"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, loaded
with ``ctypes``. The sources compile in parallel (one ``nvcc`` process
each), then link. The library lands in ``build/kernels/`` at the repo
root, named by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads at once.

Nothing here runs at import time: the first kernel launch builds.
There is no ``--use_fast_math``, so ``expf``/``sqrtf`` keep their
accurate forms. Flags differ by file: ``attention.cu``, ``histogram.cu``,
``minplus.cu``, ``rowband.cu`` and ``scoring.cu`` get ``-fmad=false``,
which keeps ``a*b + c`` as two rounded operations, as their plain
PyTorch versions compute them (the EDT kernels are bit-exact);
``flash_prefill.cu`` is built without it, so its f32 accumulation may
fuse multiply-adds as a matrix product on the card does. Headers
(``csrc/*.cuh``: ``hopper.cuh`` holds the inline PTX for mbarriers, TMA
and ``wgmma``) are part of the hash. The library links against the CUDA
runtime and ``libdl`` only: the one ``libcuda`` function the kernels
need (the tensor-map encoder of the TMA loads) is looked up at run time
in the ``libcuda.so.1`` that PyTorch has loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["load_library", "build_library", "check", "CSRC_DIR",
           "BUILD_DIR"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]
# flags of one source, by file name; every other file gets the default
DEFAULT_FILE_FLAGS = ["-fmad=false"]
FILE_FLAGS = {"flash_prefill.cu": []}

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

# C signatures of the exported launchers (each returns a cudaError_t).
_SIGNATURES = {
    # g2, R, W, qcol, nq, qcol_per_row, s_lo, s_hi, band, n_band_cols,
    # direct, out, stream
    "minplus_pass2": [_VP, _I, _I, _VP, _I, _I, _I, _I, _VP, _I, _I, _VP,
                      _VP],
    # din, dout, dclose, dwide, grad, m, stem, scal, weights, H, W,
    # 8 f32 outputs, valid (uint8), stream
    "fused_score_maps": [_VP] * 9 + [_I, _I] + [_VP] * 9 + [_VP],
    # x, ws, bs, w1, b1, w2, b2, N, HW, C, R, spatial, channel, cmajor,
    # vec, out, stream
    "fused_attention_gate": [_VP] * 7 + [_I] * 8 + [_VP, _VP],
    # dy, its strides (3), x, its strides (3), ws, bs, w1, b1, w2, b2, N,
    # HW, C, R, spatial, channel, dx, its strides (3), part, grads, stream
    "attention_gate_backward": [_VP] + [_L] * 3 + [_VP] + [_L] * 3
    + [_VP] * 6 + [_I] * 6 + [_VP] + [_L] * 3 + [_VP] * 3,
    # g2r, C, H, W, nb4 scratch, nb, out, stream
    "squared_edt_rowband": [_VP, _I, _I, _I, _VP, _VP, _VP, _VP],
    # depth, ids, lo, inv_w, n, num, r, blocks, out, stream
    "segment_histogram": [_VP] * 4 + [_I] * 4 + [_VP, _VP],
    # q, k, v, pad, out, b, t, heads, kv_heads, hd, is_bf16,
    # strides (12 int64), scale, stream
    "flash_prefill": [_VP] * 5 + [_I] * 6 + [_VP, _F, _VP],
}

_LOCK = threading.Lock()
_LIB = [None]


def _nvcc() -> str:
    for cand in ("/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _file_flags(src: Path) -> list:
    return FILE_FLAGS.get(src.name, DEFAULT_FILE_FLAGS)


def _digest(sources) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(" ".join(_file_flags(src)).encode())
        h.update(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


def build_library(verbose: bool = False) -> Path:
    """Compile (if needed) and return the path of the shared library."""
    sources = _sources()
    tag = _digest(sources)
    out = BUILD_DIR / f"libleafgrasp_kernels_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    procs = []
    objs = []
    for src in sources:
        obj = BUILD_DIR / f"{src.stem}_{tag}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *_file_flags(src), *extra, "-c", str(src),
             "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, proc in procs:
        log, _ = proc.communicate()
        if verbose and log:
            print(f"[nvcc {src.name}]\n{log}", flush=True)
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([nvcc, "-shared", *NVCC_FLAGS[:2],
                          *map(str, objs), "-ldl", "-o", str(tmp)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + res.stdout + res.stderr)
    os.replace(tmp, out)
    return out


def load_library(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    with _LOCK:
        if _LIB[0] is None:
            lib = ctypes.CDLL(str(build_library(verbose=verbose)))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB[0] = lib
        return _LIB[0]


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")
