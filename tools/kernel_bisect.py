#!/usr/bin/env python3
"""Where a hand-written kernel of the port spends its time, by cutting it.

    python tools/kernel_bisect.py gate_backward   # on a machine with a card
    python tools/kernel_bisect.py flash_f32

Builds variants of one CUDA source of ``leafgrasp_tpu_torch/kernels/csrc``
with ``nvcc`` (one process each, all started together) into
``build/bisect/``, each the source with one text patch: a step skipped or
the kernel cut short. A variant computes nonsense and is only timed:
device ms per launch from ``torch.profiler``, three profiles of 20
launches each, at the main path's shape. The difference between two
variants is what the cut step costs on the critical path.

* ``gate_backward``: ``attention_gate_backward`` at (16, 16, 256), R 16,
  spatial, x the NCHW view, dy the pool's stride-0 gradient; the kernel
  cut after staging, the gates, dz/du, dx and the records, without the
  cluster's sum, and an empty launch.
* ``flash_f32``: the f32 flash prefill at (2, 642, 32 over 8, 128), no
  pad; without the split of the K/V tiles in the walk, without the
  softmax, without O += P V, without S, and with V in two planes.

Prints one line a variant and the card's name and power limit; exits
non-zero without a card, or if a patch no longer matches its source.
"""

from __future__ import annotations

import ctypes
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

CSRC = REPO / "leafgrasp_tpu_torch" / "kernels" / "csrc"
OUT = REPO / "build" / "bisect"
NVCC = ["/usr/local/cuda/bin/nvcc", "-gencode",
        "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler",
        "-fPIC", "-I", str(CSRC), "-shared"]
LEAD_IN = 32

_GATE_SYNC = ("  cluster.sync();\n  // grads = [dws C | dbs 1 | dW1 C*R | db1 "
              "R | dW2 R*C | db2 C], each the")


def _cut_before(marker: str):
    """Skip the rest of each example from ``marker`` on, and the sum."""
    return [(marker, "    continue;\n" + marker),
            (_GATE_SYNC, "  return;\n" + _GATE_SYNC)]


GATE_VARIANTS = {
    "whole": [],
    "staging": _cut_before("    // the forward's gates, recomputed"),
    "gates": _cut_before("    // dz: a warp a position"),
    "dz_du": _cut_before("    // dx, in dx's own order"),
    "dx": _cut_before("    // the example's record for the sum over n"),
    "records": [(_GATE_SYNC, "  return;\n" + _GATE_SYNC)],
    "empty": [("attention_gate_backward_kernel(const GateGrad a) {",
               "attention_gate_backward_kernel(const GateGrad a) {\n"
               "  if (a.N > 0) return;")],
}

FLASH_VARIANTS = {
    "whole": [],
    "no_split_in_walk": [
        ("    if (n + 2 < n_steps) split_stage(n + 2);\n", "")],
    "no_softmax": [
        ("    softmax_tile(x, st, al_a, al_b, masked, c0, p, t, ra, rb, tq, "
         "scale2);\n",
         "    al_a = al_b = 1.0f;\n    (void)masked;\n")],
    "no_pv": [
        ("    issue_second<HD, BN, F_VP>(o, p0, p1, stage(n % F_NST) + L::V,"
         "\n                               L::SPLANE);\n", "")],
    "no_s": [("    if (n + 1 < n_steps) scores(n + 1);\n", "")],
    "v_two_planes": [("constexpr int F_VP = 3;", "constexpr int F_VP = 2;")],
}

EXPERIMENTS = {
    "gate_backward": ("attention.cu", ["-fmad=false"], GATE_VARIANTS,
                      "attention_gate_backward_kernel"),
    "flash_f32": ("flash_prefill.cu", ["-ldl"], FLASH_VARIANTS,
                  "flash_prefill_f32_kernel"),
}


def build(source: str, flags: list, variants: dict) -> dict:
    """{variant: path of its shared library}."""
    text = (CSRC / source).read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, patches in variants.items():
        body = text
        for old, new in patches:
            if old not in body:
                raise SystemExit(f"{source}: the patch of {name!r} no "
                                 f"longer matches: {old!r}")
            body = body.replace(old, new, 1)
        src = OUT / f"{Path(source).stem}_{name}.cu"
        src.write_text(body)
        lib = OUT / f"lib{Path(source).stem}_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            NVCC + [str(src), *flags, "-o", str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        libs[name] = lib
    return libs


def device_ms(torch, call, kernel: str, iters: int = 20) -> float:
    """Mean device ms of ``kernel`` per launch over a profile of
    ``iters`` calls (after LEAD_IN spin launches, left out)."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_IN):
            torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    rows = [(ev.self_device_time_total, ev.count)
            for ev in prof.key_averages() if kernel in ev.key]
    if not rows:
        raise SystemExit(f"the profiler recorded no {kernel}")
    return sum(t for t, _ in rows) / sum(n for _, n in rows) / 1e3


def gate_call(torch, fn):
    from leafgrasp_tpu_torch.kernels.build import check
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    n, hw, c, r = 16, 16, 256, 16

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=dev)
    x = torch.relu(t(n, c, hw)).transpose(1, 2)
    params = [t(c, 1), t(1), t(c, r), t(r), t(r, c), t(c)]
    dy = (t(n, 1, c) / hw).expand(n, hw, c)
    dx = torch.empty((n, c, hw), device=dev).transpose(1, 2)
    part = torch.empty((n, 3 * c + 2 * r + 1), device=dev)
    grads = torch.empty((2 * c + 1 + 2 * c * r + r,), device=dev)

    def call():
        check(fn(dy.data_ptr(), *dy.stride(), x.data_ptr(), *x.stride(),
                 *[p.data_ptr() for p in params], n, hw, c, r, 1, 0,
                 dx.data_ptr(), *dx.stride(), part.data_ptr(),
                 grads.data_ptr(), torch.cuda.current_stream().cuda_stream),
              "attention_gate_backward")
    return call


def flash_call(torch, fn):
    from leafgrasp_tpu_torch.kernels.build import check
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    b, t, heads, kvh, hd = 2, 642, 32, 8, 128

    def t_(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=dev)
    q, k, v = t_(b, t, heads, hd), t_(b, t, kvh, hd), t_(b, t, kvh, hd)
    pad = torch.zeros((b,), dtype=torch.int32, device=dev)
    out = torch.empty_like(q)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])

    def call():
        check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pad.data_ptr(),
                 out.data_ptr(), b, t, heads, kvh, hd, 0, strides,
                 1.0 / math.sqrt(hd), None,
                 torch.cuda.current_stream().cuda_stream), "flash_prefill")
    return call


def main() -> int:
    if len(sys.argv) != 2 or sys.argv[1] not in EXPERIMENTS:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from leafgrasp_tpu_torch.kernels.build import _SIGNATURES
    name = sys.argv[1]
    source, flags, variants, kernel = EXPERIMENTS[name]
    entry = "attention_gate_backward" if name == "gate_backward" \
        else "flash_prefill"
    make_call = gate_call if name == "gate_backward" else flash_call
    for variant, lib in build(source, flags, variants).items():
        fn = getattr(ctypes.CDLL(str(lib)), entry)
        fn.argtypes = _SIGNATURES[entry]
        fn.restype = ctypes.c_int
        call = make_call(torch, fn)
        reps = [device_ms(torch, call, kernel) for _ in range(3)]
        print(f"{name} {variant}: {reps} ms", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())
