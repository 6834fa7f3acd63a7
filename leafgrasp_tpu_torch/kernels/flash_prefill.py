"""Flash-attention prefill: the kernel wrapper and its plain version.

    out[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h // rep]
                                   / sqrt(hd)) * v[b, j, h // rep]

over ``pad[b] <= j <= i`` for the real query rows ``i >= pad[b]``, with
f32 scores, softmax and accumulation; rows ``i < pad[b]`` (the left pad
of a batched prompt) come back as zeros. ``q`` is (b, t, heads, hd),
``k`` / ``v`` are (b, s >= t, kv_heads, hd) of which the first ``t``
rows are read (the KV cache as it is: any batch / token / head strides,
no repeat to ``heads``), ``pad`` is (b,) int32.

Replaces the TPU route ``_flash_prefill``
(leafgrasp_tpu/vla/llava_jax.py:284), which pads the sequence to a block
multiple on the host and repeats K/V to the query head count first; the
kernel source, with its bound and design, is ``csrc/flash_prefill.cu``:
in bf16 a persistent ``wgmma`` kernel whose K/V tiles arrive by TMA
through tensor maps of the tensors as they lie (so every stride must be
a multiple of 16 bytes), in f32 a scalar kernel that exists to hold the
masking and the softmax to 1e-5. Kernel and plain version differ in the
order of the f32 sums and, in bf16, in where probabilities are rounded
(before or after the division by the row sum): about 1e-6 in f32, and in
bf16 a few ulps of the value (an ulp is 2^-8 of it) on unit-scale
inputs.
"""

from __future__ import annotations

import ctypes
import math

import torch

from leafgrasp_tpu_torch.kernels import LAUNCHES
from leafgrasp_tpu_torch.kernels.build import check, load_library

__all__ = ["flash_prefill", "flash_prefill_plain"]

_HEAD_DIMS = (64, 128)             # instantiated in the kernel
_DTYPES = (torch.float32, torch.bfloat16)


def _check_args(q, k, v, pad):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: want (b, t, heads, hd) and "
                         f"two (b, s, kv_heads, hd)")
    b, t, heads, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or k.shape[1] < t:
        raise ValueError(f"k {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    if k.shape[2] < 1 or heads % k.shape[2] != 0:
        raise ValueError(f"{heads} query heads over {k.shape[2]} K/V heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v differ in type: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if pad.dtype != torch.int32 or tuple(pad.shape) != (b,):
        raise ValueError(f"pad must be int32 ({b},), got {pad.dtype} "
                         f"{tuple(pad.shape)}")
    if not (q.device == k.device == v.device == pad.device):
        raise ValueError("q, k, v and pad on different devices")


def flash_prefill_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        pad: torch.Tensor, chunk: int | None = None
                        ) -> torch.Tensor:
    """Plain PyTorch version: the dense grouped-query attention with the
    mask built from ``pad``, f32 scores and softmax, probabilities cast
    to the input type before the second product. ``chunk`` computes that
    many query rows at a time, so that the f32 scores of a long prompt
    fit; the result is the same row by row."""
    _check_args(q, k, v, pad)
    b, t, heads, hd = q.shape
    kvh = k.shape[2]
    rep = heads // kvh
    kf = k[:, :t].to(torch.float32)
    vt = v[:, :t]
    key = torch.arange(t, device=q.device)
    padl = pad.to(torch.int64)
    out = torch.empty_like(q)
    step = t if chunk is None else max(1, int(chunk))
    for lo in range(0, t, step):
        hi = min(t, lo + step)
        qg = q[:, lo:hi].reshape(b, hi - lo, kvh, rep, hd)
        scores = torch.einsum("btkrd,bskd->bkrts", qg.to(torch.float32), kf)
        scores = scores / math.sqrt(hd)
        row = key[lo:hi]
        mask = (key[None, None, :] <= row[None, :, None]) \
            & (key[None, None, :] >= padl[:, None, None])     # (b, tq, t)
        scores = torch.where(mask[:, None, None], scores,
                             torch.full_like(scores, -1e30))
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        o = torch.einsum("bkrts,bskd->btkrd", probs, vt)
        real = (row[None, :] >= padl[:, None])[:, :, None, None, None]
        out[:, lo:hi] = torch.where(real, o, torch.zeros_like(o)) \
            .reshape(b, hi - lo, heads, hd)
    return out


def _row_strides(x: torch.Tensor, name: str) -> list:
    """(batch, token, head) element strides of a (b, t, h, hd) tensor the
    kernel can read 16 bytes at a time (TMA takes no other strides)."""
    vec = 16 // x.element_size()
    sb, st, sh, sd = x.stride()
    if sd != 1 or st % vec or sh % vec or sb % vec \
            or x.data_ptr() % 16:
        raise ValueError(f"{name}: strides {x.stride()} at offset "
                         f"{x.storage_offset()} are not 16-byte rows with "
                         f"a contiguous last dimension")
    return [sb, st, sh]


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  pad: torch.Tensor) -> torch.Tensor:
    """(b, t, heads, hd) attention output in ``q``'s type: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, pad)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_args(q, k, v, pad)
    b, t, heads, hd = q.shape
    if hd not in _HEAD_DIMS or q.dtype not in _DTYPES:
        raise ValueError(f"the kernel takes f32 or bf16 with a head size in "
                         f"{_HEAD_DIMS}, got {q.dtype} with {hd}")
    out = torch.empty((b, t, heads, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if q.stride(3) != 1:
        q = q.contiguous()
    strides = _row_strides(q, "q") + _row_strides(k, "k") \
        + _row_strides(v, "v") + _row_strides(out, "out")
    pad = pad.contiguous()
    lib = load_library()
    err = lib.flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pad.data_ptr(),
        out.data_ptr(), b, t, heads, k.shape[2], hd,
        int(q.dtype == torch.bfloat16),
        (ctypes.c_longlong * 12)(*strides), 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "flash_prefill")
    LAUNCHES["flash_prefill"] += 1
    return out
