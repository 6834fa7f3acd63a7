"""The attention of a decode step: the kernel wrapper and its plain
version, and the dense grouped-query attention that both the plain
version and the prompt pass's dense and chunked routes run.

    out[b, 0, h] = sum_j p[b, h, j] v[b, j, h // rep]
    p[b, h, j]   = softmax_j(q[b, 0, h] . k[b, j, h // rep] / sqrt(hd))

over the live keys ``max(pad[b], pos - window + 1) <= j <= pos`` of a
cache (b, capacity, kv_heads, hd), where ``pos`` is the step's slot,
``cursor`` (1,) int64 on the device; the window only where one is
given. Scores and softmax are f32, the probabilities are cast to the
layer's type ``dt`` before the second product, and the output has the
promoted type of ``dt`` and the cache's.

For CPU tensors it is the plain version: the dense masked attention over
every slot (``grouped_attention`` under ``slot_mask``), which is what
the port's step ran before the kernel, operation for operation. For CUDA
tensors it is the kernel of ``csrc/decode_attention.cu`` (its source
note has the bound and the design), which reads only the live keys of
the cache as it lies and finds the cursor on the device at each launch,
so a captured CUDA graph serves any prompt that fits; it raises for a
head size, a type or a layout it lacks. Kernel and plain version differ
in the order of the f32 sums (and, on the card, in ``exp``'s last bit),
so a bf16 probability on a rounding edge may round the other way: in
f32 a few 1e-7 of the output, in bf16 an ulp of it. The replaced TPU
code is no kernel: the JAX decode is the grouped einsum of
leafgrasp_tpu/vla/llava_jax.py:355-379.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from leafgrasp_tpu_torch.kernels import LAUNCHES
from leafgrasp_tpu_torch.kernels.build import check, load_library

__all__ = ["decode_attention", "decode_attention_plain",
           "grouped_attention", "slot_mask", "route"]

_HEAD_DIMS = (64, 128)            # instantiated in the kernel
_DTYPES = (torch.float32, torch.bfloat16)
#: query heads of one K/V head that a block of the kernel takes
_HEADS_PER_BLOCK = 4
#: live keys a block takes at most (its shared memory), and at least
#: where the capacity allows
_MAX_SHARE, _MIN_SHARE = 256, 32
#: blocks an SM that every block of a launch fits in
_BLOCKS_PER_SM = 4


def route(device: torch.device) -> str:
    """What a step's attention runs on ``device``: "plain" (the plain
    version) on the CPU, "kernel" elsewhere (the kernel, or a raise)."""
    return "plain" if device.type == "cpu" else "kernel"


def slot_mask(q, k, pad=None, window: Optional[int] = None):
    """(1 or b, 1, queries, keys) bool: the key slots ``k`` at or before
    each query slot ``q``, within ``window``, if any, and with ``pad``
    (b,) at or after the row's pad."""
    mask = k[None, :] <= q[:, None]
    if window is not None:
        # pad is a shared prefix, so absolute distance == pad-relative
        mask = mask & (q[:, None] - k[None, :] < window)
    if pad is None:
        return mask[None, None]
    return mask[None, None] & (k[None, None, None, :]
                               >= pad[:, None, None, None])


def grouped_attention(q, k, v, mask, dt):
    """Exact attention of the query rows ``q`` (b, t, heads, hd) over the
    whole key axis of ``k``/``v`` (b, s, kv_heads, hd) under ``mask`` (b
    or 1, 1 or heads, t, s), in grouped-query form (K/V never repeated to
    the query heads): f32 scores and softmax, probabilities cast to
    ``dt``, the second product in the promoted type of ``dt`` and V's."""
    b, t, heads, hd = q.shape
    kvh = k.shape[2]
    rep = heads // kvh
    qg = q.reshape(b, t, kvh, rep, hd)
    scores = torch.einsum("btkrd,bskd->bkrts", qg.to(torch.float32),
                          k.to(torch.float32))
    scores = scores / math.sqrt(hd)
    if mask.shape[1] == heads:          # per-head mask
        mcb = mask.reshape(mask.shape[0], kvh, rep, *mask.shape[2:])
    else:                               # head-dim-1 mask
        mcb = mask[:, :, None]
    scores = scores.masked_fill(~mcb, -1e30)
    probs = torch.softmax(scores, dim=-1).to(dt)
    pt = torch.promote_types(probs.dtype, v.dtype)
    out = torch.einsum("bkrts,bskd->btkrd", probs.to(pt), v.to(pt))
    return out.reshape(b, t, heads, hd)


def _check_args(q, k, v, pad, cursor, window):
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 \
            or v.shape != k.shape or k.shape[0] != q.shape[0] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: want (b, 1, heads, hd) and "
                         f"twice (b, capacity, kv_heads, hd)")
    b, _, heads, _ = q.shape
    if k.shape[2] < 1 or heads % k.shape[2] != 0:
        raise ValueError(f"{heads} query heads over {k.shape[2]} K/V heads")
    if pad.dtype != torch.int32 or tuple(pad.shape) != (b,):
        raise ValueError(f"pad must be int32 ({b},), got {pad.dtype} "
                         f"{tuple(pad.shape)}")
    if cursor.dtype != torch.int64 or cursor.numel() != 1:
        raise ValueError(f"cursor must be one int64, got {cursor.dtype} "
                         f"{tuple(cursor.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window {window}")


def decode_attention_plain(q, k, v, pad, cursor, dt,
                           window: Optional[int] = None):
    """Plain PyTorch version: ``grouped_attention`` over every slot of the
    cache under the step's mask from ``pad``, ``cursor`` and ``window``."""
    _check_args(q, k, v, pad, cursor, window)
    slot = cursor.reshape(1)
    mask = slot_mask(slot, torch.arange(k.shape[1], device=q.device), pad,
                     window)
    return grouped_attention(q, k, v, mask, dt)


def _strides(x: torch.Tensor, name: str, dims) -> list:
    """Element strides of ``dims`` of a tensor the kernel reads 16 bytes
    of a row at a time."""
    vec = 16 // x.element_size()
    st = [x.stride(d) for d in dims]
    if x.stride(3) != 1 or any(s % vec for s in st) or x.data_ptr() % 16:
        raise ValueError(f"{name}: strides {x.stride()} at offset "
                         f"{x.storage_offset()} are not 16-byte rows with "
                         f"a contiguous last dimension")
    return st


def _check_kernel_args(q, k, v, pad, cursor, dt, window):
    """Shapes, what the kernel is instantiated for, and the device."""
    _check_args(q, k, v, pad, cursor, window)
    hd = q.shape[3]
    if hd not in _HEAD_DIMS or k.dtype not in _DTYPES \
            or v.dtype != k.dtype or q.dtype not in _DTYPES \
            or dt not in _DTYPES:
        raise ValueError(f"the kernel takes f32 or bf16 with a head size in "
                         f"{_HEAD_DIMS}, got q {q.dtype}, cache {k.dtype} "
                         f"and {v.dtype}, probabilities {dt}, head size "
                         f"{hd}")
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if not (q.device == k.device == v.device == pad.device == cursor.device):
        raise ValueError("q, k, v, pad and cursor on different devices")


def _shares(cap: int, pairs: int, sms: int) -> int:
    """How many blocks split a row's live keys: at most ``_MAX_SHARE``
    keys a block; otherwise as many as one wave of ``_BLOCKS_PER_SM``
    blocks an SM holds, and no more than give each ``_MIN_SHARE`` keys.
    From the capacity, never from the cursor."""
    wave = max(1, _BLOCKS_PER_SM * sms // pairs)
    return max(-(-cap // _MAX_SHARE), min(-(-cap // _MIN_SHARE), wave))


def _up4(n: int) -> int:
    return -(-n // 4) * 4


def decode_attention(q, k, v, pad, cursor, dt,
                     window: Optional[int] = None):
    """(b, 1, heads, hd) attention of a step's queries ``q`` over the cache
    ``k``/``v`` (b, capacity, kv_heads, hd) as it lies, in the promoted
    type of ``dt`` and the cache's: the CUDA kernel for CUDA tensors
    (two launches, one count), the plain version for CPU tensors.
    ``cursor`` (1,) int64 is the step's slot, ``pad`` (b,) int32 the
    rows' left pads, ``window`` the sliding window or None."""
    if route(q.device) == "plain":
        return decode_attention_plain(q, k, v, pad, cursor, dt, window)
    _check_kernel_args(q, k, v, pad, cursor, dt, window)
    b, _, heads, hd = q.shape
    cap, kvh = k.shape[1], k.shape[2]
    out_dt = torch.promote_types(dt, k.dtype)
    out = torch.empty((b, 1, heads, hd), dtype=out_dt, device=q.device)
    if q.stride(3) != 1:
        q = q.contiguous()
    strides = _strides(q, "q", (0, 2)) + _strides(k, "k", (0, 1, 2)) \
        + _strides(v, "v", (0, 1, 2))
    groups = -(-(heads // kvh) // _HEADS_PER_BLOCK)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    n_split = _shares(cap, b * kvh * groups, sms)
    # the scores, the shares' (max, sum) pairs and partial sums, each from
    # a 16-byte boundary, then the pairs' tickets
    work = torch.empty((_up4(b * heads * cap) + _up4(b * heads * n_split * 2)
                        + _up4(n_split * b * heads * hd) + b * kvh * groups,),
                       dtype=torch.float32, device=q.device)
    pad = pad.contiguous()
    cursor = cursor.reshape(1).contiguous()
    bf16 = torch.bfloat16
    scale = float(np.float32(1.0) / np.float32(math.sqrt(hd)))
    err = load_library().decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pad.data_ptr(),
        cursor.data_ptr(), out.data_ptr(), work.data_ptr(), b, heads, kvh,
        cap, hd, int(k.dtype == bf16), int(q.dtype == bf16),
        int(dt == bf16), int(out_dt == bf16), n_split,
        0 if window is None else int(window),
        (ctypes.c_longlong * 8)(*strides), scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "decode_attention")
    LAUNCHES["decode_attention"] += 1
    return out
