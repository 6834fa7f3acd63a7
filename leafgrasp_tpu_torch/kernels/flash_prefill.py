"""Flash-attention prefill: the kernel wrapper and its plain version.

    out[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h // rep]
                                   / sqrt(hd)) * v[b, j, h // rep]

over ``pad[b] <= j <= i`` for the real query rows ``i >= pad[b]``, with
f32 scores, softmax and accumulation; rows ``i < pad[b]`` (the left pad
of a batched prompt) come back as zeros. ``q`` is (b, t, heads, hd),
``k`` / ``v`` are (b, s >= t, kv_heads, hd) of which the first ``t``
rows are read (the KV cache as it is: any batch / token / head strides,
no repeat to ``heads``), ``pad`` is (b,) int32. ``v`` may have a head
size of its own (latent attention's split heads: q and k of 192, v and
the output of 128), and the scale is then q's, 1 / sqrt(192).

A query offset ``o`` (``q_offset``) puts the t query rows at the key
rows o .. o + t - 1: row i reads the keys ``pad[b] <= j <= o + i`` of
the first o + t rows of k and v, and is a pad row where ``o + i <
pad[b]``. That is a pass over the text after an image prefix whose K/V
are already in the cache. Both forward kernels (bf16 and f32) take
it; the backward takes none.

Replaces the TPU route ``_flash_prefill``
(leafgrasp_tpu/vla/llava_jax.py:284), which pads the sequence to a block
multiple on the host and repeats K/V to the query head count first; the
kernel source, with its bound and design, is ``csrc/flash_prefill.cu``:
in bf16 a persistent ``wgmma`` kernel whose K/V tiles arrive by TMA
through tensor maps of the tensors as they lie (so every stride must be
a multiple of 16 bytes), in f32 a ``wgmma`` kernel on bf16 planes of the
f32 operands (three planes of q, k and v, two of the probabilities),
whose tiles arrive by TMA too. Kernel and plain version differ in the
order of the f32 sums and, in bf16, in where probabilities are rounded
(before or after the division by the row sum): a few 1e-6 in f32, and in
bf16 a few ulps of the value (an ulp is 2^-8 of it) on unit-scale
inputs.

The gradient. ``flash_prefill_trainable`` is the entry point of a pass
that is differentiated: when autograd records and an input needs a
gradient it goes through ``FlashPrefill``, an ``autograd.Function``
whose forward also writes the row log-sum-exp ``lse`` (b, heads, t) f32
(natural log, ``-inf`` on pad rows) and whose backward is two more
kernels (``csrc/flash_prefill_bwd.cu``): ``flash_prefill_bwd_dq`` (dQ,
and D = rowsum(dO o O) for the other) then ``flash_prefill_bwd_dkv`` (dK
and dV at the K/V heads, summed over each query-head group). They
replace the backward Pallas kernels of the TPU flash attention
(``_flash_attention_bwd_dq`` and ``_flash_attention_bwd_dkv`` of
jax/experimental/pallas/ops/tpu/flash_attention.py:1287 and :941).
Otherwise it is ``flash_prefill``: the same launch as serving, no
log-sum-exp. For CPU tensors both directions are the plain versions.
Gradients come back in each input's type, from f32 sums.
"""

from __future__ import annotations

import ctypes
import math

import torch

from leafgrasp_tpu_torch.kernels import LAUNCHES
from leafgrasp_tpu_torch.kernels.build import check, load_library

__all__ = ["flash_prefill", "flash_prefill_plain", "flash_prefill_backward",
           "flash_prefill_backward_plain", "FlashPrefill",
           "flash_prefill_trainable"]

_HEAD_DIMS = (64, 128)             # instantiated in the kernel
_SPLIT_HEAD_DIMS = ((192, 128),)   # (q and k, v) instantiated, bf16
_DTYPES = (torch.float32, torch.bfloat16)


def _check_args(q, k, v, pad, q_offset: int = 0):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: want (b, t, heads, hd), "
                         f"(b, s, kv_heads, hd) and (b, s, kv_heads, hd_v)")
    b, t, heads, hd = q.shape
    if q_offset < 0:
        raise ValueError(f"query offset {q_offset} below 0")
    if k.shape[0] != b or k.shape[3] != hd or k.shape[1] < q_offset + t:
        raise ValueError(f"k {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)} at query offset {q_offset}")
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


def _mask(key: torch.Tensor, row: torch.Tensor, padl: torch.Tensor):
    """(b, rows, keys): key j visible from query row i of batch row b."""
    return (key[None, None, :] <= row[None, :, None]) \
        & (key[None, None, :] >= padl[:, None, None])


def flash_prefill_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        pad: torch.Tensor, q_offset: int = 0,
                        chunk: int | None = None, return_lse: bool = False):
    """Plain PyTorch version: the dense grouped-query attention with the
    mask built from ``pad`` and ``q_offset``, f32 scores and softmax,
    probabilities cast to the input type before the second product.
    ``chunk`` computes that many query rows at a time, so that the f32
    scores of a long prompt fit; the result is the same row by row.
    ``return_lse`` also returns the row log-sum-exp of the scaled scores,
    (b, heads, t) f32."""
    _check_args(q, k, v, pad, q_offset)
    b, t, heads, hd = q.shape
    kvh = k.shape[2]
    rep = heads // kvh
    s = q_offset + t
    kf = k[:, :s].to(torch.float32)
    vt = v[:, :s]
    hdv = v.shape[3]
    key = torch.arange(s, device=q.device)
    padl = pad.to(torch.int64)
    out = torch.empty((b, t, heads, hdv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, kvh, rep, t), dtype=torch.float32,
                      device=q.device)
    step = t if chunk is None else max(1, int(chunk))
    for lo in range(0, t, step):
        hi = min(t, lo + step)
        qg = q[:, lo:hi].reshape(b, hi - lo, kvh, rep, hd)
        scores = torch.einsum("btkrd,bskd->bkrts", qg.to(torch.float32), kf)
        scores = scores / math.sqrt(hd)
        row = key[q_offset + lo:q_offset + hi]
        mask = _mask(key, row, padl)[:, None, None]           # (b, tq, s)
        if return_lse:
            lse[..., lo:hi] = torch.logsumexp(torch.where(
                mask, scores, torch.full_like(scores, -math.inf)), dim=-1)
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        o = torch.einsum("bkrts,bskd->btkrd", probs, vt)
        real = (row[None, :] >= padl[:, None])[:, :, None, None, None]
        out[:, lo:hi] = torch.where(real, o, torch.zeros_like(o)) \
            .reshape(b, hi - lo, heads, hdv)
    if return_lse:
        return out, lse.reshape(b, heads, t)
    return out


def flash_prefill_backward_plain(q, k, v, pad, out, lse, dout,
                                 chunk: int | None = None):
    """Plain PyTorch version of the backward, from the explicit formulas
    in f32: P = exp(S scale - lse) on the visible keys (0 elsewhere),
    D = rowsum(dO o O), dV = P^T dO, dP = dO V^T, dS = P o (dP - D),
    dK = scale dS^T Q, dQ = scale dS K. Returns f32 (dq, dk, dv) in the
    shapes of q, k and v (dK, dV summed over each query-head group; rows
    of k and v from t on are zero). ``chunk`` takes that many query rows
    at a time."""
    _check_args(q, k, v, pad)
    b, t, heads, hd = q.shape
    kvh = k.shape[2]
    rep = heads // kvh
    scale = 1.0 / math.sqrt(hd)
    f32 = torch.float32
    kf = k[:, :t].to(f32)
    vf = v[:, :t].to(f32)
    lse = lse.reshape(b, kvh, rep, t)
    key = torch.arange(t, device=q.device)
    padl = pad.to(torch.int64)
    dq = torch.zeros(q.shape, dtype=f32, device=q.device)
    dk = torch.zeros(k.shape, dtype=f32, device=q.device)
    dv = torch.zeros(v.shape, dtype=f32, device=q.device)
    step = t if chunk is None else max(1, int(chunk))
    for lo in range(0, t, step):
        hi = min(t, lo + step)
        qg = q[:, lo:hi].reshape(b, hi - lo, kvh, rep, hd).to(f32)
        dog = dout[:, lo:hi].reshape(b, hi - lo, kvh, rep, hd).to(f32)
        og = out[:, lo:hi].reshape(b, hi - lo, kvh, rep, hd).to(f32)
        scores = torch.einsum("btkrd,bskd->bkrts", qg, kf) * scale
        mask = _mask(key, key[lo:hi], padl)[:, None, None]
        p = torch.where(mask, torch.exp(scores - lse[..., lo:hi, None]),
                        torch.zeros_like(scores))
        d = (dog * og).sum(-1).permute(0, 2, 3, 1)             # (b, k, r, tq)
        dv[:, :t] += torch.einsum("bkrts,btkrd->bskd", p, dog)
        dp = torch.einsum("btkrd,bskd->bkrts", dog, vf)
        ds = p * (dp - d[..., None])
        dq[:, lo:hi] = scale * torch.einsum("bkrts,bskd->btkrd", ds, kf) \
            .reshape(b, hi - lo, heads, hd)
        dk[:, :t] += scale * torch.einsum("bkrts,btkrd->bskd", ds, qg)
    return dq, dk, dv


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


def _check_kernel_args(q, k, v, pad, q_offset: int = 0):
    """Device, shapes and what the kernels are instantiated for."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_args(q, k, v, pad, q_offset)
    hd, hdv = q.shape[3], v.shape[3]
    if hd != hdv:
        if (hd, hdv) not in _SPLIT_HEAD_DIMS or q.dtype != torch.bfloat16:
            raise ValueError(f"split heads: the kernel takes bf16 with "
                             f"(q/k, v) head sizes in {_SPLIT_HEAD_DIMS}, "
                             f"got {q.dtype} with {(hd, hdv)}")
    elif hd not in _HEAD_DIMS or q.dtype not in _DTYPES:
        raise ValueError(f"the kernel takes f32 or bf16 with a head size in "
                         f"{_HEAD_DIMS}, got {q.dtype} with {hd}")


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  pad: torch.Tensor, q_offset: int = 0,
                  return_lse: bool = False):
    """(b, t, heads, hd) attention output in ``q``'s type: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors. With
    ``return_lse`` also the row log-sum-exp, (b, heads, t) f32."""
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, pad, q_offset,
                                   return_lse=return_lse)
    _check_kernel_args(q, k, v, pad, q_offset)
    b, t, heads, hd = q.shape
    hdv = v.shape[3]
    out = torch.empty((b, t, heads, hdv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, heads, t), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    if q.stride(3) != 1:
        q = q.contiguous()
    strides = _row_strides(q, "q") + _row_strides(k, "k") \
        + _row_strides(v, "v") + _row_strides(out, "out")
    pad = pad.contiguous()
    lib = load_library()
    err = lib.flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pad.data_ptr(),
        out.data_ptr(), b, t, heads, k.shape[2], hd, hdv,
        int(q.dtype == torch.bfloat16), int(q_offset),
        (ctypes.c_longlong * 12)(*strides), 1.0 / math.sqrt(hd),
        None if lse is None else lse.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "flash_prefill")
    LAUNCHES["flash_prefill"] += 1
    return (out, lse) if return_lse else out


def _input_rows(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x``, or a contiguous copy where its rows are not 16-byte rows
    with a contiguous last dimension (a gradient may come as any view)."""
    try:
        _row_strides(x, name)
        return x
    except ValueError:
        return x.contiguous()


def flash_prefill_backward(q, k, v, pad, out, lse, dout):
    """f32 (dq, dk, dv) of the flash prefill (shapes of q, k, v): the two
    CUDA kernels for CUDA tensors (raising for a type or head size they
    lack), the plain version for CPU tensors. One head size for q, k and
    v: split heads are served, not trained."""
    if v.dim() == 4 and q.dim() == 4 and v.shape[3] != q.shape[3]:
        raise ValueError(f"the backward takes one head size, got q "
                         f"{q.shape[3]} and v {v.shape[3]}")
    if q.device.type == "cpu":
        return flash_prefill_backward_plain(q, k, v, pad, out, lse, dout)
    _check_kernel_args(q, k, v, pad)
    b, t, heads, hd = q.shape
    kvh = k.shape[2]
    if out.shape != q.shape or dout.shape != q.shape \
            or tuple(lse.shape) != (b, heads, t):
        raise ValueError(f"out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)}, lse {tuple(lse.shape)} do "
                         f"not fit q {tuple(q.shape)}")
    if not (out.dtype == dout.dtype == q.dtype) \
            or lse.dtype != torch.float32:
        raise ValueError(f"out {out.dtype}, dout {dout.dtype}, lse "
                         f"{lse.dtype}: want {q.dtype}, {q.dtype}, f32")
    f32 = torch.float32
    dq = torch.empty(q.shape, dtype=f32, device=q.device)
    zeros_beyond_t = k.shape[1] > t       # rows t.. are not written
    alloc = torch.zeros if zeros_beyond_t else torch.empty
    dk = alloc(k.shape, dtype=f32, device=q.device)
    dv = alloc(v.shape, dtype=f32, device=q.device)
    if dq.numel() == 0:
        return dq, dk, dv
    q, out, dout = (_input_rows(x, n) for x, n in
                    ((q, "q"), (out, "out"), (dout, "dout")))
    lse = lse.contiguous()
    dsum = torch.empty((b, heads, t), dtype=f32, device=q.device)
    pad = pad.contiguous()
    lib = load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    bf16 = int(q.dtype == torch.bfloat16)
    scale = 1.0 / math.sqrt(hd)
    rows = {n: _row_strides(x, n) for n, x in
            (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout),
             ("dq", dq), ("dk", dk), ("dv", dv))}
    strides = rows["q"] + rows["k"] + rows["v"] + rows["out"] \
        + rows["dout"] + rows["dq"]
    err = lib.flash_prefill_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), pad.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
        dq.data_ptr(), b, t, heads, kvh, hd, bf16,
        (ctypes.c_longlong * 18)(*strides), scale, stream)
    check(err, "flash_prefill_bwd_dq")
    LAUNCHES["flash_prefill_bwd_dq"] += 1
    strides = rows["q"] + rows["k"] + rows["v"] + rows["dout"] \
        + rows["dk"] + rows["dv"]
    err = lib.flash_prefill_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        pad.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, t, heads, kvh, hd, bf16,
        (ctypes.c_longlong * 18)(*strides), scale, stream)
    check(err, "flash_prefill_bwd_dkv")
    LAUNCHES["flash_prefill_bwd_dkv"] += 1
    return dq, dk, dv


class FlashPrefill(torch.autograd.Function):
    """The flash prefill as an autograd node: the forward keeps the
    output and its row log-sum-exp, the backward is
    ``flash_prefill_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, pad):
        out, lse = flash_prefill(q, k, v, pad, return_lse=True)
        ctx.save_for_backward(q, k, v, pad, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, pad, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_prefill_backward(q, k, v, pad, out, lse,
                                            dout.to(q.dtype))
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def flash_prefill_trainable(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, pad: torch.Tensor,
                            q_offset: int = 0) -> torch.Tensor:
    """``flash_prefill`` for a pass that may be differentiated: through
    ``FlashPrefill`` when autograd records and q, k or v needs a
    gradient (at query offset 0 only: the backward takes none), else the
    serving launch itself (no log-sum-exp)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if q_offset:
            raise ValueError("the flash prefill's backward takes no query "
                             "offset")
        return FlashPrefill.apply(q, k, v, pad)
    return flash_prefill(q, k, v, pad, q_offset)
