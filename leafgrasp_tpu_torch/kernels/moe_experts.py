"""Grouped expert product of a mixture-of-experts layer: the kernel
wrapper and its plain version.

    out[t] = sum_k w[t, k] * down_e(silu(gate_e(x[t])) * up_e(x[t])),
             e = ids[t, k]

``x`` is (T, hidden), ``ids`` (T, k) the experts each token was routed
to (distinct within a row), ``w`` (T, k) f32 their weights, and the
experts' SwiGLU weights lie stacked as they are held: ``w_gate`` and
``w_up`` (E, width, hidden), ``w_down`` (E, hidden, width). Products
take the input's type with f32 sums; ``h = silu(g) * u`` is rounded to
the input's type between the two products; the weighted sum over a
token's k experts is f32, rounded to the input's type once.

Replaces no TPU kernel: the JAX package has no expert layer. It serves
DeepSeek-V3-style decoders (``vla/moe.py``) in the prompt pass and in the
decode alike. Bound: at the prompt pass's thousands of tokens the
products (about 17 MFLOP a routed pair at Moonlight's widths: the
tensor cores' rate); at a decode step's few tokens the chosen experts'
weights (17.3 MB an expert a layer: HBM).

Design (Triton, two launches: ``moe_experts_gate_up_kernel`` then
``moe_experts_down_kernel``). The routed pairs are grouped by expert on
the device, with nothing read back to the host: ``order`` lists the
pairs expert by expert (a stable sort of the pairs' experts), and each
expert's first pair and first row tile are cumulative sums of its pair
count. A program owns
one tile of ``BM`` pairs of one expert and one column tile: it finds its
expert by comparing its tile index with the experts' first tiles, reads
the tokens' rows of ``x`` (or of ``h``) by their pair, and the expert's
weight tiles in place from the stacked tensors, never a copy of them.
The grid has the most row tiles any routing can need (the pairs over
``BM``, plus one a expert), so its shape depends on shapes alone and a
CUDA graph can capture it; programs past the routing's tiles return at
once. An expert without pairs has no tile and its weights are not read.
The second launch scales each pair's row by its weight and writes it at
the pair's own place, so the sum over k is a plain reduction.

Counter: ``LAUNCHES["moe_experts"]``, one a call, at the wrapper.
"""

from __future__ import annotations

from typing import Optional

import torch

from leafgrasp_tpu_torch.kernels import LAUNCHES

__all__ = ["moe_experts", "moe_experts_plain", "expert_counts"]

_KERNELS: list = []
# at most this many routed pairs a call take the narrow row tiles
FEW_PAIRS = 256


def _check(x, ids, w, w_gate, w_up, w_down):
    if x.dim() != 2 or ids.dim() != 2 or w.shape != ids.shape \
            or ids.shape[0] != x.shape[0]:
        raise ValueError(f"x {tuple(x.shape)}, ids {tuple(ids.shape)}, w "
                         f"{tuple(w.shape)}: want (T, hidden), (T, k), "
                         f"(T, k)")
    e, width, hidden = w_gate.shape
    if w_up.shape != w_gate.shape or tuple(w_down.shape) != (e, hidden,
                                                             width) \
            or x.shape[1] != hidden:
        raise ValueError(f"w_gate {tuple(w_gate.shape)}, w_up "
                         f"{tuple(w_up.shape)}, w_down "
                         f"{tuple(w_down.shape)} do not fit x "
                         f"{tuple(x.shape)}")


def expert_counts(ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """(n_experts,) int32: each expert's routed pairs, on the device."""
    flat = ids.reshape(-1).to(torch.int64)
    return torch.zeros((n_experts,), dtype=torch.int32,
                       device=ids.device).scatter_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32))


def moe_experts_plain(x, ids, w, w_gate, w_up, w_down) -> torch.Tensor:
    """Plain PyTorch version: a loop over the experts, each taking its
    tokens' rows; the kernel's types and roundings."""
    _check(x, ids, w, w_gate, w_up, w_down)
    f32 = torch.float32
    out = torch.zeros((x.shape[0], x.shape[1]), dtype=f32, device=x.device)
    for e in range(w_gate.shape[0]):
        tok, slot = torch.nonzero(ids == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        xs = x[tok].to(f32)
        g = xs @ w_gate[e].to(f32).T
        u = xs @ w_up[e].to(f32).T
        h = (g * torch.sigmoid(g) * u).to(x.dtype).to(f32)
        y = (h @ w_down[e].to(f32).T) * w[tok, slot].to(f32)[:, None]
        out.index_add_(0, tok, y)
    return out.to(x.dtype)


def _kernels():
    """The two Triton kernels, built at the first launch. ``tl`` and the
    shared helper are module globals, which is where Triton's compiler
    looks names up."""
    global tl, _expert_tile
    if _KERNELS:
        return _KERNELS[0]
    import triton
    import triton.language as tl

    @triton.jit
    def _expert_tile(tile_start_ptr, pair_start_ptr, order_ptr, pid_m,
                     E: tl.constexpr, EP: tl.constexpr, BM: tl.constexpr):
        """(expert, pair indices, their mask) of row tile ``pid_m``; the
        expert is E past the routing's tiles."""
        idx = tl.arange(0, EP)
        tile_end = tl.load(tile_start_ptr + 1 + idx, mask=idx < E,
                           other=2147483647)
        e = tl.sum((tile_end <= pid_m).to(tl.int32), axis=0)
        e_safe = tl.minimum(e, E - 1)
        t0 = tl.load(tile_start_ptr + e_safe)
        p0 = tl.load(pair_start_ptr + e_safe)
        p1 = tl.load(pair_start_ptr + e_safe + 1)
        rows = p0 + (pid_m - t0) * BM + tl.arange(0, BM)
        rmask = (rows < p1) & (e < E)
        pair = tl.load(order_ptr + rows, mask=rmask, other=0)
        return e, e_safe, rows, pair, rmask

    @triton.jit
    def moe_experts_gate_up_kernel(
            x_ptr, wg_ptr, wu_ptr, h_ptr, order_ptr, pair_start_ptr,
            tile_start_ptr, H, I, K, s_xt, s_we, s_wn, s_ht,
            E: tl.constexpr, EP: tl.constexpr, BM: tl.constexpr,
            BN: tl.constexpr, BK: tl.constexpr):
        pid_m = tl.program_id(0)
        pid_n = tl.program_id(1)
        e, e_safe, rows, pair, rmask = _expert_tile(
            tile_start_ptr, pair_start_ptr, order_ptr, pid_m, E, EP, BM)
        if e < E:
            tok = (pair // K).to(tl.int64)
            cols = pid_n * BN + tl.arange(0, BN)
            cmask = cols < I
            wbase = e_safe.to(tl.int64) * s_we
            acc_g = tl.zeros((BM, BN), dtype=tl.float32)
            acc_u = tl.zeros((BM, BN), dtype=tl.float32)
            for k0 in range(0, H, BK):
                ks = k0 + tl.arange(0, BK)
                kmask = ks < H
                a = tl.load(x_ptr + tok[:, None] * s_xt + ks[None, :],
                            mask=rmask[:, None] & kmask[None, :], other=0.0)
                woff = wbase + cols[:, None].to(tl.int64) * s_wn \
                    + ks[None, :]
                wmask = cmask[:, None] & kmask[None, :]
                wg = tl.load(wg_ptr + woff, mask=wmask, other=0.0)
                wu = tl.load(wu_ptr + woff, mask=wmask, other=0.0)
                acc_g = tl.dot(a, tl.trans(wg), acc_g)
                acc_u = tl.dot(a, tl.trans(wu), acc_u)
            h = acc_g * tl.sigmoid(acc_g) * acc_u
            tl.store(h_ptr + rows[:, None].to(tl.int64) * s_ht
                     + cols[None, :], h.to(h_ptr.dtype.element_ty),
                     mask=rmask[:, None] & cmask[None, :])

    @triton.jit
    def moe_experts_down_kernel(
            h_ptr, wd_ptr, w_ptr, y_ptr, order_ptr, pair_start_ptr,
            tile_start_ptr, H, I, s_ht, s_we, s_wn, s_yp,
            E: tl.constexpr, EP: tl.constexpr, BM: tl.constexpr,
            BN: tl.constexpr, BK: tl.constexpr):
        pid_m = tl.program_id(0)
        pid_n = tl.program_id(1)
        e, e_safe, rows, pair, rmask = _expert_tile(
            tile_start_ptr, pair_start_ptr, order_ptr, pid_m, E, EP, BM)
        if e < E:
            cols = pid_n * BN + tl.arange(0, BN)
            cmask = cols < H
            wbase = e_safe.to(tl.int64) * s_we
            acc = tl.zeros((BM, BN), dtype=tl.float32)
            for k0 in range(0, I, BK):
                ks = k0 + tl.arange(0, BK)
                kmask = ks < I
                a = tl.load(h_ptr + rows[:, None].to(tl.int64) * s_ht
                            + ks[None, :],
                            mask=rmask[:, None] & kmask[None, :], other=0.0)
                wd = tl.load(wd_ptr + wbase
                             + cols[:, None].to(tl.int64) * s_wn
                             + ks[None, :],
                             mask=cmask[:, None] & kmask[None, :], other=0.0)
                acc = tl.dot(a, tl.trans(wd), acc)
            wt = tl.load(w_ptr + pair, mask=rmask, other=0.0)
            acc = acc * wt[:, None]
            tl.store(y_ptr + pair[:, None].to(tl.int64) * s_yp
                     + cols[None, :], acc,
                     mask=rmask[:, None] & cmask[None, :])

    _KERNELS.append((triton, moe_experts_gate_up_kernel,
                     moe_experts_down_kernel))
    return _KERNELS[0]


def _grouping(ids: torch.Tensor, counts: torch.Tensor, bm: int):
    """(order, pair_start, tile_start) int32 on the device: the pairs
    expert by expert (a stable sort of their experts), each expert's
    first pair and first row tile."""
    zero = counts.new_zeros((1,))
    pair_start = torch.cat([zero, torch.cumsum(counts, 0,
                                               dtype=torch.int32)])
    tiles = torch.div(counts + (bm - 1), bm, rounding_mode="floor")
    tile_start = torch.cat([zero, torch.cumsum(tiles, 0, dtype=torch.int32)])
    order = torch.sort(ids.reshape(-1), stable=True).indices
    return order.to(torch.int32), pair_start, tile_start


def moe_experts(x: torch.Tensor, ids: torch.Tensor, w: torch.Tensor,
                w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor,
                counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(T, hidden) in ``x``'s type: the Triton kernels for CUDA tensors
    (bf16; the weights' last dimension contiguous), the plain version for
    CPU tensors. ``counts``: ``expert_counts(ids, E)``, if the caller has
    it."""
    if x.device.type == "cpu":
        return moe_experts_plain(x, ids, w, w_gate, w_up, w_down)
    _check(x, ids, w, w_gate, w_up, w_down)
    if x.device.type != "cuda" or not (x.dtype == w_gate.dtype == w_up.dtype
                                       == w_down.dtype == torch.bfloat16):
        raise ValueError(f"the kernel takes bf16 on a CUDA device, got x "
                         f"{x.dtype} on {x.device}, weights "
                         f"{w_gate.dtype}")
    for name, t in (("w_gate", w_gate), ("w_up", w_up), ("w_down", w_down)):
        if t.stride(2) != 1 or t.stride(1) != t.shape[2] \
                or t.stride(0) != t.shape[1] * t.shape[2]:
            raise ValueError(f"{name}: strides {t.stride()}, want a "
                             f"contiguous (E, rows, cols)")
    n_tok, k = ids.shape
    e, width, hidden = w_gate.shape
    n_pairs = n_tok * k
    if n_pairs == 0:
        return torch.zeros_like(x)
    if counts is None:
        counts = expert_counts(ids, e)
    if x.stride(1) != 1:
        x = x.contiguous()
    # a few pairs (a decode step): narrow row tiles, wide reads of the
    # weights; thousands (a prompt pass): the tensor cores' tiles
    if n_pairs <= FEW_PAIRS:
        bm, bn, bk, warps, stages = 16, 64, 128, 4, 4
    else:
        bm, bn, bk, warps, stages = 64, 128, 64, 8, 3
    order, pair_start, tile_start = _grouping(ids, counts, bm)
    h = torch.empty((n_pairs, width), dtype=x.dtype, device=x.device)
    y = torch.empty((n_pairs, hidden), dtype=torch.float32, device=x.device)
    wf = w.to(torch.float32).contiguous()
    triton, gate_up, down = _kernels()
    m_tiles = triton.cdiv(n_pairs, bm) + e
    ep = triton.next_power_of_2(e)
    gate_up[(m_tiles, triton.cdiv(width, bn))](
        x, w_gate, w_up, h, order, pair_start, tile_start, hidden, width, k,
        x.stride(0), w_gate.stride(0), w_gate.stride(1), h.stride(0),
        E=e, EP=ep, BM=bm, BN=bn, BK=bk, num_warps=warps,
        num_stages=stages)
    down[(m_tiles, triton.cdiv(hidden, bn))](
        h, w_down, wf, y, order, pair_start, tile_start, hidden, width,
        h.stride(0), w_down.stride(0), w_down.stride(1), y.stride(0),
        E=e, EP=ep, BM=bm, BN=bn, BK=bk, num_warps=warps,
        num_stages=stages)
    LAUNCHES["moe_experts"] += 1
    return y.view(n_tok, k, hidden).sum(dim=1).to(x.dtype)
