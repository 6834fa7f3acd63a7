"""The split arithmetic of the flash prefill's backward kernels, on the CPU.

``kernels/csrc/flash_prefill_bwd.cu`` multiplies on the tensor cores,
which take bf16 operands and sum in f32. It writes an f32 operand as bf16
planes, x = x0 + x1 (+ x2) with x0 = bf16(x), x1 = bf16(x - x0), x2 =
bf16(x - x0 - x1), and sums the plane products whose order is below the
kept precision, smallest first: two planes (16 significant bits) for
dP = dO V^T and for the products with P or dS, three (24 bits) for
S = Q K^T. For bf16 inputs only P and dS (f32 in registers) are split.
The kernels run only on the card; this file emulates their arithmetic in
plain torch (exact bf16 plane products, f32 sums) and holds it against
float64 and against ``flash_prefill_backward_plain`` within the card's
tolerance, so that the split is shown to meet the limit before a chip run.
"""

import math

import numpy as np
import pytest
import torch

from leafgrasp_tpu_torch.kernels.flash_prefill import (
    flash_prefill_backward_plain, flash_prefill_plain)

F32 = torch.float32
# each gradient's largest difference over its L2 norm, as the card tests
FLASH_BWD_REL_TOL = 1e-5
# bf16 keeps 8 significant bits: |x - x0| <= U |x| with U = 2^-8
U = 2.0 ** -8
# plane products in the kernel's order (plane of A, plane of B)
TERMS = {3: ((1, 1), (2, 0), (0, 2), (1, 0), (0, 1), (0, 0)),
         2: ((1, 0), (0, 1), (0, 0)),
         1: ((0, 0),)}
SPLIT_A = ((1, 0), (0, 0))   # A (P or dS) in two planes, B exact in bf16


def planes(x: torch.Tensor, n: int) -> list:
    """x as n bf16 planes (values kept as f32): x0 = bf16(x), x1 =
    bf16(x - x0), ...; the rest is exact in f32."""
    out, rest = [], x.to(F32)
    for _ in range(n):
        hi = rest.to(torch.bfloat16).to(F32)
        out.append(hi)
        rest = rest - hi
    return out


def split_mm(a: torch.Tensor, b: torch.Tensor, n: int, terms=None):
    """a @ b as the kernel computes it: the plane products of ``terms``
    (by default those of n planes each), each exact, summed in f32."""
    terms = TERMS[n] if terms is None else terms
    pa = planes(a, max(i for i, _ in terms) + 1)
    pb = planes(b, max(j for _, j in terms) + 1)
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=F32)
    for i, j in terms:
        acc = acc + pa[i] @ pb[j]
    return acc


def emulated_backward(q, k, v, pad, out, lse, dout):
    """f32 (dq, dk, dv) as the two kernels compute them: S in three
    planes (f32 inputs), dP and the second products in two; for bf16
    inputs S and dP in one product and P, dS split in two planes."""
    b, t, heads, hd = q.shape
    rep = heads // k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    is_f32 = q.dtype == F32
    dq = torch.zeros(q.shape, dtype=F32)
    dk = torch.zeros(k.shape, dtype=F32)
    dv = torch.zeros(v.shape, dtype=F32)
    key = torch.arange(t)
    for bi in range(b):
        visible = (key[None, :] <= key[:, None]) \
            & (key[None, :] >= int(pad[bi]))
        for h in range(heads):
            kvh = h // rep
            qh, kh, vh = q[bi, :, h], k[bi, :t, kvh], v[bi, :t, kvh]
            doh, oh = dout[bi, :, h], out[bi, :, h]
            if is_f32:
                s = split_mm(qh, kh.T, 3)
                dp = split_mm(doh, vh.T, 2)
                second = dict(n=2)
            else:
                s = qh.to(F32) @ kh.to(F32).T
                dp = doh.to(F32) @ vh.to(F32).T
                second = dict(n=2, terms=SPLIT_A)
            p = torch.where(visible,
                            torch.exp(s * scale - lse[bi, h][:, None]),
                            torch.zeros(()))
            d = (doh.to(F32) * oh.to(F32)).sum(-1)
            ds = p * (dp - d[:, None])
            dv[bi, :t, kvh] += split_mm(p.T, doh.to(F32), **second)
            dk[bi, :t, kvh] += scale * split_mm(ds.T, qh.to(F32), **second)
            dq[bi, :, h] = scale * split_mm(ds, kh.to(F32), **second)
    return dq, dk, dv


def _tile(rng, rows, cols, mul=1.0):
    return torch.as_tensor(
        (rng.standard_normal((rows, cols)) * mul).astype(np.float32))


@pytest.mark.parametrize("mul", [1.0, 8.0])
def test_split_products_against_float64(mul):
    """Each plane product against float64, elementwise, within the bound
    the planes give: two planes drop 3 U^2 (the rests of a and b, and
    a1 b1) of sum |a b|, three 4 U^3; the f32 sums add at most one
    rounding (2^-24) of sum |a b| a term summed. On tiles at 8 times unit
    scale (|S scale| in the tens, as in the large-score card test) two
    planes put the exponent S / sqrt(hd) ten times further off than an
    f32 product does, three planes within twice it: the reason S takes
    three."""
    rng = np.random.default_rng(3)
    a, b = _tile(rng, 64, 128, mul), _tile(rng, 128, 32, mul)
    exact = a.double() @ b.double()
    mag = a.double().abs() @ b.double().abs()
    errs = {}
    for n, drop in ((2, 3 * U ** 2 * (1 + U) ** 2), (3, 4 * U ** 3)):
        err = (split_mm(a, b, n).double() - exact).abs()
        sums = len(TERMS[n]) * a.shape[1] * 2.0 ** -24
        assert bool((err <= (drop + sums) * mag).all()), n
        errs[n] = float(err.max()) / math.sqrt(a.shape[1])
    # bf16 operands with the f32 operand split: exact but for U^2 and sums
    bb = b.to(torch.bfloat16).to(F32)
    err = (split_mm(a, bb, 2, SPLIT_A).double()
           - a.double() @ bb.double()).abs()
    assert bool((err <= (2 * U ** 2 + 2 * 128 * 2.0 ** -24) * mag).all())
    f32 = float((a @ b).double().sub(exact).abs().max()) \
        / math.sqrt(a.shape[1])
    if mul == 8.0:
        assert errs[2] > 10 * f32 and errs[3] < 2 * f32, (errs, f32)


@pytest.mark.parametrize("mul", [1.0, 8.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,pads", [
    ((2, 128, 4, 2, 64), (0, 64)),
    ((3, 129, 4, 1, 128), (128, 0, 70)),
])
def test_split_backward_matches_plain(shape, pads, dtype, mul):
    """The backward with the kernels' split arithmetic against the plain
    f32 backward, at two of the card test's shapes, with q and k at unit
    scale and at 8 times it: each gradient within FLASH_BWD_REL_TOL of
    its norm, pad rows and keys exactly zero."""
    b, t, heads, kvh, hd = shape
    rng = np.random.default_rng(5)

    def t_(*s, m=1.0):
        return torch.as_tensor((rng.standard_normal(s) * m)
                               .astype(np.float32)).to(dtype)

    q, k = t_(b, t, heads, hd, m=mul), t_(b, t, kvh, hd, m=mul)
    v, dout = t_(b, t, kvh, hd), t_(b, t, heads, hd)
    pad = torch.tensor(pads, dtype=torch.int32)
    out, lse = flash_prefill_plain(q, k, v, pad, return_lse=True)
    want = flash_prefill_backward_plain(q, k, v, pad, out, lse, dout)
    got = emulated_backward(q, k, v, pad, out, lse, dout)
    for name, g, w in zip("qkv", got, want):
        assert bool(torch.isfinite(g).all()), name
        for i, p in enumerate(pads):
            assert not g[i, :p].any(), (name, i)
        err = float((g - w).abs().max())
        assert err <= FLASH_BWD_REL_TOL * float(w.norm()), (name, err)
