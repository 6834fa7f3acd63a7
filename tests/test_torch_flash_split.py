"""The split arithmetic of the flash prefill's f32 kernels, on the CPU.

``kernels/csrc/flash_prefill_bwd.cu`` (the backward) and the f32 forward
of ``kernels/csrc/flash_prefill.cu`` multiply on the tensor cores, which
take bf16 operands and sum in f32. They write an f32 operand as bf16
planes, x = x0 + x1 (+ x2) with x0 = bf16(x), x1 = bf16(x - x0), x2 =
bf16(x - x0 - x1), and sum the plane products whose order is below the
kept precision, smallest first. The backward: two planes (16
significant bits) for dP = dO V^T and for the products with P or dS,
three (24 bits) for S = Q K^T; for bf16 inputs only P and dS (f32 in
registers) are split. The forward: three planes of q and k for S, and
O += P V with P in two planes and V in three (five products). The
kernels run only on the card; this file emulates their arithmetic in
plain torch (exact bf16 plane products, f32 sums; the forward's running
softmax over 32-key tiles and its log-sum-exp as the kernel forms them)
and holds it against float64 and against the plain versions within the
card's tolerances, so that the split is shown to meet the limit before a
chip run, and each plane count to be needed.
"""
import math

import numpy as np
import pytest
import torch

from leafgrasp_tpu_torch.kernels.flash_prefill import (
    flash_prefill_backward_plain, flash_prefill_plain)

F32 = torch.float32
LOG2E = 1.4426950408889634
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
    """a @ b (batched over leading dimensions) as the kernels compute it:
    the plane products of ``terms`` (by default those of n planes each),
    each exact, summed in f32."""
    terms = TERMS[n] if terms is None else terms
    pa = planes(a, max(i for i, _ in terms) + 1)
    pb = planes(b, max(j for _, j in terms) + 1)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=F32)
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


# ---- the f32 forward ------------------------------------------------------

# the card's f32 limit of the forward's output, absolute
# (tests/test_torch_cuda.py FLASH_TOL), and of its log-sum-exp (phase 8a
# of chip_smoke.py)
FLASH_TOL_F32 = 2e-5
FLASH_LSE_TOL = 1e-5
# at 8 times unit scale both limits take that many f32 ulps of the row's
# score terms as slack (see score_slack)
SCORE_ULPS = 4
BN = 32                      # keys a tile of the forward kernel
# O += P V: P (A) in two planes, V (B) in three, smallest first
PV_TERMS = ((1, 1), (0, 2), (1, 0), (0, 1), (0, 0))


def emulated_forward(q, k, v, pad, s_planes=3, pv_terms=PV_TERMS):
    """(out, lse) as the f32 forward kernel computes them: 32-key tiles
    from the first pad's tile to t, S = Q K^T in ``s_planes`` planes, the
    running maximum in raw score units, P = exp2(S scale log2(e) - m
    scale log2(e)) with one rounding (the kernel's fused multiply-add),
    O and the row sum rescaled by exp2((m_old - m) scale log2(e)), O += P
    V over ``pv_terms``; out = O / l on real rows, 0 on pad rows; lse =
    (m scale log2(e) + log2 l) ln 2, -inf on pad rows."""
    b, t, heads, hd = q.shape
    rep = heads // k.shape[2]
    scale2 = torch.tensor(1.0 / math.sqrt(hd), dtype=F32) \
        * torch.tensor(LOG2E, dtype=F32)
    qh = q.to(F32).transpose(1, 2)                           # b, h, t, hd
    kh = k[:, :t].to(F32).repeat_interleave(rep, 2).transpose(1, 2)
    vh = v[:, :t].to(F32).repeat_interleave(rep, 2).transpose(1, 2)
    rows = torch.arange(t)
    padl = pad.to(torch.int64)
    m = torch.full((b, heads, t), -math.inf)
    l_sum = torch.zeros((b, heads, t))
    o = torch.zeros((b, heads, t, hd))
    for c0 in range(int(padl.min()) // BN * BN, t, BN):
        keys = torch.arange(c0, min(t, c0 + BN))
        s = split_mm(qh, kh[:, :, keys].transpose(-1, -2), s_planes)
        vis = (keys[None, None, :] <= rows[None, :, None]) \
            & (keys[None, None, :] >= padl[:, None, None])
        s = torch.where(vis[:, None], s, torch.full_like(s, -math.inf))
        m_new = torch.maximum(m, s.amax(-1))
        # a row with no key yet keeps -inf and subtracts 0
        mu = torch.where(m_new == -math.inf, torch.zeros_like(m_new), m_new)
        alpha = torch.exp2((m - mu) * scale2)
        p = torch.exp2((s.double() * scale2.double()
                        - (mu * scale2).double()[..., None]).to(F32))
        m = m_new
        l_sum = l_sum * alpha + p.sum(-1)
        o = o * alpha[..., None] + split_mm(p, vh[:, :, keys], 0, pv_terms)
    real = (rows[None, :] >= padl[:, None])[:, None] & (l_sum > 0)
    inv = torch.where(real, 1.0 / l_sum, torch.zeros_like(l_sum))
    lse = torch.where(real, (m * scale2 + torch.log2(l_sum))
                      * 0.6931471805599453, torch.full_like(m, -math.inf))
    return (o * inv[..., None]).transpose(1, 2), lse


def float64_forward(q, k, v, pad):
    """(out, lse, P) in float64 from the f32 inputs (the plain version
    computes its scores in f32 whatever its input type)."""
    b, t, heads, hd = q.shape
    rep = heads // k.shape[2]
    kd = k[:, :t].double().repeat_interleave(rep, 2)
    vd = v[:, :t].double().repeat_interleave(rep, 2)
    s = torch.einsum("bihd,bjhd->bhij", q.double(), kd) / math.sqrt(hd)
    key = torch.arange(t)
    vis = (key[None, None, :] <= key[None, :, None]) \
        & (key[None, None, :] >= pad.to(torch.int64)[:, None, None])
    s = torch.where(vis[:, None], s, torch.full_like(s, -math.inf))
    lse = torch.logsumexp(s, -1)
    p = torch.nan_to_num(torch.exp(s - lse[..., None]))
    return torch.einsum("bhij,bjhd->bihd", p, vd), lse, p


def score_terms(q, k):
    """(b, heads, t): the largest over a row's keys of sum_d |q_d k_d|
    times the scale, the size of what an f32 sum of S scale adds up."""
    t, hd = q.shape[1], q.shape[3]
    rep = q.shape[2] // k.shape[2]
    kk = k[:, :t].double().abs().repeat_interleave(rep, 2)
    return torch.einsum("bihd,bjhd->bhij", q.double().abs(), kk) \
        .amax(-1) / math.sqrt(hd)


def score_slack(q, k, v, pad, ulps):
    """(b, t, heads, hd): how far ``ulps`` f32 ulps of each row's score
    terms in the scores move an output. A change d_j of S_j scale moves
    O_i by sum_j P_ij d_j (v_j - O_i), so by at most max |d| sum_j P_ij
    |v_j - O_i|. Two f32 sums of S over hd in other orders (kernel and
    plain version) differ by a few ulps of the terms, some 500 at 8
    times unit scale (an ulp 3e-5 to 6e-5): between near-equal top
    scores that moves O by up to 1e-4, more than the plain f32 version's
    own distance from float64 allows any kernel. A one-hot row takes no
    slack (its sum is 0)."""
    o, _, p = float64_forward(q, k, v, pad)
    rep = q.shape[2] // k.shape[2]
    vd = v[:, :q.shape[1]].double().repeat_interleave(rep, 2)
    spread = torch.zeros(o.shape, dtype=torch.float64)
    for bi in range(q.shape[0]):
        for h in range(q.shape[2]):
            dev = (vd[bi, None, :, h] - o[bi, :, None, h]).abs()   # i, j, d
            spread[bi, :, h] = (p[bi, h][..., None] * dev).sum(1)
    terms = score_terms(q, k).transpose(1, 2)[..., None]       # b, t, h, 1
    return ulps * 2.0 ** -23 * terms * spread


def _forward_inputs(shape, pads, mul, seed=21):
    b, t, heads, kvh, hd = shape
    rng = np.random.default_rng(seed)

    def t_(*s, m=1.0):
        return torch.as_tensor((rng.standard_normal(s) * m)
                               .astype(np.float32))

    q, k = t_(b, t, heads, hd, m=mul), t_(b, t, kvh, hd, m=mul)
    return q, k, t_(b, t, kvh, hd), torch.tensor(pads, dtype=torch.int32)


def _over(got, want, pad, slack):
    """The largest amount by which |got - want| on real rows exceeds
    FLASH_TOL_F32 plus the slack (<= 0 passes)."""
    real = (torch.arange(got.shape[1])[None, :]
            >= pad.to(torch.int64)[:, None])[:, :, None, None]
    diff = (got.double() - want.double()).abs() * real
    return float((diff - FLASH_TOL_F32 - slack).max())


def _lse_over(got, want, q, k, ulps):
    real = torch.isfinite(want)
    assert torch.equal(real, torch.isfinite(got))
    err = (got.double() - want.double())[real].abs()
    tol = FLASH_LSE_TOL + ulps * 2.0 ** -23 * score_terms(q, k)[real]
    return float((err - tol).max())


# the card test's f32 shapes of tests/test_torch_cuda.py that are small
# enough here, with their pads
FORWARD_SHAPES = [((2, 200, 4, 2, 64), (0, 37)),
                  ((3, 129, 4, 4, 64), (128, 0, 64)),
                  ((2, 333, 6, 2, 128), (70, 5)),
                  ((1, 1, 4, 1, 128), (0,)),
                  ((2, 100, 4, 4, 128), (0, 99)),
                  ((2, 257, 8, 2, 128), (130, 70))]


@pytest.mark.parametrize("mul", [1.0, 8.0])
@pytest.mark.parametrize("shape,pads", FORWARD_SHAPES)
def test_split_forward_matches_plain_and_float64(shape, pads, mul):
    """The forward with the kernel's planes, sum order and running
    softmax against ``flash_prefill_plain`` and against float64: the
    output within the card's f32 limit (2e-5) on real rows, exactly 0 on
    pad rows; the log-sum-exp within 1e-5, -inf on pad rows. With q and
    k at 8 times unit scale both limits take SCORE_ULPS ulps of the
    score terms as slack (``score_slack``), as the card holds the
    log-sum-exp there."""
    q, k, v, pad = _forward_inputs(shape, pads, mul)
    ulps = 0 if mul == 1.0 else SCORE_ULPS
    got, lse = emulated_forward(q, k, v, pad)
    want, lse_plain = flash_prefill_plain(q, k, v, pad, return_lse=True)
    exact, lse64, _ = float64_forward(q, k, v, pad)
    slack = score_slack(q, k, v, pad, ulps) if ulps else 0.0
    assert bool(torch.isfinite(got).all())
    for i, p in enumerate(pads):
        assert not got[i, :p].any(), i
    assert _over(got, want, pad, slack) <= 0.0
    assert _over(got, exact, pad, slack) <= 0.0
    assert _lse_over(lse, lse_plain, q, k, ulps) <= 0.0
    assert _lse_over(lse, lse64, q, k, ulps) <= 0.0


def test_split_forward_plane_counts_are_needed():
    """One plane fewer anywhere misses the limit. P in one plane (bf16
    probabilities) puts the output 1e-3 off at unit scale. S in two
    planes misses even the slack at 8 times unit scale (its error enters
    the exponent). V in two planes: a row whose probabilities are one-hot
    returns its V row (P = 1 is one exact plane), which two planes leave
    up to 2^-17 of the value off: at the training shape's V (2, 642 + 10
    rows, 8 heads of 128) some elements pass 2e-5; three planes return
    it exactly."""
    q, k, v, pad = _forward_inputs((2, 257, 8, 2, 128), (130, 70), 1.0)
    want = flash_prefill_plain(q, k, v, pad)
    p_one = emulated_forward(q, k, v, pad,
                             pv_terms=((0, 2), (0, 1), (0, 0)))[0]
    assert _over(p_one, want, pad, 0.0) > 10 * FLASH_TOL_F32
    q, k, v, pad = _forward_inputs((2, 257, 8, 2, 128), (130, 70), 8.0)
    want = flash_prefill_plain(q, k, v, pad)
    slack = score_slack(q, k, v, pad, SCORE_ULPS)
    s_two = emulated_forward(q, k, v, pad, s_planes=2)[0]
    assert _over(s_two, want, pad, slack) > 0.0
    rng = np.random.default_rng(21)
    vt = torch.as_tensor(rng.standard_normal((2, 8, 652, 128))
                         .astype(np.float32))
    one_hot = torch.eye(652, dtype=F32)
    for terms, limit in ((((1, 0), (0, 1), (0, 0)), False),
                         (PV_TERMS, True)):
        err = float((split_mm(one_hot, vt, 0, terms).double()
                     - vt.double()).abs().max())
        assert (err <= FLASH_TOL_F32) == limit, (terms, err)
        if limit:
            assert err == 0.0


def test_plain_f32_forward_needs_the_score_slack_at_large_scores():
    """Why the limit takes a slack at 8 times unit scale: there the plain
    f32 version itself is more than 2e-5 from float64 (its S is an f32
    sum of terms near 500), and within the slack of ``score_slack``; at
    unit scale it is within 2e-5 without one."""
    for mul, ulps, beyond in ((1.0, 0, False), (8.0, SCORE_ULPS, True)):
        q, k, v, pad = _forward_inputs((2, 257, 8, 2, 128), (130, 70), mul)
        want = flash_prefill_plain(q, k, v, pad)
        exact, _, _ = float64_forward(q, k, v, pad)
        assert (_over(want, exact, pad, 0.0) > 0.0) == beyond, mul
        if ulps:
            slack = score_slack(q, k, v, pad, ulps)
            assert _over(want, exact, pad, slack) <= 0.0
