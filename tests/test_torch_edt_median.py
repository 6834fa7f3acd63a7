"""The port's batch EDTs (row-banded kernel module), the segment
histogram and histogram median (histogram kernel module), and the
``union_half`` isolation mode, against the JAX package on the same numpy
inputs. The Pallas kernels run in interpret mode, as the JAX package's
own tests run them on the CPU.

Tolerances: every EDT bit-exact (integer squared distances, one
correctly rounded root), the row-banded plain version on +inf fields
equal to a float64 brute force; histogram counts equal; the histogram median
1e-6 against the JAX histogram median (the same arithmetic, different
summation libraries) and range / 256^2 against ``np.median``;
``union_half`` distance fields bit-exact, score maps 1e-5 absolute,
valid mask equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import leafgrasp_tpu.config as jcfg
import leafgrasp_tpu_torch.config as tcfg
from leafgrasp_tpu.io.scenes import make_leaf_scene
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from leafgrasp_tpu_torch import kernels
from leafgrasp_tpu_torch.kernels.histogram import (NBINS, segment_histogram,
                                                   segment_histogram_plain)
from leafgrasp_tpu_torch.kernels.rowband import (TILE_COLS, TILE_ROWS,
                                                 rowband_radii_plain,
                                                 squared_edt_rowband,
                                                 squared_edt_rowband_plain)
from leafgrasp_tpu_torch.ops import edt as tedt
from leafgrasp_tpu_torch.ops.components import leaf_stats
from leafgrasp_tpu_torch.ops.median import masked_median_hist

CX, CY, F = np.float32(236.0), np.float32(165.0), np.float32(583.0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _seeds(h=96, w=160):
    """The four channels of the JAX package's row-band test: every leaf,
    one leaf, sparse noise, and a seedless channel."""
    mask, _ = make_leaf_scene(height=h, width=w, num_leaves=3, seed=4,
                              margin=20)
    rng = np.random.default_rng(9)
    return np.stack([mask > 0, mask == 2, rng.random((h, w)) < 0.002,
                     np.zeros((h, w), bool)])


@pytest.fixture(scope="module")
def small_scene():
    return make_leaf_scene(height=270, width=360, num_leaves=4, seed=3,
                           margin=40)


# ---- batch EDTs ---------------------------------------------------------------

@pytest.mark.parametrize("name,shape", [("edt_batch", (96, 160)),
                                        ("edt_batch_rowband", (96, 160)),
                                        ("edt_batch", (75, 130))])
def test_edt_batch_matches_jax(name, shape):
    from leafgrasp_tpu.ops.edt import edt_batch as j_edt_batch
    from leafgrasp_tpu.ops.pallas_edt import edt_batch_rowband as j_rowband
    seeds = _seeds(*shape)
    want = np.asarray(j_edt_batch(jnp.asarray(seeds)))
    np.testing.assert_array_equal(
        np.asarray(j_rowband(jnp.asarray(seeds), interpret=True)), want)
    kernels.reset_launch_counts()
    got = getattr(tedt, name)(_t(seeds)).numpy()
    np.testing.assert_array_equal(got, want)
    # a seedless channel keeps the sentinel H + W
    assert (got[3] == sum(shape)).all()
    # a single (H, W) mask comes back (H, W)
    np.testing.assert_array_equal(
        getattr(tedt, name)(_t(seeds[1])).numpy(), want[1])
    assert set(kernels.launch_counts().values()) == {0}


def test_signed_edt_matches_jax():
    from leafgrasp_tpu.ops.edt import signed_edt as j_signed
    seeds = _seeds()
    for m in (seeds[0], seeds[1]):
        np.testing.assert_array_equal(
            tedt.signed_edt(_t(m)).numpy(), np.asarray(j_signed(m)))


@pytest.mark.parametrize("shape", [(96, 160), (75, 130)])
def test_rowband_plain_matches_pallas_and_bruteforce(shape):
    from leafgrasp_tpu.ops.edt import nearest_seed_dist_1d
    from leafgrasp_tpu.ops.pallas_edt import squared_edt_rowband as j_rowband
    h, w = shape
    seeds = _seeds(h, w)
    g = np.asarray(nearest_seed_dist_1d(jnp.asarray(seeds), axis=2),
                   np.float32)
    g2r = g * g
    want = np.asarray(j_rowband(g2r, interpret=True))
    got = squared_edt_rowband_plain(_t(g2r)).numpy()
    np.testing.assert_array_equal(got, want)
    i = np.arange(h, dtype=np.float64)
    brute = (g2r[:, None, :, :].astype(np.float64)
             + ((i[:, None] - i[None, :]) ** 2)[None, :, :, None]).min(axis=2)
    np.testing.assert_array_equal(got, brute.astype(np.float32))


def test_rowband_radii_bound_the_result():
    """The radii give an exact band: restricting each tile's candidate
    rows to its radius changes nothing, and the winning row always lies
    within it."""
    seeds = _seeds(75, 130)
    g = tedt.nearest_seed_dist_1d(_t(seeds), axis=2).to(torch.float32)
    g2r = (g * g).contiguous()
    out, nb = squared_edt_rowband(g2r, return_radii=True)
    c, h, w = g2r.shape
    assert nb.dtype == torch.int32
    assert tuple(nb.shape) == (c, -(-h // TILE_ROWS), -(-w // TILE_COLS))
    assert torch.equal(nb, rowband_radii_plain(g2r))
    nb_px = nb.repeat_interleave(TILE_ROWS, 1)[:, :h] \
        .repeat_interleave(TILE_COLS, 2)[:, :, :w].to(torch.float32)
    # a radius clamped to H already spans every row
    assert bool(((out <= nb_px * nb_px) | (nb_px >= h)).all())
    rows = torch.arange(h)
    tile0 = (rows // TILE_ROWS) * TILE_ROWS
    banded = torch.empty_like(out)
    for ci in range(c):
        for i in range(h):
            r = nb_px[ci, i].to(torch.int64)                     # (W,)
            lo = torch.clamp(tile0[i] - r, min=0)
            hi = torch.clamp(tile0[i] + TILE_ROWS - 1 + r, max=h - 1)
            inside = (rows[:, None] >= lo[None, :]) \
                & (rows[:, None] <= hi[None, :])
            d = (rows - i).to(torch.float32)[:, None]
            cand = torch.where(inside, g2r[ci] + d * d,
                               torch.full_like(g2r[ci], float("inf")))
            banded[ci, i] = cand.amin(dim=0)
    assert torch.equal(banded, out)


def _rowband_brute(g2r):
    """float64 reference of the row min-plus, +inf included."""
    g = g2r.astype(np.float64)
    i = np.arange(g.shape[1], dtype=np.float64)
    off = (i[:, None] - i[None, :]) ** 2                    # (out, cand)
    return (g[:, None, :, :] + off[None, :, :, None]).min(axis=2)


def _radii_brute(g2r):
    """float64 reference of the per-tile radii (``rowband_radii_plain``'s
    definition): 8-row pooled minima, the min-plus at tile resolution
    with the offset (8 (|I - K| + 1))^2, each tile's largest value over
    its columns (columns past W bound nothing), floor(sqrt) + 1, at most
    H."""
    c, h, w = g2r.shape
    rt, ct = -(-h // TILE_ROWS), -(-w // TILE_COLS)
    g = np.full((c, rt * TILE_ROWS, w), np.inf)
    g[:, :h] = g2r
    pooled = g.reshape(c, rt, TILE_ROWS, w).min(axis=2)
    k = np.arange(rt)
    off = ((np.abs(k[:, None] - k[None, :]) + 1) * TILE_ROWS) ** 2.0
    upper = (pooled[:, None, :, :] + off[None, :, :, None]).min(axis=2)
    upper = np.pad(upper, ((0, 0), (0, 0), (0, ct * TILE_COLS - w)))
    tile_max = upper.reshape(c, rt, ct, TILE_COLS).max(axis=3)
    nb = np.floor(np.sqrt(np.minimum(tile_max, float(h) * h))) + 1
    return np.minimum(nb, h).astype(np.int32)


@pytest.mark.parametrize("case", ["inf_rows", "inf_cols"])
@pytest.mark.parametrize("shape", [(1, 24, 130), (2, 40, 257)])
def test_rowband_plain_on_inf_fields_matches_float64(shape, case):
    """Fields that are +inf but for a few finite rows, and finite fields
    with whole +inf columns: the plain version, which the card holds the
    row-banded kernel to, against a float64 brute force (the JAX kernel
    cannot be the oracle here: it casts sqrt(+inf) to int32 and leaves
    +inf where the answer is finite). The radii equal their float64
    definition, and restricting each tile to its radius changes nothing."""
    c, h, w = shape
    rng = np.random.default_rng(h + w)
    if case == "inf_rows":
        g2r = np.full(shape, np.inf, np.float32)
        g2r[0, 5, :64] = 0.0
        g2r[0, h - 7, 100:] = rng.integers(0, 50, w - 100)
        g2r[1:, 3] = rng.integers(0, 500, w)
    else:
        g2r = rng.integers(0, 2000, shape).astype(np.float32)
        g2r[:, :, :10] = np.inf
        g2r[:, :, 128:141] = np.inf
        g2r[:, :, w - 1] = np.inf
    want = _rowband_brute(g2r)
    got = squared_edt_rowband_plain(_t(g2r)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.float32))
    assert np.isfinite(got).any() and not np.isfinite(got).all()
    if case == "inf_rows":     # a finite row reaches every row, columns
        assert np.isfinite(got[0, :, :64]).all()    # 64-99 have none
        assert np.isinf(got[0, :, 64:100]).all()
    nb = rowband_radii_plain(_t(g2r)).numpy()
    np.testing.assert_array_equal(nb, _radii_brute(g2r))
    rows = np.arange(h)
    tile0 = (rows // TILE_ROWS) * TILE_ROWS
    nb_px = np.repeat(np.repeat(nb, TILE_ROWS, 1)[:, :h], TILE_COLS,
                      2)[:, :, :w]
    lo = np.maximum(tile0[None, :, None] - nb_px, 0)
    hi = np.minimum(tile0[None, :, None] + TILE_ROWS - 1 + nb_px, h - 1)
    inside = (rows[None, None, :, None] >= lo[:, :, None, :]) \
        & (rows[None, None, :, None] <= hi[:, :, None, :])
    off = ((rows[:, None] - rows[None, :]) ** 2.0)[None, :, :, None]
    banded = np.where(inside, g2r[:, None].astype(np.float64) + off,
                      np.inf).min(axis=2)
    np.testing.assert_array_equal(banded, want)


def test_rowband_wrapper_checks():
    with pytest.raises(ValueError):
        squared_edt_rowband(torch.zeros((4, 4)))
    with pytest.raises(ValueError):
        squared_edt_rowband(torch.zeros((1, 4, 4), dtype=torch.float64))
    with pytest.raises(ValueError):
        squared_edt_rowband(torch.zeros((1, 0, 4)))
    with pytest.raises(ValueError):
        squared_edt_rowband(torch.zeros((1, 4, 4), device="meta"))


# ---- histogram and median -----------------------------------------------------

def test_segment_histogram_matches_pallas_and_numpy():
    from leafgrasp_tpu.ops.pallas_median import segment_histogram as j_hist
    rng = np.random.default_rng(0)
    h, w, num = 40, 70, 5
    depth = rng.random((h, w)).astype(np.float32)
    ids = rng.integers(0, num, (h, w)).astype(np.int32)
    lo = (rng.random(num) * 0.3).astype(np.float32)
    inv_w = (NBINS / (0.2 + rng.random(num))).astype(np.float32)
    want = np.asarray(j_hist(depth, ids, lo, inv_w, num, interpret=True))
    kernels.reset_launch_counts()
    got = segment_histogram(_t(depth), _t(ids), _t(lo), _t(inv_w), num)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    for n in range(num):
        vals = depth[ids == n]
        bins = np.clip((vals - lo[n]) * inv_w[n], 0, NBINS - 1) \
            .astype(np.int32)
        np.testing.assert_array_equal(
            got[n].numpy(), np.bincount(bins, minlength=NBINS))
    assert kernels.launch_counts()["segment_histogram"] == 0


def test_segment_histogram_ignores_ids_out_of_range_and_checks():
    rng = np.random.default_rng(1)
    depth = _t(rng.random((9, 11)).astype(np.float32))
    ids = _t(rng.integers(-2, 6, (9, 11)).astype(np.int64))
    lo, inv_w = torch.zeros(4), torch.full((4,), float(NBINS))
    got = segment_histogram_plain(depth, ids, lo, inv_w, 4)
    assert float(got.sum()) == float(((ids >= 0) & (ids < 4)).sum())
    keep = (ids >= 0) & (ids < 4)
    only = segment_histogram_plain(depth[keep], ids[keep], lo, inv_w, 4)
    assert torch.equal(got, only)
    bad = [dict(depth=depth.double()), dict(ids=ids.float()),
           dict(ids=ids[:3]), dict(lo=lo[:2]), dict(inv_w=inv_w.double()),
           dict(num=0)]
    for kw in bad:
        args = dict(depth=depth, ids=ids, lo=lo, inv_w=inv_w, num=4)
        args.update(kw)
        if "num" in kw:
            args["lo"], args["inv_w"] = lo[:0], inv_w[:0]
        with pytest.raises(ValueError):
            segment_histogram(**args)
    with pytest.raises(ValueError):
        segment_histogram(depth.to("meta"), ids.to("meta"), lo.to("meta"),
                          inv_w.to("meta"), 4)


@pytest.mark.parametrize("brackets", [1, 2])
def test_segment_histogram_brackets_match_pallas(brackets):
    """The (R, num) form: each slice equals one call of the JAX package's
    ``segment_histogram`` (interpret mode) with that bracket, on a frame
    whose pixel count is no multiple of 8, with ids out of range; the
    wrapper on CPU tensors is the plain version, with no launch."""
    from leafgrasp_tpu.ops.pallas_median import segment_histogram as j_hist
    rng = np.random.default_rng(3 + brackets)
    h, w, num = 37, 71, 7
    depth = rng.random((h, w)).astype(np.float32)
    ids = rng.integers(-1, num + 1, (h, w)).astype(np.int32)
    lo = (rng.random((brackets, num)) * 0.4).astype(np.float32)
    inv_w = (NBINS / (0.1 + rng.random((brackets, num)))).astype(np.float32)
    kernels.reset_launch_counts()
    got = segment_histogram(_t(depth), _t(ids), _t(lo), _t(inv_w), num)
    assert got.shape == (brackets, num, NBINS) and got.dtype == torch.float32
    for r in range(brackets):
        want = np.asarray(j_hist(depth, ids, lo[r], inv_w[r], num,
                                 interpret=True))
        keep = (ids >= 0) & (ids < num)
        want_np = np.stack([np.bincount(np.clip(
            (depth[keep & (ids == n)] - lo[r, n]) * inv_w[r, n], 0,
            NBINS - 1).astype(np.int32), minlength=NBINS)
            for n in range(num)])
        np.testing.assert_array_equal(want, want_np)
        np.testing.assert_array_equal(got[r].numpy(), want_np)
        one = segment_histogram_plain(_t(depth), _t(ids), _t(lo[r]),
                                      _t(inv_w[r]), num)
        assert torch.equal(one, got[r])
    # a contiguous view at an offset (the kernel's unaligned head)
    flat_d, flat_i = _t(depth).reshape(-1), _t(ids).reshape(-1)
    assert torch.equal(
        segment_histogram(flat_d[3:], flat_i[3:], _t(lo), _t(inv_w), num),
        segment_histogram_plain(flat_d[3:].clone(), flat_i[3:].clone(),
                                _t(lo), _t(inv_w), num))
    assert kernels.launch_counts()["segment_histogram"] == 0


def test_segment_histogram_checks_bracket_shapes():
    depth = torch.rand((6, 9))
    ids = torch.zeros((6, 9), dtype=torch.int32)
    ok = torch.zeros((2, 4))
    bad = [(torch.zeros((3, 4)), torch.zeros((3, 4))),     # R past 2
           (ok, torch.zeros((1, 4))),                      # R differs
           (ok, torch.zeros(4)),
           (torch.zeros((2, 5)), torch.zeros((2, 5))),     # not num
           (torch.zeros((1, 2, 4)), torch.zeros((1, 2, 4))),
           (ok.double(), ok.double())]
    for lo, inv_w in bad:
        with pytest.raises(ValueError):
            segment_histogram(depth, ids, lo, inv_w, 4)
    assert segment_histogram(depth, ids, ok, ok, 4).shape == (2, 4, NBINS)


def test_masked_median_hist_takes_two_histograms(monkeypatch):
    """One histogram of one bracket, then one of the two order
    statistics' brackets together; the medians are those of three
    one-bracket histograms, bit for bit."""
    from leafgrasp_tpu_torch.ops import median
    rng = np.random.default_rng(4)
    depth = _t((rng.random((50, 80)) * 0.5 + 0.3).astype(np.float32))
    ids = _t(rng.integers(0, 5, (50, 80)).astype(np.int32))
    counts = torch.bincount(ids.reshape(-1).long(), minlength=5)
    shapes = []

    def spy(d, i, lo, inv_w, num):
        shapes.append(tuple(lo.shape))
        return segment_histogram(d, i, lo, inv_w, num)

    monkeypatch.setattr(median, "segment_histogram", spy)
    got = median.masked_median_hist(depth, ids, counts, 5)
    assert shapes == [(5,), (2, 5)]
    # the three-call construction of the JAX package, one bracket a call
    lo = depth.min().expand(5)
    width = torch.clamp(depth.max() - depth.min(), min=1e-12).expand(5)
    hist1 = segment_histogram(depth, ids, lo, NBINS / width, 5)
    mids = []
    for k in (torch.clamp(counts - 1, min=0) // 2, counts // 2):
        kf = k.to(torch.float32)
        lo_k, w_k = median._refine(hist1, kf, lo, width)
        hist2 = segment_histogram(depth, ids, lo_k.contiguous(),
                                  NBINS / w_k, 5)
        lo_k, w_k = median._refine(hist2, kf, lo_k, w_k)
        mids.append(lo_k + 0.5 * w_k)
    assert torch.equal(got, 0.5 * (mids[0] + mids[1]))


def test_masked_median_hist_matches_pallas_and_numpy():
    from leafgrasp_tpu.ops.pallas_median import masked_median_pallas
    rng = np.random.default_rng(2)
    h, w, num = 64, 96, 6
    depth = (rng.random((h, w)) * 0.5 + 0.3).astype(np.float32)
    ids = rng.integers(0, num, (h, w)).astype(np.int32)
    counts = np.bincount(ids.ravel(), minlength=num)
    want = np.asarray(masked_median_pallas(depth, ids, counts, num,
                                           levels=2, interpret=True))
    got = masked_median_hist(_t(depth), _t(ids), _t(counts), num).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    span = depth.max() - depth.min()
    for n in range(num):
        assert abs(got[n] - np.median(depth[ids == n])) <= span / 256 ** 2


def test_leaf_stats_hist_median_parity(small_scene):
    """``hist_median=True`` agrees with the default on every statistic
    (the medians within the histogram's envelope) and picks the same
    leaf, as the JAX package asks of its ``use_pallas`` argument."""
    from leafgrasp_tpu_torch.geometry.leaf_scorer import select_optimal_leaf
    mask, depth = small_scene
    mt, dt = _t(mask.astype(np.int32)), _t(depth)
    a = leaf_stats(mt, dt, 8, CX, CY, F)
    b = leaf_stats(mt, dt, 8, CX, CY, F, hist_median=True)
    span = float(depth.max() - depth.min())
    present = a.present.numpy()
    assert present.sum() == 4
    np.testing.assert_allclose(a.median_depth.numpy()[present],
                               b.median_depth.numpy()[present], rtol=0,
                               atol=span / 256 ** 2 + span * 2 ** -18)
    for n in np.where(present)[0]:
        assert abs(b.median_depth[n] - np.median(depth[mask == n + 1])) \
            <= span / 256 ** 2
    for name in a._fields:
        if name != "median_depth":
            assert torch.equal(getattr(a, name), getattr(b, name)), name
    scal = [_t(v) for v in (CX, CY, F)]
    sa = select_optimal_leaf(mt, dt, *scal)
    sb = select_optimal_leaf(mt, dt, *scal, hist_median=True)
    assert int(sa.best_leaf_id) == int(sb.best_leaf_id) > 0
    assert torch.equal(sa.is_tall, sb.is_tall)


# ---- union_half ---------------------------------------------------------------

@pytest.mark.parametrize("shape", [(270, 360), (135, 181)])
def test_compute_grasp_scores_union_half_matches_jax(shape):
    """270 x 360 is the stated size; 135 x 181 has odd sides, so the
    half-resolution fields are edge-padded."""
    from leafgrasp_tpu.geometry.grasp_scorer import \
        compute_grasp_scores as j_scores
    from leafgrasp_tpu_torch.geometry.grasp_scorer import compute_grasp_scores
    h, w = shape
    mask, depth = make_leaf_scene(height=h, width=w, num_leaves=4, seed=3,
                                  margin=min(40, h // 5))
    leaf = mask == 3
    jc = jcfg.GraspScoringConfig(isolation_context="union_half")
    tc = tcfg.GraspScoringConfig(isolation_context="union_half")
    want = j_scores(leaf, mask > 0, depth, CX, CY, F, cfg=jc)
    kernels.reset_launch_counts()
    got = compute_grasp_scores(_t(leaf), _t(mask > 0), _t(depth), _t(CX),
                               _t(CY), _t(F), cfg=tc)
    # the interior distance field is exact
    np.testing.assert_array_equal(got.distance_map.numpy(),
                                  np.asarray(want.distance_map))
    for name in got._fields:
        a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        if name == "valid_region":
            np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5, err_msg=name)
    assert got.isolation_map.numpy()[leaf].min() < 1.0   # a field is there
    assert set(kernels.launch_counts().values()) == {0}


def test_half_edt_fields_are_bit_exact():
    """The half-resolution interference fields themselves, against the
    JAX construction (grasp_scorer.py half_edt), at an odd size."""
    from leafgrasp_tpu.ops.edt import edt_batch as j_edt_batch
    from leafgrasp_tpu.ops.morphology import dilate as j_dilate, \
        elliptical_kernel as j_kernel
    from leafgrasp_tpu_torch.geometry.grasp_scorer import _half_edt
    from leafgrasp_tpu_torch.ops.morphology import dilate, elliptical_kernel
    h, w = 135, 181
    mask, _ = make_leaf_scene(height=h, width=w, num_leaves=4, seed=3,
                              margin=27)
    other = (mask > 0) & (mask != 3)
    for k in (30, 40):
        inter = np.asarray(j_dilate(other, j_kernel(k)))
        hh, wh = h // 2, w // 2
        pooled = inter[:hh * 2, :wh * 2].reshape(hh, 2, wh, 2) \
            .any(axis=(1, 3))
        d = np.asarray(j_edt_batch(jnp.asarray(pooled[None])))[0] * 2.0
        up = np.repeat(np.repeat(d, 2, axis=0), 2, axis=1)
        want = np.pad(up, ((0, h - hh * 2), (0, w - wh * 2)), mode="edge")
        got = _half_edt(dilate(_t(other), elliptical_kernel(k))).numpy()
        assert got.shape == (h, w)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("with_cnn", [False, True])
def test_frame_union_half_matches_jax(small_scene, with_cnn):
    import jax
    from leafgrasp_tpu.models.grasp_cnn import init_grasp_cnn
    from leafgrasp_tpu.pipeline.frame import make_frame_fn as j_make
    from leafgrasp_tpu_torch.models.convert import flax_to_torch_grasp_cnn
    from leafgrasp_tpu_torch.models.grasp_cnn import GraspPointCNN
    from leafgrasp_tpu_torch.pipeline.frame import make_frame_fn
    mask, depth = small_scene
    jc = jcfg.DEFAULT_CONFIG.replace(
        grasp=jcfg.GraspScoringConfig(isolation_context="union_half"))
    tc = tcfg.DEFAULT_CONFIG.replace(
        grasp=tcfg.GraspScoringConfig(isolation_context="union_half"))
    args = (mask, depth, CX, CY, F)
    jfn = j_make(jc, with_cnn=with_cnn)
    tfn = make_frame_fn(tc, with_cnn=with_cnn, device="cpu")
    kernels.reset_launch_counts()
    if with_cnn:
        _, variables = init_grasp_cnn(jax.random.PRNGKey(0),
                                      jcfg.DEFAULT_CONFIG.model)
        model = GraspPointCNN(tcfg.ModelConfig()).eval()
        model.load_state_dict(flax_to_torch_grasp_cnn(
            jax.tree.map(np.asarray, variables)))
        a, b = jfn(*args, variables), tfn(*args, model)
    else:
        a, b = jfn(*args), tfn(*args)
    assert int(a.leaf_id) == int(b.leaf_id) > 0
    np.testing.assert_array_equal(np.asarray(a.grasp_uv), b.grasp_uv.numpy())
    for name in ("found", "degenerate", "ml_used"):
        assert bool(getattr(a, name)) == bool(getattr(b, name)), name
    assert bool(b.found) and not bool(b.degenerate)
    np.testing.assert_array_equal(np.asarray(a.candidates.x),
                                  b.candidates.x.numpy())
    np.testing.assert_array_equal(np.asarray(a.candidates.y),
                                  b.candidates.y.numpy())
    np.testing.assert_allclose(np.asarray(a.grasp_xyz), b.grasp_xyz.numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(a.fusion.combined),
                               b.fusion.combined.numpy(), rtol=0, atol=1e-5)
    # on CPU tensors neither new kernel is launched
    counts = kernels.launch_counts()
    assert counts["squared_edt_rowband"] == 0
    assert counts["segment_histogram"] == 0
