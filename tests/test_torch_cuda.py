"""Each CUDA kernel of the port against its plain version, on the card.

This file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed; ``tests/conftest.py`` imports JAX, so on such a
machine run it alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Without a CUDA device every test here skips. Tolerances: min-plus and
row-banded EDT bit-exact (integer-valued f32 to 2^24, and past it the
plain version's rounding); fused scoring
1e-5 absolute, valid mask equal; attention gate 1e-5 absolute; segment
histogram counts equal; flash prefill 2e-5 absolute in f32, and in bf16
2^-6 of the value plus 2^-6 of the largest value of the same output row
(another order of the f32 sums; in bf16 the output is rounded, one ulp
being up to 2^-7 of the value, and the probabilities are rounded
before, not after, the division by the row sum; an output that cancels
to near zero carries an ulp of the values it was summed from, which the
row's largest stands for: ``chip_smoke.py`` reads at most 0.0051 of it
over the relative part), pad rows exactly zero.
"""

import math

import numpy as np
import pytest
import torch

from leafgrasp_tpu_torch import kernels
from leafgrasp_tpu_torch.config import GraspScoringConfig
from leafgrasp_tpu_torch.geometry.grasp_scorer import stem_penalty_map
from leafgrasp_tpu_torch.io.scenes import make_leaf_scene
from leafgrasp_tpu_torch.kernels.attention import (MODES,
                                                   attention_gate_plain,
                                                   fused_attention_gate)
from leafgrasp_tpu_torch.kernels.flash_prefill import (flash_prefill,
                                                       flash_prefill_plain)
from leafgrasp_tpu_torch.kernels.histogram import (NBINS, segment_histogram,
                                                   segment_histogram_plain)
from leafgrasp_tpu_torch.kernels.minplus import (BAND_ROWS, max_g2,
                                                 minplus_form, minplus_pass2,
                                                 minplus_pass2_plain)
from leafgrasp_tpu_torch.kernels.rowband import (rowband_radii_plain,
                                                 squared_edt_rowband,
                                                 squared_edt_rowband_plain)
from leafgrasp_tpu_torch.kernels.scoring import (fused_score_maps,
                                                 fused_score_maps_plain)
from leafgrasp_tpu_torch.ops.edt import edt, nearest_seed_dist_1d

CX, CY, F = np.float32(80.0), np.float32(48.0), np.float32(400.0)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def test_minplus_kernel_matches_plain_on_card(cuda):
    rng = np.random.default_rng(5)
    dense = rng.random((96, 160)) < 0.1
    sparse = np.zeros((96, 160), bool)
    sparse[7, 140] = True
    seeds = torch.as_tensor(np.stack([dense, sparse, np.zeros_like(sparse)]),
                            device=cuda)
    g = nearest_seed_dist_1d(seeds, axis=1).to(torch.float32)
    c, h, w = g.shape
    g2 = (g * g).reshape(c * h, w).contiguous()
    js = torch.tensor([0, 16, 32, 159], dtype=torch.int32, device=cuda)
    per_row = torch.randint(0, w, (c * h, 5), dtype=torch.int32,
                            device=cuda)
    band = torch.ones((c * h // BAND_ROWS, 2), dtype=torch.int32,
                      device=cuda)
    forms = [{}, {"qcol": js}, {"qcol": per_row}, {"band": band},
             {"qcol": js, "s_lo": 10, "s_hi": 100}]
    kernels.reset_launch_counts()
    for kw in forms:
        assert torch.equal(minplus_pass2(g2, **kw),
                           minplus_pass2_plain(g2, **kw)), kw
    assert kernels.launch_counts()["minplus_pass2"] == len(forms)


@pytest.mark.parametrize("shape", [(80, 1440), (40, 300), (19, 77)])
def test_minplus_kernel_at_the_edge_of_its_range_on_card(cuda, shape):
    """Sentinel rows, sources at the first, last or both columns, and
    rows of the largest admitted value, as every-column queries (wide
    and narrow tiles), per-row windows at both ends, and a source
    sub-range: bit-exact."""
    r, w = shape
    g2 = torch.full((r, w), float((1080 + w) ** 2), device=cuda)
    g2[1::5, 0] = 0.0
    g2[2::5, w - 1] = 0.0
    g2[3::5] = float(max_g2(w))
    g2[4::5, 0], g2[4::5, w - 1] = 0.0, 1.0
    ends = torch.tensor([0, 1, w // 2, w - 2, w - 1], dtype=torch.int32,
                        device=cuda)
    per_row = ends[None, :].repeat(r, 1).contiguous()
    forms = [{}, {"qcol": ends}, {"qcol": per_row},
             {"s_lo": 1, "s_hi": w - 1},
             {"qcol": ends, "s_lo": w // 3, "s_hi": w // 3 + 5}]
    for kw in forms:
        got = minplus_pass2(g2, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, minplus_pass2_plain(g2, **kw)), kw


def _edge_rows(r, w, top, big):
    """Rows of the sentinel ``big`` alone, with a source at the first, the
    last or both columns, and rows of the largest value ``top``."""
    g2 = torch.full((r, w), float(big), device="cuda")
    g2[1::5, 0] = 0.0
    g2[2::5, w - 1] = 0.0
    g2[3::5] = float(top)
    g2[4::5, 0], g2[4::5, w - 1] = 0.0, 1.0
    return g2


@pytest.mark.parametrize("h,w,form", [(2100, 1600, "direct"),
                                      (3829, 256, "direct"),
                                      (1080, 1920, "expanded"),
                                      (1080, 1440, "expanded")])
def test_minplus_forms_over_the_whole_exact_range_on_card(cuda, h, w, form):
    """The direct form (2100 x 1600, and a frame just past the expanded
    form's range) and the expanded form at W = 1920, each at the edge of
    its range (rows of the largest value it admits) and with the frame's
    sentinel, every query form: bit-exact against the plain version."""
    big = (h + w) ** 2
    assert minplus_form(w, big) == form
    top = max_g2(w) if form == "expanded" else 2 ** 24 - w * w
    g2 = _edge_rows(40, w, top, big)
    ends = torch.tensor([0, 1, w // 2, w - 2, w - 1], dtype=torch.int32,
                        device=cuda)
    band = torch.full((40 // BAND_ROWS, -(-w // 128)), 3, dtype=torch.int32,
                      device=cuda)
    forms = [{}, {"qcol": ends}, {"qcol": ends[None, :].repeat(40, 1)},
             {"band": band}, {"s_lo": 1, "s_hi": w - 1},
             {"qcol": ends, "s_lo": w // 3, "s_hi": w // 3 + 5}]
    for kw in forms:
        got = minplus_pass2(g2, g2_max=max(big, top), **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, minplus_pass2_plain(g2, **kw)), kw


@pytest.mark.parametrize("h,w", [(2048, 2448), (2160, 3840)])
def test_minplus_direct_form_past_2_24_on_card(cuda, h, w):
    """A 5 MP and a 4K UHD frame, whose sentinel (H + W)^2 passes 2^24:
    80 rows of the pass-1 field of a frame with seeds and of one without,
    every query form and a source sub-range, in the direct form,
    bit-exact against the plain version."""
    big = (h + w) ** 2
    assert big > 2 ** 24 and minplus_form(w, big) == "direct"
    seeds = torch.zeros((h, w), dtype=torch.bool, device=cuda)
    seeds[300:340, 100:140] = True
    seeds[h - 500:h - 460, w - 200:w - 160] = True
    for s in (seeds, torch.zeros_like(seeds)):
        g = nearest_seed_dist_1d(s, axis=0).to(torch.float32)
        g2 = (g * g)[h // 2 - 40:h // 2 + 40].contiguous()
        ends = torch.tensor([0, 1, w // 2, w - 2, w - 1], dtype=torch.int32,
                            device=cuda)
        band = torch.full((80 // BAND_ROWS, -(-w // 128)), 4,
                          dtype=torch.int32, device=cuda)
        forms = [{}, {"qcol": ends}, {"qcol": ends[None, :].repeat(80, 1)},
                 {"band": band},
                 {"qcol": torch.arange(w // 2, w // 2 + 64, dtype=torch.int32,
                                       device=cuda),
                  "s_lo": w // 2 - 100, "s_hi": w // 2 + 164}]
        for kw in forms:
            got = minplus_pass2(g2, g2_max=big, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, minplus_pass2_plain(g2, **kw)), kw
        if not s.any():
            assert bool((got == float(big)).all())


def test_minplus_card_raises_only_where_the_cpu_raises(cuda):
    """Neither device raises any more: a call that states no bound takes
    the direct form, whatever its width, and a frame past the old range
    runs the EDTs and every isolation mode of the grasp scorer on both
    devices to the same fields."""
    import dataclasses
    from leafgrasp_tpu_torch.config import GraspScoringConfig
    from leafgrasp_tpu_torch.geometry.grasp_scorer import (
        compute_grasp_scores)
    from leafgrasp_tpu_torch.ops import edt as tedt
    wide = torch.full((3, 1673), float(4000 ** 2), device=cuda)
    wide[:, 7] = 0.0
    assert torch.equal(minplus_pass2(wide), minplus_pass2_plain(wide))
    h, w = 3840, 256                         # (H + W)^2 + W^2 past 2^24
    kernels.reset_launch_counts()
    out = {}
    for dev in (cuda, torch.device("cpu")):
        leaf = torch.zeros((h, w), dtype=torch.bool, device=dev)
        leaf[5:60, 10:200] = True
        other = torch.zeros_like(leaf)
        other[100:130, 5:250] = True
        one = torch.ones((), dtype=torch.float32, device=dev)
        res = [tedt.squared_edt(leaf), *tedt.edt_max_argmax(leaf)]
        for mode in ("union", "union_half", "reference_self"):
            cfg = dataclasses.replace(GraspScoringConfig(),
                                      isolation_context=mode)
            res.append(compute_grasp_scores(
                leaf, leaf | other, torch.ones((h, w), device=dev), one,
                one, one, cfg).distance_map)
        out[dev.type] = [r.cpu() for r in res]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a, b)
    assert kernels.launch_counts()["minplus_pass2"] >= 3


def test_scoring_kernel_matches_plain_on_card(cuda):
    mask, _ = make_leaf_scene(height=96, width=160, num_leaves=3, seed=1,
                              margin=20)
    mask = torch.as_tensor(mask, device=cuda)
    leaf = mask == 2
    other = (mask > 0) & ~leaf
    grad = torch.as_tensor(
        np.random.default_rng(2).random((96, 160)).astype(np.float32) * 0.3,
        device=cuda)
    fields = [edt(~leaf), torch.zeros(leaf.shape, device=cuda), edt(other),
              edt(mask == 1) * 0.5, grad, leaf.to(torch.float32),
              stem_penalty_map(leaf, GraspScoringConfig())]
    scal = [torch.tensor(v, device=cuda) for v in (CX, CY, F)]
    kernels.reset_launch_counts()
    for valid in (True, False):
        args = (*fields, *scal, torch.tensor(0.7, device=cuda),
                torch.tensor(valid, device=cuda))
        got = fused_score_maps(*args)
        want = fused_score_maps_plain(*args)
        for a, b in zip(got[:8], want[:8]):
            assert float((a - b).abs().max()) <= 1e-5
        assert torch.equal(got[8], want[8])
    assert kernels.launch_counts()["fused_score_maps"] == 2


# (N, HW, C, R): the four architectures' gates at the path's batch of 20
# (R = C / 16), the kernel's limits, a C that is no multiple of 32 with an
# odd HW (no 16-byte access), and a tile too large to stage
GATE_SHAPES = [(20, 16, 128, 8), (20, 16, 256, 16), (20, 4, 256, 16),
               (20, 16, 512, 32), (3, 64, 1024, 64), (5, 9, 48, 3),
               (4, 1, 100, 6), (2, 64, 200, 64)]


@pytest.mark.parametrize("layout", ["contiguous", "nchw_view", "strided"])
@pytest.mark.parametrize("shape", GATE_SHAPES)
def test_attention_kernel_matches_plain_on_card(cuda, shape, layout):
    """Every mode within 1e-5 of the plain version, from a contiguous
    input, from the (N, HW, C) view of NCHW activations (read through its
    strides, output in the same layout), and from a slice with other
    strides (copied first)."""
    n, hw, c, r = shape
    rng = np.random.default_rng(3)

    def t(*sh, s=1.0):
        return torch.as_tensor((rng.normal(size=sh) * s)
                               .astype(np.float32), device=cuda)

    if layout == "contiguous":
        x = t(n, hw, c)
    elif layout == "nchw_view":
        x = t(n, c, hw).transpose(1, 2)
    else:
        x = t(n, hw, 2 * c)[:, :, ::2]
    params = (t(c, 1, s=0.1), t(1, s=0.1), t(c, r, s=0.1),
              t(r, s=0.1), t(r, c, s=0.1), t(c, s=0.1))
    kernels.reset_launch_counts()
    for mode in MODES:
        got = fused_attention_gate(x, *params, mode)
        want = attention_gate_plain(x, *params, mode)
        assert got.shape == x.shape
        assert float((got - want).abs().max()) <= 1e-5, mode
        if not x.is_contiguous() and x.transpose(1, 2).is_contiguous() \
                and mode != "none":
            assert got.stride() == x.stride()
    assert kernels.launch_counts()["fused_attention_gate"] == 3


@pytest.mark.parametrize("shape", [(96, 160), (75, 130), (540, 720),
                                   (540, 960), (5, 300), (64, 100), (7, 9)])
def test_rowband_kernel_matches_plain_on_card(cuda, shape):
    """Dense, single-leaf, sparse and seedless channels; odd sizes leave
    ragged row and column tiles, H < 8 and W < 128 leave one. Bit-exact,
    radii included."""
    h, w = shape
    if min(h, w) >= 40:
        mask, _ = make_leaf_scene(height=h, width=w, num_leaves=3, seed=4,
                                  margin=min(h, w) // 5)
    else:
        mask = np.zeros((h, w), np.int32)
        mask[h // 2, w // 3:] = 2
    rng = np.random.default_rng(9)
    seeds = torch.as_tensor(np.stack([
        mask > 0, mask == 2, rng.random((h, w)) < 0.002,
        np.zeros((h, w), bool)]), device=cuda)
    g = nearest_seed_dist_1d(seeds, axis=2).to(torch.float32)
    g2r = (g * g).contiguous()
    kernels.reset_launch_counts()
    got, nb = squared_edt_rowband(g2r, return_radii=True)
    torch.cuda.synchronize()
    want = squared_edt_rowband_plain(g2r)
    assert torch.equal(got, want)
    assert torch.equal(nb, rowband_radii_plain(g2r))
    assert kernels.launch_counts()["squared_edt_rowband"] == 1
    # a seedless channel keeps the sentinel (H + W)^2 everywhere
    assert torch.all(got[3] == float((h + w) ** 2))


@pytest.mark.parametrize("case", ["one_seed_row", "band_covers_all",
                                  "full_resolution", "inf_rows"])
def test_rowband_kernel_at_extremes_on_card(cuda, case):
    """One row with a seed (every tile's band reaches it), a single seed
    in a corner (the far tiles' bands cover every row), three channels at
    full resolution (more tiles than one segment of item offsets), and
    rows of +inf: bit-exact, radii included."""
    if case == "one_seed_row":
        seeds = torch.zeros((2, 300, 400), dtype=torch.bool, device=cuda)
        seeds[0, 150, :] = True
        seeds[1, 299, 7] = True
    elif case == "band_covers_all":
        seeds = torch.zeros((1, 540, 720), dtype=torch.bool, device=cuda)
        seeds[0, 0, 0] = True
    elif case == "full_resolution":
        mask, _ = make_leaf_scene(height=1080, width=1440, num_leaves=6,
                                  seed=8, margin=120)
        mask = torch.as_tensor(mask, device=cuda)
        seeds = torch.stack([mask != 1, mask == 1, (mask > 1)])
    else:
        seeds = torch.zeros((1, 200, 260), dtype=torch.bool, device=cuda)
        seeds[0, 120:, 30] = True
    g = nearest_seed_dist_1d(seeds, axis=2).to(torch.float32)
    g2r = (g * g).contiguous()
    if case == "inf_rows":
        g2r[0, :100] = float("inf")
    got, nb = squared_edt_rowband(g2r, return_radii=True)
    torch.cuda.synchronize()
    assert torch.equal(got, squared_edt_rowband_plain(g2r))
    assert torch.equal(nb, rowband_radii_plain(g2r))
    if case == "band_covers_all":
        assert int(nb.max()) == 540


@pytest.mark.parametrize("shape,num", [((40, 70), 5), ((1080, 1440), 18),
                                       ((33, 1001), 60)])
def test_histogram_kernel_matches_plain_on_card(cuda, shape, num):
    """Counts equal; ids outside [0, num) count nowhere; 60 segments
    need more than 48 KB of shared memory."""
    rng = np.random.default_rng(11)
    depth = torch.as_tensor((rng.random(shape) * 0.5 + 0.3)
                            .astype(np.float32), device=cuda)
    ids = torch.as_tensor(rng.integers(-1, num + 2, shape).astype(np.int32),
                          device=cuda)
    lo = torch.as_tensor((0.3 + rng.random(num) * 0.2).astype(np.float32),
                         device=cuda)
    inv_w = NBINS / torch.as_tensor(
        (0.05 + rng.random(num) * 0.4).astype(np.float32), device=cuda)
    kernels.reset_launch_counts()
    got = segment_histogram(depth, ids, lo, inv_w, num)
    torch.cuda.synchronize()
    want = segment_histogram_plain(depth, ids, lo, inv_w, num)
    assert torch.equal(got, want)
    assert float(got.sum()) == float(((ids >= 0) & (ids < num)).sum())
    assert kernels.launch_counts()["segment_histogram"] == 1


@pytest.mark.parametrize("case", ["two_brackets", "ragged", "offset_view",
                                  "offsets_differ", "max_segments"])
def test_histogram_kernel_brackets_and_alignment_on_card(cuda, case):
    """Two brackets in one launch against the plain version and against
    two one-bracket launches; a pixel count that is no multiple of the
    vector width; an offset view (the unaligned head); depth and ids at
    different offsets from a 16-byte boundary (the wrapper copies); and
    the most segments the shared memory holds. Counts equal."""
    from leafgrasp_tpu_torch.kernels.histogram import _MAX_SEGMENTS
    rng = np.random.default_rng(13)
    n, num, brackets = 1080 * 1440, 18, 2
    if case == "ragged":
        n = 1080 * 1440 - 5
    elif case == "max_segments":
        n, num, brackets = 300 * 401, _MAX_SEGMENTS, 1
    depth = torch.as_tensor((rng.random(n + 8) * 0.5 + 0.3)
                            .astype(np.float32), device=cuda)
    ids = torch.as_tensor(rng.integers(-1, num + 2, n + 8).astype(np.int32),
                          device=cuda)
    d, i = depth[:n], ids[:n]
    if case == "offset_view":
        d, i = depth[3:n + 3], ids[3:n + 3]
    elif case == "offsets_differ":
        d, i = depth[1:n + 1], ids[2:n + 2]
    lo = torch.as_tensor((0.3 + rng.random((brackets, num)) * 0.2)
                         .astype(np.float32), device=cuda)
    inv_w = NBINS / torch.as_tensor(
        (0.05 + rng.random((brackets, num)) * 0.4).astype(np.float32),
        device=cuda)
    kernels.reset_launch_counts()
    got = segment_histogram(d, i, lo, inv_w, num)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["segment_histogram"] == 1
    assert torch.equal(got, segment_histogram_plain(d, i, lo, inv_w, num))
    for r in range(brackets):
        assert torch.equal(got[r], segment_histogram(d, i, lo[r], inv_w[r],
                                                     num))
    assert float(got.sum()) == brackets * float(((i >= 0) & (i < num)).sum())


def test_masked_median_hist_launches_twice_on_card(cuda):
    from leafgrasp_tpu_torch.ops.median import masked_median_hist
    rng = np.random.default_rng(14)
    depth = torch.as_tensor((rng.random((1080, 1440)) * 0.5 + 0.3)
                            .astype(np.float32), device=cuda)
    ids = torch.as_tensor(rng.integers(0, 18, (1080, 1440)).astype(np.int32),
                          device=cuda)
    counts = torch.bincount(ids.reshape(-1).long(), minlength=18)
    kernels.reset_launch_counts()
    got = masked_median_hist(depth, ids, counts, 18)
    assert kernels.launch_counts()["segment_histogram"] == 2
    want = masked_median_hist(depth.cpu(), ids.cpu(), counts.cpu(), 18)
    assert torch.equal(got.cpu(), want)


def test_frame_launch_counts_on_card(cuda):
    """A ``union_half`` frame on the card launches the row-banded EDT at
    least twice; with ``hist_median=True`` it also launches the segment
    histogram twice, and picks the default's leaf and pixel."""
    from leafgrasp_tpu_torch.config import (DEFAULT_CONFIG, FrameConfig,
                                            LeafSelectionConfig, ModelConfig)
    from leafgrasp_tpu_torch.models.grasp_cnn import (GraspPointCNN,
                                                      init_random_)
    from leafgrasp_tpu_torch.pipeline.frame import make_frame_fn
    h, w = 270, 360
    cfg = DEFAULT_CONFIG.replace(
        frame=FrameConfig(height=h, width=w, max_leaves=8),
        leaf=LeafSelectionConfig(min_leaf_area=1500),
        grasp=GraspScoringConfig(isolation_context="union_half"))
    mask, depth = make_leaf_scene(height=h, width=w, num_leaves=4, seed=3,
                                  margin=40)
    cnn = init_random_(GraspPointCNN(ModelConfig()), seed=0).to(cuda).eval()
    args = (mask, depth, np.float32(w / 2), np.float32(h / 2),
            np.float32(400.0), cnn)
    kernels.reset_launch_counts()
    base = make_frame_fn(cfg, with_cnn=True)(*args)
    counts = kernels.launch_counts()
    assert counts["squared_edt_rowband"] >= 2
    assert counts["segment_histogram"] == 0
    kernels.reset_launch_counts()
    hist = make_frame_fn(cfg, with_cnn=True, hist_median=True)(*args)
    assert kernels.launch_counts()["segment_histogram"] == 2
    assert int(hist.leaf_id) == int(base.leaf_id) > 0
    assert torch.equal(hist.grasp_uv, base.grasp_uv)


# dtype -> (absolute, share of |plain|, share of the row's largest |plain|)
FLASH_TOL = {torch.float32: (2e-5, 0.0, 0.0),
             torch.bfloat16: (0.0, 2.0 ** -6, 2.0 ** -6)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,pads", [
    ((2, 200, 4, 2, 64), (0, 37)),
    ((3, 129, 4, 4, 64), (128, 0, 64)),
    ((2, 333, 6, 2, 128), (70, 5)),
    ((5, 640, 32, 8, 128), (0, 3, 64, 130, 639)),
    ((1, 1, 4, 1, 128), (0,)),
    ((2, 100, 4, 4, 128), (0, 99)),
    ((2, 257, 8, 2, 128), (130, 70)),
    ((1, 2437, 4, 1, 128), (300,)),
    ((2, 642, 32, 8, 128), (0, 5)),
])
def test_flash_prefill_kernel_matches_plain_on_card(cuda, dtype, shape, pads):
    """Unequal left pads including 0 and pads that end inside a 64-row
    group, prompts of one token, shorter than a tile and no multiple of
    one, one to four query heads a K/V head, the LoRA step's training
    shape, K/V read through the strides of a longer cache that holds NaN
    beyond t: real rows within tolerance, pad rows exactly zero,
    everything finite, the same bits on a second run; with the
    log-sum-exp too (the training forward), its output within the same
    tolerance and the log-sum-exp within 1e-5 of the plain one, -inf on
    pad rows."""
    b, t, heads, kvh, hd = shape
    rng = np.random.default_rng(21)

    def t_(*s):
        return torch.as_tensor(rng.standard_normal(s).astype(np.float32),
                               device=cuda).to(dtype)

    q = t_(b, t, heads, hd)
    cache_k, cache_v = t_(b, t + 10, kvh, hd), t_(b, t + 10, kvh, hd)
    cache_k[:, t:] = float("nan")
    cache_v[:, t:] = float("nan")
    pad = torch.tensor(pads, dtype=torch.int32, device=cuda)
    kernels.reset_launch_counts()
    got = flash_prefill(q, cache_k, cache_v, pad)
    again = flash_prefill(q, cache_k, cache_v, pad)
    got_lse, lse = flash_prefill(q, cache_k, cache_v, pad, return_lse=True)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_prefill"] == 3
    assert torch.equal(got, again)
    want, lse_plain = flash_prefill_plain(q, cache_k, cache_v, pad,
                                          chunk=256, return_lse=True)
    atol, rtol, rowtol = FLASH_TOL[dtype]
    allowed = rtol * want.float().abs() \
        + rowtol * want.float().abs().amax(-1, keepdim=True)
    for out in (got, got_lse):
        assert out.dtype == dtype and out.shape == q.shape
        assert torch.isfinite(out.float()).all()
        for i, p in enumerate(pads):
            assert not out[i, :p].any()
        diff = (out.float() - want.float()).abs()
        assert float((diff - allowed).max()) <= atol, float(diff.max())
    real = torch.isfinite(lse_plain)
    assert torch.equal(real, torch.isfinite(lse))
    assert float((lse - lse_plain)[real].abs().max()) <= 1e-5


@pytest.mark.parametrize("shape,pads", [
    ((2, 128, 4, 2, 64), (0, 64)),
    ((2, 257, 8, 2, 128), (130, 70)),
    ((2, 642, 32, 8, 128), (0, 5)),
])
def test_flash_prefill_f32_kernel_holds_large_scores_on_card(cuda, shape,
                                                             pads):
    """The f32 kernel with q and k at 8 times unit scale (|S / sqrt(hd)|
    in the tens, softmax rows close to one-hot; the training shape among
    them), with and without the log-sum-exp: the output within
    FLASH_TOL[float32] of the plain version plus what four f32 ulps of
    the row's score terms in S move it by (``_score_slack``): kernel and
    plain version sum S over hd in f32 in other orders, and between two
    near-equal top scores that moves an output by up to 1e-4, as far as
    the plain version itself is from float64 there
    (tests/test_torch_flash_split.py shows both); a one-hot row takes no
    slack. The log-sum-exp within 1e-5 plus four ulps of those terms, as
    the backward's tests hold it. Pad rows zero, the same bits twice."""
    q, k, v, pad, _ = _flash_bwd_inputs(cuda, torch.float32, shape, pads,
                                        qk_mul=8.0)
    t = shape[1]
    want, lse_plain = flash_prefill_plain(q, k, v, pad, chunk=256,
                                          return_lse=True)
    slack = _score_slack(q, k, v, pad, 4)
    real_rows = (torch.arange(t, device=cuda)[None, :]
                 >= pad.to(torch.int64)[:, None])[:, :, None, None]
    for return_lse in (False, True):
        got = flash_prefill(q, k, v, pad, return_lse=return_lse)
        again = flash_prefill(q, k, v, pad, return_lse=return_lse)
        if return_lse:
            (got, lse), (again, _) = got, again
            real = torch.isfinite(lse_plain)
            assert torch.equal(real, torch.isfinite(lse))
            lse_tol = 1e-5 + 4 * 2.0 ** -23 * _score_terms(q, k, t)[real]
            assert bool(((lse - lse_plain)[real].abs() <= lse_tol).all())
        assert torch.equal(got, again)
        assert torch.isfinite(got).all()
        for i, p in enumerate(pads):
            assert not got[i, :p].any()
        diff = (got - want).abs() * real_rows
        over = float((diff - FLASH_TOL[torch.float32][0] - slack).max())
        assert over <= 0.0, (float(diff.max()), over)


def _score_slack(q, k, v, pad, ulps, chunk=128):
    """(b, t, heads, hd): how far ``ulps`` f32 ulps of each row's score
    terms (``_score_terms``) in S scale move an output: a change d_j of
    S_j scale moves O_i by sum_j P_ij d_j (v_j - O_i), so by at most
    max |d| sum_j P_ij |v_j - O_i|, which is 0 for a one-hot row."""
    b, t, heads, hd = q.shape
    rep = heads // k.shape[2]
    kf = k[:, :t].float().repeat_interleave(rep, 2)
    vf = v[:, :t].float().repeat_interleave(rep, 2)
    key = torch.arange(t, device=q.device)
    spread = torch.zeros((b, t, heads, hd), device=q.device)
    for lo in range(0, t, chunk):
        hi = min(t, lo + chunk)
        s = torch.einsum("bihd,bjhd->bhij", q[:, lo:hi].float(), kf) \
            / math.sqrt(hd)
        vis = (key[None, None, :] <= key[lo:hi][None, :, None]) \
            & (key[None, None, :] >= pad.to(torch.int64)[:, None, None])
        s = s.masked_fill(~vis[:, None], -math.inf)
        p = torch.nan_to_num(torch.softmax(s, -1))      # pad rows: 0
        o = torch.einsum("bhij,bjhd->bihd", p, vf)
        for h in range(heads):
            dev = (vf[:, None, :, h] - o[:, :, None, h]).abs()
            spread[:, lo:hi, h] = torch.einsum("bij,bijd->bid", p[:, h], dev)
    return ulps * 2.0 ** -23 \
        * _score_terms(q, k, t).transpose(1, 2)[..., None] * spread


def test_flash_prefill_raises_on_card_for_what_the_kernel_lacks(cuda):
    q = torch.zeros((1, 130, 2, 24), device=cuda)
    pad = torch.zeros((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        flash_prefill(q, q, q, pad)
    with pytest.raises(ValueError):
        flash_prefill(q.half(), q.half(), q.half(), pad)


def test_flash_route_raises_on_card_rather_than_take_another_route(cuda):
    """A model whose head size the kernel lacks, asked for the flash
    route on the card, raises; the chunked route serves it."""
    from leafgrasp_tpu_torch.vla.llava_torch import (LlavaTorch,
                                                     LlavaTorchConfig,
                                                     init_random_)
    cfg = LlavaTorchConfig(
        vis_hidden=32, vis_intermediate=64, vis_layers=2, vis_heads=2,
        image_size=28, patch_size=14, vocab_size=128, hidden=64,
        intermediate=96, layers=2, heads=4, kv_heads=2,
        image_token_index=100, prefill_attn_impl="flash")
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    model = init_random_(LlavaTorch(cfg, device=cuda), gen).eval()
    ids = torch.ones((1, 150), dtype=torch.int64, device=cuda)
    with torch.no_grad():
        with pytest.raises(ValueError, match="head size"):
            model(ids)
        model.set_prefill_attn("chunked")
        assert torch.isfinite(model(ids)[0]).all()


@pytest.mark.parametrize("shape", [(16, 16, 256, 16), (16, 4, 256, 16),
                                   (5, 9, 48, 3), (3, 64, 1024, 64),
                                   (1, 16, 256, 16), (17, 16, 256, 16),
                                   (33, 16, 128, 8), (17, 64, 1024, 64)])
@pytest.mark.parametrize("dy_form", ["contiguous", "pool_stride0",
                                     "channel_major"])
def test_gate_backward_kernel_matches_plain_on_card(cuda, shape, dy_form):
    """The gate's gradient kernel against its plain version: dx within
    1e-5 absolute; each parameter gradient within 1e-5 of its L2 norm of
    the float64 gradient plus twice the plain f32 version's own distance
    from it (a sum over N and HW whose terms cancel has a small norm and
    a rounding error set by its terms); the same bits on a second run
    (the sum over N is in a fixed order); x the NCHW view and contiguous,
    dy contiguous, channel-major or with stride 0 along HW (the average
    pool's gradient); N of 1, past one cluster of blocks (17, 33) and the
    kernel's limits (HW 64, C 1024, R 64); one launch a call."""
    from leafgrasp_tpu_torch.kernels.attention import (
        attention_gate_backward, attention_gate_backward_plain)
    n, hw, c, r = shape
    rng = np.random.default_rng(4)

    def t(*sh, s=1.0):
        return torch.as_tensor((rng.normal(size=sh) * s)
                               .astype(np.float32), device=cuda)

    x_view = torch.relu(t(n, c, hw)).transpose(1, 2)
    params = (t(c, 1, s=c ** -0.5), t(1), t(c, r, s=c ** -0.5), t(r),
              t(r, c, s=r ** -0.5), t(c))
    dy = {"contiguous": lambda: t(n, hw, c),
          "pool_stride0": lambda: (t(n, 1, c) / hw).expand(n, hw, c),
          "channel_major": lambda: t(n, c, hw).transpose(1, 2)}[dy_form]()
    kernels.reset_launch_counts()
    for x in (x_view, x_view.contiguous()):
        for mode in ("spatial", "channel", "hybrid"):
            got = attention_gate_backward(dy, x, *params, mode)
            again = attention_gate_backward(dy, x, *params, mode)
            want = attention_gate_backward_plain(dy, x, *params, mode)
            exact = attention_gate_backward_plain(
                dy.double(), x.double(), *(p.double() for p in params),
                mode)
            assert all(torch.equal(a, b) for a, b in zip(got, again)), mode
            assert float((got[0] - want[0]).abs().max()) <= 1e-5, mode
            assert got[0].stride() == x.stride()
            for g, w, e in zip(got[1:], want[1:], exact[1:]):
                assert g.shape == w.shape
                err = float((g.double() - e).abs().max())
                err_plain = float((w.double() - e).abs().max())
                assert err <= 2.0 * err_plain + 1e-5 * float(e.norm()), mode
    assert kernels.launch_counts()["attention_gate_backward"] == 12


def test_cnn_train_step_gradients_on_card_match_cpu(cuda):
    """One train step of the standard CNN (dropout 0, the same weights
    and batch): every parameter gets a finite gradient on the card
    through the gate's autograd Function, as close to the float64
    gradient (the CPU's, in double precision) as the CPU's f32 gradient
    is, within a factor 2 and 3e-5 of its L2 norm (cuDNN's f32
    convolutions, TF32 off, and the CPU sum in other orders; with random
    data and labels a leaf's f32 gradient sits up to ~2e-4 of its norm
    from float64); the biases that feed a train-mode BatchNorm (exact
    gradient 0) are held against the same layer's weight gradient."""
    from leafgrasp_tpu_torch.config import ModelConfig
    from leafgrasp_tpu_torch.models.grasp_cnn import (GraspPointCNN,
                                                      batchnorm_fed_biases,
                                                      init_like_flax_)
    from leafgrasp_tpu_torch.training.train import bce_with_logits
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = ModelConfig(conv_dropout=0.0, fc_dropout=(0.0, 0.0, 0.0))
        cpu = init_like_flax_(GraspPointCNN(cfg),
                              torch.Generator().manual_seed(42))
        card = GraspPointCNN(cfg)
        card.load_state_dict(cpu.state_dict())
        card.to(cuda)
        cpu64 = GraspPointCNN(cfg)
        cpu64.load_state_dict(cpu.state_dict())
        cpu64.double()
        rng = np.random.default_rng(6)
        x = torch.as_tensor(rng.normal(size=(16, 32, 32, 9)))
        y = torch.as_tensor((rng.random(16) > 0.5).astype(np.float64))
        kernels.reset_launch_counts()
        for model, dev, dt in ((card, cuda, torch.float32),
                               (cpu, torch.device("cpu"), torch.float32),
                               (cpu64, torch.device("cpu"), torch.float64)):
            model.train()
            bce_with_logits(model(x.to(dev, dt)), y.to(dev, dt),
                            2.0).backward()
            if model is card:
                counts = kernels.launch_counts()
        assert counts["fused_attention_gate"] == 1
        assert counts["attention_gate_backward"] == 1
        cpu_grads = dict(cpu.named_parameters())
        exact = dict(cpu64.named_parameters())
        for k, p in card.named_parameters():
            g, g_cpu, e = p.grad, cpu_grads[k].grad, exact[k].grad
            assert g is not None and bool(torch.isfinite(g).all()), k
            if k in batchnorm_fed_biases(card):
                ref = exact[k[:-len("bias")] + "weight"].grad
                assert float((g.cpu() - g_cpu).abs().max()) \
                    <= 3e-5 * float(ref.norm()), k
                continue
            assert float(g.abs().max()) > 0, k
            err = float((g.cpu().double() - e).abs().max())
            err_cpu = float((g_cpu.double() - e).abs().max())
            assert err <= 2.0 * err_cpu + 3e-5 * float(e.norm()), k
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32


# ---- the flash prefill's backward ----------------------------------------------

# each gradient's largest difference from the plain backward's, over the
# gradient's L2 norm: both take the same inputs, output and log-sum-exp,
# widen bf16 to f32 and compute in f32, in other orders of the sums
FLASH_BWD_REL_TOL = 1e-5


def _flash_bwd_inputs(cuda, dtype, shape, pads, seed=5, extra=10,
                      qk_mul=1.0):
    """q, K/V as views of a longer cache whose rows beyond t hold NaN,
    the pads, and the output's gradient (pad rows carry one too); q and
    k drawn at ``qk_mul`` times unit scale."""
    b, t, heads, kvh, hd = shape
    rng = np.random.default_rng(seed)

    def t_(*s, mul=1.0):
        return torch.as_tensor((rng.standard_normal(s) * mul)
                               .astype(np.float32), device=cuda).to(dtype)

    q = t_(b, t, heads, hd, mul=qk_mul)
    cache_k = t_(b, t + extra, kvh, hd, mul=qk_mul)
    cache_v = t_(b, t + extra, kvh, hd)
    cache_k[:, t:] = float("nan")
    cache_v[:, t:] = float("nan")
    pad = torch.tensor(pads, dtype=torch.int32, device=cuda)
    dout = t_(b, t, heads, hd)
    return q, cache_k[:, :t + extra], cache_v[:, :t + extra], pad, dout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,pads", [
    ((2, 128, 4, 2, 64), (0, 64)),
    ((2, 200, 4, 4, 64), (0, 37)),
    ((3, 129, 4, 1, 128), (128, 0, 70)),
    ((2, 642, 32, 8, 128), (0, 5)),
    ((2, 100, 8, 2, 128), (0, 100)),
    ((2, 257, 8, 2, 128), (0, 100)),
    ((2, 65, 8, 2, 64), (0, 33)),
    ((1, 97, 4, 4, 128), (40,)),
    ((1, 130, 8, 1, 64), (3,)),
])
def test_flash_prefill_backward_kernels_match_plain_on_card(cuda, dtype,
                                                            shape, pads):
    """The two backward kernels (through ``flash_prefill_backward``)
    against the plain backward on the kernel forward's output and
    log-sum-exp: rep 1, 2, 4 and 8 (the dK/dV kernel gives a key tile's
    query heads to a cluster of one, two or four blocks, two heads each
    at rep 8), head sizes 64 and 128, t a multiple of a
    tile and not (one row past the 64-row fixed tiles and the 32- and
    64-row stream tiles: 65, 97, 129, 257), pads inside and across a tile
    and a row of pad only, K/V as views of a longer cache holding NaN
    beyond t. Each gradient within 1e-5 of its norm, dQ of pad rows, dK/dV
    of pad keys and of the rows beyond t exactly zero, everything finite,
    the same bits twice, one launch of each kernel a call; the forward's
    log-sum-exp equals the plain version's to 1e-5 and is -inf on pad
    rows."""
    _check_flash_backward(cuda, dtype, shape, pads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,pads", [
    ((2, 128, 4, 2, 64), (0, 64)),
    ((2, 257, 8, 2, 128), (0, 100)),
])
def test_flash_prefill_backward_kernels_hold_large_scores_on_card(
        cuda, dtype, shape, pads):
    """As above with q and k at 8 times unit scale (|S / sqrt(hd)| in the
    tens, a softmax close to one-hot): an error of the split products in
    S enters the exponent absolutely, so this is where too few bf16
    planes would show (tests/test_torch_flash_split.py emulates it).
    The forward's log-sum-exp comes from S, which kernel and plain
    version sum over hd in f32 in other orders: here the terms |q_d k_d|
    sum to some 500 after the scale, so it is held to 1e-5 plus four f32
    ulps of that sum, the row's largest over its keys, where the other
    cases hold it to 1e-5 alone (an ulp at 512 is 6.1e-5; read on an
    H100: (2, 128, 4 over 2, 64) 3.1e-5 in f32 and 6.1e-5 in bf16,
    (2, 257, 8 over 2, 128) 3.1e-5 and 1.2e-4)."""
    _check_flash_backward(cuda, dtype, shape, pads, qk_mul=8.0,
                          lse_ulps=4)


def _score_terms(q, k, t):
    """(b, heads, t): the largest over a row's keys of sum_d |q_d k_d|
    times the scale, the size of what an f32 sum of S scale adds up."""
    rep = q.shape[2] // k.shape[2]
    kk = k[:, :t].float().abs().repeat_interleave(rep, dim=2)
    terms = torch.einsum("bihd,bjhd->bhij", q.float().abs(), kk)
    return terms.amax(-1) * q.shape[3] ** -0.5


def _check_flash_backward(cuda, dtype, shape, pads, qk_mul=1.0,
                          lse_ulps=0):
    from leafgrasp_tpu_torch.kernels.flash_prefill import (
        flash_prefill_backward, flash_prefill_backward_plain)
    q, k, v, pad, dout = _flash_bwd_inputs(cuda, dtype, shape, pads,
                                           qk_mul=qk_mul)
    t = shape[1]
    out, lse = flash_prefill(q, k, v, pad, return_lse=True)
    _, lse_plain = flash_prefill_plain(q, k, v, pad, chunk=256,
                                       return_lse=True)
    real = torch.isfinite(lse_plain)
    assert torch.equal(real, torch.isfinite(lse))
    lse_err = (lse[real] - lse_plain[real]).abs()
    lse_tol = 1e-5 + lse_ulps * 2.0 ** -23 * _score_terms(q, k, t)[real]
    assert bool((lse_err <= lse_tol).all()), float(lse_err.max())
    kernels.reset_launch_counts()
    got = flash_prefill_backward(q, k, v, pad, out, lse, dout)
    again = flash_prefill_backward(q, k, v, pad, out, lse, dout)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["flash_prefill_bwd_dq"] == 2
    assert counts["flash_prefill_bwd_dkv"] == 2
    want = flash_prefill_backward_plain(q, k, v, pad, out, lse, dout,
                                        chunk=256)
    for name, g, g2, w, x in zip("qkv", got, again, want, (q, k, v)):
        assert g.dtype == torch.float32 and g.shape == x.shape, name
        assert torch.equal(g, g2), name
        assert bool(torch.isfinite(g).all()), name
        assert not g[:, t:].any(), name
        for i, p in enumerate(pads):
            assert not g[i, :p].any(), (name, i)
        err = float((g - w).abs().max())
        assert err <= FLASH_BWD_REL_TOL * float(w.norm()), (name, err)


def test_flash_prefill_backward_raises_on_card_for_what_it_lacks(cuda):
    from leafgrasp_tpu_torch.kernels.flash_prefill import (
        flash_prefill_backward, flash_prefill_trainable)
    pad = torch.zeros((1,), dtype=torch.int32, device=cuda)
    for dtype, hd in ((torch.float16, 64), (torch.float32, 32)):
        q = torch.zeros((1, 130, 2, hd), device=cuda, dtype=dtype)
        lse = torch.zeros((1, 2, 130), device=cuda)
        with pytest.raises(ValueError):
            flash_prefill_backward(q, q, q, pad, q, lse, q)
        with pytest.raises(ValueError):
            flash_prefill_trainable(q.requires_grad_(), q, q, pad)


def test_flash_prefill_trainable_serves_as_before_and_trains(cuda):
    """Without a gradient to record it is the serving launch (one
    forward, no log-sum-exp, no backward launch); with one, the
    gradients equal ``flash_prefill_backward``'s in the inputs' types."""
    from leafgrasp_tpu_torch.kernels.flash_prefill import (
        flash_prefill_backward, flash_prefill_trainable)
    q, k, v, pad, dout = _flash_bwd_inputs(cuda, torch.bfloat16,
                                           (2, 130, 4, 2, 64), (0, 3))
    kernels.reset_launch_counts()
    with torch.no_grad():
        served = flash_prefill_trainable(q, k, v, pad)
    assert torch.equal(served, flash_prefill(q, k, v, pad))
    counts = kernels.launch_counts()
    assert counts["flash_prefill"] == 2
    assert counts["flash_prefill_bwd_dq"] == counts["flash_prefill_bwd_dkv"] \
        == 0
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))
    out = flash_prefill_trainable(qg, kg, vg, pad)
    assert torch.equal(out, served)
    out.backward(dout)
    out2, lse = flash_prefill(q, k, v, pad, return_lse=True)
    want = flash_prefill_backward(q, k, v, pad, out2, lse, dout)
    for g, w in zip((qg.grad, kg.grad, vg.grad), want):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, w.to(torch.bfloat16))


def test_flash_route_gradients_on_card_equal_the_chunked_routes(cuda):
    """The fault the backward closes: on the card the flash route of a
    LoRA model carries gradients. One loss, two routes, the same f32
    weights: every parameter, each q/k/v adapter among them, gets a
    finite gradient within 1e-5 of its norm of the chunked route's (the
    routes sum in other orders), and the adapters' are not zero. (With
    bf16 weights the chunked route rounds the first layer's
    probabilities to bf16, the layer input's type, and the flash route
    does not; ``chip_smoke.py`` phase 8 holds the routes at that
    config.)"""
    from leafgrasp_tpu_torch.vla.llava_torch import (LlavaTorch,
                                                     LlavaTorchConfig,
                                                     init_random_)
    cfg = LlavaTorchConfig(
        vis_hidden=32, vis_intermediate=64, vis_layers=1, vis_heads=2,
        image_size=28, patch_size=14, vocab_size=128, hidden=128,
        intermediate=192, layers=2, heads=2, kv_heads=1,
        image_token_index=100, lora_rank=4, lora_alpha=8.0,
        prefill_attn_impl="flash")
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    model = init_random_(LlavaTorch(cfg, device=cuda), gen)
    ids = torch.randint(0, 100, (2, 150), generator=gen, device=cuda)
    grads = {}
    for route in ("flash", "chunked"):
        model.set_prefill_attn(route, chunk=64)
        model.zero_grad(set_to_none=True)
        kernels.reset_launch_counts()
        logits, _ = model(ids)
        torch.log_softmax(logits.float(), -1)[..., 7].mean().backward()
        counts = kernels.launch_counts()
        flash = route == "flash"
        assert counts["flash_prefill"] == (2 if flash else 0)
        assert counts["flash_prefill_bwd_dq"] == (2 if flash else 0)
        assert counts["flash_prefill_bwd_dkv"] == (2 if flash else 0)
        grads[route] = {n: p.grad.clone() for n, p in model.named_parameters()
                        if p.grad is not None}
    assert set(grads["flash"]) == set(grads["chunked"])
    for proj in ("q_proj", "k_proj", "v_proj"):
        assert f"layers.0.self_attn.{proj}.lora_b" in grads["flash"]
    for name, g in grads["flash"].items():
        w = grads["chunked"][name]
        assert bool(torch.isfinite(g).all()), name
        if name.endswith((".lora_a", ".lora_b")):
            assert float(g.abs().max()) > 0, name
        err = float((g - w).abs().max())
        assert err <= 1e-5 * float(w.norm()), (name, err)
