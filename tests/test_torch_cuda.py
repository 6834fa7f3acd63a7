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
over the relative part), pad rows exactly zero. The decode step's
attention against its plain version: in f32 1e-5 absolute plus 1e-5 of
the value (another order of the f32 sums, ``expf``'s last bit); in bf16
2^-7 of the value plus 2^-7 of the largest value of the same output row
(the output is rounded to bf16, where an ulp is up to 2^-7 of the value,
and a probability on a rounding edge may round the other way); its
launches bit-equal to each other, eager or replayed.
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


# ---- weight-only quantized serving (vla/quant.py, vla/checkpoint_io.py) --

# |layer - plain| <= QUANT_TOL * (|plain| + the largest |plain| of the row):
# f32 compute sums in another order (1e-5); bf16 int4's prompt-pass
# formulation rounds the dequantized weight to bf16 before its product
# (each term off by up to 2^-9) and the output once more, so two ulps of
# the value and of the row's largest. bf16 int8 and int4's per-group
# partials round once: within one_rounding_share's limit of the f64 product
QUANT_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}


def _quant_layer(cuda, bits, dtype, n_in=512, n_out=384, group=128,
                 threshold=256):
    from leafgrasp_tpu_torch.vla.quant import QuantDense, quantize_kernel
    gen = torch.Generator(device=cuda)
    gen.manual_seed(bits)
    w = 0.02 * torch.randn((n_in, n_out), generator=gen, device=cuda)
    lay = QuantDense(n_in, n_out, dtype=dtype, bits=bits, group=group,
                     dequant_threshold=threshold, device=cuda)
    q, s = quantize_kernel(w, bits, group)
    with torch.no_grad():
        lay.kernel_q.copy_(q)
        lay.kernel_scale.copy_(s)
    return lay, gen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits,rows,threshold", [
    (8, 5, 256), (8, 600, 256), (4, 5, 256), (4, 600, 256),
    (4, 600, 10 ** 9)])
def test_quant_dense_matches_plain_on_card(cuda, dtype, bits, rows,
                                           threshold):
    """QuantDense on CUDA tensors (int8; int4 by per-group partials at or
    below the threshold and by the dequantized product above it) against
    its plain f32 version on the same card (bf16 int8 and partials: one
    rounding of the f64 product, which int8's bf16 product rounded before
    its scale misses), and the card's codes and scales against the CPU
    quantizer's (equal)."""
    from leafgrasp_tpu_torch.vla.quant import (one_rounding_share,
                                               quant_dense_exact,
                                               quant_dense_plain,
                                               quantize_kernel)
    lay, gen = _quant_layer(cuda, bits, dtype, threshold=threshold)
    x = torch.randn((rows, 512), generator=gen, device=cuda)
    with torch.no_grad():
        got = lay(x)
        want = quant_dense_plain(lay, x)
        exact = quant_dense_exact(lay, x)
    assert got.dtype == dtype and got.shape == (rows, 384)
    if dtype == torch.bfloat16 and (bits == 8 or rows <= threshold):
        assert one_rounding_share(got, exact) <= 1.0
        if bits == 8:       # the bf16 product rounded before its scale
            twice = (torch.mm(x.to(dtype), lay.kernel_q.to(dtype)).float()
                     * lay.kernel_scale).to(dtype)
            assert one_rounding_share(twice, exact) > 1.0
    else:
        tol = QUANT_TOL[dtype]
        bound = tol * (want.float().abs()
                       + want.float().abs().amax(dim=-1, keepdim=True))
        assert bool(((got.float() - want.float()).abs() <= bound).all())
    w = 0.02 * torch.randn((512, 384), generator=gen, device=cuda)
    for a, b in zip(quantize_kernel(w, bits), quantize_kernel(w.cpu(), bits)):
        assert torch.equal(a.cpu(), b)


def test_checkpoint_loads_onto_the_card(cuda, tmp_path):
    """A tiny synthetic checkpoint loaded straight onto the card in bf16,
    int8 and int4: the same tensors as the CPU load (the card quantizes
    with the host's arithmetic), logits within 1e-4 of the CPU model's,
    and the flash prefill launched by a long prompt."""
    from leafgrasp_tpu_torch.vla.checkpoint_io import (
        load_llava_checkpoint, write_synthetic_llava_checkpoint)
    from leafgrasp_tpu_torch.vla.llava_torch import LlavaTorchConfig
    cfg = LlavaTorchConfig(
        vis_hidden=64, vis_intermediate=128, vis_layers=2, vis_heads=2,
        image_size=28, patch_size=14, vocab_size=256, hidden=256,
        intermediate=512, layers=2, heads=2, kv_heads=1,
        image_token_index=200)
    d = str(tmp_path / "ckpt")
    write_synthetic_llava_checkpoint(d, cfg, seed=4, n_shards=3)
    ids = torch.randint(0, 199, (2, 160), generator=torch.Generator()
                        .manual_seed(4))
    for kw in ({}, {"quantize": True}, {"quantize": True, "quant_bits": 4}):
        card, cstate, _ = load_llava_checkpoint(d, dtype="bfloat16",
                                                device=cuda, **kw)
        host, hstate, _ = load_llava_checkpoint(d, dtype="bfloat16",
                                                device="cpu", **kw)
        assert card.device.type == "cuda" and set(cstate) == set(hstate)
        for k, v in hstate.items():
            assert torch.equal(cstate[k].cpu(), v), k
        card.set_prefill_attn("flash")
        kernels.reset_launch_counts()
        with torch.no_grad():
            got = card(ids.to(cuda))[0].float().cpu()
            want = host(ids)[0].float()
        assert kernels.launch_counts()["flash_prefill"] == cfg.layers
        assert float((got - want).abs().max()) <= 1e-4 * max(
            1.0, float(want.abs().max())), kw


def _sharded_frame_rank(rank, world):
    """A rank of the row-sharded frame and of a data-parallel train step
    on the card (gloo: the ranks share cuda:0): the kernels each launched,
    the sharded frame and the unsharded one."""
    from leafgrasp_tpu_torch.config import (FrameConfig, LeafSelectionConfig,
                                            ModelConfig, PipelineConfig,
                                            TrainConfig)
    from leafgrasp_tpu_torch.models.grasp_cnn import (GraspPointCNN,
                                                      init_random_)
    from leafgrasp_tpu_torch.parallel import make_mesh, make_sharded_frame_fn
    from leafgrasp_tpu_torch.pipeline.frame import make_frame_fn
    from leafgrasp_tpu_torch.training.train import (make_optimizer,
                                                    make_parallel_train_step,
                                                    parallelize_grasp_cnn)
    from leafgrasp_tpu_torch.utils.device import fetch_to_host

    torch.cuda.set_device(0)
    mesh = make_mesh()
    cfg = PipelineConfig(frame=FrameConfig(height=192, width=256,
                                           max_leaves=8),
                         leaf=LeafSelectionConfig(min_leaf_area=300))
    mask, depth = make_leaf_scene(192, 256, num_leaves=4, seed=3, margin=30)
    cnn = init_random_(GraspPointCNN(ModelConfig()), seed=0).cuda().eval()
    cam = (np.float32(128.0), np.float32(96.0), np.float32(300.0))
    fn = make_sharded_frame_fn(mesh, cfg, with_cnn=True)
    kernels.reset_launch_counts()
    sharded = fetch_to_host(fn(mask, depth, *cam, cnn))
    counts = kernels.launch_counts()
    single = fetch_to_host(make_frame_fn(cfg, with_cnn=True)(mask, depth,
                                                              *cam, cnn))
    model, names, rows = parallelize_grasp_cnn(
        init_random_(GraspPointCNN(ModelConfig()), seed=0).cuda(), mesh, 8)
    step = make_parallel_train_step(
        model, make_optimizer(model, TrainConfig(batch_size=8)),
        TrainConfig(batch_size=8), mesh, names)
    kernels.reset_launch_counts()
    loss, _ = step(torch.ones((8, 32, 32, 9), device="cuda")[rows],
                   torch.ones(8, device="cuda")[rows],
                   torch.ones(rows.stop - rows.start, device="cuda"), 2.0)
    train_counts = kernels.launch_counts()
    return counts, sharded, single, train_counts, float(loss)


def test_sharded_frame_and_train_step_launch_kernels_on_card(cuda,
                                                             tmp_path):
    from leafgrasp_tpu_torch.parallel.launch import run_ranks
    outs = run_ranks(_sharded_frame_rank, 2, str(tmp_path / "store"),
                     timeout_s=120.0, join_s=300.0, threads=0)
    for counts, sharded, single, train_counts, loss in outs:
        for name in ("fused_score_maps", "minplus_pass2",
                     "fused_attention_gate"):
            assert counts[name] > 0, name
        assert train_counts["attention_gate_backward"] > 0
        assert np.isfinite(loss) and loss == outs[0][4]
        assert int(sharded.leaf_id) == int(single.leaf_id)
        np.testing.assert_array_equal(sharded.grasp_uv, single.grasp_uv)
        assert bool(sharded.ml_used) == bool(single.ml_used)
        np.testing.assert_allclose(sharded.fusion.combined,
                                   single.fusion.combined, rtol=1e-4,
                                   atol=1e-5)


# ---- the evaluation tools on the card ------------------------------------------------

def test_parity_tool_production_rows_on_card(cuda, tmp_path):
    """tools/parity_report_torch.py on CUDA: two production scenes give
    the committed PARITY_production.json rows (leaf, pixel, flag, message
    and the oracle's pixel), and launch the frame path's kernels."""
    from tools import parity_report_torch
    kernels.reset_launch_counts()
    out = parity_report_torch.main(["--scale", "production", "--seeds",
                                    "0,39", "--out",
                                    str(tmp_path / "p.json")])
    assert out["device"].startswith("cuda")
    assert out["mismatches"] == 0 and out["scenes"] == 2
    assert out["leaf_equal"] == out["uv_equal"] == out["message_equal"] == 2
    assert out["oracle_uv_equal"] == out["oracle_uv_rows"] == 2
    counts = kernels.launch_counts()
    assert counts["fused_score_maps"] > 0 and counts["minplus_pass2"] > 0


def test_hard_cnn_logits_on_card_equal_cpu(cuda):
    """The converted hard-corpus CNN (``deep``, artifacts/torch/
    grasp_cnn_hard) on the card, TF32 off: its logits within 1e-5 of the
    CPU's on seeded patches, through the attention gate's kernel."""
    import os
    from leafgrasp_tpu_torch.config import ModelConfig
    from leafgrasp_tpu_torch.models.grasp_cnn import ARCHITECTURES
    from leafgrasp_tpu_torch.models.predictor import GraspQualityPredictor
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "artifacts", "torch", "grasp_cnn_hard",
        "best_model")
    cfg = ModelConfig(encoder_filters=ARCHITECTURES["deep"])
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(20, 32, 32, 9)).astype(np.float32))
    cpu = GraspQualityPredictor(cfg, device="cpu").load(path)
    card = GraspQualityPredictor(cfg, device=cuda).load(path)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        kernels.reset_launch_counts()
        with torch.no_grad():
            got = card.model(x.to(cuda)).cpu()
            want = cpu.model(x)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    assert kernels.launch_counts()["fused_attention_gate"] == 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


# ---- the VLA decode's CUDA graph (vla/llava_torch.py) ----------------------

def _graph_llava(cuda, quantized):
    """A small random LLaVA in bf16 (head size 64, so prompts of 128
    tokens or more take the flash prefill), as drawn or with its
    projections and head in int8."""
    import dataclasses
    from leafgrasp_tpu_torch.vla.llava_torch import (LlavaTorch,
                                                     LlavaTorchConfig,
                                                     init_random_)
    from leafgrasp_tpu_torch.vla.quant import quantize_llava_variables
    cfg = LlavaTorchConfig(
        vis_hidden=32, vis_intermediate=64, vis_layers=1, vis_heads=2,
        image_size=28, patch_size=14, vocab_size=256, hidden=256,
        intermediate=512, layers=2, heads=4, kv_heads=2,
        image_token_index=200, dtype="bfloat16", prefill_attn_impl="flash")
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    model = init_random_(LlavaTorch(cfg, device=cuda,
                                    param_dtype=torch.bfloat16), gen,
                         std=0.1)
    if not quantized:
        return model
    return LlavaTorch.from_state(
        dataclasses.replace(cfg, quantized=True, quant_bits=8),
        quantize_llava_variables(model.state_dict(), bits=8))


def _uncaptured_tokens(model, ids, pad, n_new):
    """The graph route's tokens computed without a graph: the prompt pass
    into fresh caches of the graph route's capacity, then the same step
    function, run eagerly."""
    from leafgrasp_tpu_torch.vla import llava_torch as tl
    from leafgrasp_tpu_torch.vla.layers import KVCache
    b, t = ids.shape
    cap = -(-(t + n_new) // tl.CACHE_QUANTUM) * tl.CACHE_QUANTUM
    cache = KVCache(model.cfg, b, cap, ids.device)
    with torch.no_grad():
        first, _ = tl._generate_prefill(model, ids, pad, None, None, cache)
        steps = tl._decode_steps(
            model, cache, first, pad,
            torch.full((), t, dtype=torch.int64, device=ids.device),
            n_new - 1)
    return torch.cat([first[:, None], steps], dim=1).to(torch.int32)


@pytest.mark.parametrize("quantized", [False, True])
def test_decode_graph_replays_the_uncaptured_steps_bit_for_bit(cuda,
                                                               quantized):
    """``greedy_generate_llava`` on the card captures the decode steps
    once a (rows, capacity, steps) and replays them: its tokens equal the
    same step function's run uncaptured at the same capacity, in bf16 and
    int8, at 3 and 5 rows with unequal pads; a second call of a shape
    reads its new inputs, a prompt one token longer replays (the same
    capacity), more rows capture anew, and the first shape's graph still
    replays after that capture."""
    from leafgrasp_tpu_torch.vla.llava_torch import greedy_generate_llava
    model = _graph_llava(cuda, quantized)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(11)
    calls = [(3, 150, [0, 7, 40], "captured"),
             (3, 150, [5, 0, 60], "replayed"),
             (3, 151, [2, 9, 0], "replayed"),
             (5, 151, [0, 3, 17, 1, 30], "captured"),
             (5, 151, [4, 0, 2, 11, 6], "replayed"),
             (3, 150, [1, 1, 0], "replayed")]
    seen = []
    for b, t, pads, route in calls:
        ids = torch.randint(1, 200, (b, t), generator=gen, device=cuda)
        pad = torch.tensor(pads, dtype=torch.int32, device=cuda)
        ids[torch.arange(t, device=cuda)[None, :] < pad[:, None]] = 0
        timings = {}
        got = greedy_generate_llava(model, ids, max_new_tokens=10,
                                    pad_lens=pad, timings=timings)
        want = _uncaptured_tokens(model, ids, pad, 10)
        assert timings["decode_graph"] == route, (b, t, pads)
        assert timings["decode_ms"] > 0
        assert got.dtype == torch.int32 and got.shape == (b, 10)
        assert torch.equal(got, want), (b, t, pads)
        seen.append(got.cpu())
    assert not torch.equal(seen[0], seen[1])
    assert not torch.equal(seen[3], seen[4])
    # a parameter that moves (a new tensor, as an assigning load makes)
    # leaves the graphs reading the old one: they are captured anew
    head = model.lm_head
    name = "kernel_q" if quantized else "weight"
    setattr(head, name, torch.nn.Parameter(
        getattr(head, name).detach().flip(-1).clone(), requires_grad=False))
    timings = {}
    got = greedy_generate_llava(model, ids, max_new_tokens=10,
                                pad_lens=pad, timings=timings)
    assert timings["decode_graph"] == "captured"
    assert torch.equal(got, _uncaptured_tokens(model, ids, pad, 10))
    assert not torch.equal(got.cpu(), seen[-1])


def test_scorer_reports_the_capture_then_the_replays(cuda):
    """``LlavaTorchScorer.last["decode_graph"]`` on the card: "captured"
    on the first rerank of a shape, "replayed" after it, and "captured"
    again where a batch of another size is new."""
    from leafgrasp_tpu_torch.vla.llava_runtime import LlavaTorchScorer

    class Tok:
        def encode(self, text):
            data = np.frombuffer(text.encode(), np.uint8).astype(np.int64)
            fold = np.zeros(-(-len(data) // 24) * 24, np.int64)
            fold[:len(data)] = data
            return [1] + (fold.reshape(-1, 24).sum(0) % 190 + 3).tolist()

        def decode(self, ids):
            return "0." + "".join(str(int(i) % 10) for i in ids)

    cands = [dict(leaf_id=i + 1, x=float(10 + 7 * i), y=float(30 - 3 * i),
                  clutter_score=0.2 + 0.1 * i, distance_score=0.9 - 0.1 * i,
                  geometric_score=0.5 + 0.05 * i) for i in range(5)]
    scorer = LlavaTorchScorer(_graph_llava(cuda, False), Tok(),
                              max_new_tokens=6)
    first = scorer.score(None, cands, "Select")
    assert scorer.last["decode_graph"] == "captured"
    assert scorer.score(None, cands, "Select") == first
    assert scorer.last["decode_graph"] == "replayed"
    scorer.max_batch = 2
    scorer.score(None, cands, "Select")
    assert scorer.last["decode_graph"] == "captured"
    scorer.score(None, cands, "Select")
    assert scorer.last["decode_graph"] == "replayed"


# ------------------------------------------------ latent attention, experts --

@pytest.mark.parametrize("shape,pads", [
    ((5, 2400, 16), (0, 0, 0, 0, 0)),
    ((2, 333, 16), (70, 5)),
    ((3, 129, 4), (128, 0, 64)),
    ((1, 1, 2), (0,)),
])
def test_flash_prefill_split_heads_match_plain_on_card(cuda, shape, pads):
    """Latent attention's split heads (q and k of 192, v of 128, bf16):
    the kernel against its plain version, v read as the value half of
    ``kv_b_proj``'s (b, t, heads, 256) output and k through the strides
    of a longer tensor that holds NaN beyond t, with and without the
    log-sum-exp; the flash tolerances of bf16, pad rows exactly zero,
    the same bits on a second run."""
    b, t, heads = shape
    rng = np.random.default_rng(23)

    def t_(*s):
        return torch.as_tensor(rng.standard_normal(s).astype(np.float32),
                               device=cuda).to(torch.bfloat16)

    q = t_(b, t, heads, 192)
    k = t_(b, t + 10, heads, 192)
    kv = t_(b, t + 10, heads, 256)
    k[:, t:] = float("nan")
    kv[:, t:] = float("nan")
    v = kv[..., 128:]
    pad = torch.tensor(pads, dtype=torch.int32, device=cuda)
    kernels.reset_launch_counts()
    got = flash_prefill(q, k, v, pad)
    again = flash_prefill(q, k, v, pad)
    got_lse, lse = flash_prefill(q, k, v, pad, return_lse=True)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_prefill"] == 3
    assert torch.equal(got, again)
    want, lse_plain = flash_prefill_plain(q, k, v, pad, chunk=256,
                                          return_lse=True)
    atol, rtol, rowtol = FLASH_TOL[torch.bfloat16]
    allowed = rtol * want.float().abs() \
        + rowtol * want.float().abs().amax(-1, keepdim=True)
    for out in (got, got_lse):
        assert out.shape == (b, t, heads, 128)
        assert torch.isfinite(out.float()).all()
        for i, p in enumerate(pads):
            assert not out[i, :p].any()
        diff = (out.float() - want.float()).abs()
        assert float((diff - allowed).max()) <= atol, float(diff.max())
    real = torch.isfinite(lse_plain)
    assert torch.equal(real, torch.isfinite(lse))
    assert float((lse - lse_plain)[real].abs().max()) <= 1e-5
    with pytest.raises(ValueError):
        flash_prefill(q.float(), k.float(), v.float(), pad)


def _moe_operands(cuda, n_tok, k=6, e=64, hidden=2048, width=1408,
                  idle=()):
    """Moonlight's expert widths in bf16 and a routing of ``n_tok``
    tokens that leaves the experts ``idle`` without a pair."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n_tok)
    x = torch.randn((n_tok, hidden), generator=gen, device=cuda) \
        .to(torch.bfloat16)
    ws = [(torch.randn(s, generator=gen, device=cuda) * 0.02)
          .to(torch.bfloat16) for s in ((e, width, hidden),
                                        (e, width, hidden),
                                        (e, hidden, width))]
    score = torch.rand((n_tok, e), generator=gen, device=cuda)
    if idle:
        score[:, list(idle)] = -1.0
    ids = torch.topk(score, k, dim=-1).indices
    w = torch.rand((n_tok, k), generator=gen, device=cuda)
    return x, ids, w, ws


@pytest.mark.parametrize("n_tok,idle", [(2400, ()), (2400, (3, 40, 63)),
                                        (5, ()), (1, (0,)), (43, ())])
def test_moe_experts_kernel_matches_plain_on_card(cuda, n_tok, idle):
    """The grouped expert kernel at Moonlight's widths against its plain
    version (a loop over the experts): a prompt pass's tokens, a decode
    step's five, one token, and routings that leave experts without a
    pair; within 2^-6 of the value plus 2^-6 of the row's largest (bf16
    outputs and the rounding of h, from f32 sums in another order); the
    same bits on a second run; the idle experts without pairs."""
    from leafgrasp_tpu_torch.kernels import moe_experts as me
    x, ids, w, ws = _moe_operands(cuda, n_tok, idle=idle)
    kernels.reset_launch_counts()
    got = me.moe_experts(x, ids, w, *ws)
    again = me.moe_experts(x, ids, w, *ws)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["moe_experts"] == 2
    assert torch.equal(got, again)
    want = me.moe_experts_plain(x, ids, w, *ws)
    allowed = 2.0 ** -6 * want.float().abs() \
        + 2.0 ** -6 * want.float().abs().amax(-1, keepdim=True)
    diff = (got.float() - want.float()).abs()
    assert float((diff - allowed).max()) <= 0.0, float(diff.max())
    counts = me.expert_counts(ids, 64).cpu()
    assert int(counts.sum()) == n_tok * 6
    for i in idle:
        assert int(counts[i]) == 0


def _graph_moe_llava(cuda):
    """A small random LLaVA over the deepseek_v3 decoder in bf16 at
    Moonlight's head sizes (q/k 192, v 128, so prompts of 128 tokens or
    more take the split-head flash prefill): 3 layers, one dense, 8
    experts, 2 a token, one shared."""
    from leafgrasp_tpu_torch.vla.llava_torch import (LlavaTorch,
                                                     LlavaTorchConfig,
                                                     init_random_)
    cfg = LlavaTorchConfig(
        vis_hidden=32, vis_intermediate=64, vis_layers=1, vis_heads=2,
        image_size=28, patch_size=14, vocab_size=256, hidden=256,
        intermediate=512, layers=3, heads=2, kv_heads=2,
        image_token_index=200, dtype="bfloat16", prefill_attn_impl="flash",
        decoder="deepseek_v3", kv_lora_rank=64, qk_nope_head_dim=128,
        qk_rope_head_dim=64, v_head_dim=128, n_routed_experts=8,
        num_experts_per_tok=2, n_shared_experts=1,
        moe_intermediate_size=128, first_k_dense_replace=1,
        routed_scaling_factor=2.446, rope_theta=50000.0)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    return init_random_(LlavaTorch(cfg, device=cuda,
                                   param_dtype=torch.bfloat16), gen, std=0.1)


def test_moe_decode_graph_replays_the_uncaptured_steps(cuda):
    """The deepseek_v3 decoder's decode on the graph route (latent caches,
    the grouped expert kernel, routing that depends on the data) gives
    the tokens of the same steps run uncaptured, at 3 and 5 rows with
    unequal pads, for a capture and a replay; the prompt pass launches
    the split-head flash kernel once a layer."""
    from leafgrasp_tpu_torch.vla.llava_torch import greedy_generate_llava
    model = _graph_moe_llava(cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(12)
    calls = [(3, 150, [0, 7, 40], "captured"),
             (3, 150, [5, 0, 60], "replayed"),
             (5, 151, [0, 3, 17, 1, 30], "captured")]
    for b, t, pads, route in calls:
        ids = torch.randint(1, 200, (b, t), generator=gen, device=cuda)
        pad = torch.tensor(pads, dtype=torch.int32, device=cuda)
        ids[torch.arange(t, device=cuda)[None, :] < pad[:, None]] = 0
        timings = {}
        kernels.reset_launch_counts()
        got = greedy_generate_llava(model, ids, max_new_tokens=8,
                                    pad_lens=pad, timings=timings)
        counts = kernels.launch_counts()
        assert timings["decode_graph"] == route
        assert timings["moe_load"].shape == (2,)
        want = _uncaptured_tokens(model, ids, pad, 8)
        assert torch.equal(got, want), (b, t, pads)
        assert counts["flash_prefill"] == 3


def test_moe_prefill_and_decode_step_never_synchronize(cuda):
    """The deepseek_v3 decoder's prompt pass and a decode step (routing,
    grouped experts, latent caches, the flash prefill) under
    ``torch.cuda.set_sync_debug_mode("error")``: nothing waits on the
    card (after one warm-up pass that builds the kernels)."""
    from leafgrasp_tpu_torch.vla import llava_torch as tl
    from leafgrasp_tpu_torch.vla.layers import KVCache
    model = _graph_moe_llava(cuda)
    b, t = 5, 140
    ids = torch.randint(1, 200, (b, t), device=cuda)
    pad = torch.tensor([0, 3, 0, 9, 1], dtype=torch.int32, device=cuda)
    prompt_len = torch.full((), t, dtype=torch.int64, device=cuda)

    def passes():
        cache = KVCache(model.cfg, b, 192, cuda)
        first, _ = tl._generate_prefill(model, ids, pad, None, None, cache)
        return tl._generate_decode_step(model, cache, first, pad, 0,
                                        prompt_len)

    with torch.no_grad():
        passes()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = passes()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert out.shape == (b,)


# ---------------------------------- the shared image prefix: a query offset --

@pytest.mark.parametrize("pads", [(0, 0, 0, 0, 0), (0, 3, 700, 2350, 2401)])
@pytest.mark.parametrize("t", [61, 128])
@pytest.mark.parametrize("heads,dtype", [
    ("gqa_128", torch.bfloat16), ("split_192_128", torch.bfloat16),
    ("gqa_128", torch.float32), ("gqa_64", torch.float32)])
def test_flash_prefill_query_offset_matches_plain_on_card(cuda, heads, dtype,
                                                          t, pads):
    """The bf16 kernel's instantiations and the f32 kernel at the rerank's
    suffix shape: 5 rows of t queries at the key rows 2401 - t .. 2400 of
    a cache whose rows past 2401 hold NaN (never to be read), pads at 0
    and unequal (inside the prefix, inside the queries, past every key).
    Real rows within the flash tolerance of their type of the plain
    version at the same offset, pad rows exactly zero, everything
    finite, the same bits on a second run; with the log-sum-exp too, it
    within 1e-5 of the plain one, -inf on pad rows."""
    b, keys = 5, 2401
    o = keys - t
    h, kvh, hd, hdv = {"gqa_128": (32, 8, 128, 128),
                       "gqa_64": (8, 2, 64, 64),
                       "split_192_128": (16, 16, 192, 128)}[heads]
    rng = np.random.default_rng(41)

    def t_(*s):
        return torch.as_tensor(rng.standard_normal(s).astype(np.float32),
                               device=cuda).to(dtype)

    q = t_(b, t, h, hd)
    k = t_(b, keys + 10, kvh, hd)
    kv = t_(b, keys + 10, kvh, 2 * hdv)
    k[:, keys:] = float("nan")
    kv[:, keys:] = float("nan")
    v = kv[..., hdv:]
    pad = torch.tensor(pads, dtype=torch.int32, device=cuda)
    kernels.reset_launch_counts()
    got = flash_prefill(q, k, v, pad, o)
    again = flash_prefill(q, k, v, pad, o)
    got_lse, lse = flash_prefill(q, k, v, pad, o, return_lse=True)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_prefill"] == 3
    assert torch.equal(got, again)
    want, lse_plain = flash_prefill_plain(q, k, v, pad, o, chunk=64,
                                          return_lse=True)
    atol, rtol, rowtol = FLASH_TOL[dtype]
    allowed = rtol * want.float().abs() \
        + rowtol * want.float().abs().amax(-1, keepdim=True)
    for out in (got, got_lse):
        assert out.dtype == dtype and out.shape == (b, t, h, hdv)
        assert torch.isfinite(out.float()).all()
        for i, p in enumerate(pads):
            assert not out[i, :max(p - o, 0)].any()
        diff = (out.float() - want.float()).abs()
        assert float((diff - allowed).max()) <= atol, float(diff.max())
    real = torch.isfinite(lse_plain)
    assert torch.equal(real, torch.isfinite(lse))
    assert float((lse - lse_plain)[real].abs().max()) <= 1e-5


def _shared_prefix_inputs(cuda, model, n, texts, seed):
    """Rows of n image tokens then text, left padded to one length, and
    features of one image: (ids, pad on the card, pads, features)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    t = n + max(texts)
    ids = torch.zeros((len(texts), t), dtype=torch.int64, device=cuda)
    pads = []
    for r, m in enumerate(texts):
        p = t - n - m
        ids[r, p:p + n] = model.cfg.image_token_index
        ids[r, p + n:] = torch.randint(1, 200, (m,), generator=gen,
                                       device=cuda)
        pads.append(p)
    feats = torch.randn((1, n, model.cfg.hidden), generator=gen,
                        device=cuda).to(torch.bfloat16)
    return ids, torch.tensor(pads, dtype=torch.int32, device=cuda), pads, \
        feats


def _uncaptured_shared_tokens(model, ids, pad, pads, feats, n_new):
    """The shared route's tokens without a graph: its prompt pass into a
    fresh store of the graph route's capacity, then the step function,
    run eagerly."""
    from leafgrasp_tpu_torch.vla import llava_torch as tl
    from leafgrasp_tpu_torch.vla.layers import KVCache
    b, t = ids.shape
    cap = -(-(t + n_new) // tl.CACHE_QUANTUM) * tl.CACHE_QUANTUM
    cache = KVCache(model.cfg, b, cap, ids.device)
    with torch.no_grad():
        first, _ = tl._generate_prefill_shared(model, ids, pad, pads, feats,
                                               cache)
        steps = tl._decode_steps(
            model, cache, first, pad,
            torch.full((), t, dtype=torch.int64, device=ids.device),
            n_new - 1)
    return torch.cat([first[:, None], steps], dim=1).to(torch.int32)


@pytest.mark.parametrize("decoder", ["mistral", "deepseek_v3"])
def test_shared_prefix_route_on_the_graph_replays_its_eager_steps(cuda,
                                                                  decoder):
    """Features of one image under several rows on the card: the
    prefix's attention and the rows' text's both launch the flash
    kernel, a layer each (no other attention), and the graph route's
    tokens equal the same pass and steps run eagerly on a fresh store,
    bit for bit, for a capture and replays with other pads (the static
    caches' old slots zeroed), rows of equal length, and more rows; for
    the decoder with experts one expert launch a layer for the whole
    prompt."""
    from leafgrasp_tpu_torch.vla.llava_torch import greedy_generate_llava
    model = _graph_llava(cuda, False) if decoder == "mistral" \
        else _graph_moe_llava(cuda)
    c = model.cfg
    calls = [((20, 9, 31), "captured"), ((31, 20, 9), "replayed"),
             ((14, 14, 14), "replayed"), ((5, 30, 12, 1, 25), "captured"),
             ((30, 5, 1, 25, 12), "replayed")]
    seen = []
    for i, (texts, route) in enumerate(calls):
        ids, pad, pads, feats = _shared_prefix_inputs(cuda, model, 140,
                                                      texts, 20 + i)
        timings = {}
        kernels.reset_launch_counts()
        got = greedy_generate_llava(model, ids, image_features=feats,
                                    max_new_tokens=8, pad_lens=pads,
                                    timings=timings)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert (timings["prefill_route"], timings["decode_graph"]) \
            == ("shared", route)
        assert counts["flash_prefill"] == 2 * c.layers
        if c.mla and route == "replayed":
            assert counts["moe_experts"] \
                == c.layers - c.first_k_dense_replace
        want = _uncaptured_shared_tokens(model, ids, pad, pads, feats, 8)
        assert torch.equal(got, want), texts
        seen.append(got.cpu())
    assert not torch.equal(seen[0], seen[1])


@pytest.mark.parametrize("decoder", ["mistral", "deepseek_v3"])
def test_shared_prefix_route_never_synchronizes(cuda, decoder):
    """The shared route's prompt pass (the prefix, its K/V written into
    every row, the rows' text at a query offset) under
    ``torch.cuda.set_sync_debug_mode("error")``: nothing waits on the
    card (after one warm-up that builds the kernels)."""
    from leafgrasp_tpu_torch.vla import llava_torch as tl
    from leafgrasp_tpu_torch.vla.layers import KVCache
    model = _graph_llava(cuda, False) if decoder == "mistral" \
        else _graph_moe_llava(cuda)
    ids, pad, pads, feats = _shared_prefix_inputs(cuda, model, 140,
                                                  (20, 9, 31, 2, 14), 30)

    def prefill():
        cache = KVCache(model.cfg, ids.shape[0], 256, cuda)
        return tl._generate_prefill_shared(model, ids, pad, pads, feats,
                                           cache)[0]

    with torch.no_grad():
        prefill()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = prefill()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert out.shape == (ids.shape[0],)


def test_checkpoint_scorer_in_f32_shares_the_image_prefix_on_card(cuda,
                                                                  tmp_path):
    """A checkpoint loaded onto the card keeps the f32 compute type (the
    serving CLI's case); its anyres scorer passes the frame's features
    once for several candidates, so the rows' text runs the f32 kernel at
    a query offset: two flash launches a layer (the prefix's and the
    text's), nothing else for the prompt's attention. Every row decodes
    the tokens that scoring the candidates one by one gives (one row: the
    single pass), and the scores are the same."""
    from leafgrasp_tpu_torch.vla.checkpoint_io import (
        load_llava_checkpoint, write_synthetic_llava_checkpoint)
    from leafgrasp_tpu_torch.vla.llava_runtime import LlavaTorchScorer
    from leafgrasp_tpu_torch.vla.layers import FLASH_MIN_TOKENS
    from leafgrasp_tpu_torch.vla.llava_torch import LlavaTorchConfig
    cfg = LlavaTorchConfig(
        vis_hidden=64, vis_intermediate=128, vis_layers=2, vis_heads=2,
        image_size=112, patch_size=14, vocab_size=256, hidden=256,
        intermediate=512, layers=2, heads=2, kv_heads=1,
        image_token_index=200,
        image_grid_pinpoints=((112, 224), (224, 112), (224, 224)))
    d = str(tmp_path / "ckpt")
    write_synthetic_llava_checkpoint(d, cfg, seed=6, n_shards=2)
    model, _, tok = load_llava_checkpoint(d, dtype="bfloat16", device=cuda)
    assert model.cfg.torch_dtype == torch.float32
    model.set_prefill_attn("flash")
    rgb = (np.random.default_rng(6).uniform(0, 255, (150, 200, 3))
           .astype(np.uint8))
    cands = [dict(leaf_id=i + 1, x=float(20 + 35 * i), y=float(30 + 20 * i),
                  geometric_score=0.9 - 0.1 * i) for i in range(4)]
    batched = LlavaTorchScorer(model, tok, max_new_tokens=4, anyres=True)
    kernels.reset_launch_counts()
    with torch.no_grad():
        scores = batched.score(rgb, cands, "pick the best leaf")
    torch.cuda.synchronize()
    assert batched.last["prefill_route"] == "shared"
    assert batched.last["n_image_tokens"] >= FLASH_MIN_TOKENS
    assert kernels.launch_counts()["flash_prefill"] == 2 * cfg.layers
    single = LlavaTorchScorer(model, tok, max_new_tokens=4, anyres=True,
                              max_batch=1)
    with torch.no_grad():
        want = single.score(rgb, cands, "pick the best leaf")
    assert single.last["prefill_route"] == "full"
    assert batched.last["tokens"] == single.last["tokens"]
    assert scores == want and all(np.isfinite(scores))


# ------------------------------------------- the decode step's attention --

# (b, capacity, heads, kv_heads, hd, cursor, pads): the 7B cell's step
# (2400 prompt slots, the graph route's capacity), its heads as two and
# four tensor-parallel ranks would hold them (16 over 4, 8 over 2: on 132
# SMs 26 and 52 shares a row), the card tests' model (head size 64), and
# a capacity over 8192 slots (33 shares of 256 keys at most); past 32
# shares the pv kernel's lanes merge more than one share's (max, sum)
DECODE_SHAPES = [
    (5, 2432, 32, 8, 128, 2405, (0, 3, 700, 2401, 2405)),
    (5, 2432, 32, 8, 128, 2409, (0, 0, 0, 0, 0)),
    (5, 2432, 16, 4, 128, 2405, (0, 3, 700, 2401, 2405)),
    (5, 2432, 8, 2, 128, 2409, (0, 2, 5, 1, 3)),
    (3, 192, 4, 2, 64, 150, (0, 7, 40)),
    (2, 64, 12, 2, 64, 63, (0, 63)),
    (2, 8448, 32, 8, 64, 8400, (0, 5000)),
]


def _decode_inputs(cuda, dtype, b, cap, heads, kvh, hd, pos, pads,
                   seed=9):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    q = (2.0 * torch.randn((b, 1, heads, hd), generator=gen,
                           device=cuda)).to(dtype)
    kv = torch.randn((2, b, cap, kvh, hd), generator=gen,
                     device=cuda).to(dtype)
    pad = torch.tensor(pads, dtype=torch.int32, device=cuda)
    cursor = torch.tensor([pos], dtype=torch.int64, device=cuda)
    return q, kv, pad, cursor


def _dead_slots(kv, pads, pos, window=None):
    """A copy of the caches with every slot that is no live key of its
    row filled with NaN in K and 1e4 in V."""
    kv = kv.clone()
    key = torch.arange(kv.shape[2], device=kv.device)
    for r, p in enumerate(pads):
        lo = p if window is None else max(p, pos - window + 1)
        dead = (key < lo) | (key > pos)
        kv[0, r, dead] = float("nan")
        kv[1, r, dead] = 1e4
    return kv


def _check_decode_close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.float(), want.float()
    if got.dtype == torch.float32:
        bound = 1e-5 + 1e-5 * w.abs()
    else:
        bound = 2.0 ** -7 * (w.abs() + w.abs().amax(-1, keepdim=True))
    assert bool(((g - w).abs() <= bound).all()), \
        float(((g - w).abs() - bound).max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_decode_attention_kernel_matches_plain_on_card(cuda, dtype, shape):
    """The kernel against its plain version at the 7B cell's step and the
    test model's, unequal pads (one row's only live key the cursor);
    slots before the pad and past the cursor filled with NaN and 1e4
    change no bit; two launches are bit-equal; one count a call."""
    from leafgrasp_tpu_torch.kernels.decode_attention import (
        decode_attention, decode_attention_plain)
    b, cap, heads, kvh, hd, pos, pads = shape
    q, kv, pad, cursor = _decode_inputs(cuda, dtype, b, cap, heads, kvh,
                                        hd, pos, pads)
    want = decode_attention_plain(q, kv[0], kv[1], pad, cursor, dtype)
    kernels.reset_launch_counts()
    got = decode_attention(q, kv[0], kv[1], pad, cursor, dtype)
    again = decode_attention(q, kv[0], kv[1], pad, cursor, dtype)
    dead = _dead_slots(kv, pads, pos)
    filled = decode_attention(q, dead[0], dead[1], pad, cursor, dtype)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["decode_attention"] == 3
    _check_decode_close(got, want)
    assert torch.equal(got, again) and torch.equal(got, filled)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window", [1, 37, 600])
def test_decode_attention_kernel_keeps_to_the_window_on_card(cuda, dtype,
                                                             window):
    """With a sliding window the keys before ``pos - window + 1`` are left
    out: the plain version under the window, and NaN there changes no
    bit."""
    from leafgrasp_tpu_torch.kernels.decode_attention import (
        decode_attention, decode_attention_plain)
    b, cap, heads, kvh, hd, pos = 3, 1024, 8, 2, 128, 1000
    pads = (0, 980, 430)
    q, kv, pad, cursor = _decode_inputs(cuda, dtype, b, cap, heads, kvh,
                                        hd, pos, pads, seed=10)
    want = decode_attention_plain(q, kv[0], kv[1], pad, cursor, dtype,
                                  window)
    got = decode_attention(q, kv[0], kv[1], pad, cursor, dtype, window)
    dead = _dead_slots(kv, pads, pos, window)
    filled = decode_attention(q, dead[0], dead[1], pad, cursor, dtype,
                              window)
    _check_decode_close(got, want)
    assert torch.equal(got, filled)


def test_decode_attention_graph_reads_the_cursor_on_card(cuda):
    """One captured graph of the kernel, replayed at two cursors and two
    sets of pads written into its static inputs, gives the eager
    launches' bits at each: nothing of the first call is baked in."""
    from leafgrasp_tpu_torch.kernels.decode_attention import decode_attention
    b, cap, heads, kvh, hd = 5, 2432, 32, 8, 128
    q, kv, pad, cursor = _decode_inputs(cuda, torch.bfloat16, b, cap, heads,
                                        kvh, hd, 2405, (0, 1, 2, 3, 4))
    decode_attention(q, kv[0], kv[1], pad, cursor, torch.bfloat16)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention(q, kv[0], kv[1], pad, cursor,
                               torch.bfloat16)
    seen = []
    for pos, pads in ((2405, (0, 1, 2, 3, 4)), (1300, (9, 0, 1299, 5, 77))):
        cursor.fill_(pos)
        pad.copy_(torch.tensor(pads, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        eager = decode_attention(q, kv[0], kv[1], pad, cursor,
                                 torch.bfloat16)
        assert torch.equal(out, eager), pos
        seen.append(out.clone())
    assert not torch.equal(seen[0], seen[1])


def test_decode_attention_raises_on_card_for_what_it_lacks(cuda):
    from leafgrasp_tpu_torch.kernels.decode_attention import decode_attention
    for hd, dtype in ((96, torch.bfloat16), (128, torch.float16)):
        q, kv, pad, cursor = _decode_inputs(cuda, dtype, 2, 64, 4, 2, hd, 30,
                                            (0, 1))
        with pytest.raises(ValueError, match="the kernel takes"):
            decode_attention(q, kv[0], kv[1], pad, cursor, dtype)


@pytest.mark.parametrize("quantized", [False, True])
def test_decode_steps_launch_the_kernel_once_a_layer_on_card(cuda,
                                                             quantized):
    """Eager steps launch the decode kernel once a layer and step; the
    graph route's timings and the scorer's record say "kernel"."""
    from leafgrasp_tpu_torch.vla.llava_torch import greedy_generate_llava
    model = _graph_llava(cuda, quantized)
    b, t, n_new = 3, 150, 6
    ids = torch.randint(1, 200, (b, t), device=cuda)
    pad = torch.tensor([0, 7, 40], dtype=torch.int32, device=cuda)
    kernels.reset_launch_counts()
    _uncaptured_tokens(model, ids, pad, n_new)
    assert kernels.launch_counts()["decode_attention"] == \
        model.cfg.layers * (n_new - 1)
    timings = {}
    greedy_generate_llava(model, ids, max_new_tokens=n_new, pad_lens=pad,
                          timings=timings)
    assert timings["decode_graph"] == "captured"
    assert timings["decode_attention"] == "kernel"
    timings = {}
    greedy_generate_llava(model, ids, max_new_tokens=n_new, pad_lens=pad,
                          timings=timings)
    assert timings["decode_graph"] == "replayed"
    assert timings["decode_attention"] == "kernel"
