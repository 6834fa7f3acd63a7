"""The port's first three kernel modules (min-plus, fused scoring,
attention gate; the row-banded EDT and the segment histogram are in
tests/test_torch_edt_median.py): plain versions against the JAX
package's Pallas kernels (interpret mode) and oracles, the wrappers'
CPU dispatch and argument checks, and the build's flags. The kernels
themselves are held against their plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.

Tolerances: min-plus and every EDT bit-exact (integer-valued f32 below
2^24, and past it the JAX package's own rounding); fused scoring 1e-5
absolute, valid mask equal; attention gate 1e-5 absolute.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from leafgrasp_tpu.config import GraspScoringConfig as JScoringConfig
from leafgrasp_tpu.io.scenes import make_leaf_scene
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from leafgrasp_tpu_torch import kernels
from leafgrasp_tpu_torch.config import GraspScoringConfig
from leafgrasp_tpu_torch.kernels import build
from leafgrasp_tpu_torch.kernels.attention import (MODES,
                                                   attention_gate_plain,
                                                   fused_attention_gate)
from leafgrasp_tpu_torch.kernels.minplus import (BAND_COLS, BAND_ROWS,
                                                 max_g2, minplus_form,
                                                 minplus_pass2,
                                                 minplus_pass2_plain)
from leafgrasp_tpu_torch.kernels.scoring import (fused_score_maps,
                                                 fused_score_maps_plain)

CX, CY, F = np.float32(80.0), np.float32(48.0), np.float32(400.0)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def g2_stack():
    """(3, 96, 160) pass-1 squared fields: dense, sparse, seedless."""
    from leafgrasp_tpu.ops.edt import nearest_seed_dist_1d
    rng = np.random.default_rng(5)
    dense = rng.random((96, 160)) < 0.1
    sparse = np.zeros((96, 160), bool)
    sparse[7, 140] = True
    seeds = np.stack([dense, sparse, np.zeros((96, 160), bool)])
    g = np.asarray(nearest_seed_dist_1d(jnp.asarray(seeds), axis=1),
                   np.float32)
    return g * g


def _brute(g2, qcol, lo, hi):
    """float64 reference: out[r, q] = min_{lo[r,q] <= s < hi[r,q]} ..."""
    r, w = g2.shape
    s = np.arange(w)[None, None, :]
    q = qcol[:, :, None].astype(np.float64)
    cand = g2[:, None, :].astype(np.float64) + (q - s) ** 2
    cand = np.where((s >= lo[:, :, None]) & (s < hi[:, :, None]), cand,
                    np.inf)
    return cand.min(axis=-1).astype(np.float32)


# ---- min-plus --------------------------------------------------------------

def test_minplus_plain_matches_pallas_full_and_banded(g2_stack):
    from leafgrasp_tpu.ops.pallas_edt import (squared_edt_pass2,
                                              squared_edt_pass2_banded)
    c, h, w = g2_stack.shape
    want = np.asarray(squared_edt_pass2(g2_stack, interpret=True))
    np.testing.assert_array_equal(
        np.asarray(squared_edt_pass2_banded(g2_stack, interpret=True)), want)
    flat = _t(g2_stack.reshape(c * h, w))
    np.testing.assert_array_equal(
        minplus_pass2_plain(flat).reshape(c, h, w).numpy(), want)
    # the per-tile radii of the Pallas banded kernel (pallas_edt.py:139-155)
    big = np.float32((h + w) ** 2)
    nc = -(-w // BAND_COLS)
    g2p = np.pad(g2_stack, ((0, 0), (0, 0), (0, nc * BAND_COLS - w)),
                 constant_values=big)
    upper = g2p.copy()
    for delta in (1, 4, 16, 64):
        sp = np.pad(g2p[:, :, delta:], ((0, 0), (0, 0), (0, delta)),
                    constant_values=big) + np.float32(delta * delta)
        sm = np.pad(g2p[:, :, :-delta], ((0, 0), (0, 0), (delta, 0)),
                    constant_values=big) + np.float32(delta * delta)
        upper = np.minimum(upper, np.minimum(sp, sm))
    tile_max = upper.reshape(c, h // BAND_ROWS, BAND_ROWS, nc,
                             BAND_COLS).max(axis=(2, 4))
    nb = np.minimum((np.sqrt(tile_max) / BAND_COLS).astype(np.int32) + 1,
                    nc - 1)
    band = _t(nb.reshape(c * h // BAND_ROWS, nc))
    np.testing.assert_array_equal(
        minplus_pass2_plain(flat, band=band).reshape(c, h, w).numpy(), want)


def test_minplus_plain_query_forms_match_bruteforce(g2_stack):
    g2 = g2_stack.reshape(-1, g2_stack.shape[-1])[:120]
    r, w = g2.shape
    rng = np.random.default_rng(1)
    shared = np.array([0, 3, 16, 17, 100, 159], np.int32)
    per_row = rng.integers(0, w, (r, 5)).astype(np.int32)
    zeros, full = np.zeros((r, 1), int), np.full((r, 1), w)
    for qcol, lo, hi in (
            (shared, 0, w), (per_row, 0, w), (shared, 30, 90),
            (np.arange(40, 72, dtype=np.int32), 10, 100)):
        kw = {"qcol": _t(qcol)}
        if (lo, hi) != (0, w):
            kw.update(s_lo=lo, s_hi=hi)
        got = minplus_pass2_plain(_t(g2), **kw).numpy()
        q2 = np.broadcast_to(qcol, (r, qcol.shape[-1]))
        want = _brute(g2, q2, zeros + lo, full - w + hi)
        np.testing.assert_array_equal(got, want)


def test_minplus_band_restricts_sources(g2_stack):
    """A too-narrow band gives the min over exactly the banded chunks."""
    g2 = g2_stack[1]                           # the sparse field
    h, w = g2.shape
    nb = np.zeros((h // BAND_ROWS, -(-w // BAND_COLS)), np.int32)
    nb[::2] = 1
    got = minplus_pass2_plain(_t(g2), band=_t(nb)).numpy()
    qt = np.arange(w) // BAND_COLS
    rad = nb[np.arange(h) // BAND_ROWS][:, qt]
    lo = (qt[None, :] - rad) * BAND_COLS
    hi = (qt[None, :] + rad + 1) * BAND_COLS
    want = _brute(g2, np.broadcast_to(np.arange(w), (h, w)), lo, hi)
    np.testing.assert_array_equal(got, want)


def test_minplus_wrapper_cpu_and_checks(g2_stack):
    kernels.reset_launch_counts()
    g2 = _t(g2_stack[0])
    np.testing.assert_array_equal(minplus_pass2(g2).numpy(),
                                  minplus_pass2_plain(g2).numpy())
    assert kernels.launch_counts()["minplus_pass2"] == 0
    bad = [
        dict(g2=g2.double()),
        dict(g2=g2, qcol=torch.arange(4)),                  # not int32
        dict(g2=g2, qcol=torch.zeros((3, 2), dtype=torch.int32)),
        dict(g2=g2, s_lo=50, s_hi=10),
        dict(g2=g2, band=torch.zeros((2, 2), dtype=torch.int32)),
        dict(g2=g2, qcol=torch.arange(4, dtype=torch.int32),
             band=torch.zeros((12, 2), dtype=torch.int32)),
    ]
    for kw in bad:
        with pytest.raises(ValueError):
            minplus_pass2(**kw)
    with pytest.raises(ValueError):
        minplus_pass2(g2.to("meta"))


def test_minplus_plain_matches_pallas_at_the_edge_of_its_range():
    """Rows of the sentinel (H + W)^2 alone, with a source at the first,
    the last or both columns, and rows of the largest value the
    contract admits (2^24 - 2 W^2): the plain version, which the card
    holds the kernel to, against the Pallas kernel in interpret mode and
    a float64 reference, bit for bit. The width is a multiple of the
    Pallas kernel's 128-column chunk: it pads a narrower row with
    sentinel sources, which would win against the larger value."""
    from leafgrasp_tpu.ops.pallas_edt import squared_edt_pass2
    h, w = 96, 256
    g2 = np.full((5, h, w), np.float32((h + w) ** 2))
    g2[1, :, 0] = 0.0
    g2[2, :, w - 1] = 0.0
    g2[3, :, 0], g2[3, :, w - 1] = 0.0, 1.0
    g2[4] = np.float32(max_g2(w))
    assert float(g2.max()) + 2.0 * w * w == 2.0 ** 24
    want = np.asarray(squared_edt_pass2(g2, interpret=True))
    flat = g2.reshape(5 * h, w)
    got = minplus_pass2_plain(_t(flat)).numpy()
    np.testing.assert_array_equal(got.reshape(5, h, w), want)
    full = np.broadcast_to(np.arange(w), (5 * h, w))
    np.testing.assert_array_equal(
        got, _brute(flat, full, np.zeros((5 * h, 1), int),
                    np.full((5 * h, 1), w)))
    assert got[0, 0] == (h + w) ** 2 and got[h, w - 1] == (w - 1) ** 2
    assert (got[4 * h:] == max_g2(w)).all()


def _jax_edt():
    import importlib
    return importlib.import_module("leafgrasp_tpu.ops.edt")


def test_minplus_and_edt_raise_where_sums_could_pass_2_24():
    """A 4090 x 8 frame, whose sentinel (H + W)^2 alone passes 2^24, with
    seeds and without: every EDT entry point returns the JAX package's
    values bit for bit (none raises, on either device, since the
    min-plus rounds as JAX does past 2^24), and so does the grasp scorer's
    distance field in every isolation mode, its maps within 1e-5."""
    import leafgrasp_tpu.config as jcfg
    from leafgrasp_tpu.geometry.grasp_scorer import \
        compute_grasp_scores as j_scores
    from leafgrasp_tpu_torch.geometry.grasp_scorer import (
        compute_grasp_scores)
    from leafgrasp_tpu_torch.ops import edt as tedt
    jedt = _jax_edt()
    h, w = 4090, 8
    assert (h + w) ** 2 > 2 ** 24 and minplus_form(w, (h + w) ** 2) \
        == "direct"
    tall = np.zeros((h, w), bool)
    tall[5:60, 2:6] = True
    for seeds in (tall, np.zeros((h, w), bool)):
        g = np.asarray(jedt.nearest_seed_dist_1d(jnp.asarray(seeds), axis=0),
                       np.float32)
        g2 = g * g
        ts, tg = _t(seeds), _t(g2)
        pairs = [
            (jedt.squared_edt(seeds), tedt.squared_edt(ts)),
            (jedt.squared_edt_full(seeds), tedt.squared_edt_full(ts)),
            (jedt.edt_max_argmax(seeds), tedt.edt_max_argmax(ts)),
            (jedt.edt_max_argmax(seeds, g2=g2),
             tedt.edt_max_argmax(ts, g2=tg)),
            (jedt.squared_edt(None, g2=g2), tedt.squared_edt(None, g2=tg)),
            (jedt.squared_edt_window(g2, 2000, 0, 16, 4),
             tedt.squared_edt_window(tg, 2000, 0, 16, 4)),
            (jedt.squared_edt_window_src(g2[None], 2000, 2, 16, 4, 1),
             tedt.squared_edt_window_src(tg[None], 2000, 2, 16, 4, 1)),
            (jedt.edt_max_argmax_batch(g2[None]),
             tedt.edt_max_argmax_batch(tg[None]))]
        for i, (want, got) in enumerate(pairs):
            want = want if isinstance(want, tuple) else (want,)
            got = got if isinstance(got, tuple) else (got,)
            for a, b in zip(want, got):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                              err_msg=str(i))
        if not seeds.any():         # the sentinel itself, past 2^24
            assert float(pairs[0][1].max()) == float((h + w) ** 2)
    other = np.zeros((h, w), bool)
    other[100:130, 1:7] = True
    other[3000:3100, 0:3] = True
    depth = (0.4 + 1e-4 * np.arange(h * w).reshape(h, w) % 0.3) \
        .astype(np.float32)
    cx, cy, f = np.float32(4.0), np.float32(2045.0), np.float32(583.0)
    for mode in ("union", "union_half", "reference_self"):
        want = j_scores(tall, tall | other, depth, cx, cy, f,
                        cfg=jcfg.GraspScoringConfig(isolation_context=mode))
        got = compute_grasp_scores(
            _t(tall), _t(tall | other), _t(depth), _t(cx), _t(cy), _t(f),
            cfg=GraspScoringConfig(isolation_context=mode))
        np.testing.assert_array_equal(got.distance_map.numpy(),
                                      np.asarray(want.distance_map))
        for name in got._fields:
            a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
            if name == "valid_region":
                np.testing.assert_array_equal(b, a)
            else:
                np.testing.assert_allclose(b, a, rtol=0, atol=1e-5,
                                           err_msg=f"{mode} {name}")


def _large_frame_seeds(h, w, seeded):
    """Six 40 x 40 seed blobs beside a 600-column band without seeds, or
    no seed at all."""
    seeds = np.zeros((h, w), bool)
    if seeded:
        rng = np.random.default_rng(h * 7 + w)
        band0 = w // 2 - 300
        cols = np.concatenate([np.arange(0, band0 - 40),
                               np.arange(band0 + 600, w - 40)])
        for r, c in zip(rng.integers(0, h - 40, 6), rng.choice(cols, 6)):
            seeds[r:r + 40, c:c + 40] = True
    return seeds


@pytest.mark.parametrize("seeded", [True, False])
@pytest.mark.parametrize("shape", [(2048, 2448), (2448, 2048), (3000, 1600),
                                   (2160, 3840)])
def test_edt_windows_match_jax_on_large_frames(shape, seeded):
    """A 5 MP sensor frame (2048 x 2448, and on its side), 3000 x 1600 and
    4K UHD (2160 x 3840), whose sentinel (H + W)^2 passes 2^24: eight rows
    of the pass-1 field at mid-height through ``squared_edt_window`` (all
    columns) and ``squared_edt_window_src`` (a source sub-range in the
    seedless band, where every row holds no seed and the answer is the
    sentinel, and one beside a blob), bit for bit the JAX package's."""
    from leafgrasp_tpu_torch.ops import edt as tedt
    jedt = _jax_edt()
    h, w = shape
    big = (h + w) ** 2
    assert big > 2 ** 24 and minplus_form(w, big) == "direct"
    seeds = _large_frame_seeds(h, w, seeded)
    g = np.asarray(jedt.nearest_seed_dist_1d(jnp.asarray(seeds), axis=0),
                   np.float32)
    g2 = g * g
    r0 = h // 2 - 4
    want = np.asarray(jedt.squared_edt_window(g2, r0, 0, 8, w))
    got = tedt.squared_edt_window(_t(g2), r0, 0, 8, w).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.max() == np.float32(big) if not seeded else got.max() < big
    band_c0 = w // 2 - 32
    for c0 in (band_c0, 50):
        want = np.asarray(jedt.squared_edt_window_src(g2[None], r0, c0, 8,
                                                      64, 100))
        got = tedt.squared_edt_window_src(_t(g2)[None], r0, c0, 8, 64,
                                          100).numpy()
        np.testing.assert_array_equal(got, want)
        if c0 == band_c0:
            assert (got == np.float32(big)).all()


@pytest.mark.parametrize("h,w,g2_max,form", [
    (1080, 1440, None, "direct"),              # no bound stated: direct
    (None, 1672, None, "direct"),
    (None, 1673, None, "direct"),
    (1080, 1440, "frame", "expanded"),
    (1080, 1920, "frame", "expanded"),         # 3000^2 + 2 * 1920^2 < 2^24
    (2100, 1600, "frame", "direct"),
    (3000, 1600, "frame", "direct"),
    (2048, 2448, "frame", "direct"),           # a 5 MP sensor frame
    (2160, 3840, "frame", "direct"),           # 4K UHD
    (4090, 8, "frame", "direct"),              # (H + W)^2 alone past 2^24
    (None, 1673, 0, "expanded"),
    (None, 1600, max_g2(1600), "expanded"),    # the expanded form's edge
    (None, 1600, max_g2(1600) + 1, "direct"),
    (None, 1600, 2 ** 24 - 1600 ** 2, "direct"),
    (None, 1600, 2 ** 24 - 1600 ** 2 + 1, "direct"),
    (None, 2896, 0, "expanded"),               # 2 W^2 <= 2^24
    (None, 2897, 0, "direct"),
])
def test_minplus_form_at_each_edge(h, w, g2_max, form):
    """The one choice of the min-plus form: pure Python, so it is held
    here at each edge. The expanded form where it is exact, the direct
    form, which rounds as the plain version and JAX do, everywhere else;
    nothing raises. "frame" states the frame's sentinel (H + W)^2, as
    ``ops/edt.py`` does."""
    if g2_max == "frame":
        g2_max = (h + w) ** 2
    assert minplus_form(w, g2_max) == form
    if form == "expanded" and g2_max is not None:
        assert g2_max + 2 * w * w <= 2 ** 24


def test_minplus_plain_rounds_as_jax_past_4097_columns():
    """Past W = 4097 the square (q - s)^2 itself rounds: the plain version
    rounds it before the sum, as the JAX package's ``off = (q - s)^2``
    does, so the two agree bit for bit on rows with a source at each end
    and the sentinel between."""
    jedt = _jax_edt()
    w = 4700
    g2 = np.full((2, w), np.float32((8 + w) ** 2))
    g2[:, 0] = 0.0
    g2[1, w - 1] = 3.0
    want = np.asarray(jedt.squared_edt_window(g2, 0, 0, 2, w))
    got = minplus_pass2_plain(_t(g2)).numpy()
    np.testing.assert_array_equal(got, want)
    last = np.float32(w - 1)
    assert got[0, w - 1] == np.multiply(last, last)
    assert float(got[0, w - 1]) != (w - 1) ** 2      # it rounded


# ---- fused scoring -----------------------------------------------------------

def _scoring_inputs():
    from leafgrasp_tpu.geometry.grasp_scorer import stem_penalty_map
    from leafgrasp_tpu.ops.edt import edt
    mask, depth = make_leaf_scene(height=96, width=160, num_leaves=3,
                                  seed=1, margin=20)
    leaf = mask == 2
    other = (mask > 0) & ~leaf
    rng = np.random.default_rng(2)
    fields = [np.asarray(edt(~leaf)), np.zeros(leaf.shape, np.float32),
              np.asarray(edt(other)), np.asarray(edt(mask == 1)) * 0.5,
              (rng.random(leaf.shape) * 0.3).astype(np.float32),
              leaf.astype(np.float32),
              np.asarray(stem_penalty_map(leaf, JScoringConfig()))]
    return [np.asarray(f, np.float32) for f in fields]


@pytest.mark.parametrize("angle_valid", [True, False])
@pytest.mark.parametrize("row0", [0, 8])
def test_fused_scoring_plain_matches_pallas(angle_valid, row0):
    from leafgrasp_tpu.ops.pallas_scoring import fused_score_maps as jfused
    fields = _scoring_inputs()
    angle = np.float32(0.7)
    frame_h = None if row0 == 0 else 120
    extra = {} if row0 == 0 else dict(max_sdf=np.float32(30.0),
                                      max_close=np.float32(25.0),
                                      max_wide=np.float32(12.0))
    want = jfused(*fields, CX, CY, F, angle, angle_valid,
                  cfg=JScoringConfig(), interpret=True,
                  row0=None if row0 == 0 else row0, frame_height=frame_h,
                  **extra)
    got = fused_score_maps_plain(
        *map(_t, fields), _t(CX), _t(CY), _t(F), _t(angle),
        _t(angle_valid), cfg=GraspScoringConfig(), row0=row0,
        frame_height=frame_h, **{k: _t(v) for k, v in extra.items()})
    assert len(got) == len(want) == 9
    for i, (a, b) in enumerate(zip(want[:8], got[:8])):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0,
                                   atol=1e-5, err_msg=str(i))
    np.testing.assert_array_equal(np.asarray(want[8]), got[8].numpy())
    # the wrapper on CPU tensors is the plain version, with no launch
    kernels.reset_launch_counts()
    again = fused_score_maps(
        *map(_t, fields), _t(CX), _t(CY), _t(F), _t(angle),
        _t(angle_valid), cfg=GraspScoringConfig(), row0=row0,
        frame_height=frame_h, **{k: _t(v) for k, v in extra.items()})
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    assert kernels.launch_counts()["fused_score_maps"] == 0


# ---- attention gate ---------------------------------------------------------

def _gate_params(rng, c, r):
    def n(*shape, s=0.1):
        return (rng.normal(size=shape) * s).astype(np.float32)
    return n(c, 1), n(1), n(c, r), n(r), n(r, c), n(c)


@pytest.mark.parametrize("mode", MODES)
def test_attention_plain_matches_jax(mode):
    from leafgrasp_tpu.models.attention_pallas import (
        attention_gate_reference, fused_attention_gate as jfused)
    rng = np.random.default_rng(0)
    n, h, w, c, r = 4, 4, 4, 64, 4
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    params = _gate_params(rng, c, r)
    ref = np.asarray(attention_gate_reference(x, *params, mode))
    pallas = np.asarray(jfused(x, *params, mode, interpret=True))
    xs = _t(x.reshape(n, h * w, c))
    tp = [_t(p) for p in params]
    got = attention_gate_plain(xs, *tp, mode).numpy().reshape(n, h, w, c)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5)
    kernels.reset_launch_counts()
    assert torch.equal(fused_attention_gate(xs, *tp, mode),
                       attention_gate_plain(xs, *tp, mode))
    assert kernels.launch_counts()["fused_attention_gate"] == 0


@pytest.mark.parametrize("mode", MODES)
def test_attention_gate_module_passes_the_nchw_view_uncopied(mode,
                                                             monkeypatch):
    """``AttentionGate`` hands the gate the (N, HW, C) view of its NCHW
    activations as it lies (the kernel reads it through its strides), and
    the same values come out as from the copied, contiguous input."""
    from leafgrasp_tpu_torch.models import grasp_cnn
    rng = np.random.default_rng(12)
    n, c, h, w = 3, 32, 4, 4
    gate = grasp_cnn.AttentionGate(mode, c, reduction=16)
    with torch.no_grad():
        for p in list(gate.parameters()) + list(gate.buffers()):
            p.copy_(_t((rng.normal(size=p.shape) * 0.3).astype(np.float32)))
    x = _t(rng.normal(size=(n, c, h, w)).astype(np.float32))
    seen = []

    def spy(xs, *args):
        seen.append(xs)
        return fused_attention_gate(xs, *args)

    monkeypatch.setattr(grasp_cnn, "fused_attention_gate", spy)
    got = gate(x)
    assert got.shape == x.shape
    if mode == "none":
        assert got is x and not seen
        return
    (xs,) = seen
    assert xs.shape == (n, h * w, c) and not xs.is_contiguous()
    assert xs.transpose(1, 2).is_contiguous() and xs.data_ptr() == x.data_ptr()
    params = [getattr(gate, k) for k in (
        "spatial_kernel", "spatial_bias", "squeeze_kernel", "squeeze_bias",
        "excite_kernel", "excite_bias")]
    want = attention_gate_plain(xs.contiguous(), *params, mode)
    torch.testing.assert_close(
        got, want.reshape(n, h, w, c).permute(0, 3, 1, 2), rtol=0,
        atol=1e-6)


def test_attention_rejects_unknown_mode():
    x = torch.zeros((1, 4, 8))
    params = [torch.zeros(s) for s in ((8, 1), (1,), (8, 2), (2,), (2, 8),
                                       (8,))]
    with pytest.raises(ValueError):
        fused_attention_gate(x, *params, "both")


# ---- build ------------------------------------------------------------------

def test_build_flags_and_sources():
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    names = sorted(p.name for p in build._sources())
    assert names == ["attention.cu", "decode_attention.cu",
                     "flash_prefill.cu", "flash_prefill_bwd.cu",
                     "histogram.cu", "minplus.cu", "rowband.cu",
                     "scoring.cu"]
    # the one header (inline PTX for mbarriers, TMA, wgmma) is hashed too
    assert [p.name for p in build.CSRC_DIR.glob("*.cuh")] == ["hopper.cuh"]
    flash = (build.CSRC_DIR / "flash_prefill.cu").read_text()
    assert '#include "hopper.cuh"' in flash and "mma.sync" not in flash
    assert "wgmma.mma_async" in (build.CSRC_DIR / "hopper.cuh").read_text()
    # the bit-exact kernels keep separate multiply and add; the flash
    # prefill, its backward and the decode attention alone may fuse them
    for p in build._sources():
        assert ("-fmad=false" in build._file_flags(p)) == \
            (p.name not in ("flash_prefill.cu", "flash_prefill_bwd.cu",
                            "decode_attention.cu"))
    for p in build._sources():
        text = p.read_text()
        assert "extern \"C\" int " in text and "Replaces" in text
    # moe_experts is a Triton kernel: it has no C export
    assert set(build._SIGNATURES) | {"moe_experts"} == set(kernels.LAUNCHES)
    assert len(build._digest(build._sources())) == 16


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build._nvcc()



# ---- flash prefill ------------------------------------------------------------

def _flash_case(seed, b, t, heads, kvh, hd, pads, extra=6):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, heads, hd)).astype(np.float32)
    k = rng.standard_normal((b, t + extra, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, t + extra, kvh, hd)).astype(np.float32)
    return q, k, v, np.asarray(pads, np.int32)


@pytest.mark.parametrize("shape,pads", [
    ((2, 130, 4, 2, 16), (0, 37)),
    ((3, 160, 4, 4, 8), (128, 1, 159)),
    ((1, 128, 6, 2, 16), (5,)),
    ((2, 40, 4, 4, 16), (0, 17)),      # one query head a K/V head, t < a tile
    ((1, 1, 2, 2, 8), (0,)),
])
def test_flash_prefill_plain_matches_jax_dense_route(shape, pads):
    """The kernel's plain version against the JAX package's dense route:
    ``_MistralAttention``'s ``attend`` under the mask that
    ``_generate_prefill`` builds (causal AND key >= left pad), t from 1
    to beyond a tile, one to three query heads a K/V head, unequal pads,
    f32, real rows to 1e-5. The JAX package's own flash
    route is a Pallas TPU kernel that needs the TPU backend and is never
    run on the CPU by its tests; the dense route is what it states that
    kernel to equal on real rows, so it is the reference here. The JAX
    module is applied with identity q and o projections and positions 0
    (no rotation), so its output is ``attend`` itself."""
    from leafgrasp_tpu.vla import llava_jax as jl
    from leafgrasp_tpu_torch.kernels.flash_prefill import (
        flash_prefill, flash_prefill_plain)
    b, t, heads, kvh, hd = shape
    hidden = heads * hd
    rng = np.random.default_rng(31)
    x = rng.standard_normal((b, t, hidden)).astype(np.float32)
    wk = (rng.standard_normal((hidden, kvh * hd)) / np.sqrt(hidden)) \
        .astype(np.float32)
    wv = (rng.standard_normal((hidden, kvh * hd)) / np.sqrt(hidden)) \
        .astype(np.float32)
    pad = np.asarray(pads, np.int32)
    cfg = jl.LlavaJaxConfig(hidden=hidden, heads=heads, kv_heads=kvh,
                            prefill_attn_chunk=None)
    eye = np.eye(hidden, dtype=np.float32)
    params = {"q_proj": {"kernel": eye}, "o_proj": {"kernel": eye},
              "k_proj": {"kernel": wk}, "v_proj": {"kernel": wv}}
    mask = np.tril(np.ones((t, t), bool))[None, None] \
        & (np.arange(t)[None, None, None, :] >= pad[:, None, None, None])
    want, _ = jl._MistralAttention(cfg).apply(
        {"params": params}, jnp.asarray(x),
        jnp.zeros((b, t), jnp.int32), jnp.asarray(mask))
    want = np.asarray(want).reshape(b, t, heads, hd)
    q = _t(x.reshape(b, t, heads, hd))
    k = _t((x @ wk).reshape(b, t, kvh, hd))
    v = _t((x @ wv).reshape(b, t, kvh, hd))
    got = flash_prefill_plain(q, k, v, _t(pad))
    for i, p in enumerate(pads):
        np.testing.assert_allclose(got[i, p:].numpy(), want[i, p:], rtol=0,
                                   atol=1e-5)
        assert not got[i, :p].any()               # pad rows are zeros
    kernels.reset_launch_counts()
    assert torch.equal(flash_prefill(q, k, v, _t(pad)), got)
    assert kernels.launch_counts()["flash_prefill"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_prefill_plain_chunks_strides_and_pad_rows(dtype):
    """Query chunks give the same rows; K/V are read through the strides
    of a longer cache and only its first t rows; pad rows are exactly
    zero and everything is finite, whatever the cache holds there."""
    from leafgrasp_tpu_torch.kernels.flash_prefill import flash_prefill_plain
    q, k, v, pad = _flash_case(32, 2, 50, 4, 2, 8, (0, 20))
    k[:, 50:] = np.nan                            # beyond t: never read
    q, k, v = (_t(a).to(dtype) for a in (q, k, v))
    whole = flash_prefill_plain(q, k, v, _t(pad))
    assert whole.dtype == dtype and torch.isfinite(whole.float()).all()
    assert not whole[1, :20].any()
    for chunk in (1, 7, 50, 64):
        torch.testing.assert_close(
            flash_prefill_plain(q, k, v, _t(pad), chunk=chunk), whole,
            rtol=0, atol=1e-6 if dtype == torch.float32 else 2e-2)
    cache_k = torch.zeros((2, 60, 3, 8), dtype=dtype)
    cache_v = torch.zeros((2, 60, 3, 8), dtype=dtype)
    cache_k[:, :56, 1:], cache_v[:, :56, 1:] = k, v
    torch.testing.assert_close(
        flash_prefill_plain(q, cache_k[:, :, 1:], cache_v[:, :, 1:],
                            _t(pad)), whole, rtol=0, atol=0)
    # the first real row attends itself alone: its output is its v row
    torch.testing.assert_close(whole[1, 20, :2].float(),
                               v[1, 20, 0].float().expand(2, 8),
                               rtol=0, atol=1e-6)


def test_flash_prefill_checks_its_arguments():
    from leafgrasp_tpu_torch.kernels.flash_prefill import flash_prefill
    q, k, v, pad = (_t(a) for a in _flash_case(33, 2, 10, 4, 2, 8, (0, 1)))
    with pytest.raises(ValueError, match="int32"):
        flash_prefill(q, k, v, pad.long())
    with pytest.raises(ValueError, match="heads"):
        flash_prefill(q[:, :, :3], k, v, pad)
    with pytest.raises(ValueError, match="fit"):
        flash_prefill(q, k[:, :5], v[:, :5], pad)
    with pytest.raises(ValueError, match="type"):
        flash_prefill(q, k.bfloat16(), v, pad)
    # a CPU tensor takes the plain version at any head size and type
    assert flash_prefill(q.half(), k.half(), v.half(), pad).dtype \
        == torch.float16


# ---- decode attention ------------------------------------------------------------

def _decode_case(seed, b, cap, heads, kvh, hd):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, 1, heads, hd), generator=g)
    k = torch.randn((b, cap, kvh, hd), generator=g)
    v = torch.randn((b, cap, kvh, hd), generator=g)
    return q, k, v


@pytest.mark.parametrize("window", [None, 1, 7])
@pytest.mark.parametrize("shape,pads,pos", [
    ((2, 30, 4, 2, 16), (0, 11), 25),
    ((3, 40, 6, 2, 8), (0, 39, 5), 39),   # a row whose one live key is pos
    ((1, 12, 2, 2, 16), (0,), 0),
])
def test_decode_attention_plain_reads_the_live_keys_alone(shape, pads, pos,
                                                          window):
    """The plain version against a float64 loop over the live keys
    ``max(pad, pos - window + 1) <= j <= pos`` of each row (1e-6; f32
    sums in another order), whatever the other slots hold."""
    from leafgrasp_tpu_torch.kernels.decode_attention import (
        decode_attention, decode_attention_plain)
    b, cap, heads, kvh, hd = shape
    q, k, v = _decode_case(41, b, cap, heads, kvh, hd)
    pad = torch.tensor(pads, dtype=torch.int32)
    cursor = torch.tensor([pos], dtype=torch.int64)
    got = decode_attention_plain(q, k, v, pad, cursor, torch.float32, window)
    assert got.shape == q.shape and got.dtype == torch.float32
    assert torch.equal(decode_attention(q, k, v, pad, cursor, torch.float32,
                                        window), got)
    want = np.zeros(q.shape)
    qd, kd, vd = (x.double().numpy() for x in (q, k, v))
    rep = heads // kvh
    for r in range(b):
        lo = pads[r] if window is None else max(pads[r], pos - window + 1)
        for h in range(heads):
            s = kd[r, lo:pos + 1, h // rep] @ qd[r, 0, h] / np.sqrt(hd)
            p = np.exp(s - s.max())
            want[r, 0, h] = (p / p.sum()) @ vd[r, lo:pos + 1, h // rep]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_decode_attention_checks_its_arguments():
    """Shapes, pad and cursor types raise everywhere; a CPU tensor takes
    the plain version at any head size and type; on any other device
    the wrapper raises for a head size or type its kernel lacks (here
    meta tensors, which reach the kernel's checks and no further)."""
    from leafgrasp_tpu_torch.kernels.decode_attention import decode_attention
    q, k, v = _decode_case(43, 2, 20, 4, 2, 16)
    pad = torch.zeros((2,), dtype=torch.int32)
    cur = torch.tensor([9])
    f32 = torch.float32
    with pytest.raises(ValueError, match="int32"):
        decode_attention(q, k, v, pad.long(), cur, f32)
    with pytest.raises(ValueError, match="int64"):
        decode_attention(q, k, v, pad, cur.int(), f32)
    with pytest.raises(ValueError, match="heads"):
        decode_attention(q[:, :, :3], k, v, pad, cur, f32)
    with pytest.raises(ValueError, match="want"):
        decode_attention(q.expand(2, 2, 4, 16), k, v, pad, cur, f32)
    with pytest.raises(ValueError, match="window"):
        decode_attention(q, k, v, pad, cur, f32, 0)
    half = decode_attention(q.half(), k.half(), v.half(), pad, cur,
                            torch.float16)
    assert half.dtype == torch.float16 and half.shape == q.shape

    def meta(hd, dtype=torch.bfloat16, dt=torch.bfloat16):
        z = dict(device="meta", dtype=dtype)
        return (torch.empty((5, 1, 32, hd), **z),
                torch.empty((5, 64, 8, hd), **z),
                torch.empty((5, 64, 8, hd), **z),
                torch.empty((5,), dtype=torch.int32, device="meta"),
                torch.empty((1,), dtype=torch.int64, device="meta"), dt)

    for bad in (meta(96), meta(16, torch.float32, torch.float32),
                meta(128, torch.float16), meta(64, dt=torch.float16)):
        with pytest.raises(ValueError, match="the kernel takes"):
            decode_attention(*bad)
    for good in (meta(128), meta(64, torch.float32, torch.float32)):
        with pytest.raises(ValueError, match="unsupported device"):
            decode_attention(*good)
