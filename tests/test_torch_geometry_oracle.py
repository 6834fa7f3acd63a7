"""The port's grasp scorer, grasp pixel, pre-grasp and frame against the
loop-based oracle (``tests/reference_impl.py``), as
``tests/test_geometry.py`` holds the JAX package, on the CPU at its
golden-scene sizes (270 x 360; the fuzz at its three shapes).

Tolerances are the JAX tests': score maps 2e-3 relative and absolute
(the oracle's exact EDT against the port's f32 arithmetic), the valid
region, candidates and grasp pixels equal, the pre-grasp point 1e-5
relative.
"""

import numpy as np
import pytest
import torch

from tests import reference_impl as ref
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from leafgrasp_tpu_torch import config as tcfg
from leafgrasp_tpu_torch.geometry.grasp_scorer import compute_grasp_scores
from leafgrasp_tpu_torch.geometry.lift3d import lift_to_3d, pre_grasp_point
from leafgrasp_tpu_torch.io.scenes import make_leaf_scene
from leafgrasp_tpu_torch.ops.topk import topk_min_distance
from leafgrasp_tpu_torch.pipeline.frame import make_frame_fn

CX, CY, F = 180.0, 135.0, 800.0
AREA = 1500          # the reference's 10000 px area gate, scaled down


def _t(a):
    return torch.from_numpy(np.array(a))


def _scene(seed, n=4):
    return make_leaf_scene(height=270, width=360, num_leaves=n, seed=seed,
                           margin=40)


def _cam():
    return _t(np.float32(CX)), _t(np.float32(CY)), _t(np.float32(F))


def _selected(mask, depth):
    sel_id, _ = ref.select_leaf_reference(mask, depth, CX, CY, F,
                                          min_area=AREA, mode="exact")
    return sel_id, mask == sel_id, mask > 0


def _ref_candidates(score_map, valid, top_k, min_distance):
    """The reference's greedy spaced top-k (tests/test_geometry.py)."""
    valid_scores = score_map * valid
    flat = np.argsort(valid_scores.ravel(), kind="stable")[::-1]
    out, used = [], np.zeros_like(valid, bool)
    for idx in flat:
        if len(out) >= top_k:
            break
        y, x = np.unravel_index(idx, score_map.shape)
        sl = (slice(max(0, y - min_distance), y + min_distance + 1),
              slice(max(0, x - min_distance), x + min_distance + 1))
        if not used[sl].any():
            out.append((int(x), int(y)))
            used[sl] = True
    return out


@pytest.mark.parametrize("seed", [0, 3])
def test_grasp_scores_match_oracle(seed):
    mask, depth = _scene(seed)
    _, leaf, allm = _selected(mask, depth)
    ours = compute_grasp_scores(_t(leaf), _t(allm), _t(depth), *_cam())
    oracle = ref.grasp_scores_reference(leaf, allm, depth, CX, CY, F,
                                        mode="exact")
    for name in ("sdf_score", "approach_score", "flatness_map",
                 "isolation_map", "distance_map", "accessibility_map",
                 "stem_penalty", "traditional_score"):
        np.testing.assert_allclose(
            getattr(ours, name).numpy(), oracle[name], rtol=2e-3,
            atol=2e-3, err_msg=f"score map mismatch: {name}")
    np.testing.assert_array_equal(ours.valid_region.numpy(),
                                  oracle["valid_region"])


def test_grasp_pixel_matches_exact_oracle_bitwise():
    """The port's spaced top-k against the oracle's on the port's maps
    (every candidate with a positive score), and the first candidate
    against the oracle's own exact-EDT maps."""
    mask, depth = _scene(3)
    _, leaf, allm = _selected(mask, depth)
    ours = compute_grasp_scores(_t(leaf), _t(allm), _t(depth), *_cam())
    score = ours.traditional_score.numpy()
    valid = ours.valid_region.numpy()
    cand = topk_min_distance(ours.traditional_score, ours.valid_region,
                             k=20, min_distance=10)
    got = list(zip(cand.x.tolist(), cand.y.tolist()))
    ref_cand = _ref_candidates(score, valid, 20, 10)
    n_pos = sum(1 for (x, y) in ref_cand if score[y, x] > 0)
    assert n_pos > 0 and got[:n_pos] == ref_cand[:n_pos]
    oracle = ref.grasp_scores_reference(leaf, allm, depth, CX, CY, F,
                                        mode="exact")
    assert got[0] == _ref_candidates(oracle["traditional_score"],
                                     oracle["valid_region"], 20, 10)[0]


def _ref_pre_grasp(g, leaf_u8, cx, cy, f):
    """The reference's pre-grasp march (grasp_point_selector.py:754-819)."""
    import cv2
    d = g / np.linalg.norm(g)
    k = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (31, 31))
    dil = cv2.dilate(leaf_u8, k)
    h, w = leaf_u8.shape
    for dist in np.arange(0.05, 0.10, 0.01):
        t = (g[0] - d[0] * dist, g[1] - d[1] * dist, g[2])
        u = int(t[0] * f / t[2] + cx)
        v = int(t[1] * f / t[2] + cy)
        if not (0 <= u < w and 0 <= v < h):
            continue
        if dil[v, u] == 0 and np.linalg.norm(np.array(t) - g) >= 0.05:
            return np.array(t)
    return np.array([g[0] - d[0] * 0.10, g[1] - d[1] * 0.10, g[2]])


@pytest.mark.parametrize("pick", ["middle", "first", "last"])
def test_pre_grasp_matches_reference_loop(pick):
    mask, depth = _scene(3)
    _, leaf, _ = _selected(mask, depth)
    ys, xs = np.where(leaf)
    gi = {"middle": len(xs) // 2, "first": 0, "last": len(xs) - 1}[pick]
    u, v = int(xs[gi]), int(ys[gi])
    g3 = lift_to_3d(_t(np.float32(u)), _t(np.float32(v)),
                    _t(depth[v, u]), *_cam())
    out = pre_grasp_point(g3, _t(leaf), *_cam())
    expected = _ref_pre_grasp(g3.numpy().astype(np.float64),
                              leaf.astype(np.uint8), CX, CY, F)
    np.testing.assert_allclose(out.point.numpy(), expected, rtol=1e-5)


@pytest.mark.parametrize("seed,n,h,w", [
    (31, 5, 192, 256), (33, 7, 320, 280), (35, 2, 256, 384),
])
def test_fuzz_pipeline_vs_oracle(seed, n, h, w):
    """Shapes and leaf counts of the JAX fuzz: the port's frame (CPU,
    exact EDT) picks the oracle's leaf and its first candidate pixel."""
    area = max(300, h * w // 60)
    cfg = tcfg.PipelineConfig(frame=tcfg.FrameConfig(height=h, width=w,
                                                     max_leaves=8),
                              leaf=tcfg.LeafSelectionConfig(
                                  min_leaf_area=area))
    mask, depth = make_leaf_scene(height=h, width=w, num_leaves=n,
                                  seed=seed, margin=30)
    res = make_frame_fn(cfg, with_cnn=False, device="cpu")(
        mask, depth, np.float32(CX), np.float32(CY), np.float32(F))
    expected, _ = ref.select_leaf_reference(mask, depth, CX, CY, F,
                                            min_area=area, mode="exact")
    if expected is None:
        assert not bool(res.found)
        return
    assert int(res.leaf_id) == expected
    assert not bool(res.degenerate)
    leaf = mask == expected
    oracle = ref.grasp_scores_reference(leaf, mask > 0, depth, CX, CY, F,
                                        mode="exact")
    cands = _ref_candidates(oracle["traditional_score"],
                            oracle["valid_region"], 20, 10)
    assert (int(res.grasp_uv[0]), int(res.grasp_uv[1])) == cands[0]
