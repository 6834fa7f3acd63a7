"""Judging the service's published frames against the plain reference
route (``grasp_ref``, run on the same mask, depth, camera and CNN
weights).

A published frame is judged by what the reference makes of it, so that
a tie the reference itself cannot break is no fault:

* ``flags``: found and degenerate must be the reference's (exact);
* ``leaf_gap``: the reference's weighted leaf score of its own leaf less
  that of the published leaf (0 when they agree; 1 when the published
  leaf is no candidate of the reference);
* ``pixel_gap``, where the leaf agrees: the reference's fused value of
  its own pick less that of the published pixel among its candidates
  (0 when they agree; 1 when the pixel is none of its candidates);
* ``xyz_err_m``, where leaf and pixel agree: the largest difference of
  the 3D grasp and pre-grasp points, in metres.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import numpy as np
import torch

from benchmark.reference.grasp_ref.pipeline.frame import select_grasp
from benchmark.reference.grasp_ref.utils.device import fetch_to_host

MISS = 1.0      # the gap of a choice the reference does not offer


def published(out: dict) -> Dict[str, np.ndarray]:
    """The judged part of a service result (its ``FrameResult`` holds
    numpy leaves)."""
    r = out["result"]
    return {"found": bool(r.found), "degenerate": bool(r.degenerate),
            "leaf_id": int(r.leaf_id),
            "grasp_uv": np.asarray(r.grasp_uv).astype(np.int64),
            "grasp_xyz": np.asarray(r.grasp_xyz, np.float64),
            "pre_grasp_xyz": np.asarray(r.pre_grasp_xyz, np.float64)}


def reference_frame(mask, depth, camera, cnn, cfg, dev, hist_median=False):
    """The reference route's ``FrameResult`` with numpy leaves."""
    res = select_grasp(mask, depth, np.float32(camera.cx),
                       np.float32(camera.cy), np.float32(camera.fx),
                       cnn=cnn, cfg=cfg, device=dev,
                       hist_median=hist_median)
    return fetch_to_host(res)


def _value(ref, j: int) -> float:
    """The reference's fused value of picking candidate ``j``."""
    fus, cand = ref.fusion, ref.candidates
    acc = np.asarray(cand.accepted)
    do_ml = bool(acc.sum() > 1)
    val = -np.inf
    if do_ml and acc[j]:
        val = float(np.asarray(fus.combined)[j])
    if j == 0:
        val = max(val, float(np.asarray(cand.score)[0]))
    return val


def judge(ref, pub: Dict) -> Dict[str, float]:
    """The four readings of one published frame against ``ref``."""
    out = {"flags": 0.0, "leaf_gap": 0.0, "pixel_gap": None,
           "xyz_err_m": None}
    if bool(ref.found) != pub["found"] or \
            bool(ref.degenerate) != pub["degenerate"]:
        out["flags"] = 1.0
        return out
    if not pub["found"]:
        return out
    sel = ref.leaf_selection
    ref_leaf = int(ref.leaf_id)
    if pub["leaf_id"] != ref_leaf:
        w = np.asarray(sel.weighted, np.float64)
        cand = np.asarray(sel.candidate)
        k = pub["leaf_id"] - 1
        if 0 <= k < len(w) and cand[k]:
            out["leaf_gap"] = float(w[ref_leaf - 1] - w[k])
        else:
            out["leaf_gap"] = MISS
        return out
    xs = np.asarray(ref.candidates.x)
    ys = np.asarray(ref.candidates.y)
    u, v = int(pub["grasp_uv"][0]), int(pub["grasp_uv"][1])
    hit = np.nonzero((xs == u) & (ys == v))[0]
    if len(hit) == 0:
        out["pixel_gap"] = MISS
        return out
    out["pixel_gap"] = float(ref.fusion.best_score) - _value(ref, int(hit[0]))
    if (u, v) == tuple(int(t) for t in np.asarray(ref.grasp_uv)):
        out["xyz_err_m"] = float(max(
            np.abs(pub["grasp_xyz"] - np.asarray(ref.grasp_xyz)).max(),
            np.abs(pub["pre_grasp_xyz"]
                   - np.asarray(ref.pre_grasp_xyz)).max()))
    return out


def worst(readings: Iterable[Dict]) -> Dict[str, float]:
    """The worst of each reading over frames (absent ones read 0), and
    how many frames agreed on leaf and pixel."""
    rs: List[Dict] = list(readings)
    agg = {"flags": 0.0, "leaf_gap": 0.0, "pixel_gap": 0.0,
           "xyz_err_m": 0.0}
    for r in rs:
        for k in agg:
            if r.get(k) is not None:
                agg[k] = max(agg[k], float(r[k]))
    agg["frames"] = float(len(rs))
    agg["same_pixel"] = float(sum(r.get("xyz_err_m") is not None
                                  for r in rs))
    return agg


class Bf16Cnn(torch.nn.Module):
    """The control's CNN: the reference CNN's weights and inputs in
    bfloat16, its logits back in float32."""

    def __init__(self, cnn):
        super().__init__()
        self.inner = cnn.to(torch.bfloat16)
        self.training = False

    def forward(self, x):
        return self.inner(x.to(torch.bfloat16)).to(torch.float32)
