"""The plain re-pick of the VLA node: from the reference frame's leaf
scores and a rerank's served tokens, the leaf that the hybrid selector
has to choose.

Written from the reference's VLA node as the port documents it
(``leaf_grasp_node_vla.py`` with ``hybrid_selector.py``,
``llava_processor.py`` and ``confidence_manager.py``):

* candidates: one per area-valid leaf, by weighted geometric score, the
  best ``k`` kept;
* each candidate's prompt (the chat prompt with its position and
  scores), one row of the scorer;
* each row's served tokens read as text by the tokenizer's decode, then
  parsed as a decimal clipped to [0, 1] (0.5 if it is none), the scores
  min-max normalized across candidates (all 0.5 when they do not vary);
* confidence 0.4 * consistency (the rescaled correlation of the
  normalized VLA and geometric scores) + 0.3 * (1 - variance / mean) +
  0.3 * magnitude (max * (1 + range / 2)), clipped to [0, 1];
* the weight ladder on that confidence (> 0.8: VLA 0.6, > 0.5: 0.3,
  > 0.2: 0.1, else 0), and the leaf of the largest blend of the two
  min-max-normalized score lists.

The confidence's rolling history does not enter a choice. Numpy only.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

INSTRUCTION = "Select the best leaf for grasping"
LADDER = ((0.8, 0.6), (0.5, 0.3), (0.2, 0.1))


def hash_decimal(ids) -> str:
    """The benchmark tokenizer's decode (after tools/_torch_bench.py
    ``_hash_decimal`` at 8d152a04df5e): an injective token path as a
    decimal, so parsed scores vary."""
    key = 0
    for i in ids:
        key = (key * 1000003 + int(i) + 1) % (10 ** 9)
    return f"0.{key:09d}"


def candidates(selection, k: int) -> List[Dict]:
    """The reference frame's ``leaf_selection`` as the node's candidate
    dicts, best ``k`` by weighted score (a stable sort: ties keep leaf
    order)."""
    scores = np.asarray(selection.scores)
    weighted = np.asarray(selection.weighted)
    cx = np.asarray(selection.stats.centroid_x)
    cy = np.asarray(selection.stats.centroid_y)
    out = [dict(leaf_id=int(s) + 1, x=float(cx[s]), y=float(cy[s]),
                clutter_score=float(scores[s, 0]),
                distance_score=float(scores[s, 1]),
                geometric_score=float(weighted[s]))
           for s in np.where(np.asarray(selection.candidate))[0]]
    out.sort(key=lambda c: -c["geometric_score"])
    return out[:k]


def prompt(c: Dict, instruction: str = INSTRUCTION) -> str:
    """The node's evaluation prompt for one candidate."""
    return (
        "<|im_start|>system\n"
        "You are an expert robotic vision system evaluating leaf grasp "
        "candidates.\n<|im_end|>\n"
        "<|im_start|>user\n<image>\n"
        f"Task: {instruction}\n\n"
        "Candidate details:\n"
        f"- Position: ({c['x']}, {c['y']})\n"
        f"- Geometric score: {c['geometric_score']:.3f}\n"
        f"- Clutter score: {c['clutter_score']:.3f}\n"
        f"- Distance score: {c['distance_score']:.3f}\n\n"
        "Rate this candidate from 0.0 to 1.0 for grasping suitability. "
        "Consider:\n"
        "1. Leaf isolation and accessibility\n"
        "2. Surface quality for stable grasping\n"
        "3. Positioning relative to other leaves\n\n"
        "Respond with only a decimal number between 0.0 and 1.0.\n"
        "<|im_end|>\n<|im_start|>assistant\n")


def parse(text: str) -> float:
    try:
        return float(np.clip(float(text.strip()), 0.0, 1.0))
    except (TypeError, ValueError):
        return 0.5


def _minmax(a: np.ndarray, eps: float) -> np.ndarray:
    return (a - a.min()) / (a.max() - a.min() + eps)


def vla_scores(raw: Sequence[float]) -> np.ndarray:
    s = np.asarray(raw, np.float64)
    if np.std(s) < 1e-6:
        return np.full_like(s, 0.5)
    return (s - s.min()) / (s.max() - s.min())


def confidence(vla: np.ndarray, geo: np.ndarray) -> float:
    if vla.size < 2:
        consistency = 0.5
    else:
        with np.errstate(invalid="ignore", divide="ignore"):
            corr = np.corrcoef(_minmax(vla, 1e-6), _minmax(geo, 1e-6))[0, 1]
        consistency = 0.5 if np.isnan(corr) else (corr + 1.0) / 2.0
    variance = 1.0 if vla.size < 2 else float(np.clip(
        np.var(vla) / (np.mean(vla) + 1e-6), 0.0, 1.0))
    magnitude = float(np.clip(
        vla.max() * (1.0 + (vla.max() - vla.min()) / 2.0), 0.0, 1.0))
    return float(np.clip(0.4 * consistency + 0.3 * (1.0 - variance)
                         + 0.3 * magnitude, 0.0, 1.0))


def _unit(a: np.ndarray) -> np.ndarray:
    lo, hi = a.min(), a.max()
    if hi - lo < 1e-6:
        return np.full_like(a, 0.5)
    return (a - lo) / (hi - lo)


def choose(cands: List[Dict], served_tokens, decode=hash_decimal) -> int:
    """The leaf id that the node picks from ``cands`` given each row's
    served tokens."""
    vla = vla_scores([parse(decode(t)) for t in served_tokens])
    geo = np.asarray([c["geometric_score"] for c in cands], np.float64)
    conf = confidence(vla, geo)
    w = 0.0
    for threshold, weight in LADDER:
        if conf > threshold:
            w = weight
            break
    blend = (1.0 - w) * _unit(geo) + w * _unit(vla)
    return int(cands[int(np.argmax(blend))]["leaf_id"])
