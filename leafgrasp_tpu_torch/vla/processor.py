"""VLA candidate evaluation: prompt building, scoring backends, parsing.
The port's own copy of leafgrasp_tpu/vla/processor.py.

Rebuild of vla_system/llava_processor.py with a pluggable backend
contract (SURVEY.md section 7 step 9):

* ``StubScorer``        -- model unavailable => every score 0.5
                           (llava_processor.py:35-36,39-40);
* ``HeuristicScorer``   -- deterministic geometric blend, for hermetic
                           tests and CPU-only deployments;
* ``TinyVLAScorer``     -- the torch TinyVLA runtime: builds the same chat
                           prompt, greedy-decodes <=10 tokens, parses a
                           decimal in [0,1], defaults 0.5 on parse
                           failure (llava_processor.py:78-101).

Scores are min-max normalized across candidates, and
``get_confidence = max * (1 + range)`` clipped
(llava_processor.py:103-123).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

__all__ = ["build_prompt", "parse_score", "normalize_scores",
           "get_confidence", "StubScorer", "HeuristicScorer",
           "TinyVLAScorer", "VLAProcessor"]


def build_prompt(candidate: Dict, instruction: str) -> str:
    """Chat-format evaluation prompt (llava_processor.py:53-76)."""
    return (
        "<|im_start|>system\n"
        "You are an expert robotic vision system evaluating leaf grasp "
        "candidates.\n<|im_end|>\n"
        "<|im_start|>user\n<image>\n"
        f"Task: {instruction}\n\n"
        "Candidate details:\n"
        f"- Position: ({candidate.get('x', 0)}, {candidate.get('y', 0)})\n"
        f"- Geometric score: {candidate.get('geometric_score', 0.5):.3f}\n"
        f"- Clutter score: {candidate.get('clutter_score', 0.5):.3f}\n"
        f"- Distance score: {candidate.get('distance_score', 0.5):.3f}\n\n"
        "Rate this candidate from 0.0 to 1.0 for grasping suitability. "
        "Consider:\n"
        "1. Leaf isolation and accessibility\n"
        "2. Surface quality for stable grasping\n"
        "3. Positioning relative to other leaves\n\n"
        "Respond with only a decimal number between 0.0 and 1.0.\n"
        "<|im_end|>\n<|im_start|>assistant\n"
    )


def parse_score(response: str, default: float = 0.5) -> float:
    """Parse a float from generated text; clip to [0,1]; default on
    failure (llava_processor.py:94-101)."""
    try:
        return float(np.clip(float(response.strip()), 0.0, 1.0))
    except (TypeError, ValueError):
        return default


def normalize_scores(scores: List[float]) -> List[float]:
    if not scores:
        return []
    s = np.asarray(scores, np.float64)
    if np.std(s) < 1e-6:
        return [0.5] * len(s)
    return ((s - s.min()) / (s.max() - s.min())).tolist()


def get_confidence(scores: List[float]) -> float:
    if not scores:
        return 0.0
    s = np.asarray(scores, np.float64)
    return float(np.clip(s.max() * (1.0 + (s.max() - s.min())), 0.0, 1.0))


class StubScorer:
    """Degraded mode: uniform 0.5 for every candidate."""

    def score(self, image, candidates, instruction) -> List[float]:
        return [0.5] * len(candidates)


class HeuristicScorer:
    """Deterministic, geometry-grounded scores for hermetic testing
    (mirrors the reference's mock mode, test_vla_full.py:204-209, but
    reproducible instead of random)."""

    def score(self, image, candidates, instruction) -> List[float]:
        out = []
        for c in candidates:
            s = (0.5 * float(c.get("geometric_score", 0.5))
                 + 0.3 * float(c.get("clutter_score", 0.5))
                 + 0.2 * float(c.get("distance_score", 0.5)))
            out.append(float(np.clip(s, 0.0, 1.0)))
        return out


class TinyVLAScorer:
    """LM-backed scorer: prompt -> greedy decode -> parse decimal.

    ``device=None`` means CUDA. Without a model, one is drawn from
    ``seed``."""

    def __init__(self, model=None, cfg=None, seed: int = 0, device=None):
        from leafgrasp_tpu_torch.vla.lm import (VLAModelConfig,
                                                ByteTokenizer, init_vla)
        self.tokenizer = ByteTokenizer()
        if model is None:
            model = init_vla(seed, cfg or VLAModelConfig(), device=device)
        self.model = model
        self.device = next(model.parameters()).device

    def _prep_image(self, image):
        patch = self.model.cfg.vision_patch
        if image is None:
            return np.zeros((1, patch, patch, 3), np.float32)
        img = np.asarray(image, np.float32)
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        if img.max() > 1.5:
            img = img / 255.0
        # nearest-neighbor resize to (patch, patch)
        h, w = img.shape[:2]
        ys = (np.arange(patch) * h // patch).clip(0, h - 1)
        xs = (np.arange(patch) * w // patch).clip(0, w - 1)
        return img[ys][:, xs][None]

    def score(self, image, candidates, instruction) -> List[float]:
        import torch
        from leafgrasp_tpu_torch.utils.device import host_read
        from leafgrasp_tpu_torch.vla.lm import greedy_generate
        img = torch.as_tensor(self._prep_image(image)).to(self.device)
        out = []
        for cand in candidates:
            prompt = build_prompt(cand, instruction)
            toks = torch.as_tensor(self.tokenizer.encode(prompt)
                                   .astype(np.int64))[None].to(self.device)
            gen = greedy_generate(self.model, toks, image=img,
                                  max_new_tokens=10)
            out.append(parse_score(self.tokenizer.decode(
                host_read(gen)[0])))
        return out


class VLAProcessor:
    """Reference-shaped facade (llava_processor.py:11-123)."""

    def __init__(self, backend=None):
        self.backend = backend if backend is not None else StubScorer()

    def evaluate_candidates(self, image, candidates: List[Dict],
                            instruction: str =
                            "Select the best leaf for grasping"
                            ) -> List[float]:
        if not candidates:
            return []
        try:
            raw = self.backend.score(image, candidates, instruction)
        except Exception:
            return [0.5] * len(candidates)
        return normalize_scores(raw)

    def get_confidence(self, scores: List[float]) -> float:
        return get_confidence(scores)
