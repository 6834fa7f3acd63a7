"""Self-supervised training-data collector (CV teacher -> CNN student),
PyTorch port of leafgrasp_tpu/training/data_collector.py (reference
``EnhancedGraspDataCollector``, ml_grasp_optimizer/data_collector.py:10-598):
for every teacher-selected grasp point it stores a positive 9-channel
patch stack, three rot90 augmentations with depth noise and score
jitter, and up to three validated negatives sampled from leaf tips,
stems and high-curvature edges (with ``hard_negatives`` also
near-boundary and tip-adjacent points). Persistence keeps the
reference's crash-safety contract: periodic copy-then-replace saves,
metadata and quality metrics, a progress cursor, resume-from-disk.

The distance fields, erosions and patches run on the device through the
port's ops; the candidate pools are then built on the host with numpy
from those exact EDT values (equal to the JAX package's), with the same
``np.argsort`` calls, so every pool equals JAX's, order included.

Randomness (augmentation noise, jitter, the negative picked from each
pool) comes from a seeded numpy ``Generator``, not JAX's PRNG: noisy
samples and picked negatives are not equal to the JAX package's bit for
bit, only alike in distribution.
"""

from __future__ import annotations

import os
import shutil
import zipfile
from typing import Dict

import numpy as np
import torch

from leafgrasp_tpu_torch.geometry.grasp_scorer import GraspScores
from leafgrasp_tpu_torch.geometry.patches import extract_patches
from leafgrasp_tpu_torch.ops.conv import separable_conv2d_reflect
from leafgrasp_tpu_torch.ops.edt import edt
from leafgrasp_tpu_torch.ops.morphology import (elliptical_kernel, erode,
                                                morphological_boundary)
from leafgrasp_tpu_torch.utils.device import resolve_device

__all__ = ["GraspDataCollector", "dilate_gray"]

_KEYS = ("depth_patches", "mask_patches", "score_patches", "labels",
         "total_scores", "grasp_points", "is_augmented")


class GraspDataCollector:
    def __init__(self, data_dir: str, patch_size: int = 32,
                 resume: bool = True, seed: int = 0,
                 save_every: int = 5, hard_negatives: bool = False,
                 device=None):
        """hard_negatives: additionally sample near-boundary points
        (inside the leaf but within the valid-region edge margin the
        selector enforces, grasp_point_selector.py:282-288) and
        tip-adjacent points (an 8-16 px ring around each tip maximum),
        as the JAX collector does. ``device`` (None means CUDA) runs the
        distance fields, erosions and patch gathers."""
        self.patch_size = patch_size
        self.hard_negatives = hard_negatives
        self.data_dir = os.path.expanduser(data_dir)
        self.save_every = save_every
        self.device = resolve_device(device)
        self._rng = np.random.default_rng(seed)
        self.samples: list = []
        self.stats = {"positive_samples": 0, "negative_samples": 0,
                      "augmented_samples": 0}

        if not resume and os.path.exists(self.data_dir):
            shutil.rmtree(self.data_dir)
        os.makedirs(self.data_dir, exist_ok=True)
        if resume:
            self._load_existing()

    # ------------------------------------------------------------ public --

    def collect_sample(self, leaf_mask, depth, scores: GraspScores,
                       grasp_point_2d, total_score: float) -> bool:
        """Store positive + augmented + negative samples for one frame.
        ``leaf_mask`` and ``depth`` are (H, W) numpy arrays or tensors;
        ``scores`` the leaf's score maps."""
        leaf = self._tensor(leaf_mask, torch.bool)
        depth_t = self._tensor(depth, torch.float32)
        x, y = int(grasp_point_2d[0]), int(grasp_point_2d[1])
        h, w = leaf.shape
        half = self.patch_size // 2
        # boundary check (data_collector.py:83-89)
        if y < half or y >= h - half or x < half or x >= w - half:
            return False

        stack = self._patch_stack(leaf, depth_t, scores, x, y)
        if stack is None:
            return False
        depth_p, mask_p, score_p = stack
        if not mask_p.any():
            return False

        self._add(depth_p, mask_p, score_p, float(total_score), (x, y),
                  label=1, augmented=False)
        self._augment(depth_p, mask_p, score_p, float(total_score), (x, y))
        self._collect_negatives(leaf, depth_t, scores)

        n = self.stats["positive_samples"] + self.stats["negative_samples"]
        if n % self.save_every == 0:
            self.save()
        return True

    def dataset(self) -> Dict[str, np.ndarray]:
        """Stacked arrays in the reference's training_data layout."""
        if not self.samples:
            raise ValueError("no samples collected")
        return {
            "depth_patches": np.stack([s["depth"] for s in self.samples]),
            "mask_patches": np.stack([s["mask"] for s in self.samples]),
            "score_patches": np.stack([s["scores"] for s in self.samples]),
            "labels": np.array([s["label"] for s in self.samples],
                               np.int32),
            "total_scores": np.array([s["total_score"] for s in
                                      self.samples], np.float32),
            "grasp_points": np.array([s["point"] for s in self.samples],
                                     np.int32),
            "is_augmented": np.array([s["augmented"] for s in self.samples],
                                     bool),
        }

    def save(self):
        """Copy-then-replace crash-safe save + metadata
        (data_collector.py:500-598)."""
        if not self.samples:
            return
        path = os.path.join(self.data_dir, "training_data.npz")
        backup = path + ".backup"
        if os.path.exists(path):
            shutil.copy2(path, backup)
        try:
            data = self.dataset()
            np.savez_compressed(path, **data)
            self._write_metadata(data)
            if os.path.exists(backup):
                os.remove(backup)
        except BaseException:
            if os.path.exists(backup):
                shutil.copy2(backup, path)
            raise
        with open(os.path.join(self.data_dir,
                               "collection_progress.txt"), "w") as f:
            f.write(f"last_frame: {self.stats['positive_samples']}\n")

    # ----------------------------------------------------------- internal --

    def _tensor(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(a).to(device=self.device, dtype=dtype)

    def _patch_stack(self, leaf: torch.Tensor, depth: torch.Tensor,
                     scores: GraspScores, x: int, y: int):
        maps = torch.cat([depth[None], leaf.to(torch.float32)[None],
                          scores.stacked_channels().to(self.device)])
        p = extract_patches(
            maps, torch.tensor([x], device=self.device),
            torch.tensor([y], device=self.device),
            self.patch_size)[0].cpu().numpy()          # (9, P, P)
        if not np.isfinite(p).all():
            return None
        return p[0], p[1] > 0.5, p[2:]

    def _add(self, depth_p, mask_p, score_p, total_score, point, label,
             augmented):
        self.samples.append(dict(
            depth=np.asarray(depth_p, np.float32),
            mask=np.asarray(mask_p, np.float32),
            scores=np.asarray(score_p, np.float32),
            total_score=total_score, point=tuple(map(int, point)),
            label=int(label), augmented=bool(augmented)))
        if label == 1:
            key = "augmented_samples" if augmented else "positive_samples"
        else:
            key = "negative_samples"
        self.stats[key] += 1

    def _augment(self, depth_p, mask_p, score_p, total_score, point):
        """90/180/270 rot + 1-2% depth noise + 0.95-1.0 score jitter
        (data_collector.py:250-293,396-419)."""
        for k in (1, 2, 3):
            rot_d = np.rot90(depth_p, k)
            rot_m = np.rot90(mask_p, k)
            rot_s = np.rot90(score_p, k, axes=(1, 2))
            noise_factor = float(self._rng.uniform(0.01, 0.02))
            noise = self._rng.standard_normal(rot_d.shape) \
                * noise_factor * float(rot_d.mean())
            noisy = np.clip(rot_d + noise, 0.0, None)
            jitter = float(self._rng.uniform(0.95, 1.0))
            new_pt = self._rotate_point(point, 90 * k, self.patch_size)
            self._add(noisy, rot_m, rot_s, total_score * jitter, new_pt,
                      label=1, augmented=True)

    @staticmethod
    def _rotate_point(point, angle_deg, size):
        x, y = point
        c = size // 2
        a = np.radians(angle_deg)
        xr = (x - c) * np.cos(a) - (y - c) * np.sin(a) + c
        yr = (x - c) * np.sin(a) + (y - c) * np.cos(a) + c
        return (int(xr), int(yr))

    def negative_pools(self, leaf) -> list:
        """The candidate lists the negatives are drawn from, in order:
        tips, stems, edges, and with ``hard_negatives`` near-boundary and
        tip-adjacent points; each a list of (x, y)."""
        m = self._tensor(leaf, torch.bool)
        m_np = m.cpu().numpy()
        din = edt(~m).cpu().numpy()
        pools = [self._tip_points(m_np, din), self._stem_points(m),
                 self._edge_points(m)]
        if self.hard_negatives:
            pools += [self._near_boundary_points(m_np, din),
                      self._tip_adjacent_points(m, m_np, din)]
        return pools

    def _collect_negatives(self, leaf, depth, scores, max_negatives: int = 3):
        """<=1 each from tip/stem/edge regions (data_collector.py:295-348);
        with hard_negatives also near-boundary + tip-adjacent pools."""
        pools = self.negative_pools(leaf)
        if self.hard_negatives:
            max_negatives += 2
        h, w = leaf.shape
        half = self.patch_size // 2
        collected = 0
        for pool in pools:
            if collected >= max_negatives or len(pool) == 0:
                continue
            i = int(self._rng.integers(0, len(pool)))
            x, y = int(pool[i][0]), int(pool[i][1])
            if y < half or y >= h - half or x < half or x >= w - half:
                continue
            stack = self._patch_stack(leaf, depth, scores, x, y)
            if stack is None:
                continue
            self._add(*stack, 0.0, (x, y), label=0, augmented=False)
            collected += 1

    @staticmethod
    def _tip_points(m: np.ndarray, din: np.ndarray):
        """Distance-transform local maxima on the leaf, the top quartile
        by distance, in descending order of distance
        (data_collector.py:421-441)."""
        local_max = (dilate_gray(din) == din) & m
        ys, xs = np.where(local_max)
        if len(xs) == 0:
            return []
        order = np.argsort(din[ys, xs])[::-1]
        keep = max(1, len(order) // 4)
        return [(xs[i], ys[i]) for i in order[:keep]]

    def _stem_points(self, m: torch.Tensor):
        """Bottom 25% eroded twice with a 5x5 ellipse
        (data_collector.py:443-459)."""
        m = m.clone()
        m[: int(0.75 * m.shape[0])] = False
        k = elliptical_kernel(5)
        ys, xs = np.where(erode(erode(m, k), k).cpu().numpy())
        return list(zip(xs, ys))

    @staticmethod
    def _near_boundary_points(m: np.ndarray, din: np.ndarray):
        """Hard pool: on-leaf points with interior distance in
        (6, min_edge_distance]: the selector's valid region rejects them
        (distance_map > 20, grasp_point_selector.py:282-288) but their
        32x32 patches are mostly leaf."""
        ys, xs = np.where(m & (din > 6.0) & (din <= 20.0))
        return list(zip(xs, ys))

    def _tip_adjacent_points(self, m: torch.Tensor, m_np: np.ndarray,
                             din: np.ndarray):
        """Hard pool: the 8-16 px ring around each top-quartile tip."""
        tips = self._tip_points(m_np, din)
        if not tips:
            return []
        txs, tys = (torch.as_tensor(np.array(v), device=m.device)
                    for v in zip(*tips))
        seeds = torch.zeros_like(m)
        seeds[tys, txs] = True
        d_tip = edt(seeds).cpu().numpy()
        ys, xs = np.where(m_np & (d_tip >= 8.0) & (d_tip <= 16.0))
        return list(zip(xs, ys))

    def _edge_points(self, m: torch.Tensor):
        """High-curvature boundary proxy: boundary pixels whose 7x7
        neighborhood mask occupancy is low (convex corner). The box sum
        is separable (taps 1/7 twice); occupancies are k/49 to within
        rounding, far from the 0.45 threshold."""
        band = morphological_boundary(m)
        taps = (1.0 / 7.0,) * 7
        occupancy = separable_conv2d_reflect(m.to(torch.float32), taps, taps)
        ys, xs = np.where((band & (occupancy < 0.45)).cpu().numpy())
        return list(zip(xs, ys))

    def _write_metadata(self, data):
        q = {
            "depth_range": [float(data["depth_patches"].min()),
                            float(data["depth_patches"].max())],
            "mask_coverage": float((data["mask_patches"] > 0).mean()),
            "positive_ratio": float((data["labels"] == 1).mean()),
            "augmented_ratio": float(data["is_augmented"].mean()),
        }
        path = os.path.join(self.data_dir, "collection_metadata.txt")
        with open(path, "w") as f:
            f.write("=== Data Collection Statistics ===\n")
            for k, v in self.stats.items():
                f.write(f"{k}: {v}\n")
            f.write(f"total_samples: {len(self.samples)}\n\n")
            f.write("=== Tensor Shapes ===\n")
            for k, v in data.items():
                f.write(f"{k}: {v.shape}\n")
            f.write("\n=== Quality Metrics ===\n")
            for k, v in q.items():
                f.write(f"{k}: {v}\n")
            scores = data["total_scores"]
            f.write("\nScore Statistics:\n")
            f.write(f"mean: {scores.mean():.3f}\nstd: {scores.std():.3f}\n")
            f.write(f"min: {scores.min():.3f}\nmax: {scores.max():.3f}\n")

    def _load_existing(self):
        path = os.path.join(self.data_dir, "training_data.npz")
        if not os.path.exists(path):
            return
        try:
            data = np.load(path)
            for i in range(len(data["labels"])):
                self.samples.append(dict(
                    depth=data["depth_patches"][i],
                    mask=data["mask_patches"][i],
                    scores=data["score_patches"][i],
                    total_score=float(data["total_scores"][i]),
                    point=tuple(data["grasp_points"][i].tolist()),
                    label=int(data["labels"][i]),
                    augmented=bool(data["is_augmented"][i])))
            labels = data["labels"]
            aug = data["is_augmented"]
            self.stats["positive_samples"] = int(((labels == 1)
                                                  & ~aug).sum())
            self.stats["augmented_samples"] = int(((labels == 1)
                                                   & aug).sum())
            self.stats["negative_samples"] = int((labels == 0).sum())
        except (OSError, KeyError, ValueError, EOFError,
                zipfile.BadZipFile):
            # an unreadable file starts an empty collection, as in JAX
            self.samples = []
            self.stats = {"positive_samples": 0, "negative_samples": 0,
                          "augmented_samples": 0}


def dilate_gray(dist: np.ndarray, size: int = 5) -> np.ndarray:
    """Grayscale max-filter (cv2.dilate on float images with a 5x5 ones
    kernel, data_collector.py:428-429)."""
    import scipy.ndimage as ndi
    return ndi.maximum_filter(dist, size=size, mode="constant", cval=0.0)
