"""Single-frame spatial parallelism for the whole grasp pipeline,
PyTorch port of leafgrasp_tpu/parallel/spatial_frame.py.

``make_sharded_frame_fn`` runs ``pipeline.frame.select_grasp``'s steps
(leaf selection, the score maps, spaced top-k, the CNN on the candidate
patches, fusion, 3D lift, pre-grasp) with the frame's rows sharded over
a mesh axis. Every rank calls it with the same full-frame arguments,
moves only its own rows to its device, and returns the same replicated
``FrameResult``. Cross-rank movement, in the order every rank issues it:

* per-leaf statistics: float64 partial sums, one SUM, then the median
  bisection's counts, one SUM a round over the frame's depth range;
* vertical EDT pass 1: the two-level scan (``spatial.py``); pass 2 is
  row-local, through the min-plus kernel on the card;
* frame-wide extremes: (value, index) pairs gathered and combined with
  numpy's row-major tie-break; maxima in one MAX;
* dilations and convolutions: a halo of neighbouring rows, then the
  single-frame operation on the padded block (``spatial.halo_rows``);
* min-area-rect orientation: the (rows, 16) per-row runs gathered, the
  run-graph labelling and the hull replicated;
* spaced top-k: k rounds of {local argmax, gathered combine, local
  suppression};
* CNN patches and the candidates' depths: each patch cell is read by the
  one shard that holds its (clamped) row, zeros elsewhere, one SUM;
* the pre-grasp windows: a summed int32 "any" per step.

Data-dependent branches that only pick a rank-local route (the band of
a shard's min-plus, the orientation's fixed-point rounds on gathered,
identical data) read the host; no branch decides whether a collective
runs, so every rank issues the same collectives. Integer decisions
equal the single-frame path's; floats differ at most by the order of
the float64 statistic sums.
"""

from __future__ import annotations

import torch

from leafgrasp_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig
from leafgrasp_tpu_torch.geometry.grasp_scorer import (
    GraspScores, accessibility_score_map, approach_score_map,
    combine_traditional, isolation_score_map, sdf_score_map,
    stem_penalty_map, valid_region_mask)
from leafgrasp_tpu_torch.geometry.leaf_scorer import leaf_choice_from_stats
from leafgrasp_tpu_torch.geometry.lift3d import lift_to_3d, pre_grasp_point
from leafgrasp_tpu_torch.geometry.patches import normalize_patch_batch
from leafgrasp_tpu_torch.kernels.scoring import fused_score_maps
from leafgrasp_tpu_torch.models.grasp_cnn import ml_scores_from_logits
from leafgrasp_tpu_torch.ops.components import leaf_stats
from leafgrasp_tpu_torch.ops.conv import (flatness_from_depth,
                                          gradient_magnitude)
from leafgrasp_tpu_torch.ops.edt import exact_sqrt
from leafgrasp_tpu_torch.ops.morphology import dilate, elliptical_kernel
from leafgrasp_tpu_torch.ops.pca import (
    _largest_component_extremes_from_runs, _mask_row_runs,
    _rect_from_row_extremes, mask_orientation)
from leafgrasp_tpu_torch.ops.topk import Candidates
from leafgrasp_tpu_torch.parallel.collectives import Axis
from leafgrasp_tpu_torch.parallel.mesh import mesh_device
from leafgrasp_tpu_torch.parallel.spatial import halo_rows, squared_edt_local
from leafgrasp_tpu_torch.pipeline.frame import FrameResult, _scalar
from leafgrasp_tpu_torch.pipeline.fusion import fuse_candidates

__all__ = ["make_sharded_frame_fn"]

_RUNS_PER_ROW = 16


def _dilate_sharded(mask: torch.Tensor, kernels, axis: Axis) -> list:
    """Binary dilations of a row-sharded (rows, W) mask by each SE of
    ``kernels``, from one halo of the largest SE's vertical reach."""
    rows = mask.shape[0]
    reach = max(k.shape[0] // 2 for k in kernels)
    padded, n_top, _ = halo_rows(mask.to(torch.bool), reach, reach, axis)
    return [dilate(padded, k)[n_top:n_top + rows] for k in kernels]


def _conv_halo(local: torch.Tensor, radius: int, fn,
               axis: Axis) -> torch.Tensor:
    """A convolution chain ``fn`` of receptive radius ``radius`` on a
    row-sharded block: run on the halo-padded block, crop the core."""
    padded, n_top, _ = halo_rows(local, radius, radius, axis)
    return fn(padded)[n_top:n_top + local.shape[0]]


def _global_extremum(val: torch.Tensor, flat_idx: torch.Tensor,
                     axis: Axis, mode: str):
    """Combine each shard's (extremum, frame flat index) with numpy's
    tie-break (the first row-major index wins): one gather of a float64
    pair (indices below 2^53 are exact)."""
    got = axis.gather(torch.stack([val.to(torch.float64),
                                   flat_idx.to(torch.float64)]))
    vals, idxs = got[:, 0], got[:, 1]
    best = vals.amax() if mode == "max" else vals.amin()
    idx = torch.where(vals == best, idxs,
                      torch.full_like(idxs, float("inf"))).amin()
    return best, idx.to(torch.int64)


def _orientation_sharded(leaf: torch.Tensor, w: int, axis: Axis):
    """The exact min-area-rect orientation: per-row runs of the shard's
    rows, one gather, then labelling and hull on the whole frame's runs
    (replicated, as ``ops.pca.min_area_rect``)."""
    xl, xr, nrow = _mask_row_runs(leaf, _RUNS_PER_ROW)
    rpr = xl.shape[1]
    runs = axis.gather(torch.cat([xl, xr, nrow.to(torch.int32)[:, None]],
                                 dim=1))
    runs = runs.reshape(-1, 2 * rpr + 1)
    xmin_r, xmax_r, valid_m = _largest_component_extremes_from_runs(
        runs[:, :rpr], runs[:, rpr:2 * rpr], runs[:, -1].to(torch.int64), w)
    return _rect_from_row_extremes(xmin_r, xmax_r, w, valid_m)


def make_sharded_frame_fn(mesh, cfg: PipelineConfig = DEFAULT_CONFIG,
                          with_cnn: bool = False, axis: str = "data",
                          fused: bool = True):
    """Build ``fn(mask_ids, depth, cx, cy, f[, cnn])`` with the frame's
    rows sharded over the mesh's ``axis``; ``cnn`` is a GraspPointCNN in
    eval mode on this rank's device. ``fused`` routes the per-pixel
    combination through the fused scoring kernel on each shard's rows
    (``kernels.scoring.fused_score_maps``, the single-frame path's);
    False composes the unfused maps of geometry/grasp_scorer.py (the JAX
    package's oracle route). ``fn.axis`` counts the collectives issued.

    Bounds, as in JAX: the frame height must divide the axis; each shard
    must hold at least max(isolation, stem kernel) / 2, patch / 2 and
    the smoothing radius of rows; ``union_half`` isolation does not
    row-shard with the CNN (CV-only skips isolation and serves it);
    ``train_stats`` patch normalization is not plumbed through."""
    if with_cnn and cfg.fusion.patch_normalization == "train_stats":
        raise NotImplementedError(
            "patch_normalization='train_stats' is not plumbed through "
            "the row-sharded frame fn; use the single-device frame fn "
            "or patch_normalization='reference_minmax'")
    ax = Axis(mesh, axis)
    h, w = cfg.frame.height, cfg.frame.width
    if h % ax.size:
        raise ValueError(f"frame height {h} must divide {ax.size} shards")
    rows = h // ax.size
    gcfg = cfg.grasp
    iso_mode = gcfg.isolation_context
    if iso_mode not in ("union", "union_half", "reference_self"):
        raise ValueError(f"unknown isolation_context {iso_mode!r}")
    if iso_mode == "union_half" and with_cnn:
        raise NotImplementedError(
            "union_half isolation does not row-shard; use 'union'")
    min_rows = max(gcfg.isolation_wide_kernel // 2, gcfg.stem_kernel // 2,
                   cfg.fusion.patch_size // 2,
                   gcfg.gaussian_kernel_size // 2 + 1)
    if rows < min_rows:
        raise ValueError(f"{rows} rows/shard < required halo {min_rows}")
    dev = mesh_device(mesh)
    row0 = ax.index * rows
    # isolation feeds only the CNN patch channels: CV-only skips it
    mode = iso_mode if with_cnn else "skip"

    def local_rows(arr, dtype):
        arr = torch.as_tensor(arr)
        if tuple(arr.shape) != (h, w):
            raise ValueError(f"frame {tuple(arr.shape)} is not the "
                             f"configured {(h, w)}")
        return arr[row0:row0 + rows].to(device=dev, dtype=dtype)

    @torch.no_grad()
    def fn(mask_ids, depth, camera_cx, camera_cy, f_norm, cnn=None):
        if with_cnn and cnn is None:
            raise ValueError("with_cnn=True needs the cnn")
        ids = local_rows(mask_ids, torch.int32)
        depth = local_rows(depth, torch.float32)
        cx, cy, f = (_scalar(v, dev) for v in (camera_cx, camera_cy,
                                                f_norm))
        flat = row0 * w + torch.arange(rows * w, device=dev)

        # ---- leaf selection ---------------------------------------------
        fg = ids > 0
        first_fg = torch.where(fg.any(), flat[torch.argmax(
            fg.reshape(-1).to(torch.int32))], torch.full_like(flat[0], h * w))
        ext = ax.max(torch.stack([depth.max().to(torch.float64),
                                  -depth.min().to(torch.float64),
                                  -first_fg.to(torch.float64)]))
        dmax, dmin = ext[0].to(torch.float32), (-ext[1]).to(torch.float32)
        amin = (-ext[2]).to(torch.int64)
        amin = torch.where(amin == h * w, torch.zeros_like(amin), amin)
        stats = leaf_stats(ids, depth, cfg.frame.max_leaves, cx, cy, f,
                           reduce_fn=ax.sum, row0=row0, frame_height=h,
                           depth_range=(dmin, dmax))
        # the background pixel farthest from any leaf (leaf_scorer.py:66-71)
        sdf_fg = exact_sqrt(squared_edt_local(fg[None], ax, row0, h, w)[0])
        _, amax = _global_extremum(sdf_fg.max(),
                                   flat[torch.argmax(sdf_fg)], ax, "max")
        sel = leaf_choice_from_stats(
            stats, (amin % w).to(torch.float32),
            (amin // w).to(torch.float32), (amax % w).to(torch.float32),
            (amax // w).to(torch.float32), h, w, f, cfg.leaf)

        leaf = ids == sel.best_leaf_id
        mf = leaf.to(torch.float32)

        # ---- distance fields and score maps -----------------------------
        if mode == "union":
            close_k = elliptical_kernel(gcfg.isolation_close_kernel)
            wide_k = elliptical_kernel(gcfg.isolation_wide_kernel)
            seeds = torch.stack([~leaf, leaf, *_dilate_sharded(
                fg & ~leaf, (close_k, wide_k), ax)])
        else:
            seeds = torch.stack([~leaf, leaf])
        d = exact_sqrt(squared_edt_local(seeds, ax, row0, h, w))
        din, dout = d[0], d[1]
        if mode == "union":
            dclose, dwide = d[2], d[3]
        else:
            # reference_self: no interference -> isolation 1 everywhere;
            # skip: zero fields, as the single-frame path
            fill = 0.0 if mode == "skip" else 1.0
            dclose = torch.full_like(din, fill)
            dwide = dclose
        maxima = ax.max(torch.stack([din.max(), dout.max(), dclose.max(),
                                     dwide.max()]))
        norm_max = torch.maximum(maxima[0], maxima[1])
        close_max, wide_max = maxima[2], maxima[3]

        if gcfg.orientation_source == "min_area_rect":
            orient = _orientation_sharded(leaf, w, ax)
        else:
            orient = mask_orientation(leaf, reduce_fn=ax.sum, row0=row0)
        stem = stem_penalty_map(
            leaf, gcfg, row0=row0, frame_height=h,
            dilate_fn=lambda m, k: _dilate_sharded(m, (k,), ax)[0])
        radius = gcfg.gaussian_kernel_size // 2 + 1
        if fused:
            grad_mag = _conv_halo(
                depth * mf, radius,
                lambda x: gradient_magnitude(x, gcfg.gaussian_kernel_size),
                ax)
            scores = GraspScores(*fused_score_maps(
                din, torch.zeros_like(din), dclose, dwide, grad_mag, mf,
                stem, cx, cy, f, orient.angle, orient.valid, cfg=gcfg,
                row0=row0, frame_height=h, max_sdf=norm_max,
                max_close=close_max, max_wide=wide_max))
        else:
            sdf = sdf_score_map(leaf, cx, cy, gcfg, dist_inside=din,
                                dist_outside=dout, row0=row0,
                                norm_max=norm_max, orientation=orient)
            approach = approach_score_map(leaf, cx, cy, f, row0=row0)
            flatness = _conv_halo(
                depth * mf, radius,
                lambda x: flatness_from_depth(
                    x, gcfg.flatness_gradient_scale,
                    gcfg.gaussian_kernel_size), ax)
            isolation = isolation_score_map(
                leaf, None, gcfg, dist_close=dclose, dist_wide=dwide,
                row0=row0, frame_height=h, close_max=close_max,
                wide_max=wide_max)
            distance = din * mf
            accessibility = accessibility_score_map(
                leaf, cx, cy, gcfg, row0=row0, frame_height=h)
            traditional = combine_traditional(approach, sdf, flatness,
                                              accessibility, stem, gcfg)
            scores = GraspScores(
                sdf_score=sdf, approach_score=approach,
                flatness_map=flatness, isolation_map=isolation,
                distance_map=distance, accessibility_map=accessibility,
                stem_penalty=stem, traditional_score=traditional,
                valid_region=valid_region_mask(distance, leaf, stem, gcfg))

        # ---- spaced top-k: distributed greedy rounds --------------------
        sup = 2 * gcfg.min_candidate_distance
        s = torch.where(scores.valid_region, scores.traditional_score,
                        torch.zeros((), dtype=torch.float32, device=dev))
        grows = (row0 + torch.arange(rows, device=dev))[:, None]
        gcols = torch.arange(w, device=dev)[None, :]
        neg = torch.full((), float("-inf"), dtype=torch.float32, device=dev)
        xs, ys, vals = [], [], []
        for _ in range(gcfg.top_k):
            li = torch.argmax(s.reshape(-1))
            best, bidx = _global_extremum(s.reshape(-1)[li], flat[li], ax,
                                          "max")
            y, x = bidx // w, bidx % w
            s = torch.where(((grows - y).abs() <= sup)
                            & ((gcols - x).abs() <= sup), neg, s)
            xs.append(x)
            ys.append(y)
            vals.append(best.to(torch.float32))
        vals = torch.stack(vals)
        cand = Candidates(x=torch.stack(xs).to(torch.int32),
                          y=torch.stack(ys).to(torch.int32), score=vals,
                          accepted=torch.isfinite(vals))

        # ---- the candidates' depths and CNN patches: one SUM ------------
        cy64, cx64 = cand.y.to(torch.int64), cand.x.to(torch.int64)
        own = (cy64 >= row0) & (cy64 < row0 + rows)
        cdepth = torch.where(own, depth[torch.clamp(cy64 - row0, 0, rows - 1),
                                        cx64], torch.zeros_like(vals))
        if with_cnn:
            p = cfg.fusion.patch_size
            offs = torch.arange(p, device=dev) - p // 2
            prow = torch.clamp(cy64[:, None] + offs, 0, h - 1)     # (k, p)
            pcol = torch.clamp(cx64[:, None] + offs, 0, w - 1)
            held = (prow >= row0) & (prow < row0 + rows)
            stack = torch.cat([depth[None], mf[None],
                               scores.stacked_channels()])      # (9, rows, W)
            raw = stack[:, torch.clamp(prow - row0, 0, rows - 1)[:, :, None],
                        pcol[:, None, :]].permute(1, 0, 2, 3)  # (k, 9, p, p)
            raw = torch.where(held[:, None, :, None], raw,
                              torch.zeros((), device=dev))
            merged = ax.sum(torch.cat([raw.reshape(-1), cdepth]))
            patches = merged[:raw.numel()].reshape(raw.shape)
            cdepth = merged[raw.numel():]
            logits = cnn(normalize_patch_batch(patches))
            ml = ml_scores_from_logits(logits, cfg.fusion.score_spread_scale)
            fusion = fuse_candidates(cand.score, ml, cand.accepted, True,
                                     cfg.fusion)
        else:
            cdepth = ax.sum(cdepth)
            fusion = fuse_candidates(cand.score, torch.zeros_like(vals),
                                     cand.accepted, False, cfg.fusion)

        # ---- 3D lift + pre-grasp ----------------------------------------
        u = cand.x[fusion.best_index]
        v = cand.y[fusion.best_index]
        grasp_xyz = lift_to_3d(u.to(torch.float32), v.to(torch.float32),
                               cdepth[fusion.best_index], cx, cy, f)
        pre = pre_grasp_point(grasp_xyz, leaf, cx, cy, f, cfg=cfg.pregrasp,
                              row0=row0, frame_height=h, any_reduce=ax.sum)
        return FrameResult(
            found=sel.found & cand.accepted[0],
            degenerate=~(cand.score[0] > 0),
            leaf_id=sel.best_leaf_id,
            grasp_uv=torch.stack([u, v]),
            grasp_xyz=grasp_xyz,
            pre_grasp_xyz=pre.point,
            ml_used=fusion.ml_used,
            candidates=cand,
            fusion=fusion,
            leaf_selection=sel,
        )

    fn.axis = ax
    return fn
