"""Host shell: the grasp-selection service around the frame function,
PyTorch port of leafgrasp_tpu/pipeline/ingest.py.

The equivalent of the production ROS node
(reference leaf_grasp_node_v3.py:25-243) and the VLA node
(leaf_grasp_node_vla.py:24-284):

* stream callbacks (`on_mask` / `on_depth`) feed the lock-free
  FrameBus (replacing the processing-flag + param-server handshake);
* `process_pending` pulls the freshest pair, rate-gates (10 Hz default,
  leaf_grasp_node_v3.py:81), runs the frame function on the device,
  publishes the reference's message tuple "u,v,X,Y,Z[,pX,pY,pZ]"
  (leaf_grasp_node_v3.py:170-177);
* optional VLA re-ranking over per-leaf candidates BEFORE pixel
  selection -- the reference's intended flow, with its broken
  `_calculate_all_scores` call (leaf_grasp_node_vla.py:148-182)
  actually fixed: candidates come from the leaf selector's real
  per-leaf scores.

The service's ``timer`` (utils/profiler.py ``StageTimer``) takes its own
stages (``bus_push``, ``bus_pair``, ``frame_total``, ``select_grasp``,
``fetch``, ``vla_rerank``, ``vla_reselect``, ``finalize``) and, bound
while a frame is processed, the spans of the code it calls: the frame
function's stages, the host's ``device_wait``, the VLA's
``vla_prefill`` and ``vla_decode``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from leafgrasp_tpu_torch.config import (DEFAULT_CONFIG, CameraConfig,
                                        PipelineConfig)
from leafgrasp_tpu_torch.io.framebus import FrameBus
from leafgrasp_tpu_torch.pipeline.frame import make_frame_fn
from leafgrasp_tpu_torch.utils.device import fetch_to_host, resolve_device
from leafgrasp_tpu_torch.utils.profiler import StageTimer

__all__ = ["GraspService", "format_result_message", "leaf_candidates",
           "compact_instance_ids"]


def compact_instance_ids(mask: np.ndarray, max_leaves: int):
    """Remap arbitrary instance ids (e.g. YOLO tracking ids) onto the
    fixed 1..max_leaves slot range. Returns (remapped int32 mask,
    slot -> original-id lookup). Ids beyond max_leaves (by area rank,
    largest kept) are dropped to background."""
    mask = np.asarray(mask)
    ids, counts = np.unique(mask[mask > 0], return_counts=True)
    if len(ids) > max_leaves:
        keep = ids[np.argsort(-counts)][:max_leaves]
        keep = np.sort(keep)
    else:
        keep = ids
    out = np.zeros(mask.shape, np.int32)
    lookup = {}
    for slot, orig in enumerate(keep, start=1):
        out[mask == orig] = slot
        lookup[slot] = int(orig)
    return out, lookup


def format_result_message(grasp_uv, grasp_xyz, pre_grasp_xyz=None) -> str:
    """Reference publish format (leaf_grasp_node_v3.py:170-177)."""
    u, v = int(grasp_uv[0]), int(grasp_uv[1])
    x, y, z = (float(grasp_xyz[0]), float(grasp_xyz[1]),
               float(grasp_xyz[2]))
    if pre_grasp_xyz is None:
        return f"{u},{v},{x},{y},{z}"
    px, py, pz = (float(pre_grasp_xyz[0]), float(pre_grasp_xyz[1]),
                  float(pre_grasp_xyz[2]))
    return f"{u},{v},{x},{y},{z},{px},{py},{pz}"


def leaf_candidates(selection, max_candidates: int = 5) -> List[Dict]:
    """Build VLA candidates from the leaf selector's per-leaf scores
    (the working version of leaf_grasp_node_vla.py:148-182): one
    candidate per area-valid leaf, sorted by weighted geometric score,
    top-k kept."""
    scores = np.asarray(selection.scores)
    weighted = np.asarray(selection.weighted)
    valid = np.asarray(selection.candidate)
    cx = np.asarray(selection.stats.centroid_x)
    cy = np.asarray(selection.stats.centroid_y)

    cands = []
    for slot in np.where(valid)[0]:
        cands.append(dict(
            leaf_id=int(slot) + 1,
            x=float(cx[slot]), y=float(cy[slot]),
            clutter_score=float(scores[slot, 0]),
            distance_score=float(scores[slot, 1]),
            visibility_score=float(scores[slot, 2]),
            geometric_score=float(weighted[slot]),
        ))
    cands.sort(key=lambda c: -c["geometric_score"])
    return cands[:max_candidates]


class GraspService:
    """Frame-stream grasp selection service.

    Parameters
    ----------
    cfg : PipelineConfig
    cnn : optional GraspPointCNN in eval mode, already on ``device``
        (enables CV+ML fusion; absent -> CV-only, mirroring the
        reference's missing-checkpoint degradation).
    hybrid_selector : optional object with
        ``select_grasp_point(rgb, candidates)`` for leaf-level VLA
        re-ranking; failures degrade to the geometric choice.
    publish : callback(str) for the result message.
    on_result : callback(dict) with the full result; ``result`` in it is
        the frame's ``FrameResult`` with numpy leaves.
    record_path : optional path; every processed (mask, depth, stamp)
        is appended to a native frame log (io/framelog.py) for replay.
    pipeline_depth : number of frames kept in flight before their
        results are fetched and published (0 = synchronous, the
        default). Results publish in frame order, ``pipeline_depth``
        frames late; callers drain with ``flush()``. With a
        ``hybrid_selector`` the oldest in-flight frame's rerank runs
        after the newest frame's grasp selection, and uses the freshest
        ``on_rgb`` image at completion time. The frame function still
        reads a few scalars back per frame for its data-dependent
        branches (utils/device.host_read), and each read waits for the
        device, so a frame is finished by the time it is queued: depth N
        keeps the ordering and lateness semantics but overlaps no host
        work with device work yet.
    cnn_norm_stats : the checkpoint's stats dict for the train-consistent
        serving normalization (``cfg.fusion.patch_normalization ==
        'train_stats'``; see geometry/patches.py).
    device : None means CUDA (raises if CUDA is absent; there is no
        fallback to the CPU). The tests pass ``"cpu"``.
    hist_median : leaf selection takes its median depths from the
        two-level histogram (ops/median.py, two launches of the
        segment-histogram kernel per frame) instead of the 18-round
        bisection. Default False: the two agree within 1e-5 m, not bit
        for bit.

    spatial_mesh : optional (data, model) mesh (parallel.make_mesh):
        each frame's rows are sharded over its data axis
        (parallel/spatial_frame.py). Every rank of the mesh builds the
        service with the same arguments and takes the same frames; only
        rank 0 publishes, records and calls ``on_result``. The service
        runs on the mesh's device. A VLA re-pick runs the selector on
        rank 0 and broadcasts its leaf.
    """

    def __init__(self, cfg: PipelineConfig = DEFAULT_CONFIG,
                 cnn=None, hybrid_selector=None,
                 publish: Optional[Callable[[str], None]] = None,
                 on_result: Optional[Callable] = None,
                 min_interval_s: float = 0.1,
                 prefer_native_bus: bool = True,
                 pipeline_depth: int = 0,
                 record_path: Optional[str] = None,
                 cnn_norm_stats=None, device=None,
                 hist_median: bool = False, spatial_mesh=None):
        self.mesh = spatial_mesh
        self._rank0 = True
        if spatial_mesh is None:
            self.device = resolve_device(device)
        else:
            import torch.distributed as dist
            from leafgrasp_tpu_torch.parallel.mesh import mesh_device
            self.device = mesh_device(spatial_mesh)
            if device is not None and \
                    resolve_device(device).type != self.device.type:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{self.device}")
            if cnn is not None and \
                    cfg.fusion.patch_normalization == "train_stats":
                raise ValueError(
                    "patch_normalization='train_stats' is not plumbed "
                    "through the row-sharded path; use the single-device "
                    "frame fn or patch_normalization='reference_minmax'")
            self._rank0 = dist.get_rank() == 0
        if cnn is not None:
            if cnn.training:
                raise ValueError("the CNN must be in eval mode (cnn.eval())")
            cnn_dev = next(cnn.parameters()).device
            if cnn_dev.type != self.device.type:
                raise ValueError(f"the CNN is on {cnn_dev}, the service on "
                                 f"{self.device}: move it first")
        self.pipeline_depth = pipeline_depth
        self._inflight: List[tuple] = []
        self._recorder = None
        if record_path is not None and self._rank0:
            from leafgrasp_tpu_torch.io.framelog import FrameLogWriter
            self._recorder = FrameLogWriter(record_path, cfg.frame.height,
                                            cfg.frame.width)
        self.cfg = cfg
        self.camera = cfg.camera
        self.cnn = cnn
        self.hybrid_selector = hybrid_selector
        self.publish = publish
        self.on_result = on_result
        self.min_interval_s = min_interval_s
        self.timer = StageTimer()

        self.bus = FrameBus(cfg.frame.height, cfg.frame.width,
                            prefer_native=prefer_native_bus)
        if spatial_mesh is not None:
            from leafgrasp_tpu_torch.parallel.spatial_frame import \
                make_sharded_frame_fn
            self._fn = make_sharded_frame_fn(spatial_mesh, cfg,
                                             with_cnn=cnn is not None)
        else:
            self._fn = make_frame_fn(cfg, with_cnn=cnn is not None,
                                     device=self.device,
                                     norm_stats=cnn_norm_stats,
                                     hist_median=hist_median)
        self._last_processed = 0.0
        self._latest_rgb = None
        self._frames = 0
        self._stop = threading.Event()
        # serializes frame processing against stop()/flush() from
        # another thread (the documented run()-in-a-thread usage):
        # _inflight, the recorder and the kernels' launch counts are
        # shared. RLock because stop() drains via flush().
        self._proc_lock = threading.RLock()

    # ------------------------------------------------------- callbacks --

    def set_camera_params(self, projection_matrix):
        """3x4 P matrix (leaf_grasp_node_v3.py:93-99)."""
        self.camera = CameraConfig.from_projection(
            np.asarray(projection_matrix))

    def on_mask(self, mask: np.ndarray, stamp_us: int = 0):
        with self.timer.stage("bus_push"):
            self.bus.push_mask(mask, stamp_us)

    def on_depth(self, depth: np.ndarray, stamp_us: int = 0):
        with self.timer.stage("bus_push"):
            self.bus.push_depth(depth, stamp_us)

    def on_rgb(self, image: np.ndarray):
        """Left rectified color image, used by VLA re-ranking and the
        visualizer (leaf_grasp_node_v3.py:220-225)."""
        self._latest_rgb = image

    # ------------------------------------------------------ processing --

    def process_pending(self, force: bool = False):
        """Process the freshest pair if the rate gate allows. Returns the
        result dict or None."""
        now = time.monotonic()
        if not force and (now - self._last_processed) < self.min_interval_s:
            return None
        with self.timer.stage("bus_pair"):
            pair = self.bus.try_get_pair()
        if pair is None:
            return None
        mask, depth, mask_stamp, depth_stamp = pair
        self._last_processed = now
        return self.process_frame(mask, depth, mask_stamp=mask_stamp,
                                  depth_stamp=depth_stamp)

    def process_frame(self, mask: np.ndarray, depth: np.ndarray,
                      mask_stamp: int = 0, depth_stamp: int = 0):
        with self._proc_lock:
            return self._process_frame_locked(mask, depth, mask_stamp,
                                              depth_stamp)

    def _run_fn(self, mask16, depth):
        cam = self.camera
        args = (mask16, depth, np.float32(cam.cx), np.float32(cam.cy),
                np.float32(cam.fx))
        if self.cnn is not None:
            return self._fn(*args, self.cnn)
        return self._fn(*args)

    def _process_frame_locked(self, mask, depth, mask_stamp, depth_stamp):
        # ship the mask as int16 (the wire format): the frame function
        # casts on the device, which halves the mask's upload
        mask16 = np.ascontiguousarray(mask, np.int16)
        if self._recorder is not None:
            # session recording; replay with io.framelog.FrameLogReader
            self._recorder.append(mask16, depth, mask_stamp)
        with self.timer.bound(), self.timer.stage("frame_total"):
            with self.timer.stage("select_grasp"):
                res = self._run_fn(mask16, depth)

            idx = self._frames
            self._frames += 1
            entry = (res, mask16, depth, mask_stamp, depth_stamp, idx)
            if self.pipeline_depth:
                # `res` holds device tensors; complete the oldest
                # in-flight frame once the window is full
                self._inflight.append(entry)
                if len(self._inflight) > self.pipeline_depth:
                    return self._complete(*self._inflight.pop(0))
                return None
            return self._complete(*entry)

    def _complete(self, res, mask16, depth, mask_stamp, depth_stamp,
                  frame_index):
        """Materialize a frame: fetch, VLA rerank (when configured),
        then host-side finalize/publish."""
        # ONE fetch for the whole nested result (some forty tensors): a
        # `.cpu()` per field would synchronize once per field
        with self.timer.stage("fetch"):
            res = fetch_to_host(res)
        vla_choice = None
        if self.hybrid_selector is not None and bool(res.found):
            if self._rank0:
                with self.timer.stage("vla_rerank"):
                    vla_choice = self._vla_rerank(res, mask16, depth)
            leaf_id = self._repick_leaf(vla_choice, int(res.leaf_id))
            if leaf_id is not None:
                # re-run pixel selection on the VLA-chosen leaf
                with self.timer.stage("vla_reselect"):
                    res = fetch_to_host(
                        self._reselect(mask16, depth, leaf_id))
        return self._finalize(res, mask_stamp, depth_stamp, frame_index,
                              vla_choice)

    def _repick_leaf(self, vla_choice, leaf_id: int):
        """The leaf to re-run pixel selection on, when the VLA chose
        another than the frame's; else None. Over a mesh rank 0's choice
        is broadcast, so every rank runs the same sharded re-pick."""
        chosen = -1 if vla_choice is None else int(vla_choice["leaf_id"])
        if self.mesh is not None:
            import torch
            from leafgrasp_tpu_torch.parallel.collectives import Axis
            chosen = int(Axis(self.mesh, "data").broadcast(
                torch.tensor([chosen], device=self.device)).item())
        return chosen if chosen >= 0 and chosen != leaf_id else None

    def _finalize(self, res, mask_stamp, depth_stamp, frame_index,
                  vla_choice=None):
        """Materialize a frame result and publish it (host side; over a
        mesh, rank 0 only)."""
        with self.timer.stage("finalize"):
            found = bool(res.found)
            msg = None
            if found:
                msg = format_result_message(np.asarray(res.grasp_uv),
                                            np.asarray(res.grasp_xyz),
                                            np.asarray(res.pre_grasp_xyz))
                if self.publish and self._rank0:
                    self.publish(msg)
            out = dict(result=res, message=msg, found=found,
                       degenerate=bool(res.degenerate), vla=vla_choice,
                       mask_stamp=mask_stamp, depth_stamp=depth_stamp,
                       frame_index=frame_index)
            if self.on_result and self._rank0:
                self.on_result(out)
        return out

    def flush(self) -> List[dict]:
        """Finalize every in-flight frame (pipeline_depth > 0), in
        frame order. Returns their result dicts."""
        with self._proc_lock, self.timer.bound():
            outs = []
            while self._inflight:
                outs.append(self._complete(*self._inflight.pop(0)))
            return outs

    def _vla_rerank(self, res, mask, depth):
        try:
            cands = leaf_candidates(res.leaf_selection,
                                    self.cfg.vla.num_candidates)
            if not cands:
                return None
            return self.hybrid_selector.select_grasp_point(
                self._latest_rgb, cands)
        except Exception:
            return None  # geometric fallback (leaf_grasp_node_vla.py:133)

    def _reselect(self, mask, depth, leaf_id: int):
        """Pixel selection constrained to a specific leaf id: the frame
        function on a mask that keeps only this leaf, in the int16 wire
        dtype of the main path."""
        remapped = np.where(mask == leaf_id, leaf_id, 0).astype(np.int16)
        return self._run_fn(remapped, depth)

    # ------------------------------------------------------------ loop --

    def run(self, poll_interval_s: float = 0.005):
        """Blocking service loop; stop with .stop()."""
        while not self._stop.is_set():
            # the stop check and the frame under one lock: a frame taken
            # after stop() has flushed would stay in flight unpublished
            with self._proc_lock:
                if self._stop.is_set():
                    break
                out = self.process_pending()
            if out is None:
                time.sleep(poll_interval_s)

    def stop(self):
        self._stop.set()
        # drain dispatched-but-unfinalized frames (pipeline_depth > 0) so
        # their results publish and reach the recorder before it closes;
        # the lock serializes against a run() loop mid-frame in another
        # thread (its in-progress frame completes and records first)
        with self._proc_lock:
            self.flush()
            if self._recorder is not None:
                self._recorder.close()
                self._recorder = None

    def stats(self) -> dict:
        return dict(bus=self.bus.stats(), frames=self._frames,
                    stages=self.timer.summary())
