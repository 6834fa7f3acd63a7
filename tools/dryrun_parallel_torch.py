"""Dry run of the port's parallel paths on N ranks of one host: the
counterpart of ``__graft_entry__.dryrun_multichip``'s paths 1, 2 and 2b.

1. one GraspPointCNN training step with the batch sharded over ``data``
   and the dense layers over ``model`` (a (N/2, 2) mesh for an even N);
2. the data-parallel batched frame pipeline over 2 frames a data rank;
2b. the row-sharded single-frame pipeline (32 rows a data rank).

    python tools/dryrun_parallel_torch.py --ranks 4 --device cpu
    python tools/dryrun_parallel_torch.py --ranks 2 --device cuda

It spawns its ranks itself (one process each, a file store under
``build/``). ``--device cuda`` puts rank r on card r mod the card count;
several ranks on one card need ``--backend gloo`` (the default; nccl
refuses two ranks on one GPU). Rank 0 prints a line a path and, last,
one JSON object with ``"ok": true``; any rank's failure exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _rank(rank, world, device):
    import torch
    from leafgrasp_tpu_torch.config import (FrameConfig,
                                            LeafSelectionConfig,
                                            ModelConfig, PipelineConfig,
                                            TrainConfig)
    from leafgrasp_tpu_torch.io.scenes import make_leaf_scene
    from leafgrasp_tpu_torch.models.grasp_cnn import (GraspPointCNN,
                                                      init_like_flax_)
    from leafgrasp_tpu_torch.parallel import (make_batched_frame_fn,
                                              make_mesh,
                                              make_sharded_frame_fn)
    from leafgrasp_tpu_torch.parallel.mesh import mesh_device, mesh_shape
    from leafgrasp_tpu_torch.training.train import (make_optimizer,
                                                    make_parallel_train_step,
                                                    parallelize_grasp_cnn)

    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    lines = []
    model_axis = 2 if world % 2 == 0 else 1
    mesh = make_mesh(world, model_axis=model_axis, device=device)
    shape = mesh_shape(mesh)
    dev = mesh_device(mesh)

    # ---- 1) CNN train step: dp over data, tp over model ----------------
    torch.manual_seed(0)
    model_cfg = ModelConfig(encoder_filters=(8, 16), attention_type="hybrid")
    train_cfg = TrainConfig(batch_size=2 * shape["data"])
    model = init_like_flax_(GraspPointCNN(model_cfg),
                            torch.Generator().manual_seed(0)).to(dev)
    bs = train_cfg.batch_size
    model, sharded, rows = parallelize_grasp_cnn(model, mesh, bs)
    step = make_parallel_train_step(model, make_optimizer(model, train_cfg),
                                    train_cfg, mesh, sharded)
    feats = torch.ones((bs, 32, 32, 9), device=dev)[rows]
    labels = torch.ones(bs, device=dev)[rows]
    loss, _ = step(feats, labels, torch.ones_like(labels),
                   float(train_cfg.pos_weight))
    loss = float(loss)
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    lines.append(f"dryrun_parallel_torch({world}): mesh={shape} CNN dp+tp "
                 f"train step loss={loss:.4f} ({len(sharded)} sharded "
                 f"tensors) OK")

    # ---- 2) data-parallel batched inference pipeline -------------------
    pcfg = PipelineConfig(frame=FrameConfig(height=96, width=128,
                                            max_leaves=4),
                          leaf=LeafSelectionConfig(min_leaf_area=200))
    b = 2 * shape["data"]
    mask, depth = make_leaf_scene(96, 128, 3, seed=1, margin=16)
    masks = np.stack([np.roll(mask, i, 1) for i in range(b)])
    depths = np.stack([np.roll(depth, i, 1) for i in range(b)])
    res = make_batched_frame_fn(mesh, pcfg)(
        masks, depths, np.float32(64.0), np.float32(48.0), np.float32(200.0))
    if tuple(res.grasp_uv.shape) != (b, 2):
        raise RuntimeError(f"batched grasp_uv {tuple(res.grasp_uv.shape)}")
    lines.append(f"dryrun_parallel_torch({world}): dp batched pipeline "
                 f"over {b} frames OK")

    # ---- 2b) row-sharded single-frame pipeline --------------------------
    sp_h = 32 * shape["data"]
    scfg = PipelineConfig(frame=FrameConfig(height=sp_h, width=128,
                                            max_leaves=4),
                          leaf=LeafSelectionConfig(min_leaf_area=200))
    smask, sdepth = make_leaf_scene(sp_h, 128, 3, seed=1, margin=16)
    sfn = make_sharded_frame_fn(mesh, scfg)
    sres = sfn(smask, sdepth, np.float32(64.0), np.float32(sp_h / 2.0),
               np.float32(200.0))
    if tuple(sres.grasp_uv.shape) != (2,):
        raise RuntimeError(f"sharded grasp_uv {tuple(sres.grasp_uv.shape)}")
    lines.append(f"dryrun_parallel_torch({world}): row-sharded full-frame "
                 f"pipeline ({shape['data']}-way spatial, "
                 f"{sfn.axis.calls} collectives, {sfn.axis.bytes} bytes) OK")
    return {"lines": lines, "mesh": shape, "loss": loss,
            "uv": sres.grasp_uv.tolist()}


def main(argv=None) -> int:
    from leafgrasp_tpu_torch.parallel.launch import run_ranks

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="seconds for the whole run")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("no CUDA device: pass --device cpu", file=sys.stderr)
            return 2
    store = os.path.join("build", f"dryrun_store_{os.getpid()}")
    os.makedirs("build", exist_ok=True)
    outs = run_ranks(_rank, args.ranks, store, args.device,
                     backend=args.backend, timeout_s=60.0,
                     join_s=args.timeout,
                     threads=1 if args.device == "cpu" else 0)
    if any(o["uv"] != outs[0]["uv"] or o["loss"] != outs[0]["loss"]
           for o in outs):
        raise RuntimeError("the ranks disagree")
    for line in outs[0]["lines"]:
        print(line)
    print(json.dumps({"ok": True, "ranks": args.ranks,
                      "device": args.device, "mesh": outs[0]["mesh"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
