#!/usr/bin/env python3
"""End-to-end VLA rerank quality on the hard corpus through the PyTorch
port's GraspService: the counterpart of tools/eval_vla_system.py.

Two services take the same hard scenes (seed 100 + i, 4/6/8 leaves in
turn) with the shipped hard-corpus CNN (artifacts/torch/grasp_cnn_hard/
best_model: the ``deep`` encoder, ``train_stats`` patch normalization):
one geometric (+CNN) only, one with ``hybrid_selector`` wired to the
trained LLaVA-architecture LoRA scorer of artifacts/vla (the pretrained
base in the frozen slots, the adapter over it) on a deterministic RGB
composite of the scene. The summary reports the leaf agreement, the
pixel shift where the leaf changed, the confidence-ladder strategies
and the frames that fell back to geometry, as the JAX tool does.

The summary's ``prompts`` keep, for each reranked frame, the
candidates' fields that the scorer's prompts print (``prompt_inputs``):
the leaf centroid in full and three scores to three decimals. A centroid is an
f32 mean over tens of thousands of pixels; the port sums exactly and
rounds once, XLA in its own order, so at 1080 x 1440 the two can part in
the last bit, and then the prompt text, the generated tokens and the VLA
choice part with it. ``--check FILE`` holds the rows against a record:
on every scene the geometric columns (``leaf_geo``, ``uv_geo``) equal;
where the record's prompts are those of this run (or the record keeps
none), the VLA columns too (``leaf_vla``, ``uv_vla``, ``strategy``,
``vla_leaf`` equal, ``vla_confidence`` within 1e-3), and a scene live on
one side only is a mismatch.

    python tools/eval_vla_system_torch.py --check \\
        artifacts/torch/reference/system_accuracy_vla.json
    python tools/eval_vla_system_torch.py --device cpu --scenes 3 \\
        --height 540 --width 720

Writes build/artifacts_torch/system_accuracy_vla_torch.json (``--out``);
the last stdout line is the JSON summary; the exit code is 1 on a
mismatch.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from tools._torch_eval import (CAMERA, OUT_DIR,  # noqa: E402
                               TORCH_CNN_HARD, VLA_DIR, add_device_arg,
                               compare_rows, load_arch_scorer, load_cnn,
                               print_summary, render_rgb, repo_path,
                               setup_device, write_json)

GEO_FIELDS = ("leaf_geo", "uv_geo")
VLA_FIELDS = ("leaf_vla", "uv_vla", "strategy", "vla_leaf")
CONFIDENCE_TOL = 1e-3


PROMPT_KEYS = ("leaf_id", "x", "y", "geometric_score", "clutter_score",
               "distance_score")


def prompt_inputs(candidates) -> list:
    """The candidates' fields that their prompts print, in the scorer's
    order (floats as Python floats: JSON keeps them exactly)."""
    return [{k: c[k] for k in PROMPT_KEYS} for c in candidates]


def same_prompts(a, b) -> bool:
    """Whether two frames' candidates give the scorer the same leaves
    and prompt texts (``vla/processor.build_prompt``)."""
    from leafgrasp_tpu_torch.vla.processor import build_prompt
    return a is not None and b is not None and len(a) == len(b) and all(
        x["leaf_id"] == y["leaf_id"]
        and build_prompt(x, "") == build_prompt(y, "")
        for x, y in zip(a, b))


def check_rows(rows, prompts, record, seeds) -> dict:
    """The mismatches of this run's rows against ``record`` (see the
    module docstring) and how many scenes each check covered."""
    seeds = set(seeds)
    theirs = record.get("prompts")
    same = {s for s in seeds if theirs is None
            or same_prompts(prompts.get(str(s)), theirs.get(str(s)))}
    mine = {r["seed"] for r in rows}
    ref = {r["seed"] for r in record["rows"] if r["seed"] in seeds}
    both = mine & ref
    bad = [{"seed": s, "field": "row", "ours": s in mine,
            "record": s in ref} for s in sorted((mine ^ ref) & same)]
    bad += compare_rows(rows, record["rows"], both, GEO_FIELDS)
    bad += compare_rows([r for r in rows if r["seed"] in same],
                        record["rows"], both & same, VLA_FIELDS,
                        close=("vla_confidence",), tol=CONFIDENCE_TOL)
    reranked = seeds & {int(k) for k in list(prompts) + list(theirs or ())}
    bad_seeds = {m["seed"] for m in bad}
    return {"prompts_compared": len(reranked),
            "prompts_equal": len(reranked & same),
            "rows_compared": len(both),
            "rows_vla_compared": len(both & same),
            "rows_equal": sum(s not in bad_seeds for s in both),
            "mismatches": bad}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenes", type=int, default=26)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1440)
    ap.add_argument("--out", default=None)
    ap.add_argument("--check", default=None,
                    help="record to hold every row against")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from leafgrasp_tpu_torch.config import (FrameConfig,
                                            LeafSelectionConfig,
                                            MLFusionConfig, ModelConfig,
                                            PipelineConfig)
    from leafgrasp_tpu_torch.io.scenes import make_hard_leaf_scene
    from leafgrasp_tpu_torch.models.grasp_cnn import ARCHITECTURES
    from leafgrasp_tpu_torch.pipeline.ingest import GraspService
    from leafgrasp_tpu_torch.vla.hybrid import HybridGraspSelector
    from leafgrasp_tpu_torch.vla.processor import VLAProcessor

    dev = setup_device(args.device)
    h, w = args.height, args.width
    cfg = PipelineConfig(
        frame=FrameConfig(height=h, width=w, max_leaves=8),
        leaf=LeafSelectionConfig(
            min_leaf_area=10000 if h >= 1080 else 1500),
        model=ModelConfig(attention_type="spatial",
                          encoder_filters=ARCHITECTURES["deep"]),
        fusion=MLFusionConfig(patch_normalization="train_stats"))
    cnn, norm_stats, _ = load_cnn(TORCH_CNN_HARD, cfg.model, dev)
    scorer = load_arch_scorer(VLA_DIR, dev)

    def make_service(hybrid):
        svc = GraspService(cfg, cnn=cnn, cnn_norm_stats=norm_stats,
                           hybrid_selector=hybrid, min_interval_s=0.0,
                           device=dev)
        cx, cy, f = CAMERA
        svc.set_camera_params(np.array([[f, 0.0, cx, 0.0],
                                        [0.0, f, cy, 0.0],
                                        [0.0, 0.0, 1.0, 0.0]]))
        return svc

    class RecordingSelector(HybridGraspSelector):
        """The hybrid selector, keeping its last call's candidates."""
        last = None

        def select_grasp_point(self, image, candidates, *args, **kw):
            self.last = [dict(c) for c in candidates]
            return super().select_grasp_point(image, candidates, *args,
                                              **kw)

    selector = RecordingSelector(VLAProcessor(scorer))
    svc_geo = make_service(None)
    svc_vla = make_service(selector)

    rows, strategies, prompts = [], {}, {}
    fallbacks = 0
    t0 = time.perf_counter()
    for seed in range(args.scenes):
        n_leaves = (4, 6, 8)[seed % 3]
        mask, depth = make_hard_leaf_scene(h, w, num_leaves=n_leaves,
                                           seed=100 + seed, margin=120)
        svc_vla.on_rgb(render_rgb(mask, depth))
        selector.last = None
        out_g = svc_geo.process_frame(mask, depth)
        out_v = svc_vla.process_frame(mask, depth)
        if selector.last is not None:
            prompts[str(100 + seed)] = prompt_inputs(selector.last)
        if not (out_g["found"] and out_v["found"]) \
                or out_g["degenerate"] or out_v["degenerate"]:
            continue
        vla = out_v["vla"]
        if vla is None:
            fallbacks += 1
            strat, conf = "FALLBACK", None
        else:
            strat = vla["strategy"]
            conf = round(float(vla["vla_confidence"]), 4)
        strategies[strat] = strategies.get(strat, 0) + 1
        rows.append({
            "seed": 100 + seed, "n_leaves": n_leaves,
            "leaf_geo": int(out_g["result"].leaf_id),
            "leaf_vla": int(out_v["result"].leaf_id),
            "uv_geo": np.asarray(out_g["result"].grasp_uv).tolist(),
            "uv_vla": np.asarray(out_v["result"].grasp_uv).tolist(),
            "strategy": strat, "vla_confidence": conf,
            "vla_leaf": None if vla is None else int(vla["leaf_id"]),
        })
        print(f"seed={rows[-1]['seed']} leaves={n_leaves} "
              f"geo/vla leaf={rows[-1]['leaf_geo']}/"
              f"{rows[-1]['leaf_vla']} strat={strat} conf={conf}",
              flush=True)
    wall = time.perf_counter() - t0

    agree = [r for r in rows if r["leaf_geo"] == r["leaf_vla"]]
    moved = [r for r in rows if r["leaf_geo"] != r["leaf_vla"]]
    shifts = [float(np.hypot(r["uv_geo"][0] - r["uv_vla"][0],
                             r["uv_geo"][1] - r["uv_vla"][1]))
              for r in moved]
    summary = {
        "scenes": len(rows), "frame": [h, w], "device": str(dev),
        "scorer": "llava_arch_lora (artifacts/vla/llava_arch_base.npz "
                  "+ llava_arch_adapter.npz)",
        "cnn": "artifacts/torch/grasp_cnn_hard deep + train_stats norm",
        "leaf_agreement": round(len(agree) / max(len(rows), 1), 4),
        "leaves_changed": len(moved),
        "px_shift_changed_mean": round(float(np.mean(shifts)), 2)
        if shifts else None,
        "px_shift_changed_max": round(float(np.max(shifts)), 2)
        if shifts else None,
        "strategy_distribution": strategies,
        "vla_fallback_frames": fallbacks,
        "wall_s": wall,
    }
    if args.check:
        with open(repo_path(args.check)) as fh:
            record = json.load(fh)
        summary.update(record=args.check, **check_rows(
            rows, prompts, record, range(100, 100 + args.scenes)))
    summary["rows"] = rows
    summary["prompts"] = prompts
    write_json(args.out or os.path.join(OUT_DIR,
                                        "system_accuracy_vla_torch.json"),
               summary)
    print_summary(summary, drop=("rows", "prompts"))
    return summary


if __name__ == "__main__":
    sys.exit(1 if main().get("mismatches") else 0)
