"""Tiny sizes of each cell for the CPU tests, and one run of a cell at
its tiny size past the card check."""

import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TINY_FRAME = {"frame_height": 180, "frame_width": 240, "pool_scenes": 4,
              "cycle_frames": 6, "warmup_frames": 1, "check_frames": 3,
              "roll_px": 20, "margin_px": [20, 40], "leaves": [2, 5],
              "trace_frames": 2}
TINY_LLAVA = {"vis_hidden": 16, "vis_intermediate": 32, "vis_layers": 2,
              "vis_heads": 2, "image_size": 28, "patch_size": 14,
              "vocab_size": 128, "hidden": 32, "intermediate": 64,
              "layers": 2, "heads": 4, "kv_heads": 2,
              "image_token_index": 100,
              "image_grid_pinpoints": [[28, 56], [56, 28], [56, 56]]}
TINY_VLA = dict(TINY_FRAME, cycle_frames=4, check_frames=2,
                check_reranks=2, leaves=[3, 6], llava=TINY_LLAVA)
TINY_TRAIN = {"corpus": 120, "trace_steps": 3}
TINY = {"frame.union.mixed": TINY_FRAME, "vla.anyres.bf16": TINY_VLA,
        "cnn.train.b16": TINY_TRAIN}


def tiny_run(name, seed=7, seconds=0.5, trace=False, cell=None):
    """One run of a cell at its tiny size on the CPU, as ``run.py``
    drives it past the card check: (run, limits, line)."""
    import torch
    from benchmark.core import main, spec
    torch.set_num_threads(2)
    cell = cell or spec.resolve(name)
    run = main.run_cell(cell, seed, seconds, trace, torch.device("cpu"),
                        0.0, json.loads(json.dumps(TINY[name])))
    limits = run.check()
    line = main.result_line(cell, run, limits, trace,
                            {"platform": "cpu", "kind": "cpu", "count": 1,
                             "memory_peak_bytes": 0})
    return run, limits, line
