#!/usr/bin/env python3
"""Readings that set the CNN training cell's limits, at the cell's own
size: for each seed, the program's first steps against the plain
reference (the lower readings, as a run compares them), the reference
with TF32 products and convolutions against the reference (the
control), and the reference fed half of each batch, the mean taken over
the rest, against the reference (a fault). A step that returns its state
unchanged reads 1 on ``change_rel`` by the measure's definition.

    python3 benchmark/controls/train_control.py \\
        --workload cnn.train.b16 --seeds 11,12,13
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

from benchmark.core import spec  # noqa: E402
from benchmark.core.main import configure_torch  # noqa: E402
from benchmark.loops.train_cnn import Setup  # noqa: E402
from benchmark.reference import cnn_train  # noqa: E402


def _as_prog(ref: dict) -> dict:
    """A reference run read as the program's readings are read."""
    return {"losses": ref["losses"],
            "taken_grad": cnn_train.leaf_norms(ref["taken_grad"]),
            "change": cnn_train.leaf_norms(ref["change"])}


def diagnose(prog: dict, ref: dict, top: int = 4) -> dict:
    """The leaves that read worst on each number, with their sizes and
    their raw reference gradient's share of the median leaf's, and each
    step's loss gap: where a reading comes from."""
    raw = cnn_train.leaf_norms(ref["raw_grad"])
    med = sorted(raw.values())[len(raw) // 2]
    out = {"loss_gaps": [abs(a - b) / abs(b) for a, b in
                         zip(prog["losses"], ref["losses"])]}
    for key in ("taken_grad", "change"):
        gaps = cnn_train.leaf_gaps(prog[key], cnn_train.leaf_norms(ref[key]))
        worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        out[key] = [[k, g, ref["change"][k].numel(), raw[k] / med]
                    for k, g in worst]
    return out


def readings(cell, seed: int, dev, overrides=None, diag=False) -> dict:
    su = Setup(cell, seed, dev, overrides or {})
    su.release()
    ref = su.reference()
    if diag:
        return {"program": cnn_train.compare(su.prog, ref),
                "diagnosis": diagnose(su.prog, ref)}
    half = [(x[: x.shape[0] // 2], y[: y.shape[0] // 2])
            for x, y in su.batches]
    return {"program": cnn_train.compare(su.prog, ref),
            "control_tf32": cnn_train.compare(_as_prog(su.reference(
                tf32=True)), ref),
            "fault_half_batch": cnn_train.compare(_as_prog(su.reference(
                batches=half)), ref)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="cnn.train.b16")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--overrides", default="{}")
    ap.add_argument("--diagnose", action="store_true",
                    help="the worst leaves and each step's loss gap, "
                         "instead of the control and the fault")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    configure_torch(torch)
    cell = spec.resolve(args.workload)
    for s in args.seeds.split(","):
        print(json.dumps({"seed": int(s), **readings(
            cell, int(s), dev, json.loads(args.overrides),
            args.diagnose)}), flush=True)


if __name__ == "__main__":
    main()
