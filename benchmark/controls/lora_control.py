#!/usr/bin/env python3
"""Readings that set the LoRA training cell's limits, at the cell's own
size: for each seed, the program's first step against the plain
reference (the lower readings, as a run compares them); the reference
with every matrix rounded to float8 e4m3 per output channel, the
nearest precision below the configuration's bf16, against the reference
(the control); the reference with its adapters' products in bf16 and
the reference with TF32 products and convolutions, which stay nearer the
reference than the bf16 program does (beside it); and the reference fed
half of the batch, the mean taken over the rest, against the reference
(a fault). A step that leaves the adapters' state
unchanged reads 1 on ``grad1_rel`` where it takes no gradient, and 1 on
``change_med_rel`` whatever moments it fills (a learning rate of 0, an
update written to a copy): both by the measures' definitions, printed
here from the program's own first step with its change set to 0.

    python3 benchmark/controls/lora_control.py --seeds 11,12,13 \\
        [--controls fp8,adapters_bf16,tf32]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

from benchmark.core import spec  # noqa: E402
from benchmark.core.main import configure_torch  # noqa: E402
from benchmark.loops.train_lora import Setup  # noqa: E402
from benchmark.reference import lora_train  # noqa: E402


CONTROLS = {"fp8": dict(quantize="fp8"),
            "adapters_bf16": dict(adapter_dtype=torch.bfloat16),
            "tf32": dict(tf32=True)}


def readings(cell, seed: int, dev, overrides=None,
             controls=tuple(CONTROLS)) -> dict:
    su = Setup(cell, seed, dev, overrides or {})
    prog = su.prog
    su.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = su.reference()
    out = {"seed": seed, "reference_s": time.perf_counter() - t0,
           "loss": ref["loss"]}
    got = lora_train.compare(prog, ref)
    out.update({f"program_{k}": v for k, v in got.items()})
    for name in controls:
        got = lora_train.compare(su.reference(**CONTROLS[name]), ref)
        out.update({f"control_{name}_{k}": v for k, v in got.items()})
    half = su.bs // 2
    first = su.first
    su.first = first[:half]
    got = lora_train.compare(su.reference(), ref)
    su.first = first
    out.update({f"fault_half_batch_{k}": v for k, v in got.items()})
    still = {k: torch.zeros_like(v) for k, v in prog["change"].items()}
    got = lora_train.compare(dict(prog, change=still), ref)
    out["fault_state_unchanged_grad1_rel"] = lora_train.compare(
        dict(prog, grad={k: torch.zeros_like(v)
                         for k, v in prog["grad"].items()}), ref)["grad1_rel"]
    out["fault_state_unchanged_change_med_rel"] = got["change_med_rel"]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="lora.train.t642")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--overrides", default="{}")
    ap.add_argument("--controls", default=",".join(CONTROLS))
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    configure_torch(torch)
    cell = spec.resolve(args.workload)
    for s in args.seeds.split(","):
        print(json.dumps(readings(cell, int(s), dev,
                                  json.loads(args.overrides),
                                  args.controls.split(","))), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
