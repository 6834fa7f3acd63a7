"""One run of one cell: set-up, the measured window, the readers, the
comparison with the plain reference, and the last line.

    python3 benchmark/run.py --workload W --seed N --seconds S --trace 0|1

With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (a leading part of the window runs
under ``torch.profiler``). The numbers compared with the reference are
printed last on standard error and as the line's last key, ``limits``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys

from benchmark.core import guard, spec
from benchmark.core.record import Run

def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_reader(name: str):
    path = spec.metric_path(name)
    mod_spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def read_metrics(run: Run, metrics) -> dict:
    """{name: {"value", "unit"}} of every metric whose reader found
    something to read."""
    out = {}
    for m in metrics:
        value = load_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def power_limit(index: int = 0) -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return res.stdout.strip().splitlines()[0] if res.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def configure_torch(torch) -> None:
    """What every run of every cell fixes: the configurations state
    float32, so neither products nor convolutions take TF32; one host
    thread for torch's CPU operations."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)


def run_cell(cell, seed: int, seconds: float, trace: bool, dev,
             t_start: float, overrides=None) -> Run:
    loop = importlib.import_module(f"benchmark.loops.{cell.traffic['loop']}")
    return loop.run(cell, seed, seconds, trace, dev, t_start,
                    overrides or {})


def result_line(cell, run: Run, limits, trace: bool, device: dict) -> dict:
    metrics = read_metrics(run, cell.per_layer if trace else cell.end_to_end)
    line = {"correct": all(l.ok for l in limits) and bool(limits),
            "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        line["device"]["busy_s"] = run.trace.busy_s
        line["device"]["window_s"] = run.trace.window_s
        line["breakdown"] = run.trace.breakdown()
    line["limits"] = {l.name: {"value": l.value, "limit": l.limit}
                      for l in limits}
    return line


def main(argv=None, t_start: float = 0.0) -> int:
    args = parse(argv)
    cell = spec.resolve(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    configure_torch(torch)
    run = run_cell(cell, args.seed, args.seconds, bool(args.trace), dev,
                   t_start)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": cell.chips,
              "memory_peak_bytes": run.memory_peak_bytes,
              "power_limit": power_limit(dev.index or 0)}
    limits = run.check()
    line = result_line(cell, run, limits, bool(args.trace), device)
    found = guard.forbidden_loaded()
    if found:
        print("forbidden modules loaded: " + ", ".join(found),
              file=sys.stderr)
        return 4
    for k, v in run.facts.items():
        print(f"fact {k} {v!r}", file=sys.stderr)
    for l in limits:
        print(f"{l.name} {l.value!r} limit {l.limit!r} "
              f"{'ok' if l.ok else 'FAIL'}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
