"""``BENCHMARK.json`` and the files it names, resolved by name.

A cell (``workloads`` entry) names a configuration and a traffic mix.
The configuration's file is ``configs/<name>.json`` (the ``file`` key
of its entry), the mix's is ``traffic/<name>.json``, the cell's limits
on the numbers compared with the reference are ``limits/<cell>.json``,
and each metric's reader is ``metrics/<name>.py``. Nothing else in the
harness knows a cell, a mix or a metric by name.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
SPEC_PATH = os.path.join(ROOT, "BENCHMARK.json")


@dataclass
class Cell:
    name: str
    config: dict            # the configuration's file, with "name"
    traffic: dict           # the mix's file, with "name"
    chips: int
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)
    limits: Dict[str, float] = field(default_factory=dict)


def load_spec(path: str = SPEC_PATH) -> dict:
    with open(path) as fh:
        return json.load(fh)


def traffic_path(name: str) -> str:
    return os.path.join(HERE, "traffic", f"{name}.json")


def limits_path(name: str) -> str:
    return os.path.join(HERE, "limits", f"{name}.json")


def metric_path(name: str) -> str:
    return os.path.join(HERE, "metrics", f"{name}.py")


def applies(metric: dict, cell: str, reported: set) -> bool:
    """Whether a metric belongs in ``cell``'s line: it lists the cell, or
    it lists no cells and the end-to-end metric it moves is reported
    there (an end-to-end metric without ``workloads`` is everywhere)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or moves in reported


def resolve(workload: str, spec: dict | None = None) -> Cell:
    """The cell named ``workload`` with its configuration, mix and
    metrics; ``KeyError`` if BENCHMARK.json has no such cell."""
    spec = load_spec() if spec is None else spec
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    centry = configs[w["config"]]
    with open(os.path.join(ROOT, centry["file"])) as fh:
        config = dict(json.load(fh), name=centry["name"])
    with open(traffic_path(w["traffic"])) as fh:
        traffic = dict(json.load(fh), name=w["traffic"])
    e2e = [m for m in spec["end_to_end"] if applies(m, workload, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if applies(m, workload, reported)]
    with open(limits_path(workload)) as fh:
        limits = json.load(fh)["limits"]
    return Cell(name=workload, config=config, traffic=traffic,
                chips=int(w["chips"]), end_to_end=e2e, per_layer=per_layer,
                limits=limits)


def metric_files(spec: dict) -> Dict[str, str]:
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    return {n: metric_path(n) for n in names}
