"""The host around a run's window, read from ``/proc`` as facts: the
share of its CPUs' time that the hypervisor gave to others (steal) and
that any process kept busy, the load, the CPUs' clock. They print beside
a run's result, so a slow run can be told from a slow host. Readings
that ``/proc`` does not offer are left out."""

from __future__ import annotations

import os
import time
from typing import Dict, Optional


def _cpu_times() -> Optional[list]:
    try:
        with open("/proc/stat") as fh:
            fields = fh.readline().split()
    except OSError:
        return None
    if len(fields) < 9 or fields[0] != "cpu":
        return None
    return [int(v) for v in fields[1:9]]


def _mean_mhz() -> Optional[float]:
    try:
        with open("/proc/cpuinfo") as fh:
            mhz = [float(line.split(":")[1]) for line in fh
                   if line.startswith("cpu MHz")]
    except (OSError, ValueError, IndexError):
        return None
    return sum(mhz) / len(mhz) if mhz else None


def snapshot() -> dict:
    return {"cpu": _cpu_times(), "t": time.perf_counter(),
            "mhz": _mean_mhz()}


def window_facts(a: dict, b: dict) -> Dict[str, float]:
    """Host facts over the time from snapshot ``a`` to ``b``."""
    out: Dict[str, float] = {"host_cpus": float(os.cpu_count() or 0),
                             "host_cpus_allowed": float(
                                 len(os.sched_getaffinity(0)))}
    if a["cpu"] and b["cpu"]:
        d = [y - x for x, y in zip(a["cpu"], b["cpu"])]
        total = sum(d)
        if total > 0:
            # user nice system idle iowait irq softirq steal
            out["host_steal_pct"] = 100.0 * d[7] / total
            out["host_busy_pct"] = 100.0 * (total - d[3] - d[4]) / total
    try:
        out["host_load1"] = os.getloadavg()[0]
    except OSError:
        pass
    if a["mhz"] and b["mhz"]:
        out["host_mhz"] = 0.5 * (a["mhz"] + b["mhz"])
    return out
