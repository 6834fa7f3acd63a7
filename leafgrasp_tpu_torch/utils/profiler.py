"""Per-stage timing and a ``torch.profiler`` hook, the port's own copy of
leafgrasp_tpu/utils/profiler.py.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

__all__ = ["StageTimer", "trace_to"]


class StageTimer:
    """Accumulates per-stage wall-clock stats on the host clock.

    It does not synchronize the device: a stage that only enqueues CUDA
    work reads as the time to enqueue it, and the wait lands in the
    stage that next reads a value back. The frame function reads values
    back several times per frame and the service fetches every result,
    so the service's stages end on finished work; time a bare kernel
    with CUDA events instead."""

    def __init__(self):
        self._sums: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)
        self._maxes: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)

    def record(self, name: str, seconds: float):
        self._sums[name] += seconds
        self._counts[name] += 1
        self._maxes[name] = max(self._maxes[name], seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "mean_ms": 1e3 * self._sums[name] / max(self._counts[name],
                                                        1),
                "max_ms": 1e3 * self._maxes[name],
                "count": self._counts[name],
                "total_s": self._sums[name],
            }
            for name in self._sums
        }

    def report(self) -> str:
        lines = [f"{'stage':24s} {'mean ms':>9s} {'max ms':>9s} {'n':>6s}"]
        for name, s in sorted(self.summary().items()):
            lines.append(f"{name:24s} {s['mean_ms']:9.2f} "
                         f"{s['max_ms']:9.2f} {s['count']:6d}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace_to(log_dir: Optional[str]):
    """Wrap a block in a ``torch.profiler`` trace when ``log_dir`` is
    given: CPU activity always, CUDA activity when a card is present.
    The Chrome trace lands in ``log_dir/trace.json``; the profile object
    is yielded (None without ``log_dir``)."""
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
