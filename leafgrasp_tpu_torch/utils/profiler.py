"""The port's spans: per-stage timing on the host clock, and ranges in a
``torch.profiler`` trace while one runs.

``StageTimer`` accumulates each stage's durations. ``span(name)`` records
a block into the timer bound to the current context
(``StageTimer.bound()``), so code deep inside the frame function or the
VLA records into its caller's timer without being handed it; with no
timer bound it does nothing. While a profiler runs, a stage or span also
opens ``torch.profiler.record_function(SPAN_PREFIX + name)``, so
the trace shows it on the profiler's clock beside the device's kernels,
nested as the code nests.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from contextvars import ContextVar
from typing import Dict, Optional

import torch

__all__ = ["SPAN_PREFIX", "StageTimer", "span"]

SPAN_PREFIX = "leafgrasp:"

_ACTIVE: ContextVar[Optional["StageTimer"]] = ContextVar(
    "leafgrasp_stage_timer", default=None)
_NULL = contextlib.nullcontext()


class _Stage:
    """One timed block: its host-clock duration into ``timer``, and a
    profiler range around it while a profiler runs (none is built
    otherwise)."""

    __slots__ = ("timer", "name", "t0", "range")

    def __init__(self, timer: "StageTimer", name: str):
        self.timer, self.name = timer, name

    def __enter__(self):
        self.range = None
        if torch.autograd.profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function(
                SPAN_PREFIX + self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self.t0
        if self.range is not None:
            self.range.__exit__(*exc)
        self.timer.record(self.name, seconds)
        return False


class StageTimer:
    """Accumulates per-stage wall-clock stats on the host clock.

    It does not synchronize the device: a stage that only enqueues CUDA
    work reads as the time to enqueue it, and the wait lands in the
    stage that next reads a value back. The frame function reads values
    back several times per frame and the service fetches every result,
    so the service's stages end on finished work; time a bare kernel
    with CUDA events instead. ``record`` is safe from several threads
    (the service's callbacks run on others than its processing)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sums: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)
        self._maxes: Dict[str, float] = defaultdict(float)

    def stage(self, name: str) -> _Stage:
        """Time a block into this timer, bound or not."""
        return _Stage(self, name)

    @contextlib.contextmanager
    def bound(self):
        """Make this timer the one ``span`` records into, for the block
        and in this context only (another thread has its own)."""
        token = _ACTIVE.set(self)
        try:
            yield self
        finally:
            _ACTIVE.reset(token)

    def record(self, name: str, seconds: float):
        with self._lock:
            self._sums[name] += seconds
            self._counts[name] += 1
            self._maxes[name] = max(self._maxes[name], seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                name: {
                    "mean_ms": 1e3 * self._sums[name]
                    / max(self._counts[name], 1),
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


def span(name: str):
    """Time a block into the timer bound to this context, as
    ``StageTimer.stage`` does; with none bound, do nothing."""
    timer = _ACTIVE.get()
    if timer is None:
        return _NULL
    return _Stage(timer, name)
