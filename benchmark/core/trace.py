"""The traced window: ``torch.profiler`` over a leading part of the
measured window, reduced to device busy time, device operations by name,
kernel time by name, and the device's idle gaps labelled by the
benchmark's own span that the host was in.

Spans are ``torch.profiler.record_function`` ranges opened by the
harness around its calls into the program (``span(name)``); their names
start with ``bench:``. They cost nothing when no profiler runs.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

SPAN_PREFIX = "bench:"


@contextlib.contextmanager
def span(name: str):
    """A host span of the benchmark's own, seen by the profiler only."""
    import torch
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


@dataclass
class TraceSummary:
    window_s: float                  # host seconds of the traced window
    busy_s: float                    # union of device-op intervals
    n_device_ops: int
    items: int                       # frames or steps inside the window
    op_seconds: Dict[str, float] = field(default_factory=dict)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def kernel_seconds(self, *fragments: str) -> float:
        """Device seconds of the operations whose name holds any of
        ``fragments``."""
        return sum(s for n, s in self.op_seconds.items()
                   if any(f in n for f in fragments))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.op_seconds.items(), key=lambda kv: -kv[1])[:top]
        ops = [(n if len(n) <= 160 else n[:157] + "...", s) for n, s in ops]
        gaps = sorted(self.idle_gaps, key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _host_span_at(spans, t):
    """The innermost benchmark span covering host time ``t``."""
    best, best_len = "outside any span", None
    for name, a, b in spans:
        if a <= t <= b and (best_len is None or b - a < best_len):
            best, best_len = name, b - a
    return best


def reduce_events(events, t0_ns: int, t1_ns: int, items: int,
                  gap_floor_ns: int = 20_000) -> TraceSummary:
    """Reduce kineto events (``prof.profiler.kineto_results.events()``)
    of a window from ``t0_ns`` to ``t1_ns`` (the profiler's clock) to a
    summary. Device operations are the events on a CUDA device other
    than annotations. Gaps shorter than ``gap_floor_ns`` are left out of
    the gap list (they still count as idle)."""
    dev, spans = [], []
    for e in events:
        name = e.name()
        is_dev = "CUDA" in str(e.device_type())
        if name.startswith(SPAN_PREFIX):
            if not is_dev:
                spans.append((name[len(SPAN_PREFIX):], e.start_ns(),
                              e.start_ns() + e.duration_ns()))
            continue
        if not is_dev or e.is_user_annotation():
            continue
        a = max(e.start_ns(), t0_ns)
        b = min(e.start_ns() + e.duration_ns(), t1_ns)
        if b > a:
            dev.append((name, a, b))
    op_ns: Dict[str, int] = {}
    for name, a, b in dev:
        op_ns[name] = op_ns.get(name, 0) + (b - a)
    merged = _merge([(a, b) for _, a, b in dev])
    busy = sum(b - a for a, b in merged)
    gaps = []
    edges = [t0_ns] + [x for ab in merged for x in ab] + [t1_ns]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b - a >= gap_floor_ns:
            gaps.append((_host_span_at(spans, (a + b) // 2), (b - a) / 1e9))
    by_span: Dict[str, float] = {}
    for name, s in gaps:
        by_span[name] = by_span.get(name, 0.0) + s
    return TraceSummary(
        window_s=(t1_ns - t0_ns) / 1e9, busy_s=busy / 1e9,
        n_device_ops=len(dev), items=items,
        op_seconds={n: v / 1e9 for n, v in op_ns.items()},
        idle_gaps=sorted(by_span.items(), key=lambda kv: -kv[1]))


class Tracer:
    """``with Tracer() as tr: ...`` profiles the block (CPU and CUDA
    activity) and synchronizes the card at its end; ``tr.reduce(items)``
    then gives its ``TraceSummary``."""

    def __init__(self):
        self._events = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._torch = torch
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        # a profile late in a long process has been seen to lose its
        # first records: a lead-in of torch's spin kernel, outside the
        # window, takes that loss
        if torch.cuda.is_available():
            for _ in range(8):
                torch.cuda._sleep(100_000)
            torch.cuda.synchronize()
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self._torch.cuda.is_available():
            self._torch.cuda.synchronize()
        t1 = time.time_ns()
        self._t1 = t1
        self._prof.__exit__(*exc)
        return False

    def reduce(self, items: int) -> TraceSummary:
        events = self._prof.profiler.kineto_results.events()
        summary = reduce_events(events, self._t0, self._t1, items)
        self._prof = None
        return summary
