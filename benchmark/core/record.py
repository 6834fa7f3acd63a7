"""What a run hands to the metric readers and to the final line."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from benchmark.core.trace import TraceSummary


@dataclass
class Limit:
    """One number compared with the plain reference, beside its limit:
    the run is correct only if every ``value <= limit``."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Run:
    kind: str                       # "serve" or "train"
    setup_s: float
    window_s: float
    attempted: int
    failed: int
    memory_peak_bytes: int
    item_s: List[float] = field(default_factory=list)   # each frame's s
    steps: int = 0                  # optimizer steps in the window
    stages: Dict[str, Dict[str, float]] = field(default_factory=dict)
    host_reads: int = 0
    vla: List[dict] = field(default_factory=list)       # scorer.last
    trace: Optional[TraceSummary] = None
    work: Dict[str, float] = field(default_factory=dict)
    facts: Dict[str, float] = field(default_factory=dict)
    # frees the program's state, then compares with the reference
    check: Callable[[], List[Limit]] = lambda: []
