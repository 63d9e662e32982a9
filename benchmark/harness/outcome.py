"""What a driver is handed and what it gives back, and its progress lines."""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Run:
    cell: object  # spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device


@dataclass
class Outcome:
    window_start: float  # perf_counter at the first timed operation
    end_to_end: dict  # end-to-end metric name -> value (not setup_s)
    attempted: int
    failed: int
    # name -> (value, limit): each number that decides `correct`, which
    # holds when every value is at most its limit
    checks: dict
    memory_peak_bytes: int
    layer: dict = field(default_factory=dict)  # what the metric readers read
    trace: Optional[object] = None  # trace.Trace of the traced call
    spans: list = field(default_factory=list)  # labels of its idle gaps

    @property
    def correct(self) -> bool:
        return all(v <= limit for v, limit in self.checks.values())


def log(step: str, t0: float) -> float:
    """A progress line on standard error: the step and its seconds since
    t0.  Returns the time now."""
    now = time.perf_counter()
    print(f"{step}: {now - t0:.3f} s", file=sys.stderr, flush=True)
    return now
