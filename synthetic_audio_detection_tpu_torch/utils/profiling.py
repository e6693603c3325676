"""Tracing and stage timing (the port's counterpart of the reference
package's ``utils/profiling.py``).

- ``trace(logdir)``: context manager around ``torch.profiler`` (host
  activity, and the CUDA kernels where a GPU is present) that writes one
  Chrome trace (``*.pt.trace.json``, viewable in TensorBoard's profiler
  plugin or Perfetto) into ``logdir``; it yields the profiler, whose
  ``key_averages()`` sums the trace by name.
- ``annotate(name)``: a named range (``torch.profiler.record_function``)
  that nests into the trace.
- ``StageTimer``: named wall-clock stages with EWMA smoothing for
  steady-state reporting (a copy of the reference's).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile everything inside the block into a trace file in ``logdir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)) as prof:
        yield prof


def annotate(name: str):
    """Named host range that nests into profiler traces."""
    return torch.profiler.record_function(name)


@dataclass
class StageTimer:
    """Named stage timers with exponential smoothing.

    Usage:
        t = StageTimer()
        with t.stage("decode"): ...
        with t.stage("mel+model"): ...
        print(t.report())
    """

    alpha: float = 0.2
    ewma: Dict[str, float] = field(default_factory=dict)
    totals: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        with annotate(name):
            yield
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1
        prev = self.ewma.get(name)
        self.ewma[name] = dt if prev is None else prev + self.alpha * (dt - prev)

    def report(self) -> str:
        lines = []
        for name in self.totals:
            n = self.counts[name]
            lines.append(
                f"{name}: total {self.totals[name]:.3f}s over {n} calls "
                f"(mean {self.totals[name] / n * 1e3:.1f} ms, "
                f"ewma {self.ewma[name] * 1e3:.1f} ms)"
            )
        return "\n".join(lines)
