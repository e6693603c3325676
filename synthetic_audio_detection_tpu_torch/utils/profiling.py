"""Tracing and stage timing (the port's counterpart of the reference
package's ``utils/profiling.py``).

- ``trace(logdir)``: context manager around ``torch.profiler`` (host
  activity, and the CUDA kernels where a GPU is present) that writes one
  Chrome trace (``*.pt.trace.json``, viewable in TensorBoard's profiler
  plugin or Perfetto) into ``logdir``; it yields the profiler, whose
  ``key_averages()`` sums the trace by name.
- ``span(name)``: a named range (``torch.profiler.record_function``) that
  nests into the trace; with no profiler running it is one shared
  ``nullcontext``, so a span costs one check. ``annotate`` is the same.
  The port's ranges: ``serve.*`` in ``infer/pipeline.py`` (one request's
  bucketing and padding, forward with its front end and backbone,
  device-to-host read-back and decision) and ``train_step.*``
  in ``train/steps.py``, ``train/joint.py`` and ``train/trainer.py``
  (features, forward, backward, optimizer, and the feed of each batch).
- ``count(name, n)``: adds to a process-wide table of ints, whether or not
  a profiler runs; ``counters()`` returns a copy and ``reset_counters()``
  clears it. The pipeline counts ``serve.batches``, ``serve.rows`` (the
  buckets' rows, padding included), ``serve.useful_rows`` and
  ``serve.prefetched_batches`` (the batches staged while the batch before
  computed). A count is a dict add without a lock: the daemon's
  dispatches, which run under ``ServingState.dispatching()``'s lock, count
  one at a time.
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
from torch.autograd import profiler as autograd_profiler


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


_OFF = contextlib.nullcontext()
_COUNTS: Dict[str, int] = {}


def span(name: str):
    """Named host range that nests into profiler traces; the shared null
    context when no profiler is running. The check is the flag that
    ``torch.profiler`` sets for the whole process: the thread-local
    ``torch.autograd._profiler_enabled()`` reads False under a profiler
    that records every thread (``profile_all_threads``)."""
    if not autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


annotate = span


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the process-wide counter ``name``."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A copy of the process-wide counters."""
    return dict(_COUNTS)


def reset_counters() -> None:
    _COUNTS.clear()


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
