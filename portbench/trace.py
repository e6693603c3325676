"""Spans, and the reading of the profiler's trace.

A span is a ``record_function`` range named ``portbench.<layer>`` that the
harness opens around its calls into a layer (the program's own
``train_step.*`` ranges are read the same way). It costs nothing unless
the run traces. The trace is read from the profiler's raw events, without
building PyTorch's event tree: each device event (kernel, copy, set) is
tied to the host event that launched it (its linked correlation id names
the operator or range that was open at the launch; the runtime call's own
correlation id is the fallback), and a layer's device time is the time of
the device events launched inside that layer's spans on the same thread.
The busy time is the union of the device events inside the window span;
the idle gaps are labelled by the innermost span open on the host at each
gap's midpoint.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

PREFIXES = ("portbench.", "train_step.")
WINDOW = "portbench.window"


def union_length(intervals: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def gaps(intervals: Sequence[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi) that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


@dataclass
class DeviceEvent:
    name: str
    start: float   # seconds, the trace's clock
    end: float
    tid: int       # launching host thread, 0 when unknown
    launch: float  # host time of the launch


@dataclass
class Span:
    name: str
    tid: int
    start: float
    end: float


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    span_device_s: Dict[str, float]
    device_by_name: Dict[str, float]
    gap_by_host: Dict[str, float]
    h2d_s: float
    unattributed_s: float
    counts: Dict[str, int] = field(default_factory=dict)

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        def best(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": best(self.device_by_name), "idle_gaps": best(self.gap_by_host)}


def summarize(device: List[DeviceEvent], spans: List[Span]) -> TraceSummary:
    """Reduce events to the window's busy time, each span name's device
    time, device time by kernel name and idle time by host span."""
    windows = [s for s in spans if s.name == WINDOW]
    if not windows:
        raise RuntimeError("the trace holds no window span")
    lo, hi = windows[0].start, windows[0].end
    inside = [e for e in device if e.end > lo and e.start < hi]
    clipped = [(max(e.start, lo), min(e.end, hi)) for e in inside]
    by_key: Dict[Tuple[str, int], Tuple[List[float], List[float]]] = {}
    for s in sorted(spans, key=lambda s: s.start):
        starts, ends = by_key.setdefault((s.name, s.tid), ([], []))
        starts.append(s.start)
        ends.append(s.end)
    names = sorted({s.name for s in spans} - {WINDOW})
    span_s = {n: 0.0 for n in names}
    by_name: Dict[str, float] = defaultdict(float)
    h2d = unattributed = 0.0
    for e, (s, t) in zip(inside, clipped):
        d = t - s
        by_name[e.name] += d
        if "HtoD" in e.name:
            h2d += d
        hit = False
        for n in names:
            key = (n, e.tid)
            if key not in by_key:
                continue
            starts, ends = by_key[key]
            i = bisect.bisect_right(starts, e.launch) - 1
            if i >= 0 and e.launch <= ends[i]:
                span_s[n] += d
                hit = True
        unattributed += 0.0 if hit else d
    # each gap goes to the innermost span name open at its midpoint: names
    # tried from the shortest mean span up, each by bisection
    host: Dict[str, float] = defaultdict(float)
    merged: Dict[str, Tuple[List[float], List[float]]] = {}
    mean: Dict[str, float] = {}
    for n in names:
        mine = sorted((s.start, s.end) for s in spans if s.name == n)
        merged[n] = ([a for a, _ in mine], [b for _, b in mine])
        mean[n] = sum(b - a for a, b in mine) / len(mine)
    order = sorted(names, key=mean.get)
    for a, b in gaps(clipped, lo, hi):
        mid, label = 0.5 * (a + b), "host outside spans"
        for n in order:
            starts, ends = merged[n]
            i = bisect.bisect_right(starts, mid) - 1
            if i >= 0 and max(ends[max(0, i - 63):i + 1]) >= mid:
                label = n
                break
        host[label] += b - a
    return TraceSummary(window_s=hi - lo, busy_s=union_length(clipped), span_device_s=span_s,
                        device_by_name=dict(by_name), gap_by_host=dict(host), h2d_s=h2d,
                        unattributed_s=unattributed,
                        counts={"device_events": len(inside), "spans": len(spans)})


def _kind(e, cuda) -> str:
    """The kineto activity type; older PyTorch has no accessor for it, and
    the runtime calls are then known by their names."""
    f = getattr(e, "activity_type", None)
    if f is not None:
        return f()
    if e.device_type() == cuda:
        return "device"
    return "cuda_runtime" if e.name().startswith(("cuda", "cu")) else "cpu_op"


def read_events(result) -> Tuple[List[DeviceEvent], List[Span], Dict[str, int]]:
    """The profiler's raw kineto events → device events tied to their
    launch, the harness's and the program's spans, and counts by activity
    type (for a look at what the trace held)."""
    cuda = torch.autograd.DeviceType.CUDA
    ops: Dict[int, Tuple[int, float]] = {}
    runtime: Dict[int, Tuple[int, float]] = {}
    spans: List[Span] = []
    raw_dev = []
    kinds: Dict[str, int] = defaultdict(int)
    for e in result.events():
        kind = _kind(e, cuda)
        kinds[kind] += 1
        start = e.start_ns() * 1e-9
        if e.device_type() == cuda:
            if e.name().startswith(PREFIXES):  # a range's mirror on the device timeline
                continue
            raw_dev.append((e.name(), start, start + e.duration_ns() * 1e-9,
                            e.linked_correlation_id(), e.correlation_id()))
            continue
        if kind in ("cuda_runtime", "cuda_driver"):
            runtime[e.correlation_id()] = (e.start_thread_id(), start)
            continue
        ops[e.correlation_id()] = (e.start_thread_id(), start)
        name = e.name()
        if name.startswith(PREFIXES):
            spans.append(Span(name, e.start_thread_id(), start, start + e.duration_ns() * 1e-9))
    device = []
    for name, s, t, linked, corr in raw_dev:
        tid, at = ops.get(linked) or runtime.get(corr) or (0, s)
        device.append(DeviceEvent(name, s, t, tid, at))
    kinds["device_linked"] = sum(1 for *_, linked, _ in raw_dev if linked in ops)
    kinds["device_by_runtime"] = sum(1 for *_, linked, corr in raw_dev
                                     if linked not in ops and corr in runtime)
    return device, spans, dict(kinds)


class Tracer:
    """Spans for the harness's wrappers, and with ``on`` the profiler over
    the window."""

    def __init__(self, on: bool):
        self.on = on
        self._prof = None

    def span(self, layer: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function("portbench." + layer)

    @contextlib.contextmanager
    def window(self) -> Iterator[None]:
        """Profile (when on) everything inside, under the window span."""
        if not self.on:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        try:  # every thread's operators, not only this one's (the daemon's dispatcher)
            extra = {"experimental_config": torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True)}
        except (AttributeError, TypeError):
            extra = {}
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], **extra)
        self._prof.__enter__()
        try:
            with torch.profiler.record_function(WINDOW):
                yield
                torch.cuda.synchronize()
        finally:
            self._prof.__exit__(None, None, None)

    def summary(self) -> Optional[TraceSummary]:
        if self._prof is None:
            return None
        t0 = time.perf_counter()
        device, spans, kinds = read_events(self._prof.profiler.kineto_results)
        if not device:
            raise RuntimeError("the profiler recorded no device activity")
        s = summarize(device, spans)
        s.counts.update(kinds)
        s.counts["read_ms"] = int(1e3 * (time.perf_counter() - t0))
        self._prof = None
        return s


def sync(device) -> None:
    """Wait for the device (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
