"""The port's ``utils/profiling.py``: ``StageTimer`` against the JAX
package's on a fixed clock, and ``trace`` writing a trace file on the CPU
with the annotated ranges in it."""

import json
import os

import pytest
import torch

from synthetic_audio_detection_tpu.utils import profiling as jprof
from synthetic_audio_detection_tpu_torch.utils import profiling


class _Clock:
    """perf_counter stand-in: each stage lasts the next of ``durations``."""

    def __init__(self, durations):
        self.t, self.durations, self.calls = 0.0, list(durations), 0

    def __call__(self):
        self.calls += 1
        if self.calls % 2 == 0:  # the stage's end
            self.t += self.durations.pop(0)
        return self.t


@pytest.mark.parametrize("alpha", [0.2, 0.5])
def test_stage_timer_matches_jax_on_a_fixed_clock(monkeypatch, alpha):
    stages = ["decode", "mel+model", "decode", "decode", "json", "mel+model"]
    durations = [0.012, 0.25, 0.018, 0.011, 0.0005, 0.31]
    timers = []
    for mod in (profiling, jprof):
        monkeypatch.setattr(mod.time, "perf_counter", _Clock(durations))
        t = mod.StageTimer(alpha=alpha)
        for name in stages:
            with t.stage(name):
                pass
        monkeypatch.undo()
        timers.append(t)
    port, ref = timers
    assert port.totals == ref.totals and port.counts == ref.counts and port.ewma == ref.ewma
    assert port.report() == ref.report()
    assert port.report().splitlines()[0].startswith("decode: total 0.041s over 3 calls")


def test_trace_writes_a_trace_with_the_annotations(tmp_path):
    logdir = str(tmp_path / "trace")
    timer = profiling.StageTimer()
    with profiling.trace(logdir) as prof:
        with timer.stage("feature"):
            x = torch.randn(64, 64)
        with profiling.annotate("matmul-range"):
            (x @ x).sum()
    files = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(os.path.join(logdir, files[0])) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"feature", "matmul-range"} <= names
    assert any(e.key == "matmul-range" for e in prof.key_averages())
    assert timer.counts == {"feature": 1}
