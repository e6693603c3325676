"""The reader (``trace.summarize``) on the program's training ranges, and
the two metrics built on them (``feed_idle_ms.train``,
``backward_idle_ms.train``), on a synthetic trace."""

import pytest

from portbench import run, trace


def _train_trace(with_program_ranges: bool):
    """Two steps on the bench's clock: the ``step`` span (tid 7) around, with
    the program's ranges, the feed (0.0-0.3 of each step), the forward
    (0.3-0.5) and the backward (0.5-0.9, its kernels launched by autograd's
    thread, tid 9); the device idles in the feed after 0.1 and in the
    backward between 0.6 and 0.8."""
    spans = [trace.Span(trace.WINDOW, 7, 0.0, 2.0)]
    dev = []
    for t in (0.0, 1.0):
        spans.append(trace.Span("portbench.step", 7, t, t + 1.0))
        if with_program_ranges:
            spans += [trace.Span("train_step.feed", 7, t, t + 0.3),
                      trace.Span("train_step.forward", 7, t + 0.3, t + 0.5),
                      trace.Span("train_step.backward", 7, t + 0.5, t + 0.9)]
        dev += [trace.DeviceEvent("Memcpy HtoD (Pinned -> Device)", t, t + 0.1, 7, t),
                trace.DeviceEvent("fwd", t + 0.3, t + 0.6, 7, t + 0.3),
                trace.DeviceEvent("bwd", t + 0.8, t + 1.0, 9, t + 0.55)]
    return trace.summarize(dev, spans)


def test_the_reader_labels_idle_by_the_training_ranges_and_the_metrics_read_it_per_step():
    s = _train_trace(True)
    assert s.gap_by_host == pytest.approx({"train_step.feed": 2 * 0.2,
                                           "train_step.backward": 2 * 0.2})
    assert "portbench.step" not in s.gap_by_host
    # the backward's kernels come from another thread: the same-thread reading misses them
    assert s.span_device_s["train_step.backward"] == 0.0
    assert s.unattributed_s == pytest.approx(2 * 0.2)
    ctx = {"trace": s, "run": {"steps": 2}}
    assert run.metric_module("feed_idle_ms.train").read(ctx) == pytest.approx(200.0)
    assert run.metric_module("backward_idle_ms.train").read(ctx) == pytest.approx(200.0)
    parent = {"trace": _train_trace(False), "run": {"steps": 2}}
    assert parent["trace"].gap_by_host == pytest.approx({"portbench.step": 0.8})
    for name in ("feed_idle_ms.train", "backward_idle_ms.train"):
        for ctx in (parent, {"trace": None, "run": {"steps": 2}}, {"trace": s, "run": {}}):
            assert run.metric_module(name).read(ctx) is None
