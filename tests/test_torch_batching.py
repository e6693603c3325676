"""The port's copy of the micro-batcher (``infer/batching.py``) under the
JAX package's own batcher tests, and beside the original on one gated
arrival pattern: the same dispatches, in the same sizes, with the same
rows routed back."""

import threading
import time

import numpy as np
import pytest

import tests.test_batching as reference_cases
from synthetic_audio_detection_tpu.infer.batching import MicroBatcher as JaxBatcher
from synthetic_audio_detection_tpu_torch.infer.batching import MicroBatcher as PortBatcher

CASES = sorted(n for n in dir(reference_cases) if n.startswith("test_"))


def test_every_reference_case_is_collected():
    assert len(CASES) == 7


@pytest.mark.parametrize("case", CASES)
def test_reference_case_on_the_port(case, monkeypatch):
    """Each case of tests/test_batching.py, its batcher swapped for the
    port's copy."""
    monkeypatch.setattr(reference_cases, "MicroBatcher", PortBatcher)
    getattr(reference_cases, case)()


def _gated_run(cls, sizes, max_windows):
    """The first item blocks the forward until the rest are queued, in
    order; → (the forward's row counts, each caller's logits)."""
    gate, entered, calls = threading.Event(), threading.Event(), []

    def forward(windows):
        calls.append(windows.shape[0])
        if len(calls) == 1:
            entered.set()
            gate.wait(timeout=30)
        return reference_cases.fake_forward(windows)

    b = cls(forward, max_windows=max_windows)
    arrays = [np.full((n, 4), i, np.float32) for i, n in enumerate(sizes)]
    results = [None] * len(arrays)

    def run(i):
        results[i] = b.logits(arrays[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(arrays))]
    try:
        threads[0].start()
        assert entered.wait(timeout=10)
        for t in threads[1:]:
            t.start()
            time.sleep(0.03)  # keep the queue in submission order
        gate.set()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
    finally:
        b.stop()
    return calls, results


@pytest.mark.parametrize("sizes,max_windows", [([1, 3, 3, 9, 2, 2], 5), ([2] * 9, 8),
                                               ([4, 1, 7, 1, 1], 128)])
def test_port_dispatches_as_the_reference(sizes, max_windows):
    ref_calls, ref_out = _gated_run(JaxBatcher, sizes, max_windows)
    calls, out = _gated_run(PortBatcher, sizes, max_windows)
    assert calls == ref_calls
    for a, b in zip(out, ref_out):
        np.testing.assert_array_equal(a, b)
