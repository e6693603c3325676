"""Cross-request micro-batching for the serving daemon (the port's copy of
the reference package's ``infer/batching.py``, which imports no JAX; the
port imports nothing of that package, and ``tests/test_torch_host.py``
pins this copy to the original).

The one-shot CLI serves one clip per process; infer/server.py keeps one
warm pipeline, and without this module each request's windows would reach
the device alone, as small 8-window bucket batches. The daemon instead
coalesces windows ACROSS in-flight requests into one device batch (up to
the pipeline's large bucket) and splits the logits back per request.

Design: request threads enqueue their windows and block on a per-item
event; ONE dispatcher thread drains the queue, concatenates up to
``max_windows`` rows, runs the (bucketed) forward, and distributes the
logit slices. Items are never split (the pipeline's forward chunks
internally), so a long recording rides alone while bursts of short clips
share a bucket. Dispatch is immediate once the queue is drained: while the
device executes one batch, the next burst accumulates behind it, so a lone
request never waits an artificial linger. An optional ``linger_ms`` adds a
bounded wait for stragglers when the device is idle.

Numerics: a request's windows may run in a different bucket (8 alone, the
large bucket coalesced). The log-mel kernel and the conv kernel work row
by row, but cuDNN may pick another algorithm for the float32 stem at
another batch size, so a bf16 rounding can flip: verdicts are stable,
byte-identical logits across load patterns are not guaranteed.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, List, Optional

import numpy as np


class _Item:
    __slots__ = ("windows", "logits", "error", "done")

    def __init__(self, windows: np.ndarray):
        self.windows = windows
        self.logits: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.done = threading.Event()


class MicroBatcher:
    """Coalesces concurrent ``logits(windows)`` calls into shared forwards.

    ``forward``: ``[n, T] float32 -> [n, C] float32`` (thread-safe or
    externally locked; only the dispatcher thread calls it).
    ``max_windows``: stop coalescing once the batch reaches this many rows
    (use the pipeline's large bucket so one dispatch fills one batch).
    ``linger_ms``: after the first item of a batch, wait up to this long
    for more arrivals before dispatching (0 = drain-and-go).
    """

    def __init__(
        self,
        forward: Callable[[np.ndarray], np.ndarray],
        max_windows: int = 128,
        linger_ms: float = 0.0,
    ):
        if max_windows < 1:
            raise ValueError("max_windows must be >= 1")
        self._forward = forward
        self._max_windows = int(max_windows)
        self._linger_s = float(linger_ms) / 1000.0
        self._queue: "queue.SimpleQueue[Optional[_Item]]" = queue.SimpleQueue()
        self._dispatches = 0  # device-forward count (observability/tests)
        self._stopped = False
        self._thread = threading.Thread(
            target=self._run, name="micro-batcher", daemon=True)
        self._thread.start()

    # -- request-thread side -------------------------------------------------

    def logits(self, windows: np.ndarray) -> np.ndarray:
        """Blocking: returns this call's logit rows (device batch shared
        with whatever else is in flight)."""
        if self._stopped:
            raise RuntimeError("MicroBatcher is stopped")
        if windows.shape[0] == 0:
            return self._forward(windows)  # shape answer only, no device use
        item = _Item(windows)
        self._queue.put(item)
        item.done.wait()
        if item.error is not None:
            raise item.error
        if item.logits is None:
            raise RuntimeError("MicroBatcher returned no logits")
        return item.logits

    @property
    def dispatch_count(self) -> int:
        return self._dispatches

    def stop(self) -> None:
        """Drain-stop the dispatcher (idempotent)."""
        if not self._stopped:
            self._stopped = True
            self._queue.put(None)
            self._thread.join(timeout=10)

    # -- dispatcher thread ----------------------------------------------------

    def _collect(self, first: _Item) -> List[_Item]:
        batch = [first]
        total = first.windows.shape[0]
        deadline = time.monotonic() + self._linger_s
        while total < self._max_windows:
            try:
                timeout = deadline - time.monotonic()
                nxt = self._queue.get(timeout=max(timeout, 0.0)) \
                    if timeout > 0 else self._queue.get_nowait()
            except queue.Empty:
                break
            if nxt is None:  # stop sentinel: re-post for the main loop
                self._queue.put(None)
                break
            batch.append(nxt)
            total += nxt.windows.shape[0]
        return batch

    def _dispatch(self, batch: List[_Item]) -> None:
        cat = (batch[0].windows if len(batch) == 1
               else np.concatenate([it.windows for it in batch], axis=0))
        self._dispatches += 1
        out = self._forward(cat)
        off = 0
        for it in batch:
            n = it.windows.shape[0]
            it.logits = out[off:off + n]
            off += n

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                # fail any stragglers that raced the stop sentinel
                while True:
                    try:
                        it = self._queue.get_nowait()
                    except queue.Empty:
                        return
                    if it is not None:
                        it.error = RuntimeError("MicroBatcher is stopped")
                        it.done.set()
            batch = self._collect(item)
            try:
                self._dispatch(batch)
            except BaseException:  # noqa: BLE001 - isolate batch neighbors
                # the dispatcher must outlive any one forward: a failed
                # coalesced batch must not poison its neighbors, so each
                # item is retried alone and only the offender's caller
                # re-raises its error
                for it in batch:
                    try:
                        self._dispatch([it])
                    except BaseException as e:  # noqa: BLE001
                        it.error = e
            finally:
                for it in batch:
                    it.done.set()
