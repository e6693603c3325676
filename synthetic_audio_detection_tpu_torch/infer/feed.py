"""The serving feed's staging ring: each device batch is staged in a reused
host slot, copied into a reused device slot on a copy stream of its own,
and its padding rows are zeroed on the device.

For each batch shape (rows × samples) and transport dtype the ring owns two
slots, made at first use and kept for the pipeline's life; consecutive
batches of a shape take them in turn. A slot is a host tensor (pinned on
CUDA) and a device tensor. Per batch:

1. ``host_slot``: the next slot, once the copy out of its host side that
   the batch two back launched has finished; the caller writes the batch's
   useful rows into its host side.
2. ``launch``: on CUDA, on the copy stream, the copy of those rows into the
   device side (non-blocking) and a zero fill of the rest; the compute
   stream waits for both before whatever the caller launches next. On the
   CPU the same copies run synchronously.

The copy into a device slot waits for the compute work launched before the
previous ``launch`` (an event recorded then on the compute stream), and no
later: the slot's last batch is two back, so its forward was launched by
then, and the forward of the batch one back, which may still be running,
overlaps the copy. So a device batch stays valid until the caller has
launched two more, and the work on the card that reads it has to be
launched before the next ``launch``.

One pipeline serves one dispatch at a time (the daemon's lock ensures it);
``dispatch`` holds the ring for one and raises on a second concurrent one,
rather than let two share the slots.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import torch


@dataclasses.dataclass
class Slot:
    host: torch.Tensor
    device: torch.Tensor
    copied: Optional[torch.cuda.Event]  # the last copy out of ``host`` (CUDA)


class StagingRing:
    """Two slots per batch shape and dtype, a copy stream on CUDA."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self._slots: Dict[Tuple[int, int, torch.dtype], List[Slot]] = {}
        self._launched: Optional[torch.cuda.Event] = None
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def dispatch(self) -> Iterator[None]:
        """Hold the ring for one dispatch; raises RuntimeError while another
        holds it."""
        if not self._lock.acquire(blocking=False):
            raise RuntimeError("this pipeline is already serving a dispatch: one pipeline "
                               "serves one at a time (the daemon dispatches under its lock)")
        try:
            yield
        finally:
            self._lock.release()

    def host_slot(self, rows: int, samples: int, dtype: torch.dtype) -> Slot:
        """The next slot for [rows, samples] ``dtype`` batches, its host side
        free to write."""
        key = (rows, samples, dtype)
        if key not in self._slots:
            self._slots[key] = [self._new_slot(rows, samples, dtype) for _ in range(2)]
        pair = self._slots[key]
        slot = pair.pop(0)
        pair.append(slot)  # the other slot is next
        if slot.copied is not None:
            slot.copied.synchronize()
        return slot

    def _new_slot(self, rows: int, samples: int, dtype: torch.dtype) -> Slot:
        host = torch.empty((rows, samples), dtype=dtype, pin_memory=self.cuda)
        device = torch.empty((rows, samples), dtype=dtype, device=self.device)
        if not self.cuda:
            return Slot(host, device, None)
        device.record_stream(self.stream)  # its release waits for the copy stream too
        return Slot(host, device, torch.cuda.Event())

    def launch(self, slot: Slot, n: int) -> torch.Tensor:
        """Copy the host side's rows [0, n) to the device side and zero its
        rows [n, rows) there; the device batch, which the compute stream's
        next work waits for."""
        if not self.cuda:
            slot.device[:n].copy_(slot.host[:n])
            slot.device[n:].zero_()
            return slot.device
        compute = torch.cuda.current_stream(self.device)
        previous, self._launched = self._launched, compute.record_event()
        with torch.cuda.stream(self.stream):
            if previous is not None:
                self.stream.wait_event(previous)
            slot.device[:n].copy_(slot.host[:n], non_blocking=True)
            slot.device[n:].zero_()
            slot.copied.record(self.stream)
        compute.wait_event(slot.copied)
        return slot.device
