"""The worker-process input pipeline, behind ``--data-backend grain`` (the
reference package's ``data/grain_pipeline.py``, which builds it on Grain):
a ``torch.utils.data.DataLoader`` whose worker processes decode the files,
a batch each, so no package beyond PyTorch is needed.

The epoch's file order is the threads backend's rule
(``dataset.WaveformBatcher``: ``random.Random(derive_epoch_seed(seed,
epoch)).shuffle``), so for one seed both backends give the same files in
the same batches. Batch contract (the reference's grain batches):
    {'audio': [2B, T] float32, 'label': [2B] int32, 'weight': [2B] float32}
with a dropped or corrupt file's two rows zero and weighted 0, and the last
partial batch dropped (fixed shapes without padding).
"""

from __future__ import annotations

import random
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch.utils.data

from synthetic_audio_detection_tpu_torch.data.dataset import (
    derive_epoch_seed,
    load_two_segments,
    window_batch,
    window_files,
)


class _Batches(torch.utils.data.Dataset):
    """Batch b of the epoch order: rows [start, stop) of its files'
    (``dataset.window_batch``; the whole batch by default), decoding only
    the files of those rows."""

    def __init__(self, order: Sequence[Tuple[str, int]], batch_size: int,
                 rows: Optional[Tuple[int, int]] = None):
        self.order = list(order)
        self.batch_size = batch_size
        self.rows = rows or (0, 2 * batch_size)

    def __len__(self) -> int:
        return len(self.order) // self.batch_size  # the last partial batch dropped

    def __getitem__(self, b: int) -> Dict[str, np.ndarray]:
        chunk = self.order[b * self.batch_size:(b + 1) * self.batch_size]
        files = window_files(len(chunk), *self.rows)
        return window_batch(chunk, {f: load_two_segments(chunk[f][0]) for f in files},
                            *self.rows)


def _as_is(batch):
    return batch


def epoch_order(samples: Sequence[Tuple[str, int]], seed: int, epoch_idx: int,
                shuffle: bool = True) -> List[Tuple[str, int]]:
    order = list(samples)
    if shuffle:
        random.Random(derive_epoch_seed(seed, epoch_idx)).shuffle(order)
    return order


def make_loader(samples: Sequence[Tuple[str, int]], batch_size: int, shuffle: bool = True,
                seed: int = 0, epoch_idx: int = 0, workers: int = 4,
                rows: Optional[Tuple[int, int]] = None) -> Iterator[Dict[str, np.ndarray]]:
    """The epoch's batches (with ``rows``: each batch's row window),
    decoded by ``workers`` processes, a batch each (0: in this process).
    The workers fork from a forkserver, not from this process, whose CUDA
    context and threads a fork would copy."""
    workers = max(0, workers)
    return iter(torch.utils.data.DataLoader(
        _Batches(epoch_order(samples, seed, epoch_idx, shuffle), batch_size, rows),
        batch_size=None, num_workers=workers, collate_fn=_as_is,
        multiprocessing_context="forkserver" if workers else None))
