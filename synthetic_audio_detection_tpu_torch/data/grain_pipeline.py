"""The worker-process input pipeline, behind ``--data-backend grain`` (the
reference package's ``data/grain_pipeline.py``, which builds it on Grain):
a ``torch.utils.data.DataLoader`` whose worker processes decode the files,
so no package beyond PyTorch is needed.

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
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch.utils.data

from synthetic_audio_detection_tpu_torch.data.dataset import (
    SEGMENT_SAMPLES,
    derive_epoch_seed,
    load_two_segments,
)


def decode_two_segments(sample: Tuple[str, int]) -> Dict[str, np.ndarray]:
    """(path, label) → a fixed-shape record of the file's two rows."""
    path, label = sample
    segs = load_two_segments(path)
    if segs is None:
        return {"audio": np.zeros((2, SEGMENT_SAMPLES), np.float32),
                "label": np.full(2, label, np.int32), "weight": np.zeros(2, np.float32)}
    return {"audio": segs, "label": np.full(2, label, np.int32),
            "weight": np.ones(2, np.float32)}


def collate(records: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.concatenate([r[k] for r in records], axis=0)
            for k in ("audio", "label", "weight")}


class _Files(torch.utils.data.Dataset):
    def __init__(self, samples: Sequence[Tuple[str, int]]):
        self.samples = list(samples)

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        return decode_two_segments(self.samples[i])


def epoch_order(samples: Sequence[Tuple[str, int]], seed: int, epoch_idx: int,
                shuffle: bool = True) -> List[Tuple[str, int]]:
    order = list(samples)
    if shuffle:
        random.Random(derive_epoch_seed(seed, epoch_idx)).shuffle(order)
    return order


def make_loader(samples: Sequence[Tuple[str, int]], batch_size: int, shuffle: bool = True,
                seed: int = 0, epoch_idx: int = 0, workers: int = 4
                ) -> Iterator[Dict[str, np.ndarray]]:
    """The epoch's batches, decoded by ``workers`` processes (0: in this
    process). The workers fork from a forkserver, not from this process,
    whose CUDA context and threads a fork would copy."""
    workers = max(0, workers)
    return iter(torch.utils.data.DataLoader(
        _Files(epoch_order(samples, seed, epoch_idx, shuffle)), batch_size=batch_size,
        shuffle=False, num_workers=workers, collate_fn=collate, drop_last=True,
        multiprocessing_context="forkserver" if workers else None))
