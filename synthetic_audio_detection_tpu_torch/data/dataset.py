"""Training input pipeline: split-tree WAVs → batched waveform arrays (the
port's copy of the reference package's ``data/dataset.py``, held to it by
``tests/test_torch_trainer.py``).

Reproduces the reference ``SpectrogramDataset`` *data* semantics
(submodel_trainer.py:118-238) while moving all spectrogram math onto the
device (the train step fuses mel/dB/mask/normalize/resize — SURVEY.md §3.1
notes the reference does this per-sample on CPU inside DataLoader workers,
its biggest inefficiency):

- Samples from ``data_dir/{train,test}/<ClassName>/*.wav``; label = index of
  the class in ``class_names`` ([Class0, Class1] → {0, 1}).
- Per file (submodel_trainer.py:155-187): resample to 32 kHz if needed, then
  * ≥ 2 segments of audio → first two 4 s segments
  * ≥ 1 segment → duplicate the first
  * ≥ 0.9 segment → zero-pad to 4 s and duplicate
  * shorter → drop (the reference returns None; collate filters)
- A batch of B files yields 2B training rows (the reference concatenates the
  two segments into the batch at :255-256).

Host work is only file IO + resample; a double-buffered thread pool keeps the
card fed. ``data/grain_pipeline.py`` is the worker-process alternative.

Under a data-parallel mesh each rank asks for a row window [start, stop)
of every batch (``WaveformBatcher.epoch(rows=...)``, ``window_batch``): the
one-process batch order, each file's two rows in place, and only the files
of those rows decoded. A file that does not load then keeps its two rows
as zeros weighted 0 (the grain backend's contract) rather than shrinking
the batch, so every rank's rows stay where they are; with no such file
the rows are the one-process batch's.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import queue
import random
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from synthetic_audio_detection_tpu_torch.audio import wavio
from synthetic_audio_detection_tpu_torch.audio.resample import resample_poly_np

SEGMENT_SAMPLES = 4 * 32_000
MIN_LENGTH_RATIO = 0.9


def derive_epoch_seed(seed: int, epoch_idx: int) -> int:
    """fold_in-style (splitmix64 finalizer) per-epoch shuffle seed —
    adjacent-seed streams of some generators correlate, so ``seed + epoch``
    is avoided everywhere batchers derive epoch seeds."""
    z = ((seed & 0xFFFFFFFF) << 32) | (epoch_idx & 0xFFFFFFFF)
    z = (z + 0x9E3779B97F4A7C15) & (2**64 - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & (2**64 - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & (2**64 - 1)
    return (z ^ (z >> 31)) & 0x7FFFFFFF


def list_samples(
    data_dir: str,
    mode: str,
    class_names: Sequence[str],
    extra_negative_classes: Sequence[str] = (),
) -> List[Tuple[str, int]]:
    """[(path, label)] from the dataset tree contract (dataset tree built by
    data.etl.split_dataset; consumed as at submodel_trainer.py:118-137).

    ``extra_negative_classes`` folds additional class folders into label 0
    (hard negatives): a one-vs-rest head trained only on Real-vs-SynthX never
    sees other generators, so any synthetic can fire it and attribution
    argmax ties at saturated sigmoids (the reference shares this failure —
    its per-head datasets are binary too, submodel_trainer.py:118-137).
    Training each head with the *other* synth classes as negatives turns it
    from "synthetic?" into "this generator?", which is what attribution
    needs; measured study in docs/PERFORMANCE.md."""
    labeled = [(cls, label) for label, cls in enumerate(class_names)]
    labeled += [(cls, 0) for cls in extra_negative_classes]
    samples = []
    for cls, label in labeled:
        cls_dir = os.path.join(data_dir, mode, cls)
        if not os.path.isdir(cls_dir):
            raise FileNotFoundError(f"missing class folder: {cls_dir}")
        for f in sorted(os.listdir(cls_dir)):
            if f.lower().endswith(".wav"):
                samples.append((os.path.join(cls_dir, f), label))
    if not samples:
        raise ValueError(f"no WAV files under {data_dir}/{mode}")
    return samples


def load_two_segments(path: str) -> Optional[np.ndarray]:
    """One file → [2, SEGMENT_SAMPLES] float32 or None (too short / corrupt).
    Mirrors the reference short-file policy exactly (submodel_trainer.py:155-187)."""
    try:
        wf, sr = wavio.read_wav(path)
    except Exception:
        return None
    if wf.size == 0:
        return None
    mono = wf.mean(axis=0)
    if sr != 32_000:
        mono = resample_poly_np(mono, sr, 32_000)
    n = mono.shape[0]
    if n >= 2 * SEGMENT_SAMPLES:
        segs = np.stack([mono[:SEGMENT_SAMPLES],
                         mono[SEGMENT_SAMPLES : 2 * SEGMENT_SAMPLES]])
    elif n >= SEGMENT_SAMPLES:
        first = mono[:SEGMENT_SAMPLES]
        segs = np.stack([first, first])
    elif n >= SEGMENT_SAMPLES * MIN_LENGTH_RATIO:
        padded = np.pad(mono, (0, SEGMENT_SAMPLES - n))
        segs = np.stack([padded, padded])
    else:
        return None
    return segs.astype(np.float32)


def window_files(n_files: int, start: int, stop: int) -> range:
    """The files (batch indices) whose two rows meet rows [start, stop)."""
    return range(start // 2, min(n_files, (stop + 1) // 2))


def window_batch(chunk: Sequence[Tuple[str, int]], segs: Dict[int, Optional[np.ndarray]],
                 start: int, stop: int) -> Dict[str, np.ndarray]:
    """Rows [start, stop) of the batch of ``chunk``'s files, file f's two
    segments at rows 2f and 2f + 1: {'audio' [stop − start, T], 'label',
    'weight'}. ``segs[f]`` ([2, T], or None for a file that did not load:
    its rows zero, its label kept, weighted 0) for each of
    ``window_files``; rows past the files zero, label 0, weighted 0."""
    n = stop - start
    out = {"audio": np.zeros((n, SEGMENT_SAMPLES), np.float32),
           "label": np.zeros(n, np.int32), "weight": np.zeros(n, np.float32)}
    for row in range(start, min(stop, 2 * len(chunk))):
        f = row // 2
        out["label"][row - start] = chunk[f][1]
        if segs[f] is not None:
            out["audio"][row - start] = segs[f][row % 2]
            out["weight"][row - start] = 1.0
    return out


@dataclass
class EpochStats:
    files_seen: int = 0
    files_dropped: int = 0


class WaveformBatcher:
    """Shuffled, threaded, double-buffered batch iterator.

    Yields {'audio': [2B', T], 'label': [2B']} with B' ≤ batch_size (dropped
    files shrink the batch like the reference's custom_collate_fn,
    submodel_trainer.py:221-238; callers pad to a fixed row count via
    :func:`pad_batch`)."""

    def __init__(
        self,
        samples: Sequence[Tuple[str, int]],
        batch_size: int,
        shuffle: bool = True,
        workers: int = 8,
        seed: int = 0,
        prefetch: int = 2,
    ):
        self.samples = list(samples)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.workers = max(1, workers)
        self.seed = seed
        self.prefetch = prefetch
        self.stats = EpochStats()

    def __len__(self) -> int:
        return (len(self.samples) + self.batch_size - 1) // self.batch_size

    def _make_batch(self, chunk: List[Tuple[str, int]], ex) -> Optional[Dict[str, np.ndarray]]:
        segs_list = list(ex.map(lambda s: load_two_segments(s[0]), chunk))
        audios, labels = [], []
        for (path, label), segs in zip(chunk, segs_list):
            self.stats.files_seen += 1
            if segs is None:
                self.stats.files_dropped += 1
                continue
            audios.append(segs)
            labels.extend([label, label])
        if not audios:
            return None
        audio = np.concatenate(audios, axis=0)  # [2B', T]
        return {"audio": audio, "label": np.asarray(labels, np.int32)}

    def _make_rows(self, chunk: List[Tuple[str, int]], ex, rows: Tuple[int, int]
                   ) -> Dict[str, np.ndarray]:
        files = window_files(len(chunk), *rows)
        segs = dict(zip(files, ex.map(lambda f: load_two_segments(chunk[f][0]), files)))
        self.stats.files_seen += len(files)
        self.stats.files_dropped += sum(s is None for s in segs.values())
        return window_batch(chunk, segs, *rows)

    def epoch(self, epoch_idx: int = 0, rows: Optional[Tuple[int, int]] = None
              ) -> Iterator[Dict[str, np.ndarray]]:
        """The epoch's batches; with ``rows`` = (start, stop) each batch's
        row window (``window_batch``), one for every batch, however many
        of its files load."""
        order = list(self.samples)
        if self.shuffle:
            random.Random(derive_epoch_seed(self.seed, epoch_idx)).shuffle(order)
        chunks = [
            order[i : i + self.batch_size]
            for i in range(0, len(order), self.batch_size)
        ]
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        producer_error: List[BaseException] = []

        def producer():
            # The sentinel MUST reach the queue even if _make_batch raises:
            # otherwise the consumer blocks on q.get() forever. The exception
            # is carried out and re-raised on the consumer side.
            try:
                with cf.ThreadPoolExecutor(max_workers=self.workers) as ex:
                    for chunk in chunks:
                        q.put(self._make_batch(chunk, ex) if rows is None
                              else self._make_rows(chunk, ex, rows))
            except BaseException as e:  # noqa: BLE001 — relayed to consumer
                producer_error.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            if item is not None:
                yield item
        t.join()
        if producer_error:
            raise producer_error[0]


def pad_batch(
    batch: Dict[str, np.ndarray], target_rows: int
) -> Tuple[Dict[str, np.ndarray], int]:
    """Zero-pad a shrunken batch up to the fixed row count; returns the
    padded batch and the number of real rows (labels of pad rows are 0 and
    must be masked out of metrics by the caller)."""
    n = batch["audio"].shape[0]
    if n == target_rows:
        return batch, n
    pad = target_rows - n
    return (
        {
            "audio": np.concatenate(
                [batch["audio"], np.zeros((pad, batch["audio"].shape[1]), np.float32)]
            ),
            "label": np.concatenate([batch["label"], np.zeros(pad, np.int32)]),
        },
        n,
    )
