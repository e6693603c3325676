"""Held-out evaluation over a segment tree (the reference package's
``infer/study.py``): the measurement core behind tools/accuracy_study.py,
tools/robustness_study.py, tools/calibrate_ensemble.py and
tools/decision_ab.py.

Drives the serving pipeline itself (its buckets, front end, backbone
route and decision rule) over ``<data_dir>/<ClassName>/*.wav`` and
aggregates binary detection accuracy (Real vs any synthetic), attribution
accuracy (the exact class), the class-confusion table, and the
threshold-free detector AUC/EER (utils/metrics.py).

An optional ``perturb(waveform, rng)`` hook distorts each decoded clip
before windowing; the robustness study sweeps noise, gain, band-limit,
clipping and shift through it, with a per-file RNG seeded from
``(seed << 32) ^ crc32(class/file)``.

Each file's windows go to the device alone, in the pipeline's 8 bucket
for a 4-s or 8-s segment, as the reference does.
"""

from __future__ import annotations

import collections
import logging
import os
import zlib
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from synthetic_audio_detection_tpu_torch.infer.pipeline import (
    InferencePipeline,
    preprocess_waveform,
    slice_waveform,
)
from synthetic_audio_detection_tpu_torch.utils import metrics as metrics_mod
from synthetic_audio_detection_tpu_torch.utils.calibration import apply_calibration

Perturb = Callable[[np.ndarray, np.random.Generator], np.ndarray]


def _class_folders(data_dir: str) -> List[str]:
    return sorted(d for d in os.listdir(data_dir) if os.path.isdir(os.path.join(data_dir, d)))


def labeled_clips(data_dir: str, audio, folders: Optional[Sequence[str]] = None,
                  perturb: Optional[Perturb] = None, seed: int = 0
                  ) -> Iterator[Tuple[str, str, np.ndarray, np.ndarray]]:
    """Yields (class folder, file name, windows, stamps) for every WAV of a
    labeled tree, folders and files in sorted order, skipping clips with no
    window. ``folders`` (default: every folder) picks the classes;
    ``perturb`` distorts each decoded clip before windowing, with the RNG
    seeded from ``(seed << 32) ^ crc32(class/file)``."""
    for cls in _class_folders(data_dir) if folders is None else folders:
        folder = os.path.join(data_dir, cls)
        for name in sorted(os.listdir(folder)):
            if not name.lower().endswith(".wav"):
                continue
            wf = preprocess_waveform(os.path.join(folder, name), audio)
            if perturb is not None:
                rng = np.random.default_rng((seed << 32) ^ zlib.crc32(f"{cls}/{name}".encode()))
                wf = np.asarray(perturb(wf, rng), np.float32)
            windows, stamps = slice_waveform(wf, audio)
            if windows.shape[0]:
                yield cls, name, windows, stamps


def collect_logits_tree(pipe: InferencePipeline, data_dir: str) -> Dict[str, np.ndarray]:
    """Per-WINDOW serving logits over a labeled segment tree.

    → {"logits": [num, N+1] float32 (RAW, before calibration), "class_idx":
    [num] int64 index into pipe.ensemble.class_names (the real class is the
    last index)}. A folder that names no ensemble class is skipped with a
    warning: it has no column to calibrate against."""
    names = list(pipe.ensemble.class_names)
    folders = []
    for cls in _class_folders(data_dir):
        if cls in names:
            folders.append(cls)
        else:
            logging.getLogger(__name__).warning(
                "collect_logits_tree: folder %r matches no ensemble class %s; skipped",
                cls, names)
    logits_out, idx_out = [], []
    for cls, _, windows, _ in labeled_clips(data_dir, pipe.audio, folders):
        lg = pipe.logits_for_windows(windows)
        logits_out.append(np.asarray(lg, np.float32))
        idx_out.extend([names.index(cls)] * lg.shape[0])
    if not logits_out:
        raise ValueError(f"{data_dir}: no usable labeled segments")
    return {"logits": np.concatenate(logits_out, axis=0),
            "class_idx": np.asarray(idx_out, np.int64)}


def evaluate_tree(pipe: InferencePipeline, data_dir: str, perturb: Optional[Perturb] = None,
                  seed: int = 0) -> Dict[str, Any]:
    """→ {n_segments, binary_accuracy, attribution_accuracy, per_class,
    confusion, binary_auc, binary_eer, binary_eer_threshold}.

    A file's verdict is the majority of its windows' labels. The per-file
    RNG passed to ``perturb`` is seeded from (seed, crc32 of the relative
    path): the same across runs, whatever the listing order."""
    real_name = pipe.ensemble.real_name
    n = bin_ok = attr_ok = 0
    per_class = collections.defaultdict(lambda: [0, 0, 0])  # n, bin, attr
    confusion = collections.Counter()
    det_scores, det_truth = [], []  # per-file synthetic-ness score / label
    for cls, _, windows, stamps in labeled_clips(data_dir, pipe.audio, perturb=perturb,
                                                 seed=seed):
        logits = pipe.logits_for_windows(windows)
        res = pipe.analyze_windows(windows, stamps, logits=logits)
        labels = [s["label"] for s in res["segments"]]
        label = collections.Counter(labels).most_common(1)[0][0]
        is_real_true = cls == real_name
        is_real_pred = label == real_name
        n += 1
        per_class[cls][0] += 1
        if is_real_true == is_real_pred:
            bin_ok += 1
            per_class[cls][1] += 1
        if label == cls:
            attr_ok += 1
            per_class[cls][2] += 1
        confusion[(cls, label)] += 1
        if res["percentages"]:
            if pipe.ensemble.generic_head and pipe.infer.generic_verdict:
                # the generic head's mean calibrated synthetic
                # probability: the ranking the generic head exists for
                cal_logits = logits
                if pipe._cal is not None:
                    cal_logits = np.asarray(apply_calibration(logits, pipe._cal), np.float32)
                probs = 1.0 / (1.0 + np.exp(-cal_logits.astype(np.float32)))
                _, gen = pipe._split_generic(probs)
                det_scores.append(float(gen.mean()))
            else:
                # 1 - mean real sigmoid (the unanimity rule's primary axis)
                det_scores.append(1.0 - res["percentages"][real_name] / 100.0)
            det_truth.append(not is_real_true)

    out: Dict[str, Any] = {
        "n_segments": n,
        "binary_accuracy": round(bin_ok / max(n, 1), 4),
        "attribution_accuracy": round(attr_ok / max(n, 1), 4),
        "per_class": {
            c: {"n": v[0], "binary": round(v[1] / max(v[0], 1), 4),
                "attribution": round(v[2] / max(v[0], 1), 4)}
            for c, v in per_class.items()
        },
        "confusion": {f"{t}->{p}": c for (t, p), c in sorted(confusion.items())},
    }
    truth = np.asarray(det_truth, bool)
    if truth.size and 0 < truth.sum() < truth.size:
        s = np.asarray(det_scores, np.float64)
        eer, thr = metrics_mod.equal_error_rate(s, truth)
        out["binary_auc"] = round(metrics_mod.roc_auc(s, truth), 6)
        out["binary_eer"] = round(eer, 6)
        out["binary_eer_threshold"] = round(thr, 6)
    return out
