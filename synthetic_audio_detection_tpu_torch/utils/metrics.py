"""The port's own copy of the reference package's ``utils/metrics.py``
(pinned to it by ``tests/test_torch_train_ops.py``). Classification
metrics: per-class precision/recall/F1 report + confusion
matrix, formatted like sklearn's ``classification_report`` (the reference
prints one per validation epoch and a confusion matrix in --evaluate,
submodel_trainer.py:376-383,444-457) — computed from the confusion-count
sufficient statistics the eval step returns.

Also threshold-free binary-detector metrics the reference lacks entirely
(its only surfaces are argmax accuracy reports): ROC/AUC and the equal
error rate — the standard operating metrics for synthetic-speech detection
(ASVspoof-style evaluation). Pure numpy; tests pin them against sklearn."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def binary_roc(
    scores: np.ndarray, labels: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """ROC curve points for a binary detector.

    ``scores``: higher = more positive; ``labels``: 1 = positive class.
    Returns ``(fpr, tpr, thresholds)`` with sklearn ``roc_curve`` semantics
    (tied scores collapsed to one point, ``drop_intermediate=False``,
    leading (0, 0) point at threshold +inf, thresholds descending: point i
    is the operating point "predict positive iff score >= thresholds[i]").
    """
    s = np.asarray(scores, np.float64).ravel()
    y = np.asarray(labels).ravel().astype(np.int64)
    if s.shape != y.shape:
        raise ValueError(f"scores {s.shape} vs labels {y.shape}")
    pos = int(y.sum())
    neg = y.size - pos
    if pos == 0 or neg == 0:
        raise ValueError("ROC needs at least one positive and one negative")
    order = np.argsort(-s, kind="mergesort")
    s, y = s[order], y[order]
    # last index of each run of tied scores = one ROC vertex per distinct score
    distinct = np.r_[np.nonzero(np.diff(s))[0], s.size - 1]
    tps = np.cumsum(y)[distinct]
    fps = (distinct + 1) - tps
    fpr = np.r_[0.0, fps / neg]
    tpr = np.r_[0.0, tps / pos]
    thresholds = np.r_[np.inf, s[distinct]]
    return fpr, tpr, thresholds


def roc_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Area under the ROC curve (trapezoid over the tie-collapsed points —
    identical to sklearn's ``roc_auc_score``, i.e. the probability a random
    positive outscores a random negative, ties counting half)."""
    fpr, tpr, _ = binary_roc(scores, labels)
    trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2.0
    return float(trapezoid(tpr, fpr))


def equal_error_rate(
    scores: np.ndarray, labels: np.ndarray
) -> Tuple[float, float]:
    """Equal error rate of a binary detector and its operating threshold.

    The EER is where the false-positive rate equals the false-negative rate
    on the piecewise-linear ROC (the convention behind the classic
    ``brentq(1 - x - interp1d(fpr, tpr)(x))`` recipe; linear interpolation
    corresponds to randomizing between the two adjacent thresholds).
    Returns ``(eer, threshold)`` where ``threshold`` is the nearest
    achievable operating point (predict positive iff score >= threshold).
    """
    fpr, tpr, thr = binary_roc(scores, labels)
    diff = fpr - (1.0 - tpr)  # increasing: -1 at (0,0) ... +1 at (1,1)
    i = int(np.searchsorted(diff, 0.0, side="left"))
    if i == 0 or diff[i] == 0.0:
        return float(fpr[i]), float(thr[i])
    # crossing lies strictly inside segment (i-1, i): interpolate both rates
    d_fpr = fpr[i] - fpr[i - 1]
    d_fnr = -(tpr[i] - tpr[i - 1])
    t = (1.0 - tpr[i - 1] - fpr[i - 1]) / (d_fpr - d_fnr)
    eer = fpr[i - 1] + t * d_fpr
    # nearest achievable threshold: whichever endpoint's max(fpr, fnr) is
    # closer to the interpolated EER
    at_prev = max(fpr[i - 1], 1.0 - tpr[i - 1])
    at_next = max(fpr[i], 1.0 - tpr[i])
    best = i - 1 if abs(at_prev - eer) <= abs(at_next - eer) else i
    return float(eer), float(thr[best])


def report_from_confusion(
    confusion: np.ndarray, class_names: Sequence[str]
) -> Dict[str, Dict[str, float]]:
    """confusion[true, pred] counts → per-class precision/recall/f1/support
    plus 'accuracy', 'macro avg', 'weighted avg' (sklearn semantics:
    undefined → 0)."""
    conf = np.asarray(confusion, np.float64)
    n = conf.shape[0]
    support = conf.sum(axis=1)
    pred_tot = conf.sum(axis=0)
    tp = np.diag(conf)
    precision = np.divide(tp, pred_tot, out=np.zeros(n), where=pred_tot > 0)
    recall = np.divide(tp, support, out=np.zeros(n), where=support > 0)
    denom = precision + recall
    f1 = np.divide(2 * precision * recall, denom, out=np.zeros(n), where=denom > 0)

    out: Dict[str, Dict[str, float]] = {}
    for i, name in enumerate(class_names):
        out[name] = {
            "precision": float(precision[i]),
            "recall": float(recall[i]),
            "f1-score": float(f1[i]),
            "support": float(support[i]),
        }
    total = support.sum()
    accuracy = float(tp.sum() / total) if total else 0.0
    weights = support / total if total else np.zeros(n)
    out["accuracy"] = {"precision": accuracy, "recall": accuracy,
                       "f1-score": accuracy, "support": float(total)}
    out["macro avg"] = {
        "precision": float(precision.mean()),
        "recall": float(recall.mean()),
        "f1-score": float(f1.mean()),
        "support": float(total),
    }
    out["weighted avg"] = {
        "precision": float((precision * weights).sum()),
        "recall": float((recall * weights).sum()),
        "f1-score": float((f1 * weights).sum()),
        "support": float(total),
    }
    return out


def format_report(
    report: Dict[str, Dict[str, float]], digits: int = 2
) -> str:
    """sklearn classification_report text layout."""
    classes = [k for k in report if k not in ("accuracy", "macro avg", "weighted avg")]
    width = max(max((len(c) for c in classes), default=0), len("weighted avg"))
    head = f"{'':>{width}}  {'precision':>9} {'recall':>9} {'f1-score':>9} {'support':>9}"
    lines = [head, ""]
    for c in classes:
        r = report[c]
        lines.append(
            f"{c:>{width}}  {r['precision']:>9.{digits}f} {r['recall']:>9.{digits}f} "
            f"{r['f1-score']:>9.{digits}f} {int(r['support']):>9}"
        )
    lines.append("")
    acc = report["accuracy"]
    lines.append(
        f"{'accuracy':>{width}}  {'':>9} {'':>9} {acc['f1-score']:>9.{digits}f} "
        f"{int(acc['support']):>9}"
    )
    for c in ("macro avg", "weighted avg"):
        r = report[c]
        lines.append(
            f"{c:>{width}}  {r['precision']:>9.{digits}f} {r['recall']:>9.{digits}f} "
            f"{r['f1-score']:>9.{digits}f} {int(r['support']):>9}"
        )
    return "\n".join(lines)


def format_confusion(
    confusion: np.ndarray, class_names: Sequence[str]
) -> str:
    conf = np.asarray(confusion)
    width = max(len(c) for c in class_names) + 2
    header = " " * width + "".join(f"{c:>{width}}" for c in class_names)
    lines = [header]
    for i, name in enumerate(class_names):
        lines.append(
            f"{name:>{width}}" + "".join(f"{int(v):>{width}}" for v in conf[i])
        )
    return "\n".join(lines)
