"""Post-hoc probability calibration for the ensemble's sigmoid outputs (the
port's own copy of the reference package's ``utils/calibration.py``,
pinned to it by tests/test_torch_calibration.py and
tests/test_torch_host.py).

Per-column temperature scaling: one scalar T per aggregated ensemble
output (syn_1..syn_N, the generic column of a generic-head ensemble, and
the real mean), fit by minimizing the binary NLL on held-out labeled
windows, and the expected calibration error that measures it; optionally
the operating points the decision rule can use instead of 0.5 (the real
column's EER point, or per-column EER or Šidák points). Fitting is offline
tooling (tools/calibrate_ensemble.py, tools/decision_ab.py); serving
divides each column's logit by its temperature on the host before the
sigmoid (``apply_calibration``), so the decision rule, smoothing and the
JSON stay as they are, and an uncalibrated checkpoint serves as before.

Pure numpy in float64 on the host, so the copy gives the reference's
values.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from synthetic_audio_detection_tpu_torch.utils.metrics import equal_error_rate

# Fitted inverse-temperature bounds: s = 1/T clamped to [1/T_MAX, 1/T_MIN].
# Perfectly separated columns push s -> inf (NLL monotone decreasing); the
# clamp keeps the fit finite and the stored temperature meaningful.
T_MIN = 1e-2
T_MAX = 1e3


def stable_sigmoid(u: np.ndarray) -> np.ndarray:
    """Overflow-safe sigmoid: exp only ever sees non-positive arguments."""
    u = np.asarray(u, np.float64)
    e = np.exp(-np.abs(u))
    return np.where(u >= 0, 1.0 / (1.0 + e), e / (1.0 + e))


def binary_nll(logits: np.ndarray, labels: np.ndarray, scale: float = 1.0) -> float:
    """Mean binary cross-entropy of ``sigmoid(scale * logits)`` vs labels.

    Stable formulation: softplus(u) - y*u with softplus(u) computed as
    max(u, 0) + log1p(exp(-|u|)).
    """
    u = np.asarray(logits, np.float64) * float(scale)
    y = np.asarray(labels, np.float64)
    softplus = np.maximum(u, 0.0) + np.log1p(np.exp(-np.abs(u)))
    return float(np.mean(softplus - y * u))


def fit_temperature(
    logits: np.ndarray, labels: np.ndarray, iters: int = 80
) -> float:
    """Fit T minimizing ``binary_nll(logits, labels, scale=1/T)``.

    The NLL is convex in the inverse temperature s (its second derivative,
    mean(sigmoid'(s*z) * z^2), is nonnegative), so the gradient
    g(s) = mean((sigmoid(s*z) - y) * z) is nondecreasing and bisection on
    its sign finds the global optimum deterministically — no line searches,
    no dependence on optimizer defaults. Degenerate inputs (single-class
    labels, all-zero logits) return T=1.
    """
    z = np.asarray(logits, np.float64).ravel()
    y = np.asarray(labels, np.float64).ravel()
    if z.shape != y.shape:
        raise ValueError(f"logits {z.shape} vs labels {y.shape}")
    if z.size == 0 or len(np.unique(y)) < 2 or not np.any(z):
        return 1.0

    def grad(s: float) -> float:
        return float(np.mean((stable_sigmoid(s * z) - y) * z))

    lo, hi = 1.0 / T_MAX, 1.0 / T_MIN
    g_lo, g_hi = grad(lo), grad(hi)
    if g_lo >= 0.0:  # optimum at or below the s floor (huge T)
        return 1.0 / lo
    if g_hi <= 0.0:  # separable: optimum beyond the s ceiling (tiny T)
        return 1.0 / hi
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if grad(mid) > 0.0:
            hi = mid
        else:
            lo = mid
    return float(1.0 / (0.5 * (lo + hi)))


def expected_calibration_error(
    probs: np.ndarray, labels: np.ndarray, n_bins: int = 15
) -> float:
    """ECE with equal-width confidence bins on [0, 1]: the support-weighted
    mean |accuracy - mean confidence| per bin (Guo et al. 2017 convention
    applied to the binary "positive" probability directly)."""
    p = np.asarray(probs, np.float64).ravel()
    y = np.asarray(labels, np.float64).ravel()
    if p.shape != y.shape:
        raise ValueError(f"probs {p.shape} vs labels {y.shape}")
    if p.size == 0:
        return 0.0
    # right-closed bins; clip 1.0 into the last bin
    idx = np.minimum((p * n_bins).astype(np.int64), n_bins - 1)
    ece = 0.0
    for b in range(n_bins):
        mask = idx == b
        m = int(mask.sum())
        if not m:
            continue
        ece += (m / p.size) * abs(float(y[mask].mean()) - float(p[mask].mean()))
    return float(ece)


def column_target(class_idx: np.ndarray, j: int, n_named: int,
                  generic_head: bool = False) -> np.ndarray:
    """Column j's binary float64 target over windows of true class
    ``class_idx`` (index ``n_named`` = the real class): "is class j" for a
    specialist column, "any synthetic" for the generic column (index
    ``n_named`` of a generic-head ensemble), "is real" for the last."""
    ci = np.asarray(class_idx, np.int64).ravel()
    if generic_head and j == n_named:
        return (ci != n_named).astype(np.float64)  # any synthetic
    if j == n_named + int(generic_head):
        return (ci == n_named).astype(np.float64)  # real column
    return (ci == j).astype(np.float64)


def fit_ensemble_calibration(
    logits: np.ndarray,
    class_idx: np.ndarray,
    class_names: Sequence[str],
    store_eer_threshold: bool = False,
    store_column_thresholds: bool = False,
    column_threshold_method: str = "eer",
    sidak_alpha: float = 0.05,
    fit_on: Optional[str] = None,
    generic_head: bool = False,
) -> Dict[str, object]:
    """Fit per-column temperatures for aggregated ensemble outputs.

    ``logits``: [num, N+1] serving logits (columns syn_1..syn_N, real mean —
    ensemble.multihead._aggregate order). ``class_idx``: [num] true class
    index into ``class_names`` (index N = the real class). Column j's binary
    target is "is this window class j" for synthetic columns and "is this
    window real" for the last column.

    Returns the calibration dict stored in merged-checkpoint metadata:
    ``{"temperatures": [N+1 floats], "column_names": [...], "fit_on": ...,
    "ece_before": [...], "ece_after": [...], "nll_before": [...],
    "nll_after": [...]}`` plus ``"threshold"`` (the calibrated real column's
    EER operating point mapped through its sigmoid) when
    ``store_eer_threshold`` — the serving default stays 0.5 otherwise, which
    post-calibration is the NLL-consistent operating point.

    ``store_column_thresholds`` additionally stores ``"column_thresholds"``
    — the per-head operating-point lever for the unanimity rule's
    compounding false-positive problem (per-head real-FPRs compose as
    1 - prod(1 - FPR_k)); serving engages them with
    ``InferenceConfig.per_column_thresholds``. Two methods
    (``column_threshold_method``; tools/decision_ab.py compares them):

    - ``"eer"``: each column's OWN calibrated-sigmoid EER point (syn_j
      positives = that generator's windows; real positives = real
      windows) — the balanced default. A column with no positives or no
      negatives in the fit data falls back to 0.5.
    - ``"sidak"``: per-head thresholds at per-head real-window FPR
      q = 1 - (1 - sidak_alpha)^(1/N), so the ENSEMBLE's compounded
      real-FPR is bounded by ``sidak_alpha`` (independence-or-better);
      the real column stays at the calibrated 0.5. The TNR-control knob;
      costs seen TPR in proportion to head overlap.
    """
    z = np.asarray(logits, np.float64)
    ci = np.asarray(class_idx, np.int64).ravel()
    # generic-head ensembles carry one extra column (the generic
    # Real-vs-any-synthetic head) between the specialists and the real mean
    # (ensemble/multihead.py); its binary target is "any synthetic"
    n_named = len(class_names) - 1
    expect_cols = n_named + 1 + int(generic_head)
    if z.ndim != 2 or z.shape[1] != expect_cols:
        raise ValueError(
            f"logits {z.shape} vs {expect_cols} columns for "
            f"{list(class_names)} (generic_head={generic_head})")
    if z.shape[0] != ci.shape[0]:
        raise ValueError(f"logits rows {z.shape[0]} vs labels {ci.shape[0]}")
    n_heads = n_named  # specialist heads; ci index n_named = the real class

    def col_target(j: int) -> np.ndarray:
        return column_target(ci, j, n_named, generic_head)

    temps: List[float] = []
    ece_b: List[float] = []
    ece_a: List[float] = []
    nll_b: List[float] = []
    nll_a: List[float] = []
    for j in range(expect_cols):
        target = col_target(j)
        col = z[:, j]
        t = fit_temperature(col, target)
        temps.append(round(float(t), 6))
        p_raw = stable_sigmoid(col)
        p_cal = stable_sigmoid(col / t)
        ece_b.append(round(expected_calibration_error(p_raw, target), 6))
        ece_a.append(round(expected_calibration_error(p_cal, target), 6))
        nll_b.append(round(binary_nll(col, target), 6))
        nll_a.append(round(binary_nll(col, target, scale=1.0 / t), 6))

    column_names = list(class_names)
    if generic_head:
        column_names = column_names[:-1] + ["__generic__", column_names[-1]]
    out: Dict[str, object] = {
        "temperatures": temps,
        "column_names": column_names,
        "ece_before": ece_b,
        "ece_after": ece_a,
        "nll_before": nll_b,
        "nll_after": nll_a,
    }
    if fit_on:
        out["fit_on"] = fit_on
    if store_eer_threshold:
        # detector score = calibrated real sigmoid; positives = real windows.
        # The EER threshold on that score IS a probability threshold, directly
        # usable as the decision rule's operating point.
        real_col = z[:, -1] / temps[-1]
        p_real = stable_sigmoid(real_col)
        is_real = (ci == n_heads).astype(np.int64)
        if 0 < is_real.sum() < is_real.size:
            _, thr = equal_error_rate(p_real, is_real)
            out["threshold"] = round(float(thr), 6)
    if store_column_thresholds:
        if column_threshold_method not in ("eer", "sidak"):
            raise ValueError(
                f"column_threshold_method {column_threshold_method!r} "
                "(choose 'eer' or 'sidak')")
        col_thr: List[float] = []
        if column_threshold_method == "eer":
            for j in range(expect_cols):
                target = col_target(j).astype(np.int64)
                if not 0 < target.sum() < target.size:
                    col_thr.append(0.5)
                    continue
                p_cal = stable_sigmoid(z[:, j] / temps[j])
                _, thr = equal_error_rate(p_cal, target)
                col_thr.append(round(float(thr), 6))
        else:
            if not 0.0 < sidak_alpha < 1.0:
                raise ValueError(f"sidak_alpha {sidak_alpha} not in (0, 1)")
            real_rows = z[ci == n_named]
            q = 1.0 - (1.0 - sidak_alpha) ** (1.0 / max(n_heads, 1))
            for j in range(n_heads):
                if real_rows.shape[0] == 0:
                    col_thr.append(0.5)
                    continue
                p_real = stable_sigmoid(real_rows[:, j] / temps[j])
                col_thr.append(round(float(np.quantile(p_real, 1.0 - q)), 6))
            if generic_head:
                # ONE head bounds the real-FPR directly: its threshold is
                # the plain (1 - alpha) real-window quantile, no Šidák split
                j = n_named
                if real_rows.shape[0] == 0:
                    col_thr.append(0.5)
                else:
                    p_real = stable_sigmoid(real_rows[:, j] / temps[j])
                    # 9 dp: a sharply-calibrated generic head can place its
                    # real-window quantile below 5e-7, which 6 dp would
                    # round to an always-synthetic 0.0 operating point
                    col_thr.append(
                        round(float(np.quantile(p_real, 1.0 - sidak_alpha)), 9))
            col_thr.append(0.5)  # real column: calibrated NLL-consistent pt
            out["sidak_alpha"] = float(sidak_alpha)
        out["column_thresholds"] = col_thr
        out["column_threshold_method"] = column_threshold_method
    return out


def apply_calibration(
    logits: np.ndarray, calibration: Dict[str, object]
) -> np.ndarray:
    """[num, N+1] logits → temperature-scaled logits (float32, host-side).

    The scaled logits feed the unchanged sigmoid decision rule; dividing
    before the sigmoid keeps the whole serving contract (thresholding,
    smoothing, percentage means) untouched.
    """
    temps = np.asarray(calibration["temperatures"], np.float32)
    z = np.asarray(logits, np.float32)
    if z.ndim != 2 or temps.shape != (z.shape[1],):
        raise ValueError(f"logits {z.shape} vs temperatures {temps.shape}")
    return (z / temps).astype(np.float32)
