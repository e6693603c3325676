"""The comparisons that decide ``correct``. Each returns numbers that are
held against limits of the cell's workload file (``limits``); a number at
or below its limit passes.

Serving: ``logit_gap``, the widest gap between a served logit and the
reference's over the sampled windows, in units of the spread across
windows (the RMS of the reference logits less each column's mean over the
sample: what tells one window from another, not the seed's offset);
``verdict_errors``, sampled windows whose served label is not the
reference's decision on the served logits themselves (sigmoid, threshold,
argmax), over the windows that no float32 rounding could tip (``of``
counts them). With both at their limits no verdict that the reference
holds clear of every threshold and tie by twice the logit limit can
change unseen. ``stamp_errors``, sampled clips whose served segment times
differ from the reference's slicing; ``failed``, requests that raised or
never answered.

Training: ``loss1_gap``, the relative gap of the first set-up step's loss
(``loss_gap``, the largest over the three steps, is read and not
compared: Adam's first moves make the later losses swing); ``grad_gap``,
the worst leaf's gap between the norms of the first clipped gradient (the
port's from its first Adam moment) and the reference's; ``change_gap``,
the same for the parameters' change over the three steps; ``grad_diff``,
the worst leaf's norm of the first gradient's difference. A leaf's gap
is taken against the larger of its reference norm and the median leaf's;
leaves whose reference gradient is under a thousandth of the median
leaf's (the Linear biases before a train-mode BatchNorm) are left out. A
number without a limit is read and not compared.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def logit_gap(served: np.ndarray, ref: np.ndarray) -> Tuple[float, float]:
    """(widest |served − ref| / spread, spread): the spread is the RMS of
    ``ref`` less each column's mean over the rows."""
    ref = ref.astype(np.float64)
    spread = float(np.sqrt(np.mean((ref - ref.mean(axis=0)) ** 2)))
    return float(np.abs(served.astype(np.float64) - ref).max() / spread), spread


TIE = 1e-4  # logits this close to a threshold or a tie may round either way in float32


def firm_rows(logits: np.ndarray) -> np.ndarray:
    """Rows whose decision no float32 rounding can tip: every column at least
    ``TIE`` from the 0.5 threshold (logit 0), and the top two synthetic
    columns at least ``TIE`` apart."""
    far = np.all(np.abs(logits) >= TIE, axis=1)
    syn = np.sort(logits[:, :-1], axis=1)
    apart = (syn[:, -1] - syn[:, -2] >= TIE) if syn.shape[1] > 1 else np.ones(len(logits), bool)
    return far & apart


def serving(served: np.ndarray, ref: np.ndarray, served_labels: Sequence[str],
            decided: Sequence[str], stamp_errors: int, failed: int,
            limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """``decided``: the reference's decision on the served logits."""
    gap, spread = logit_gap(served, ref)
    firm = firm_rows(served)
    errors = sum(1 for i in np.nonzero(firm)[0] if served_labels[i] != decided[i])
    return {"logit_gap": {"value": gap, "limit": limits["logit_gap"], "spread": spread},
            "verdict_errors": {"value": errors, "limit": 0, "of": int(firm.sum())},
            "stamp_errors": {"value": stamp_errors, "limit": 0},
            "failed": {"value": failed, "limit": 0}}


def leaf_gaps(port: Sequence[float], ref: Sequence[float], keep: Sequence[bool]) -> List[float]:
    """Each kept leaf's |‖port‖ − ‖ref‖| / max(‖ref‖, median ‖ref‖)."""
    med = float(np.median([r for r, k in zip(ref, keep) if k]))
    return [abs(p - r) / max(r, med) for p, r, k in zip(port, ref, keep) if k]


def training(port_losses: Sequence[float], ref_losses: Sequence[float],
             port_grad: Sequence[float], ref_grad: Sequence[float],
             port_change: Sequence[float], ref_change: Sequence[float],
             limits: Dict[str, float], names: Sequence[str] = (),
             grad_diff: Sequence[float] = ()) -> Dict[str, Dict[str, float]]:
    med = float(np.median(ref_grad))
    keep = [g >= 1e-3 * med for g in ref_grad]
    med_g = float(np.median([g for g, k in zip(ref_grad, keep) if k]))
    steps = [abs(a - b) / abs(b) for a, b in zip(port_losses, ref_losses)]
    grad, change = leaf_gaps(port_grad, ref_grad, keep), leaf_gaps(port_change, ref_change, keep)
    kept = [n for n, k in zip(names, keep) if k] or [""] * len(grad)
    diff = [d / max(r, med_g) for d, r, k in zip(grad_diff, ref_grad, keep) if k]
    out = {"loss_gap": {"value": max(steps), "steps": steps},
           "loss1_gap": {"value": steps[0]},
           "grad_gap": {"value": max(grad), "leaf": kept[int(np.argmax(grad))],
                        "median": float(np.median(grad))},
           "change_gap": {"value": max(change), "leaf": kept[int(np.argmax(change))],
                          "median": float(np.median(change))}}
    if diff:
        out["grad_diff"] = {"value": max(diff), "leaf": kept[int(np.argmax(diff))],
                            "median": float(np.median(diff))}
    for k, c in out.items():
        c["limit"] = limits.get(k)
    return out


def compared(checks: Dict[str, Dict]) -> Dict[str, Dict]:
    """The numbers that have a limit (the others are read, not compared)."""
    return {k: c for k, c in checks.items() if c["limit"] is not None}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in compared(checks).values())


def lines(checks: Dict[str, Dict[str, float]]) -> List[str]:
    return [f"check {k} {c['value']!r} limit {c['limit']!r}" for k, c in compared(checks).items()]
