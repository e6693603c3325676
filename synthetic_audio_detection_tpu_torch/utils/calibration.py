"""Temperature calibration at serving time (the port's copy of
``apply_calibration`` from the reference package's ``utils/calibration.py``;
fitting stays offline tooling there).

A calibrated checkpoint carries one temperature per aggregated column
(syn_1..syn_N and the real mean). Serving divides each column's logit by
its temperature on the host, before the sigmoid, so the decision rule,
smoothing and percentages stay as they are.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def apply_calibration(logits: np.ndarray, calibration: Dict[str, object]) -> np.ndarray:
    """[num, N+1] logits → temperature-scaled logits (float32)."""
    temps = np.asarray(calibration["temperatures"], np.float32)
    z = np.asarray(logits, np.float32)
    if z.ndim != 2 or temps.shape != (z.shape[1],):
        raise ValueError(f"logits {z.shape} vs temperatures {temps.shape}")
    return (z / temps).astype(np.float32)
