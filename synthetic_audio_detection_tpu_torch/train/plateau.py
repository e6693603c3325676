"""ReduceLROnPlateau host-side state machine (the port's own copy of the
reference package's ``train/plateau.py``, pinned to it by
``tests/test_torch_train_ops.py``).

Matches torch.optim.lr_scheduler.ReduceLROnPlateau(mode='min', factor=0.5,
patience=2) as configured by the reference (submodel_trainer.py:655-660):
if the monitored value fails to improve for `patience` consecutive epochs
*after* the best epoch, multiply the lr by `factor`. torch semantics details
reproduced: 'rel' threshold mode with threshold=1e-4 (default), cooldown 0,
min_lr 0.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class PlateauState:
    factor: float = 0.5
    patience: int = 2
    threshold: float = 1e-4
    min_scale: float = 0.0
    best: Optional[float] = None
    num_bad_epochs: int = 0
    scale: float = 1.0

    def update(self, metric: float) -> float:
        """Feed one epoch's monitored value; returns the current lr scale."""
        if self.best is None or metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.scale = max(self.scale * self.factor, self.min_scale)
            self.num_bad_epochs = 0
        return self.scale

    def state_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_state_dict(cls, d: dict) -> "PlateauState":
        return cls(**d)

    @classmethod
    def from_torch_state_dict(
        cls, d: dict, base_lr: float = 1.0
    ) -> "PlateauState":
        """Map a torch ReduceLROnPlateau.state_dict() (the ``scheduler`` entry
        of a reference checkpoint, submodel_trainer.py:712) onto this state
        machine. ``scale`` is recovered from ``_last_lr`` relative to
        ``base_lr`` when present (older torch omits it → scale stays 1.0).
        torch's fresh ``best`` is +inf (mode='min'); our update() treats it the
        same as None, so it is kept verbatim."""
        last_lr = d.get("_last_lr") or []
        scale = float(last_lr[0]) / base_lr if last_lr and base_lr else 1.0
        best = d.get("best")
        if best is not None and best == float("inf"):
            best = None
        return cls(
            factor=float(d.get("factor", 0.5)),
            patience=int(d.get("patience", 2)),
            threshold=float(d.get("threshold", 1e-4)),
            min_scale=0.0,
            best=None if best is None else float(best),
            num_bad_epochs=int(d.get("num_bad_epochs", 0)),
            scale=scale,
        )
