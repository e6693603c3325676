"""Binary head: un-pooled features → 2 logits [Real, Synthetic] (the
reference package's ``models/head.py``).

AdaptiveAvgPool2d(1) → Flatten → Linear(F, 512) → BN → ReLU → Dropout(0.5)
→ Linear(512, 256) → BN → ReLU → Dropout(0.3) → Linear(256, 2), as one
``nn.Sequential`` whose indices (head.2, head.3, head.6, head.7, head.10)
are the reference checkpoint's keys. In train mode the BatchNorms follow
flax (``FlaxBatchNorm1d``) and each dropout draws its mask from the
generator that ``set_dropout_generator`` hands it (the train step's), as
flax's ``nn.Dropout``: keep with probability 1 − p, scale by 1 / (1 − p).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from synthetic_audio_detection_tpu_torch.models.resnet import BN_EPS, BN_MOMENTUM, FlaxBatchNorm1d
from synthetic_audio_detection_tpu_torch.parallel.sharding import rows_of


class StepDropout(nn.Dropout):
    """Dropout whose mask comes from ``self.generator`` (a torch.Generator
    on the input's device; None: PyTorch's default generator). With
    ``self.rows`` = (first row, global rows) the input holds those rows of
    a global batch: the mask is drawn for the global batch and cut to
    them."""

    generator: Optional[torch.Generator] = None
    rows: Optional[Tuple[int, int]] = None

    def keep(self, shape, device) -> torch.Tensor:
        """The keep mask of an input of ``shape`` (the draw of a forward)."""
        full = (self.rows[1],) + tuple(shape[1:]) if self.rows else shape
        u = torch.rand(full, generator=self.generator, device=device)
        return rows_of(u, self.rows, shape[0]) >= self.p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = self.keep(x.shape, x.device)
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


def set_dropout_generator(model: nn.Module, generator: Optional[torch.Generator],
                          rows: Optional[Tuple[int, int]] = None) -> None:
    for m in model.modules():
        if isinstance(m, StepDropout):
            m.generator = generator
            m.rows = rows


def skip_dropout_draws(head: nn.Module, n_rows: int, device) -> None:
    """Draw and drop what ``head``'s forward in train mode would draw for
    ``n_rows`` input rows: a rank that does not hold a head keeps its
    generator where one holding every head would be."""
    width = None
    for m in head.modules():
        if isinstance(m, nn.Linear):
            width = m.out_features
        elif isinstance(m, StepDropout) and m.training and m.p != 0.0:
            m.keep((n_rows, width), device)


class BinaryHead(nn.Sequential):
    def __init__(self, num_features: int = 512, hidden=(512, 256),
                 dropout=(0.5, 0.3), num_outputs: int = 2):
        layers = [nn.AdaptiveAvgPool2d(1), nn.Flatten()]
        width = num_features
        for h, rate in zip(hidden, dropout):
            layers += [nn.Linear(width, h),
                       FlaxBatchNorm1d(h, eps=BN_EPS, momentum=1.0 - BN_MOMENTUM), nn.ReLU(),
                       StepDropout(rate)]
            width = h
        layers.append(nn.Linear(width, num_outputs))
        super().__init__(*layers)
