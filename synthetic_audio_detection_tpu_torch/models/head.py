"""Binary head: un-pooled features → 2 logits [Real, Synthetic] (the
reference package's ``models/head.py``).

AdaptiveAvgPool2d(1) → Flatten → Linear(F, 512) → BN → ReLU → Dropout(0.5)
→ Linear(512, 256) → BN → ReLU → Dropout(0.3) → Linear(256, 2), as one
``nn.Sequential`` whose indices (head.2, head.3, head.6, head.7, head.10)
are the reference checkpoint's keys.
"""

from __future__ import annotations

import torch.nn as nn

from synthetic_audio_detection_tpu_torch.models.resnet import BN_EPS


class BinaryHead(nn.Sequential):
    def __init__(self, num_features: int = 512, hidden=(512, 256),
                 dropout=(0.5, 0.3), num_outputs: int = 2):
        layers = [nn.AdaptiveAvgPool2d(1), nn.Flatten()]
        width = num_features
        for h, rate in zip(hidden, dropout):
            layers += [nn.Linear(width, h), nn.BatchNorm1d(h, eps=BN_EPS), nn.ReLU(),
                       nn.Dropout(rate)]
            width = h
        layers.append(nn.Linear(width, num_outputs))
        super().__init__(*layers)
