"""Sub-model = backbone + binary head (the reference package's
``models/classifier.py``). Output index 0 = Real, 1 = Synthetic."""

from __future__ import annotations

import torch
import torch.nn as nn

from synthetic_audio_detection_tpu_torch.models.head import BinaryHead
from synthetic_audio_detection_tpu_torch.models.resnet import create_resnet

REAL_INDEX = 0
SYNTHETIC_INDEX = 1


class BinaryClassifier(nn.Module):
    """[B, C, H, W] spectrogram image → [B, num_outputs] logits. State-dict
    keys: ``base.*`` (timm ResNet) and ``head.<index>.*``. ``s2d_stage1``
    runs stage 1 in H-only space-to-depth form (``models/resnet.py``
    ``S2DBasicBlock``); the parameters are the same, so checkpoints are
    interchangeable either way."""

    def __init__(self, backbone: str = "resnet18", in_channels: int = 3,
                 num_outputs: int = 2, s2d_stage1: bool = False):
        super().__init__()
        self.backbone = backbone
        self.base = create_resnet(backbone, in_channels, s2d_stage1=s2d_stage1)
        self.head = BinaryHead(self.base.num_features, num_outputs=num_outputs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.base(x))
