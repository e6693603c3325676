"""Eval-mode ResNet forward with each BatchNorm folded into its conv (the
reference package's ``models/fast_resnet.py``).

Every conv + eval BN pair becomes one ``F.conv2d`` with weight
``w · γ/√(σ² + ε)`` and bias ``β − μ·γ/√(σ² + ε)``, in the compute dtype and
``channels_last`` layout, so cuDNN runs each conv with its epilogue fused.
Built once from an ``nn.Module`` backbone; the backbone itself is not
changed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from synthetic_audio_detection_tpu_torch.models.resnet import ResNet


@dataclass
class FoldedConv:
    weight: torch.Tensor
    bias: torch.Tensor
    stride: int
    padding: int

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding)


@torch.no_grad()
def fold_conv_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d, dtype: torch.dtype) -> FoldedConv:
    alpha = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    beta = bn.bias - bn.running_mean * alpha
    weight = conv.weight * alpha[:, None, None, None]
    return FoldedConv(weight.to(dtype).contiguous(memory_format=torch.channels_last),
                      beta.to(dtype), conv.stride[0], conv.padding[0])


@dataclass
class FoldedBlock:
    convs: List[FoldedConv]  # conv1, conv2[, conv3]; ReLU after all but the last
    downsample: Optional[FoldedConv]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = x
        for conv in self.convs[:-1]:
            out = torch.relu(conv(out))
        return torch.relu(self.convs[-1](out) + identity)


class FastResNet:
    """[B, C, H, W] → un-pooled features in ``dtype`` (channels_last)."""

    def __init__(self, backbone: ResNet, dtype: torch.dtype = torch.bfloat16):
        if backbone.first_stage != 1:
            raise ValueError("FastResNet folds a full backbone (stem included)")
        self.dtype = dtype
        self.stem = fold_conv_bn(backbone.conv1, backbone.bn1, dtype)
        self.blocks: List[FoldedBlock] = []
        for stage in range(1, backbone.last_stage + 1):
            for blk in getattr(backbone, f"layer{stage}"):
                pairs = [(blk.conv1, blk.bn1), (blk.conv2, blk.bn2)]
                if hasattr(blk, "conv3"):
                    pairs.append((blk.conv3, blk.bn3))
                ds = None
                if blk.downsample is not None:
                    ds = fold_conv_bn(blk.downsample[0], blk.downsample[1], dtype)
                self.blocks.append(FoldedBlock([fold_conv_bn(c, b, dtype) for c, b in pairs], ds))

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        x = F.max_pool2d(torch.relu(self.stem(x)), 3, 2, 1)
        for blk in self.blocks:
            x = blk(x)
        return x
