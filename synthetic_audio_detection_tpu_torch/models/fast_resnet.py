"""Eval-mode ResNet forward with each BatchNorm folded into its conv (the
reference package's ``models/fast_resnet.py``).

Every conv + eval BN pair becomes one ``F.conv2d`` with weight
``w · γ/√(σ² + ε)`` and bias ``β − μ·γ/√(σ² + ε)``, in the compute dtype and
``channels_last`` layout. cuDNN runs the conv; the bias, the ReLU and the
residual add run as separate elementwise passes over the activations.

``conv3x3_max_channels`` is the reference's ``gemm_max_channels`` knob
(same meaning, same default 0): a 3x3 conv with at most that many input
channels runs through the hand-written conv + BN + ReLU kernel
(``ops/cuda_conv.py``) instead, with the unscaled bf16 weight (packed once
here) and the BN affine applied in float32 in the kernel's epilogue, the
numerics of the reference's ``_conv_bn``. The 7x7 stem, the 1x1 downsample
convs, the max-pool and ``relu(out + identity)`` stay as they are.

Built once from an ``nn.Module`` backbone; the backbone itself is not
changed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from synthetic_audio_detection_tpu_torch.models.resnet import ResNet
from synthetic_audio_detection_tpu_torch.ops import cuda_conv


@dataclass
class FoldedConv:
    weight: torch.Tensor
    bias: torch.Tensor
    stride: int
    padding: int
    relu: bool

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.weight, self.bias, self.stride, self.padding)
        return torch.relu(y) if self.relu else y


@dataclass
class KernelConv:
    """A 3x3 conv + eval BN (+ ReLU) through ``cuda_conv.conv3x3_bn_relu``."""

    weight: torch.Tensor  # [F, 3, 3, C] bf16, the conv's own weight
    scale: torch.Tensor   # [F] float32, γ/√(σ² + ε)
    bias: torch.Tensor    # [F] float32, β − μ·scale
    stride: int
    relu: bool

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        # x is channels_last [B, C, H, W], so its NHWC view is contiguous
        # (the wrapper raises otherwise); the output's NCHW view is
        # channels_last again
        y = cuda_conv.conv3x3_bn_relu(x.permute(0, 2, 3, 1), self.weight.permute(1, 2, 3, 0),
                                      self.scale, self.bias, stride=self.stride,
                                      relu=self.relu, out_dtype=x.dtype)
        return y.permute(0, 3, 1, 2)


def bn_affine(bn: nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BN as (scale, bias) in float32."""
    alpha = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    return alpha, bn.bias - bn.running_mean * alpha


@torch.no_grad()
def fold_conv_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d, dtype: torch.dtype,
                 relu: bool = False) -> FoldedConv:
    alpha, beta = bn_affine(bn)
    weight = conv.weight * alpha[:, None, None, None]
    return FoldedConv(weight.to(dtype).contiguous(memory_format=torch.channels_last),
                      beta.to(dtype), conv.stride[0], conv.padding[0], relu)


@torch.no_grad()
def kernel_conv_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d, relu: bool) -> KernelConv:
    alpha, beta = bn_affine(bn)
    weight = conv.weight.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()
    return KernelConv(weight, alpha.float().contiguous(), beta.float().contiguous(),
                      conv.stride[0], relu)


@dataclass
class FoldedBlock:
    convs: List  # conv1, conv2[, conv3]; all but the last apply their ReLU
    downsample: Optional[FoldedConv]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = x
        for conv in self.convs[:-1]:
            out = conv(out)
        return torch.relu(self.convs[-1](out) + identity)


class FastResNet:
    """[B, C, H, W] → un-pooled features in ``dtype`` (channels_last)."""

    def __init__(self, backbone: ResNet, dtype: torch.dtype = torch.bfloat16,
                 conv3x3_max_channels: int = 0):
        if backbone.first_stage != 1:
            raise ValueError("FastResNet folds a full backbone (stem included)")
        if conv3x3_max_channels > 0 and dtype != torch.bfloat16:
            raise ValueError("the 3x3 conv kernel computes in bfloat16; "
                             f"conv3x3_max_channels needs dtype bfloat16, got {dtype}")
        self.dtype = dtype
        self.conv3x3_max_channels = conv3x3_max_channels

        def conv_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d, relu: bool):
            if (conv.kernel_size == (3, 3) and conv.padding == (1, 1)
                    and conv.in_channels <= conv3x3_max_channels):
                return kernel_conv_bn(conv, bn, relu)
            return fold_conv_bn(conv, bn, dtype, relu)

        self.stem = fold_conv_bn(backbone.conv1, backbone.bn1, dtype, relu=True)
        self.blocks: List[FoldedBlock] = []
        for stage in range(1, backbone.last_stage + 1):
            for blk in getattr(backbone, f"layer{stage}"):
                pairs = [(blk.conv1, blk.bn1), (blk.conv2, blk.bn2)]
                if hasattr(blk, "conv3"):
                    pairs.append((blk.conv3, blk.bn3))
                ds = None
                if blk.downsample is not None:
                    ds = fold_conv_bn(blk.downsample[0], blk.downsample[1], dtype)
                convs = [conv_bn(c, b, relu=j + 1 < len(pairs)) for j, (c, b) in enumerate(pairs)]
                self.blocks.append(FoldedBlock(convs, ds))

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        x = F.max_pool2d(self.stem(x), 3, 2, 1)
        for blk in self.blocks:
            x = blk(x)
        return x
