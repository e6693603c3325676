"""Eval-mode ResNet forward with every conv + BN computed as the reference
package's ``models/fast_resnet.py:_conv_bn`` computes it: a conv of
operands rounded to the compute dtype, summed in float32, then the eval BN
as a float32 affine ``y·scale + bias`` (scale = γ/√(σ² + ε), bias =
β − μ·scale), the optional ReLU, and one rounding to the compute dtype.
Activations stay in the compute dtype and ``channels_last`` layout; the
max-pool and ``relu(out + identity)`` run on them as in the reference.

``conv3x3_max_channels`` is the reference's ``gemm_max_channels`` knob: 0
runs no kernel, and a conv with at most that many input channels runs
through the hand-written conv + BN + ReLU kernel (``ops/cuda_conv.py``),
whose epilogue applies the affine and the ReLU in float32 and rounds once:

- a 3x3 conv with its own weight;
- a 1x1 downsample with its weight at the centre tap of an otherwise zero
  3x3 weight. A 3x3, pad-1 output pixel is centred on the input pixel a
  1x1, pad-0 conv reads at the same stride, and the other eight taps add
  exact zeros, so the result is the 1x1 conv's.

Above 0 the knob also sends the stem (the 7x7 stride-2 conv of 1 or 3
input channels, its BN, max-pool and ReLU) through the hand-written stem
kernel (``ops/cuda_stem.py``): the same products and affine, one rounding
to bf16, then the max-pool, with no intermediate in device memory. A
broadcast input (below) is one plane to the kernel, convolved with each
channel's own weight.

Every other conv (any conv above the knob, and every conv at knob 0) is
``cuda_conv.conv_bn_relu_plain``: a float32 conv of the rounded operands
with TF32 off, the counterpart of the reference's ``lax.conv`` branch. All
ways compute the same function; only the float32 summation order inside a
conv differs.

The serving input repeats one log-mel plane on three channels as a
broadcast view (``melspec.replicate_channels``: stride 0 on the channel
axis). For such an input the knob-0 stem convolves the one plane with its
bf16-rounded weight summed over the three input channels in float32: a
third of the products. The sum of three bf16 weights is exact in float32
unless their exponents lie far apart, and so is its product with a bf16
value unless the sum needs more than 16 significant bits; otherwise the
product rounds once more in float32. Either way the change is of the
size of the summation order's.

Built once from an ``nn.Module`` backbone; the backbone itself is not
changed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from synthetic_audio_detection_tpu_torch.models.resnet import ResNet
from synthetic_audio_detection_tpu_torch.ops import cuda_conv, cuda_stem


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


@dataclass
class PlainConv:
    """A conv + eval BN (+ ReLU) as ``cuda_conv.conv_bn_relu_plain``
    computes it, with the weight rounded once, here."""

    weight: torch.Tensor  # [F, C, kh, kw] float32 holding the weight rounded to dtype
    scale: torch.Tensor
    bias: torch.Tensor
    stride: int
    padding: int
    relu: bool
    dtype: torch.dtype

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return cuda_conv.conv_f32_bn_relu(x.to(self.dtype).float(), self.weight, self.scale,
                                          self.bias, self.stride, self.padding, self.relu,
                                          self.dtype)


Conv = Union[KernelConv, PlainConv]


@dataclass
class KernelStem:
    """The stem conv + eval BN, its max-pool and its ReLU through
    ``cuda_stem.stem_pool``."""

    weight: torch.Tensor  # [64, C, 7, 7] bf16
    packed: torch.Tensor  # cuda_stem.pack_weight(weight)
    scale: torch.Tensor   # [64] float32
    bias: torch.Tensor    # [64] float32

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] > 1 and x.stride(1) == 0:  # one plane on every channel: keep it one
            x = x[:, :1].to(torch.bfloat16).expand(x.shape)
        x = cuda_stem.contiguous_planes(x.to(torch.bfloat16))
        y = cuda_stem.stem_pool(x, self.weight, self.scale, self.bias, self.packed)
        return y.permute(0, 3, 1, 2)  # NHWC → channels_last [B, 64, Hp, Wp]


def bn_affine(bn: nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BN as (scale, bias) in float32."""
    alpha = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    return alpha, bn.bias - bn.running_mean * alpha


@torch.no_grad()
def plain_conv_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d, dtype: torch.dtype, relu: bool,
                  sum_input_channels: bool = False) -> PlainConv:
    """``sum_input_channels``: the weight for an input whose channels are
    one plane repeated, summed over its input axis in float32 after the
    rounding."""
    weight = conv.weight.to(dtype).float()
    if sum_input_channels:
        weight = weight.sum(dim=1, keepdim=True)
    alpha, beta = bn_affine(bn)
    return PlainConv(weight.contiguous(memory_format=torch.channels_last), alpha.float(),
                     beta.float(), conv.stride[0], conv.padding[0], relu, dtype)


@torch.no_grad()
def kernel_conv_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d, relu: bool) -> KernelConv:
    """The kernel's packed [F, 3, 3, C] bf16 weight; a 1x1 conv's weight
    goes to the centre tap of zeros."""
    w = conv.weight.to(torch.bfloat16).permute(0, 2, 3, 1)  # [F, kh, kw, C]
    if conv.kernel_size == (1, 1):
        w = F.pad(w, (0, 0, 1, 1, 1, 1))
    alpha, beta = bn_affine(bn)
    return KernelConv(w.contiguous(), alpha.float().contiguous(), beta.float().contiguous(),
                      conv.stride[0], relu)


@torch.no_grad()
def kernel_stem(conv: nn.Conv2d, bn: nn.BatchNorm2d) -> KernelStem:
    weight = conv.weight.to(torch.bfloat16).contiguous()
    alpha, beta = bn_affine(bn)
    return KernelStem(weight, cuda_stem.pack_weight(weight), alpha.float().contiguous(),
                      beta.float().contiguous())


@dataclass
class Block:
    convs: List[Conv]  # conv1, conv2[, conv3]; all but the last apply their ReLU
    downsample: Optional[Conv]

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
            raise ValueError("FastResNet takes a full backbone (stem included)")
        if conv3x3_max_channels > 0 and dtype != torch.bfloat16:
            raise ValueError("the 3x3 conv kernel computes in bfloat16; "
                             f"conv3x3_max_channels needs dtype bfloat16, got {dtype}")
        self.dtype = dtype
        self.conv3x3_max_channels = conv3x3_max_channels

        def conv_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d, relu: bool,
                    downsample: bool = False) -> Conv:
            fits = ((conv.kernel_size == (3, 3) and conv.padding == (1, 1))
                    or (downsample and conv.kernel_size == (1, 1) and conv.padding == (0, 0)))
            if fits and conv.in_channels <= conv3x3_max_channels:
                return kernel_conv_bn(conv, bn, relu)
            return plain_conv_bn(conv, bn, dtype, relu)

        # the stem's ReLU runs after the max-pool, on a quarter of the
        # pixels: both are monotone, so the two orders give the same values
        self.kernel_stem = (kernel_stem(backbone.conv1, backbone.bn1)
                            if conv3x3_max_channels > 0
                            and backbone.conv1.in_channels in cuda_stem.CHANNELS else None)
        self.stem = plain_conv_bn(backbone.conv1, backbone.bn1, dtype, relu=False)
        self.stem_one_plane = plain_conv_bn(backbone.conv1, backbone.bn1, dtype, relu=False,
                                            sum_input_channels=True)
        self.blocks: List[Block] = []
        for stage in range(1, backbone.last_stage + 1):
            for blk in getattr(backbone, f"layer{stage}"):
                pairs = [(blk.conv1, blk.bn1), (blk.conv2, blk.bn2)]
                if hasattr(blk, "conv3"):
                    pairs.append((blk.conv3, blk.bn3))
                ds = None
                if blk.downsample is not None:
                    ds = conv_bn(blk.downsample[0], blk.downsample[1], False, downsample=True)
                convs = [conv_bn(c, b, relu=j + 1 < len(pairs)) for j, (c, b) in enumerate(pairs)]
                self.blocks.append(Block(convs, ds))

    @torch.no_grad()
    def stem_pool(self, x: torch.Tensor) -> torch.Tensor:
        """The stem, its max-pool and its ReLU: [B, C, H, W] → the first
        block's input."""
        if self.kernel_stem is not None:
            return self.kernel_stem(x)
        stem = self.stem
        if x.shape[1] > 1 and x.stride(1) == 0:  # one plane on every channel
            x, stem = x[:, :1], self.stem_one_plane
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        return torch.relu_(F.max_pool2d(stem(x), 3, 2, 1))

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem_pool(x)
        for blk in self.blocks:
            x = blk(x)
        return x
