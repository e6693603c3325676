"""ResNet-18/26/34/50/101/152/200 backbones as ``nn.Module``s (the reference
package's ``models/resnet.py``): 7x7/2 stem, 3x3/2 max-pool, four stages of
basic or bottleneck blocks with the stride on the 3x3 conv (v1.5).

NCHW, with timm/torchvision parameter names (``conv1``, ``bn1``,
``layer1.0.conv1``, ``layer2.0.downsample.0`` …), so the reference's merged
``.pth`` state dicts load as they are. ``forward`` returns the un-pooled
feature map (timm ``forward_features``). The space-to-depth stage-1 blocks
of the reference package are not ported: they work around the TPU conv
emitter.

In train mode BatchNorm follows flax, as the reference trains
(``FlaxBatchNorm2d``), and ``stop_grad_stage`` runs the stages before it
without autograd, as the reference's ``jax.lax.stop_gradient`` at that
stage does; their BN statistics still update.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn as nn

RESNET_SPECS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet26": ("bottleneck", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
    "resnet152": ("bottleneck", (3, 8, 36, 3)),
    "resnet200": ("bottleneck", (3, 24, 36, 3)),
}

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax's convention: new = 0.9·old + 0.1·batch (torch's 0.1)


class _FlaxStats:
    """Train-mode BatchNorm as flax computes it: the batch mean and the
    *biased* variance, E[x²] − E[x]² clipped at 0, in float32 at least
    (bf16 input promoted); x normalized as (x − mean)·(rsqrt(var + eps)·
    scale) + bias at that precision and returned in the input dtype;
    running statistics 0.9·old + 0.1·batch, with the biased variance
    (``nn.BatchNorm*d`` uses the unbiased one). Eval mode, and ``momentum=None`` (torch's cumulative
    average, for code that estimates statistics the torch way), are
    PyTorch's own.

    The moments are Σx / n and Σx² / n. With ``mesh`` set (a
    ``parallel.sharding.Mesh``; ``sync_batch_stats``), Σx, Σx² and n are
    summed over its ``data`` ranks by one differentiable all-reduce, so
    the statistics are the global batch's, pad rows included, as flax's
    under the reference's mesh. One process runs the same arithmetic
    without the all-reduce."""

    mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.momentum is None:
            return super().forward(x)
        dims = [0] + list(range(2, x.ndim))
        view = [1, -1] + [1] * (x.ndim - 2)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        c = xf.shape[1]
        sums = torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                          xf.new_full((1,), float(xf.numel() // c))])
        if self.mesh is not None:
            sums = self.mesh.all_reduce(sums)
        mean = sums[:c] / sums[2 * c:]
        var = torch.clamp(sums[c:2 * c] / sums[2 * c:] - mean * mean, min=0.0)
        if self.track_running_stats:
            with torch.no_grad():
                keep = 1.0 - self.momentum
                self.running_mean.copy_(keep * self.running_mean + (1.0 - keep) * mean)
                self.running_var.copy_(keep * self.running_var + (1.0 - keep) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(xf.dtype)
        y = (xf - mean.view(view)) * mul.view(view) + self.bias.to(xf.dtype).view(view)
        return y.to(x.dtype)


class FlaxBatchNorm2d(_FlaxStats, nn.BatchNorm2d):
    pass


class FlaxBatchNorm1d(_FlaxStats, nn.BatchNorm1d):
    pass


def sync_batch_stats(model: nn.Module, mesh) -> None:
    """Train-mode BatchNorm statistics of ``model`` over ``mesh``'s data
    ranks (None: this process's batch)."""
    for m in model.modules():
        if isinstance(m, _FlaxStats):
            m.mesh = mesh


def _bn(channels: int) -> nn.BatchNorm2d:
    return FlaxBatchNorm2d(channels, eps=BN_EPS, momentum=1.0 - BN_MOMENTUM)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = _bn(planes)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(out)) + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, 1, 0, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)  # v1.5
        self.bn2 = _bn(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, 1, 0, bias=False)
        self.bn3 = _bn(planes * 4)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        return torch.relu(self.bn3(self.conv3(out)) + identity)


class ResNet(nn.Module):
    """[B, C, H, W] → un-pooled features [B, F, H/32, W/32].

    ``first_stage``/``last_stage`` (1-based, inclusive) build only those
    stages; the stem exists only when first_stage is 1. A sliced model keeps
    the full model's parameter names (``layer{k}.{b}.*``), so a trunk and a
    tail state dict together are the full backbone's. ``stop_grad_stage``
    (1-based, 0 off; the train step sets it) runs everything before that
    stage under ``torch.no_grad()`` in train mode."""

    def __init__(self, block: str, stage_sizes, in_channels: int = 3,
                 first_stage: int = 1, last_stage: Optional[int] = None):
        super().__init__()
        self.stop_grad_stage = 0
        last = len(stage_sizes) if last_stage is None else last_stage
        if not 1 <= first_stage <= last <= len(stage_sizes):
            raise ValueError(f"stage slice [{first_stage}, {last}] out of range for "
                             f"{len(stage_sizes)} stages")
        self.block = block
        self.stage_sizes = tuple(stage_sizes)
        self.in_channels = in_channels
        self.first_stage, self.last_stage = first_stage, last
        cls = BasicBlock if block == "basic" else Bottleneck
        if first_stage == 1:
            self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
            self.bn1 = _bn(64)
            self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = 64 if first_stage == 1 else 64 * 2 ** (first_stage - 2) * cls.expansion
        for stage in range(first_stage, last + 1):
            planes = 64 * 2 ** (stage - 1)
            stride = 1 if stage == 1 else 2
            layers = []
            for b in range(stage_sizes[stage - 1]):
                s = stride if b == 0 else 1
                downsample = None
                if s != 1 or inplanes != planes * cls.expansion:
                    downsample = nn.Sequential(
                        nn.Conv2d(inplanes, planes * cls.expansion, 1, s, bias=False),
                        _bn(planes * cls.expansion),
                    )
                layers.append(cls(inplanes, planes, s, downsample))
                inplanes = planes * cls.expansion
            setattr(self, f"layer{stage}", nn.Sequential(*layers))
        self.num_features = inplanes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        boundary = self.stop_grad_stage if self.training else 0
        frozen = torch.no_grad() if boundary else contextlib.nullcontext()
        with frozen:
            if self.first_stage == 1:
                x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
            for stage in range(self.first_stage, min(boundary, self.last_stage + 1)):
                x = getattr(self, f"layer{stage}")(x)
        for stage in range(max(boundary, self.first_stage), self.last_stage + 1):
            x = getattr(self, f"layer{stage}")(x)
        return x


def create_resnet(name: str, in_channels: int = 3, first_stage: int = 1,
                  last_stage: Optional[int] = None) -> ResNet:
    if name not in RESNET_SPECS:
        raise ValueError(f"unknown backbone {name!r}; choose from {sorted(RESNET_SPECS)}")
    block, stages = RESNET_SPECS[name]
    return ResNet(block, stages, in_channels, first_stage, last_stage)


def backbone_num_features(name: str) -> int:
    return 512 if RESNET_SPECS[name][0] == "basic" else 2048


def fold_rgb_conv(conv1_weight: torch.Tensor) -> torch.Tensor:
    """Fold the reference's ``repeat(3,1,1)`` into the stem: the three input
    channels are identical, so summing conv1's kernel over its input axis
    gives a 1-channel conv with the same output. [O, 3, kh, kw] →
    [O, 1, kh, kw]."""
    return conv1_weight.sum(dim=1, keepdim=True)
