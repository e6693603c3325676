"""A bottleneck-block ResNet (He et al. 2016, Table 1: ResNet-50, -101 and
-152; v1.5, the stride on the 3x3 conv) as a plain function of a state
dict, and its tensors' shapes in the torchvision/timm key space. A
configuration whose ``model.block`` is ``bottleneck_v1_5`` runs here
(``portbench.reference.backbone``); v1, with the stride on the first 1x1
conv, computes another function and would have a module of its own.

``model.widths`` are the stages' output widths; each block works at a
quarter of its stage's width (1x1 reduce, 3x3, 1x1 expand by 4), and the
stem at a quarter of the first stage's (64 for Table 1's 256).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.resnet import Q, batch_norm, conv
from portbench.reference.weights import Shape, bn_shapes

EXPANSION = 4


def shapes(model: Dict) -> List[Tuple[str, Shape]]:
    """(name, shape) of a bottleneck ResNet's tensors, in order."""
    stem = model["widths"][0] // EXPANSION
    out = [("conv1.weight", (stem, model["in_channels"], 7, 7))] + bn_shapes("bn1", stem)
    cin = stem
    for s, (n, f) in enumerate(zip(model["stages"], model["widths"]), start=1):
        inner = f // EXPANSION
        for b in range(n):
            p = f"layer{s}.{b}."
            stride = 2 if (s > 1 and b == 0) else 1
            out += [(p + "conv1.weight", (inner, cin, 1, 1))] + bn_shapes(p + "bn1", inner)
            out += [(p + "conv2.weight", (inner, inner, 3, 3))] + bn_shapes(p + "bn2", inner)
            out += [(p + "conv3.weight", (f, inner, 1, 1))] + bn_shapes(p + "bn3", f)
            if stride != 1 or cin != f:
                out += [(p + "downsample.0.weight", (f, cin, 1, 1))] + bn_shapes(p + "downsample.1", f)
            cin = f
    return out


def _block(x, sd, p, stride, train, q):
    out = torch.relu(batch_norm(conv(x, sd[p + "conv1.weight"], 1, 0, q), sd, p + "bn1", train))
    out = torch.relu(batch_norm(conv(out, sd[p + "conv2.weight"], stride, 1, q), sd, p + "bn2",
                                train))
    out = batch_norm(conv(out, sd[p + "conv3.weight"], 1, 0, q), sd, p + "bn3", train)
    if p + "downsample.0.weight" in sd:
        x = batch_norm(conv(x, sd[p + "downsample.0.weight"], stride, 0, q), sd,
                       p + "downsample.1", train)
    return torch.relu(out + x)


def forward(x: torch.Tensor, sd: Dict[str, torch.Tensor], model: Dict, train: bool = False,
            q: Q = None, grad_from_stage: int = 1) -> torch.Tensor:
    """[B, C, H, W] → pooled features [B, F]. The stem and the stages before
    ``grad_from_stage`` run without autograd (the trainer's stop-gradient
    boundary)."""
    stages = model["stages"]

    def stage(x, s):
        for b in range(stages[s - 1]):
            x = _block(x, sd, f"layer{s}.{b}.", 2 if (s > 1 and b == 0) else 1, train, q)
        return x

    with torch.no_grad() if grad_from_stage > 1 else contextlib.nullcontext():
        x = torch.relu(batch_norm(conv(x, sd["conv1.weight"], 2, 3, q), sd, "bn1", train))
        x = F.max_pool2d(x, 3, 2, 1)
        for s in range(1, min(grad_from_stage, len(stages) + 1)):
            x = stage(x, s)
    for s in range(max(grad_from_stage, 1), len(stages) + 1):
        x = stage(x, s)
    return x.mean(dim=(2, 3))
