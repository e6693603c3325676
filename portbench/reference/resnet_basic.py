"""A basic-block ResNet (He et al. 2016, Table 1; v1.5, the stride on the
3x3 conv) as a plain function of a state dict, and its tensors' shapes in
the torchvision/timm key space. A configuration whose ``model.block`` is
``basic`` runs here (``portbench.reference.backbone``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.resnet import Q, batch_norm, conv
from portbench.reference.weights import Shape, bn_shapes


def shapes(model: Dict) -> List[Tuple[str, Shape]]:
    """(name, shape) of a basic-block ResNet's tensors, in order."""
    w0 = model["widths"][0]
    out = [("conv1.weight", (w0, model["in_channels"], 7, 7))] + bn_shapes("bn1", w0)
    cin = w0
    for s, (n, f) in enumerate(zip(model["stages"], model["widths"]), start=1):
        for b in range(n):
            p = f"layer{s}.{b}."
            stride = 2 if (s > 1 and b == 0) else 1
            out += [(p + "conv1.weight", (f, cin, 3, 3))] + bn_shapes(p + "bn1", f)
            out += [(p + "conv2.weight", (f, f, 3, 3))] + bn_shapes(p + "bn2", f)
            if stride != 1 or cin != f:
                out += [(p + "downsample.0.weight", (f, cin, 1, 1))] + bn_shapes(p + "downsample.1", f)
            cin = f
    return out


def _block(x, sd, p, stride, train, q):
    out = torch.relu(batch_norm(conv(x, sd[p + "conv1.weight"], stride, 1, q), sd, p + "bn1", train))
    out = batch_norm(conv(out, sd[p + "conv2.weight"], 1, 1, q), sd, p + "bn2", train)
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
