"""Seeded weights of a configuration, drawn on the device in a few large
calls, in the reference checkpoint's key space: per sub-model ``base.*``
(torchvision/timm ResNet names) and ``head.<index>.*`` (the binary head's
``nn.Sequential`` indices 2, 3, 6, 7, 10). Both the port and the reference
take them from here; the reference draws them again after the port's run.

Convs are He-normal (std √(2/fan_in)), Linear weights std √(1/fan_in) with
biases at 0.1·N(0,1); BatchNorm scales 1 + 0.1·N(0,1) (the last BN of
each block at half that, so the residual sums stay near unit scale),
shifts and running means 0.1·N(0,1), running variances exp(0.2·N(0,1)).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

Shape = Tuple[int, ...]


def substream(seed: int, tag: int) -> int:
    """A 63-bit seed for one use of ``seed`` (weights, traffic, step draws)."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + tag * 0xBF58476D1CE4E5B9) & (2**64 - 1)
    z ^= z >> 31
    return z & (2**63 - 1)


def backbone_shapes(model: Dict) -> List[Tuple[str, Shape]]:
    """(name, shape) of the backbone's tensors, in order, by its block."""
    from portbench.reference import backbone

    return backbone(model).shapes(model)


def head_shapes(model: Dict) -> List[Tuple[str, Shape]]:
    dims = [model["widths"][-1], *model["head_hidden"], model["outputs"]]
    out, idx = [], 2
    for j, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out += [(f"{idx}.weight", (b, a)), (f"{idx}.bias", (b,))]
        if j + 1 < len(dims) - 1:
            out += bn_shapes(str(idx + 1), b)
            idx += 4
    return out


def bn_shapes(prefix: str, c: int) -> List[Tuple[str, Shape]]:
    return [(f"{prefix}.{k}", (c,)) for k in ("weight", "bias", "running_mean", "running_var")]


def _shape_tensors(flat: torch.Tensor, shapes: Sequence[Tuple[str, Shape]]) -> Dict[str, torch.Tensor]:
    out, off = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        z = flat[off:off + n].view(shape)
        off += n
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight" and len(shape) == 4:
            z = z * math.sqrt(2.0 / math.prod(shape[1:]))
        elif leaf == "weight" and len(shape) == 2:
            z = z * math.sqrt(1.0 / shape[1])
        elif leaf == "weight":  # a BN scale
            half = name.endswith(("bn2.weight", "downsample.1.weight"))
            z = (1.0 + 0.1 * z) * (0.5 if half else 1.0)
        elif leaf == "running_var":
            z = torch.exp(0.2 * z)
        else:  # bias, running_mean
            z = 0.1 * z
        out[name] = z.contiguous()
    return out


def draw(model: Dict, seed: int, device) -> Dict[str, List[Dict[str, torch.Tensor]]]:
    """{'backbones': [state dict, ...] (one for the shared layout, one per
    head for the dense), 'heads': [state dict, ...]} float32 on ``device``."""
    b_shapes, h_shapes = backbone_shapes(model), head_shapes(model)
    n_bb = 1 if model["layout"] == "shared" else model["heads"]
    n_b = sum(math.prod(s) for _, s in b_shapes)
    n_h = sum(math.prod(s) for _, s in h_shapes)
    g = torch.Generator(device=device).manual_seed(substream(seed, 1))
    flat = torch.randn(n_bb * n_b + model["heads"] * n_h, generator=g, device=device)
    backbones = [_shape_tensors(flat[i * n_b:(i + 1) * n_b], b_shapes) for i in range(n_bb)]
    base = n_bb * n_b
    heads = [_shape_tensors(flat[base + i * n_h:base + (i + 1) * n_h], h_shapes)
             for i in range(model["heads"])]
    return {"backbones": backbones, "heads": heads}
