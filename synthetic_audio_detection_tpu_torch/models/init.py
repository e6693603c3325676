"""The initial weights the reference package trains from: flax's defaults.

``flax.linen.Conv`` and ``Dense`` draw their kernels from ``lecun_normal``
(a normal truncated at ±2σ whose std, after the truncation, is
1/√fan_in) and start their biases at zero; ``BatchNorm`` starts at scale 1,
bias 0, mean 0 and variance 1. PyTorch's own defaults differ
(``kaiming_uniform(a=√5)``: std·√fan_in = 1/√3, and uniform biases), so a
trainer that builds a fresh model draws these instead. Weights loaded for
serving or for a resume are never re-drawn.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

# the std of a unit normal truncated at ±2 (flax's variance_scaling divides by it)
TRUNCATED_STD = 0.87962566103423978


@torch.no_grad()
def flax_default_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw every Conv2d and Linear weight of ``module`` in place from a
    normal truncated at ±2σ, σ = 1/√fan_in / 0.8796 (fan_in = in_channels·
    kh·kw for a conv, in_features for a Linear), their biases zero, and
    reset every BatchNorm to weight 1, bias 0, running mean 0 and running
    variance 1. The draws come from ``generator`` (on the parameters'
    device), in the module's order; → ``module``."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            std = 1.0 / math.sqrt(fan_in) / TRUNCATED_STD
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
    return module
