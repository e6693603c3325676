"""The layers a ResNet is built of, the binary heads and the ensemble as
plain functions of a state dict, float32. The backbone itself is the
configuration's block's module (``portbench.reference.backbone``).

BatchNorm is eval mode (running statistics) or train mode (the batch's
mean and biased variance, as flax normalizes). ``q`` rounds the operands
of every convolution and linear layer (the control's lower precision);
None keeps float32. Dropout, in train mode, keeps a unit where a uniform
draw is at least p and scales it by 1/(1 − p), the draws taken from the
step's generator in the head's order.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

Q = Optional[Callable[[torch.Tensor], torch.Tensor]]
EPS = 1e-5


class _Round(torch.autograd.Function):
    """Round in the forward pass to ``fwd``, and the incoming gradient in
    the backward pass to ``bwd``, each through ``_cast``."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return _cast(x, fwd)

    @staticmethod
    def backward(ctx, g):
        return _cast(g, ctx.bwd), None, None


def _cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to ``dtype`` and back to float32; an fp8 type with one scale
    for the tensor that maps its largest magnitude to the type's largest
    finite value, as fp8 matmuls are fed."""
    if dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        s = torch.clamp(x.abs().amax(), min=1e-30) / torch.finfo(dtype).max
        return (x / s).to(dtype).float() * s
    return x.to(dtype).float()


def quantizer(dtype: torch.dtype) -> Callable[[torch.Tensor], torch.Tensor]:
    """The operand rounding of a matmul in ``dtype`` with float32
    accumulation; for fp8 the gradients flowing back are rounded to e5m2,
    as fp8 training recipes keep them."""
    bwd = torch.float8_e5m2 if dtype == torch.float8_e4m3fn else dtype
    return lambda x: _Round.apply(x, dtype, bwd)


def _q(q: Q, x: torch.Tensor) -> torch.Tensor:
    return x if q is None else q(x)


def conv(x, w, stride, pad, q: Q):
    return F.conv2d(_q(q, x), _q(q, w), stride=stride, padding=pad)


def linear(x, w, b, q: Q):
    return F.linear(_q(q, x), _q(q, w)) + b


def batch_norm(x, sd, prefix, train: bool):
    g, b = sd[prefix + ".weight"], sd[prefix + ".bias"]
    dims = [0] + list(range(2, x.ndim))
    view = [1, -1] + [1] * (x.ndim - 2)
    if train:
        mean = x.mean(dim=dims)
        var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
    else:
        mean, var = sd[prefix + ".running_mean"], sd[prefix + ".running_var"]
    return (x - mean.view(view)) * (torch.rsqrt(var + EPS) * g).view(view) + b.view(view)


def head(pooled: torch.Tensor, sd: Dict[str, torch.Tensor], train: bool = False, q: Q = None,
         g: Optional[torch.Generator] = None, dropout=(0.5, 0.3)) -> torch.Tensor:
    """Pooled [B, F] → logits [B, outputs]: (Linear → BN → ReLU → Dropout)
    twice, then Linear."""
    x = pooled
    idx = 2
    for p in dropout:
        x = torch.relu(batch_norm(linear(x, sd[f"{idx}.weight"], sd[f"{idx}.bias"], q), sd,
                                  str(idx + 1), train))
        if train:
            keep = torch.rand(x.shape, generator=g, device=x.device) >= p
            x = torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
        idx += 4
    return linear(x, sd[f"{idx}.weight"], sd[f"{idx}.bias"], q)


def ensemble_logits(images: torch.Tensor, weights: Dict[str, List[Dict[str, torch.Tensor]]],
                    model: Dict, q: Q = None) -> torch.Tensor:
    """[B, H, W] images → [B, N+1] = [synthetic logit of each head, mean of
    the heads' Real logits] (index 0 Real, 1 Synthetic per head)."""
    from portbench.reference import backbone

    x = images[:, None].expand(-1, model["in_channels"], -1, -1)
    bbs, heads = weights["backbones"], weights["heads"]
    pooled = [backbone(model).forward(x, sd, model, q=q) for sd in bbs]
    per_head = torch.stack([head(pooled[0 if len(bbs) == 1 else i], sd, q=q)
                            for i, sd in enumerate(heads)])  # [N, B, 2]
    return torch.cat([per_head[:, :, 1].T, per_head[:, :, 0].mean(dim=0)[:, None]], dim=1)
