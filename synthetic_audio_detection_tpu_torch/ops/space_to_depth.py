"""The H-only space-to-depth form of stage 1's stride-1 3x3 convs (the
part of the reference package's ``ops/space_to_depth.py`` that its
model-level ``s2d_stage1`` flag runs).

Rearranging [B, C, H, W] into [B, 2C, H/2, W] (``space_to_depth_h``) and
folding the [F, C, 3, 3] kernel into an exactly equivalent [2F, 2C, 3, 3]
kernel on the rearranged tensor computes the same conv at twice the
channel count and twice the nominal FLOPs (half the folded kernel's
entries are zero).

Derivation (r=2, padding 1): for output phase qy∈{0,1} and tap dy∈{0,1,2},
the original row offset qy+dy-1 lands on s2d row ty = floor((qy+dy-1)/2)
with phase py = (qy+dy-1) - 2*ty; ty ∈ {-1,0,1} maps to folded-kernel tap
ty+1 under padding 1. The W taps pass through. Zero padding commutes with
the rearrangement: only the phase-1 rows of the out-of-range s2d taps are
ever read, and those rows are the original zero padding.

Layout: NCHW, with the reference's (py, c) channel order, so a tensor here
equals the reference's under the NHWC↔NCHW permute. A rearrangement keeps
its input's layout: a ``channels_last`` tensor in (its NHWC view
contiguous, as the bf16 backbones hold activations), a ``channels_last``
one out; otherwise a contiguous one. Weights are [F, C, kh, kw]
(``nn.Conv2d``'s OIHW), the folded one with out (qy, f) and in (py, c).
The fold is ``torch.einsum`` over a one-hot map, so autograd reaches the
original kernel.

The conv is ``F.conv2d``. ``preferred_element_type`` follows the
reference's ``lax.conv`` argument with the port's precision rules: a dtype
(float32, the default) computes the conv of the operands' values in that
dtype, with TF32 off for float32 (``ops/precision.py``), so the products
of bf16 values are exact and their sums float32; None is ``F.conv2d`` on
the operands as they are (the conv of an ``nn.Conv2d``, under the caller's
autocast and TF32 flags).

The reference module's other reformulations (the both-axes fold, its
per-phase and merged variants, and the stem folds) serve only its fast
backbone's s2d options, which the port does not take: README, "Deliberately
not ported".
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from synthetic_audio_detection_tpu_torch.ops.precision import exact_float32


def _channels_last(x: torch.Tensor) -> bool:
    return x.is_contiguous(memory_format=torch.channels_last) and not x.is_contiguous()


def space_to_depth_h(x: torch.Tensor) -> torch.Tensor:
    """H-only s2d (r=2): [B, C, H, W] → [B, 2C, H/2, W]; channel (py, c)."""
    b, c, h, w = x.shape
    if not _channels_last(x):
        return x.reshape(b, c, h // 2, 2, w).permute(0, 3, 1, 2, 4).reshape(b, 2 * c, h // 2, w)
    y = x.permute(0, 2, 3, 1).reshape(b, h // 2, 2, w, c)
    return y.transpose(2, 3).reshape(b, h // 2, w, 2 * c).permute(0, 3, 1, 2)


def depth_to_space_h(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`space_to_depth_h`."""
    b, c2, h, w = x.shape
    c = c2 // 2
    if not _channels_last(x):
        return x.reshape(b, 2, c, h, w).permute(0, 2, 3, 1, 4).reshape(b, c, h * 2, w)
    y = x.permute(0, 2, 3, 1).reshape(b, h, w, 2, c)
    return y.transpose(2, 3).reshape(b, h * 2, w, c).permute(0, 3, 1, 2)


def _fold_map_h() -> np.ndarray:
    """One-hot map for H-only folding: M[ty, p, q, dy]."""
    m = np.zeros((3, 2, 2, 3), np.float32)
    for qy in range(2):
        for dy in range(3):
            vy = qy + dy - 1
            ty, py = vy // 2, vy % 2
            m[ty + 1, py, qy, dy] = 1.0
    return m


_FOLD_MAP_H = _fold_map_h()


@functools.lru_cache(maxsize=None)
def _device_map(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The one-hot map on ``device`` in ``dtype``, copied there once: a copy
    from host memory in every forward would wait for the device."""
    return torch.as_tensor(_FOLD_MAP_H, dtype=dtype, device=device)


def fold_conv3x3_s2d_h(w: torch.Tensor) -> torch.Tensor:
    """[F, C, 3, 3] → [2F, 2C, 3, 3]: H-only folding (2x nominal FLOPs at 2x
    channel width; the W taps pass through). Each entry is one weight or
    zero, exactly, with TF32 off for float32 (a TF32 matmul would round the
    weight)."""
    w = torch.as_tensor(w)
    f, c = w.shape[0], w.shape[1]
    # W'[(q,f), (p,c), ty, dx] = M[ty,p,q,dy] W[f,c,dy,dx]
    with exact_float32():
        wf = torch.einsum("tpqy,fcyx->qfpctx", _device_map(w.dtype, w.device), w)
    return wf.reshape(2 * f, 2 * c, 3, 3)


def conv3x3_s2d_h(x_s2dh: torch.Tensor, w_folded: torch.Tensor,
                  preferred_element_type: Optional[torch.dtype] = torch.float32
                  ) -> torch.Tensor:
    """[B, 2C, H/2, W] x [2F, 2C, 3, 3] → [B, 2F, H/2, W] (padding 1)."""
    exact = contextlib.nullcontext()
    if preferred_element_type is not None:
        x_s2dh, w_folded = x_s2dh.to(preferred_element_type), w_folded.to(preferred_element_type)
        if preferred_element_type == torch.float32:
            exact = exact_float32()
    with exact:
        return F.conv2d(x_s2dh, w_folded, padding=1)
