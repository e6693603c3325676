"""Counterparts of the reference package's ``ops/pallas_conv_flat.py``:
``conv3x3_bn_relu_flat`` (kernel ``_flat_kernel``) and
``conv3x3_bn_relu_flat_static`` (``_flat_static_kernel``).

On the TPU these compute the stride-1 3x3 conv + affine (+ReLU) on the
zero-padded image flattened to rows, each tap a contiguous row offset, with
the padding columns computed as junk and sliced off afterwards; the static
variant unrolls the tile loop to get past a TPU compiler limit. Both are the
function of ``ops/cuda_conv.py``, and both run its kernel
(csrc/conv3x3_wgmma.cu), which needs neither the flattened copy nor the
junk columns. ``tile_rows`` is validated as the reference validates it
(it must divide H·(W+2)) and selects nothing on the kernel; ``k_pack`` has
no effect.
"""

from __future__ import annotations

from typing import Optional

import torch

from synthetic_audio_detection_tpu_torch.ops import cuda_conv


def _check_tile_rows(x: torch.Tensor, tile_rows: Optional[int]) -> None:
    if x.ndim != 4:
        raise ValueError(f"x must be [B, H, W, C], got {tuple(x.shape)}")
    n_out = x.shape[1] * (x.shape[2] + 2)  # flat output rows, junk columns included
    if tile_rows is not None and (tile_rows <= 0 or n_out % tile_rows):
        raise ValueError(f"tile_rows {tile_rows} must divide H·(W+2) = {n_out}")


def conv3x3_bn_relu_flat(
    x: torch.Tensor,
    w: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    relu: bool = True,
    tile_rows: Optional[int] = None,
    k_pack: Optional[bool] = None,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """[B, H, W, C] × [3, 3, C, F] → [B, H, W, F], stride-1 SAME, fused
    per-channel affine (+ReLU)."""
    _check_tile_rows(x, tile_rows)
    return cuda_conv.run(x, w, scale, bias, 1, relu, out_dtype)


def conv3x3_bn_relu_flat_static(
    x: torch.Tensor,
    w: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    relu: bool = True,
    tile_rows: Optional[int] = None,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """The unrolled flat variant's entry: the same function as
    ``conv3x3_bn_relu_flat``."""
    _check_tile_rows(x, tile_rows)
    return cuda_conv.run(x, w, scale, bias, 1, relu, out_dtype)
