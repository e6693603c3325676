"""RandomResizedCrop on spectrogram images (the reference package's
``ops/image.py``): per image, a crop of random area (scale) and aspect
(log-uniform ratio) at a uniform position, resized back to (H, W) by the
bilinear affine resample of ``jax.image.scale_and_translate(method=
"linear", antialias=False)``: output pixel p samples input
(p + ½)·h/H + i − ½ with a unit triangle kernel, the weights of each output
pixel normalized to sum 1 and zeroed where the sample falls outside the
image.

``random_resized_crop_draw`` takes its uniforms from an explicit
``torch.Generator``; ``random_resized_crop_apply`` is a plain function of
the drawn boxes (i, j, h, w), so the same boxes give the same images in
both packages.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from synthetic_audio_detection_tpu_torch.parallel.sharding import rows_of

_F32_EPS = float(np.finfo(np.float32).eps)


def random_resized_crop_draw(
    generator: Optional[torch.Generator], batch: int, height: int, width: int,
    scale: Tuple[float, float] = (0.8, 1.0),
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0), device=None,
) -> Dict[str, torch.Tensor]:
    """{'i', 'j', 'h', 'w'} [B] float32: the crop's top, left, height and
    width, the box clamped to the image (the reference clamps rather than
    re-draws)."""
    u = torch.rand((4, batch), generator=generator, device=device)
    area = height * width * (scale[0] + (scale[1] - scale[0]) * u[0])
    lo, hi = math.log(ratio[0]), math.log(ratio[1])
    aspect = torch.exp(lo + (hi - lo) * u[1])
    w = torch.clamp(torch.sqrt(area * aspect), 1.0, float(width))
    h = torch.clamp(torch.sqrt(area / aspect), 1.0, float(height))
    return {"i": u[2] * (height - h), "j": u[3] * (width - w), "h": h, "w": w}


def _weights(in_size: int, out_size: int, scale: torch.Tensor,
             translation: torch.Tensor) -> torch.Tensor:
    """[B, in, out] linear resample weights (jax.image's compute_weight_mat
    with antialias off)."""
    dev = scale.device
    inv = 1.0 / scale
    sample = ((torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5) * inv[:, None]
              - (translation * inv)[:, None] - 0.5)
    x = torch.abs(sample[:, None, :]
                  - torch.arange(in_size, dtype=torch.float32, device=dev)[None, :, None])
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * _F32_EPS,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, None, :], w, torch.zeros_like(w))


def random_resized_crop_apply(images: torch.Tensor, box: Dict[str, torch.Tensor]) -> torch.Tensor:
    """images [B, H, W] → [B, H, W], each resampled from its box."""
    _, H, W = images.shape
    sy, sx = H / box["h"], W / box["w"]
    wy = _weights(H, H, sy, -box["i"] * sy).to(images.dtype)
    wx = _weights(W, W, sx, -box["j"] * sx).to(images.dtype)
    return torch.einsum("bhw,bhi,bwj->bij", images, wy, wx)


def random_resized_crop(generator: Optional[torch.Generator], images: torch.Tensor,
                        scale: Tuple[float, float] = (0.8, 1.0),
                        ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
                        rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``rows``: as ``waveform_augment.augment_waveforms``'s."""
    b, h, w = images.shape
    box = random_resized_crop_draw(generator, rows[1] if rows else b, h, w, scale, ratio,
                                   images.device)
    return random_resized_crop_apply(images, rows_of(box, rows, b))
