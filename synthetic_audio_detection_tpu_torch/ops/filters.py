"""Temporal smoothing of per-window probabilities (the reference package's
``ops/filters.py``): ``scipy.ndimage.gaussian_filter1d`` semantics, and the
legacy analyzer's ``scipy.signal.medfilt``."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=16)
def _gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """scipy's order-0 kernel: radius int(truncate·σ + 0.5), normalized."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _reflect_index(n: int, radius: int) -> np.ndarray:
    """Source index of each position of a length-n axis padded by ``radius``
    in scipy's 'reflect' mode (d c b a | a b c d | d c b a), repeated as
    often as the radius needs."""
    i = np.arange(-radius, n + radius) % (2 * n)
    return np.where(i < n, i, 2 * n - 1 - i)


def gaussian_filter1d(x: torch.Tensor, sigma: float, axis: int = 0,
                      truncate: float = 4.0) -> torch.Tensor:
    """Gaussian smoothing along ``axis`` (float32)."""
    k = torch.as_tensor(_gaussian_kernel1d(sigma, truncate), device=x.device)
    radius = (k.shape[0] - 1) // 2
    x = torch.movedim(x.float(), axis, -1)
    shape = x.shape
    n = shape[-1]
    flat = x.reshape(-1, 1, n)
    idx = torch.as_tensor(_reflect_index(n, radius), device=x.device)
    y = F.conv1d(flat[..., idx], k[None, None, :])
    return torch.movedim(y.reshape(shape), -1, axis)


def median_filter1d(x: torch.Tensor, kernel_size: int = 5, axis: int = -1) -> torch.Tensor:
    """Median over ``kernel_size`` neighbours along ``axis`` with
    ``scipy.signal.medfilt``'s semantics: zero padding at the edges, an odd
    kernel."""
    if kernel_size % 2 != 1:
        raise ValueError("kernel_size must be odd")
    r = kernel_size // 2
    x = torch.movedim(x, axis, -1)
    windows = F.pad(x, (r, r)).unfold(-1, kernel_size, 1)  # [..., n, k]
    return torch.movedim(windows.median(dim=-1).values, -1, axis)
