"""Host polyphase resampler (torchaudio ``sinc_interp_hann`` semantics).

The same kernel bank and sgemm formulation as the reference package's
``audio/dsp.resample_poly_np``, whose kernel bank lives in a module that
imports JAX; numpy only here.
"""

from __future__ import annotations

import functools
import math

import numpy as np


@functools.lru_cache(maxsize=32)
def sinc_kernels(orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
                 rolloff: float = 0.99) -> tuple:
    """(kernels [new_g, L] float32, width, orig_g, new_g)."""
    g = math.gcd(int(orig_freq), int(new_freq))
    orig_g, new_g = int(orig_freq) // g, int(new_freq) // g
    base_freq = min(orig_g, new_g) * rolloff
    width = math.ceil(lowpass_filter_width * orig_g / base_freq)
    idx = np.arange(-width, width + orig_g, dtype=np.float64)[None, :] / orig_g
    t = (-np.arange(new_g, dtype=np.float64)[:, None] / new_g + idx) * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2.0) ** 2
    t_pi = t * np.pi
    kernel = np.where(t == 0.0, 1.0, np.sin(t_pi) / np.where(t_pi == 0.0, 1.0, t_pi))
    return (kernel * window * base_freq / orig_g).astype(np.float32), width, orig_g, new_g


def resample_poly_np(y: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """[T] → [ceil(T · new/orig)] float32."""
    if orig_sr == new_sr:
        return np.asarray(y, np.float32)
    kernels, width, orig_g, new_g = sinc_kernels(orig_sr, new_sr)
    k = np.ascontiguousarray(kernels.T, np.float32)  # [L, new_g]
    T = len(y)
    xp = np.pad(np.asarray(y, np.float32), (width, width + orig_g))
    L = k.shape[0]
    n_pos = (len(xp) - L) // orig_g + 1
    frames = np.lib.stride_tricks.as_strided(
        xp, shape=(n_pos, L), strides=(xp.strides[0] * orig_g, xp.strides[0]))
    out = np.ascontiguousarray(frames) @ k
    return out.reshape(-1)[: int(math.ceil(new_g * T / orig_g))]
