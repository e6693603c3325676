"""The one traffic generator: seeded pools of audio made on the device in
bulk, and the schedules that a traffic file's parameters describe.

Every seed gets the same sizes (clip lengths, batch rows); the seed
changes the audio, the offsets into the pool and the order.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

from portbench.reference.weights import substream

POOL, SCHEDULE = 2, 3


def window_pool(n: int, samples: int, sample_rate: int, seed: int, device,
                chunk: int = 256) -> np.ndarray:
    """[n, samples] float32 windows of coloured noise, each with its own
    spectral tilt (white to brown), level (−6 to −30 dB RMS) and slow
    amplitude modulation, all far above the silence gate; made on
    ``device`` in chunks and copied to the host."""
    g = torch.Generator(device=device).manual_seed(substream(seed, POOL))
    out = np.empty((n, samples), np.float32)
    t = torch.arange(samples, device=device, dtype=torch.float32) / sample_rate
    bins = samples // 2 + 1
    f = torch.arange(bins, device=device, dtype=torch.float32).clamp(min=1.0) / bins
    for i in range(0, n, chunk):
        m = min(chunk, n - i)
        u = torch.rand((m, 3), generator=g, device=device)
        white = torch.randn((m, samples), generator=g, device=device)
        spec = torch.fft.rfft(white, dim=1) * f[None] ** (-u[:, :1])
        x = torch.fft.irfft(spec, n=samples, dim=1)
        level = 10.0 ** (-(6.0 + 24.0 * u[:, 1:2]) / 20.0)
        x = x / x.std(dim=1, keepdim=True) * level
        x = x * (0.75 + 0.25 * torch.sin(2 * math.pi * (0.5 + 4.0 * u[:, 2:3]) * t[None]))
        out[i:i + m] = x.clamp(-0.99, 0.99).cpu().numpy()
    return out


def pcm16(x: np.ndarray) -> np.ndarray:
    return np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)


def even_lengths(lo: int, hi: int, k: int) -> List[int]:
    """k lengths spread evenly over [lo, hi]: the same set for every seed."""
    return [round(lo + j * (hi - lo) / (k - 1)) for j in range(k)] if k > 1 else [lo]


def clip_offsets(lengths: Sequence[int], pool_rows: int, seed: int) -> List[int]:
    """A seeded start row in the pool for each clip."""
    rng = np.random.default_rng(substream(seed, SCHEDULE))
    return [int(rng.integers(0, pool_rows - n + 1)) for n in lengths]


def cycle_order(k: int, seed: int, stream: int = SCHEDULE):
    """Endless clip indices: a fresh seeded permutation of 0..k−1 each cycle."""
    rng = np.random.default_rng(substream(seed, stream + 1))
    while True:
        yield from (int(i) for i in rng.permutation(k))
