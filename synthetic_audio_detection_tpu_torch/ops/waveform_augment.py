"""On-device waveform augmentation for training (the reference package's
``ops/waveform_augment.py``): per example, with probability
``wave_lowpass_prob`` a windowed-sinc low-pass at a cutoff ~
U[wave_lowpass_hz], then with probability ``wave_noise_prob`` white
Gaussian noise at an SNR ~ U[wave_snr_db] dB of the filtered signal's
power. Off (both probabilities 0) the trainer does not call it.

``augment_draw`` takes every random value from an explicit
``torch.Generator``; ``augment_apply`` is a plain function of the draws, so
the same draws give the same waveforms in both packages.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from synthetic_audio_detection_tpu_torch.parallel.sharding import rows_of


def lowpass_kernels(cutoffs_hz: torch.Tensor, taps: int, sample_rate: int) -> torch.Tensor:
    """[B] cutoffs → [B, taps] windowed-sinc FIRs, h[n] = 2fc·sinc(2fc(n −
    c))·hann(n), normalized to DC gain 1."""
    dev = cutoffs_hz.device
    fc = (cutoffs_hz / sample_rate)[:, None]
    n = torch.arange(taps, dtype=torch.float32, device=dev) - (taps - 1) / 2.0
    win = 0.5 - 0.5 * torch.cos(2.0 * torch.pi * torch.arange(taps, device=dev) / (taps - 1))
    h = 2.0 * fc * torch.sinc(2.0 * fc * n) * win.float()
    return h / torch.sum(h, dim=1, keepdim=True)


def batched_same_conv(wav: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """Each row of ``wav`` [B, T] correlated with its own kernel [B, taps],
    'same' padding ((taps − 1)//2 before, taps//2 after), as one grouped
    conv."""
    b = wav.shape[0]
    taps = kernels.shape[1]
    x = F.pad(wav[None], ((taps - 1) // 2, taps // 2))
    return F.conv1d(x, kernels[:, None, :], groups=b)[0]


def augment_draw(generator: Optional[torch.Generator], batch: int, samples: int, cfg,
                 device=None) -> Dict[str, torch.Tensor]:
    """{'cutoff_hz', 'lowpass' (bool), 'snr_db', 'noise_on' (bool) [B],
    'noise' [B, T] standard normal}; the low-pass or noise entries only
    when its probability is above 0."""
    out: Dict[str, torch.Tensor] = {}
    if cfg.wave_lowpass_prob > 0.0:
        lo, hi = cfg.wave_lowpass_hz
        out["cutoff_hz"] = lo + (hi - lo) * torch.rand(batch, generator=generator, device=device)
        out["lowpass"] = (torch.rand(batch, generator=generator, device=device)
                          < cfg.wave_lowpass_prob)
    if cfg.wave_noise_prob > 0.0:
        lo, hi = cfg.wave_snr_db
        out["snr_db"] = lo + (hi - lo) * torch.rand(batch, generator=generator, device=device)
        out["noise_on"] = (torch.rand(batch, generator=generator, device=device)
                           < cfg.wave_noise_prob)
        out["noise"] = torch.randn((batch, samples), generator=generator, device=device)
    return out


def augment_apply(wav: torch.Tensor, draws: Dict[str, torch.Tensor], cfg,
                  sample_rate: int) -> torch.Tensor:
    """[B, T] float32 → [B, T]: the drawn low-pass channel, then the drawn
    noise scaled to its SNR."""
    out = wav.float()
    if "lowpass" in draws:
        filt = batched_same_conv(out, lowpass_kernels(draws["cutoff_hz"], cfg.wave_taps,
                                                      sample_rate))
        out = torch.where(draws["lowpass"][:, None], filt, out)
    if "noise_on" in draws:
        p_sig = torch.mean(out * out, dim=1)
        sigma = torch.sqrt(p_sig * torch.pow(10.0, -draws["snr_db"] / 10.0) + 1e-20)
        noise = draws["noise"] * sigma[:, None]
        out = out + torch.where(draws["noise_on"][:, None], noise, torch.zeros_like(noise))
    return out


def augment_waveforms(generator: Optional[torch.Generator], wav: torch.Tensor, cfg,
                      sample_rate: int, rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``rows`` = (first row, global rows): ``wav`` holds those rows of a
    global batch, whose draws are made and cut to them
    (``parallel.sharding.rows_of``)."""
    b = wav.shape[0]
    draws = augment_draw(generator, rows[1] if rows else b, wav.shape[1], cfg, wav.device)
    return augment_apply(wav, rows_of(draws, rows, b), cfg, sample_rate)
