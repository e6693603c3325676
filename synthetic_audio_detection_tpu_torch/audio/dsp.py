"""Host-side DSP for offline ETL: STFT, phase-vocoder time stretch, pitch
shift (the port's copy of the reference package's ``audio/dsp.py``;
librosa-equivalent semantics, no librosa).

The reference augments audio with librosa.effects.time_stretch / pitch_shift:
a phase vocoder over an STFT (n_fft=2048, hop=n_fft//4, centered Hann) for
stretching; stretching by 2^(-steps/12) followed by resampling back to the
original rate for pitch.

NumPy only, and nothing here imports torch: the augmenter's worker
processes import this module, and stay free of CUDA and cheap to start.
``resample_poly_np`` is ``audio/resample.py``'s, on its kernel bank.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from synthetic_audio_detection_tpu_torch.audio.resample import resample_poly_np

__all__ = ["hann", "stft", "istft", "phase_vocoder", "time_stretch", "resample_poly_np",
           "pitch_shift"]


def hann(n: int) -> np.ndarray:
    """Symmetric Hann window of length n (librosa's default for stft)."""
    if n == 1:
        return np.ones(1)
    k = np.arange(n)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * k / (n - 1)))


def _hann_periodic(n: int) -> np.ndarray:
    k = np.arange(n)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * k / n))).astype(np.float64)


def stft(
    y: np.ndarray, n_fft: int = 2048, hop: Optional[int] = None, center: bool = True
) -> np.ndarray:
    """[T] → complex [1 + n_fft//2, n_frames]; centered reflect padding and a
    periodic Hann window (librosa.stft defaults)."""
    hop = hop or n_fft // 4
    w = _hann_periodic(n_fft)
    if center:
        y = np.pad(y, (n_fft // 2, n_fft // 2), mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop
    frames = np.lib.stride_tricks.as_strided(
        y,
        shape=(n_frames, n_fft),
        strides=(y.strides[0] * hop, y.strides[0]),
    )
    return np.fft.rfft(frames * w, axis=-1).T


def istft(
    D: np.ndarray,
    hop: Optional[int] = None,
    center: bool = True,
    length: Optional[int] = None,
) -> np.ndarray:
    """Inverse STFT with windowed overlap-add and squared-window normalization
    (librosa.istft semantics)."""
    n_fft = 2 * (D.shape[0] - 1)
    hop = hop or n_fft // 4
    w = _hann_periodic(n_fft)
    frames = np.fft.irfft(D.T, n=n_fft, axis=-1)
    n_frames = frames.shape[0]
    out_len = n_fft + hop * (n_frames - 1)
    out = np.zeros(out_len)
    norm = np.zeros(out_len)
    w2 = w * w
    for i in range(n_frames):
        s = i * hop
        out[s : s + n_fft] += frames[i] * w
        norm[s : s + n_fft] += w2
    out = out / np.maximum(norm, 1e-10)
    if center:
        out = out[n_fft // 2 :]
        if length is not None:
            out = out[:length]
        else:
            out = out[: out_len - n_fft]
    elif length is not None:
        out = out[:length]
    return out


def phase_vocoder(D: np.ndarray, rate: float, hop: Optional[int] = None) -> np.ndarray:
    """Speed up (rate>1) / slow down (rate<1) an STFT by phase accumulation
    (librosa.phase_vocoder algorithm)."""
    n_fft = 2 * (D.shape[0] - 1)
    hop = hop or n_fft // 4
    time_steps = np.arange(0, D.shape[1], rate)
    phi_advance = np.linspace(0, np.pi * hop, D.shape[0])

    # pad one empty column so step+1 is always valid
    Dp = np.pad(D, ((0, 0), (0, 2)))
    out = np.zeros((D.shape[0], len(time_steps)), dtype=complex)
    phase_acc = np.angle(Dp[:, 0])
    for t, step in enumerate(time_steps):
        i = int(step)
        alpha = step - i
        c0, c1 = Dp[:, i], Dp[:, i + 1]
        mag = (1.0 - alpha) * np.abs(c0) + alpha * np.abs(c1)
        out[:, t] = mag * np.exp(1j * phase_acc)
        dphase = np.angle(c1) - np.angle(c0) - phi_advance
        dphase -= 2.0 * np.pi * np.round(dphase / (2.0 * np.pi))
        phase_acc += phi_advance + dphase
    return out


def time_stretch(y: np.ndarray, rate: float, n_fft: int = 2048) -> np.ndarray:
    """librosa.effects.time_stretch: output length ≈ len(y)/rate."""
    if rate <= 0:
        raise ValueError("rate must be positive")
    hop = n_fft // 4
    D = stft(y.astype(np.float64), n_fft, hop)
    D2 = phase_vocoder(D, rate, hop)
    return istft(D2, hop, length=int(round(len(y) / rate))).astype(np.float32)


def pitch_shift(
    y: np.ndarray, sr: int, n_steps: float, bins_per_octave: int = 12
) -> np.ndarray:
    """librosa.effects.pitch_shift: stretch by 2^(-steps/bpo), resample back,
    fix to the original length.

    The resample ratio is approximated by a small rational (denominator ≤ 64,
    pitch error < 0.001 semitone): the polyphase kernel bank is
    [new_g, 2·width + orig_g] and an arbitrary ``round(sr/rate)`` can make
    gcd(orig, new) tiny, exploding the bank to hundreds of MB."""
    from fractions import Fraction

    rate = 2.0 ** (-float(n_steps) / bins_per_octave)
    stretched = time_stretch(y, rate)
    # want new/orig == rate (resampling sr/rate → sr speeds playback by rate)
    frac = Fraction(rate).limit_denominator(64)
    new_g, orig_g = frac.numerator, frac.denominator
    shifted = resample_poly_np(stretched, orig_g, new_g)
    if len(shifted) < len(y):
        shifted = np.pad(shifted, (0, len(y) - len(shifted)))
    return shifted[: len(y)].astype(np.float32)
