"""Batched log-mel front end in PyTorch (counterpart of the reference
package's ``ops/melspec.py``).

frame → periodic Hann → DFT → power → mel matmul → dB with the
per-spectrogram top-80 clamp → per-spectrogram standardize (unbiased std) →
bilinear resize, or the native zero-pad of the frame axis.

The host-side constants (filterbank, window, DFT matrices, combine phases)
are numpy, computed once per configuration. The tensor functions take and
return tensors on whatever device their input lies on.

``log_mel_factored`` is the plain version of the hand-written kernel in
``ops/cuda_melspec.py`` (factored block DFT, the Hann window applied in
frequency): with ``dft_dtype=torch.bfloat16`` it reproduces the kernel's
precision (bf16 DFT operands, float32 accumulation), with ``torch.float32``
it is the exact algorithm. ``log_mel_strip`` is that of
``ops/cuda_melspec_strip.py`` (one DFT per frame, the Hann window applied
in time), at the kernel's bf16 DFT precision.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from synthetic_audio_detection_tpu_torch.utils.config import SpectrogramConfig

_AMIN = 1e-10


# ---------------------------------------------------------------------------
# Host-side constants
# ---------------------------------------------------------------------------

def hz_to_mel(f, mel_scale: str = "htk") -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    if mel_scale == "htk":
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(f / min_log_hz) / logstep, mels)


def mel_to_hz(m, mel_scale: str = "htk") -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    if mel_scale == "htk":
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@functools.lru_cache(maxsize=16)
def mel_filterbank(
    n_freqs: int,
    f_min: float,
    f_max: float,
    n_mels: int,
    sample_rate: int,
    norm: Optional[str] = None,
    mel_scale: str = "htk",
) -> np.ndarray:
    """Triangular mel filterbank [n_freqs, n_mels] float32
    (torchaudio.functional.melscale_fbanks semantics; norm None or
    'slaney')."""
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    m_pts = np.linspace(hz_to_mel(f_min, mel_scale), hz_to_mel(f_max, mel_scale), n_mels + 2)
    f_pts = mel_to_hz(m_pts, mel_scale)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if norm == "slaney":
        fb = fb * (2.0 / (f_pts[2 : n_mels + 2] - f_pts[:n_mels]))[None, :]
    elif norm is not None:
        raise ValueError(f"unsupported mel norm: {norm!r}")
    return fb.astype(np.float32)


def config_filterbank(cfg: SpectrogramConfig, sample_rate: int) -> np.ndarray:
    return mel_filterbank(cfg.n_freqs, cfg.f_min, cfg.f_max, cfg.n_mels,
                          sample_rate, cfg.mel_norm, cfg.mel_scale)


@functools.lru_cache(maxsize=8)
def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (torch.hann_window(periodic=True))."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))).astype(np.float32)


def significant_bins(fb: np.ndarray, rel_tol: float = 1e-7) -> int:
    """Leading frequency bins with non-negligible mel weight: the bin on
    f_max carries only float dust from the mel↔Hz round trip, and a
    threshold at ``rel_tol × max(row_sum)`` drops it (768, not 769, at the
    32 kHz / f_max 12 kHz defaults)."""
    row_sums = fb.sum(axis=1)
    keep = np.nonzero(row_sums > rel_tol * row_sums.max())[0]
    return int(keep[-1]) + 1


def strip_filterbank(fb: np.ndarray) -> np.ndarray:
    """The filterbank rows the strip DFT multiplies: the significant bins
    rounded up to a multiple of 128 (768 at the defaults), rows past the
    last rFFT bin zero — the reference strip kernel's geometry."""
    n_bins = -(-significant_bins(fb) // 128) * 128
    rows = min(n_bins, fb.shape[0])
    out = np.zeros((n_bins, fb.shape[1]), np.float32)
    out[:rows] = fb[:rows]
    return out


def sparse_columns(fb: np.ndarray) -> tuple:
    """The filterbank [n_bins, n_mels] as spans: mel m sums bins lo[m] + j
    with weights w[off[m] + j] for j < off[m + 1] − off[m], the span from
    its first to its last nonzero weight (a triangle's support, so the
    weights inside are nonzero too). → (lo int32, off int32, w float32)."""
    lo = np.zeros(fb.shape[1], np.int32)
    off = np.zeros(fb.shape[1] + 1, np.int32)
    spans = []
    for m in range(fb.shape[1]):
        nz = np.nonzero(fb[:, m])[0]
        span = fb[nz[0]:nz[-1] + 1, m] if nz.size else fb[:0, m]
        lo[m] = nz[0] if nz.size else 0
        off[m + 1] = off[m] + span.size
        spans.append(span)
    return lo, off, np.concatenate(spans).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _dft_matrices(n_fft: int, n_cols: int) -> tuple:
    """Real/imag DFT matrices [n_fft, n_cols] float32."""
    k = np.arange(n_cols)[None, :]
    n = np.arange(n_fft)[:, None]
    ang = -2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def hop_block_phases(n_fft: int, hop: int, n_cols: int) -> tuple:
    """Combine phases (a, b) [k4, n_cols] of the factored DFT:
    a[i, f] + j·b[i, f] = exp(−2πj·i·hop·f / n_fft), k4 = n_fft / hop. The
    phase depends only on f mod k4, so at k4 = 4 every entry is 0 or ±1."""
    k4 = n_fft // hop
    f = np.arange(n_cols) % k4
    i = np.arange(k4)[:, None]
    ang = 2.0 * np.pi * i * f[None, :] / k4
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def _const(a: np.ndarray, like: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(a, device=like.device).to(dtype)


# ---------------------------------------------------------------------------
# Framing and spectrograms
# ---------------------------------------------------------------------------

def reflect_pad(x: torch.Tensor, pad: int, mode: str = "reflect") -> torch.Tensor:
    """[B, T] → [B, T + 2·pad] (numpy/jnp ``reflect``: edge not repeated)."""
    return F.pad(x[:, None, :], (pad, pad), mode=mode)[:, 0, :]


def frame_signal(x: torch.Tensor, n_fft: int, hop: int, center: bool,
                 pad_mode: str) -> torch.Tensor:
    """[B, T] → [B, n_frames, n_fft] frames (a strided view)."""
    if center:
        x = reflect_pad(x, n_fft // 2, pad_mode)
    return x.unfold(1, n_fft, hop)


def power_spectrogram(frames: torch.Tensor, window: torch.Tensor,
                      power: float = 2.0) -> torch.Tensor:
    """[B, n_frames, n_fft] → [B, n_frames, n_fft//2+1] power via rFFT."""
    spec = torch.fft.rfft((frames * window).float(), dim=-1)
    p = spec.real ** 2 + spec.imag ** 2
    return p if power == 2.0 else p ** (power / 2.0)


def _gemm_f32(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """a @ b with operands rounded to ``dtype`` and float32 accumulation
    (a product of two bf16 values is exact in float32, so upcasting the
    rounded operands gives the reduced-precision-operand matmul on any
    device)."""
    return torch.matmul(a.to(dtype).float(), b.to(dtype).float())


def power_spectrogram_gemm(frames: torch.Tensor, window: torch.Tensor,
                           n_cols: int, power: float = 2.0,
                           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """GEMM DFT over the first ``n_cols`` rFFT bins (the bins with mel
    weight): two real matmuls."""
    cos_m, sin_m = _dft_matrices(frames.shape[-1], n_cols)
    xw = frames * window
    re = _gemm_f32(xw, _const(cos_m, xw), dtype)
    im = _gemm_f32(xw, _const(sin_m, xw), dtype)
    p = re * re + im * im
    return p if power == 2.0 else p ** (power / 2.0)


def factored_blocks(waveforms: torch.Tensor, cfg: SpectrogramConfig) -> tuple:
    """[B, T] → (hop blocks [B, n_blocks, hop] of the centre-padded signal,
    n_frames). The signal is reflect-padded by n_fft/2 on both sides and
    zero-padded at the end to a hop multiple; the zero tail reaches only
    frames ≥ n_frames."""
    n_fft, hop = cfg.n_fft, cfg.hop_length
    if n_fft % hop or cfg.win != n_fft or not cfg.center:
        raise ValueError("factored DFT requires hop | n_fft == win, center")
    x = reflect_pad(waveforms, n_fft // 2, cfg.pad_mode)
    T = x.shape[1]
    n_frames = 1 + (T - n_fft) // hop
    if T % hop:
        x = F.pad(x, (0, hop - T % hop))
    return x.reshape(x.shape[0], -1, hop), n_frames


def power_spectrogram_factored(
    waveforms: torch.Tensor,
    cfg: SpectrogramConfig,
    n_cols: int,
    power: float = 2.0,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """[B, T] → [B, n_frames, n_cols] power via the factored block DFT.

    Each hop block's DFT at the full n_fft-point frequencies is ONE
    [hop] × [hop, 2·(n_cols+1)] product, shared by the k4 = n_fft/hop frames
    that contain the block. Frame t is X_t[f] = Σ_i c_i[f]·Y[t+i, f] with
    the {0, ±1} phases of hop_block_phases, and the periodic Hann window is
    the exact 3-tap conv 0.5·X[f] − 0.25·(X[f−1] + X[f+1]) with
    X[−1] = conj(X[1]). One guard bin (n_cols) feeds the f+1 tap of the
    last bin."""
    blocks, n_frames = factored_blocks(waveforms, cfg)
    k4 = cfg.n_fft // cfg.hop_length
    nraw = n_cols + 1
    cos_m, sin_m = _dft_matrices(cfg.n_fft, nraw)
    hop = cfg.hop_length
    y_re = _gemm_f32(blocks, _const(cos_m[:hop], blocks), dtype)
    y_im = _gemm_f32(blocks, _const(sin_m[:hop], blocks), dtype)
    a_np, b_np = hop_block_phases(cfg.n_fft, hop, nraw)
    x_re = torch.zeros_like(y_re[:, :n_frames])
    x_im = torch.zeros_like(x_re)
    for i in range(k4):
        a = _const(a_np[i], x_re)
        b = _const(b_np[i], x_re)
        yr = y_re[:, i : i + n_frames]
        yi = y_im[:, i : i + n_frames]
        x_re = x_re + a * yr - b * yi
        x_im = x_im + a * yi + b * yr
    r_re = torch.cat([x_re[..., 1:2], x_re[..., : n_cols - 1]], -1)
    r_im = torch.cat([-x_im[..., 1:2], x_im[..., : n_cols - 1]], -1)
    l_re = x_re[..., 1 : n_cols + 1]
    l_im = x_im[..., 1 : n_cols + 1]
    w_re = 0.5 * x_re[..., :n_cols] - 0.25 * (r_re + l_re)
    w_im = 0.5 * x_im[..., :n_cols] - 0.25 * (r_im + l_im)
    p = w_re * w_re + w_im * w_im
    return p if power == 2.0 else p ** (power / 2.0)


def amplitude_to_db(x: torch.Tensor, top_db: Optional[float] = 80.0) -> torch.Tensor:
    """Power → dB (torchaudio AmplitudeToDB(stype='power')):
    10·log10(max(x, 1e-10)), clamped from below at each spectrogram's
    max − top_db."""
    x_db = 10.0 * torch.log10(torch.clamp(x, min=_AMIN))
    if top_db is not None:
        ref = torch.amax(x_db, dim=(-2, -1), keepdim=True) - top_db
        x_db = torch.maximum(x_db, ref)
    return x_db


def standardize(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-spectrogram (x − mean) / (std + eps), unbiased std, two passes."""
    dims = tuple(range(1, x.ndim))
    n = math.prod(x.shape[1:])
    mean = torch.mean(x, dim=dims, keepdim=True)
    var = torch.sum((x - mean) ** 2, dim=dims, keepdim=True) / max(n - 1, 1)
    return (x - mean) / (torch.sqrt(var) + eps)


_standardize = standardize  # log_mel_factored's flag of the same name shadows it


def _log_mel_tail(p: torch.Tensor, fb: np.ndarray, cfg: SpectrogramConfig,
                  standardize: bool, lowp_tail: bool) -> torch.Tensor:
    """Power [B, n_frames, n_bins] → [B, n_mels, n_frames]: the mel product
    (float32, or bf16 operands with float32 accumulation under
    ``lowp_tail``), dB with the top_db clamp, then standardized unless
    ``standardize`` is False; bf16 out under ``lowp_tail``."""
    fb_t = _const(fb, p)
    mel = _gemm_f32(p, fb_t, torch.bfloat16) if lowp_tail else torch.matmul(p, fb_t)
    db = amplitude_to_db(mel.transpose(1, 2), cfg.top_db)
    out = _standardize(db, cfg.eps) if standardize else db
    return out.to(torch.bfloat16) if lowp_tail else out


def log_mel_factored(
    waveforms: torch.Tensor,
    cfg: SpectrogramConfig,
    sample_rate: int = 32_000,
    standardize: bool = True,
    dft_dtype: torch.dtype = torch.bfloat16,
    lowp_tail: bool = False,
) -> torch.Tensor:
    """[B, T] → [B, n_mels, n_frames]: the factored-DFT log-mel, standardized
    or stopped at the clamped dB. The plain version of the kernel in
    ops/cuda_melspec.py: a float32 mel matmul and float32 out, or with
    ``lowp_tail`` the power and filterbank rounded to bf16 for the mel
    matmul and bf16 out."""
    fb = config_filterbank(cfg, sample_rate)
    n_cols = significant_bins(fb)
    p = power_spectrogram_factored(waveforms.float(), cfg, n_cols, cfg.power, dft_dtype)
    return _log_mel_tail(p, fb[:n_cols], cfg, standardize, lowp_tail)


def log_mel_strip(waveforms: torch.Tensor, cfg: SpectrogramConfig,
                  sample_rate: int = 32_000) -> torch.Tensor:
    """[B, T] → [B, n_mels, n_frames] standardized log-mel through the strip
    DFT: each frame times the periodic Hann (float32, rounded once to bf16)
    against the bf16 cos|sin of the first ``strip_filterbank`` rows' bins,
    float32 accumulation, then the float32 mel product. The plain version
    of the kernel in ops/cuda_melspec_strip.py."""
    fb = strip_filterbank(config_filterbank(cfg, sample_rate))
    frames = frame_signal(waveforms.float(), cfg.n_fft, cfg.hop_length, cfg.center, cfg.pad_mode)
    window = _const(hann_window(cfg.n_fft), frames)
    p = power_spectrogram_gemm(frames, window, fb.shape[0], cfg.power, torch.bfloat16)
    return _log_mel_tail(p, fb, cfg, standardize=True, lowp_tail=False)


# ---------------------------------------------------------------------------
# Full front end
# ---------------------------------------------------------------------------

def mel_spectrogram(
    waveforms: torch.Tensor,
    cfg: SpectrogramConfig,
    sample_rate: int = 32_000,
    use_gemm_dft: bool = False,
    dft_mode: Optional[str] = None,
) -> torch.Tensor:
    """[B, T] → [B, n_mels, n_frames] power-mel spectrograms, all float32.
    dft_mode: 'fft' (rFFT), 'gemm' (GEMM DFT over the bins with mel weight)
    or 'factored'; None picks 'gemm' or 'fft' from use_gemm_dft."""
    mode = dft_mode or ("gemm" if use_gemm_dft else "fft")
    waveforms = waveforms.float()
    fb_np = config_filterbank(cfg, sample_rate)
    if mode == "factored":
        n_cols = significant_bins(fb_np)
        p = power_spectrogram_factored(waveforms, cfg, n_cols, cfg.power)
        fb_np = fb_np[:n_cols]
    else:
        frames = frame_signal(waveforms, cfg.n_fft, cfg.hop_length, cfg.center, cfg.pad_mode)
        window = _const(hann_window(cfg.win), frames)
        if mode == "gemm":
            n_cols = significant_bins(fb_np)
            p = power_spectrogram_gemm(frames, window, n_cols, cfg.power)
            fb_np = fb_np[:n_cols]
        else:
            p = power_spectrogram(frames, window, cfg.power)
    mel = torch.matmul(p, _const(fb_np, p))
    return mel.transpose(1, 2)


def finalize_features(z: torch.Tensor, cfg: SpectrogramConfig) -> torch.Tensor:
    """Standardized [B, n_mels, n_frames] → the model-input image [B, H, W].

    Square modes resize bilinearly (align_corners=False) with antialiasing,
    which is the reference package's ``jax.image.resize(..., "linear")``
    bit for bit at every size; without it the two agree only where the
    resize upsamples both axes (512², 256²) and differ by O(1) below the
    mel's own resolution (e.g. 64²). A bf16 ``z`` (``lowp_tail``) is
    resized in float32 and returned in bf16: PyTorch has no bf16
    antialiased resize on the CPU. Native mode
    (out_size 0) zero-pads the frame axis to a multiple of 128 — after
    standardizing, where zero is the mean."""
    if cfg.is_native:
        w = -(-z.shape[2] // 128) * 128
        return F.pad(z, (0, w - z.shape[2]))
    return F.interpolate(z[:, None].float(), size=(cfg.out_size, cfg.out_size),
                         mode="bilinear", align_corners=False,
                         antialias=True)[:, 0].to(z.dtype)


def log_mel_features(
    waveforms: torch.Tensor,
    cfg: SpectrogramConfig,
    sample_rate: int = 32_000,
    use_gemm_dft: bool = False,
    resize: bool = True,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """[B, T] → [B, H, W] standardized log-mel images (one channel)."""
    mel = mel_spectrogram(waveforms, cfg, sample_rate, use_gemm_dft)
    z = standardize(amplitude_to_db(mel, cfg.top_db), cfg.eps)
    if resize:
        z = finalize_features(z, cfg)
    return z.to(out_dtype)


def replicate_channels(x: torch.Tensor, channels: int = 3) -> torch.Tensor:
    """[B, H, W] → [B, C, H, W] by replication (the reference's
    ``repeat(3,1,1)``; NCHW, PyTorch's layout)."""
    return x[:, None].expand(x.shape[0], channels, *x.shape[1:])
