"""The log-mel front end: the DFT against the bins the filterbank needs,
one multiply-add per filterbank nonzero a frame, the resize, and the bytes
of the waveforms in and the features out.

The filterbank is built here from the spectrogram settings (torchaudio's
``melscale_fbanks``: HTK or Slaney mel scale, optional Slaney area norm),
not read from any kernel's tables. The DFT is counted as the factored form
needs it: each hop block of the centre-padded signal against bins 0 … n_sig,
where n_sig is the last bin with filterbank weight and one guard bin feeds
the Hann window's three-tap form. At [128, 128000] and the serving settings
that is 51.20 GFLOP.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from portbench.work.peaks import Work


def _hz_to_mel(f, scale: str):
    f = np.asarray(f, np.float64)
    if scale == "htk":
        return 2595.0 * np.log10(1.0 + f / 700.0)
    lin = f / (200.0 / 3)
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-12) / 1000.0) / (math.log(6.4) / 27.0),
                    lin)


def _mel_to_hz(m, scale: str):
    m = np.asarray(m, np.float64)
    if scale == "htk":
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    return np.where(m >= 15.0, 1000.0 * np.exp((math.log(6.4) / 27.0) * (m - 15.0)),
                    (200.0 / 3) * m)


def filterbank(spec: Dict, sample_rate: int) -> np.ndarray:
    """[n_fft/2 + 1, n_mels] triangular filters, float64."""
    n_freqs = spec["n_fft"] // 2 + 1
    freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    scale = spec.get("mel_scale", "htk")
    m = np.linspace(_hz_to_mel(spec["f_min"], scale), _hz_to_mel(spec["f_max"], scale),
                    spec["n_mels"] + 2)
    f_pts = _mel_to_hz(m, scale)
    diff = np.diff(f_pts)
    slopes = f_pts[None, :] - freqs[:, None]
    fb = np.maximum(0.0, np.minimum(-slopes[:, :-2] / diff[:-1], slopes[:, 2:] / diff[1:]))
    if spec.get("mel_norm") == "slaney":
        fb = fb * (2.0 / (f_pts[2:] - f_pts[:-2]))[None, :]
    return fb


def significant_bins(fb: np.ndarray) -> int:
    """Bins up to the last whose summed weight is above float dust (1e-7 of
    the largest row sum): 768 at 32 kHz, n_fft 2048, f_max 12 kHz."""
    rows = fb.sum(axis=1)
    return int(np.nonzero(rows > 1e-7 * rows.max())[0][-1]) + 1


def geometry(spec: Dict, T: int):
    """(hop blocks of the centre-padded window, frames)."""
    hop = spec["hop_length"]
    return -(-(T + spec["n_fft"]) // hop), 1 + T // hop


def log_mel(spec: Dict, sample_rate: int, n_windows: int, T: int,
            in_bytes_per_sample: int = 4) -> Dict[str, float]:
    """{'dft', 'mel', 'resize', 'bytes'} of one front-end call at
    [n_windows, T]: the standardized log-mel resized to out_size², float32
    out."""
    fb = filterbank(spec, sample_rate)
    n_sig = significant_bins(fb)
    nnz = int(np.count_nonzero(fb[:n_sig].astype(np.float32)))
    nb, frames = geometry(spec, T)
    hop = spec["hop_length"]
    out = spec["out_size"]
    # separable linear resize: the frame axis first, then the mel axis, two
    # taps an output when both axes upsample
    resize = 2.0 * 2 * (spec["n_mels"] * out + out * out)
    return {
        "dft": 2.0 * n_windows * nb * hop * 2 * (n_sig + 1),
        "mel": 2.0 * n_windows * frames * nnz,
        "resize": n_windows * resize,
        "bytes": n_windows * (T * in_bytes_per_sample + out * out * 4.0),
    }


def frontend_work(spec: Dict, sample_rate: int, n_windows: int, T: int,
                  in_bytes_per_sample: int = 4) -> Work:
    c = log_mel(spec, sample_rate, n_windows, T, in_bytes_per_sample)
    return Work(ops_bf16=c["dft"], ops_f32=c["mel"] + c["resize"], bytes=c["bytes"])
