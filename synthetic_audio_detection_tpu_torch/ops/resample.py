"""Polyphase windowed-sinc resampling on the device (the reference
package's ``ops/resample.py``; torchaudio ``sinc_interp_hann`` semantics).

The same kernel bank as the host resampler (``audio/resample.sinc_kernels``,
``[new_g, L]``), applied as one strided ``F.conv1d``: ``new_g`` polyphase
filters with stride ``orig_g``, whose phases interleave into the output.
The reference computes it as an XLA convolution, not a Pallas kernel, so
the library convolution is its counterpart here; it runs inside
``exact_float32()`` so that cuDNN does not round its operands to TF32.

No serving path calls it: the pipeline, the server and the streams
resample on the host (``resample_poly_np``), as the reference's do. Its
reference's only caller is a benchmark's device-resample option.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from synthetic_audio_detection_tpu_torch.audio.resample import sinc_kernels
from synthetic_audio_detection_tpu_torch.ops.precision import exact_float32


def resample(waveform: torch.Tensor, orig_freq: int, new_freq: int,
             lowpass_filter_width: int = 6, rolloff: float = 0.99) -> torch.Tensor:
    """[..., T] → [..., ceil(T · new/orig)] float32, on ``waveform``'s
    device."""
    if orig_freq == new_freq:
        return waveform
    bank, width, orig_g, new_g = sinc_kernels(orig_freq, new_freq, lowpass_filter_width,
                                              rolloff)
    kernels = torch.as_tensor(bank, device=waveform.device)[:, None, :]  # [new_g, 1, L]
    shape = waveform.shape
    T = shape[-1]
    # `width` zeros left, `width + orig_g` right (covers the final frame)
    x = F.pad(waveform.reshape(-1, 1, T).float(), (width, width + orig_g))
    with exact_float32():
        y = F.conv1d(x, kernels, stride=orig_g)  # [B, new_g, K]
    # interleave the phases: out[k * new_g + i] = y[i, k]
    out = y.transpose(1, 2).reshape(y.shape[0], -1)
    target = int(math.ceil(new_g * T / orig_g))
    return out[:, :target].reshape(*shape[:-1], target)


def resample_bucketed(waveform: np.ndarray, orig_freq: int, new_freq: int,
                      bucket_seconds: float = 60.0, device: Any = "cuda") -> np.ndarray:
    """Resample a host waveform of any length on ``device`` (the GPU unless
    the caller asks for the CPU). The input is zero-padded up to a multiple
    of ``bucket_seconds``, so each (orig, new, bucket count) is one input
    shape, as in the reference; zero padding is exact (the polyphase conv
    zero-pads its tail anyway), so trimming to ceil(T·new/orig) gives
    ``resample`` of the unpadded signal to float tolerance."""
    waveform = np.asarray(waveform, np.float32)
    if orig_freq == new_freq:
        return waveform
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but CUDA is not available")
    T = waveform.shape[-1]
    bucket = max(int(bucket_seconds * orig_freq), 1)
    padded = -(-T // bucket) * bucket
    x = np.pad(waveform, [(0, 0)] * (waveform.ndim - 1) + [(0, padded - T)])
    y = resample(torch.from_numpy(x).to(device), int(orig_freq), int(new_freq)).cpu().numpy()
    g = math.gcd(int(orig_freq), int(new_freq))
    target = int(math.ceil(int(new_freq) // g * T / (int(orig_freq) // g)))
    return y[..., :target]
