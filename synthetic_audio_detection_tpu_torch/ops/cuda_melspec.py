"""The factored-DFT log-mel kernel (csrc/melspec_factored.cu) and its wrapper.

Counterpart of the reference package's ``ops/pallas_melspec.py``
(``fused_log_mel_factored`` / ``serving_log_mel``, kernel
``_factored_kernel``). [B, T] waveforms → [B, n_mels, n_frames] standardized
log-mel, or the clamped dB with ``standardize=False``.

For a tensor on the CPU the wrapper runs the plain version,
``ops.melspec.log_mel_factored`` at bf16 DFT precision. For a CUDA tensor it
launches the kernel or raises; it never falls back. The reflect pad and the
int16 dequantisation are plain tensor ops here; the kernel starts at the
padded signal.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from synthetic_audio_detection_tpu_torch.utils.config import SpectrogramConfig
from synthetic_audio_detection_tpu_torch.ops import build, melspec

SOURCE = "synthetic_audio_detection_tpu_torch/csrc/melspec_factored.cu"
REPLACES = "synthetic_audio_detection_tpu/ops/pallas_melspec.py:169"

_NCP_ALIGN = 64  # cos | sin columns padded so 2·ncp is a multiple of the 128-column tile


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def dequantize(waveforms: torch.Tensor) -> torch.Tensor:
    """int16 PCM transport → float32 in [-1, 1); float32 passes through."""
    if waveforms.dtype == torch.int16:
        return waveforms.float() / 32768.0
    if waveforms.dtype != torch.float32:
        raise TypeError(f"waveforms must be float32 or int16, got {waveforms.dtype}")
    return waveforms


class FactoredMelKernel:
    """Launches the kernel and counts its launches (``launches``, one per
    call that runs the kernel; the plain version on the CPU does not
    count)."""

    name = "melspec_factored"

    def __init__(self) -> None:
        self.launches = 0
        self._lib = None
        self._consts: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor, int, int]] = {}

    def load(self) -> ctypes.CDLL:
        """Build (at first use) and bind the library."""
        if self._lib is None:
            lib = build.load(self.name)
            lib.sad_melspec_factored.argtypes = (
                [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            lib.sad_melspec_factored.restype = ctypes.c_int
            lib.sad_cuda_error_string.argtypes = [ctypes.c_int]
            lib.sad_cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def _constants(self, cfg: SpectrogramConfig, sample_rate: int, device: torch.device):
        """(cos|sin transposed [2·ncp, hop] bf16, filterbank [n_sig, n_mels]
        f32, ncp, n_sig) on ``device``, built once per configuration. Keyed
        on the fields they depend on, so any object with a
        SpectrogramConfig's attributes shares one entry with an equal
        config."""
        key = (cfg.n_fft, cfg.hop_length, cfg.n_mels, cfg.f_min, cfg.f_max, cfg.mel_norm,
               cfg.mel_scale, sample_rate, str(device))
        if key not in self._consts:
            fb = melspec.config_filterbank(cfg, sample_rate)
            n_sig = melspec.significant_bins(fb)
            nraw = n_sig + 1  # guard bin for the f+1 Hann tap
            ncp = _round_up(nraw, _NCP_ALIGN)
            cos_m, sin_m = melspec._dft_matrices(cfg.n_fft, nraw)
            hop = cfg.hop_length
            cs_t = np.zeros((2 * ncp, hop), np.float32)
            cs_t[:nraw] = cos_m[:hop].T
            cs_t[ncp : ncp + nraw] = sin_m[:hop].T
            self._consts[key] = (
                torch.as_tensor(cs_t).to(device=device, dtype=torch.bfloat16).contiguous(),
                torch.as_tensor(np.ascontiguousarray(fb[:n_sig])).to(device),
                ncp,
                n_sig,
            )
        return self._consts[key]

    def __call__(self, waveforms: torch.Tensor, cfg: SpectrogramConfig,
                 sample_rate: int = 32_000, standardize: bool = True) -> torch.Tensor:
        if waveforms.device.type != "cuda":
            raise ValueError(f"the kernel takes CUDA tensors, got {waveforms.device}")
        if waveforms.ndim != 2:
            raise ValueError(f"waveforms must be [B, T], got {tuple(waveforms.shape)}")
        if cfg.n_fft != 4 * cfg.hop_length:
            raise ValueError("the kernel's combine phases need n_fft == 4·hop_length")
        if cfg.power != 2.0:
            raise ValueError("the kernel computes the power-2 spectrogram")
        x = dequantize(waveforms)
        blocks, n_frames = melspec.factored_blocks(x, cfg)  # [B, nb, hop], contiguous
        if not blocks.is_contiguous():
            raise ValueError("padded waveforms must be contiguous")
        B, nb, hop = blocks.shape
        cs_t, fb, ncp, n_sig = self._constants(cfg, sample_rate, x.device)
        n_mels = cfg.n_mels
        y = torch.empty((B * nb, 2 * ncp), dtype=torch.float32, device=x.device)
        mel = torch.empty((B, n_mels, n_frames), dtype=torch.float32, device=x.device)
        out = torch.empty_like(mel)
        lib = self.load()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.sad_melspec_factored(
            ctypes.c_void_p(blocks.data_ptr()), ctypes.c_void_p(cs_t.data_ptr()),
            ctypes.c_void_p(fb.data_ptr()), ctypes.c_void_p(y.data_ptr()),
            ctypes.c_void_p(mel.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            B, nb, hop, ncp, n_frames, n_sig, n_mels,
            float(cfg.top_db), float(cfg.eps), int(standardize),
            ctypes.c_void_p(stream))
        if rc != 0:
            msg = lib.sad_cuda_error_string(rc).decode()
            raise RuntimeError(f"{self.name} launch failed: CUDA error {rc} ({msg})")
        self.launches += 1
        return out


KERNEL = FactoredMelKernel()


def fused_log_mel_factored(waveforms: torch.Tensor, cfg: SpectrogramConfig,
                           sample_rate: int = 32_000,
                           standardize: bool = True) -> torch.Tensor:
    """[B, T] float32 or int16 → [B, n_mels, n_frames] float32. CPU: the
    plain version; CUDA: the kernel; any other device raises."""
    if waveforms.device.type == "cpu":
        return melspec.log_mel_factored(dequantize(waveforms), cfg, sample_rate,
                                        standardize=standardize,
                                        dft_dtype=torch.bfloat16)
    if waveforms.device.type != "cuda":
        raise ValueError(f"no log-mel kernel for device {waveforms.device}")
    return KERNEL(waveforms, cfg, sample_rate, standardize)


def serving_log_mel(waveforms: torch.Tensor, cfg: SpectrogramConfig,
                    sample_rate: int = 32_000) -> torch.Tensor:
    """The serving pipeline's mel front end (standardized)."""
    return fused_log_mel_factored(waveforms, cfg, sample_rate)
