"""The strip-DFT log-mel kernel (csrc/melspec_strip.cu) and its wrapper.

Counterpart of the reference package's ``ops/pallas_melspec.py``
``fused_log_mel`` (kernel ``_kernel``): [B, T] float32 waveforms → [B,
n_mels, n_frames] standardized log-mel, one DFT per frame with the Hann
window applied in time. It computes what the factored kernel
(``ops/cuda_melspec.py``) computes, by the other formulation, and is the
mel-only front end's entry.

For a tensor on the CPU the wrapper runs the plain version,
``ops.melspec.log_mel_strip`` at bf16 DFT precision. For a CUDA tensor it
launches the kernel or raises; it never falls back. The reflect pad and the
zero tail to a hop multiple are plain tensor ops here; the kernel starts at
the padded signal.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from synthetic_audio_detection_tpu_torch.utils.config import SpectrogramConfig
from synthetic_audio_detection_tpu_torch.ops import build, melspec

SOURCE = "synthetic_audio_detection_tpu_torch/csrc/melspec_strip.cu"
REPLACES = "synthetic_audio_detection_tpu/ops/pallas_melspec.py:69"


class StripMelKernel:
    """Launches the kernel and counts its launches (``launches``, one per
    call that runs the kernel; the plain version on the CPU does not
    count)."""

    name = "melspec_strip"

    def __init__(self) -> None:
        self.launches = 0
        self._lib = None
        self._consts: Dict[Tuple, Dict[str, torch.Tensor]] = {}

    def load(self) -> ctypes.CDLL:
        """Build (at first use) and bind the library."""
        if self._lib is None:
            lib = build.load(self.name)
            lib.sad_melspec_strip.argtypes = (
                [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
            lib.sad_melspec_strip.restype = ctypes.c_int
            lib.sad_cuda_error_string.argtypes = [ctypes.c_int]
            lib.sad_cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def constants(self, cfg: SpectrogramConfig, sample_rate: int,
                  device: torch.device) -> Dict[str, torch.Tensor]:
        """On ``device``, built once per configuration: ``hann`` [n_fft]
        float32, ``cs`` [2·n_bins, n_fft] bf16 (row 2f the cos of bin f, row
        2f + 1 its sin), and the filterbank's spans ``lo``, ``off``, ``w``
        (``melspec.sparse_columns``). Keyed on the fields they depend on."""
        key = (cfg.n_fft, cfg.n_mels, cfg.f_min, cfg.f_max, cfg.mel_norm, cfg.mel_scale,
               sample_rate, str(device))
        if key not in self._consts:
            fb = melspec.strip_filterbank(melspec.config_filterbank(cfg, sample_rate))
            n_bins = fb.shape[0]
            cos_m, sin_m = melspec._dft_matrices(cfg.n_fft, n_bins)
            cs = np.empty((2 * n_bins, cfg.n_fft), np.float32)
            cs[0::2] = cos_m.T
            cs[1::2] = sin_m.T
            lo, off, w = melspec.sparse_columns(fb)
            self._consts[key] = {
                "hann": torch.as_tensor(melspec.hann_window(cfg.n_fft)).to(device),
                "cs": torch.as_tensor(cs).to(device=device, dtype=torch.bfloat16).contiguous(),
                "lo": torch.as_tensor(lo).to(device),
                "off": torch.as_tensor(off).to(device),
                "w": torch.as_tensor(w).to(device),
            }
        return self._consts[key]

    def __call__(self, waveforms: torch.Tensor, cfg: SpectrogramConfig,
                 sample_rate: int = 32_000) -> torch.Tensor:
        if waveforms.device.type != "cuda":
            raise ValueError(f"the kernel takes CUDA tensors, got {waveforms.device}")
        if waveforms.ndim != 2 or waveforms.dtype != torch.float32:
            raise ValueError(f"waveforms must be float32 [B, T], got {waveforms.dtype} "
                             f"{tuple(waveforms.shape)}")
        if cfg.power != 2.0:
            raise ValueError("the kernel computes the power-2 spectrogram")
        blocks, n_frames = melspec.factored_blocks(waveforms, cfg)  # padded, [B, nb, hop]
        x = blocks.reshape(blocks.shape[0], -1)
        if not x.is_contiguous():
            raise ValueError("padded waveforms must be contiguous")
        B, padded_len = x.shape
        c = self.constants(cfg, sample_rate, x.device)
        n_bins = c["cs"].shape[0] // 2
        powt = torch.empty((B, n_bins, n_frames), dtype=torch.float32, device=x.device)
        out = torch.empty((B, cfg.n_mels, n_frames), dtype=torch.float32, device=x.device)
        lib = self.load()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ptrs = [x, c["hann"], c["cs"], c["lo"], c["off"], c["w"], powt, out]
        rc = lib.sad_melspec_strip(
            *(ctypes.c_void_p(t.data_ptr()) for t in ptrs),
            B, padded_len, cfg.n_fft, cfg.hop_length, n_frames, n_bins, cfg.n_mels,
            float(cfg.top_db), float(cfg.eps), ctypes.c_void_p(stream))
        if rc != 0:
            msg = lib.sad_cuda_error_string(rc).decode()
            raise RuntimeError(f"{self.name} launch failed: CUDA error {rc} ({msg})")
        self.launches += 1
        return out


KERNEL = StripMelKernel()


def fused_log_mel(waveforms: torch.Tensor, cfg: SpectrogramConfig,
                  sample_rate: int = 32_000, windows_per_cell: int = 2,
                  stack_windows: bool = False) -> torch.Tensor:
    """[B, T] float32 → [B, n_mels, n_frames] float32 standardized log-mel.
    CPU: the plain version; CUDA: the kernel; any other device, or any
    other dtype, raises.

    ``windows_per_cell`` and ``stack_windows`` are the TPU grid's packing
    (windows per grid cell, a ``windows_per_cell`` that does not divide B
    becoming 1, and M-stacked strips). The reference shows they change no
    value, and nothing here has a grid to pack: they are accepted for the
    reference's signature and select nothing."""
    del windows_per_cell, stack_windows
    if waveforms.dtype != torch.float32:
        raise TypeError(f"waveforms must be float32, got {waveforms.dtype}")
    if waveforms.device.type == "cpu":
        return melspec.log_mel_strip(waveforms, cfg, sample_rate)
    if waveforms.device.type != "cuda":
        raise ValueError(f"no log-mel kernel for device {waveforms.device}")
    return KERNEL(waveforms, cfg, sample_rate)
