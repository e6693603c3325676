"""The strip-DFT log-mel kernel (csrc/melspec_strip.cu) and its wrapper.

Counterpart of the reference package's ``ops/pallas_melspec.py``
``fused_log_mel`` (kernel ``_kernel``): [B, T] float32 waveforms → [B,
n_mels, n_frames] standardized log-mel, one DFT per frame with the Hann
window applied in time. It computes what the factored kernel
(``ops/cuda_melspec.py``) computes, by the other formulation, and is the
mel-only front end's entry.

For a tensor on the CPU the wrapper runs the plain version,
``ops.melspec.log_mel_strip`` at bf16 DFT precision. For a CUDA tensor it
launches the kernel or raises; it never falls back. The kernel starts at
the unpadded float32 waveforms: the reflect pad, the zero tail, the Hann
window and the one rounding to bf16 are its first launch.

The kernel's host tables are plain functions, so the CPU tests can hold its
decomposition against the plain version: ``band_plan`` (the factored
kernel's rule, without its halo bin and phase alignment), the factored
kernel's ``band_tables`` (each band's mel product as two running sums) and
``tiles`` (the tiles of frame rows); ``work`` counts the operations of a
call. The tile and band sizes are the kernel's compile-time constants: the
wrapper passes its own to the kernel, which refuses a call planned for
other sizes.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from synthetic_audio_detection_tpu_torch.utils.config import SpectrogramConfig
from synthetic_audio_detection_tpu_torch.ops import build, cuda_melspec, melspec

SOURCE = "synthetic_audio_detection_tpu_torch/csrc/melspec_strip.cu"
REPLACES = "synthetic_audio_detection_tpu/ops/pallas_melspec.py:69"

# csrc/melspec_strip.cu: a tile is 128 frame rows (hop blocks, counted over
# all windows back to back; a row starts the frame that reads it and the
# next n_fft/hop − 1 rows of the other strips), a band 128 bins f0 … f0 + 127
TILE_ROWS = 128
BAND_BINS = 128
KSTEP = 64  # hop must be a multiple of the kernel's K-step
# the kernel's tiles of one band to a thread block cluster, sharing the
# band's cos|sin loads (TMA multicast); the grid holds whole clusters
CLUSTER = 2


def band_plan(lo: np.ndarray, off: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The factored kernel's band plan (``cuda_melspec.band_plan``) at
    BAND_BINS bins a band: the strip DFT needs no Hann-tap halo and has no
    phases, so a band starts at its first mel's first bin."""
    return cuda_melspec.band_plan(lo, off, width=BAND_BINS, align=1)


def tiles(n_windows: int, nb: int, n_frames: int) -> int:
    """Tiles of TILE_ROWS rows over all windows' rows back to back that hold
    every frame's first row, rounded up to whole clusters."""
    n = cuda_melspec.row_tiles(n_windows, nb, n_frames, TILE_ROWS)
    return -(-n // CLUSTER) * CLUSTER


def work(c: Dict[str, torch.Tensor], cfg: SpectrogramConfig, n_windows: int, T: int
         ) -> Dict[str, float]:
    """Operations (two a multiply-add) of one call at [n_windows, T], for
    the constants ``c`` of ``StripMelKernel.constants``: ``dft_min`` and
    ``mel_min``, what the function needs (each frame's DFT against the
    table's bins; one multiply-add a frame per filterbank nonzero), and
    ``dft`` and ``mel``, what this tiling does (every tile against every
    band, the rows that start no frame and the bands' overlap included;
    each parity's running sum over whole groups of 4 bins)."""
    nb, n_frames = cuda_melspec.geometry(T, cfg)
    n_bins = c["cs"].shape[0] // 2
    steps = 4 * int((c["quads"][..., 1] - c["quads"][..., 0]).sum())
    return {
        "dft_min": 2.0 * n_windows * n_frames * cfg.n_fft * 2 * n_bins,
        "mel_min": 2.0 * n_windows * n_frames * int(torch.count_nonzero(c["weights"])),
        "dft": 2.0 * tiles(n_windows, nb, n_frames) * TILE_ROWS * c["f0"].numel()
               * 2 * BAND_BINS * cfg.n_fft,
        "mel": 2.0 * n_windows * n_frames * steps,
    }


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
                [ctypes.c_void_p] * 10 + [ctypes.c_int] * 12
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
        2f + 1 its sin, over the ``strip_filterbank`` rows' bins), the
        bands' ``f0`` (``band_plan``) and their mel tables
        (``cuda_melspec.band_tables``: ``weights``, ``ends``, ``quads``).
        Keyed on the fields they depend on."""
        key = (cfg.n_fft, cfg.n_mels, cfg.f_min, cfg.f_max, cfg.mel_norm, cfg.mel_scale,
               sample_rate, BAND_BINS, str(device))
        if key not in self._consts:
            fb = melspec.strip_filterbank(melspec.config_filterbank(cfg, sample_rate))
            n_bins = fb.shape[0]
            cos_m, sin_m = melspec._dft_matrices(cfg.n_fft, n_bins)
            cs = np.empty((2 * n_bins, cfg.n_fft), np.float32)
            cs[0::2] = cos_m.T
            cs[1::2] = sin_m.T
            lo, off, w = melspec.sparse_columns(fb)
            f0, edges = band_plan(lo, off)
            tables = cuda_melspec.band_tables(lo, off, w, f0, edges, bins=BAND_BINS, first=0)
            c = {k: torch.as_tensor(v).to(device) for k, v in tables.items()}
            c["f0"] = torch.as_tensor(f0).to(device)
            c["hann"] = torch.as_tensor(melspec.hann_window(cfg.n_fft)).to(device)
            c["cs"] = torch.as_tensor(cs).to(device=device, dtype=torch.bfloat16).contiguous()
            self._consts[key] = c
        return self._consts[key]

    def __call__(self, waveforms: torch.Tensor, cfg: SpectrogramConfig,
                 sample_rate: int = 32_000) -> torch.Tensor:
        """The standardized log-mel of ``waveforms`` on the card."""
        if waveforms.device.type != "cuda":
            raise ValueError(f"the kernel takes CUDA tensors, got {waveforms.device}")
        if waveforms.ndim != 2 or waveforms.dtype != torch.float32:
            raise ValueError(f"waveforms must be float32 [B, T], got {waveforms.dtype} "
                             f"{tuple(waveforms.shape)}")
        n_fft, hop = cfg.n_fft, cfg.hop_length
        if n_fft % hop or hop % KSTEP:
            raise ValueError(f"the kernel needs hop_length dividing n_fft and a multiple of "
                             f"{KSTEP}, got n_fft {n_fft} and hop_length {hop}")
        if cfg.win != n_fft or not cfg.center or cfg.pad_mode != "reflect":
            raise ValueError("the kernel takes win == n_fft, center and the reflect pad")
        if cfg.power != 2.0:
            raise ValueError("the kernel computes the power-2 spectrogram")
        x = waveforms.contiguous()
        B, T = x.shape
        nb, n_frames = cuda_melspec.geometry(T, cfg)
        n_mels = cfg.n_mels
        if T <= n_fft // 2 or n_mels * n_frames > 32_768:
            raise ValueError(f"the kernel takes windows of more than n_fft/2 samples and at most "
                             f"32,768 cells a plane, got T={T} ({n_mels}×{n_frames})")
        c = self.constants(cfg, sample_rate, x.device)
        strips = torch.empty((n_fft // hop, B * nb, hop), dtype=torch.bfloat16, device=x.device)
        mel = torch.empty((B, n_mels, n_frames), dtype=torch.float32, device=x.device)
        out = torch.empty_like(mel)
        lib = self.load()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ptrs = [x, c["hann"], c["cs"], c["f0"], c["weights"], c["ends"], c["quads"], strips,
                mel, out]
        rc = lib.sad_melspec_strip(
            *(ctypes.c_void_p(t.data_ptr()) for t in ptrs),
            B, T, n_fft, hop, nb, n_frames, c["f0"].numel(), c["cs"].shape[0], n_mels,
            BAND_BINS, TILE_ROWS, tiles(B, nb, n_frames),
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
