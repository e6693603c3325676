"""The factored-DFT log-mel kernel (csrc/melspec_factored.cu) and its wrapper.

Counterpart of the reference package's ``ops/pallas_melspec.py``
(``fused_log_mel_factored`` / ``serving_log_mel``, kernel
``_factored_kernel``). [B, T] waveforms → [B, n_mels, n_frames] standardized
log-mel, or the clamped dB with ``standardize=False``; float32, or with
``lowp_tail`` a bf16 mel product (float32 accumulation) and bf16 out.

For a tensor on the CPU the wrapper runs the plain version,
``ops.melspec.log_mel_factored`` at bf16 DFT precision. For a CUDA tensor it
launches the kernel or raises; it never falls back. The kernel starts at the
float32 or int16 waveforms: the reflect pad, the int16 dequantisation and
the rounding to bf16 are its first launch.

The kernel's host tables are plain functions here, so the CPU tests can hold
its decomposition against the plain version: ``dft_rows`` (the interleaved
cos|sin with the mirror and guard bins), ``band_plan`` (which bins and mels
each block's band takes), ``band_tables`` (each band's mel product as two
running sums) and ``row_tiles`` (the tiles of hop blocks); ``work`` counts
the operations of a call. The tile and band sizes are the kernel's
compile-time constants: the wrapper passes its own to the kernel, which
refuses a call planned for other sizes.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from synthetic_audio_detection_tpu_torch.utils.config import SpectrogramConfig
from synthetic_audio_detection_tpu_torch.ops import build, melspec

SOURCE = "synthetic_audio_detection_tpu_torch/csrc/melspec_factored.cu"
REPLACES = "synthetic_audio_detection_tpu/ops/pallas_melspec.py:169"

# csrc/melspec_factored.cu: a tile is 128 hop blocks, and yields the 125
# frames that start in it (a frame reads 4 blocks); a band is 128 bins, f0 − 1
# … f0 + 126, and has power for the 126 inner ones
TILE_ROWS = 128
TILE_FRAMES = TILE_ROWS - 3
BAND_BINS = 128
BAND_OUT_BINS = BAND_BINS - 2
KSTEP = 64  # hop must be a multiple of the kernel's K-step

# Two lowp_tail results from the same bf16 DFT operands (kernel and plain
# version, or the port and the reference) round the same float32 powers to
# bf16, except where the two powers, summed in different orders, straddle a
# bf16 rounding boundary: there one term moves by one bf16 ulp, at most 2^-7
# of itself. A mel value is a sum of non-negative terms, so it moves by at
# most 2^-7 of itself, and its dB by at most 10·log10(1 + 2^-7).
LOWP_STRADDLE_DB = 10.0 * math.log10(1.0 + 2.0 ** -7)


def lowp_tail_tolerance(plain: torch.Tensor, db_std: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Element-wise bound on |a − b| for two lowp_tail results of the same
    windows, ``plain`` being one of them: one bf16 ulp of the output
    (2^-7·|plain| + 2^-9) plus the straddle, LOWP_STRADDLE_DB on the dB
    plane or LOWP_STRADDLE_DB / σ on z-scores, σ ([B]) each window's dB
    standard deviation (the shift of the window's mean and σ is an average
    over all its cells, and negligible)."""
    straddle = LOWP_STRADDLE_DB if db_std is None else LOWP_STRADDLE_DB / db_std[:, None, None]
    return 2.0 ** -7 * plain.float().abs() + 2.0 ** -9 + straddle


def dequantize(waveforms: torch.Tensor) -> torch.Tensor:
    """int16 PCM transport → float32 in [-1, 1); float32 passes through."""
    if waveforms.dtype == torch.int16:
        return waveforms.float() / 32768.0
    if waveforms.dtype != torch.float32:
        raise TypeError(f"waveforms must be float32 or int16, got {waveforms.dtype}")
    return waveforms


def geometry(T: int, cfg: SpectrogramConfig) -> Tuple[int, int]:
    """(hop blocks nb, frames) of a window of T samples, as
    ``melspec.factored_blocks`` cuts it: T + n_fft samples after the centre
    pad, zero-padded to a hop multiple."""
    hop = cfg.hop_length
    return -(-(T + cfg.n_fft) // hop), 1 + T // hop


def dft_rows(n_fft: int, hop: int, n_sig: int) -> np.ndarray:
    """The kernel's B operand, [2·(n_sig + 2), hop] float32: row 2·(f + 1)
    the cos of bin f over a hop block's samples, row 2·(f + 1) + 1 its sin,
    for bins f = −1 … n_sig. Bin −1 is conj(bin 1), so the Hann tap
    X[−1] = conj(X[1]) is an ordinary column; bin n_sig is the guard bin
    of the last bin's X[f + 1] tap."""
    cos_m, sin_m = melspec._dft_matrices(n_fft, n_sig + 1)
    rows = np.empty((2 * (n_sig + 2), hop), np.float32)
    rows[0], rows[1] = cos_m[:hop, 1], -sin_m[:hop, 1]
    rows[2::2] = cos_m[:hop].T
    rows[3::2] = sin_m[:hop].T
    return rows


def band_plan(lo: np.ndarray, off: np.ndarray, width: int = BAND_OUT_BINS, align: int = 4
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Bands of ``width`` bins such that each mel's whole span (``lo``,
    ``off`` of ``melspec.sparse_columns``) lies in the band that owns it:
    → (f0 [bands], the first bin of each band; edges [bands + 1], band k
    owning mels edges[k] … edges[k + 1] − 1), int32. Greedy in mel order: a
    band starts at its first mel's first bin, moved down to f0 ≡ 1 (mod
    ``align``) (this kernel's 4, so that bin f0 − 1 + j has the phases of j
    mod 4; 1 leaves it where it is), and takes the following mels while
    they fit. A mel without weights, or wider than a band, raises."""
    spans = np.diff(off)
    if not spans.all():
        raise ValueError(f"mel {int(np.argmin(spans))} has no filterbank weight")
    f0s, edges = [], [0]
    m, n = 0, len(lo)
    while m < n:
        start = int(lo[m]) - (int(lo[m]) - 1) % align
        k = m
        while k < n and start <= lo[k] and lo[k] + spans[k] <= start + width:
            k += 1
        if k == m:
            raise ValueError(f"mel {m} spans {spans[m]} bins, more than a band's {width}")
        f0s.append(start)
        edges.append(k)
        m = k
    return np.asarray(f0s, np.int32), np.asarray(edges, np.int32)


def band_tables(lo: np.ndarray, off: np.ndarray, w: np.ndarray, f0: np.ndarray,
                edges: np.ndarray, bins: Optional[int] = None, first: int = -1
                ) -> Dict[str, np.ndarray]:
    """The mel product of each band as two running sums over its bins, one
    for its even and one for its odd mels (a triangle's support ends where
    the next but one begins, so the mels of one parity never share a bin):
    ``weights`` [bands, 2, bins] float32, the weight of local bin j (bin
    f0 + first + j: this kernel's bands start one halo bin below f0) in the
    parity's mel there, or 0; ``ends`` [bands, 2, bins] int32, the mel whose
    last bin j is, or −1; ``quads`` [bands, 2, 2] int32, the parity's first
    and past-last group of 4 local bins. ``bins`` defaults to BAND_BINS.
    Mels of one parity that share a bin raise."""
    n_bands = len(f0)
    bins = BAND_BINS if bins is None else bins
    weights = np.zeros((n_bands, 2, bins), np.float32)
    ends = np.full((n_bands, 2, bins), -1, np.int32)
    quads = np.zeros((n_bands, 2, 2), np.int32)
    for k in range(n_bands):
        for m in range(edges[k], edges[k + 1]):
            j = np.arange(lo[m], lo[m] + off[m + 1] - off[m]) - f0[k] - first
            if np.any(weights[k, m % 2, j]):
                raise ValueError(f"mel {m} shares a bin with another mel of its parity")
            weights[k, m % 2, j] = w[off[m]:off[m + 1]]  # nonzero over the whole span
            ends[k, m % 2, j[-1]] = m
        for par in range(2):
            used = np.nonzero(weights[k, par])[0]
            if used.size:
                quads[k, par] = (used[0] // 4, used[-1] // 4 + 1)
    return {"weights": weights, "ends": ends, "quads": quads}


def row_tiles(n_windows: int, nb: int, n_frames: int, tile_frames: int = TILE_FRAMES) -> int:
    """Tiles of TILE_ROWS hop blocks, ``tile_frames`` apart over all
    windows' blocks back to back, that hold the first block of every
    frame."""
    return -(-((n_windows - 1) * nb + n_frames) // tile_frames)


def work(c: Dict[str, torch.Tensor], cfg: SpectrogramConfig, n_windows: int, T: int
         ) -> Dict[str, float]:
    """Operations (two a multiply-add) of one call at [n_windows, T], for
    the constants ``c`` of ``FactoredMelKernel.constants``: ``dft_min`` and
    ``mel_min``, what the function needs (each hop block against bins 0 …
    n_sig, the last the guard bin; one multiply-add a frame per filterbank
    nonzero), and ``dft`` and ``mel``, what this tiling does (every tile
    against every band, the tiles' 3-block and the bands' 2-bin halos
    included; each parity's running sum over whole groups of 4 bins)."""
    hop = cfg.hop_length
    nb, n_frames = geometry(T, cfg)
    n_bins = c["cs"].shape[0] // 2 - 1  # the table's bins but the mirror bin −1
    steps = 4 * int((c["quads"][..., 1] - c["quads"][..., 0]).sum())
    return {
        "dft_min": 2.0 * n_windows * nb * hop * 2 * n_bins,
        "mel_min": 2.0 * n_windows * n_frames * int(torch.count_nonzero(c["weights"])),
        "dft": 2.0 * row_tiles(n_windows, nb, n_frames) * TILE_ROWS * c["f0"].numel()
               * 2 * BAND_BINS * hop,
        "mel": 2.0 * n_windows * n_frames * steps,
    }


class FactoredMelKernel:
    """Launches the kernel and counts its launches (``launches``, one per
    call that runs the kernel; the plain version on the CPU does not
    count)."""

    name = "melspec_factored"

    def __init__(self) -> None:
        self.launches = 0
        self._lib = None
        self._consts: Dict[Tuple, Dict[str, torch.Tensor]] = {}

    def load(self) -> ctypes.CDLL:
        """Build (at first use) and bind the library."""
        if self._lib is None:
            lib = build.load(self.name)
            lib.sad_melspec_factored.argtypes = (
                [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
                + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
            lib.sad_melspec_factored.restype = ctypes.c_int
            lib.sad_cuda_error_string.argtypes = [ctypes.c_int]
            lib.sad_cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def constants(self, cfg: SpectrogramConfig, sample_rate: int,
                  device: torch.device) -> Dict[str, torch.Tensor]:
        """On ``device``, built once per configuration: ``cs`` (``dft_rows``,
        bf16), the bands' ``f0`` (``band_plan``) and their mel tables
        (``band_tables``: ``weights``, the same rounded to bf16 as
        ``weights_lowp``, ``ends``, ``quads``), over the filterbank's
        significant bins. Keyed on the fields they depend on, so any object
        with a SpectrogramConfig's attributes shares one entry with an equal
        config."""
        key = (cfg.n_fft, cfg.hop_length, cfg.n_mels, cfg.f_min, cfg.f_max, cfg.mel_norm,
               cfg.mel_scale, sample_rate, str(device))
        if key not in self._consts:
            fb = melspec.config_filterbank(cfg, sample_rate)
            n_sig = melspec.significant_bins(fb)
            lo, off, w = melspec.sparse_columns(fb[:n_sig])
            f0, edges = band_plan(lo, off)
            tables = band_tables(lo, off, w, f0, edges)
            c = {k: torch.as_tensor(v).to(device) for k, v in tables.items()}
            c["weights_lowp"] = c["weights"].to(torch.bfloat16).float()
            c["f0"] = torch.as_tensor(f0).to(device)
            c["cs"] = torch.as_tensor(dft_rows(cfg.n_fft, cfg.hop_length, n_sig)).to(
                device=device, dtype=torch.bfloat16).contiguous()
            self._consts[key] = c
        return self._consts[key]

    def __call__(self, waveforms: torch.Tensor, cfg: SpectrogramConfig,
                 sample_rate: int = 32_000, standardize: bool = True,
                 lowp_tail: bool = False) -> torch.Tensor:
        if waveforms.device.type != "cuda":
            raise ValueError(f"the kernel takes CUDA tensors, got {waveforms.device}")
        if waveforms.ndim != 2:
            raise ValueError(f"waveforms must be [B, T], got {tuple(waveforms.shape)}")
        if waveforms.dtype not in (torch.float32, torch.int16):
            raise TypeError(f"waveforms must be float32 or int16, got {waveforms.dtype}")
        hop = cfg.hop_length
        if cfg.n_fft != 4 * hop or hop % KSTEP:
            raise ValueError(f"the kernel needs n_fft == 4·hop_length and hop_length a multiple "
                             f"of {KSTEP}, got {cfg.n_fft} and {hop}")
        if cfg.win != cfg.n_fft or not cfg.center or cfg.pad_mode != "reflect":
            raise ValueError("the kernel takes win == n_fft, center and the reflect pad")
        if cfg.power != 2.0:
            raise ValueError("the kernel computes the power-2 spectrogram")
        x = waveforms.contiguous()
        B, T = x.shape
        nb, n_frames = geometry(T, cfg)
        n_mels = cfg.n_mels
        if T <= cfg.n_fft // 2 or n_mels * n_frames > 32_768:
            raise ValueError(f"the kernel takes windows of more than n_fft/2 samples and at most "
                             f"32,768 cells a plane, got T={T} ({n_mels}×{n_frames})")
        c = self.constants(cfg, sample_rate, x.device)
        blocks = torch.empty((B * nb, hop), dtype=torch.bfloat16, device=x.device)
        mel = torch.empty((B, n_mels, n_frames), dtype=torch.float32, device=x.device)
        out = torch.empty_like(mel, dtype=torch.bfloat16 if lowp_tail else torch.float32)
        lib = self.load()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ptrs = [c["cs"], c["f0"], c["weights_lowp" if lowp_tail else "weights"], c["ends"],
                c["quads"], blocks, mel, out]
        rc = lib.sad_melspec_factored(
            ctypes.c_void_p(x.data_ptr()), int(x.dtype == torch.int16),
            *(ctypes.c_void_p(t.data_ptr()) for t in ptrs),
            B, T, cfg.n_fft, hop, nb, n_frames, c["f0"].numel(), c["cs"].shape[0], n_mels,
            BAND_BINS, TILE_ROWS, float(cfg.top_db), float(cfg.eps), int(standardize), int(lowp_tail),
            ctypes.c_void_p(stream))
        if rc != 0:
            msg = lib.sad_cuda_error_string(rc).decode()
            raise RuntimeError(f"{self.name} launch failed: CUDA error {rc} ({msg})")
        self.launches += 1
        return out


KERNEL = FactoredMelKernel()


def fused_log_mel_factored(waveforms: torch.Tensor, cfg: SpectrogramConfig,
                           sample_rate: int = 32_000, standardize: bool = True,
                           lowp_tail: bool = False) -> torch.Tensor:
    """[B, T] float32 or int16 → [B, n_mels, n_frames], float32 or, with
    ``lowp_tail``, bf16 (for a bf16 consumer only: z-scores keep about 3
    decimal digits). CPU: the plain version; CUDA: the kernel; any other
    device raises."""
    if waveforms.device.type == "cpu":
        return melspec.log_mel_factored(dequantize(waveforms), cfg, sample_rate,
                                        standardize=standardize,
                                        dft_dtype=torch.bfloat16, lowp_tail=lowp_tail)
    if waveforms.device.type != "cuda":
        raise ValueError(f"no log-mel kernel for device {waveforms.device}")
    return KERNEL(waveforms, cfg, sample_rate, standardize, lowp_tail)


def serving_log_mel(waveforms: torch.Tensor, cfg: SpectrogramConfig,
                    sample_rate: int = 32_000, lowp_tail: bool = False) -> torch.Tensor:
    """The serving pipeline's mel front end (standardized)."""
    return fused_log_mel_factored(waveforms, cfg, sample_rate, lowp_tail=lowp_tail)
