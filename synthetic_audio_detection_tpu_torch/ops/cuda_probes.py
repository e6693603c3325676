"""The helper probes P1-P3 (csrc/helper_probes.cu) and their wrappers.

Counterparts of the three Pallas kernels in the reference repository's
``benchmarks/pallas_helper_bisect.py:main``, with their shapes as the
contract: x [2, 2048, 64] bf16, W [64, 64] bf16 (W9 [9, 64, 64] for P3), bf16
out, every product summed in float32 and rounded once.

- ``dyn_slice_dot`` (P1): ``x[:, 3:1795] @ W`` → [2, 1792, 64], the Pallas
  grid's (b, t) program reading rows 256·t + 3 on;
- ``lane_concat_dot`` (P2): ``[x[:, 0:256] | x[:, 1:257]] @ [W; W]`` →
  [2, 256, 64];
- ``nine_tap_dot`` (P3): ``Σ_i x[:, i:i+256] @ W9[i]`` → [2, 256, 64].

On Hopper the three are one kernel, a shifted-row multi-tap product
parameterised by the taps, the first input row and the stride between the
taps' weights, over 64-row output tiles (``tiles``: the plan the kernel
runs, which its entry checks). Every entry checks its inputs the same way on
every device; then a CPU tensor runs the plain version (``*_plain``, a
float32 product of the bf16 values rounded once) and a CUDA tensor launches
the kernel or raises. There is no fallback to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from synthetic_audio_detection_tpu_torch.ops import build
from synthetic_audio_detection_tpu_torch.ops.precision import exact_float32

LIBRARY = "helper_probes"
SOURCE = f"synthetic_audio_detection_tpu_torch/csrc/{LIBRARY}.cu"
REPLACES = {
    "P1": "benchmarks/pallas_helper_bisect.py:51",
    "P2": "benchmarks/pallas_helper_bisect.py:67",
    "P3": "benchmarks/pallas_helper_bisect.py:83",
}
X_SHAPE = (2, 2048, 64)
TILE = 256           # output rows per Pallas block
P1_ROW0, P1_TILES = 3, 7
TILE_ROWS = 64       # output rows per kernel block: one wgmma warpgroup's M


@functools.lru_cache(maxsize=None)
def tiles(rows_out: int, taps: int, row0: int, tile_rows: int = TILE_ROWS) -> np.ndarray:
    """The kernel's tile plan (read-only, cached: it is on every call's host
    path): [rows_out / tile_rows, taps], the first input row of tap i's A box
    (tile_rows rows) for the tile of output rows tile_rows·t … tile_rows·t +
    tile_rows − 1: row0 + tile_rows·t + i."""
    if rows_out <= 0 or rows_out % tile_rows:
        raise ValueError(f"rows_out must be a positive multiple of {tile_rows}, got {rows_out}")
    plan = row0 + tile_rows * np.arange(rows_out // tile_rows)[:, None] + np.arange(taps)
    plan.setflags(write=False)
    return plan


def _check(x: torch.Tensor, w: torch.Tensor, w_shape: tuple) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no probe kernel for device {x.device}: CPU runs the plain "
                         "version, CUDA the kernel")
    if w.device != x.device:
        raise ValueError(f"w on {w.device}, x on {x.device}")
    if tuple(x.shape) != X_SHAPE or tuple(w.shape) != w_shape:
        raise ValueError(f"x must be {list(X_SHAPE)} and w {list(w_shape)}, got "
                         f"{list(x.shape)} and {list(w.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"x and w must be bfloat16, got {x.dtype} and {w.dtype}")
    if not x.is_contiguous() or not w.is_contiguous():
        raise ValueError("x and w must be contiguous")


class HelperProbesKernel:
    """Launches the kernel and counts its launches (``launches``, one per
    call that runs the kernel; the plain versions on the CPU do not
    count)."""

    name = LIBRARY

    def __init__(self) -> None:
        self.launches = 0
        self._lib = None

    def load(self) -> ctypes.CDLL:
        """Build (at first use) and bind the library."""
        if self._lib is None:
            lib = build.load(LIBRARY)
            lib.sad_shifted_taps.argtypes = (
                [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
            lib.sad_shifted_taps.restype = ctypes.c_int
            lib.sad_probes_error_string.argtypes = [ctypes.c_int]
            lib.sad_probes_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def __call__(self, x: torch.Tensor, w: torch.Tensor, taps: int, row0: int, rows_out: int,
                 w_tap_stride: int) -> torch.Tensor:
        """out[b, r] = Σ_{i < taps} x[b, row0 + r + i] @ W_i for r < rows_out,
        W_i the [64, 64] block at w's element i·w_tap_stride, on the tiles
        of ``tiles(rows_out, taps, row0)``; x and w checked by the entries."""
        if x.device.type != "cuda":
            raise ValueError(f"the kernel takes CUDA tensors, got {x.device}")
        if x.data_ptr() % 16 or w.data_ptr() % 16:
            raise ValueError("x and w must start on a 16-byte boundary")
        B, rows, C = x.shape
        cols = w.shape[-1]
        n_tiles = len(tiles(rows_out, taps, row0, TILE_ROWS))
        out = torch.empty((B, rows_out, cols), dtype=torch.bfloat16, device=x.device)
        lib = self.load()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.sad_shifted_taps(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), B, rows, C, cols, TILE_ROWS, n_tiles, taps, row0,
            w_tap_stride, ctypes.c_void_p(stream))
        if rc != 0:
            msg = lib.sad_probes_error_string(rc).decode()
            raise RuntimeError(f"{LIBRARY} launch failed: CUDA error {rc} ({msg})")
        self.launches += 1
        return out


KERNEL = HelperProbesKernel()


def dyn_slice_dot_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    rows = P1_ROW0 + TILE * P1_TILES
    with exact_float32():
        return (x[:, P1_ROW0:rows].float() @ w.float()).to(torch.bfloat16)


def lane_concat_dot_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    with exact_float32():
        wf = w.float()
        y = x[:, 0:TILE].float() @ wf + x[:, 1:TILE + 1].float() @ wf
    return y.to(torch.bfloat16)


def nine_tap_dot_plain(x: torch.Tensor, w9: torch.Tensor) -> torch.Tensor:
    with exact_float32():
        y = x[:, 0:TILE].float() @ w9[0].float()
        for i in range(1, w9.shape[0]):
            y = y + x[:, i:i + TILE].float() @ w9[i].float()
    return y.to(torch.bfloat16)


def dyn_slice_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """P1: [2, 2048, 64] × [64, 64] → [2, 1792, 64], rows 3 to 1794."""
    _check(x, w, (64, 64))
    if x.device.type == "cpu":
        return dyn_slice_dot_plain(x, w)
    return KERNEL(x, w, taps=1, row0=P1_ROW0, rows_out=TILE * P1_TILES, w_tap_stride=0)


def lane_concat_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """P2: rows 0-255 and 1-256 of each image, each times W, summed →
    [2, 256, 64]."""
    _check(x, w, (64, 64))
    if x.device.type == "cpu":
        return lane_concat_dot_plain(x, w)
    return KERNEL(x, w, taps=2, row0=0, rows_out=TILE, w_tap_stride=0)


def nine_tap_dot(x: torch.Tensor, w9: torch.Tensor) -> torch.Tensor:
    """P3: Σ_i rows i to i + 255 of each image times W9[i] → [2, 256, 64]."""
    _check(x, w9, (9, 64, 64))
    if x.device.type == "cpu":
        return nine_tap_dot_plain(x, w9)
    return KERNEL(x, w9, taps=9, row0=0, rows_out=TILE, w_tap_stride=64 * 64)
