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
parameterised by the taps, the per-tile row offset and the stride between
the taps' weights. Every entry checks its inputs the same way on every
device; then a CPU tensor runs the plain version (``*_plain``, a float32
product of the bf16 values rounded once) and a CUDA tensor launches the
kernel or raises. There is no fallback to the plain version.
"""

from __future__ import annotations

import ctypes

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
TILE = 256           # output rows per Pallas block and per kernel block
P1_ROW0, P1_TILES = 3, 7


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
                [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
            lib.sad_shifted_taps.restype = ctypes.c_int
            lib.sad_probes_error_string.argtypes = [ctypes.c_int]
            lib.sad_probes_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def __call__(self, x: torch.Tensor, w: torch.Tensor, taps: int, row0: int, tiles: int,
                 w_tap_stride: int) -> torch.Tensor:
        """out[b, 256·t + r] = Σ_{i < taps} x[b, row0 + 256·t + i + r] @ W_i,
        W_i the [64, 64] block at w's element i·w_tap_stride; x and w
        checked by the entries."""
        if x.device.type != "cuda":
            raise ValueError(f"the kernel takes CUDA tensors, got {x.device}")
        if x.data_ptr() % 16:
            raise ValueError("x must start on a 16-byte boundary")
        B, rows, C = x.shape
        cols = w.shape[-1]
        out = torch.empty((B, TILE * tiles, cols), dtype=torch.bfloat16, device=x.device)
        lib = self.load()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.sad_shifted_taps(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), B, rows, C, cols, tiles, taps, row0,
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
    return KERNEL(x, w, taps=1, row0=P1_ROW0, tiles=P1_TILES, w_tap_stride=0)


def lane_concat_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """P2: rows 0-255 and 1-256 of each image, each times W, summed →
    [2, 256, 64]."""
    _check(x, w, (64, 64))
    if x.device.type == "cpu":
        return lane_concat_dot_plain(x, w)
    return KERNEL(x, w, taps=2, row0=0, tiles=1, w_tap_stride=0)


def nine_tap_dot(x: torch.Tensor, w9: torch.Tensor) -> torch.Tensor:
    """P3: Σ_i rows i to i + 255 of each image times W9[i] → [2, 256, 64]."""
    _check(x, w9, (9, 64, 64))
    if x.device.type == "cpu":
        return nine_tap_dot_plain(x, w9)
    return KERNEL(x, w9, taps=9, row0=0, tiles=1, w_tap_stride=64 * 64)
