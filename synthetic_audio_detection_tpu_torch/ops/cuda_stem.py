"""The ResNet stem with its max-pool and ReLU in one kernel
(csrc/stem_wgmma.cu), and its wrappers.

The fast backbone's stem is the reference package's ``_conv_bn`` on the 7x7
stride-2 conv (``models/fast_resnet.py:151``) followed by its 3x3 stride-2
``reduce_window`` max (``:153``): operands rounded to bf16, every product
exact in float32, the sum in float32, ``y·scale + bias`` as a float32
multiply and a float32 add, the ReLU, one rounding to bf16, the max-pool.
The ReLU runs after the pool here: both are monotone, so the two orders give
the same values. It replaces no TPU kernel (the reference computes the stem
with ``lax.conv``); the kernel takes the stem's five device passes into one
(PERF.md §6, PR 24).

x [B, C, H, W] bf16 (C 1 or 3) whose [H, W] planes are contiguous, at any
batch and channel strides; a channel stride of 0 is one plane repeated on the
channels (``melspec.replicate_channels``), which the kernel reads once and
convolves with each channel's weight. w [64, C, 7, 7], scale and bias [64]
→ NHWC bf16 [B, Hp, Wp, 64] with Ho = ceil(H / 2), Hp = ceil(Ho / 2) (the
same for W). The entry checks its inputs the same way on every device; then
a CPU tensor runs the plain version (``stem_pool_plain``) and a CUDA tensor
launches the kernel or raises. There is no fallback to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from synthetic_audio_detection_tpu_torch.ops import build, cuda_conv

LIBRARY = "stem_wgmma"
SOURCE = f"synthetic_audio_detection_tpu_torch/csrc/{LIBRARY}.cu"
FILTERS = 64
KSIZE = 7
TILE = (8, 16)  # pooled rows and columns a kernel block computes
CHANNELS = (1, 3)


def out_sizes(H: int, W: int) -> Tuple[int, int, int, int]:
    """(Ho, Wo, Hp, Wp): the conv's output (7x7, stride 2, pad 3) and the
    pool's (3x3, stride 2, pad 1)."""
    Ho, Wo = (H + 1) // 2, (W + 1) // 2
    return Ho, Wo, (Ho + 1) // 2, (Wo + 1) // 2


def tile_plan(H: int, W: int) -> Tuple[int, int, int, int]:
    """The kernel's tiles for an H × W input → (th, tw, tiles_h, tiles_w):
    blocks of th × tw pooled outputs of one image, tiles_h × tiles_w of them
    an image, the last row and column of tiles masked where th or tw does
    not divide Hp or Wp. A block computes the (2·th + 1) × (2·tw + 1) conv
    pixels its outputs read, from the input rows 4·p0 − 5 … 4·p0 + 4·th + 1
    and columns 4·q0 − 5 … 4·q0 + 4·tw + 2 of its first pooled output (p0,
    q0)."""
    _, _, Hp, Wp = out_sizes(H, W)
    th, tw = TILE
    return th, tw, -(-Hp // th), -(-Wp // tw)


def packed_k(C: int) -> int:
    """The kernel's K for C channels: 8 taps a (channel, row) of 7,
    padded to a multiple of 16 (one wgmma k-step)."""
    return 16 * -(-(KSIZE * C) // 2)


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """[64, C, 7, 7] → the kernel's B [64, packed_k(C)] bf16, k = c·56 +
    dy·8 + dx: each (channel, row) of taps padded to 8 with a zero, the
    tail zero."""
    Fo, C = w.shape[:2]
    packed = F.pad(w.to(torch.bfloat16), (0, 1)).reshape(Fo, C * KSIZE * 8)
    return F.pad(packed, (0, packed_k(C) - packed.shape[1])).contiguous()


def work(B: int, C: int, H: int, W: int, planes: Optional[int] = None) -> Tuple[float, float]:
    """(operations, bytes) of one call: the C channels' products (2 per
    multiply-add) and the bytes it must move, ``planes`` bf16 input planes
    read once (1 for a repeated plane; default C), the weights and the
    affine, the bf16 output written once."""
    Ho, Wo, Hp, Wp = out_sizes(H, W)
    ops = 2.0 * B * Ho * Wo * FILTERS * C * KSIZE * KSIZE
    nbytes = (2.0 * B * (C if planes is None else planes) * H * W
              + 2.0 * FILTERS * C * KSIZE * KSIZE + 8.0 * FILTERS + 2.0 * B * Hp * Wp * FILTERS)
    return ops, nbytes


def contiguous_planes(x: torch.Tensor) -> torch.Tensor:
    """x with contiguous [H, W] planes; a stride-0 channel axis stays one."""
    if x.stride(-1) == 1 and x.stride(-2) == x.shape[-1]:
        return x
    if x.shape[1] > 1 and x.stride(1) == 0:
        return x[:, :1].contiguous().expand(x.shape)
    return x.contiguous()


def check_inputs(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor) -> Tuple[int, int, int, int]:
    """Validate the entry's contract → (B, C, H, W)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no stem kernel for device {x.device}: CPU runs the plain version, "
                         "CUDA the kernel")
    if any(t.device != x.device for t in (w, scale, bias)):
        raise ValueError("w, scale and bias must lie on x's device")
    if x.ndim != 4:
        raise ValueError(f"x must be [B, C, H, W], got {tuple(x.shape)}")
    B, C, H, W = x.shape
    if C not in CHANNELS:
        raise ValueError(f"the stem kernel takes 1 or 3 input channels, got {C}")
    if tuple(w.shape) != (FILTERS, C, KSIZE, KSIZE):
        raise ValueError(f"w must be [{FILTERS}, {C}, {KSIZE}, {KSIZE}], got {tuple(w.shape)}")
    if any(tuple(t.shape) != (FILTERS,) for t in (scale, bias)):
        raise ValueError(f"scale and bias must be [{FILTERS}]")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"x must be bfloat16, got {x.dtype}")
    if B == 0 or H == 0 or W == 0:
        raise ValueError(f"x must not be empty, got {tuple(x.shape)}")
    if x.stride(3) != 1 or x.stride(2) != W:
        raise ValueError("x's [H, W] planes must be contiguous (contiguous_planes makes them so)")
    return B, C, H, W


def stem_pool_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the float32 conv of the bf16
    values of every channel (TF32 off), the float32 affine, one rounding to
    bf16 (``cuda_conv.conv_f32_bn_relu``), the max-pool, the ReLU. Only the
    float32 summation order differs from the kernel. Returns contiguous
    NHWC."""
    y = cuda_conv.conv_f32_bn_relu(x.to(torch.bfloat16).float(), w.to(torch.bfloat16).float(),
                                   scale, bias, 2, KSIZE // 2, False, torch.bfloat16)
    y = torch.relu_(F.max_pool2d(y, 3, 2, 1))
    return y.permute(0, 2, 3, 1).contiguous()


class StemKernel:
    """Launches the kernel and counts its launches (``launches``, one per
    call that runs the kernel; the plain version on the CPU does not
    count)."""

    name = "stem_pool"

    def __init__(self) -> None:
        self.launches = 0
        self._lib = None

    def load(self) -> ctypes.CDLL:
        """Build (at first use) and bind the library."""
        if self._lib is None:
            lib = build.load(LIBRARY)
            lib.sad_stem_wgmma.argtypes = (
                [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] + [ctypes.c_void_p] * 4
                + [ctypes.c_int] * 6 + [ctypes.c_void_p])
            lib.sad_stem_wgmma.restype = ctypes.c_int
            lib.sad_stem_error_string.argtypes = [ctypes.c_int]
            lib.sad_stem_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def __call__(self, x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
        """x checked by the entry, on CUDA; w_packed from ``pack_weight``;
        scale and bias contiguous float32 [64]."""
        if x.device.type != "cuda":
            raise ValueError(f"the kernel takes CUDA tensors, got {x.device}")
        B, C, H, W = x.shape
        k = packed_k(C)
        if (w_packed.dtype != torch.bfloat16 or tuple(w_packed.shape) != (FILTERS, k)
                or not w_packed.is_contiguous() or w_packed.data_ptr() % 16):
            raise ValueError(f"w_packed must be contiguous 16-byte aligned bf16 [{FILTERS}, {k}]")
        for t in (scale, bias):
            if t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError("scale and bias must be contiguous float32")
        _, _, Hp, Wp = out_sizes(H, W)
        th, tw, _, _ = tile_plan(H, W)
        out = torch.empty((B, Hp, Wp, FILTERS), dtype=torch.bfloat16, device=x.device)
        lib = self.load()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.sad_stem_wgmma(
            ctypes.c_void_p(x.data_ptr()), x.stride(0), x.stride(1) if C > 1 else 0,
            *(ctypes.c_void_p(t.data_ptr()) for t in (w_packed, scale, bias, out)),
            B, C, H, W, th, tw, ctypes.c_void_p(stream))
        if rc != 0:
            msg = lib.sad_stem_error_string(rc).decode()
            raise RuntimeError(f"{LIBRARY} launch failed: CUDA error {rc} ({msg})")
        self.launches += 1
        return out


KERNEL = StemKernel()


def stem_pool(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              w_packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, C, H, W] bf16 → NHWC bf16 [B, Hp, Wp, 64]: the stem conv, its
    eval-BN affine, the max-pool and the ReLU. ``w_packed`` is
    ``pack_weight(w)``, packed here when None."""
    check_inputs(x, w, scale, bias)
    scale = scale.to(torch.float32).contiguous()
    bias = bias.to(torch.float32).contiguous()
    if x.device.type == "cpu":
        return stem_pool_plain(x, w, scale, bias)
    return KERNEL(x, pack_weight(w) if w_packed is None else w_packed, scale, bias)
