"""The 3x3 conv + per-channel affine + ReLU kernel (csrc/conv3x3_bn_relu.cu)
and its wrappers.

Counterpart of the reference package's ``ops/pallas_conv.py``:
``conv3x3_bn_relu`` (kernel ``_kernel``) and ``conv3x3_bn_relu_tiled``
(``_tiled_kernel``); ``ops/cuda_conv_flat.py`` holds the counterparts of
``ops/pallas_conv_flat.py``. The four TPU kernels are four layouts of one
function, and on Hopper they are one kernel: an implicit GEMM (M = output
pixels, N = output channels, K = 9·C) on ``mma.sync`` with bf16 operands
and float32 accumulation, whose epilogue applies ``acc·scale + bias`` in
float32, then the optional ReLU, and rounds once to the output dtype.

[B, H, W, C] NHWC bf16 × [3, 3, C, F] HWIO → [B, H/s, W/s, F], SAME
padding (one zero row and column on each side), stride 1 or 2. The kernel
zero-fills taps outside the image as it loads them, so no padded copy of the
input is written. Knobs of the TPU entries:

- ``tile_h`` (``conv3x3_bn_relu_tiled``) is the kernel's output-row tile:
  each block computes 128 output pixels inside one tile of ``tile_h`` rows
  of one image. The other entries use one tile per image.
- ``k_pack`` is accepted and has no effect: it pairs taps to fill the TPU
  matrix unit's 128-deep contraction, and ``mma.sync``'s depth of 16 has no
  such need.
- The TPU entries' ``interpret`` flag has no counterpart: a CPU tensor runs
  the plain version.

Every entry checks its inputs the same way on every device: x is bf16 and
contiguous NHWC with C % 8 == 0 (16-byte loads) and F % 8 == 0, w is
[3, 3, C, F], H and W divide by the stride. Then a CPU tensor runs the plain
version (``conv3x3_bn_relu_plain``) and a CUDA tensor launches the kernel or
raises; any other device raises. There is no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from synthetic_audio_detection_tpu_torch.ops import build

SOURCE = "synthetic_audio_detection_tpu_torch/csrc/conv3x3_bn_relu.cu"
REPLACES = {
    "K3": "synthetic_audio_detection_tpu/ops/pallas_conv.py:33",
    "K4": "synthetic_audio_detection_tpu/ops/pallas_conv.py:74",
    "K5": "synthetic_audio_detection_tpu/ops/pallas_conv_flat.py:35",
    "K6": "synthetic_audio_detection_tpu/ops/pallas_conv_flat.py:75",
}
OUT_DTYPES = (torch.bfloat16, torch.float32)


def check_inputs(x: torch.Tensor, w: torch.Tensor, stride: int = 1
                 ) -> Tuple[int, int, int, int, int]:
    """Validate the shared contract of the four entries → (B, H, W, C, F)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no 3x3 conv for device {x.device}: CPU runs the plain "
                         "version, CUDA the kernel")
    if w.device != x.device:
        raise ValueError(f"w on {w.device}, x on {x.device}")
    if x.ndim != 4:
        raise ValueError(f"x must be [B, H, W, C], got {tuple(x.shape)}")
    B, H, W, C = x.shape
    if w.ndim != 4 or tuple(w.shape[:3]) != (3, 3, C):
        raise ValueError(f"w must be [3, 3, {C}, F], got {tuple(w.shape)}")
    Fo = w.shape[3]
    if x.dtype != torch.bfloat16:
        raise ValueError(f"x must be bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC (a channels_last [B, C, H, W] "
                         "tensor's permute(0, 2, 3, 1) is)")
    if C % 8 or Fo % 8:
        raise ValueError(f"C and F must be multiples of 8 (16-byte loads), got C={C}, F={Fo}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if H % stride or W % stride:
        raise ValueError(f"H and W must divide by the stride, got {H}x{W} at stride {stride}")
    return B, H, W, C, Fo


def _affine(v: Optional[torch.Tensor], fill: float, n: int, device) -> torch.Tensor:
    if v is None:
        return torch.full((n,), fill, dtype=torch.float32, device=device)
    if tuple(v.shape) != (n,):
        raise ValueError(f"scale and bias must be [{n}], got {tuple(v.shape)}")
    return v.to(device=device, dtype=torch.float32).contiguous()


def conv3x3_bn_relu_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, stride: int = 1, relu: bool = True,
                          out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The kernel's function in plain PyTorch: x and w rounded to bf16, the
    conv in float32 (TF32 off, so every bf16 product is exact and only the
    summation order differs from the kernel), the float32 affine, the ReLU,
    one rounding to ``out_dtype``. Returns contiguous NHWC."""
    xf = x.to(torch.bfloat16).float().permute(0, 3, 1, 2)
    wf = w.to(torch.bfloat16).float().permute(3, 2, 0, 1)  # HWIO → OIHW
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv2d(xf, wf, stride=stride, padding=1)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    y = y * scale.float()[None, :, None, None] + bias.float()[None, :, None, None]
    if relu:
        y = torch.relu(y)
    return y.to(out_dtype).permute(0, 2, 3, 1).contiguous()


class Conv3x3Kernel:
    """Launches the kernel and counts its launches (``launches``, one per
    call that runs the kernel; the plain version on the CPU does not
    count)."""

    name = "conv3x3_bn_relu"

    def __init__(self) -> None:
        self.launches = 0
        self._lib = None

    def load(self) -> ctypes.CDLL:
        """Build (at first use) and bind the library."""
        if self._lib is None:
            lib = build.load(self.name)
            lib.sad_conv3x3_bn_relu.argtypes = (
                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
            lib.sad_conv3x3_bn_relu.restype = ctypes.c_int
            lib.sad_cuda_error_string.argtypes = [ctypes.c_int]
            lib.sad_cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def __call__(self, x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, stride: int, relu: bool, out_dtype: torch.dtype,
                 tile_h: int) -> torch.Tensor:
        """x [B, H, W, C] bf16 NHWC, w_packed [F, 3, 3, C] bf16, scale and
        bias [F] float32, all contiguous on one CUDA device (the entries
        check the rest)."""
        if x.device.type != "cuda":
            raise ValueError(f"the kernel takes CUDA tensors, got {x.device}")
        B, H, W, C = x.shape
        Fo = w_packed.shape[0]
        if (w_packed.dtype != torch.bfloat16 or tuple(w_packed.shape) != (Fo, 3, 3, C)
                or not w_packed.is_contiguous()):
            raise ValueError("w_packed must be contiguous bf16 [F, 3, 3, C]")
        for t in (scale, bias):
            if t.dtype != torch.float32 or tuple(t.shape) != (Fo,) or not t.is_contiguous():
                raise ValueError("scale and bias must be contiguous float32 [F]")
        if any(t.device != x.device for t in (w_packed, scale, bias)):
            raise ValueError("all operands must lie on x's device")
        if x.data_ptr() % 16 or w_packed.data_ptr() % 16:
            raise ValueError("x and w must start on a 16-byte boundary")
        if out_dtype not in OUT_DTYPES:
            raise ValueError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")
        Ho, Wo = H // stride, W // stride
        if tile_h <= 0 or Ho % tile_h:
            raise ValueError(f"tile_h {tile_h} must divide the {Ho} output rows")
        out = torch.empty((B, Ho, Wo, Fo), dtype=out_dtype, device=x.device)
        lib = self.load()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.sad_conv3x3_bn_relu(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w_packed.data_ptr()),
            ctypes.c_void_p(scale.data_ptr()), ctypes.c_void_p(bias.data_ptr()),
            ctypes.c_void_p(out.data_ptr()),
            B, H, W, C, Fo, stride, tile_h, int(relu), int(out_dtype == torch.float32),
            ctypes.c_void_p(stream))
        if rc != 0:
            msg = lib.sad_cuda_error_string(rc).decode()
            raise RuntimeError(f"{self.name} launch failed: CUDA error {rc} ({msg})")
        self.launches += 1
        return out


KERNEL = Conv3x3Kernel()


def run(x: torch.Tensor, w: torch.Tensor, scale: Optional[torch.Tensor],
        bias: Optional[torch.Tensor], stride: int, relu: bool, out_dtype: torch.dtype,
        tile_h: Optional[int] = None) -> torch.Tensor:
    """Check, then the plain version on the CPU or the kernel on CUDA.
    ``tile_h`` None is one tile per image."""
    _, H, _, _, Fo = check_inputs(x, w, stride)
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")
    scale = _affine(scale, 1.0, Fo, x.device)
    bias = _affine(bias, 0.0, Fo, x.device)
    if x.device.type == "cpu":
        return conv3x3_bn_relu_plain(x, w, scale, bias, stride, relu, out_dtype)
    # [F, 3, 3, C]: free when w is the HWIO view of an already packed weight
    w_packed = w.permute(3, 0, 1, 2).to(torch.bfloat16).contiguous()
    return KERNEL(x, w_packed, scale, bias, stride, relu, out_dtype,
                  H // stride if tile_h is None else tile_h)


def conv3x3_bn_relu(
    x: torch.Tensor,
    w: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    relu: bool = True,
    k_pack: Optional[bool] = None,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """[B, H, W, C] × [3, 3, C, F] → [B, H/s, W/s, F] with SAME padding and
    the fused per-channel affine (+ReLU). ``k_pack`` has no effect."""
    return run(x, w, scale, bias, stride, relu, out_dtype)


def conv3x3_bn_relu_tiled(
    x: torch.Tensor,
    w: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    relu: bool = True,
    tile_h: int = 32,
    k_pack: Optional[bool] = None,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Stride-1 ``conv3x3_bn_relu`` with ``tile_h`` output rows per tile;
    H must divide by ``tile_h``, as in the reference. ``k_pack`` has no
    effect."""
    if tile_h <= 0 or (x.ndim == 4 and x.shape[1] % tile_h):
        raise ValueError(f"H={x.shape[1]} must divide by tile_h={tile_h}")
    return run(x, w, scale, bias, 1, relu, out_dtype, tile_h)
