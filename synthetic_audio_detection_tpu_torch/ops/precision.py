"""Float32 that is float32: TF32 off for the span of a ``with`` block.

On an NVIDIA GPU a float32 convolution goes through cuDNN in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True), and a float32 matmul does
where ``torch.backends.cuda.matmul.allow_tf32`` is set. TF32 keeps 10
mantissa bits, so a product of two bf16 values is no longer exact and a
float32 reference is no longer float32. The port's float32 paths (the
float32 forward, the plain versions of its kernels, the fast backbone's
exact convolutions) turn both flags off inside ``exact_float32()`` and
leave them as they found them, so no caller's setting leaks into another's.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def exact_float32() -> Iterator[None]:
    """Both TF32 flags False inside the block, restored on exit (also when
    the block raises)."""
    cudnn, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul
