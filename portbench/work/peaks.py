"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit), and the roofline bound."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

PEAK_BF16 = 989e12   # FLOP/s, tensor cores, bf16 and fp16
PEAK_F32 = 67e12     # FLOP/s, float32 outside the tensor cores
HBM_BYTES_S = 3.35e12


@dataclass(frozen=True)
class Work:
    """Operations (two a multiply-add) by the rate they run at, and bytes
    moved: each input byte read once, each output byte written once."""

    ops_bf16: float = 0.0
    ops_f32: float = 0.0
    bytes: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.ops_bf16 + other.ops_bf16, self.ops_f32 + other.ops_f32,
                    self.bytes + other.bytes)

    def __mul__(self, k: float) -> "Work":
        return Work(self.ops_bf16 * k, self.ops_f32 * k, self.bytes * k)

    __rmul__ = __mul__

    @property
    def ops(self) -> float:
        return self.ops_bf16 + self.ops_f32

    def bound(self) -> Tuple[float, str]:
        """(the least seconds the chip could take, 'operations' or 'bytes')."""
        t_ops = self.ops_bf16 / PEAK_BF16 + self.ops_f32 / PEAK_F32
        t_bytes = self.bytes / HBM_BYTES_S
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
