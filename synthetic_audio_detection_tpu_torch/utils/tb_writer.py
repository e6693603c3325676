"""Minimal TensorBoard scalar writer (the port's own copy of the reference
package's ``utils/tb_writer.py``, pinned to it by ``tests/test_torch_host.py``).

The reference logs train/val scalars through torch's SummaryWriter every 100
steps and per epoch (reference: submodel_trainer.py:662,295-298,717-720).
This writer produces byte-compatible ``events.out.tfevents.*`` files by
encoding the two protobuf messages TensorBoard actually reads (Event,
Summary.Value.simple_value) directly on the wire, framed as TFRecords with
masked CRC-32C — loadable by any standard TensorBoard.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

# ---------------------------------------------------------------------------
# CRC-32C (Castagnoli), table-driven
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _build_table():
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_build_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Protobuf wire encoding (just what Event/Summary need)
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b7 | 0x80])
        else:
            out += bytes([b7])
            return out


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _int64(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _bytes(field: int, v: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(v)) + v


def _string(field: int, v: str) -> bytes:
    return _bytes(field, v.encode("utf-8"))


def _scalar_event(wall_time: float, step: int, tag: str, value: float) -> bytes:
    # Summary.Value { tag = 1, simple_value = 2 }
    sval = _string(1, tag) + _float(2, value)
    # Summary { value = 1 (repeated) }
    summary = _bytes(1, sval)
    # Event { wall_time = 1 (double), step = 2 (int64), summary = 5 }
    return _double(1, wall_time) + _int64(2, step) + _bytes(5, summary)


def _file_version_event(wall_time: float) -> bytes:
    # Event { wall_time = 1, file_version = 3 (string) }
    return _double(1, wall_time) + _string(3, "brain.Event:2")


class SummaryWriter:
    """Append-only TB event file writer (SummaryWriter-compatible subset)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        ts = time.time()
        name = f"events.out.tfevents.{int(ts)}.{socket.gethostname()}.{os.getpid()}.0"
        self._path = os.path.join(log_dir, name)
        self._f = open(self._path, "ab")
        self._write_record(_file_version_event(ts))

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: Optional[float] = None) -> None:
        self._write_record(
            _scalar_event(wall_time or time.time(), int(step), tag, float(value))
        )

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
