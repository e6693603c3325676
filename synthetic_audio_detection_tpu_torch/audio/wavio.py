"""RIFF/WAVE reader and writer (the port's copy of the reference package's
``audio/wavio.py``).

PCM 8/16/24/32-bit and IEEE float32/64, any channel count, chunks in any
order. Readers return float32 in [-1, 1] shaped [channels, samples], as
``torchaudio.load`` does.
"""

from __future__ import annotations

import io
import os
import struct
from typing import Tuple, Union

import numpy as np

_RIFF = b"RIFF"
_WAVE = b"WAVE"
_FMT = b"fmt "
_DATA = b"data"

# wFormatTag values understood here
_FMT_PCM = 0x0001
_FMT_IEEE_FLOAT = 0x0003
_FMT_EXTENSIBLE = 0xFFFE


class WavFormatError(ValueError):
    pass


def _trim(raw: bytes, itemsize: int) -> bytes:
    """Drop a trailing partial sample (a file truncated mid-sample)."""
    return raw[: len(raw) - len(raw) % itemsize]


def _decode_pcm(raw: bytes, bits: int, channels: int) -> np.ndarray:
    if bits == 16:
        x = np.frombuffer(_trim(raw, 2), dtype="<i2").astype(np.float32) / 32768.0
    elif bits == 32:
        x = np.frombuffer(_trim(raw, 4), dtype="<i4").astype(np.float32) / 2147483648.0
    elif bits == 24:
        b = np.frombuffer(raw, dtype=np.uint8)
        n = len(b) // 3
        b = b[: n * 3].reshape(n, 3)
        # sign-extend 24-bit little-endian into int32
        x = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / 8388608.0
    elif bits == 8:
        # 8-bit WAV is unsigned
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise WavFormatError(f"unsupported PCM bit depth: {bits}")
    n = len(x) // channels
    return x[: n * channels].reshape(n, channels).T


def _decode_float(raw: bytes, bits: int, channels: int) -> np.ndarray:
    if bits == 32:
        x = np.frombuffer(_trim(raw, 4), dtype="<f4").astype(np.float32)
    elif bits == 64:
        x = np.frombuffer(_trim(raw, 8), dtype="<f8").astype(np.float32)
    else:
        raise WavFormatError(f"unsupported float bit depth: {bits}")
    n = len(x) // channels
    return x[: n * channels].reshape(n, channels).T


def read_wav_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """Parse a WAV byte string → (waveform [channels, samples] float32, sample_rate)."""
    if len(data) < 12 or data[:4] != _RIFF or data[8:12] != _WAVE:
        raise WavFormatError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    raw = None
    size = len(data)
    while pos + 8 <= size:
        cid = data[pos : pos + 4]
        (csize,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + csize]
        if cid == _FMT:
            # a declared size past the end clamps to the bytes present, so a
            # truncated file fails with WavFormatError, not struct.error
            if len(body) < 16:
                raise WavFormatError("fmt chunk too small")
            tag, channels, rate, _, _, bits = struct.unpack_from("<HHIIHH", body, 0)
            if tag == _FMT_EXTENSIBLE and len(body) >= 40:
                # the SubFormat GUID's first 2 bytes carry the real format tag
                (tag,) = struct.unpack_from("<H", body, 24)
            fmt = (tag, channels, rate, bits)
        elif cid == _DATA:
            raw = body
        pos += 8 + csize + (csize & 1)  # chunks are word-aligned
        if fmt is not None and raw is not None:
            break
    if fmt is None:
        raise WavFormatError("missing fmt chunk")
    if raw is None:
        raise WavFormatError("missing data chunk")
    tag, channels, rate, bits = fmt
    if channels < 1:
        raise WavFormatError("zero channels")
    if tag == _FMT_PCM:
        wf = _decode_pcm(raw, bits, channels)
    elif tag == _FMT_IEEE_FLOAT:
        wf = _decode_float(raw, bits, channels)
    else:
        raise WavFormatError(f"unsupported WAV format tag: {tag:#x}")
    return wf, rate


def read_wav(path: Union[str, os.PathLike]) -> Tuple[np.ndarray, int]:
    """Read a WAV file → (waveform [channels, samples] float32 in [-1,1], rate)."""
    with open(path, "rb") as f:
        return read_wav_bytes(f.read())


def pcm16_quantize(x: np.ndarray) -> np.ndarray:
    """Float waveform → int16 transport codes: scale by 32768, round to
    nearest, clamp to the int16 range (the device side dequantizes with the
    symmetric /32768). float32 arithmetic: exact for inputs on the PCM grid."""
    return np.clip(
        np.round(np.asarray(x, np.float32) * np.float32(32768.0)),
        -32768, 32767,
    ).astype(np.int16)


def write_wav(
    path: Union[str, os.PathLike],
    waveform: np.ndarray,
    sample_rate: int,
    subtype: str = "PCM_16",
) -> None:
    """Write a WAV file. ``waveform`` is [channels, samples] or [samples],
    float in [-1, 1] or int16; ``subtype`` PCM_16 (default) or FLOAT."""
    wf = np.asarray(waveform)
    if wf.ndim == 1:
        wf = wf[None, :]
    channels, n = wf.shape
    interleaved = wf.T.reshape(-1)

    if subtype == "PCM_16":
        if interleaved.dtype != np.int16:
            # libsndfile's float → PCM16: scale by 32768, round to nearest,
            # clamp; the /32768 read path round-trips within 0.5 LSB
            x = np.clip(interleaved.astype(np.float64), -1.0, 1.0)
            pcm = np.clip(np.round(x * 32768.0), -32768, 32767).astype("<i2")
        else:
            pcm = interleaved.astype("<i2")
        raw = pcm.tobytes()
        tag, bits = _FMT_PCM, 16
    elif subtype == "FLOAT":
        raw = interleaved.astype("<f4").tobytes()
        tag, bits = _FMT_IEEE_FLOAT, 32
    else:
        raise WavFormatError(f"unsupported write subtype: {subtype}")

    block_align = channels * bits // 8
    byte_rate = sample_rate * block_align
    buf = io.BytesIO()
    buf.write(_RIFF)
    buf.write(struct.pack("<I", 36 + len(raw)))
    buf.write(_WAVE)
    buf.write(_FMT)
    buf.write(struct.pack("<IHHIIHH", 16, tag, channels, sample_rate, byte_rate, block_align, bits))
    buf.write(_DATA)
    buf.write(struct.pack("<I", len(raw)))
    buf.write(raw)
    with open(path, "wb") as f:
        f.write(buf.getvalue())
