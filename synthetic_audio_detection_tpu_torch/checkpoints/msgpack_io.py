"""The native checkpoint's byte format: msgpack as flax writes it.

The port's counterpart of ``flax.serialization.msgpack_serialize`` and
``msgpack_restore``, written out for the subset a flax tree of numpy leaves
uses, with no ``msgpack`` package: maps (str keys), arrays, str, int,
float, bool, nil, bin, and flax's extension types 1 (ndarray: the msgpack
array ``[shape, dtype name, C-order bytes]``) and 3 (a numpy scalar,
packed as a 0-d ndarray); flax's type 2 (a Python complex) is refused.
Arrays over ``MAX_CHUNK_SIZE`` bytes take flax's chunked form (a map with
``__msgpack_chunked_array__``, the shape and the flat chunks as maps keyed
"0", "1", ...), both ways, as flax does. A bfloat16 array, which numpy
cannot hold, is read widened to float32 (exact).

``packb(tree)`` → bytes, ``unpackb(data)`` → tree: maps come back as
dicts, arrays as lists, the ndarray extension as a read-only numpy array.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
MAX_CHUNK_SIZE = 2 ** 30  # flax's: msgpack's limit per object, with a margin
CHUNKED = "__msgpack_chunked_array__"


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 128:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xFF)
    elif n >= 0:
        for code, fmt, top in ((0xCC, ">B", 2 ** 8), (0xCD, ">H", 2 ** 16),
                               (0xCE, ">I", 2 ** 32), (0xCF, ">Q", 2 ** 64)):
            if n < top:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"integer {n} does not fit msgpack's 64 bits")
    else:
        for code, fmt, low in ((0xD0, ">b", -2 ** 7), (0xD1, ">h", -2 ** 15),
                               (0xD2, ">i", -2 ** 31), (0xD3, ">q", -2 ** 63)):
            if n >= low:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"integer {n} does not fit msgpack's 64 bits")


def _pack_len(n: int, fix: Tuple[int, int], codes: Tuple[int, ...], out: bytearray) -> None:
    """A length header: ``fix`` (base, limit) for the fix form, then
    ``codes`` for the 8-, 16- and 32-bit forms (8-bit omitted for maps and
    arrays, which have none: pass -1)."""
    base, limit = fix
    if base >= 0 and n < limit:
        out.append(base | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (2 ** 8, 2 ** 16, 2 ** 32)):
        if code >= 0 and n < top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(f"length {n} over msgpack's 32 bits")


def _pack_bin(b: bytes, out: bytearray) -> None:
    _pack_len(len(b), (-1, 0), (0xC4, 0xC5, 0xC6), out)
    out += b


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_len(n, (-1, 0), (0xC7, 0xC8, 0xC9), out)
    out += struct.pack(">b", code)
    out += data


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    return packb([list(arr.shape), arr.dtype.name, np.ascontiguousarray(arr).tobytes("C")])


def _chunk(arr: np.ndarray) -> dict:
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {CHUNKED: True, "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, np.ndarray):
        if obj.nbytes > MAX_CHUNK_SIZE:
            _pack(_chunk(obj), out)
        else:
            _pack_ext(EXT_NDARRAY, _ndarray_bytes(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)), out)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(len(b), (0xA0, 32), (0xD9, 0xDA, 0xDB), out)
        out += b
    elif isinstance(obj, (bytes, bytearray)):
        _pack_bin(bytes(obj), out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), (0x80, 16), (-1, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), (0x90, 16), (-1, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} to msgpack")


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------

def _ndarray_from(data: bytes) -> np.ndarray:
    shape, name, buf = unpackb(data)
    if name == "bfloat16":
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape, order="C")


def _ext(code: int, data: bytes) -> Any:
    if code == EXT_NDARRAY:
        return _ndarray_from(data)
    if code == EXT_NPSCALAR:
        return _ndarray_from(data)[()]
    raise ValueError(f"unknown msgpack extension type {code}")


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return b

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        c = self.take(1)[0]
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.read() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self.take(c & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if c in lens:
            return self.take(self.unpack(lens[c]))
        exts = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if c in exts:
            n = self.unpack(exts[c])
            code = self.unpack(">b")
            return _ext(code, self.take(n))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if c in fixext:
            code = self.unpack(">b")
            return _ext(code, self.take(fixext[c]))
        nums = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in nums:
            return self.unpack(nums[c])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if c in strs:
            return self.take(self.unpack(strs[c])).decode("utf-8")
        if c in (0xDC, 0xDD):
            return [self.read() for _ in range(self.unpack(">H" if c == 0xDC else ">I"))]
        if c in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if c == 0xDE else ">I"))
        raise ValueError(f"msgpack byte 0x{c:02x} is not a format this reader takes")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data: bytes) -> Any:
    r = _Reader(data)
    obj = r.read()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after the msgpack object")
    return _unchunk(obj)
