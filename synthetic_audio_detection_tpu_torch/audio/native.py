"""ctypes bindings for the native audio library (the port's copy of the
reference package's ``audio/native.py``, the same API).

Multithreaded WAV decode with mono downmix, and the polyphase resampler's
strided-dot loop, in C++ (``native/sadio.cpp``), for the host data path.
The port does not load the repository's prebuilt ``native/libsadio.so``
(it was built for one host's CPU): at first use it builds
``native/sadio.cpp`` with ``g++`` into its own build directory
(``ops/build.build_host``). A failed build raises with the compiler's
output; there is no silent fallback to the Python reader.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import List, Optional, Tuple

import numpy as np

from synthetic_audio_detection_tpu_torch.audio.resample import sinc_kernels
from synthetic_audio_detection_tpu_torch.ops import build

SOURCE = build.PACKAGE_DIR.parent / "native" / "sadio.cpp"

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build.build_host(SOURCE)))
        lib.sadio_wav_info.restype = ctypes.c_int32
        lib.sadio_wav_info.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.sadio_decode_file_mono.restype = ctypes.c_int64
        lib.sadio_decode_file_mono.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
        ]
        lib.sadio_decode_batch.restype = None
        lib.sadio_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        lib.sadio_resample_poly.restype = ctypes.c_int64
        lib.sadio_resample_poly.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_int32,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """True once the library is built and loaded; a failed build raises."""
    return _load() is not None


def _floats(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def wav_info(path: str) -> Tuple[int, int, int]:
    """(channels, sample_rate, frames) — raises ValueError on a parse failure."""
    lib = _load()
    with open(path, "rb") as f:
        data = f.read()
    ch = ctypes.c_int32()
    sr = ctypes.c_int32()
    fr = ctypes.c_int64()
    rc = lib.sadio_wav_info(data, len(data), ctypes.byref(ch), ctypes.byref(sr),
                            ctypes.byref(fr))
    if rc != 0:
        raise ValueError(f"{path}: sadio parse error {rc}")
    return ch.value, sr.value, fr.value


def read_mono(path: str, max_frames: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Decode + mean-downmix one WAV → (float32 [T], sample_rate)."""
    lib = _load()
    if max_frames is None:
        _, _, max_frames = wav_info(path)
    out = np.zeros(max(max_frames, 1), np.float32)
    sr = ctypes.c_int32()
    got = lib.sadio_decode_file_mono(path.encode(), _floats(out), max_frames, ctypes.byref(sr))
    if got < 0:
        raise ValueError(f"{path}: sadio decode error {got}")
    return out[:got], sr.value


def resample_poly(x: np.ndarray, orig_sr: int, new_sr: int,
                  threads: int = 0) -> Optional[np.ndarray]:
    """Multithreaded C polyphase resample with ``audio/resample.py``'s
    kernel bank (torchaudio semantics): ``resample_poly_np``'s function with
    its float32 sums in another order. None when the library rejects the
    input (an empty ``x``)."""
    lib = _load()
    if orig_sr == new_sr:
        return np.asarray(x, np.float32)
    kern, width, orig_g, new_g = sinc_kernels(orig_sr, new_sr)
    kern = np.ascontiguousarray(kern, np.float32)  # [new_g, L]
    x = np.ascontiguousarray(x, np.float32)
    target = int(math.ceil(new_g * len(x) / orig_g))
    out = np.empty(target, np.float32)
    got = lib.sadio_resample_poly(_floats(x), len(x), _floats(kern), new_g, orig_g,
                                  kern.shape[1], width, _floats(out), target, threads)
    if got < 0:
        return None
    return out


def decode_batch(paths: List[str], max_frames: int,
                 threads: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode N files in parallel → (out [N, max_frames] zero-padded,
    lengths [N] (negative = per-file error), rates [N])."""
    lib = _load()
    n = len(paths)
    out = np.zeros((n, max_frames), np.float32)
    lengths = np.zeros(n, np.int64)
    rates = np.zeros(n, np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.sadio_decode_batch(
        arr, n, _floats(out), max_frames,
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        rates.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        threads,
    )
    return out, lengths, rates
