"""The port's binding of the native audio library (``audio/native.py``),
built from ``native/sadio.cpp`` into the port's build directory, against
the JAX package's binding and against the Python WAV reader: the cases of
tests/test_native.py and a cut of tests/test_wav_fuzz.py's mutations."""

import ctypes
import math
import os
import struct

import numpy as np
import pytest

from synthetic_audio_detection_tpu.audio import native as jnative
from synthetic_audio_detection_tpu_torch.audio import native, wavio
from synthetic_audio_detection_tpu_torch.audio.resample import resample_poly_np, sinc_kernels
from synthetic_audio_detection_tpu_torch.ops import build
from tests.test_wav_fuzz import _valid_wavs


def _write(tmp_path, name, data, sr=32_000, subtype="PCM_16"):
    p = tmp_path / name
    wavio.write_wav(p, data, sr, subtype)
    return str(p)


def test_library_is_built_from_source_into_the_build_directory():
    assert native.available()
    path = build.host_library_path(native.SOURCE)
    assert path.exists() and path.parent == build.BUILD_DIR
    assert native.SOURCE.name == "sadio.cpp" and native.SOURCE.exists()
    assert "-march=native" not in build.GXX_FLAGS
    assert os.path.realpath(native._lib._name) == os.path.realpath(path)
    tracked = os.path.realpath(os.path.join(build.PACKAGE_DIR.parent, "native", "libsadio.so"))
    assert os.path.realpath(native._lib._name) != tracked


def test_failed_build_raises_with_the_compilers_log(tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("extern \"C\" int f() { return undeclared_name; }\n")
    with pytest.raises(RuntimeError, match="undeclared_name"):
        build.build_host(bad)
    assert not build.host_library_path(bad).exists()


@pytest.mark.parametrize("channels,sr,subtype", [(2, 44_100, "PCM_16"), (1, 16_000, "FLOAT"),
                                                 (3, 32_000, "PCM_16")])
def test_info_and_mono_match(tmp_path, rng, channels, sr, subtype):
    x = np.clip(rng.standard_normal((channels, 5000)) * 0.3, -0.99, 0.99).astype(np.float32)
    p = _write(tmp_path, "a.wav", x, sr, subtype)
    assert native.wav_info(p) == jnative.wav_info(p) == (channels, sr, 5000)
    mono, got_sr = native.read_mono(p)
    ref, _ = wavio.read_wav(p)
    assert got_sr == sr
    np.testing.assert_allclose(mono, ref.mean(axis=0), atol=1e-7)
    np.testing.assert_array_equal(mono, jnative.read_mono(p)[0])
    np.testing.assert_array_equal(native.read_mono(p, max_frames=1000)[0], mono[:1000])


def test_batch_decode(tmp_path, rng):
    paths, refs = [], []
    for i in range(5):
        x = np.clip(rng.standard_normal((2, 1000 + 100 * i)) * 0.2, -1, 1).astype(np.float32)
        paths.append(_write(tmp_path, f"b{i}.wav", x, 32_000))
        refs.append(wavio.read_wav(paths[-1])[0].mean(axis=0))
    paths.append(str(tmp_path / "missing.wav"))  # per-file error isolation
    out, lengths, rates = native.decode_batch(paths, max_frames=1200, threads=3)
    j_out, j_lengths, j_rates = jnative.decode_batch(paths, max_frames=1200, threads=3)
    np.testing.assert_array_equal(out, j_out)
    np.testing.assert_array_equal(lengths, j_lengths)
    np.testing.assert_array_equal(rates, j_rates)
    assert out.shape == (6, 1200) and lengths[5] < 0
    for i, r in enumerate(refs):
        n = min(len(r), 1200)
        assert lengths[i] == n and rates[i] == 32_000
        np.testing.assert_allclose(out[i, :n], r[:n], atol=1e-7)
        np.testing.assert_array_equal(out[i, n:], 0)


@pytest.mark.parametrize("orig,new", [(44_100, 32_000), (48_000, 32_000), (16_000, 32_000)])
def test_resample_poly_matches_numpy(rng, orig, new):
    """The C loop and the sgemm sum the same float32 products in other
    orders; both errors are within L·2^-24·Σ|k·x| of the exact sum, so the
    two differ by at most twice that (about 2e-5 at 44.1 → 32 kHz)."""
    x = (rng.standard_normal(20_011) * 0.3).astype(np.float32)
    got = native.resample_poly(x, orig, new, threads=3)
    ref = resample_poly_np(x, orig, new)
    kern, *_ = sinc_kernels(orig, new)
    tol = 2 * kern.shape[1] * 2.0 ** -24 * float(np.abs(kern).sum(axis=1).max()) \
        * float(np.abs(x).max())
    assert got.shape == ref.shape == (math.ceil(len(x) * new / orig),)
    assert float(np.abs(got - ref).max()) <= tol
    assert native.resample_poly(np.zeros(0, np.float32), orig, new) is None
    np.testing.assert_array_equal(native.resample_poly(x, orig, orig), x)


def _mutations(group):
    """A cut of tests/test_wav_fuzz.py's mutations, by group."""
    rng = np.random.default_rng(11)
    wavs = _valid_wavs(rng)
    _, blob = wavs[0]  # PCM_16 stereo
    fmt_at, data_at = blob.index(b"fmt "), blob.index(b"data")
    if group == "whole":
        return [(f"{name} whole", b) for name, b in wavs]
    if group == "truncations":
        return [(f"{name} cut@{c}", b[:c]) for name, b in wavs[:3] for c in range(0, len(b), 13)]
    if group == "header fields":
        cases = []
        for at, field in [(fmt_at, "fmt"), (data_at, "data")]:
            for csize in (0, 1, 15, 16, 0xFFFFFFFF, len(blob)):
                b = bytearray(blob)
                struct.pack_into("<I", b, at + 4, csize)
                cases.append((f"{field} csize={csize}", bytes(b)))
        for off, values in [(2, (0, 255)), (14, (0, 12, 64)), (0, (0x0000, 0x0055, 0xFFFE))]:
            for v in values:
                b = bytearray(blob)
                struct.pack_into("<H", b, fmt_at + 8 + off, v)
                cases.append((f"fmt+{off}={v}", bytes(b)))
        return cases + [(f"mid-sample -{d}", blob[:-d]) for d in (1, 2, 3)]
    if group == "pathological":
        return [("empty", b""), ("RIFF only", b"RIFF"),
                ("no chunks", b"RIFF\x00\x00\x00\x00WAVE"),
                ("data no fmt", b"RIFF\x10\x00\x00\x00WAVEdata\x00\x00\x00\x00"),
                ("aiff", b"FORM\x00\x00\x00\x10AIFF" + b"\x00" * 32)]
    cases = []
    for i in range(12):
        name, b = wavs[int(rng.integers(len(wavs)))]
        b = bytearray(b)
        for _ in range(int(rng.integers(1, 6))):
            b[int(rng.integers(len(b)))] = int(rng.integers(256))
        cases.append((f"{name} flips {i}", bytes(b)))
    return cases


def _decode(fn, path):
    try:
        mono, sr = fn(path)
        return "ok", mono, sr
    except ValueError:
        return ("err",)


@pytest.mark.parametrize("group", ["whole", "truncations", "header fields", "pathological",
                                   "random flips"])
def test_mutations_agree_with_wavio_and_the_jax_binding(tmp_path, group):
    """For each mutated file the port's binding, the JAX package's and the
    Python reader either all decode, to the same samples and rate, or all
    raise a ValueError; nothing crashes the process."""
    cases = _mutations(group)
    assert len(cases) >= 5
    for i, (note, blob) in enumerate(cases):
        p = str(tmp_path / f"m{i}.wav")
        with open(p, "wb") as f:
            f.write(blob)
        port = _decode(native.read_mono, p)
        jax_side = _decode(jnative.read_mono, p)
        py = _decode(lambda q: (lambda w: (w[0].mean(axis=0).astype(np.float32), w[1]))(
            wavio.read_wav(q)), p)
        assert port[0] == jax_side[0] == py[0], note
        if port[0] == "ok":
            assert port[2] == py[2] == jax_side[2], note
            np.testing.assert_array_equal(port[1], jax_side[1], err_msg=note)
            np.testing.assert_allclose(port[1], py[1], atol=1e-6, err_msg=note)


def test_every_symbol_is_bound():
    lib = native._load()
    for name in ("sadio_wav_info", "sadio_decode_file_mono", "sadio_decode_batch",
                 "sadio_resample_poly"):
        assert getattr(lib, name).argtypes and getattr(lib, name).restype in (
            ctypes.c_int32, ctypes.c_int64, None)
