"""The port's log-mel front end (synthetic_audio_detection_tpu_torch.ops)
against the JAX package: the same numpy inputs through both, on the CPU.

The Pallas factored kernel runs in interpret mode, as
tests/test_pallas_melspec.py runs it. The port's CUDA kernel runs only on a
GPU (tests/test_torch_cuda.py); on the CPU its wrapper runs the plain
version, which is what these tests hold against the reference.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.ndimage
import torch

from synthetic_audio_detection_tpu.ops import filters as jax_filters
from synthetic_audio_detection_tpu.ops import melspec as JM
from synthetic_audio_detection_tpu.ops.pallas_melspec import fused_log_mel_factored
from synthetic_audio_detection_tpu.utils.config import SpectrogramConfig
from synthetic_audio_detection_tpu_torch.ops import build, cuda_melspec, filters
from synthetic_audio_detection_tpu_torch.ops import melspec as TM

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "golden_v1.npz")
CFG = SpectrogramConfig(mel_norm="slaney")


@pytest.fixture(scope="module")
def waves():
    return (np.random.default_rng(11).standard_normal((2, 128_000)) * 0.3).astype(np.float32)


@pytest.fixture(scope="module")
def pallas_out(waves):
    return {std: np.asarray(fused_log_mel_factored(jnp.asarray(waves), CFG, interpret=True,
                                                   standardize=std))
            for std in (True, False)}


@pytest.mark.parametrize("standardize", [True, False])
def test_plain_factored_bf16_matches_pallas_kernel(waves, pallas_out, standardize):
    """bf16 DFT operands and float32 accumulation on both sides: every
    product is exact in float32, so only the summation order of the
    512-term DFT and of the mel product differs. Bound: 1e-4 on z-scores,
    1e-3 dB on the dB plane (both about 20x the observed worst case)."""
    got = cuda_melspec.fused_log_mel_factored(torch.from_numpy(waves), CFG,
                                              standardize=standardize).numpy()
    ref = pallas_out[standardize]
    assert got.shape == ref.shape == (2, 128, 251)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 if standardize else 1e-3)


@pytest.mark.parametrize("standardize", [True, False])
def test_plain_factored_f32_within_kernel_bound(waves, pallas_out, standardize):
    """The exact (float32) factored algorithm against the bf16 kernel, at
    the reference's own bounds for bf16 DFT rounding: rtol 0.05 / atol 0.15
    on z-scores (test_pallas_melspec.py:64) and atol 1.5 dB with a 0.05 dB
    mean on the dB plane (test_pallas_melspec.py:161-162)."""
    got = TM.log_mel_factored(torch.from_numpy(waves), CFG, standardize=standardize,
                              dft_dtype=torch.float32).numpy()
    ref = pallas_out[standardize]
    if standardize:
        np.testing.assert_allclose(got, ref, rtol=0.05, atol=0.15)
    else:
        assert float(np.mean(np.abs(got - ref))) < 0.05
        np.testing.assert_allclose(got, ref, atol=1.5)


def test_plain_factored_f32_matches_gemm_front_end(waves):
    """Factored and direct GEMM DFT are the same transform: float32
    rounding only (1e-4 on z-scores)."""
    x = torch.from_numpy(waves)
    got = TM.log_mel_factored(x, CFG, dft_dtype=torch.float32)
    ref = TM.standardize(TM.amplitude_to_db(TM.mel_spectrogram(x, CFG, use_gemm_dft=True)))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("signal", ["tone", "chirp", "white"])
def test_bf16_dft_floor_is_the_reference_kernels(signal):
    """bf16 DFT operands put a rounding floor about 54 dB below a window's
    peak, inside the 80-dB clamp. Where most of the mel plane lies below
    that floor (tones, chirps) bf16 and float32 z-scores differ by O(1);
    on broadband noise they agree to the reference's 0.15 bound. The port
    reproduces the reference kernel here too (1e-4 against Pallas), so this
    is the reference design's numerics, not a port drift."""
    t = np.arange(128_000) / 32_000
    x = {"tone": 0.3 * np.sin(2 * np.pi * 1000 * t),
         "chirp": 0.3 * np.sin(2 * np.pi * (100 * t + 7900 * t ** 2 / 8)),
         "white": 0.3 * np.random.default_rng(12).standard_normal(t.size)}[signal]
    x = x.astype(np.float32)[None]
    bf16 = TM.log_mel_factored(torch.from_numpy(x), CFG, dft_dtype=torch.bfloat16).numpy()
    ref = np.asarray(fused_log_mel_factored(jnp.asarray(x), CFG, interpret=True))
    np.testing.assert_allclose(bf16, ref, rtol=0, atol=1e-4)
    exact = TM.log_mel_factored(torch.from_numpy(x), CFG, dft_dtype=torch.float32).numpy()
    deviation = float(np.abs(bf16 - exact).max())
    if signal == "white":
        assert deviation < 0.15
    else:
        assert deviation > 0.5


def test_wrapper_uses_plain_version_on_cpu_and_counts_nothing(waves):
    x = torch.from_numpy(waves[:1])
    before = cuda_melspec.KERNEL.launches
    got = cuda_melspec.serving_log_mel(x, CFG)
    ref = TM.log_mel_factored(x, CFG, dft_dtype=torch.bfloat16)
    assert torch.equal(got, ref)
    assert cuda_melspec.KERNEL.launches == before


def test_wrapper_dequantises_int16(waves):
    pcm = np.clip(np.round(waves[:1] * 32768), -32768, 32767).astype(np.int16)
    got = cuda_melspec.fused_log_mel_factored(torch.from_numpy(pcm), CFG)
    ref = cuda_melspec.fused_log_mel_factored(
        torch.from_numpy(pcm.astype(np.float32) / 32768.0), CFG)
    assert torch.equal(got, ref)


def test_wrapper_raises_instead_of_falling_back():
    meta = torch.empty((1, 128_000), device="meta")
    with pytest.raises(ValueError):
        cuda_melspec.fused_log_mel_factored(meta, CFG)
    with pytest.raises(ValueError):  # the kernel itself never takes a CPU tensor
        cuda_melspec.KERNEL(torch.zeros((1, 128_000)), CFG)
    with pytest.raises(TypeError):
        cuda_melspec.fused_log_mel_factored(torch.zeros((1, 128_000), dtype=torch.float64), CFG)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_gemm_front_end_matches_recorded_mel():
    """Same bound as test_golden_fixtures.py:46 (2e-4)."""
    golden = np.load(FIXTURE)
    got = TM.log_mel_features(torch.from_numpy(golden["audio"]), CFG, 32_000,
                              use_gemm_dft=True).numpy()
    np.testing.assert_allclose(got, golden["mel"], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("mode", ["fft", "gemm", "factored"])
def test_mel_spectrogram_matches_jax(waves, mode):
    """float32 on both sides; relative 1e-5 of the largest mel value."""
    got = TM.mel_spectrogram(torch.from_numpy(waves), CFG, 32_000, dft_mode=mode).numpy()
    ref = np.asarray(JM.mel_spectrogram(jnp.asarray(waves), CFG, 32_000, dft_mode=mode))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("norm", [None, "slaney"])
def test_filterbank_matches_jax(norm):
    args = (1025, 20.0, 12_000.0, 128, 32_000, norm, "htk")
    np.testing.assert_array_equal(TM.mel_filterbank(*args), JM.mel_filterbank(*args))


def test_host_constants_match_jax():
    fb = JM.mel_filterbank(1025, 20.0, 12_000.0, 128, 32_000, "slaney", "htk")
    assert TM.significant_bins(fb) == JM.significant_bins(fb) == 768
    np.testing.assert_array_equal(TM.hann_window(2048), JM.hann_window(2048))
    for a, b in zip(TM._dft_matrices(2048, 769), JM._dft_matrices(2048, 769)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(TM.hop_block_phases(2048, 512, 769), JM.hop_block_phases(2048, 512, 769)):
        np.testing.assert_array_equal(a, b)


def test_frame_signal_matches_jax(waves):
    got = TM.frame_signal(torch.from_numpy(waves), 2048, 512, True, "reflect").numpy()
    ref = np.asarray(JM.frame_signal(jnp.asarray(waves), 2048, 512, True, "reflect"))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("out_size", [512, 256, 64, 0])
def test_finalize_features_matches_jax(out_size):
    """Antialiased bilinear resize against jax.image.resize 'linear' (and
    the native zero pad): float32 rounding only."""
    cfg = SpectrogramConfig(mel_norm="slaney", out_size=out_size)
    z = np.random.default_rng(3).standard_normal((2, 128, 251)).astype(np.float32)
    got = TM.finalize_features(torch.from_numpy(z), cfg).numpy()
    ref = np.asarray(JM.finalize_features(jnp.asarray(z), cfg))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_db_and_standardize_match_jax():
    """float32 log10 and two-pass moments: 1e-5 relative."""
    p = np.random.default_rng(4).gamma(0.5, 1.0, (2, 128, 251)).astype(np.float32) ** 4
    db = TM.amplitude_to_db(torch.from_numpy(p), 80.0)
    db_ref = JM.amplitude_to_db(jnp.asarray(p), 80.0)
    np.testing.assert_allclose(db.numpy(), np.asarray(db_ref), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(TM.standardize(db).numpy(),
                               np.asarray(JM.standardize(db_ref)), rtol=1e-5, atol=1e-5)


def test_replicate_channels_is_nchw():
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    y = TM.replicate_channels(x, 3)
    assert y.shape == (2, 3, 3, 4)
    for c in range(3):
        assert torch.equal(y[:, c], x)


@pytest.mark.parametrize("n", [1, 3, 9, 40])
def test_gaussian_filter_matches_scipy_and_jax(n):
    """scipy 'reflect' boundary, including axes shorter than the radius
    (σ = 2 → radius 8). float32: 1e-6."""
    x = np.random.default_rng(n).random((n, 3)).astype(np.float32)
    got = filters.gaussian_filter1d(torch.from_numpy(x), 2.0, axis=0).numpy()
    np.testing.assert_allclose(got, scipy.ndimage.gaussian_filter1d(x, 2.0, axis=0),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        got, np.asarray(jax_filters.gaussian_filter1d(jnp.asarray(x), 2.0, axis=0)),
        rtol=0, atol=1e-6)
