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
import parity_bounds
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


@pytest.mark.parametrize("standardize", [True, False])
def test_plain_factored_lowp_tail_matches_pallas_kernel(waves, standardize):
    """lowp_tail: bf16 power and filterbank in the mel product, bf16 out, on
    both sides. Beyond the float32-tail bound above, two summation orders
    may round a power term to neighbouring bf16 values, and the output's
    own rounding adds one ulp: cuda_melspec.lowp_tail_tolerance."""
    x = torch.from_numpy(waves)
    ref = fused_log_mel_factored(jnp.asarray(waves), CFG, interpret=True,
                                 standardize=standardize, lowp_tail=True)
    got = cuda_melspec.fused_log_mel_factored(x, CFG, standardize=standardize, lowp_tail=True)
    assert ref.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    ref = torch.from_numpy(np.asarray(ref, np.float32))
    assert got.shape == ref.shape == (2, 128, 251)
    db_std = TM.log_mel_factored(x, CFG, standardize=False).std(dim=(1, 2))
    tol = (cuda_melspec.lowp_tail_tolerance(ref, db_std if standardize else None)
           + (1e-4 if standardize else 1e-3))
    assert bool(((got.float() - ref).abs() <= tol).all())


def test_lowp_tail_wrapper_uses_plain_version_on_cpu(waves):
    x = torch.from_numpy(waves[:1])
    before = cuda_melspec.KERNEL.launches
    got = cuda_melspec.serving_log_mel(x, CFG, lowp_tail=True)
    assert torch.equal(got, TM.log_mel_factored(x, CFG, lowp_tail=True))
    assert got.dtype == torch.bfloat16
    assert cuda_melspec.KERNEL.launches == before


def test_plain_factored_f32_matches_gemm_front_end(waves):
    """Factored and direct GEMM DFT are the same transform: float32
    rounding only (1e-4 on z-scores)."""
    x = torch.from_numpy(waves)
    got = TM.log_mel_factored(x, CFG, dft_dtype=torch.float32)
    ref = TM.standardize(TM.amplitude_to_db(TM.mel_spectrogram(x, CFG, use_gemm_dft=True)))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-4)


SIGNALS = ("tone", "chirp", "white")


def _signal(name):
    t = np.arange(128_000) / 32_000
    x = {"tone": 0.3 * np.sin(2 * np.pi * 1000 * t),
         "chirp": 0.3 * np.sin(2 * np.pi * (100 * t + 7900 * t ** 2 / 8)),
         "white": 0.3 * np.random.default_rng(12).standard_normal(t.size)}[name]
    return x.astype(np.float32)[None]


def _plain_bf16(x):
    """The port's plain bf16 log-mel of ``x``: (dB plane, z-scores)."""
    x = torch.from_numpy(x)
    return tuple(TM.log_mel_factored(x, CFG, standardize=std, dft_dtype=torch.bfloat16).numpy()
                 for std in (False, True))


# Where a cell lies within 54 dB of its window's peak (above the bf16
# design's floor), its power is not what is left after the DFT's sums
# cancel: there the port is held to the float64 truth at the numbers it was
# held to the reference kernel before (1e-4 z, and 1e-3 dB as
# test_plain_factored_bf16_matches_pallas_kernel holds the dB plane), which
# no CPU's float32 order comes near: the port lies within 5e-6 z and 6e-5
# dB of the truth there on all three signals, the reference kernel within
# 4e-5 z. The any-order float32 bound of parity_bounds.log_mel_truth is
# loose there (up to 0.075 z within 54 dB: γ_{hop+16} of the DFT's
# Σ|products|, which dwarf a cell 54 dB down) and governs alone below.
SIGNAL_DEPTH_DB = 54.0
SIGNAL_Z, SIGNAL_DB = 1e-4, 1e-3


def _signal_cells(truth):
    """The cells within SIGNAL_DEPTH_DB of their window's peak."""
    return truth.db.max(axis=(1, 2), keepdims=True) - truth.db <= SIGNAL_DEPTH_DB


def _assert_within_float32_bound(truth, db, z, name):
    parity_bounds.assert_within(db, truth.db, truth.db_bound, f"{name} dB")
    parity_bounds.assert_within(z, *truth.standardized(db), f"{name} z")


def _assert_port_within(truth, db, z):
    """The port's plain result within the float32 bound everywhere, and
    within SIGNAL_Z / SIGNAL_DB of the truth on the signal's cells."""
    _assert_within_float32_bound(truth, db, z, "port")
    near = _signal_cells(truth)
    parity_bounds.assert_within(db[near], truth.db[near], SIGNAL_DB, "port dB near the peak")
    parity_bounds.assert_within(z[near], truth.z[near], SIGNAL_Z, "port z near the peak")


@pytest.mark.parametrize("signal", SIGNALS)
def test_bf16_dft_floor_is_the_reference_kernels(signal):
    """bf16 DFT operands put a rounding floor about 54 dB below a window's
    peak, inside the 80-dB clamp. Where most of the mel plane lies below
    that floor (tones, chirps) bf16 and float32 z-scores differ by O(1);
    on broadband noise they agree to the reference's 0.15 bound. The port
    reproduces the reference kernel here too, so this is the reference
    design's numerics, not a port drift.

    Both are held, cell by cell, to the float64 evaluation of the one
    function they compute on the same bf16 operands, within the rounding
    that function's float32 sums allow in any order
    (parity_bounds.log_mel_truth: γ_{hop+16}·Σ|products| for the DFT,
    carried through |X|², the mel sum, 10·log10, the clamp and the
    standardize), on the dB plane and on z-scores, and so each other
    within the sum of their bounds; the port, on the cells within 54 dB
    of the peak, within SIGNAL_Z and SIGNAL_DB of the truth as well. Far
    below the peak a cell's power is what is left after the DFT's sums
    cancel, and the order in which float32 adds the exact bf16 products
    decides its last digits: the order differs with the CPU's instruction
    set, so a fixed 1e-4 against the reference there held the port to one
    CPU's rounding."""
    x = _signal(signal)
    truth = parity_bounds.log_mel_truth(x, CFG)
    port = _plain_bf16(x)
    ref = tuple(np.asarray(fused_log_mel_factored(jnp.asarray(x), CFG, interpret=True,
                                                  standardize=std)) for std in (False, True))
    _assert_port_within(truth, *port)
    _assert_within_float32_bound(truth, *ref, "reference")
    bf16 = port[1]
    exact = TM.log_mel_factored(torch.from_numpy(x), CFG, dft_dtype=torch.float32).numpy()
    deviation = float(np.abs(bf16 - exact).max())
    if signal == "white":
        assert deviation < 0.15
    else:
        assert deviation > 0.5


@pytest.mark.parametrize("signal", SIGNALS)
def test_log_mel_float32_bound_holds_and_stays_narrow(signal):
    """The check both ways: the port's plain result passes it, and what it
    allows the port's z-scores is below 1e-3 on every cell within 54 dB of
    the window's peak, so that the derived bound governs alone only below
    that. The derived bound itself: near a window's peak a DFT sum's
    float32 bound is γ_{hop+16} ≈ 3e-5 of its terms' magnitudes, and the
    window's mean and σ add at most γ̃_N of theirs; it widens with depth as
    the cell's power falls below those magnitudes, and reaches the clamp
    interval only below the float32 floor. On the tone and the chirp (dB
    σ ≈ 12) it is below 1e-3 z on every cell within 10 dB of the peak; on
    white noise, whose DFT terms cancel more and whose dB σ is 2.7, below
    1e-2."""
    x = _signal(signal)
    truth = parity_bounds.log_mel_truth(x, CFG)
    db, z = _plain_bf16(x)
    _assert_port_within(truth, db, z)
    bound = truth.standardized(db)[1]
    near = _signal_cells(truth)
    allowed = np.where(near, np.minimum(bound, SIGNAL_Z), bound)
    assert float(allowed[near].max()) < 1e-3
    depth = truth.db.max(axis=(1, 2), keepdims=True) - truth.db
    assert float(bound[depth <= 10].max()) < (1e-2 if signal == "white" else 1e-3)


def test_log_mel_bound_rejects_a_79_db_clamp(monkeypatch):
    """A top-dB clamp at 79 dB in place of 80, on the chirp (30% of its
    cells clamped): the derived bound rejects it on the dB plane and on
    z-scores, as the fixed 1e-4 against the reference kernel did."""
    x = _signal("chirp")
    truth = parity_bounds.log_mel_truth(x, CFG)
    ref = np.asarray(fused_log_mel_factored(jnp.asarray(x), CFG, interpret=True))
    to_db = TM.amplitude_to_db
    monkeypatch.setattr(TM, "amplitude_to_db", lambda p, top_db=80.0: to_db(p, top_db - 1.0))
    db, z = _plain_bf16(x)
    with pytest.raises(AssertionError):
        parity_bounds.assert_within(db, truth.db, truth.db_bound)
    with pytest.raises(AssertionError):
        parity_bounds.assert_within(z, *truth.standardized(db))
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(z, ref, rtol=0, atol=1e-4)


def test_log_mel_check_rejects_one_mel_filter_scaled_by_1e_3(monkeypatch):
    """One mel filter's weights scaled by 1 + 1e-3, on the tone: that mel
    bin's dB 4.3e-3 higher, its z-scores 3.6e-4. The any-order float32
    bound lets it through (at 0.05 of itself); the check near the peak
    rejects it on the dB plane and on z-scores, as the fixed 1e-4 against
    the reference kernel did."""
    x = _signal("tone")
    truth = parity_bounds.log_mel_truth(x, CFG)
    ref = np.asarray(fused_log_mel_factored(jnp.asarray(x), CFG, interpret=True))
    filterbank = TM.config_filterbank

    def drifted(cfg, sample_rate):
        fb = filterbank(cfg, sample_rate).copy()
        fb[:, 64] *= 1 + 1e-3
        return fb

    monkeypatch.setattr(TM, "config_filterbank", drifted)
    db, z = _plain_bf16(x)
    _assert_within_float32_bound(truth, db, z, "port")
    with pytest.raises(AssertionError, match="near the peak"):
        _assert_port_within(truth, db, z)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(z, ref, rtol=0, atol=1e-4)


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


@pytest.mark.parametrize("out_size", [512, 256, 0])
def test_finalize_features_keeps_bf16(out_size):
    """A bf16 log-mel (lowp_tail) is resized in float32 and comes back bf16."""
    cfg = SpectrogramConfig(mel_norm="slaney", out_size=out_size)
    z = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 128, 251))
                         .astype(np.float32)).to(torch.bfloat16)
    got = TM.finalize_features(z, cfg)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, TM.finalize_features(z.float(), cfg).to(torch.bfloat16))


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
