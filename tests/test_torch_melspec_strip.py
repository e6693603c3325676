"""The port's strip-DFT log-mel (ops/cuda_melspec_strip.py) against the JAX
package's ``fused_log_mel``: the same numpy inputs through both, on the CPU.

The Pallas kernel runs in interpret mode, as tests/test_pallas_melspec.py
runs it. The port's CUDA kernel runs only on a GPU (tests/test_torch_cuda.py);
on the CPU its wrapper runs the plain version, ``ops.melspec.log_mel_strip``,
which is what these tests hold against the reference.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from synthetic_audio_detection_tpu.ops import melspec as JM
from synthetic_audio_detection_tpu.ops.pallas_melspec import fused_log_mel
from synthetic_audio_detection_tpu.utils.config import SpectrogramConfig
from synthetic_audio_detection_tpu_torch.ops import build, cuda_melspec, cuda_melspec_strip
from synthetic_audio_detection_tpu_torch.ops import melspec as TM

CFG = SpectrogramConfig(mel_norm="slaney")
# plain version vs the Pallas kernel: the same bf16 operands (the windowed
# frame rounded once, the cos|sin), every product exact in float32, so only
# the float32 summation order of the 2048-term DFT and of the mel product
# differs; measured 2.4e-6 (norm None) and 4.8e-6 (slaney) at [2, 128000],
# the bound is about 20x that
TOL_Z = 1e-4


def _waves(batch, samples, seed):
    return (np.random.default_rng(seed).standard_normal((batch, samples)) * 0.3).astype(np.float32)


@pytest.fixture(scope="module")
def waves():
    return _waves(2, 128_000, seed=21)


@pytest.fixture(scope="module")
def pallas_z(waves):
    return np.asarray(fused_log_mel(jnp.asarray(waves), CFG, interpret=True))


@pytest.mark.parametrize("norm", [None, "slaney"])
def test_plain_strip_matches_pallas_kernel(waves, pallas_z, norm):
    cfg = SpectrogramConfig(mel_norm=norm)
    got = cuda_melspec_strip.fused_log_mel(torch.from_numpy(waves), cfg).numpy()
    ref = pallas_z if norm == "slaney" else np.asarray(
        fused_log_mel(jnp.asarray(waves), cfg, interpret=True))
    assert got.shape == ref.shape == (2, 128, 251)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL_Z)


def test_plain_strip_short_window_matches_pallas_kernel():
    """1-s windows: 63 frames, one partial 128-frame tile on the card."""
    x = _waves(1, 32_000, seed=22)
    got = cuda_melspec_strip.fused_log_mel(torch.from_numpy(x), CFG).numpy()
    ref = np.asarray(fused_log_mel(jnp.asarray(x), CFG, interpret=True))
    assert got.shape == ref.shape == (1, 128, 63)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL_Z)


@pytest.mark.parametrize("batch,wpc,stack", [
    (4, 1, False), (4, 2, False), (4, 4, False), (4, 2, True), (4, 4, True),
    (3, 2, False),  # 2 does not divide 3: the reference packs 1 window per cell
])
def test_windows_per_cell_and_stack_windows_change_no_value(batch, wpc, stack):
    """The TPU grid's packing: the reference gives identical output for
    every packing, and the port accepts the arguments and selects nothing
    with them."""
    x = _waves(4, 32_000, seed=23)[:batch]
    base = cuda_melspec_strip.fused_log_mel(torch.from_numpy(x), CFG)
    got = cuda_melspec_strip.fused_log_mel(torch.from_numpy(x), CFG, windows_per_cell=wpc,
                                           stack_windows=stack)
    assert torch.equal(got, base)
    ref = np.asarray(fused_log_mel(jnp.asarray(x), CFG, interpret=True, windows_per_cell=wpc,
                                   stack_windows=stack))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL_Z)


@pytest.mark.parametrize("out_size,shape", [(512, (2, 512, 512)), (256, (2, 256, 256)),
                                            (0, (2, 128, 256))])
def test_mel_only_front_end_matches_jax_composition(waves, pallas_z, out_size, shape):
    """fused_log_mel → finalize_features → bf16, as the reference's mel-only
    benchmark composes it. The resize is a convex combination, so the
    log-mel's bound carries over (the two resizes agree to 1e-5 on their
    own); the bf16 cast then adds one ulp where the two straddle a rounding
    boundary."""
    cfg = SpectrogramConfig(mel_norm="slaney", out_size=out_size)
    z = cuda_melspec_strip.fused_log_mel(torch.from_numpy(waves), cfg)
    got32 = TM.finalize_features(z, cfg)
    ref32 = np.asarray(JM.finalize_features(jnp.asarray(pallas_z), cfg))
    assert got32.shape == ref32.shape == shape
    np.testing.assert_allclose(got32.numpy(), ref32, rtol=0, atol=TOL_Z + 1e-5)
    got = got32.to(torch.bfloat16).float().numpy()
    ref = np.asarray(jnp.asarray(ref32).astype(jnp.bfloat16), np.float32)
    assert np.all(np.abs(got - ref) <= 2.0 ** -7 * np.abs(ref) + TOL_Z + 1e-5)


def test_wrapper_uses_plain_version_on_cpu_and_counts_nothing(waves):
    x = torch.from_numpy(waves[:1])
    before = cuda_melspec_strip.KERNEL.launches
    got = cuda_melspec_strip.fused_log_mel(x, CFG)
    assert torch.equal(got, TM.log_mel_strip(x, CFG))
    assert got.dtype == torch.float32
    assert cuda_melspec_strip.KERNEL.launches == before


def test_wrapper_raises_instead_of_falling_back():
    with pytest.raises(ValueError):
        cuda_melspec_strip.fused_log_mel(torch.empty((1, 128_000), device="meta"), CFG)
    with pytest.raises(ValueError):  # the kernel itself never takes a CPU tensor
        cuda_melspec_strip.KERNEL(torch.zeros((1, 128_000)), CFG)
    for dtype in (torch.float64, torch.int16, torch.bfloat16):
        with pytest.raises(TypeError):
            cuda_melspec_strip.fused_log_mel(torch.zeros((1, 128_000), dtype=dtype), CFG)


@pytest.mark.parametrize("kernel", [cuda_melspec_strip.StripMelKernel,
                                    cuda_melspec.FactoredMelKernel])
def test_kernel_load_raises_without_nvcc(monkeypatch, tmp_path, kernel):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")  # nothing built there
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel().load()


@pytest.mark.parametrize("norm", [None, "slaney"])
def test_sparse_columns_rebuild_the_filterbank(norm):
    """The kernel's mel spans hold every nonzero weight of the rows the
    strip DFT multiplies (the reference's [n_bins, n_mels] filterbank)."""
    cfg = SpectrogramConfig(mel_norm=norm)
    fb = TM.strip_filterbank(TM.config_filterbank(cfg, 32_000))
    assert fb.shape == (768, 128)
    lo, off, w = TM.sparse_columns(fb)
    dense = np.zeros_like(fb)
    for m in range(fb.shape[1]):
        dense[lo[m]:lo[m] + off[m + 1] - off[m], m] = w[off[m]:off[m + 1]]
    np.testing.assert_array_equal(dense, fb)
    assert np.count_nonzero(w) == np.count_nonzero(fb)
