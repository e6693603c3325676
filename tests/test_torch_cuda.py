"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Imports neither JAX nor the test suite's conftest, so it also runs where
JAX is absent (the GPU machine):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Each test decides inside itself whether a CUDA device is present and skips
without one.
"""

import numpy as np
import pytest
import torch

from synthetic_audio_detection_tpu_torch.ops import (
    cuda_conv,
    cuda_conv_flat,
    cuda_melspec,
    cuda_melspec_strip,
    melspec,
)
from synthetic_audio_detection_tpu_torch.utils.config import SpectrogramConfig

CFG = SpectrogramConfig(mel_norm="slaney")
# conv kernel vs its plain version: both form every bf16 product exactly in
# float32 and sum in float32 in different orders, so float32 outputs agree
# to summation order and bf16 outputs to one bf16 ulp (relative 2^-7) where
# the two sums straddle a rounding boundary
CONV_TOL = {torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-5),
            torch.float32: dict(rtol=1e-5, atol=1e-5)}


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _waves(batch, samples, seed=5):
    x = np.random.default_rng(seed).standard_normal((batch, samples)) * 0.3
    return torch.from_numpy(x.astype(np.float32)).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("standardize", [True, False])
@pytest.mark.parametrize("batch,samples", [(4, 128_000), (3, 32_000)])
def test_factored_mel_kernel_matches_plain_version(standardize, batch, samples):
    """Same inputs, bf16 DFT operands on both sides: the float32 summation
    order of the DFT and mel products is all that differs (1e-3 on z-scores,
    1e-2 dB)."""
    _cuda_or_skip()
    x = _waves(batch, samples)
    before = cuda_melspec.KERNEL.launches
    got = cuda_melspec.fused_log_mel_factored(x, CFG, standardize=standardize)
    ref = melspec.log_mel_factored(x, CFG, standardize=standardize, dft_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert cuda_melspec.KERNEL.launches == before + 1
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-3 if standardize else 1e-2)


@pytest.mark.cuda
def test_factored_mel_kernel_is_deterministic_and_takes_int16():
    _cuda_or_skip()
    x = _waves(8, 128_000)
    a = cuda_melspec.fused_log_mel_factored(x, CFG)
    assert torch.equal(a, cuda_melspec.fused_log_mel_factored(x, CFG))
    pcm = torch.round(x * 32768).clamp(-32768, 32767).to(torch.int16)
    torch.testing.assert_close(cuda_melspec.fused_log_mel_factored(pcm, CFG),
                               cuda_melspec.fused_log_mel_factored(pcm.float() / 32768.0, CFG),
                               rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("standardize", [True, False])
def test_factored_mel_kernel_lowp_tail_matches_plain_version(standardize):
    """lowp_tail: bf16 out, within one bf16 ulp plus the one-ulp straddle of
    a bf16 power term (cuda_melspec.lowp_tail_tolerance) of the plain
    version."""
    _cuda_or_skip()
    x = _waves(8, 128_000)
    got = cuda_melspec.fused_log_mel_factored(x, CFG, standardize=standardize, lowp_tail=True)
    ref = melspec.log_mel_factored(x, CFG, standardize=standardize, lowp_tail=True)
    db_std = melspec.log_mel_factored(x, CFG, standardize=False).std(dim=(1, 2))
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype == torch.bfloat16 and got.shape == ref.shape
    tol = cuda_melspec.lowp_tail_tolerance(ref, db_std if standardize else None)
    assert bool(((got.float() - ref.float()).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("batch,samples", [(2, 32_000), (3, 128_000), (128, 128_000)])
def test_strip_mel_kernel_matches_plain_version(batch, samples):
    """Same bf16 operands on both sides (the windowed frame rounded once, the
    cos|sin): the float32 summation order of the DFT and mel products is all
    that differs (1e-3 on z-scores)."""
    _cuda_or_skip()
    x = _waves(batch, samples, seed=6)
    before = cuda_melspec_strip.KERNEL.launches
    got = cuda_melspec_strip.fused_log_mel(x, CFG)
    ref = melspec.log_mel_strip(x, CFG)
    torch.cuda.synchronize()
    assert cuda_melspec_strip.KERNEL.launches == before + 1
    assert got.shape == (batch, 128, 1 + samples // 512)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_strip_mel_kernel_is_deterministic_and_raises():
    _cuda_or_skip()
    x = _waves(8, 128_000)
    a = cuda_melspec_strip.fused_log_mel(x, CFG)
    assert torch.equal(a, cuda_melspec_strip.fused_log_mel(x, CFG))
    with pytest.raises(TypeError):
        cuda_melspec_strip.fused_log_mel(x.to(torch.float16), CFG)
    with pytest.raises(RuntimeError, match="melspec_strip launch failed"):
        cuda_melspec_strip.fused_log_mel(_waves(1, 32_000 * 9), CFG)  # 563 frames > 256


def _conv_inputs(B, H, W, C, F, seed=7):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((B, H, W, C)) * 0.5).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((3, 3, C, F)) * 0.1).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, F).astype(np.float32))
    bias = torch.from_numpy((rng.standard_normal(F) * 0.1).astype(np.float32))
    return x.to(torch.bfloat16).cuda(), w.cuda(), scale.cuda(), bias.cuda()


# the reference tests' C=8 shapes, a ragged pixel tile (16·14 = 224 output
# pixels) and a ragged channel tile (F = 16 of the kernel's 64), and
# ResNet-18's layer-1 shape at batch 32
CONV_SHAPES = [(2, 16, 16, 8, 16), (2, 16, 14, 8, 8), (1, 16, 16, 64, 64), (32, 128, 128, 64, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CONV_SHAPES)
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_conv_kernel_matches_plain_version(shape, stride, relu, out_dtype):
    _cuda_or_skip()
    x, w, scale, bias = _conv_inputs(*shape)
    before = cuda_conv.KERNEL.launches
    got = cuda_conv.conv3x3_bn_relu(x, w, scale, bias, stride=stride, relu=relu,
                                    out_dtype=out_dtype)
    ref = cuda_conv.conv3x3_bn_relu_plain(x, w, scale, bias, stride, relu, out_dtype)
    torch.cuda.synchronize()
    assert cuda_conv.KERNEL.launches == before + 1
    B, H, W, _, F = shape
    assert got.shape == (B, H // stride, W // stride, F) and got.dtype == out_dtype
    assert got.is_contiguous()
    torch.testing.assert_close(got, ref, **CONV_TOL[out_dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["tiled", "flat", "flat_static"])
@pytest.mark.parametrize("shape", [(2, 16, 16, 8, 16), (8, 128, 128, 64, 64)])
def test_conv_entries_launch_the_kernel(entry, shape):
    """The stride-1 entries of the other three TPU layouts run the same
    kernel (tiled: tile_h output rows per tile)."""
    _cuda_or_skip()
    x, w, scale, bias = _conv_inputs(*shape, seed=8)
    fn = {"tiled": lambda *a: cuda_conv.conv3x3_bn_relu_tiled(*a, tile_h=8),
          "flat": cuda_conv_flat.conv3x3_bn_relu_flat,
          "flat_static": cuda_conv_flat.conv3x3_bn_relu_flat_static}[entry]
    before = cuda_conv.KERNEL.launches
    got = fn(x, w, scale, bias)
    ref = cuda_conv.conv3x3_bn_relu_plain(x, w, scale, bias)
    torch.cuda.synchronize()
    assert cuda_conv.KERNEL.launches == before + 1
    torch.testing.assert_close(got, ref, **CONV_TOL[torch.bfloat16])


@pytest.mark.cuda
def test_conv_kernel_is_deterministic_and_tile_h_free():
    """Two calls give identical bits, and the row tile changes which block
    computes a pixel but not its sum order."""
    _cuda_or_skip()
    x, w, scale, bias = _conv_inputs(4, 64, 64, 64, 128, seed=9)
    a = cuda_conv.conv3x3_bn_relu(x, w, scale, bias)
    assert torch.equal(a, cuda_conv.conv3x3_bn_relu(x, w, scale, bias))
    for tile_h in (1, 8, 32):
        assert torch.equal(a, cuda_conv.conv3x3_bn_relu_tiled(x, w, scale, bias, tile_h=tile_h))


@pytest.mark.cuda
def test_conv_kernel_raises_instead_of_falling_back():
    _cuda_or_skip()
    x, w, scale, bias = _conv_inputs(1, 8, 8, 8, 8)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_conv.conv3x3_bn_relu(x.transpose(1, 2), w, scale, bias)
    with pytest.raises(ValueError, match="multiples of 8"):
        cuda_conv.conv3x3_bn_relu(x[..., :4].contiguous(), w[:, :, :4], scale, bias)
    with pytest.raises(ValueError, match="w on"):
        cuda_conv.conv3x3_bn_relu(x, w.cpu(), scale, bias)
