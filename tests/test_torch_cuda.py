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


def _conv_inputs(B, H, W, C, F, seed=7, w_std=0.1):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((B, H, W, C)) * 0.5).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((3, 3, C, F)) * w_std).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, F).astype(np.float32))
    bias = torch.from_numpy((rng.standard_normal(F) * 0.1).astype(np.float32))
    return x.to(torch.bfloat16).cuda(), w.cuda(), scale.cuda(), bias.cuda()


# the reference tests' C=8 shapes; ragged tiles that the kernel masks: a
# pixel rectangle past the image (16·14 of 256 pixels; rows 600 or 300 wide
# in rectangles 256 or 128 wide), output channels past F (F = 8, 16 or 24 of a 64-wide N
# tile; F = 72, two tiles) and channels past C (C = 72: a 64-channel chunk
# and an 8-channel one); and ResNet-18's layer-1 shape at batch 32
CONV_SHAPES = [(2, 16, 16, 8, 16), (2, 16, 14, 8, 8), (2, 16, 16, 72, 72), (1, 4, 600, 16, 24),
               (1, 16, 16, 64, 64), (32, 128, 128, 64, 64)]


def _launch(fn):
    """fn()'s output, checking that it launched the kernel once."""
    before = cuda_conv.KERNEL.launches
    out = fn()
    torch.cuda.synchronize()
    assert cuda_conv.KERNEL.launches == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CONV_SHAPES)
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_conv_kernel_matches_plain_version(shape, stride, relu, out_dtype):
    _cuda_or_skip()
    x, w, scale, bias = _conv_inputs(*shape)
    got = _launch(lambda: cuda_conv.conv3x3_bn_relu(x, w, scale, bias, stride=stride, relu=relu,
                                                    out_dtype=out_dtype))
    ref = cuda_conv.conv3x3_bn_relu_plain(x, w, scale, bias, stride, relu, out_dtype)
    B, H, W, _, F = shape
    assert got.shape == (B, H // stride, W // stride, F) and got.dtype == out_dtype
    assert got.is_contiguous()
    torch.testing.assert_close(got, ref, **CONV_TOL[out_dtype])


# every 3x3 conv class of ResNet-18 (C → F, stride) at batch 2-4 and 32², or
# 16² for layer 4, and a width that is no divisor of 128 (48: the kernel's
# 64-wide pixel rectangles are ragged and masked), as (B, H, W, C, F, stride)
RESNET18_SHAPES = [
    (2, 32, 32, 64, 64, 1), (2, 32, 32, 64, 128, 2), (3, 32, 32, 128, 128, 1),
    (2, 32, 32, 128, 256, 2), (2, 32, 32, 256, 256, 1), (2, 32, 32, 256, 512, 2),
    (4, 16, 16, 512, 512, 1), (2, 40, 48, 64, 128, 1), (2, 40, 48, 256, 256, 2),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RESNET18_SHAPES)
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_conv_kernel_matches_plain_version_at_resnet18_shapes(shape, out_dtype):
    """The kernel at every ResNet-18 3x3 conv class, ReLU on and off,
    within one bf16 ulp of the plain version (float32 out: within the
    float32 summation order), and the same bits twice. He-scaled weights
    keep the outputs O(1) at every depth, as in the network. The two
    float32 sums of 9·C exact products differ by rounding in their order,
    which grows like the square root of their length: float32 out is held
    to 1e-5 absolute at ResNet-18's shallowest K = 576 (CONV_TOL) and
    1e-5·√(9·C / 576) at deeper K."""
    _cuda_or_skip()
    B, H, W, C, F, stride = shape
    x, w, scale, bias = _conv_inputs(B, H, W, C, F, seed=10, w_std=(2.0 / (9 * C)) ** 0.5)
    tol = dict(CONV_TOL[out_dtype])
    if out_dtype == torch.float32:
        tol["atol"] = 1e-5 * (9 * C / 576) ** 0.5
    for relu in (True, False):
        def call():
            return cuda_conv.conv3x3_bn_relu(x, w, scale, bias, stride=stride, relu=relu,
                                             out_dtype=out_dtype)

        got = _launch(call)
        assert got.shape == (B, H // stride, W // stride, F) and got.dtype == out_dtype
        ref = cuda_conv.conv3x3_bn_relu_plain(x, w, scale, bias, stride, relu, out_dtype)
        torch.testing.assert_close(got, ref, **tol)
        assert torch.equal(got, call())


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["tiled", "flat", "flat_static"])
@pytest.mark.parametrize("shape", [(2, 16, 16, 8, 16), (8, 128, 128, 64, 64)])
def test_conv_entries_launch_the_kernel(entry, shape):
    """The stride-1 entries of the other three TPU layouts run the same
    kernel."""
    _cuda_or_skip()
    x, w, scale, bias = _conv_inputs(*shape, seed=8)
    fn = {"tiled": lambda *a: cuda_conv.conv3x3_bn_relu_tiled(*a, tile_h=8),
          "flat": cuda_conv_flat.conv3x3_bn_relu_flat,
          "flat_static": cuda_conv_flat.conv3x3_bn_relu_flat_static}[entry]
    got = _launch(lambda: fn(x, w, scale, bias))
    ref = cuda_conv.conv3x3_bn_relu_plain(x, w, scale, bias)
    torch.testing.assert_close(got, ref, **CONV_TOL[torch.bfloat16])


@pytest.mark.cuda
def test_conv_kernel_is_deterministic_and_tile_h_free():
    """Two calls give identical bits, and tile_h, which the kernel checks
    and does not use (it picks its own pixel rectangles), changes no bit:
    at a shape whose tiles divide the output and at one whose tiles are
    ragged in pixels, output channels and input channels."""
    _cuda_or_skip()
    for shape in ((4, 64, 64, 64, 128), (2, 16, 14, 72, 24)):
        x, w, scale, bias = _conv_inputs(*shape, seed=9)
        a = cuda_conv.conv3x3_bn_relu(x, w, scale, bias)
        assert torch.equal(a, cuda_conv.conv3x3_bn_relu(x, w, scale, bias))
        for tile_h in (1, 8, 16):
            assert torch.equal(a, cuda_conv.conv3x3_bn_relu_tiled(x, w, scale, bias,
                                                                   tile_h=tile_h))


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
