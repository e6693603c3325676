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

from synthetic_audio_detection_tpu_torch.ensemble.multihead import build_ensemble
from synthetic_audio_detection_tpu_torch.infer.pipeline import InferencePipeline
from synthetic_audio_detection_tpu_torch.models.classifier import BinaryClassifier
from synthetic_audio_detection_tpu_torch.models.fast_resnet import FastResNet
from synthetic_audio_detection_tpu_torch.ops import (
    cuda_conv,
    cuda_conv_flat,
    cuda_melspec,
    cuda_melspec_strip,
    cuda_probes,
    melspec,
)
from synthetic_audio_detection_tpu_torch.tools import helper_bisect
from synthetic_audio_detection_tpu_torch.ops.precision import exact_float32
from synthetic_audio_detection_tpu_torch.utils.config import InferenceConfig, SpectrogramConfig

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


K1_MODES = {"z": (True, False), "dB": (False, False), "z-lowp": (True, True),
            "dB-lowp": (False, True)}  # (standardize, lowp_tail)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(K1_MODES))
@pytest.mark.parametrize("pcm", [False, True])
@pytest.mark.parametrize("batch,samples", [(1, 127_700), (5, 127_700), (5, 128_000),
                                           (128, 128_000)])
def test_factored_mel_kernel_at_serving_batches(batch, samples, pcm, mode):
    """The kernel against its plain version on float32 and int16 windows, at
    a window length that is not a multiple of hop (a zero tail after the
    reflect pad) and at the serving batch: 1e-3 on z-scores and 1e-2 dB
    (summation order), and under lowp_tail the bound of two bf16 mel
    products (cuda_melspec.lowp_tail_tolerance)."""
    _cuda_or_skip()
    standardize, lowp_tail = K1_MODES[mode]
    x = _waves(batch, samples, seed=8)
    if pcm:
        x = torch.round(x * 32768).clamp(-32768, 32767).to(torch.int16)
    before = cuda_melspec.KERNEL.launches
    got = cuda_melspec.fused_log_mel_factored(x, CFG, standardize=standardize,
                                              lowp_tail=lowp_tail)
    ref = melspec.log_mel_factored(cuda_melspec.dequantize(x), CFG, standardize=standardize,
                                   dft_dtype=torch.bfloat16, lowp_tail=lowp_tail)
    torch.cuda.synchronize()
    assert cuda_melspec.KERNEL.launches == before + 1
    assert got.shape == ref.shape == (batch, 128, 1 + samples // 512) and got.dtype == ref.dtype
    if lowp_tail:
        db_std = melspec.log_mel_factored(cuda_melspec.dequantize(x), CFG,
                                          standardize=False).std(dim=(1, 2))
        tol = cuda_melspec.lowp_tail_tolerance(ref, db_std if standardize else None)
        assert bool(((got.float() - ref.float()).abs() <= tol).all())
    else:
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-3 if standardize else 1e-2)


@pytest.mark.cuda
def test_factored_mel_kernel_is_deterministic_in_every_mode():
    _cuda_or_skip()
    x = _waves(128, 128_000, seed=9)
    for standardize, lowp_tail in K1_MODES.values():
        a = cuda_melspec.fused_log_mel_factored(x, CFG, standardize=standardize,
                                                lowp_tail=lowp_tail)
        assert torch.equal(a, cuda_melspec.fused_log_mel_factored(
            x, CFG, standardize=standardize, lowp_tail=lowp_tail))


@pytest.mark.cuda
def test_factored_mel_kernel_mirrors_bin_minus_one(monkeypatch):
    """A mel that weighs bin 0 (none of the triangular filterbanks does)
    starts its band at f0 = −3: the cos|sin box begins 6 rows before the
    table, which the TMA fills with zeros, and bin −1 is conj(bin 1)."""
    _cuda_or_skip()
    config_filterbank = melspec.config_filterbank

    def with_bin_0(cfg, sample_rate):
        fb = config_filterbank(cfg, sample_rate).copy()
        fb[0, 0] = fb[1:, 0].max()
        return fb

    monkeypatch.setattr(melspec, "config_filterbank", with_bin_0)
    kernel = cuda_melspec.FactoredMelKernel()  # tables of this filterbank, not the cached ones
    assert int(kernel.constants(CFG, 32_000, torch.device("cuda"))["f0"][0]) == -3
    x = _waves(3, 32_000, seed=11)
    got = kernel(x, CFG)
    ref = melspec.log_mel_factored(x, CFG, dft_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_factored_mel_kernel_scratch_is_mel_sized():
    """At [128, 128000] one call allocates, beyond its input and output,
    the bf16 hop blocks (33.3 MB) and the float32 mel plane (16.4 MB): no
    float32 [B·nb, 2·bins] scratch (216 MB in the kernel's first design)."""
    _cuda_or_skip()
    x = _waves(128, 128_000, seed=10)
    cuda_melspec.fused_log_mel_factored(x, CFG)  # build, constants
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = cuda_melspec.fused_log_mel_factored(x, CFG)
    torch.cuda.synchronize()
    scratch = torch.cuda.max_memory_allocated() - base - out.numel() * out.element_size()
    assert scratch < 100e6, scratch


@pytest.mark.cuda
def test_factored_mel_kernel_raises_instead_of_falling_back():
    _cuda_or_skip()
    with pytest.raises(TypeError):
        cuda_melspec.fused_log_mel_factored(_waves(1, 32_000).double(), CFG)
    with pytest.raises(ValueError, match="32,768 cells"):
        cuda_melspec.fused_log_mel_factored(_waves(1, 32_000 * 9), CFG)  # 563 frames
    with pytest.raises(ValueError, match="n_fft == 4"):
        cuda_melspec.fused_log_mel_factored(_waves(1, 32_000),
                                            SpectrogramConfig(mel_norm="slaney", hop_length=256))


@pytest.mark.cuda
@pytest.mark.parametrize("name,size", [("BAND_BINS", 136), ("TILE_ROWS", 64)])
def test_factored_mel_kernel_refuses_a_plan_for_other_sizes(monkeypatch, name, size):
    """The host plans bands and tiles with its own sizes and passes them to
    the kernel, which refuses any but its compile-time ones."""
    _cuda_or_skip()
    monkeypatch.setattr(cuda_melspec, name, size)
    kernel = cuda_melspec.FactoredMelKernel()  # tables of these sizes, not the cached ones
    with pytest.raises(RuntimeError, match="melspec_factored launch failed"):
        kernel(_waves(1, 32_000), CFG)
    assert kernel.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("batch,samples", [(2, 32_000), (3, 128_000), (128, 128_000),
                                           (3, 127_700), (2, 1_100)])
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
@pytest.mark.parametrize("norm", [None, "slaney"])
def test_strip_mel_kernel_at_a_band_edge(norm):
    """96 mels: each band's first mel starts at its first bin and mels end
    at local bin 127, the band's last column pair (the band plan's edges,
    tests/test_torch_melspec_strip_tiled.py)."""
    _cuda_or_skip()
    cfg = SpectrogramConfig(mel_norm=norm, n_mels=96)
    x = _waves(3, 128_000, seed=12)
    got = cuda_melspec_strip.fused_log_mel(x, cfg)
    ref = melspec.log_mel_strip(x, cfg)
    torch.cuda.synchronize()
    assert got.shape == (3, 96, 251)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_strip_mel_kernel_is_deterministic_and_raises():
    """The same bits on a second run (each mel cell is written once, with
    no atomics); refusals in the wrapper."""
    _cuda_or_skip()
    x = _waves(8, 128_000)
    a = cuda_melspec_strip.fused_log_mel(x, CFG)
    assert torch.equal(a, cuda_melspec_strip.fused_log_mel(x, CFG))
    with pytest.raises(TypeError):
        cuda_melspec_strip.fused_log_mel(x.to(torch.float16), CFG)
    with pytest.raises(ValueError, match="32,768 cells"):
        cuda_melspec_strip.fused_log_mel(_waves(1, 32_000 * 9), CFG)  # 563 frames
    with pytest.raises(ValueError, match="a multiple of 64"):  # hop 96 divides n_fft 384
        cuda_melspec_strip.fused_log_mel(
            x, SpectrogramConfig(mel_norm="slaney", n_fft=384, hop_length=96))


@pytest.mark.cuda
def test_strip_mel_kernel_scratch_is_strips_and_mel_plane():
    """At [128, 128000] one call allocates, beyond its input and output,
    the four bf16 strips (133.2 MB), the float32 mel plane (16.4 MB) and
    under 4 MB besides (1 MiB on an H100 with torch 2.11): no float32 [B,
    n_bins, n_frames] power scratch (98.7 MB in the kernel's first design)
    and no float32 padded copy of the waveforms (66.6 MB)."""
    _cuda_or_skip()
    x = _waves(128, 128_000, seed=10)
    cuda_melspec_strip.fused_log_mel(x, CFG)  # build, constants
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = cuda_melspec_strip.fused_log_mel(x, CFG)
    torch.cuda.synchronize()
    scratch = torch.cuda.max_memory_allocated() - base - out.numel() * out.element_size()
    strips = 4 * 128 * 254 * 512 * 2
    mel = out.numel() * 4
    assert strips + mel <= scratch < strips + mel + 4e6, scratch


@pytest.mark.cuda
@pytest.mark.parametrize("name,size", [("BAND_BINS", 136), ("TILE_ROWS", 64)])
def test_strip_mel_kernel_refuses_a_plan_for_other_sizes(monkeypatch, name, size):
    """The host plans bands and tiles with its own sizes and passes them to
    the kernel, which refuses any but its compile-time ones."""
    _cuda_or_skip()
    monkeypatch.setattr(cuda_melspec_strip, name, size)
    kernel = cuda_melspec_strip.StripMelKernel()  # tables of these sizes, not the cached ones
    with pytest.raises(RuntimeError, match="melspec_strip launch failed"):
        kernel(_waves(1, 32_000), CFG)
    assert kernel.launches == 0


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


def _seeded_ensemble(seed=0, heads=2):
    """A shared-backbone ResNet-18 ensemble from seeded torch inits, with
    BN statistics perturbed from the seed (so eval BN is not an identity)."""
    g = torch.Generator().manual_seed(seed)
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        models = [BinaryClassifier("resnet18") for _ in range(heads)]
    with torch.no_grad():
        for m in models[0].modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=g))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=g))
    base = {k: v for k, v in models[0].state_dict().items() if k.startswith("base.")}
    sds = [{**base, **{k: v for k, v in m.state_dict().items() if k.startswith("head.")}}
           for m in models]
    names = [f"Syn{i}" for i in range(heads)] + ["Real"]
    return build_ensemble(sds, names)


@pytest.mark.cuda
def test_fast_backbone_routes_agree_on_the_card():
    """Full-depth ResNet-18 at 64², bf16: the kernel route (knob 512, 19
    launches: sixteen 3x3 convs and three downsamples) against the knob-0
    route (every conv the plain composition). The same function; only the
    float32 summation order inside each conv differs, so the bounds are the
    CPU tests' against the reference (tests/test_torch_conv.py)."""
    _cuda_or_skip()
    net = _seeded_ensemble().backbones[0].cuda()
    x = torch.from_numpy((np.random.default_rng(11).standard_normal((2, 3, 64, 64)) * 0.4)
                         .astype(np.float32)).cuda()
    before = cuda_conv.KERNEL.launches
    got = FastResNet(net, torch.bfloat16, 512)(x)
    torch.cuda.synchronize()
    assert cuda_conv.KERNEL.launches == before + 19
    ref = FastResNet(net, torch.bfloat16, 0)(x)
    torch.cuda.synchronize()
    assert cuda_conv.KERNEL.launches == before + 19
    got, ref = got.float(), ref.float()
    d = (got - ref).abs()
    assert float(d.mean() / ref.abs().mean()) < 2e-3
    assert float((d <= 2.0 ** -5 * ref.abs() + 1e-3).float().mean()) >= 0.998
    assert float(torch.corrcoef(torch.stack([got.ravel(), ref.ravel()]))[0, 1]) > 0.99999


@pytest.mark.cuda
@pytest.mark.parametrize("bf16_first", [True, False])
def test_float32_view_of_a_bf16_pipeline_is_float32(bf16_first):
    """per_head_sigmoids(serving_numerics=False) on a bf16 pipeline equals a
    float32 pipeline's per-head sigmoids (1e-5: the same float32 operations,
    TF32 off for both), whichever pipeline was built first, and neither
    changes the process's TF32 flags."""
    _cuda_or_skip()
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ens = _seeded_ensemble(seed=3)
        spec = SpectrogramConfig.inference(out_size=64)
        kw = dict(spec=spec, infer=InferenceConfig(batch_size=8), device="cuda")
        order = (torch.bfloat16, torch.float32) if bf16_first else (torch.float32, torch.bfloat16)
        pipes = {dtype: InferencePipeline(ens, compute_dtype=dtype, **kw) for dtype in order}
        w = (np.random.default_rng(4).standard_normal((3, 128_000)) * 0.2).astype(np.float32)
        view = pipes[torch.bfloat16].per_head_sigmoids(w, serving_numerics=False)
        f32 = pipes[torch.float32].per_head_sigmoids(w)
        np.testing.assert_allclose(view, f32, rtol=0, atol=1e-5)
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (
            True, True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


PROBES = {"P1": (cuda_probes.dyn_slice_dot, cuda_probes.dyn_slice_dot_plain, (64, 64)),
          "P2": (cuda_probes.lane_concat_dot, cuda_probes.lane_concat_dot_plain, (64, 64)),
          "P3": (cuda_probes.nine_tap_dot, cuda_probes.nine_tap_dot_plain, (9, 64, 64))}


@pytest.mark.cuda
@pytest.mark.parametrize("probe", sorted(PROBES))
def test_probe_kernel_matches_plain_version(probe):
    """At the Pallas shapes, one launch per call, within one bf16 ulp of
    the plain version (the same exact products summed in another order),
    and the same bits twice."""
    _cuda_or_skip()
    entry, plain, w_shape = PROBES[probe]
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal(cuda_probes.X_SHAPE).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal(w_shape) / 8).astype(np.float32))
    x, w = x.to(torch.bfloat16).cuda(), w.to(torch.bfloat16).cuda()
    before = cuda_probes.KERNEL.launches
    got = entry(x, w)
    torch.cuda.synchronize()
    assert cuda_probes.KERNEL.launches == before + 1
    ref = plain(x, w)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    torch.testing.assert_close(got.float(), ref.float(), rtol=2.0 ** -7, atol=1e-5)
    assert torch.equal(got, entry(x, w))


@pytest.mark.cuda
@pytest.mark.parametrize("probe", sorted(PROBES))
def test_probe_kernel_on_a_triangular_weight(probe):
    """A strictly upper-triangular W (W[k, n] = 0 for n ≤ k) is far from its
    transpose, so a B operand read transposed fails here; the ones inputs of
    helper_bisect cannot show it. One bf16 ulp of the plain version, and the
    same bits on a second run."""
    _cuda_or_skip()
    entry, plain, w_shape = PROBES[probe]
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal(cuda_probes.X_SHAPE).astype(np.float32))
    w = torch.triu(torch.from_numpy((rng.standard_normal(w_shape) / 8).astype(np.float32)), 1)
    x, w = x.to(torch.bfloat16).cuda(), w.to(torch.bfloat16).contiguous().cuda()
    got = entry(x, w)
    ref = plain(x, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), rtol=2.0 ** -7, atol=1e-5)
    assert torch.equal(got, entry(x, w))
    # the transposed weight gives another function: the check can fail
    assert (plain(x, w.transpose(-1, -2).contiguous()).float() - ref.float()).abs().max() > 1


@pytest.mark.cuda
@pytest.mark.parametrize("tile_rows", [32, 128])
def test_probe_kernel_refuses_a_tile_size_other_than_its_own(monkeypatch, tile_rows):
    """The host plans 64-row tiles and passes their size; the kernel refuses
    any other, and nothing is counted."""
    _cuda_or_skip()
    monkeypatch.setattr(cuda_probes, "TILE_ROWS", tile_rows)
    x = torch.zeros(cuda_probes.X_SHAPE, dtype=torch.bfloat16, device="cuda")
    w9 = torch.zeros(9, 64, 64, dtype=torch.bfloat16, device="cuda")
    before = cuda_probes.KERNEL.launches
    with pytest.raises(RuntimeError, match="helper_probes launch failed"):
        cuda_probes.nine_tap_dot(x, w9)
    assert cuda_probes.KERNEL.launches == before


@pytest.mark.cuda
def test_helper_bisect_on_the_card(capsys):
    """The three exact sums, one kernel launch per probe."""
    _cuda_or_skip()
    before = cuda_probes.KERNEL.launches
    assert helper_bisect.main([]) == 0
    assert cuda_probes.KERNEL.launches == before + 3
    assert capsys.readouterr().out.splitlines() == [
        "F1 dyn-dslice : OK 14680064.0",
        "F2 lane-concat : OK 4194304.0",
        "F3 9-tap-static : OK 18874368.0",
    ]


@pytest.mark.cuda
def test_probe_kernel_raises_instead_of_falling_back():
    _cuda_or_skip()
    n = int(np.prod(cuda_probes.X_SHAPE))
    x = torch.zeros(n + 1, dtype=torch.bfloat16, device="cuda")[1:].view(cuda_probes.X_SHAPE)
    w = torch.zeros(64, 64, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="16-byte"):
        cuda_probes.dyn_slice_dot(x, w)
    with pytest.raises(ValueError, match="w on"):
        cuda_probes.dyn_slice_dot(x.contiguous(), w.cpu())


# ---------------------------------------------------------------------------
# The training path
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("pcm", [False, True])
@pytest.mark.parametrize("standardize", [False, True])
def test_factored_mel_kernel_under_the_training_config(standardize, pcm):
    """K1 with SpectrogramConfig.train() (mel_norm None) at the trainer's 32
    rows, float32 or int16, dB only with 8 zero tail rows (a padded last
    batch) or standardized: 1e-2 dB, 1e-3 on z-scores, one launch."""
    _cuda_or_skip()
    cfg = SpectrogramConfig.train()
    x = _waves(32, 128_000, seed=3)
    if not standardize:
        x[24:] = 0.0
    if pcm:
        x = torch.round(x * 32768).clamp(-32768, 32767).to(torch.int16)
    before = cuda_melspec.KERNEL.launches
    got = cuda_melspec.fused_log_mel_factored(x, cfg, standardize=standardize)
    ref = melspec.log_mel_factored(cuda_melspec.dequantize(x), cfg, standardize=standardize,
                                   dft_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert cuda_melspec.KERNEL.launches == before + 1
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-3 if standardize else 1e-2)


def _train_batch(rows, samples, device, seed=9):
    audio = (np.random.default_rng(seed).standard_normal((rows, samples)) * 0.2).astype(np.float32)
    audio[-1] *= 1e-3
    return {"audio": torch.from_numpy(audio).to(device),
            "label": torch.tensor([0, 1] * (rows // 2), device=device),
            "weight": torch.tensor([1.0] * (rows - 1) + [0.0], device=device)}


@pytest.mark.cuda
def test_float32_train_step_on_the_card_matches_the_cpu():
    """One float32 step (128², 4 rows, dropout off) from the same weights:
    BN statistics within 1e-4 relative + 1e-5, parameters within 1e-5
    relative + 1e-6 where the AdamW step is well conditioned and within one
    step's bound (2·lr) elsewhere; TF32 stays off only inside the step."""
    _cuda_or_skip()
    import copy

    from synthetic_audio_detection_tpu_torch.train import steps
    from synthetic_audio_detection_tpu_torch.utils.config import SpecAugmentConfig, TrainConfig

    cfg = TrainConfig(batch_size=2)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        model = BinaryClassifier()
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    step = steps.make_train_step(cfg, SpectrogramConfig(mel_norm=None, out_size=128),
                                 SpecAugmentConfig(enabled=False), stop_grad_stage=4)
    tf32 = torch.backends.cudnn.allow_tf32
    states = []
    for dev in ("cpu", "cuda"):
        st = steps.create_train_state(copy.deepcopy(model).to(dev), cfg)
        step(st, _train_batch(4, 128_000, dev), None)
        states.append(st)
    assert torch.backends.cudnn.allow_tf32 == tf32
    mu, _ = states[0].moments()
    a, b = (s.model.state_dict() for s in states)
    for k, ref in a.items():
        if k.endswith("num_batches_tracked"):
            continue
        d = (b[k].cpu() - ref).abs()
        if "running" in k:
            assert bool((d <= 1e-4 * ref.abs() + 1e-5).all()), k
            continue
        well = mu[k].abs() / 0.1 > 1e-6
        assert bool((d <= 1e-5 * ref.abs() + 1e-6)[well].all()), k
        assert float(d.max()) <= 2 * cfg.lr + 1e-6, k


@pytest.mark.cuda
def test_bf16_trainer_steps_launch_the_kernel(tmp_path):
    """On the card --bf16 selects K1 and the int16 transport: one K1 launch
    per train step and none per eval step (its mel is the float32 GEMM
    mel, as the reference's), finite loss, the moments move."""
    _cuda_or_skip()
    from synthetic_audio_detection_tpu_torch.train.trainer import Trainer
    from synthetic_audio_detection_tpu_torch.utils.config import TrainConfig

    tr = Trainer(TrainConfig(batch_size=2, compute_dtype="bfloat16", class1="SynA"),
                 spec_cfg=SpectrogramConfig(mel_norm=None, out_size=128),
                 log_dir=str(tmp_path / "runs"), device="cuda")
    assert tr._dft == "pallas" and tr._transport == "int16"
    batch = _train_batch(4, 128_000, "cuda")
    batch["audio"] = torch.round(batch["audio"] * 32768).to(torch.int16)
    before = cuda_melspec.KERNEL.launches
    m = tr._train_step(tr.state, batch, tr.generator)
    torch.cuda.synchronize()
    assert cuda_melspec.KERNEL.launches == before + 1
    stats = tr._eval_step(tr.model, batch)
    torch.cuda.synchronize()
    assert cuda_melspec.KERNEL.launches == before + 1
    assert bool(torch.isfinite(m["loss"])) and float(m["skipped"]) == 0.0
    assert int(tr.state.count) == 1 and max(float(t.abs().max()) for t in tr.state.mu) > 0
    assert float(stats["count"]) == 3.0


@pytest.mark.cuda
def test_trunk_shared_ensemble_on_the_card_matches_the_cpu():
    """A trunk-shared ensemble (K = 1) in float32 on the card against the
    CPU, 1e-3 on logits, one trunk pass."""
    _cuda_or_skip()
    sds = []
    for seed in range(3):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            sds.append(BinaryClassifier().state_dict())
    sds = [{k: (sds[0][k] if k.startswith("base.") and not k.startswith("base.layer4") else v)
            for k, v in sd.items()} for sd in sds]
    cpu = build_ensemble(sds, ["SynA", "SynB", "SynC", "Real"])
    assert cpu.shared_trunk_stages == 1
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 3, 128, 128))
                         .astype(np.float32))
    want = cpu(x)
    gpu = build_ensemble(sds, ["SynA", "SynB", "SynC", "Real"]).cuda()
    passes = []
    gpu.trunk.register_forward_hook(lambda *_: passes.append(1))
    with exact_float32():
        got = gpu(x.cuda()).cpu()
    assert len(passes) == 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("per_head_stages", [0, 1])
def test_bf16_joint_trainer_steps_launch_the_kernel(tmp_path, per_head_stages):
    """The joint trainer under --bf16 on the card: int16 transport, K1 once
    per train step and once per eval step (the eval step takes the train
    step's mel, on dequantized float32 audio), finite loss, every head's
    moments move."""
    _cuda_or_skip()
    from synthetic_audio_detection_tpu_torch.train.joint import JointTrainer
    from synthetic_audio_detection_tpu_torch.utils.config import TrainConfig

    tr = JointTrainer(TrainConfig(batch_size=2, compute_dtype="bfloat16"), ["SynA", "SynB"],
                      spec_cfg=SpectrogramConfig(mel_norm=None, out_size=128),
                      log_dir=str(tmp_path / "runs"), per_head_stages=per_head_stages,
                      generic_head=True, device="cuda")
    assert tr._dft == "pallas" and tr._transport == "int16"
    batch = _train_batch(4, 128_000, "cuda")
    batch["audio"] = torch.round(batch["audio"] * 32768).to(torch.int16)
    before = cuda_melspec.KERNEL.launches
    m = tr._train_step(tr.state, batch, tr.generator)
    torch.cuda.synchronize()
    assert cuda_melspec.KERNEL.launches == before + 1
    stats = tr._eval_step(tr.model, batch)
    torch.cuda.synchronize()
    assert cuda_melspec.KERNEL.launches == before + 2
    assert bool(torch.isfinite(m["loss"])) and float(m["skipped"]) == 0.0
    mu, _ = tr.state.moments()
    assert all(float(mu[n].abs().max()) > 0 for n in mu if n.startswith("heads.")
               and n.endswith("10.weight"))
    assert float(stats["count"]) == 3.0 and stats["confusion"].shape == (3, 2, 2)


@pytest.mark.cuda
def test_bf16_head_adder_steps_launch_the_kernel():
    """HeadAdder under --bf16 on the card: K1 once per train step and once
    per eval step; the frozen trunk is unchanged."""
    _cuda_or_skip()
    from synthetic_audio_detection_tpu_torch.train.add_head import HeadAdder
    from synthetic_audio_detection_tpu_torch.utils.config import TrainConfig

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        sd = BinaryClassifier().state_dict()
    ens = build_ensemble([sd, sd], ["SynA", "SynB", "Real"])
    adder = HeadAdder(ens, "SynC", TrainConfig(batch_size=2, compute_dtype="bfloat16"),
                      spec_cfg=SpectrogramConfig(mel_norm=None, out_size=128), device="cuda")
    trunk = {k: v.clone() for k, v in adder.trunk.state_dict().items()}
    batch = _train_batch(4, 128_000, "cuda")
    before = cuda_melspec.KERNEL.launches
    m = adder._step(adder.state, adder.trunk, batch, adder.generator)
    torch.cuda.synchronize()
    assert cuda_melspec.KERNEL.launches == before + 1
    out = adder._eval(adder.state.model, adder.trunk, batch)
    torch.cuda.synchronize()
    assert cuda_melspec.KERNEL.launches == before + 2
    assert bool(torch.isfinite(m["loss"])) and float(out["count"]) == 3.0
    assert all(torch.equal(v, trunk[k]) for k, v in adder.trunk.state_dict().items())


# ---------------------------------------------------------------------------
# The serving daemon
# ---------------------------------------------------------------------------

def _daemon_state(batch_size):
    """A warm ServingState on a bf16 shared-backbone ensemble (3 heads,
    64², the last layers scaled up so that verdicts are not ties)."""
    from synthetic_audio_detection_tpu_torch.infer.server import ServingState

    sds = []
    for seed in range(3):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            sds.append(BinaryClassifier().state_dict())
    sds = [{**{k: v for k, v in sds[0].items() if k.startswith("base.")},
            **{k: (v * 30.0 if k == "head.10.weight" else v) for k, v in sd.items()
               if k.startswith("head.")}} for sd in sds]
    pipe = InferencePipeline(build_ensemble(sds, ["SynA", "SynB", "SynC", "Real"]),
                             spec=SpectrogramConfig.inference(out_size=64),
                             infer=InferenceConfig(batch_size=batch_size),
                             compute_dtype=torch.bfloat16, device="cuda")
    assert pipe.use_kernel and pipe.use_fast_backbone
    state = ServingState(pipe)
    state.warmup()
    return state


@pytest.mark.cuda
def test_daemon_dispatch_launches_the_kernels_once_per_bucket_batch():
    """A bf16 dispatch from the micro-batcher's thread: K1 once and the
    conv kernel 19 times per bucket batch (11 windows in the 8 bucket: 2
    batches; 3 windows: 1)."""
    _cuda_or_skip()
    state = _daemon_state(batch_size=8)
    try:
        for n, batches in ((11, 2), (3, 1)):
            k1, conv = cuda_melspec.KERNEL.launches, cuda_conv.KERNEL.launches
            logits = state.batcher.logits(_waves(n, 128_000, seed=n).cpu().numpy())
            assert logits.shape == (n, 4) and np.isfinite(logits).all()
            assert cuda_melspec.KERNEL.launches - k1 == batches
            assert cuda_conv.KERNEL.launches - conv == 19 * batches
    finally:
        state.close()


@pytest.mark.cuda
def test_daemon_coalesced_verdicts_equal_lone_ones():
    """Six two-window requests queued behind the device lock coalesce into
    the 16 bucket; alone each runs in the 8 bucket. cuDNN may choose
    another algorithm for the float32 stem at another batch size, so a
    bf16 rounding can flip: logits within 0.3 (chip_smoke's TOL_ROUTE) and
    the verdicts equal on every window whose lone sigmoids all lie more
    than 0.05 from the threshold."""
    _cuda_or_skip()
    import threading
    import time

    state = _daemon_state(batch_size=16)
    try:
        reqs = [_waves(2, 128_000, seed=20 + i).cpu().numpy() for i in range(6)]
        lone = [state.batcher.logits(w) for w in reqs]
        before = state.batcher.dispatch_count
        together = [None] * len(reqs)

        def run(i):
            together[i] = state.batcher.logits(reqs[i])

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(reqs))]
        with state.lock:
            for t in threads:
                t.start()
            time.sleep(1.0)
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert state.batcher.dispatch_count - before < len(reqs)
        pipe = state.pipeline
        for a, b, w in zip(lone, together, reqs):
            assert float(np.abs(a - b).max()) <= 0.3
            stamps = [(0.0, 4.0), (4.0, 8.0)]
            la = [s["label"] for s in pipe.analyze_windows(w, stamps, logits=a)["segments"]]
            lb = [s["label"] for s in pipe.analyze_windows(w, stamps, logits=b)["segments"]]
            clear = np.all(np.abs(1 / (1 + np.exp(-a)) - 0.5) > 0.05, axis=1)
            assert [x for x, c in zip(la, clear) if c] == [x for x, c in zip(lb, clear) if c]
    finally:
        state.close()


# ---------------------------------------------------------------------------
# The release path
# ---------------------------------------------------------------------------

def _release_ensemble():
    """The daemon tests' bf16-ready shared-backbone ensemble (3 heads)."""
    sds = []
    for seed in range(3):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            sds.append(BinaryClassifier().state_dict())
    sds = [{**{k: v for k, v in sds[0].items() if k.startswith("base.")},
            **{k: (v * 30.0 if k == "head.10.weight" else v) for k, v in sd.items()
               if k.startswith("head.")}} for sd in sds]
    return build_ensemble(sds, ["SynA", "SynB", "SynC", "Real"],
                          calibration={"temperatures": [1.1, 0.9, 1.2, 0.8]})


def _hand_launches():
    return sum(m.KERNEL.launches for m in (cuda_melspec, cuda_melspec_strip, cuda_conv,
                                           cuda_probes))


@pytest.mark.cuda
def test_release_export_on_the_card_reloads():
    """A bf16 artifact exported on the card (entries 8 and 16, traced at
    8) reloads there, is refused on the CPU, and serves through
    from_artifact at both entries with the header's calibration."""
    _cuda_or_skip()
    from synthetic_audio_detection_tpu_torch.infer import export

    data = export.export_serving(_release_ensemble(), spec=SpectrogramConfig.inference(
        out_size=64), batch_sizes=(8, 16), device="cuda")
    meta, _ = export.read_header(data)
    assert meta["platforms"] == ["cuda"] and meta["compute_dtype"] == "bfloat16"
    with pytest.raises(ValueError, match="exported for cuda"):
        export.load_artifact(data, device="cpu")
    pipe = InferencePipeline.from_artifact(data, device="cuda")
    assert pipe._bucket_sizes == [8, 16] and pipe._cal is not None
    for n in (3, 11):
        logits = pipe.logits_for_windows(_waves(n, 128_000, seed=n).cpu().numpy())
        assert logits.shape == (n, 4) and np.isfinite(logits).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_release_artifact_matches_the_matched_live_forward(dtype):
    """The artifact against forward_windows with the exported flags (the
    float32 GEMM mel, the plain ResNet) on the same int16 batch: the same
    operators on the same operands, so the same bits (tools/artifact_drive.py
    holds it so); and no hand-written kernel launches while it serves."""
    _cuda_or_skip()
    from synthetic_audio_detection_tpu_torch.ensemble.multihead import with_dtype
    from synthetic_audio_detection_tpu_torch.infer import export
    from synthetic_audio_detection_tpu_torch.infer.pipeline import forward_windows

    spec = SpectrogramConfig.inference(out_size=64)
    ens = _release_ensemble()
    program, _ = export.load_artifact(export.export_serving(
        ens, spec=spec, batch_sizes=(8,), compute_dtype=dtype, device="cuda"), device="cuda")
    w = (_waves(8, 128_000, seed=3).clamp(-1, 1) * 32767).to(torch.int16)
    live = with_dtype(ens, dtype).cuda()
    before = _hand_launches()
    with exact_float32():
        got = program(w).float().cpu().numpy()
    assert _hand_launches() == before
    with exact_float32():
        want = forward_windows(live, w, spec, 32_000).float().cpu().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_release_study_tools_launch_the_kernels_once_per_file(tmp_path):
    """The study harness on a bf16 shared-backbone pipeline: each file's
    windows go to the card alone, so K1 launches once and the conv kernel
    19 times per file (one 8-bucket batch each), and nothing else."""
    _cuda_or_skip()
    from synthetic_audio_detection_tpu_torch.audio import wavio
    from synthetic_audio_detection_tpu_torch.infer.study import collect_logits_tree, evaluate_tree

    rng = np.random.default_rng(0)
    for cls in ("Real", "SynA", "SynB"):
        (tmp_path / cls).mkdir()
        for i in range(2):
            wavio.write_wav(str(tmp_path / cls / f"{i}.wav"),
                            (rng.standard_normal(8 * 32_000) * 0.2).astype(np.float32), 32_000)
    pipe = InferencePipeline(_release_ensemble(), spec=SpectrogramConfig.inference(out_size=64),
                             infer=InferenceConfig(batch_size=128),
                             compute_dtype=torch.bfloat16, device="cuda")
    for fn in (collect_logits_tree, evaluate_tree):
        k1, conv, total = (cuda_melspec.KERNEL.launches, cuda_conv.KERNEL.launches,
                           _hand_launches())
        fn(pipe, str(tmp_path))
        assert cuda_melspec.KERNEL.launches - k1 == 6
        assert cuda_conv.KERNEL.launches - conv == 19 * 6
        assert _hand_launches() - total == 6 + 19 * 6


@pytest.mark.cuda
def test_step_checkpointer_copies_cuda_tensors_before_returning(tmp_path, monkeypatch):
    """save() of CUDA tensors returns with the write held back; in-place
    updates on the card after it (as the trainer's AdamW makes) do not
    reach the step, which holds the values at save time."""
    import threading

    from synthetic_audio_detection_tpu_torch.checkpoints.orbax_io import OrbaxCheckpointer

    _cuda_or_skip()
    release = threading.Event()
    real = OrbaxCheckpointer._write

    def held(self, *args):
        assert release.wait(60)
        real(self, *args)

    monkeypatch.setattr(OrbaxCheckpointer, "_write", held)
    w = torch.randn(256, 256, device="cuda")
    want = w.cpu().numpy().copy()
    ck = OrbaxCheckpointer(str(tmp_path / "ck"))
    ck.save(1, {"w": w, "m": [w * 2]})
    torch._foreach_add_([w], 1.0)
    torch.cuda.synchronize()
    release.set()
    ck.wait()
    tree, _ = ck.restore(1)
    np.testing.assert_array_equal(tree["w"], want)
    np.testing.assert_array_equal(tree["m"][0], want * 2)


# ---------------------------------------------------------------------------
# torch.distributed on one card (an NCCL group of world size 1) and int8
# ---------------------------------------------------------------------------

@pytest.fixture
def nccl_one_rank(tmp_path):
    """An NCCL group of world size 1 through a file store, left at the
    end."""
    _cuda_or_skip()
    import torch.distributed as dist

    from synthetic_audio_detection_tpu_torch.parallel import sharding

    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'init'}", world_size=1,
                            rank=0, device_id=torch.device("cuda", 0))
    try:
        yield sharding.create_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_nccl_world_size_one_train_step_is_bit_equal(nccl_one_rank, tmp_path):
    """The data-parallel Trainer's step in an NCCL group of one rank and
    the plain Trainer's, from one seed, 3 bf16 steps on the same batches:
    parameters, BN statistics, moments and count bit for bit; K1 once a
    step; only all-reduces, the same count each step."""
    from synthetic_audio_detection_tpu_torch.train.trainer import Trainer
    from synthetic_audio_detection_tpu_torch.utils.config import TrainConfig

    mesh = nccl_one_rank
    cfg = TrainConfig(batch_size=4, compute_dtype="bfloat16", class1="SynA")
    spec = SpectrogramConfig(mel_norm=None, out_size=128)
    plain, dp = (Trainer(cfg, spec_cfg=spec, log_dir=str(tmp_path / name), device="cuda",
                         use_mesh=False, mesh=m) for name, m in (("p", None), ("d", mesh)))
    assert plain.mesh is None and dp.mesh is mesh
    batches = []
    for seed in range(3):
        b = _train_batch(8, 128_000, "cuda", seed=seed)
        b["audio"] = torch.round(b["audio"] * 32768).to(torch.int16)
        batches.append(b)
    for b in batches:
        plain._train_step(plain.state, b, plain.generator)
    per_step = []
    before = cuda_melspec.KERNEL.launches
    for b in batches:
        mesh.counts.clear()
        dp._train_step(dp.state, b, dp.generator)
        per_step.append(dict(mesh.counts))
    torch.cuda.synchronize()
    assert cuda_melspec.KERNEL.launches == before + 3
    assert per_step[0] == per_step[1] == per_step[2] and set(per_step[0]) == {"all_reduce"}
    a, b = plain.model.state_dict(), dp.model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert int(plain.state.count) == int(dp.state.count) == 3
    for x, y in zip(plain.state.mu + plain.state.nu, dp.state.mu + dp.state.nu):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_nccl_world_size_one_pipeline_is_bit_equal(nccl_one_rank):
    """InferencePipeline(mesh=...) in an NCCL group of one rank against the
    pipeline without one (bf16, the shared backbone on the conv kernel):
    logits and per-head logits bit for bit, one all-gather a batch."""
    mesh = nccl_one_rank
    sds = []
    for seed in range(2):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            sds.append(BinaryClassifier().state_dict())
    sds = [{**{k: v for k, v in sds[0].items() if k.startswith("base.")},
            **{k: v for k, v in sd.items() if k.startswith("head.")}} for sd in sds]
    ens = build_ensemble(sds, ["SynA", "SynB", "Real"])
    kw = dict(spec=SpectrogramConfig(mel_norm="slaney", out_size=128),
              infer=InferenceConfig(batch_size=16), compute_dtype=torch.bfloat16, device="cuda")
    plain, meshed = InferencePipeline(ens, **kw), InferencePipeline(ens, mesh=mesh, **kw)
    assert meshed.use_fast_backbone and meshed.device == torch.device("cuda", 0)
    windows = (np.random.default_rng(3).standard_normal((21, 32_000)) * 0.3).astype(np.float32)
    mesh.counts.clear()
    got, got_nh = meshed.logits_and_per_head(windows)
    assert mesh.counts == {"all_gather": 2}
    want, want_nh = plain.logits_and_per_head(windows)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_nh, want_nh)


@pytest.mark.cuda
def test_int8_forward_on_the_card_matches_the_cpu():
    """The int8 ensemble on the card (cuBLASLt's int8 products) against the
    CPU's (exact int32 products) on the same weights and 128² input: the
    stem's accumulators bit for bit, the logits within 1e-4 (the heads'
    float32 sums in another order), the same argmax; 20 products a pass."""
    _cuda_or_skip()
    from synthetic_audio_detection_tpu_torch.models import quantized

    sds = []
    for seed in range(3):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            sds.append(BinaryClassifier().state_dict())
    sds = [{**{k: v for k, v in sds[0].items() if k.startswith("base.")},
            **{k: v for k, v in sd.items() if k.startswith("head.")}} for sd in sds]
    ens = build_ensemble(sds, ["SynA", "SynB", "SynC", "Real"])
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((8, 3, 128, 128))
                         .astype(np.float32))
    q_cpu = quantized.quantize_ensemble(ens, device="cpu")
    q_gpu = quantized.quantize_ensemble(ens, device="cuda")
    nhwc = x.permute(0, 2, 3, 1)
    acc_cpu, s_cpu = quantized.qconv_accumulators(nhwc, q_cpu.qbackbone["stem"], 2)
    acc_gpu, s_gpu = quantized.qconv_accumulators(nhwc.cuda(), q_gpu.qbackbone["stem"], 2)
    assert float(s_cpu) == float(s_gpu)
    assert torch.equal(acc_gpu.cpu(), acc_cpu)
    before = quantized.INT_MM.launches
    got = quantized.quantized_ensemble_forward(q_gpu, x.cuda()).cpu().numpy()
    assert quantized.INT_MM.launches == before + 20
    want = quantized.quantized_ensemble_forward(q_cpu, x).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
