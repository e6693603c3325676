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
