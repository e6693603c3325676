"""The port's 3x3 conv + BN + ReLU (ops/cuda_conv.py, ops/cuda_conv_flat.py),
its stem conv + BN + max-pool + ReLU (ops/cuda_stem.py) and the fast
backbone that routes through them, against the JAX package, on the CPU.

On the CPU each entry runs the kernel's plain version. The JAX entries run
their Pallas kernels in interpret mode. Both sides round x and w to bf16,
form every product exactly in float32, sum in float32 (in different orders)
and apply the float32 affine, so the float32 outputs agree to summation
order (rtol 1e-5, atol 1e-5 at these O(1) values) and the bf16 outputs to
one bf16 ulp (rtol 2^-7) where the two float32 sums straddle a rounding
boundary.

Inputs come from numpy with fixed seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic_audio_detection_tpu.checkpoints.torch_compat import (
    classifier_variables_from_torch,
)
from synthetic_audio_detection_tpu.ensemble import multihead as JE
from synthetic_audio_detection_tpu.models import fast_resnet as JF
from synthetic_audio_detection_tpu.models.classifier import BinaryClassifier as JaxClassifier
from synthetic_audio_detection_tpu.ops import pallas_conv, pallas_conv_flat
from synthetic_audio_detection_tpu_torch.checkpoints import from_jax
from synthetic_audio_detection_tpu_torch.ensemble import multihead as TE
from synthetic_audio_detection_tpu_torch.models.classifier import BinaryClassifier
from synthetic_audio_detection_tpu_torch.models.fast_resnet import (
    FastResNet,
    KernelConv,
    PlainConv,
    kernel_conv_bn,
    plain_conv_bn,
)
from synthetic_audio_detection_tpu_torch.models.resnet import create_resnet
from synthetic_audio_detection_tpu_torch.ops import build, cuda_conv, cuda_conv_flat, cuda_stem

BF16_ULP = 2.0 ** -7  # relative spacing of bf16 at the bottom of a binade
NAMES = ["SynA", "SynB", "Real"]


def _inputs(shape, seed):
    B, H, W, C, F = shape
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, H, W, C)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, F)) * 0.1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, F).astype(np.float32)
    bias = (rng.standard_normal(F) * 0.1).astype(np.float32)
    return x, w, scale, bias


def _port_args(x, w, scale, bias):
    return (torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w),
            torch.from_numpy(scale), torch.from_numpy(bias))


def _close(got, ref, out_dtype):
    got = got.float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert got.shape == ref.shape
    if out_dtype == torch.float32:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, ref, rtol=BF16_ULP, atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 16, 16, 8, 16), (1, 16, 16, 64, 64)])
@pytest.mark.parametrize("stride,relu", [(1, True), (1, False), (2, True), (2, False)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_conv3x3_bn_relu_matches_pallas(shape, stride, relu, out_dtype):
    x, w, scale, bias = _inputs(shape, seed=1)
    jdt = jnp.float32 if out_dtype == torch.float32 else jnp.bfloat16
    ref = pallas_conv.conv3x3_bn_relu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
                                      jnp.asarray(bias), stride, relu, interpret=True,
                                      out_dtype=jdt)
    got = cuda_conv.conv3x3_bn_relu(*_port_args(x, w, scale, bias), stride=stride, relu=relu,
                                    out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.is_contiguous()
    _close(got, ref, out_dtype)


@pytest.mark.parametrize("shape,tile_h", [((2, 16, 16, 8, 16), 8), ((1, 32, 32, 64, 64), 16)])
@pytest.mark.parametrize("relu", [True, False])
def test_conv3x3_bn_relu_tiled_matches_pallas(shape, tile_h, relu):
    x, w, scale, bias = _inputs(shape, seed=2)
    ref = pallas_conv.conv3x3_bn_relu_tiled(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
                                            jnp.asarray(bias), relu, tile_h=tile_h,
                                            interpret=True)
    got = cuda_conv.conv3x3_bn_relu_tiled(*_port_args(x, w, scale, bias), relu=relu,
                                          tile_h=tile_h)
    _close(got, ref, torch.bfloat16)


@pytest.mark.parametrize("shape", [(2, 16, 14, 8, 8), (1, 32, 32, 64, 64)])
@pytest.mark.parametrize("variant", ["flat", "flat_static"])
def test_conv3x3_bn_relu_flat_matches_pallas(shape, variant):
    x, w, scale, bias = _inputs(shape, seed=3)
    ref = getattr(pallas_conv_flat, f"conv3x3_bn_relu_{variant}")(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), jnp.asarray(bias), interpret=True)
    got = getattr(cuda_conv_flat, f"conv3x3_bn_relu_{variant}")(*_port_args(x, w, scale, bias))
    _close(got, ref, torch.bfloat16)


def test_conv3x3_defaults_are_identity_affine():
    """scale and bias default to ones and zeros, as in the reference."""
    x, w, _, _ = _inputs((1, 8, 8, 8, 8), seed=4)
    xt, wt = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w)
    ones, zeros = torch.ones(8), torch.zeros(8)
    assert torch.equal(cuda_conv.conv3x3_bn_relu(xt, wt),
                       cuda_conv.conv3x3_bn_relu(xt, wt, ones, zeros))


# the seven 3x3 conv shapes of ResNet-18 at 512² input as (F, output side,
# stride), and narrower shapes of the contract as (F, Ho, Wo, stride)
RESNET18_CONVS = [(64, 128, 1), (128, 64, 2), (128, 64, 1), (256, 32, 2), (256, 32, 1),
                  (512, 16, 2), (512, 16, 1)]
NARROW_CONVS = [(16, 16, 16, 1), (8, 16, 14, 1), (8, 8, 7, 2), (72, 16, 16, 1),
                (128, 4, 300, 1), (64, 1, 1, 2)]


def _plan(F, Ho, Wo, stride):
    """tile_plan's tiles, checked against what the kernel accepts."""
    bn, th, tw = cuda_conv.tile_plan(F, Ho, Wo, stride)
    assert bn in (64, 128, 256) and th * tw == (128 if bn == 256 else 256)
    assert tw & (tw - 1) == 0 and th * stride <= 256 and tw * stride <= 256  # one TMA box
    return bn, th, tw


@pytest.mark.parametrize("F,side,stride", RESNET18_CONVS)
def test_tile_plan_tiles_resnet18_convs_exactly(F, side, stride):
    """At ResNet-18's shapes the tiles divide the output: no pixel or output
    channel is computed only to be masked."""
    bn, th, tw = _plan(F, side, side, stride)
    assert F % bn == 0 and side % th == 0 and side % tw == 0


@pytest.mark.parametrize("F,Ho,Wo,stride", NARROW_CONVS)
def test_tile_plan_covers_narrow_convs(F, Ho, Wo, stride):
    """Narrower shapes get ragged tiles that the kernel masks: the N tile is
    ragged only at its narrowest (64), and a pixel rectangle spans a whole
    output row wherever the rectangle and the TMA box allow."""
    bn, th, tw = _plan(F, Ho, Wo, stride)
    assert F % bn == 0 or bn == 64
    assert tw >= min(Wo, th * tw, 256 // stride)


def test_kernel_source_is_in_the_checkout():
    """The wrapper builds one source, which the checkout holds."""
    assert cuda_conv.SOURCE.endswith(f"csrc/{cuda_conv.LIBRARY}.cu")
    assert (build.CSRC_DIR / f"{cuda_conv.LIBRARY}.cu").exists()


def _bad_calls():
    x = torch.zeros(1, 8, 8, 8, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 8, 8)
    return {
        "channels": (cuda_conv.conv3x3_bn_relu,
                     (torch.zeros(1, 8, 8, 4, dtype=torch.bfloat16), torch.zeros(3, 3, 4, 8)), {},
                     "multiples of 8"),
        "out_channels": (cuda_conv.conv3x3_bn_relu, (x, torch.zeros(3, 3, 8, 12)), {},
                         "multiples of 8"),
        "not_contiguous": (cuda_conv.conv3x3_bn_relu,
                           (torch.zeros(1, 8, 8, 8, dtype=torch.bfloat16).transpose(1, 2), w), {},
                           "contiguous"),
        "float32_input": (cuda_conv.conv3x3_bn_relu, (x.float(), w), {}, "bfloat16"),
        "meta_device": (cuda_conv.conv3x3_bn_relu, (x.to("meta"), w.to("meta")), {}, "device"),
        "weight_shape": (cuda_conv.conv3x3_bn_relu, (x, torch.zeros(1, 1, 8, 8)), {}, r"\[3, 3"),
        "odd_stride_2": (cuda_conv.conv3x3_bn_relu,
                         (torch.zeros(1, 7, 8, 8, dtype=torch.bfloat16), w), {"stride": 2},
                         "divide by the stride"),
        "tile_h": (cuda_conv.conv3x3_bn_relu_tiled, (x, w), {"tile_h": 3}, "tile_h"),
        "tile_rows": (cuda_conv_flat.conv3x3_bn_relu_flat, (x, w), {"tile_rows": 7},
                      "tile_rows"),
        "tile_rows_static": (cuda_conv_flat.conv3x3_bn_relu_flat_static, (x, w),
                             {"tile_rows": 7}, "tile_rows"),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_entries_raise_on_what_the_kernel_does_not_take(case):
    """The entries check on every device what the kernel takes, so the CPU
    path accepts exactly what the card does; a device other than CPU and
    CUDA raises instead of falling back."""
    fn, args, kwargs, match = _bad_calls()[case]
    with pytest.raises(ValueError, match=match):
        fn(*args, **kwargs)


# ---------------------------------------------------------------------------
# The stem entry: the 7x7/2 conv, BN affine, max-pool and ReLU
# ---------------------------------------------------------------------------

def _stem_inputs(B, C, H, W, seed):
    """A bf16 input plane stack, a He-scaled [64, C, 7, 7] weight and a BN
    affine, from numpy."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((B, C, H, W)) * 0.5).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((64, C, 7, 7)) * (2.0 / (49 * C)) ** 0.5)
                         .astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, 64).astype(np.float32))
    bias = torch.from_numpy((rng.standard_normal(64) * 0.1).astype(np.float32))
    return x.to(torch.bfloat16), w, scale, bias


def _stem_jax(x, w, scale, bias):
    """The reference: JAX _conv_bn on the stem (stride 2, ReLU) in bf16, then
    its 3x3 stride-2 reduce_window max (models/fast_resnet.py:151, :153);
    x is the materialized [B, C, H, W] input."""
    p = {"kernel": jnp.asarray(w.permute(2, 3, 1, 0).numpy())}
    bn_p = {"scale": jnp.asarray(scale.numpy()), "bias": jnp.zeros(64, jnp.float32)}
    bn_s = {"mean": jnp.asarray((-bias / scale).numpy()),
            "var": jnp.full(64, 1.0 - JF.BN_EPS, jnp.float32)}
    y = JF._conv_bn(jnp.asarray(x.float().permute(0, 2, 3, 1).numpy()), p, bn_p, bn_s, 2, True,
                    0, jnp.bfloat16)
    return jax.lax.reduce_window(y, -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
                                 ((0, 0), (1, 1), (1, 1), (0, 0)))


STEM_SIDES = [(2, 64, 64), (1, 37, 50), (1, 128, 251)]


@pytest.mark.parametrize("B,H,W", STEM_SIDES)
@pytest.mark.parametrize("layout", ["one_plane", "three_channels", "mono"])
def test_stem_pool_plain_matches_jax(B, H, W, layout):
    """The entry's plain version (what a CPU tensor runs) against the
    reference's stem in bf16 at even, odd and native sides: on one plane
    repeated as a broadcast view, on three channels, and on one channel.
    Both sides form every bf16 product exactly in float32 and sum in float32
    in different orders, so outputs agree to one bf16 ulp."""
    C = 1 if layout == "mono" else 3
    x, w, scale, bias = _stem_inputs(B, C, H, W, seed=30 + H)
    if layout == "one_plane":
        x = x[:, :1].expand(B, 3, H, W)
        assert x.stride(1) == 0
    # the reference's BN: bn_affine of (scale, 0, -bias/scale, 1 - eps)
    # rounds; take the port's scale and bias from the same statistics
    alpha = scale / torch.sqrt(torch.full((64,), 1.0 - JF.BN_EPS) + JF.BN_EPS)
    beta = torch.zeros(64) - (-bias / scale) * alpha
    ref = _stem_jax(x.contiguous(), w, scale, bias)
    got = cuda_stem.stem_pool(x, w, alpha, beta)
    Hp, Wp = cuda_stem.out_sizes(H, W)[2:]
    assert got.shape == (B, Hp, Wp, 64) and got.dtype == torch.bfloat16 and got.is_contiguous()
    _close(got, ref, torch.bfloat16)


def _bad_stem_calls():
    x, w, scale, bias = _stem_inputs(1, 3, 16, 16, seed=1)
    return {
        "float32_input": ((x.float(), w, scale, bias), "bfloat16"),
        "meta_device": ((x.to("meta"), w.to("meta"), scale.to("meta"), bias.to("meta")),
                        "device"),
        "two_channels": ((x[:, :2], w[:, :2], scale, bias), "1 or 3"),
        "channels_last_planes": ((x.contiguous(memory_format=torch.channels_last), w, scale, bias),
                                 "planes must be contiguous"),
        "transposed_planes": ((x.transpose(2, 3), w, scale, bias), "planes must be contiguous"),
        "filters": ((x, w[:32], scale[:32], bias[:32]), r"\[64, 3, 7, 7\]"),
        "weight_channels": ((x, w[:, :1], scale, bias), r"\[64, 3, 7, 7\]"),
    }


@pytest.mark.parametrize("case", sorted(_bad_stem_calls()))
def test_stem_entry_raises_on_what_the_kernel_does_not_take(case):
    """The entry checks on every device what the kernel takes (bf16 input,
    1 or 3 channels of contiguous planes, the stem's [64, C, 7, 7] weight),
    so the CPU path accepts exactly what the card does."""
    args, match = _bad_stem_calls()[case]
    with pytest.raises(ValueError, match=match):
        cuda_stem.stem_pool(*args)


def test_contiguous_planes_keeps_one_plane_one():
    x, _, _, _ = _stem_inputs(2, 1, 8, 8, seed=2)
    view = x.expand(2, 3, 8, 8)
    assert cuda_stem.contiguous_planes(view) is view
    odd = x.transpose(2, 3).expand(2, 3, 8, 8)
    fixed = cuda_stem.contiguous_planes(odd)
    assert fixed.stride(1) == 0 and fixed.stride(3) == 1 and torch.equal(fixed, odd)
    cl = cuda_stem.contiguous_planes(odd.contiguous(memory_format=torch.channels_last))
    assert cl.stride(1) == 64 and torch.equal(cl, odd)


# (H, W): 512² serving, the 256² fast mode, native 128 mels × 251 frames,
# and odd sides whose last tiles are ragged in both directions
STEM_PLANS = [(512, 512), (256, 256), (128, 251), (37, 50), (1, 1), (9, 7), (65, 33)]


@pytest.mark.parametrize("H,W", STEM_PLANS)
def test_stem_tile_plan_covers_every_pooled_output(H, W):
    """The tiles cover the pooled output exactly once: the last tile of each
    row and column holds at least one pooled output, and at 512², 256² and
    native size every tile is whole but the native last column's."""
    Ho, Wo, Hp, Wp = cuda_stem.out_sizes(H, W)
    assert (Ho, Hp) == ((H - 1) // 2 + 1, (Ho - 1) // 2 + 1)  # torch's conv and pool sizes
    assert (Wo, Wp) == ((W - 1) // 2 + 1, (Wo - 1) // 2 + 1)
    th, tw, nth, ntw = cuda_stem.tile_plan(H, W)
    assert (th, tw) == cuda_stem.TILE
    assert (nth - 1) * th < Hp <= nth * th and (ntw - 1) * tw < Wp <= ntw * tw
    if (H, W) in ((512, 512), (256, 256)):
        assert Hp % th == 0 and Wp % tw == 0
    if (H, W) == (128, 251):
        assert (Hp, Wp, nth, ntw) == (32, 63, 4, 4)


def _emulate_stem_tiles(x, w, scale, bias):
    """The kernel's tiling in plain torch: each tile's input patch from the
    origin tile_plan states, A rows built as the kernel builds them from
    the packed weight's k order (k = c·56 + dy·8 + dx, dx 7 and the tail
    zero), the products summed exactly (float64) and rounded to float32, the
    affine, one bf16 rounding, −inf outside the conv's output, the pool over
    the tile's conv pixels, the ReLU, the ragged edge cropped."""
    B, C, H, W = x.shape
    Ho, Wo, Hp, Wp = cuda_stem.out_sizes(H, W)
    th, tw, nth, ntw = cuda_stem.tile_plan(H, W)
    CH, CW, PR, PC = 2 * th + 1, 2 * tw + 1, 4 * th + 7, 4 * tw + 8
    packed = cuda_stem.pack_weight(w).double()
    k = torch.arange(packed.shape[1])
    plane, dy, dx = (k // 56).clamp(max=x.shape[1] - 1), (k % 56) // 8, k % 8
    live = ((dx < 7) & (k < 56 * C)).double()
    r, c = torch.arange(CH).repeat_interleave(CW), torch.arange(CW).repeat(CH)
    rows, cols = 2 * r[:, None] + dy, 2 * c[:, None] + dx
    pad = 8
    xp = torch.nn.functional.pad(x.double(), (pad, 4 * ntw * tw + 16 - W,
                                              pad, 4 * nth * th + 16 - H))
    out = torch.empty(B, Hp, Wp, 64, dtype=torch.bfloat16)
    for ti in range(nth):
        for tj in range(ntw):
            p0, q0 = ti * th, tj * tw
            y0, x0 = 4 * p0 - 5 + pad, 4 * q0 - 5 + pad
            patch = xp[:, :, y0:y0 + PR, x0:x0 + PC]
            a = patch[:, plane, rows, cols] * live  # [B, CH·CW, K]
            acc = (a @ packed.T).float()
            y = (acc * scale + bias).to(torch.bfloat16).float()
            i, j = 2 * p0 - 1 + r, 2 * q0 - 1 + c
            inside = (i >= 0) & (i < Ho) & (j >= 0) & (j < Wo)
            y = torch.where(inside[None, :, None], y, torch.tensor(float("-inf")))
            pooled = torch.relu(torch.nn.functional.max_pool2d(
                y.reshape(B, CH, CW, 64).permute(0, 3, 1, 2), 3, 2))
            ph, pw = min(th, Hp - p0), min(tw, Wp - q0)
            out[:, p0:p0 + ph, q0:q0 + pw] = pooled.permute(0, 2, 3, 1)[:, :ph, :pw].to(
                torch.bfloat16)
    return out


@pytest.mark.parametrize("H,W", [(37, 50), (128, 251), (9, 7), (64, 64)])
@pytest.mark.parametrize("layout", ["one_plane", "three_channels", "mono"])
def test_stem_tiles_emulated_match_plain_version(H, W, layout):
    """The kernel's tile geometry, patch origins, A-row layout, weight
    packing and −inf masking, emulated in plain torch, against the entry's
    plain version: within one bf16 ulp (the summation orders differ), and
    at most 0.1% of the outputs not bit-equal."""
    C = 1 if layout == "mono" else 3
    x, w, scale, bias = _stem_inputs(2, C, H, W, seed=40 + W)
    if layout == "one_plane":
        x = x[:, :1].expand(2, 3, H, W)
    got = _emulate_stem_tiles(x, w, scale, bias)
    ref = cuda_stem.stem_pool(x, w, scale, bias)
    torch.testing.assert_close(got.float(), ref.float(), rtol=BF16_ULP, atol=1e-6)
    assert (got != ref).float().mean() <= 1e-3


def test_stem_pack_weight_layout():
    """pack_weight's k order: c·56 + dy·8 + dx, a zero at dx 7, K padded to a
    multiple of 16 (64 for one channel, 176 for three)."""
    for C, K in ((1, 64), (3, 176)):
        w = torch.arange(64 * C * 49, dtype=torch.float32).reshape(64, C, 7, 7)
        packed = cuda_stem.pack_weight(w)
        assert packed.shape == (64, K) and packed.dtype == torch.bfloat16
        assert packed.is_contiguous()
        body = packed[:, :56 * C].reshape(64, C, 7, 8)
        assert torch.equal(body[..., :7], w.to(torch.bfloat16)) and not body[..., 7].any()
        assert not packed[:, 56 * C:].any()


def test_stem_source_is_in_the_checkout():
    assert cuda_stem.SOURCE.endswith(f"csrc/{cuda_stem.LIBRARY}.cu")
    assert (build.CSRC_DIR / f"{cuda_stem.LIBRARY}.cu").exists()


# ---------------------------------------------------------------------------
# The slice: the fast backbone, its convs through the kernel entry or not
# ---------------------------------------------------------------------------

def _seeded_jax_variables(seed):
    """A classifier's JAX variables from a seeded torch init with
    non-trivial BN statistics (so eval BN is not an identity)."""
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        model = BinaryClassifier("resnet18")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=g))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=g))
                m.weight.copy_(1.0 + 0.2 * torch.randn(m.weight.shape, generator=g))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
    return classifier_variables_from_torch({k: v.numpy() for k, v in model.state_dict().items()},
                                           base_prefix="base.")


@pytest.fixture(scope="module")
def jax_vars():
    return _seeded_jax_variables(0)


def _port_backbone(variables):
    """The port's ResNet-18 with the weights carried by from_jax."""
    sd = from_jax.classifier_state_dict(variables)
    net = create_resnet("resnet18")
    missing, unexpected = net.load_state_dict(
        {k[len("base."):]: v for k, v in sd.items() if k.startswith("base.")}, strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    return net.eval()


def test_conv_gate_follows_input_channels(jax_vars):
    """conv3x3_max_channels is gemm_max_channels' gate: a 3x3 conv or a 1x1
    downsample with at most that many input channels takes the kernel; 0
    takes none, 512 all sixteen 3x3 convs and three downsamples of
    ResNet-18's; the 7x7 stem never takes the conv kernel, and takes the
    stem kernel at any knob above 0 (the knob-0 plain stem stays beside
    it)."""
    net = _port_backbone(jax_vars)

    def routed(knob):
        fast = FastResNet(net, torch.bfloat16, conv3x3_max_channels=knob)
        convs = [c for blk in fast.blocks for c in blk.convs + [blk.downsample] if c is not None]
        return (sum(isinstance(c, KernelConv) for c in convs), isinstance(fast.stem, PlainConv),
                fast.kernel_stem is not None)

    assert routed(0) == (0, True, False)
    assert routed(64) == (6, True, True)  # layer1's four, layer2.0.conv1 and its downsample
    assert routed(512) == (19, True, True)
    assert FastResNet(net, torch.float32).kernel_stem is None
    with pytest.raises(ValueError, match="bfloat16"):
        FastResNet(net, torch.float32, conv3x3_max_channels=512)


# the reference's _conv_bn against the fast backbone, over full-depth
# ResNet-18 in bf16: the same operands and function, so only the float32
# summation order inside each conv differs; where two sums straddle a bf16
# rounding boundary the flip propagates through the following layers. The
# bounds: mean |d| under 2e-3 of the mean magnitude, 99.8% of elements
# within 2^-5·|ref| + 1e-3, correlation above 0.99999 (a BN folded into
# bf16 weights, as the port's fast backbone once did, fails all three)
SIDES, SEEDS = (64, 128), (0, 1)


@pytest.fixture(scope="module")
def backbone_refs():
    """{(seed, side): (images, JAX fast_backbone_apply in bf16, port
    backbone)}."""
    out = {}
    for seed in SEEDS:
        variables = _seeded_jax_variables(seed)
        base_params = variables["params"]["base"]
        base_stats = variables["batch_stats"]["base"]
        net = _port_backbone(variables)
        for side in SIDES:
            x = (np.random.default_rng(11 + seed).standard_normal((2, side, side, 3)) * 0.4
                 ).astype(np.float32)
            ref = np.asarray(JF.fast_backbone_apply(base_params, base_stats, jnp.asarray(x),
                                                    dtype=jnp.bfloat16)).astype(np.float32)
            out[(seed, side)] = (x, ref, net)
    return out


@pytest.fixture(scope="module")
def one_plane_refs():
    """As backbone_refs, for inputs that repeat one bf16 plane on the three
    channels, as the serving pipeline feeds the backbone."""
    out = {}
    for seed in SEEDS:
        variables = _seeded_jax_variables(seed)
        net = _port_backbone(variables)
        for side in SIDES:
            plane = torch.from_numpy((np.random.default_rng(21 + seed).standard_normal(
                (2, side, side)) * 0.4).astype(np.float32)).to(torch.bfloat16).float().numpy()
            x = np.repeat(plane[..., None], 3, axis=-1)
            ref = np.asarray(JF.fast_backbone_apply(
                variables["params"]["base"], variables["batch_stats"]["base"], jnp.asarray(x),
                dtype=jnp.bfloat16)).astype(np.float32)
            out[(seed, side)] = (x, ref, net)
    return out


def _assert_backbone_matches(backbone_refs, knob, one_plane=False):
    for (seed, side), (x, ref, net) in backbone_refs.items():
        fast = FastResNet(net, torch.bfloat16, conv3x3_max_channels=knob)
        x = torch.from_numpy(x).permute(0, 3, 1, 2)
        if one_plane:  # melspec.replicate_channels' broadcast view
            x = x[:, :1].to(torch.bfloat16).expand(-1, 3, -1, -1)
            assert x.stride(1) == 0
        got = fast(x)
        assert got.dtype == torch.bfloat16
        got = got.float().permute(0, 2, 3, 1).numpy()
        assert got.shape == ref.shape == (2, side // 32, side // 32, 512)
        d = np.abs(got - ref)
        assert d.mean() / np.abs(ref).mean() < 2e-3, (seed, side)
        assert (d <= 2.0 ** -5 * np.abs(ref) + 1e-3).mean() >= 0.998, (seed, side)
        assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.99999, (seed, side)


def test_fast_backbone_kernel_route_matches_jax(backbone_refs):
    """The pipeline's default FastResNet (knob 512: every 3x3 conv and 1x1
    downsample through the kernel entry) against JAX fast_backbone_apply in
    bf16, at 64² and 128², seeds 0 and 1."""
    _assert_backbone_matches(backbone_refs, 512)


def test_fast_backbone_plain_route_matches_jax(backbone_refs):
    """The knob-0 route (every conv the plain composition, the reference's
    lax.conv branch) against the same references."""
    _assert_backbone_matches(backbone_refs, 0)


def test_fast_backbone_one_plane_stem_matches_jax(one_plane_refs):
    """An input that repeats one plane as a broadcast view: at knob 512 the
    stem entry reads the plane once and convolves it with each channel's
    own weight. The same bounds against the reference on the materialized
    input."""
    _assert_backbone_matches(one_plane_refs, 512, one_plane=True)


def test_fast_backbone_one_plane_plain_stem_matches_jax(one_plane_refs):
    """At knob 0 a broadcast input takes the stem's channel-summed weight (a
    third of the products; the sum of three bf16 weights and its products
    with bf16 values exact in float32 but for rare wide exponent spreads):
    the same bounds."""
    _assert_backbone_matches(one_plane_refs, 0, one_plane=True)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("route", ["kernel", "plain"])
def test_downsample_matches_reference_conv_bn(route, stride):
    """A 1x1 downsample + BN: through the kernel entry with its weight at the
    centre tap of a zero 3x3 weight, or the plain composition, against JAX
    _conv_bn on the 1x1 kernel. Operands hold bf16 values and both sides
    form every product exactly in float32, so the float32 outputs differ by
    summation order only (rtol and atol 1e-5; the eight zero taps add exact
    zeros)."""
    rng = np.random.default_rng(20 + stride)
    C, Fo = 64, 128
    x = torch.from_numpy(rng.standard_normal((2, 16, 16, C)).astype(np.float32)).to(torch.bfloat16)
    conv = torch.nn.Conv2d(C, Fo, 1, stride, 0, bias=False)
    bn = torch.nn.BatchNorm2d(Fo).eval()
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(rng.standard_normal((Fo, C, 1, 1)) * 0.1)
                          .to(torch.bfloat16).float())
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, Fo)))
        bn.bias.copy_(torch.from_numpy(rng.standard_normal(Fo) * 0.1))
        bn.running_mean.copy_(torch.from_numpy(rng.standard_normal(Fo) * 0.1))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, Fo)))
    p = {"kernel": jnp.asarray(conv.weight.detach().permute(2, 3, 1, 0).numpy())}
    bn_p = {"scale": jnp.asarray(bn.weight.detach().numpy()),
            "bias": jnp.asarray(bn.bias.detach().numpy())}
    bn_s = {"mean": jnp.asarray(bn.running_mean.numpy()),
            "var": jnp.asarray(bn.running_var.numpy())}
    ref = np.asarray(JF._conv_bn(jnp.asarray(x.float().numpy()), p, bn_p, bn_s, stride, False,
                                 0, jnp.float32))
    x_cl = x.permute(0, 3, 1, 2)  # channels_last [B, C, H, W], as the backbone holds it
    if route == "kernel":
        k = kernel_conv_bn(conv, bn, relu=False)
        assert tuple(k.weight.shape) == (Fo, 3, 3, C)
        assert not k.weight[:, [0, 0, 0, 1, 1, 2, 2, 2], [0, 1, 2, 0, 2, 0, 1, 2]].any()
        got = cuda_conv.conv3x3_bn_relu(x, k.weight.permute(1, 2, 3, 0), k.scale, k.bias,
                                        stride=stride, relu=False, out_dtype=torch.float32)
    else:
        c = plain_conv_bn(conv, bn, torch.bfloat16, relu=False)
        got = cuda_conv.conv_bn_relu_plain(x_cl, c.weight, c.scale, c.bias, c.stride, c.padding,
                                           False, out_dtype=torch.float32).permute(0, 2, 3, 1)
    assert tuple(got.shape) == ref.shape == (2, 16 // stride, 16 // stride, Fo)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_fast_ensemble_kernel_route_matches_jax_verdicts(jax_vars):
    """Shared-backbone ensemble in bf16 through the kernel route: the
    aggregated logits' argmax equals JAX fast_ensemble_per_head_logits +
    _aggregate (tests/test_fast_resnet.py:62), correlation above 0.99."""
    heads = [_seeded_jax_variables(s) for s in (5, 6)]
    for v in heads:
        v["params"]["base"] = jax_vars["params"]["base"]
        v["batch_stats"]["base"] = jax_vars["batch_stats"]["base"]
    je = JE.build_ensemble(JaxClassifier(backbone="resnet18", dtype=jnp.bfloat16), heads, NAMES)
    assert je.shared_backbone
    x = (np.random.default_rng(12).standard_normal((4, 64, 64, 3)) * 0.4).astype(np.float32)
    ref = np.asarray(JE._aggregate(JF.fast_ensemble_per_head_logits(je, jnp.asarray(x))),
                     np.float32)
    te = TE.with_dtype(from_jax.ensemble_from_variables(
        jax.tree_util.tree_map(np.asarray, je.variables), NAMES), torch.bfloat16)
    assert te.shared_backbone
    nh = TE.ensemble_per_head_logits(te, torch.from_numpy(x).permute(0, 3, 1, 2),
                                     fast_backbone=True, conv3x3_max_channels=512)
    got = TE._aggregate(nh).float().numpy()
    assert got.shape == ref.shape == (4, 3)
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.99
    np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))


def test_kernel_route_is_cached_per_knob(jax_vars):
    te = TE.with_dtype(from_jax.ensemble_from_variables(
        {k: jax.tree_util.tree_map(lambda a: np.stack([a, a]), v) for k, v in jax_vars.items()},
        NAMES), torch.bfloat16)
    a = te.compute_backbone(0, fast=True, conv3x3_max_channels=512)
    assert te.compute_backbone(0, fast=True, conv3x3_max_channels=512) is a
    assert te.compute_backbone(0, fast=True) is not a
    assert dataclasses.is_dataclass(a.blocks[0].convs[0])
