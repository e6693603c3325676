"""The port's 3x3 conv + BN + ReLU (ops/cuda_conv.py, ops/cuda_conv_flat.py)
and the fast backbone that routes through it, against the JAX package, on
the CPU.

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
from synthetic_audio_detection_tpu_torch.ops import build, cuda_conv, cuda_conv_flat

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
    ResNet-18's; the 7x7 stem never does."""
    net = _port_backbone(jax_vars)

    def routed(knob):
        fast = FastResNet(net, torch.bfloat16, conv3x3_max_channels=knob)
        convs = [c for blk in fast.blocks for c in blk.convs + [blk.downsample] if c is not None]
        return sum(isinstance(c, KernelConv) for c in convs), isinstance(fast.stem, PlainConv)

    assert routed(0) == (0, True)
    assert routed(64) == (6, True)  # layer1's four, layer2.0.conv1 and layer2.0's downsample
    assert routed(512) == (19, True)
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
    """An input that repeats one plane as a broadcast view takes the stem's
    channel-summed weight (a third of the products; the sum of three bf16
    weights and its products with bf16 values exact in float32 but for
    rare wide exponent spreads): the same bounds against the reference on
    the materialized input."""
    _assert_backbone_matches(one_plane_refs, 512, one_plane=True)


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
