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
from synthetic_audio_detection_tpu_torch.models.fast_resnet import FastResNet, KernelConv
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
# The slice: the fast backbone with its 3x3 convs through the kernel entry
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


@pytest.fixture(scope="module")
def images():
    return (np.random.default_rng(11).standard_normal((2, 64, 64, 3)) * 0.4).astype(np.float32)


def _port_backbone(variables):
    """The port's ResNet-18 with the weights carried by from_jax."""
    sd = from_jax.classifier_state_dict(variables)
    net = create_resnet("resnet18")
    missing, unexpected = net.load_state_dict(
        {k[len("base."):]: v for k, v in sd.items() if k.startswith("base.")}, strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    return net.eval()


def test_conv_gate_follows_input_channels(jax_vars):
    """conv3x3_max_channels is gemm_max_channels' gate: a 3x3 conv with at
    most that many input channels takes the kernel; 0 takes none, 512 all
    sixteen of ResNet-18's; the stem and downsample convs never do."""
    net = _port_backbone(jax_vars)

    def routed(knob):
        fast = FastResNet(net, torch.bfloat16, conv3x3_max_channels=knob)
        convs = [c for blk in fast.blocks for c in blk.convs]
        return (sum(isinstance(c, KernelConv) for c in convs),
                not isinstance(fast.stem, KernelConv)
                and not any(isinstance(b.downsample, KernelConv) for b in fast.blocks))

    assert routed(0) == (0, True)
    assert routed(64) == (5, True)  # layer1's four and layer2.0.conv1
    assert routed(512) == (16, True)
    with pytest.raises(ValueError, match="bfloat16"):
        FastResNet(net, torch.float32, conv3x3_max_channels=512)


def test_fast_backbone_kernel_route_matches_jax(jax_vars, images):
    """Full-depth ResNet-18 at 64², bf16, every 3x3 conv through the kernel
    entry, against JAX fast_backbone_apply in bf16: no looser than
    tests/test_fast_resnet.py:50-52 (max error under 0.2 of the mean
    magnitude, correlation above 0.999)."""
    base_params, base_stats = jax_vars["params"]["base"], jax_vars["batch_stats"]["base"]
    ref = np.asarray(JF.fast_backbone_apply(base_params, base_stats, jnp.asarray(images),
                                            dtype=jnp.bfloat16)).astype(np.float32)
    fast = FastResNet(_port_backbone(jax_vars), torch.bfloat16, conv3x3_max_channels=512)
    got = fast(torch.from_numpy(images).permute(0, 3, 1, 2))
    assert got.dtype == torch.bfloat16
    got = got.float().permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, 2, 2, 512)
    scale = np.abs(ref).mean() + 1e-6
    assert np.abs(got - ref).max() / scale < 0.2
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.999


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
