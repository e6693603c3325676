"""The port's space-to-depth stage 1 (ops/space_to_depth.py, the S2D
stage 1 of models/resnet.py, the trainer's and the pipeline's flags)
against the JAX package's, on the CPU.

Inputs and weights come from numpy with fixed seeds; the port is NCHW and
OIHW, the JAX package NHWC and HWIO, and tensors are compared under that
permute. Rearrangements and folds move values and must be equal bit for
bit. A conv on folded weights sums the same float32 products in another
order: 1e-5 at these O(1) values, as the JAX package's own tests bound
them. Whole models: 1e-4 on the logits (float32), and in float64 the
gradients of the original kernels to 1e-10 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from synthetic_audio_detection_tpu.checkpoints.torch_compat import (
    classifier_variables_from_torch,
)
from synthetic_audio_detection_tpu.cli import submodel_trainer as JCLI
from synthetic_audio_detection_tpu.ensemble import multihead as JE
from synthetic_audio_detection_tpu.infer import pipeline as JP
from synthetic_audio_detection_tpu.models import resnet as JR
from synthetic_audio_detection_tpu.models.classifier import BinaryClassifier as JaxClassifier
from synthetic_audio_detection_tpu.ops import space_to_depth as J
from synthetic_audio_detection_tpu.utils.config import InferenceConfig as JInfer
from synthetic_audio_detection_tpu.utils.config import SpectrogramConfig as JSpec
from synthetic_audio_detection_tpu_torch.checkpoints import from_jax
from synthetic_audio_detection_tpu_torch.cli import submodel_trainer as TCLI
from synthetic_audio_detection_tpu_torch.infer import pipeline as TP
from synthetic_audio_detection_tpu_torch.models import resnet as TR
from synthetic_audio_detection_tpu_torch.models.classifier import BinaryClassifier
from synthetic_audio_detection_tpu_torch.ops import space_to_depth as T
from synthetic_audio_detection_tpu_torch.utils.config import (
    AudioConfig,
    InferenceConfig,
    SpectrogramConfig,
)

NAMES = ["SynA", "SynB", "Real"]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


def _oihw(a):
    return np.asarray(a).transpose(3, 2, 0, 1)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# The functions of ops/space_to_depth.py
# ---------------------------------------------------------------------------

def _operands(seed=0, side=(16, 24), c=8, f=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, *side, c)).astype(np.float32)
    w = (rng.standard_normal((3, 3, c, f)) * 0.2).astype(np.float32)
    return x, w


# name → (port result, JAX result, exact); the port gets NCHW / OIHW operands
FUNCTION_CASES = {
    "space_to_depth_h": lambda x, w, xt, wt: (
        T.space_to_depth_h(xt), _nchw(J.space_to_depth_h(jnp.asarray(x))), True),
    "depth_to_space_h": lambda x, w, xt, wt: (
        T.depth_to_space_h(xt), _nchw(J.depth_to_space_h(jnp.asarray(x))), True),
    "fold_conv3x3_s2d_h": lambda x, w, xt, wt: (
        T.fold_conv3x3_s2d_h(wt), _oihw(J.fold_conv3x3_s2d_h(w)), True),
    "conv3x3_s2d_h": lambda x, w, xt, wt: (
        T.conv3x3_s2d_h(T.space_to_depth_h(xt), T.fold_conv3x3_s2d_h(wt)),
        _nchw(J.conv3x3_s2d_h(J.space_to_depth_h(jnp.asarray(x)), J.fold_conv3x3_s2d_h(w))),
        False),
}


@pytest.mark.parametrize("side", [(16, 24), (32, 32)])
@pytest.mark.parametrize("name", sorted(FUNCTION_CASES))
def test_function_matches_jax(name, side):
    """Every function of the module against the JAX package's at B=2, C=F=8:
    rearrangements and folds bit for bit, convs on folded weights to 1e-5
    (the same float32 products summed in another order)."""
    x, w = _operands(side=side)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got, ref, exact = FUNCTION_CASES[name](x, w, xt, torch.from_numpy(_oihw(w)).contiguous())
    got = _np(got)
    assert got.shape == ref.shape
    if exact:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("side", [(16, 24), (32, 32)])
def test_folded_conv_matches_direct_conv(side):
    """The JAX package's exactness test on the port alone: the H-only fold,
    with its rearrangement undone, is the direct 3x3 pad-1 conv
    (F.conv2d)."""
    x, w = _operands(seed=1, side=side)
    xt, wt = torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(_oihw(w)).contiguous()
    got = T.depth_to_space_h(T.conv3x3_s2d_h(T.space_to_depth_h(xt), T.fold_conv3x3_s2d_h(wt)))
    ref = F.conv2d(xt, wt, padding=1).numpy()
    np.testing.assert_allclose(_np(got), ref, rtol=1e-5, atol=1e-5)


def test_layer1_shape_and_bf16_operands_match_jax():
    """The layer-1 frontier shape (one image, [128, 128] × 64 channels) with
    bf16 operands and float32 accumulation on both sides: every product is
    exact in float32, so only the summation order differs."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 128, 128, 64)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 64, 64)) * 0.05).astype(np.float32)
    xb = torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16)
    wb = torch.from_numpy(_oihw(w)).contiguous().to(torch.bfloat16)
    got = T.conv3x3_s2d_h(T.space_to_depth_h(xb), T.fold_conv3x3_s2d_h(wb))
    assert got.dtype == torch.float32
    ref = J.conv3x3_s2d_h(J.space_to_depth_h(jnp.asarray(x, jnp.bfloat16)),
                          J.fold_conv3x3_s2d_h(jnp.asarray(w, jnp.bfloat16)),
                          preferred_element_type=jnp.float32)
    np.testing.assert_allclose(got.numpy(), _nchw(ref), rtol=2e-4, atol=2e-4)


def test_rearrangements_keep_the_layout_and_invert():
    """A rearrangement of a contiguous tensor is contiguous, of a
    channels_last one channels_last, with the same values either way, and
    each inverse undoes its rearrangement exactly."""
    x = torch.from_numpy(_operands()[0]).permute(0, 3, 1, 2).contiguous()
    last = x.contiguous(memory_format=torch.channels_last)
    a, b = T.space_to_depth_h(x), T.space_to_depth_h(last)
    assert a.is_contiguous() and b.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    for y, fmt in ((a, torch.contiguous_format), (b, torch.channels_last)):
        back = T.depth_to_space_h(y)
        assert back.is_contiguous(memory_format=fmt)
        torch.testing.assert_close(back, x, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# S2DBasicBlock and the ResNet flag
# ---------------------------------------------------------------------------

def _block_pair(dtype):
    """JAX S2DBasicBlock variables at planes 8 and the port's BasicBlock with
    the same weights (HWIO → OIHW, BN scale/bias/mean/var)."""
    rng = np.random.default_rng(4)
    c = 8
    params = {"conv1": {"kernel": rng.standard_normal((3, 3, c, c)) * 0.2},
              "conv2": {"kernel": rng.standard_normal((3, 3, c, c)) * 0.2}}
    stats = {}
    for bn in ("bn1", "bn2"):
        params[bn] = {"scale": rng.uniform(0.5, 1.5, c), "bias": rng.standard_normal(c) * 0.1}
        stats[bn] = {"mean": rng.standard_normal(c) * 0.1, "var": rng.uniform(0.5, 1.5, c)}
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype),
                                       {"params": params, "batch_stats": stats})
    blk = TR.BasicBlock(c, c).to(torch.float64 if dtype == np.float64 else torch.float32)
    with torch.no_grad():
        for name in ("conv1", "conv2"):
            getattr(blk, name).weight.copy_(torch.from_numpy(_oihw(params[name]["kernel"])))
        for name in ("bn1", "bn2"):
            bn = getattr(blk, name)
            bn.weight.copy_(torch.from_numpy(params[name]["scale"]))
            bn.bias.copy_(torch.from_numpy(params[name]["bias"]))
            bn.running_mean.copy_(torch.from_numpy(stats[name]["mean"]))
            bn.running_var.copy_(torch.from_numpy(stats[name]["var"]))
    x = rng.standard_normal((2, 128, 16, c)).astype(dtype)
    return variables, blk, x


def _jax_block(variables, x, train):
    """JAX S2DBasicBlock on the H-only rearrangement of x → (output
    undone, updated stats, d sum(out²) / d kernels)."""
    dtype = jnp.float64 if x.dtype == np.float64 else jnp.float32
    mod = JR.S2DBasicBlock(planes=8, dtype=dtype)
    xs = J.space_to_depth_h(jnp.asarray(x))

    def loss(p):
        out, upd = mod.apply({"params": p, "batch_stats": variables["batch_stats"]}, xs,
                             train=train, mutable=["batch_stats"])
        return jnp.sum(out ** 2), (out, upd["batch_stats"])

    (_, (out, stats)), g = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    return _nchw(J.depth_to_space_h(out)), stats, g


def _port_block(blk, x, train, s2d):
    """The port's block (S2DBasicBlock on the rearrangement, or the plain
    BasicBlock) → (output, running stats, d sum(out²) / d kernels)."""
    blk.train(train)
    blk.zero_grad()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    out = (T.depth_to_space_h(TR.S2DBasicBlock(blk)(T.space_to_depth_h(xt))) if s2d
           else blk(xt))
    (out ** 2).sum().backward()
    stats = {bn: (getattr(blk, bn).running_mean.detach().clone(),
                  getattr(blk, bn).running_var.detach().clone()) for bn in ("bn1", "bn2")}
    grads = {cv: getattr(blk, cv).weight.grad.clone() for cv in ("conv1", "conv2")}
    return out.detach(), stats, grads


@pytest.mark.parametrize("train", [False, True])
def test_s2d_block_matches_jax_float32(train):
    """S2DBasicBlock against JAX's at planes 8, 128×16: the output, the
    updated BN statistics (over both phases: the plain block's per-channel
    ones) and the gradients of the original kernels."""
    variables, blk, x = _block_pair(np.float32)
    ref, ref_stats, ref_g = _jax_block(variables, x, train)
    before = {bn: getattr(blk, bn).running_mean.clone() for bn in ("bn1", "bn2")}
    got, stats, g = _port_block(blk, x, train, s2d=True)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    for bn in ("bn1", "bn2"):
        np.testing.assert_allclose(stats[bn][0].numpy(), np.asarray(ref_stats[bn]["mean"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(stats[bn][1].numpy(), np.asarray(ref_stats[bn]["var"]),
                                   rtol=1e-5, atol=1e-6)
        assert train != torch.equal(stats[bn][0], before[bn])
    for cv in ("conv1", "conv2"):
        want = _oihw(ref_g[cv]["kernel"])
        rel = np.linalg.norm(g[cv].numpy() - want) / np.linalg.norm(want)
        assert rel < 1e-4, (cv, rel)


@pytest.mark.parametrize("train", [False, True])
def test_s2d_block_gradients_exact_in_float64(train):
    """float64: the s2d block's output and kernel gradients equal the plain
    BasicBlock's and JAX's S2DBasicBlock's to 1e-10 relative (the
    reformulation is exact; float32 differs by reassociation only)."""
    variables, blk, x = _block_pair(np.float64)
    with jax.enable_x64():
        ref, _, ref_g = _jax_block(variables, x, train)
    plain = _port_block(blk, x, train, s2d=False)
    blk.load_state_dict(_block_pair(np.float64)[1].state_dict())
    got = _port_block(blk, x, train, s2d=True)
    for other in (plain[0].numpy(), ref):
        assert np.abs(got[0].numpy() - other).max() < 1e-10
    for cv in ("conv1", "conv2"):
        for want in (plain[2][cv].numpy(), _oihw(ref_g[cv]["kernel"])):
            rel = np.linalg.norm(got[2][cv].numpy() - want) / np.linalg.norm(want)
            assert rel < 1e-10, (cv, rel)


def test_phase_bn_takes_both_layouts_without_copy():
    """_phase_bn reads a contiguous tensor as [2B, C, h, W] and a
    channels_last one as [B, C, h, 2W], both views: the statistics and the
    output are the same either way."""
    bn = TR.FlaxBatchNorm2d(8, momentum=0.1).train()
    y = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 16, 8, 6)).astype(
        np.float32))
    outs = []
    for t in (y.contiguous(), y.contiguous(memory_format=torch.channels_last)):
        bn.reset_running_stats()
        outs.append((TR._phase_bn(bn, t), bn.running_mean.clone(), bn.running_var.clone()))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    plain = y.view(2, 2, 8, 8, 6).transpose(1, 2).reshape(2, 8, 16, 6)  # phase rows per channel
    bn.reset_running_stats()
    bn(plain)
    torch.testing.assert_close(outs[0][1], bn.running_mean, rtol=1e-6, atol=1e-7)


class _CountingMesh:
    """A one-rank stand-in for parallel.sharding.Mesh: all_reduce returns its
    input and counts the calls."""

    def __init__(self):
        self.calls = 0

    def all_reduce(self, t):
        self.calls += 1
        return t


def test_s2d_block_makes_one_all_reduce_per_batchnorm():
    """Under a mesh each BatchNorm of the s2d block reduces its Σx, Σx² and n
    with one all-reduce, as the plain block's does, and the statistics are
    the plain block's."""
    _, blk, x = _block_pair(np.float32)
    stats = []
    for s2d in (False, True):
        mesh = _CountingMesh()
        TR.sync_batch_stats(blk, mesh)
        blk.load_state_dict(_block_pair(np.float32)[1].state_dict())
        _, st, _ = _port_block(blk, x, True, s2d)
        assert mesh.calls == 2
        stats.append(st)
    for bn in ("bn1", "bn2"):
        for a, b in zip(stats[0][bn], stats[1][bn]):
            torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)


def test_stop_grad_stage_runs_the_s2d_stage_without_autograd(s2d_calls):
    """stop_grad_stage 2 in train mode: the s2d stage 1 runs (at a 512²
    input) under no_grad, so its kernels get no gradient while its BN
    statistics update, and the stages after it train."""
    torch.manual_seed(0)
    net = TR.ResNet("basic", (1, 1, 1, 1), s2d_stage1=True).train()
    net.stop_grad_stage = 2
    before = net.layer1[0].bn1.running_mean.clone()
    net(torch.randn(1, 3, 512, 512) * 0.3).square().sum().backward()
    assert s2d_calls["port"] == [(1, 64, 128, 128)]
    assert net.layer1[0].conv1.weight.grad is None
    assert net.layer2[0].conv1.weight.grad is not None
    assert not torch.equal(net.layer1[0].bn1.running_mean, before)


def _seeded_variables(seed=0):
    """A classifier's JAX variables from a seeded torch init with non-trivial
    BN statistics."""
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
def variables():
    return _seeded_variables(0)


@pytest.fixture
def s2d_calls(monkeypatch):
    """The shapes space_to_depth_h was called on, in the port and in JAX."""
    calls = {"port": [], "jax": []}
    for mod, key in ((T, "port"), (J, "jax")):
        orig = mod.space_to_depth_h
        monkeypatch.setattr(mod, "space_to_depth_h",
                            lambda a, orig=orig, key=key: (calls[key].append(tuple(a.shape)),
                                                           orig(a))[1])
    return calls


def test_classifier_s2d_stage1_matches_jax_at_512(variables, s2d_calls):
    """One ResNet-18 classifier at 512² (stage-1 height 128: the gate
    engages) in float32 eval mode, one window: the port's
    BinaryClassifier(s2d_stage1=True) with the weights carried by from_jax
    against JAX's BinaryClassifier(s2d_stage1=True), logits within 1e-4,
    and against the port's plain model."""
    x = (np.random.default_rng(6).standard_normal((1, 512, 512, 3)) * 0.3).astype(np.float32)
    ref = np.asarray(JaxClassifier(backbone="resnet18", s2d_stage1=True).apply(
        variables, jnp.asarray(x), train=False))
    assert s2d_calls["jax"] == [(1, 128, 128, 64)]
    model = BinaryClassifier("resnet18", s2d_stage1=True).eval()
    model.load_state_dict(from_jax.classifier_state_dict(variables), strict=False)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = model(xt).numpy()
        plain = model.base(xt, s2d_stage1=False)
        assert s2d_calls["port"] == [(1, 64, 128, 128)]
        plain = model.head(plain).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, plain, rtol=1e-4, atol=1e-4)


def test_s2d_gate_is_a_no_op_where_the_reference_skips_it(s2d_calls):
    """Stage-1 height under 128, or a bottleneck backbone: the flag changes
    nothing and the rearrangement never runs, as in JAX."""
    with torch.no_grad():
        TR.create_resnet("resnet18", s2d_stage1=True).eval()(torch.zeros(1, 3, 256, 256))
        # the stage gate itself, at a 128-row stage-1 input
        TR.create_resnet("resnet26", s2d_stage1=True).eval()._stage(
            1, torch.zeros(1, 64, 128, 8), True)
    assert s2d_calls["port"] == []


def test_s2d_classifier_state_dict_is_the_plain_one():
    """The s2d flag adds and renames nothing: the same keys and shapes as the
    plain model's, and JAX's s2d variable tree (shapes of an init at 512²)
    carried by from_jax loads into the port's s2d model strictly."""
    a = BinaryClassifier("resnet18").state_dict()
    b = BinaryClassifier("resnet18", s2d_stage1=True).state_dict()
    assert {k: v.shape for k, v in a.items()} == {k: v.shape for k, v in b.items()}
    model = JaxClassifier(backbone="resnet18", s2d_stage1=True)
    shapes = jax.eval_shape(lambda: model.init({"params": jax.random.PRNGKey(0)},
                                               jnp.zeros((1, 512, 512, 3)), train=False))
    plain = jax.eval_shape(lambda: JaxClassifier(backbone="resnet18").init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3)), train=False))
    assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(plain)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    missing, unexpected = BinaryClassifier("resnet18", s2d_stage1=True).load_state_dict(
        from_jax.classifier_state_dict(zeros), strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)


# ---------------------------------------------------------------------------
# The auto gates and the pipeline flag
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [[], ["--s2d-layer1"], ["--no-s2d-layer1"],
                                  ["--no-stop-grad-boundary"],
                                  ["--no-stop-grad-boundary", "--s2d-layer1"],
                                  ["--no-stop-grad-boundary", "--input-size", "256"]])
def test_resolve_s2d_follows_jax(argv):
    """_resolve_s2d as tests/test_cli_surfaces.py:69-90 pins JAX's: explicit
    wins, the stop-grad boundary turns auto off, and otherwise JAX's backend
    test, off on a CPU backend (and on a GPU one): the port's auto is off."""
    argv = ["--data-dir", "x"] + argv
    port = TCLI._resolve_s2d(TCLI.build_parser().parse_args(argv))
    assert port is JCLI._resolve_s2d(JCLI.build_parser().parse_args(argv))
    assert port is ("--s2d-layer1" in argv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch_size", [8, 128])
def test_pipeline_s2d_auto_gate_follows_jax(variables, dtype, batch_size):
    """InferencePipeline's use_s2d_layer1 auto resolves as the JAX pipeline's
    off a TPU (off), for both dtypes and bucket sizes; True turns the fast
    backbone off, as JAX's ``not self.use_s2d_layer1``."""
    vs = [variables, _seeded_variables(1)]
    je = JE.build_ensemble(JaxClassifier(backbone="resnet18"), vs, NAMES)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jp = JP.InferencePipeline(je, spec=JSpec.inference(out_size=512),
                              infer=JInfer(batch_size=batch_size), compute_dtype=jdt)
    te = from_jax.ensemble_from_variables(je.variables, NAMES)
    tp = TP.InferencePipeline(te, spec=SpectrogramConfig.inference(out_size=512),
                              infer=InferenceConfig(batch_size=batch_size),
                              compute_dtype=dtype, device="cpu")
    assert tp.use_s2d_layer1 is jp.use_s2d_layer1 is False
    on = TP.InferencePipeline(te, compute_dtype=dtype, device="cpu", use_s2d_layer1=True)
    assert on.use_s2d_layer1 and not on.use_fast_backbone


def test_pipeline_s2d_logits_match_default_at_512(variables, s2d_calls):
    """use_s2d_layer1=True on a shared-backbone ensemble at 512², float32, one
    window: the plain backbone with the s2d stage 1 (the rearrangement runs
    once), also where the fast backbone was asked for, logits within 1e-4
    of the default pipeline's."""
    heads = _seeded_variables(1)
    other = {"params": {**heads["params"], "base": variables["params"]["base"]},
             "batch_stats": {**heads["batch_stats"], "base": variables["batch_stats"]["base"]}}
    te = from_jax.ensemble_from_variables(
        jax.tree_util.tree_map(lambda *a: np.stack(a), variables, other), NAMES)
    assert te.shared_backbone
    audio = AudioConfig()
    batch = torch.from_numpy((np.random.default_rng(9).standard_normal(
        (1, audio.window_samples)) * 0.1).astype(np.float32))
    spec = SpectrogramConfig.inference(out_size=512)
    default = TP.InferencePipeline(te, audio=audio, spec=spec, device="cpu")
    s2d = TP.InferencePipeline(te, audio=audio, spec=spec, device="cpu", use_s2d_layer1=True)
    ref = default._forward(batch).numpy()
    assert s2d_calls["port"] == []
    got = s2d._forward(batch).numpy()
    assert s2d_calls["port"] == [(1, 64, 128, 128)]
    fast = TP.forward_windows(te, batch, spec, audio.sample_rate, use_fast_backbone=True,
                              use_s2d_layer1=True).numpy()
    assert len(s2d_calls["port"]) == 2
    assert got.shape == ref.shape == (1, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(fast, got)
