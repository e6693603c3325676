"""The port's models, ensemble and checkpoints against the JAX package, on
the CPU at 64² inputs with the same weights (carried by
checkpoints/from_jax.py) and the same numpy inputs.

Float32 tolerances: 1e-4 absolute on logits of O(1) — the two frameworks
sum the convolutions in different orders, nothing else differs.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic_audio_detection_tpu.checkpoints import serialization as jax_ser
from synthetic_audio_detection_tpu.checkpoints.torch_compat import (
    classifier_variables_from_torch,
    torch_state_dict_from_variables,
)
from synthetic_audio_detection_tpu.ensemble import multihead as JE
from synthetic_audio_detection_tpu.models.classifier import BinaryClassifier as JaxClassifier
from synthetic_audio_detection_tpu_torch.checkpoints import from_jax
from synthetic_audio_detection_tpu_torch.checkpoints import serialization as ser
from synthetic_audio_detection_tpu_torch.ensemble import multihead as TE
from synthetic_audio_detection_tpu_torch.models.classifier import BinaryClassifier
from synthetic_audio_detection_tpu_torch.models.resnet import create_resnet

from fixture_weights import deterministic_state_dict

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "golden_v1.npz")
NAMES = ["SynA", "SynB", "Real"]


def port_state_dict(seed, backbone="resnet18"):
    """A classifier state dict from torch's default init (seeded) with
    non-trivial BN statistics, so eval-mode BN is not an identity."""
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        model = BinaryClassifier(backbone)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=g))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=g))
                m.weight.copy_(1.0 + 0.2 * torch.randn(m.weight.shape, generator=g))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
    return model.state_dict()


def to_jax_variables(sd):
    return classifier_variables_from_torch({k: v.numpy() for k, v in sd.items()},
                                           base_prefix="base.")


@pytest.fixture(scope="module")
def jax_vars():
    return [to_jax_variables(port_state_dict(i)) for i in range(3)]


@pytest.fixture(scope="module")
def images():
    x = np.random.default_rng(7).standard_normal((2, 64, 64, 1)).astype(np.float32)
    return x, np.repeat(x, 3, axis=-1)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("seed,key", [(0, "logits_h0"), (1, "logits_h1")])
def test_classifier_matches_recorded_torch_logits(seed, key):
    """Same bound as test_golden_fixtures.py:56 (2e-3)."""
    golden = np.load(FIXTURE)
    model = BinaryClassifier().eval()
    sd = {k: torch.from_numpy(v) for k, v in deterministic_state_dict(seed=seed).items()}
    model.load_state_dict(sd, strict=False)
    x = torch.from_numpy(golden["mel"])[:, None].expand(-1, 3, -1, -1)
    with torch.no_grad():
        got = model(x).numpy()
    np.testing.assert_allclose(got, golden[key], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("backbone", ["resnet26", "resnet50"])
def test_bottleneck_key_space_matches_flax(backbone):
    """Every parameter of the flax model (shapes only, from eval_shape) is a
    port parameter of the same shape under the reference key map."""
    model = JaxClassifier(backbone=backbone)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 32, 3)), train=False))
    flax_sd = torch_state_dict_from_variables(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes))
    port_sd = {k: v for k, v in BinaryClassifier(backbone).state_dict().items()
               if not k.endswith("num_batches_tracked")}
    assert set(flax_sd) == set(port_sd)
    for k, v in flax_sd.items():
        assert tuple(v.shape) == tuple(port_sd[k].shape), k


def test_stage_slices_compose_to_full_backbone(images):
    full = create_resnet("resnet18").eval()
    trunk = create_resnet("resnet18", last_stage=3).eval()
    tail = create_resnet("resnet18", first_stage=4).eval()
    sd = full.state_dict()
    assert set(trunk.state_dict()) | set(tail.state_dict()) == set(sd)
    trunk.load_state_dict({k: sd[k] for k in trunk.state_dict()})
    tail.load_state_dict({k: sd[k] for k in tail.state_dict()})
    x = nchw(images[1])
    with torch.no_grad():
        assert torch.equal(tail(trunk(x)), full(x))
    with pytest.raises(ValueError):
        create_resnet("resnet18", first_stage=3, last_stage=2)


def _jax_ensemble(jax_vars, layout):
    model = JaxClassifier(backbone="resnet18")
    if layout == "shared":
        return JE.build_ensemble(model, [jax_vars[0]] * 2, NAMES)
    if layout == "dense":
        return JE.build_ensemble(model, jax_vars[:2], NAMES)
    return JE.build_ensemble(model, jax_vars, NAMES, generic_head=True)


def _port_ensemble(je):
    return from_jax.ensemble_from_variables(
        jax.tree_util.tree_map(np.asarray, je.variables), je.class_names,
        generic_head=je.generic_head)


@pytest.mark.parametrize("layout", ["shared", "dense", "generic"])
def test_ensemble_matches_jax(jax_vars, images, layout):
    """Shared backbone, dense, and dense with a generic head (independent
    classifiers, so each sub-model's forward is held against flax)."""
    je = _jax_ensemble(jax_vars, layout)
    te = _port_ensemble(je)
    assert te.shared_backbone == je.shared_backbone == (layout == "shared")
    assert te.num_heads == je.num_heads
    ref_nh = JE.ensemble_per_head_logits(je, jnp.asarray(images[1]))
    ref = np.asarray(JE._aggregate(ref_nh))
    got = te(nchw(images[1])).numpy()
    assert got.shape == ref.shape == (2, je.num_heads + 1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    per_head = TE.ensemble_per_head_logits(te, nchw(images[1])).numpy()
    np.testing.assert_allclose(per_head, np.asarray(ref_nh), rtol=0, atol=1e-4)


@pytest.mark.parametrize("layout", ["shared", "dense"])
def test_fold_to_mono_gives_equal_logits(jax_vars, images, layout):
    """Summing conv1 over its input axis is exact up to float32 rounding of
    the three-term sum (1e-5)."""
    te = _port_ensemble(_jax_ensemble(jax_vars, layout))
    mono = TE.fold_to_mono(te)
    assert mono.in_channels == 1 and te.in_channels == 3
    np.testing.assert_allclose(mono(nchw(images[0])).numpy(), te(nchw(images[1])).numpy(),
                               rtol=0, atol=1e-5)


def test_fast_backbone_matches_module(jax_vars, images):
    """The reference's _conv_bn arithmetic against the module's BN: float32
    rounding (1e-4); in bf16 the logits move by bf16 activation rounding
    (0.05)."""
    te = _port_ensemble(_jax_ensemble(jax_vars, "shared"))
    x = nchw(images[1])
    ref = TE.ensemble_per_head_logits(te, x)
    fast = TE.ensemble_per_head_logits(te, x, fast_backbone=True)
    np.testing.assert_allclose(fast.numpy(), ref.numpy(), rtol=0, atol=1e-4)
    bf = TE.with_dtype(te, torch.bfloat16)
    for fb in (False, True):
        got = TE.ensemble_per_head_logits(bf, x, fast_backbone=fb)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), ref.numpy(), rtol=0, atol=0.05)


def test_stacked_heads_match_head_modules(jax_vars):
    """BN folded into the Linear weights: float32 rounding only (1e-5)."""
    te = _port_ensemble(_jax_ensemble(jax_vars, "generic"))
    feats = torch.from_numpy(np.random.default_rng(8).standard_normal((5, 512, 2, 2))
                             .astype(np.float32))
    pooled = feats.mean(dim=(2, 3)).expand(te.num_heads, -1, -1)
    got = TE.heads_forward(te.stacked_heads(), pooled)
    with torch.no_grad():
        ref = torch.stack([h(feats) for h in te.heads])
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5)


def test_from_jax_round_trips_through_reference_key_map(jax_vars):
    sd = from_jax.classifier_state_dict(jax_vars[0])
    back = classifier_variables_from_torch({k: v.numpy() for k, v in sd.items()},
                                           base_prefix="base.")
    flat_a = jax.tree_util.tree_leaves_with_path(jax_vars[0])
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf)


@pytest.mark.parametrize("layout", ["shared", "dense", "generic"])
def test_jax_written_pth_loads_into_port(jax_vars, tmp_path, layout):
    je = _jax_ensemble(jax_vars, layout)
    je.calibration = {"temperatures": [1.5] * (je.num_heads + 1), "threshold": 0.4}
    path = str(tmp_path / "merged.pth")
    jax_ser.save_merged_torch(path, je)
    te = ser.load_merged_torch(path)
    assert te.class_names == je.class_names
    assert te.generic_head == je.generic_head
    assert te.shared_backbone == je.shared_backbone
    assert te.calibration == je.calibration
    ref = _port_ensemble(je)
    for a, b in zip(te.classifier_state_dicts(), ref.classifier_state_dicts()):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k].float(), b[k].float()), k


def test_port_written_pth_loads_into_jax(jax_vars, tmp_path):
    te = _port_ensemble(_jax_ensemble(jax_vars, "generic"))
    path = str(tmp_path / "merged.pth")
    ser.save_merged_torch(path, te)
    je = jax_ser.load_merged_torch(path)
    assert je.class_names == te.class_names and je.generic_head
    for i, sd in enumerate(te.classifier_state_dicts()):
        ref = classifier_variables_from_torch({k: v.numpy() for k, v in sd.items()},
                                              base_prefix="base.")
        got = jax.tree_util.tree_map(lambda a: np.asarray(a)[i], je.variables)
        for (p, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(ref),
                                  jax.tree_util.tree_leaves_with_path(got)):
            np.testing.assert_array_equal(a, b, err_msg=str(p))


def test_load_merged_rejects_non_pth(tmp_path):
    path = tmp_path / "merged.msgpack"
    path.write_bytes(b"\x80\x00")
    with pytest.raises(ValueError, match="msgpack"):
        ser.load_merged(str(path))


def test_backbone_detection_and_generic_count(jax_vars):
    sds = [from_jax.classifier_state_dict(v) for v in jax_vars]
    assert TE.backbones_identical([sds[0], dict(sds[0])])
    assert not TE.backbones_identical(sds[:2])
    assert TE.build_ensemble([sds[0], sds[0]], NAMES).shared_backbone
    assert not TE.build_ensemble([sds[0], sds[0]], NAMES,
                                 detect_shared_backbone=False).shared_backbone
    with pytest.raises(ValueError, match="generic-head"):
        TE.build_ensemble(sds[:2], NAMES, generic_head=True)


def test_decide_and_labels_match_jax():
    logits = np.random.default_rng(9).standard_normal((16, 3)).astype(np.float32) * 3
    got = TE.decide(torch.from_numpy(logits), 0.5)
    ref = JE.decide(jnp.asarray(logits), 0.5)
    np.testing.assert_array_equal(got["label_idx"].numpy(), np.asarray(ref["label_idx"]))
    np.testing.assert_array_equal(got["is_real"].numpy(), np.asarray(ref["is_real"]))
    idx = [0, 1, 2, 5]
    assert (TE.labels_from_indices(idx, ["A", "B"], "Real")
            == JE.labels_from_indices(np.asarray(idx), ["A", "B"], "Real"))


def test_backbone_detection_uses_reference_tolerance(jax_vars):
    """Both packages call backbones "identical" within rtol 1e-5 (the JAX
    package's np.allclose(atol=0)), so both pick the same layout: a
    relative 1e-6 nudge stays shared, 1e-3 does not."""
    base = jax_vars[0]
    for rel, same in ((1e-6, True), (1e-3, False)):
        nudged = jax.tree_util.tree_map(np.copy, base)
        kernel = nudged["params"]["base"]["conv1"]["kernel"]
        kernel *= np.float32(1 + rel)
        assert JE.backbones_identical([base, nudged]) is same
        port = [from_jax.classifier_state_dict(v) for v in (base, nudged)]
        assert TE.backbones_identical(port) is same
