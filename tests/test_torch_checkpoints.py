"""The port's checkpoint formats and trunk-shared ensembles against the JAX
package, on the CPU: the msgpack codec both ways against flax's, the
native merged file both ways, the trainer's ``.pth`` contract both ways,
``trunk_shared_stages`` for K = 0..3, and the shared-trunk logits against
JAX's ensemble forward (float32, 1e-4 absolute on logits of O(1), the
bound of tests/test_torch_models.py: only the summation order differs).
"""

import functools
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from flax import serialization as flax_ser

from synthetic_audio_detection_tpu.checkpoints import serialization as JS
from synthetic_audio_detection_tpu.checkpoints.torch_compat import (
    classifier_variables_from_torch,
)
from synthetic_audio_detection_tpu.ensemble import multihead as JE
from synthetic_audio_detection_tpu.models.classifier import BinaryClassifier as JaxClassifier
from synthetic_audio_detection_tpu_torch.checkpoints import msgpack_io
from synthetic_audio_detection_tpu_torch.checkpoints import serialization as TS
from synthetic_audio_detection_tpu_torch.ensemble import multihead as TE
from synthetic_audio_detection_tpu_torch.models.classifier import BinaryClassifier

NAMES = ["SynA", "SynB", "SynC", "Real"]
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module's CPU work, restored after: the
    suite runs several workers on one machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _drop_files(tmp_path):
    """Checkpoints here are hundreds of MB: remove each test's files after
    it, so the suite's temporary directories stay small."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _sd(seed):
    """A classifier state dict with seeded weights and BN statistics (a new
    dict over shared tensors, which the tests replace but never write)."""
    return dict(_seeded_sd(seed))


@functools.lru_cache(maxsize=None)
def _seeded_sd(seed):
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        model = BinaryClassifier()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=g))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=g))
    return {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}


def _trunk_shared(k, n=3):
    """n state dicts that agree on the stem and stages 1..4−k and differ in
    the last k stages and the heads."""
    sds = [_sd(10 + i) for i in range(n)]
    for sd in sds[1:]:
        for key, v in sds[0].items():
            stage = int(key.split(".")[1][len("layer"):]) if key.startswith("base.layer") else 0
            if key.startswith("base.") and stage <= 4 - k:
                sd[key] = v.clone()
    return sds


def _jax_vars(sd):
    return classifier_variables_from_torch({k: v.numpy() for k, v in sd.items()},
                                           base_prefix="base.")


@pytest.fixture(scope="module")
def images():
    x = np.random.default_rng(7).standard_normal((2, 64, 64, 3)).astype(np.float32)
    return x, torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


# ---------------------------------------------------------------------------
# msgpack
# ---------------------------------------------------------------------------

def _tree():
    rng = np.random.default_rng(0)
    return {"tree": {"a": rng.standard_normal((2, 3)).astype(np.float32),
                     "b": {"c": np.int32(7), "d": np.zeros((0, 4), np.int64),
                           "e": np.arange(5, dtype=np.uint8), "f": np.float64(2.5)},
                     "empty": {}},
            "metadata": {"class_names": ["A", "Bé"], "x": 1.5, "n": None, "t": True,
                         "big": 2 ** 40, "neg": -70, "neg_big": -2 ** 40, "s": "x" * 300,
                         "long": list(range(40)), "blob": b"\x00\x01" * 200}}


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (np.ndarray, np.generic)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b and type(a) is type(b), (a, b)


def test_msgpack_port_writes_flax_reads():
    tree = _tree()
    _assert_tree_equal(flax_ser.msgpack_restore(msgpack_io.packb(tree)), tree)


def test_msgpack_flax_writes_port_reads():
    tree = _tree()
    _assert_tree_equal(msgpack_io.unpackb(flax_ser.msgpack_serialize(tree)), tree)


def test_msgpack_chunked_arrays_both_ways(monkeypatch):
    """flax's chunked form for arrays over MAX_CHUNK_SIZE, at a small limit
    on both sides."""
    monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(msgpack_io, "MAX_CHUNK_SIZE", 64)
    tree = {"w": np.arange(100, dtype=np.float32).reshape(4, 25), "small": np.ones(3)}
    _assert_tree_equal(msgpack_io.unpackb(flax_ser.msgpack_serialize(tree)), tree)
    _assert_tree_equal(flax_ser.msgpack_restore(msgpack_io.packb(tree)), tree)


def test_msgpack_rejects_what_it_cannot_write():
    with pytest.raises(TypeError):
        msgpack_io.packb({"x": object()})
    with pytest.raises(ValueError):
        msgpack_io.unpackb(msgpack_io.packb([1]) + b"\x00")


# ---------------------------------------------------------------------------
# Trunk-shared ensembles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_trunk_shared_stages_matches_jax(k):
    sds = _trunk_shared(k) if k else [_sd(20 + i) for i in range(3)]
    got = TE.trunk_shared_stages(sds)
    assert got == JE.trunk_shared_stages([_jax_vars(sd) for sd in sds]) == k
    ens = TE.build_ensemble(sds, NAMES)
    assert ens.shared_trunk_stages == k and not ens.shared_backbone
    assert (ens.trunk is not None) == bool(k)


def test_trunk_detection_uses_reference_tolerance():
    """A trunk that differs by a relative 1e-6 still counts as shared in both
    packages (np.allclose's default rtol, the pinned quirk)."""
    sds = _trunk_shared(1)
    sds[1]["base.conv1.weight"] = sds[1]["base.conv1.weight"] * (1 + 1e-6)
    assert TE.trunk_shared_stages(sds) == JE.trunk_shared_stages(
        [_jax_vars(sd) for sd in sds]) == 1
    sds[1]["base.conv1.weight"] = sds[1]["base.conv1.weight"] * (1 + 1e-3)
    assert TE.trunk_shared_stages(sds) == JE.trunk_shared_stages(
        [_jax_vars(sd) for sd in sds]) == 0


@pytest.mark.parametrize("k", [1, 2])
def test_shared_trunk_logits_match_jax(images, k):
    x_nhwc, x_nchw = images
    sds = _trunk_shared(k)
    je = JE.build_ensemble(JaxClassifier(), [_jax_vars(sd) for sd in sds], NAMES)
    assert je.shared_trunk_stages == k
    want = np.asarray(JE.ensemble_forward(je, x_nhwc))
    te = TE.build_ensemble(sds, NAMES)
    dense = TE.build_ensemble(sds, NAMES, detect_shared_backbone=False)
    assert te.shared_trunk_stages == k and dense.shared_trunk_stages == 0
    passes = []
    te.trunk.register_forward_hook(lambda *_: passes.append(1))
    got = te(x_nchw).numpy()
    assert len(passes) == 1  # the trunk runs once for the N heads
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(dense(x_nchw).numpy(), got, atol=TOL, rtol=0)
    # the per-sub-model state dicts put trunk and tail back together
    for sd, back in zip(sds, te.classifier_state_dicts()):
        assert sd.keys() == {k for k in back if not k.endswith("num_batches_tracked")}
        for key in sd:
            torch.testing.assert_close(back[key], sd[key], rtol=0, atol=0)


def test_shared_trunk_mono_fold(images):
    x = images[1][:, :1].expand(-1, 3, -1, -1)  # the serving input: one plane, three times
    te = TE.build_ensemble(_trunk_shared(1), NAMES)
    want = te(x)
    mono = TE.fold_to_mono(te)
    assert mono.in_channels == 1 and mono.shared_trunk_stages == 1
    torch.testing.assert_close(mono(x[:, :1]), want, atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# Native merged files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["shared", "trunk", "dense"])
def test_native_merged_port_writes_jax_reads(tmp_path, images, layout):
    x_nhwc, x_nchw = images
    sds = {"shared": [_sd(1)] * 3, "trunk": _trunk_shared(1),
           "dense": [_sd(30 + i) for i in range(3)]}[layout]
    te = TE.build_ensemble(sds, NAMES, calibration={"temperatures": [1.0, 2.0, 0.5, 1.5]})
    path = str(tmp_path / "merged.msgpack")
    TS.save_merged_native(path, te)
    je = JS.load_merged(path)
    assert je.shared_backbone == te.shared_backbone
    assert je.shared_trunk_stages == te.shared_trunk_stages
    assert je.calibration == te.calibration
    np.testing.assert_allclose(te(x_nchw).numpy(), np.asarray(JE.ensemble_forward(je, x_nhwc)),
                               atol=TOL, rtol=0)
    back = TS.load_merged(path)  # and the port reads its own file
    assert back.shared_trunk_stages == te.shared_trunk_stages
    torch.testing.assert_close(back(x_nchw), te(x_nchw), rtol=0, atol=0)


@pytest.mark.parametrize("generic", [False, True])
def test_native_merged_jax_writes_port_reads(tmp_path, images, generic):
    x_nhwc, x_nchw = images
    sds = _trunk_shared(2, n=4 if generic else 3)
    je = JE.build_ensemble(JaxClassifier(), [_jax_vars(sd) for sd in sds], NAMES[:3] + ["Real"]
                           if not generic else ["SynA", "SynB", "SynC", "Real"],
                           generic_head=generic)
    path = str(tmp_path / "merged.msgpack")
    JS.save_merged_native(path, je)
    te = TS.load_merged(path)
    assert te.generic_head == generic and te.shared_trunk_stages == 2
    np.testing.assert_allclose(te(x_nchw).numpy(), np.asarray(JE.ensemble_forward(je, x_nhwc)),
                               atol=TOL, rtol=0)


def test_torch_merged_trunk_file_loads_trunk_shared_in_both(tmp_path, images):
    x_nhwc, x_nchw = images
    te = TE.build_ensemble(_trunk_shared(1), NAMES)
    path = str(tmp_path / "merged.pth")
    TS.save_merged_torch(path, te)
    je = JS.load_merged(path)
    back = TS.load_merged(path)
    assert je.shared_trunk_stages == back.shared_trunk_stages == 1
    np.testing.assert_allclose(back(x_nchw).numpy(), np.asarray(JE.ensemble_forward(je, x_nhwc)),
                               atol=TOL, rtol=0)


def test_generic_flag_dropped_on_name_mismatch_as_in_reference(tmp_path):
    """The reference's load_merged_torch drops the generic_head flag when
    the class-name count does not fit (a known fault of the reference,
    serialization.py:141); the port keeps it, so both packages read such a
    file the same way. The names fall back to Synthetic_i + Real."""
    sds = [_sd(40 + i) for i in range(3)]
    te = TE.build_ensemble(sds, ["SynA", "SynB", "Real"], generic_head=True)
    path = str(tmp_path / "merged.pth")
    TS.save_merged_torch(path, te)
    obj = torch.load(path, weights_only=True)
    obj["metadata"]["class_names"] = ["SynA", "Real"]  # count no longer fits
    torch.save(obj, path)
    je, back = JS.load_merged(path), TS.load_merged(path)
    assert je.generic_head is back.generic_head is False
    assert je.class_names == back.class_names == ["Synthetic_1", "Synthetic_2", "Synthetic_3",
                                                  "Real"]


# ---------------------------------------------------------------------------
# Trainer .pth contract
# ---------------------------------------------------------------------------

def test_submodel_pth_port_writes_jax_reads(tmp_path):
    sd = {k: v.numpy() for k, v in _sd(3).items()}
    opt = {"state": {0: {"step": np.asarray(3.0, np.float32),
                         "exp_avg": np.ones((2, 2), np.float32)}},
           "param_groups": [{"lr": 1e-3, "betas": (0.9, 0.999), "params": [0]}]}
    path = str(tmp_path / "sub.pth")
    TS.save_submodel_torch(path, sd, epoch=4, best_acc=0.75, total_steps=12,
                           scheduler={"scale": 0.5, "best": None}, layer3_unfrozen=True,
                           optimizer=opt)
    variables, extras = JS.load_submodel_torch(path)
    assert extras["epoch"] == 4 and extras["total_steps"] == 12 and extras["layer3_unfrozen"]
    assert extras["scheduler"] == {"scale": 0.5, "best": None}
    np.testing.assert_array_equal(np.asarray(extras["optimizer"]["state"][0]["exp_avg"]),
                                  np.ones((2, 2)))
    want = _jax_vars(_sd(3))
    for a, b in zip(jax.tree_util.tree_leaves(variables), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_submodel_pth_jax_writes_port_reads(tmp_path):
    sd = _sd(5)
    path = str(tmp_path / "sub.pth")
    JS.save_submodel_torch(path, _jax_vars(sd), epoch=2, best_acc=0.5, total_steps=9,
                           scheduler={"scale": 1.0}, layer3_unfrozen=False)
    got, extras = TS.load_submodel_torch(path)
    assert extras["epoch"] == 2 and extras["total_steps"] == 9 and extras["flavor"] == "classifier"
    assert extras["layer3_unfrozen"] is False and extras["scheduler"] == {"scale": 1.0}
    assert got.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(got[k], sd[k].numpy())


def test_cli_serves_native_merged_file(tmp_path):
    """The port's inference CLI on a native merged file, against the same
    ensemble from its .pth."""
    from synthetic_audio_detection_tpu_torch.audio import wavio
    from synthetic_audio_detection_tpu_torch.cli import inference_runner

    wav = str(tmp_path / "clip.wav")
    wavio.write_wav(wav, (np.random.default_rng(0).standard_normal(32_000 * 9) * 0.2)
                    .astype(np.float32), 32_000)
    te = TE.build_ensemble(_trunk_shared(1), NAMES)
    TS.save_merged_native(str(tmp_path / "m.msgpack"), te)
    TS.save_merged_torch(str(tmp_path / "m.pth"), te)
    outs = []
    for name in ("m.msgpack", "m.pth"):
        out = str(tmp_path / f"{name}.json")
        assert inference_runner.main(["--merged-model", str(tmp_path / name), "--audio", wav,
                                      "--input-size", "64", "--device", "cpu",
                                      "--output-json", out]) == 0
        outs.append(open(out).read())
    assert outs[0] == outs[1] and os.path.getsize(str(tmp_path / "m.msgpack.json")) > 0
