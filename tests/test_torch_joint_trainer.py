"""The port's JointTrainer and ensemble-trainer CLI on the CPU (ResNet-18 at
64², a tiny seeded split tree of 8-s PCM_16 WAVs: Real, SynA, SynB), and
its checkpoints against the JAX package's: the JAX JointTrainer resumes the
port's ``sad-tpu-joint-v1`` file and the port resumes JAX's, with weights,
BN statistics and Adam moments equal to the float32 bit (K = 0, and K = 1
with the generic head); the port's ``.merged.ckpt``/``.merged.pth`` load in
the JAX package with the port's logits (1e-4, tests/test_torch_checkpoints.py's
bound)."""

import inspect
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic_audio_detection_tpu.checkpoints import serialization as JSer
from synthetic_audio_detection_tpu.ensemble import multihead as JE
from synthetic_audio_detection_tpu.train import joint as JJ
from synthetic_audio_detection_tpu.train import steps as JS
from synthetic_audio_detection_tpu.utils.config import SpectrogramConfig as JSpec
from synthetic_audio_detection_tpu.utils.config import TrainConfig as JCfg
from synthetic_audio_detection_tpu_torch.checkpoints import serialization as TSer
from synthetic_audio_detection_tpu_torch.train.joint import JointTrainer
from synthetic_audio_detection_tpu_torch.utils.config import (
    SpecAugmentConfig,
    SpectrogramConfig,
    TrainConfig,
)

SPEC = SpectrogramConfig(out_size=64)
CLASSES = ["SynA", "SynB"]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _drop_files(tmp_path):
    """Checkpoints here are hundreds of MB: removed after each test."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def make_tree(root, n=1, seed=0, classes=("Real", "SynA", "SynB")):
    """train/ and test/ × ``classes``: n 8-s 32 kHz PCM_16 files each,
    class c a tone of 220·c Hz under noise (Real noise only)."""
    from synthetic_audio_detection_tpu_torch.audio import wavio

    rng = np.random.default_rng(seed)
    t = np.arange(8 * 32_000) / 32_000
    for split in ("train", "test"):
        for c, cls in enumerate(classes):
            os.makedirs(os.path.join(root, split, cls), exist_ok=True)
            for i in range(n):
                x = rng.standard_normal(t.size) * 0.1
                if c:
                    x = x + 0.3 * np.sin(2 * np.pi * 220 * c * (i + 1) * t)
                wavio.write_wav(os.path.join(root, split, cls, f"{cls}_{i}.wav"),
                                np.clip(x, -1, 1).astype(np.float32), 32_000)
    return root


def _batch(rows=4, seed=1):
    rng = np.random.default_rng(seed)
    return {"audio": torch.from_numpy((rng.standard_normal((rows, 32_000)) * 0.2)
                                      .astype(np.float32)),
            "label": torch.tensor([0, 1, 2, 1][:rows]), "weight": torch.ones(rows)}


def _port_trainer(tmp_path, k, generic, **cfg):
    return JointTrainer(TrainConfig(batch_size=2, **cfg), CLASSES, spec_cfg=SPEC,
                        augment=SpecAugmentConfig(enabled=False), log_dir=str(tmp_path / "runs"),
                        per_head_stages=k, generic_head=generic, device="cpu")


def _jitted_init(monkeypatch):
    """The JAX trainer's initial state through a jitted init_joint_state
    (the same function; its eager call takes several times as long)."""
    eager = JJ.init_joint_state

    def init(model_name, num_heads, rng, cfg, input_hw, dtype=jnp.float32, per_head_stages=0):
        state = jax.jit(lambda r: eager(model_name, num_heads, r, cfg, input_hw, dtype,
                                        per_head_stages)[0])(rng)
        return state, JS.make_optimizer(cfg)

    monkeypatch.setattr(JJ, "init_joint_state", init)


def _jax_trainer(tmp_path, k, generic, **cfg):
    return JJ.JointTrainer(JCfg(batch_size=2, **cfg), CLASSES, spec_cfg=JSpec(out_size=64),
                           log_dir=str(tmp_path / "jruns"), use_mesh=False, per_head_stages=k,
                           generic_head=generic)


def _jax_named(jt):
    return TSer.joint_named(jax.tree_util.tree_map(np.asarray, jt.variables()))


def _jax_moments(jt):
    count, mu, nu = JS.extract_adam_state(jt.state.opt_state)
    as_named = lambda t: TSer.joint_named({"params": jax.tree_util.tree_map(np.asarray, t)})  # noqa
    return count, as_named(mu), as_named(nu)


def _port_moments(tr):
    mu, nu = tr.state.moments()
    return ({k: v.numpy() for k, v in mu.items()}, {k: v.numpy() for k, v in nu.items()})


def test_new_entry_points_default_to_cuda():
    """JointTrainer, HeadAdder, merge_models and the three CLIs run on the
    card unless asked for the CPU; without CUDA the default raises."""
    from synthetic_audio_detection_tpu_torch.cli import add_head, ensemble_trainer, model_merger
    from synthetic_audio_detection_tpu_torch.ensemble.merger import merge_models
    from synthetic_audio_detection_tpu_torch.train.add_head import HeadAdder

    for fn in (JointTrainer, HeadAdder, merge_models):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    required = {ensemble_trainer: ["--synthetic-classes", "A"],
                add_head: ["--merged-model", "m", "--new-class", "C", "--output", "o"],
                model_merger: ["--submodels-folder", "f", "--csv-file", "c", "--output-path", "o"]}
    for cli, argv in required.items():
        assert cli.build_parser().parse_args(argv).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        JointTrainer(TrainConfig(), CLASSES, spec_cfg=SPEC)


@pytest.mark.parametrize("k,generic", [(0, False), (1, True)], ids=["K0", "K1-generic"])
def test_checkpoints_resume_both_ways(tmp_path, monkeypatch, k, generic):
    """The port's checkpoint → the JAX JointTrainer (weights, BN
    statistics, count and moments bit-equal; epoch, phase, scheduler, best
    accuracy); then JAX's checkpoint of other moments → the port."""
    tr = _port_trainer(tmp_path, k, generic)
    tr._train_step(tr.state, _batch(), torch.Generator().manual_seed(0))
    tr._unfreeze()
    tr._train_step(tr.state, _batch(seed=2), torch.Generator().manual_seed(1))
    tr.best_acc = 0.5
    tr.plateau.update(0.7)
    path = str(tmp_path / "port.ckpt")
    tr.save_checkpoint(2, path)
    assert os.path.exists(path + ".merged.ckpt") and os.path.exists(path + ".merged.pth")

    _jitted_init(monkeypatch)
    jt = _jax_trainer(tmp_path, k, generic, resume=path)
    assert jt.start_epoch == 3 and jt.layer3_unfrozen and jt.best_acc == 0.5
    assert jt.plateau.state_dict() == tr.plateau.state_dict() and int(jt.state.step) == 2
    want = tr.named_state()
    got = _jax_named(jt)
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    count, mu, nu = _jax_moments(jt)
    pmu, pnu = _port_moments(tr)
    assert count == int(tr.state.count) == 2
    for n in pmu:
        np.testing.assert_array_equal(mu[n], pmu[n], err_msg=n)
        np.testing.assert_array_equal(nu[n], pnu[n], err_msg=n)

    # JAX writes, with moments of its own, and the port resumes
    rng = np.random.default_rng(4)
    rand = lambda t, s: jax.tree_util.tree_map(  # noqa: E731
        lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(np.float32) * s), t)
    jt.state = jt.state.replace(
        opt_state=JS.replace_adam_state(jt.state.opt_state, 9, rand(jt.state.params, 1e-3),
                                        jax.tree_util.tree_map(jnp.abs,
                                                               rand(jt.state.params, 1e-6))),
        step=jnp.asarray(9, jnp.int32))
    jt.best_acc = 0.75
    jpath = str(tmp_path / "jax.ckpt")
    jt.save_checkpoint(4, jpath)
    res = _port_trainer(tmp_path, k, generic, resume=jpath)
    assert res.start_epoch == 5 and res.layer3_unfrozen and res.best_acc == 0.75
    assert int(res.state.step) == 9 and int(res.state.count) == 9
    assert res.plateau.state_dict() == jt.plateau.state_dict()
    want, (count, mu, nu) = _jax_named(jt), _jax_moments(jt)
    got = res.named_state()
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    pmu, pnu = _port_moments(res)
    for n in mu:
        np.testing.assert_array_equal(pmu[n], mu[n], err_msg=n)
        np.testing.assert_array_equal(pnu[n], nu[n], err_msg=n)

    # the merged artifacts: the layout JAX detects, and the port's logits
    x = np.random.default_rng(5).standard_normal((2, 64, 64, 3)).astype(np.float32)
    want_logits = tr.to_ensemble()(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    for suffix in (".merged.ckpt", ".merged.pth"):
        je = JSer.load_merged(path + suffix)
        assert je.shared_backbone == (k == 0) and je.shared_trunk_stages == k
        assert je.generic_head == generic and list(je.class_names) == CLASSES + ["Real"]
        np.testing.assert_allclose(np.asarray(JE.ensemble_forward(je, jnp.asarray(x))),
                                   want_logits, atol=1e-4, rtol=0, err_msg=suffix)


def test_to_ensemble_shares_the_trunk_exactly(tmp_path):
    """K = 0: every head references the same base tensors, so the serving
    ensemble has one backbone; K = 1: the trunk-shared layout, one trunk
    and a layer4 per head, with the trainer's weights."""
    for k in (0, 1):
        tr = _port_trainer(tmp_path, k, False)
        ens = tr.to_ensemble()
        assert ens.shared_backbone == (k == 0) and ens.shared_trunk_stages == k
        assert len(ens.backbones) == (1 if k == 0 else 2)
        sds = ens.classifier_state_dicts()
        for i, head in enumerate(tr.model.heads):
            mlp = head.mlp if k else head
            for name, v in mlp.state_dict().items():
                assert torch.equal(sds[i][f"head.{name}"], v), name
        base = tr.model.base.state_dict()
        assert all(torch.equal(sds[1][f"base.{n}"], v) for n, v in base.items())


def test_resume_refuses_another_layout(tmp_path):
    tr = _port_trainer(tmp_path, 0, False)
    path = str(tmp_path / "k0.ckpt")
    tr.save_checkpoint(0, path)
    with pytest.raises(ValueError, match="per_head_stages=0"):
        _port_trainer(tmp_path, 1, False, resume=path)
    with pytest.raises(ValueError, match="generic_head=False"):
        _port_trainer(tmp_path, 0, True, resume=path)
    TSer.save_native(str(tmp_path / "other.ckpt"), {"x": np.zeros(1)}, metadata={"epoch": 0})
    with pytest.raises(ValueError, match="not a joint-trainer checkpoint"):
        _port_trainer(tmp_path, 0, False, resume=str(tmp_path / "other.ckpt"))


def test_fit_saves_on_a_strictly_better_ensemble_accuracy(tmp_path, monkeypatch):
    """fit: rows per step are 2 × batch_size, padded (3 files of 2 rows in
    batches of 2 files: a full step and one with 2 zero rows weighted 0);
    layer3 unfreezes at epochs // 3; a checkpoint only when the ensemble
    accuracy beats the best so far (strictly: a tie keeps the earlier
    epoch, as the reference's joint trainer)."""
    from synthetic_audio_detection_tpu_torch.train import joint as port_joint

    data = make_tree(str(tmp_path / "data"))
    tr = _port_trainer(tmp_path, 0, False, data_dir=data, epochs=3, workers=1,
                       checkpoint_dir=str(tmp_path / "ck"))
    accs = iter([0.5, 0.5, 0.75])
    saved, rows = [], []
    validate = port_joint.JointTrainer.validate
    step = tr._train_step

    def fake_validate(self, batcher, epoch):
        res = validate(self, batcher, epoch)
        res.ensemble_acc = next(accs)
        return res

    def counting_step(state, batch, generator):
        rows.append((batch["audio"].shape[0], float(batch["weight"].sum())))
        return step(state, batch, generator)

    monkeypatch.setattr(port_joint.JointTrainer, "validate", fake_validate)
    monkeypatch.setattr(tr, "save_checkpoint", lambda epoch, path: saved.append(epoch))
    monkeypatch.setattr(tr, "_build_train_step", lambda: counting_step)
    tr._train_step = counting_step
    assert tr.fit() == 0.75
    assert saved == [0, 2] and tr.layer3_unfrozen
    assert tr.train_steps_run == 6 and tr.eval_steps_run == 6
    assert sorted(set(rows)) == [(4, 2.0), (4, 4.0)]


def test_cli_trains_resumes_and_serves_on_cpu(tmp_path):
    """The CLI fits K = 0 for 2 epochs, resumes to 3, and its merged .pth
    serves through the inference CLI (a window a segment); then K = 1 with
    the generic head, whose native artifact serves as a trunk-shared
    ensemble."""
    from synthetic_audio_detection_tpu_torch.cli import ensemble_trainer, inference_runner

    data = make_tree(str(tmp_path / "data"))
    common = ["--data-dir", data, "--synthetic-classes", *CLASSES, "--batch-size", "2",
              "--input-size", "64", "--device", "cpu", "--workers", "1",
              "--log-dir", str(tmp_path / "runs")]
    wav = os.path.join(data, "test", "SynA", "SynA_0.wav")
    cwd = os.getcwd()
    os.chdir(tmp_path)  # the CLIs write logs/ where they run
    try:
        assert ensemble_trainer.main(common + ["--epochs", "2", "--checkpoint-dir", "ck"]) == 0
        saved = TSer.load_native("ck/joint_model.ckpt")[1]
        assert saved["format"] == "sad-tpu-joint-v1" and saved["num_heads"] == 2
        assert ensemble_trainer.main(common + ["--epochs", "3", "--checkpoint-dir", "ck2",
                                               "--resume", "ck/joint_model.ckpt"]) == 0
        assert ensemble_trainer.main(common + ["--epochs", "1", "--checkpoint-dir", "ck3",
                                               "--per-head-stages", "1", "--generic-head",
                                               "--no-hard-negatives"]) == 0
        for model in ("ck/joint_model.ckpt.merged.pth", "ck3/joint_model.ckpt.merged.ckpt"):
            assert inference_runner.main(["--merged-model", model, "--audio", wav,
                                          "--input-size", "64", "--device", "cpu",
                                          "--output-json", "out.json"]) == 0
            with open("out.json") as f:
                out = json.load(f)
            assert len(out["segments"]) == 2
            assert set(out["percentages"]) <= set(CLASSES + ["Real"])
        assert TSer.load_merged("ck3/joint_model.ckpt.merged.ckpt").shared_trunk_stages == 1
    finally:
        os.chdir(cwd)


def test_training_keeps_the_reference_mel_norm_mismatch(monkeypatch, tmp_path):
    """The joint trainer and add-head train without a mel norm (the
    reference serves with slaney): the defaults and the CLIs' configs."""
    from synthetic_audio_detection_tpu_torch.cli import add_head, ensemble_trainer
    from synthetic_audio_detection_tpu_torch.train import add_head as add_head_mod
    from synthetic_audio_detection_tpu_torch.train import joint as joint_mod

    assert _port_trainer(tmp_path, 0, False).spec_cfg.mel_norm is None
    seen = {}

    class Capture:
        def __init__(self, *a, spec_cfg=None, **kw):
            seen[len(seen)] = spec_cfg

        def fit(self, *a):
            return 0.0

        def spliced(self):
            raise SystemExit(0)

    monkeypatch.setattr(joint_mod, "JointTrainer", Capture)
    monkeypatch.setattr(add_head_mod, "HeadAdder", Capture)
    monkeypatch.setattr(TSer, "load_merged", lambda *a, **kw: None)
    monkeypatch.chdir(tmp_path)
    assert ensemble_trainer.main(["--synthetic-classes", "A", "--input-size", "native",
                                  "--device", "cpu"]) == 0
    with pytest.raises(SystemExit):
        add_head.main(["--merged-model", "m", "--new-class", "C", "--output", "o",
                       "--device", "cpu"])
    assert [s.mel_norm for s in seen.values()] == [None, None]
    assert seen[0].out_size == 0 and seen[1].out_size == 512
    assert SpectrogramConfig.inference().mel_norm == "slaney"
