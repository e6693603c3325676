"""The port's Trainer and trainer CLI on the CPU (ResNet-18 at 64², a tiny
seeded split tree of 8-s PCM_16 WAVs, 2 files = 4 rows a step), and its
checkpoints against the JAX package's: each package resumes from the
other's ``.pth`` twin and native file with the weights and the Adam moments
equal to the float32 bit, and the port resumes from a genuine torch AdamW
checkpoint of the reference trainer's contract."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import parity_bounds
import pytest
import torch

from synthetic_audio_detection_tpu.checkpoints.torch_compat import torch_state_dict_from_variables
from synthetic_audio_detection_tpu.train import steps as JS
from synthetic_audio_detection_tpu.train.trainer import Trainer as JaxTrainer
from synthetic_audio_detection_tpu.utils.config import SpectrogramConfig as JSpec
from synthetic_audio_detection_tpu.utils.config import TrainConfig as JCfg
from synthetic_audio_detection_tpu_torch.audio import wavio
from synthetic_audio_detection_tpu_torch.checkpoints import serialization as TSer
from synthetic_audio_detection_tpu_torch.train import steps
from synthetic_audio_detection_tpu_torch.train.trainer import Trainer
from synthetic_audio_detection_tpu_torch.utils.config import SpectrogramConfig, TrainConfig

SPEC = SpectrogramConfig(out_size=64)


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


def make_tree(root, n=2, seed=0):
    """train/ and test/ × Real, SynthA: n 8-s 32 kHz PCM_16 files each (a
    tone in SynthA), and one 1-s file in train/Real that the short-file
    policy drops."""
    rng = np.random.default_rng(seed)
    t = np.arange(8 * 32_000) / 32_000
    for split in ("train", "test"):
        for c, cls in enumerate(("Real", "SynthA")):
            os.makedirs(os.path.join(root, split, cls), exist_ok=True)
            for i in range(n):
                x = rng.standard_normal(t.size) * 0.1
                if c:
                    x = x + 0.3 * np.sin(2 * np.pi * 440 * (i + 1) * t)
                wavio.write_wav(os.path.join(root, split, cls, f"{cls}_{i}.wav"),
                                np.clip(x, -1, 1).astype(np.float32), 32_000)
    wavio.write_wav(os.path.join(root, "train", "Real", "short.wav"),
                    np.zeros(32_000, np.float32), 32_000)
    return root


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A port Trainer fitted for 2 epochs (layer3 unfreezes at epoch 0)."""
    root = str(tmp_path_factory.mktemp("sad"))
    make_tree(os.path.join(root, "data"))
    cfg = TrainConfig(data_dir=os.path.join(root, "data"), batch_size=2, epochs=2, workers=2,
                      checkpoint_dir=os.path.join(root, "ck"), class1="SynthA", seed=3)
    tr = Trainer(cfg, spec_cfg=SPEC, log_dir=os.path.join(root, "runs"), device="cpu")
    best = tr.fit()
    assert 0.0 < best <= 1.0
    yield tr, root, os.path.join(root, "ck", "best_model.ckpt")
    shutil.rmtree(root, ignore_errors=True)


def _moments(tr):
    mu, nu = tr.state.moments()
    return ({k: v.numpy().copy() for k, v in mu.items()},
            {k: v.numpy().copy() for k, v in nu.items()})


def test_trainer_defaults_to_cuda():
    import inspect

    assert inspect.signature(Trainer).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(TrainConfig(), spec_cfg=SPEC)


def test_trainer_refuses_what_is_not_ported():
    """The orbax backend is ported (tests/test_torch_orbax_io.py), and an
    unknown backend is refused."""
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        Trainer(TrainConfig(checkpoint_backend="msgpack"), spec_cfg=SPEC, device="cpu")
    assert Trainer(TrainConfig(checkpoint_backend="orbax"), spec_cfg=SPEC,
                   device="cpu").checkpointer is None


def _s2d_and_plain_steps(tmp_path, s2d_h=None, s2d_loss=None):
    """One train step at 512² of the plain model, of the s2d_stage1 model
    (its space_to_depth_h replaced by ``s2d_h``, and its cross-entropy by
    ``s2d_loss``, when given) and of the
    plain model in float64 (the same features and dropout draws; no
    backward, no update). → [(loss, state dict, μ, logits)] in that order,
    the number of s2d calls."""
    from synthetic_audio_detection_tpu_torch.ops import space_to_depth as s2d

    rng = np.random.default_rng(1)
    batch = {"audio": torch.from_numpy((rng.standard_normal((4, 32_000)) * 0.2).astype(
        np.float32)), "label": torch.tensor([0, 1, 1, 0]), "weight": torch.tensor([1., 1, 1, 0])}
    spec = SpectrogramConfig(out_size=512, mel_norm=None)
    calls, orig = [], s2d_h or s2d.space_to_depth_h
    cross_entropy = steps.cross_entropy

    def step(flag, float64=False):
        loss_fn = (s2d_loss if flag else None) or cross_entropy
        cfg = TrainConfig(s2d_stage1=flag, stop_grad_boundary=False, seed=3, batch_size=2)
        tr = Trainer(cfg, spec_cfg=spec, device="cpu", log_dir=str(tmp_path / "runs"))
        assert tr.model.base.s2d_stage1 is flag
        logits = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(steps, "cross_entropy", lambda z, *a, **kw: (
                logits.append(z.detach().double().numpy()), loss_fn(z, *a, **kw))[1])
            mp.setattr(s2d, "space_to_depth_h",
                       lambda x: (calls.append(tuple(x.shape)), orig(x))[1])
            if float64:
                tr.model.double()
                features = steps.features_from_waveforms
                mp.setattr(steps, "features_from_waveforms",
                           lambda *a, **kw: features(*a, **kw).double())
                mp.setattr(steps, "gradients", lambda loss, params, dtype: [None] * len(params))
                mp.setattr(steps, "apply_update_",
                           lambda state, grads, loss, *a, **kw: torch.isfinite(loss))
            m = tr._train_step(tr.state, batch, tr.generator)
        mu, _ = tr.state.moments()
        return (float(m["loss"]), tr.state_dict(), {k: v.numpy() for k, v in mu.items()},
                logits[0])

    return [step(False), step(True), step(False, float64=True)], calls


def _assert_s2d_within(plain, s2d_step, truth):
    """The s2d step's logits against the plain step's forward in float64,
    within reference_error_bound of the plain float32 step's error on them,
    and its loss within what its logits' own error explains
    (parity_bounds.assert_loss_within)."""
    parity_bounds.assert_within_reference(s2d_step[3], plain[3], truth[3],
                                          float(np.abs(truth[3]).max()), err_msg="logits")
    parity_bounds.assert_loss_within(s2d_step[0], truth[0], s2d_step[3], truth[3])


def test_s2d_stage1_step_equals_plain_step(tmp_path):
    """TrainConfig(s2d_stage1=True) at 512² (stage-1 height 128: the gate
    engages) with the full backward: one train step from the same seed on
    the same 4 rows as the plain model's. Float32 reassociation moves the
    gradients by up to about 0.5% of their norm (as much as a plain step in
    channels_last layout does; float64 is exact,
    tests/test_torch_space_to_depth.py), so: the logits against the plain
    step's forward in float64, within parity_bounds.reference_error_bound
    of the plain float32 step's error on them (the order of oneDNN's
    float32 sums follows the CPU's instruction set, and with it that
    error), and the loss within twice its logits' largest error (a
    cross-entropy over two classes moves by at most twice its largest
    logit's move) and its own rounding; every BN
    statistic to 1e-5, the Adam first moments to 2% of their norm (or of
    1% of the largest for a moment that is rounding only), the frozen
    weights equal and the trained ones within AdamW's 2·lr."""
    (plain, s2d_step, truth), calls = _s2d_and_plain_steps(tmp_path)
    assert calls == [(4, 64, 128, 128)]
    _assert_s2d_within(plain, s2d_step, truth)
    (_, sd_a, mu_a, _), (_, sd_b, mu_b, _) = plain, s2d_step
    top = max(np.linalg.norm(v) for v in mu_a.values())
    for k, v in mu_a.items():
        scale = max(np.linalg.norm(v), 1e-2 * top)
        assert np.linalg.norm(mu_b[k] - v) <= 2e-2 * scale, k
    for k, v in sd_a.items():
        if "running" in k:
            np.testing.assert_allclose(sd_b[k], v, rtol=1e-5, atol=1e-5, err_msg=k)
        elif k in mu_a:
            assert np.abs(sd_b[k] - v).max() <= 2 * TrainConfig().lr + 1e-6, k
        else:
            np.testing.assert_array_equal(sd_b[k], v, err_msg=k)


def test_s2d_bound_rejects_swapped_row_phases(tmp_path):
    """The s2d stage's two row phases swapped (channel (1 − py, c) for
    (py, c)): the float64-derived bound rejects it, as the fixed 1e-5 on
    the loss did."""
    from synthetic_audio_detection_tpu_torch.ops import space_to_depth as s2d

    real = s2d.space_to_depth_h
    swap = lambda x: torch.roll(real(x), x.shape[1], dims=1)  # noqa: E731
    (plain, s2d_step, truth), calls = _s2d_and_plain_steps(tmp_path, swap)
    assert calls == [(4, 64, 128, 128)]
    with pytest.raises(AssertionError, match="logits"):
        _assert_s2d_within(plain, s2d_step, truth)
    assert abs(s2d_step[0] - plain[0]) > 1e-5 * abs(plain[0])


def test_s2d_loss_check_rejects_zero_rows_in_the_denominator(tmp_path):
    """The s2d step's cross-entropy counting the row weighted 0 in its
    denominator (the loss at 3/4 of itself): its logits hold to their
    bound, and the loss check rejects it, as the fixed 1e-5 on the loss
    did."""
    ce = steps.cross_entropy
    (plain, s2d_step, truth), _ = _s2d_and_plain_steps(
        tmp_path, s2d_loss=lambda z, labels, weights=None, total=None: ce(
            z, labels, weights, torch.tensor(float(labels.shape[0]))))
    parity_bounds.assert_within_reference(s2d_step[3], plain[3], truth[3],
                                          float(np.abs(truth[3]).max()), err_msg="logits")
    with pytest.raises(AssertionError, match="loss"):
        _assert_s2d_within(plain, s2d_step, truth)
    assert abs(s2d_step[0] - plain[0]) > 1e-5 * abs(plain[0])


def test_fit_counts_steps_and_pads_batches(trained):
    """5 train files (one dropped) in batches of 2: 3 steps an epoch, the
    last batch 2 real rows and 2 zero rows weighted 0; 2 eval steps."""
    tr, _, path = trained
    assert tr.train_steps_run == 6 and int(tr.state.step) == 6
    assert tr.eval_steps_run == 4
    assert os.path.exists(path) and os.path.exists(path + ".pth")
    assert tr.layer3_unfrozen


@pytest.mark.parametrize("fmt", ["pth", "native"])
def test_port_resumes_from_its_own_checkpoint(trained, fmt):
    tr, root, path = trained
    saved = TSer.load_native(path)[1]
    res = Trainer(TrainConfig(resume=path + ".pth" if fmt == "pth" else path, batch_size=2,
                              class1="SynthA", epochs=2),
                  spec_cfg=SPEC, log_dir=os.path.join(root, "runs"), device="cpu")
    assert res.start_epoch == saved["epoch"] + 1
    assert res.layer3_unfrozen and res.plateau.state_dict() == saved["scheduler"]
    assert int(res.state.step) == saved["total_steps"]
    ref = TSer.load_native(path)[0]
    want = torch_state_dict_from_variables(ref["variables"])
    got = res.state_dict()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    count, mu, nu = TSer.adam_from_optax_state(ref["opt_state"])
    assert int(res.state.count) == count > 0
    gmu, gnu = _moments(res)
    for k in mu:
        if fmt == "native" or k.startswith(("base.layer4", "head.")):
            np.testing.assert_array_equal(gmu[k], mu[k])
            np.testing.assert_array_equal(gnu[k], nu[k])
        else:  # the .pth twin holds the phase-1 set only, as the reference's
            assert not gmu[k].any() and not gnu[k].any()


@pytest.mark.parametrize("fmt", ["pth", "native"])
def test_jax_resumes_from_port_checkpoint(trained, fmt):
    tr, root, path = trained
    jt = JaxTrainer(JCfg(resume=path + ".pth" if fmt == "pth" else path, batch_size=2,
                         class1="SynthA"),
                    spec_cfg=JSpec(out_size=64), log_dir=os.path.join(root, "runs"),
                    use_mesh=False)
    tree, meta = TSer.load_native(path)  # what the port saved
    assert jt.start_epoch == meta["epoch"] + 1 and jt.layer3_unfrozen
    got = torch_state_dict_from_variables(jax.tree_util.tree_map(np.asarray,
                                                                 jt.state.variables()))
    saved = torch_state_dict_from_variables(tree["variables"])
    for k in saved:
        np.testing.assert_array_equal(got[k], saved[k])
    count, mu, nu = JS.extract_adam_state(jt.state.opt_state)
    p_count, pmu, pnu = TSer.adam_from_optax_state(tree["opt_state"])
    assert count == p_count > 0
    as_sd = lambda t: torch_state_dict_from_variables(  # noqa: E731
        {"params": jax.tree_util.tree_map(np.asarray, t)})
    mu, nu = as_sd(mu), as_sd(nu)
    for k in pmu:
        if fmt == "native" or k.startswith(("base.layer4", "head.")):
            np.testing.assert_array_equal(mu[k], pmu[k])
            np.testing.assert_array_equal(nu[k], pnu[k])


@pytest.fixture(scope="module")
def jax_checkpoint(trained):
    """A JAX Trainer with nonzero moments on every leaf, saved in both
    formats at epoch 1, layer3 unfrozen."""
    _, root, _ = trained
    jt = JaxTrainer(JCfg(batch_size=2, class1="SynthA", seed=9), spec_cfg=JSpec(out_size=64),
                    log_dir=os.path.join(root, "runs"), use_mesh=False)
    rng = np.random.default_rng(4)
    rand = lambda t, s: jax.tree_util.tree_map(  # noqa: E731
        lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(np.float32) * s), t)
    jt.state = JS.unfreeze_layer3(jt.state.replace(
        opt_state=JS.replace_adam_state(jt.state.opt_state, 7, rand(jt.state.params, 1e-3),
                                        jax.tree_util.tree_map(jnp.abs, rand(jt.state.params,
                                                                             1e-6))),
        step=jnp.asarray(7, jnp.int32)))
    jt.layer3_unfrozen = True
    jt.best_acc = 0.75
    jt.plateau.update(0.5)
    path = os.path.join(root, "jax_ckpt")
    jt.save_checkpoint(1, path)
    return jt, path


@pytest.mark.parametrize("fmt", ["pth", "native"])
def test_port_resumes_from_jax_checkpoint(trained, jax_checkpoint, fmt):
    _, root, _ = trained
    jt, path = jax_checkpoint
    res = Trainer(TrainConfig(resume=path + ".pth" if fmt == "pth" else path, batch_size=2,
                              class1="SynthA"),
                  spec_cfg=SPEC, log_dir=os.path.join(root, "runs"), device="cpu")
    assert res.start_epoch == 2 and res.layer3_unfrozen and res.best_acc == 0.75
    assert int(res.state.step) == 7 and int(res.state.count) == 7
    assert res.plateau.state_dict() == jt.plateau.state_dict()
    want = torch_state_dict_from_variables(jax.tree_util.tree_map(np.asarray,
                                                                  jt.state.variables()))
    got = res.state_dict()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    _, mu, nu = JS.extract_adam_state(jt.state.opt_state)
    as_sd = lambda t: torch_state_dict_from_variables(  # noqa: E731
        {"params": jax.tree_util.tree_map(np.asarray, t)})
    mu, nu = as_sd(mu), as_sd(nu)
    pmu, pnu = _moments(res)
    for k in mu:
        if fmt == "native" or k.startswith(("base.layer4", "head.")):
            np.testing.assert_array_equal(pmu[k], mu[k])
            np.testing.assert_array_equal(pnu[k], nu[k])
        else:
            assert not pmu[k].any()


def test_evaluate_matches_jax_trainer_under_mel_dft_pallas(trained, jax_checkpoint,
                                                          monkeypatch):
    """--mel-dft pallas puts the log-mel kernel in the train step only: the
    reference builds its eval step without a dft_mode, so validation and
    --evaluate take the float32 GEMM mel. From the same checkpoint on the
    same tree, the port's evaluate launches no log-mel kernel and gives the
    JAX trainer's confusion, loss (1e-5 relative) and AUC."""
    from synthetic_audio_detection_tpu_torch.train import steps as port_steps

    _, root, _ = trained
    _, path = jax_checkpoint
    data = os.path.join(root, "data")
    jt = JaxTrainer(JCfg(resume=path, batch_size=2, class1="SynthA", mel_dft="pallas",
                         data_dir=data, workers=2),
                    spec_cfg=JSpec(out_size=64), log_dir=os.path.join(root, "runs"),
                    use_mesh=False)
    want = jt.evaluate()
    calls = []
    kernel = port_steps.fused_log_mel_factored
    monkeypatch.setattr(port_steps, "fused_log_mel_factored",
                        lambda *a, **k: calls.append(1) or kernel(*a, **k))
    tr = Trainer(TrainConfig(resume=path, batch_size=2, class1="SynthA", mel_dft="pallas",
                             data_dir=data, workers=2),
                 spec_cfg=SPEC, log_dir=os.path.join(root, "runs"), device="cpu")
    assert tr._dft == "pallas"
    got = tr.evaluate()
    assert not calls and tr.eval_steps_run == 2
    np.testing.assert_array_equal(got.confusion, want.confusion)
    assert got.val_acc == want.val_acc
    assert got.val_loss == pytest.approx(want.val_loss, rel=1e-5)
    assert got.val_auc == pytest.approx(want.val_auc, rel=1e-6)


def test_port_resumes_from_a_torch_adamw_checkpoint(tmp_path):
    """A reference-trainer checkpoint (unprefixed backbone keys, a real
    torch AdamW over layer4 and the head): the moments map onto the port's
    parameters exactly, frozen ones zero."""
    from tests.torch_ref import TorchResNetFeatures, make_head

    torch.manual_seed(0)
    m = TorchResNetFeatures("resnet18")
    m.head = make_head(512)
    params = [p for n, p in m.named_parameters() if n.startswith(("layer4", "head"))]
    opt = torch.optim.AdamW(params, lr=1e-3, weight_decay=0.01)
    for _ in range(3):
        for p in params:
            p.grad = torch.randn_like(p) * 1e-3
        opt.step()
    path = str(tmp_path / "ref.pth")
    torch.save({"epoch": 4, "state_dict": m.state_dict(), "best_acc": 0.5,
                "optimizer": opt.state_dict(), "scheduler": {}, "total_steps": 3}, path)
    res = Trainer(TrainConfig(resume=path, batch_size=2, class1="SynthA"), spec_cfg=SPEC,
                  log_dir=str(tmp_path / "runs"), device="cpu")
    assert res.start_epoch == 5 and int(res.state.count) == 3
    mu, nu = _moments(res)
    sd_opt = opt.state_dict()["state"]
    names = [n for n, p in m.named_parameters() if n.startswith(("layer4", "head"))]
    for i, n in enumerate(names):
        key = n if n.startswith("head.") else "base." + n
        np.testing.assert_array_equal(mu[key], sd_opt[i]["exp_avg"].numpy())
        np.testing.assert_array_equal(nu[key], sd_opt[i]["exp_avg_sq"].numpy())
    assert not mu["base.conv1.weight"].any()


def test_cli_trains_resumes_and_evaluates_on_cpu(tmp_path):
    from synthetic_audio_detection_tpu_torch.cli import submodel_trainer

    data = make_tree(str(tmp_path / "data"), n=1)
    common = ["--data-dir", data, "--Class0", "Real", "--Class1", "SynthA", "--batch-size", "2",
              "--input-size", "64", "--device", "cpu", "--workers", "1",
              "--log-dir", str(tmp_path / "runs")]
    cwd = os.getcwd()
    os.chdir(tmp_path)  # the CLI writes logs/ where it runs
    try:
        assert submodel_trainer.main(common + ["--epochs", "1", "--checkpoint-dir", "ck",
                                               "--data-backend", "grain", "--workers", "0"]) == 0
        assert os.path.exists("ck/best_model.ckpt.pth")
        assert submodel_trainer.main(common + ["--epochs", "2", "--checkpoint-dir", "ck2",
                                               "--resume", "ck/best_model.ckpt.pth"]) == 0
        assert submodel_trainer.main(common + ["--evaluate", "--resume",
                                               "ck/best_model.ckpt"]) == 0
        assert submodel_trainer.main(common + ["--epochs", "1", "--checkpoint-dir", "ck3",
                                               "--s2d-layer1"]) == 0
        assert os.path.exists("ck3/best_model.ckpt.pth")
    finally:
        os.chdir(cwd)


def test_training_keeps_the_reference_mel_norm_mismatch(monkeypatch, tmp_path):
    """Training's mel has no norm (the reference trains without one and
    serves with slaney): the trainer's default and the CLI's config."""
    from synthetic_audio_detection_tpu_torch.cli import submodel_trainer
    from synthetic_audio_detection_tpu_torch.train import trainer as trainer_mod

    assert Trainer(TrainConfig(), log_dir=str(tmp_path / "runs"),
                   device="cpu").spec_cfg.mel_norm is None
    seen = {}

    class Capture:
        def __init__(self, cfg, spec_cfg=None, **kw):
            seen["spec"] = spec_cfg

        def evaluate(self):
            return None

    monkeypatch.setattr(trainer_mod, "Trainer", Capture)
    monkeypatch.chdir(tmp_path)
    assert submodel_trainer.main(["--evaluate", "--input-size", "native", "--device", "cpu"]) == 0
    assert seen["spec"].mel_norm is None and seen["spec"].out_size == 0
    assert SpectrogramConfig.inference().mel_norm == "slaney"
