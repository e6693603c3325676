"""The port's head addition (``train/add_head.py``, ``cli/add_head.py``)
against the JAX package's, on the CPU: a shared-backbone ResNet-18 artifact
(seeded weights, written once as a native merged file that both packages
read), one add-head step and the eval from a common state (JAX's new head
carried into the port; dropout neutralised and SpecAugment off, as in
tests/test_torch_train_step.py, whose float32 bounds hold here), the
best-epoch rule, splice_head against JAX's splice, and the refusals."""

import logging
import os
import shutil

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic_audio_detection_tpu.checkpoints import serialization as JSer
from synthetic_audio_detection_tpu.checkpoints.torch_compat import torch_state_dict_from_variables
from synthetic_audio_detection_tpu.ensemble import multihead as JE
from synthetic_audio_detection_tpu.train import add_head as JA
from synthetic_audio_detection_tpu.train import steps as JS
from synthetic_audio_detection_tpu.utils.config import SpecAugmentConfig as JAug
from synthetic_audio_detection_tpu.utils.config import SpectrogramConfig as JSpec
from synthetic_audio_detection_tpu.utils.config import TrainConfig as JCfg
from synthetic_audio_detection_tpu_torch.checkpoints import serialization as TSer
from synthetic_audio_detection_tpu_torch.ensemble.multihead import (
    build_ensemble,
    ensemble_per_head_logits,
)
from synthetic_audio_detection_tpu_torch.train import add_head
from synthetic_audio_detection_tpu_torch.utils.config import (
    SpecAugmentConfig,
    SpectrogramConfig,
    TrainConfig,
)
from tests.test_torch_joint_trainer import make_tree
from tests.test_torch_merger import _seeded

LR = 1e-5
SPEC = SpectrogramConfig(out_size=64)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


class _NoDropout(fnn.Module):
    rate: float = 0.0
    deterministic: bool = None

    @fnn.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


def _shared_sds(n=2, generic=False):
    """n sub-models (one more for a generic head) sharing seed 0's base."""
    sds = [_seeded(i + 10) for i in range(n + int(generic))]
    return [{**{k: v for k, v in sds[0].items() if k.startswith("base.")},
             **{k: v for k, v in sd.items() if k.startswith("head.")}} for sd in sds]


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """A shared-backbone artifact (SynA, SynB) as a native merged file."""
    root = tmp_path_factory.mktemp("artifact")
    path = str(root / "merged.ckpt")
    TSer.save_merged_native(path, build_ensemble(_shared_sds(), ["SynA", "SynB", "Real"]))
    yield path
    shutil.rmtree(root, ignore_errors=True)


def _batch(seed=1):
    """Rows of other spectra (noise, a tone in noise, low-passed noise, a
    quiet row weighted 0): the frozen trunk's pooled features of four
    white-noise rows are nearly one vector, and the head's train-mode
    BatchNorm over such rows (flax's E[x²] − E[x]²) cancels to rounding
    noise in either package."""
    rng = np.random.default_rng(seed)
    t = np.arange(32_000) / 32_000
    noise = rng.standard_normal((4, 32_000))
    audio = np.stack([0.2 * noise[0], 0.05 * noise[1] + 0.3 * np.sin(2 * np.pi * 440 * t),
                      0.05 * np.cumsum(noise[2]) / np.sqrt(np.arange(1, 32_001)),
                      1e-3 * noise[3]]).astype(np.float32)
    return {"audio": audio, "label": np.array([0, 1, 1, 0], np.int32),
            "weight": np.array([1, 1, 1, 0], np.float32)}


def _torch_batch(b):
    return {"audio": torch.from_numpy(b["audio"]), "label": torch.from_numpy(b["label"]).long(),
            "weight": torch.from_numpy(b["weight"])}


def _head_sd(params, stats):
    sd = torch_state_dict_from_variables(jax.tree_util.tree_map(
        np.asarray, {"params": {"head": params}, "batch_stats": {"head": stats}}))
    return {k[len("head."):]: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def test_step_and_eval_match_jax(artifact, monkeypatch):
    """From JAX's initial head: one step (trunk frozen in eval mode, the
    head in train mode, clip and AdamW at cfg.lr) on the same model input,
    within the float32 bounds of tests/test_torch_train_step.py, the trunk
    bit-identical after it; the eval step under mel_dft='pallas' (the
    kernel's plain version here, JAX's Pallas kernel in interpret mode)
    counts the same correct rows."""
    monkeypatch.setattr(fnn, "Dropout", _NoDropout)
    jcfg = JCfg(batch_size=2, lr=LR, mel_dft="pallas")
    jens = JSer.load_merged(artifact)
    jadd = JA.HeadAdder(jens, "SynC", jcfg, spec_cfg=JSpec(out_size=64),
                        augment=JAug(enabled=False))
    ens = TSer.load_merged(artifact)
    adder = add_head.HeadAdder(ens, "SynC", TrainConfig(batch_size=2, lr=LR, mel_dft="pallas"),
                               spec_cfg=SPEC, augment=SpecAugmentConfig(enabled=False),
                               device="cpu")
    head = adder.state.model
    head.load_state_dict(_head_sd(jadd.state.params, jadd.state.batch_stats))
    for m in head.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    trunk_before = {k: v.clone() for k, v in adder.trunk.state_dict().items()}

    trunk = jax.device_put(jadd.trunk)
    # the step on the same model input (JAX's GEMM-mel features: the two
    # kernels' log-mels differ by up to 1e-3, the float32 bounds are tighter)
    x = np.array(JS._features_from_waveforms(jnp.asarray(_batch()["audio"]), JSpec(out_size=64),
                                             None, None, 32_000))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS, "_features_from_waveforms", lambda *a, **kw: jnp.asarray(x))
        mp.setattr(add_head.steps, "features_from_waveforms",
                   lambda *a, **kw: torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
        js, jm = jadd._step(jadd.state, trunk, _batch(), jax.random.PRNGKey(0))
        pm = adder._step(adder.state, adder.trunk, _torch_batch(_batch()), torch.Generator())
    assert float(pm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(pm["accuracy"]) == float(jm["accuracy"])
    assert int(adder.state.count) == 1 and int(js.step) == 1
    want = _head_sd(js.params, js.batch_stats)
    _, mu, nu = JS.extract_adam_state(js.opt_state)
    mu, nu = _head_sd(mu, {}), _head_sd(nu, {})
    pmu, pnu = adder.state.moments()
    # a tensor whose gradient is rounding noise (a Linear's bias before a
    # BatchNorm) takes 1e-2 of the head's largest moment as its scale
    top = {id(m): max(float(v.abs().max()) for v in m.values()) for m in (mu, nu)}
    for k, w in want.items():
        got = head.state_dict()[k]
        if "running" in k:
            torch.testing.assert_close(got, w, rtol=1e-5, atol=1e-5)
            continue
        for a, b, m in ((pmu[k], mu[k], mu), (pnu[k], nu[k], nu)):
            scale = max(float(b.abs().max()), 1e-2 * top[id(m)])
            assert bool(((a - b).abs() <= 3e-4 * b.abs() + 3e-4 * scale).all()), k
        well = mu[k].abs() / 0.1 > 1e-6
        d = (got - w).abs()
        assert bool((d[well] <= 1e-5 * w[well].abs() + 1e-6).all()), k
        assert bool((d <= 2 * LR + 1e-6).all()), k
    assert all(torch.equal(v, trunk_before[k]) for k, v in adder.trunk.state_dict().items())

    b = _batch(3)
    want_eval = jadd._eval({"params": js.params, "batch_stats": js.batch_stats}, trunk, b)
    calls = []
    kernel = add_head.steps.fused_log_mel_factored
    monkeypatch.setattr(add_head.steps, "fused_log_mel_factored",
                        lambda *a, **kw: calls.append(1) or kernel(*a, **kw))
    got_eval = adder._eval(head, adder.trunk, _torch_batch(b))
    assert calls == [1]  # the eval step takes the train step's mel
    assert float(got_eval["correct"]) == float(want_eval["correct"])
    assert float(got_eval["count"]) == float(want_eval["count"]) == 3.0


def test_best_epoch_is_taken_with_greater_or_equal(artifact, tmp_path, monkeypatch):
    """On a tie the later epoch's head serves (>=); a worse epoch does not
    replace a better one. The validation accuracies are set per epoch; the
    head after each epoch's training is recorded at its first eval step (4
    files a split with the hard negatives: 2 train and 2 eval steps an
    epoch)."""
    data = make_tree(str(tmp_path / "data"), classes=("Real", "SynA", "SynB", "SynC"))
    for accs, kept in (([0.5, 0.5], 1), ([0.75, 0.5], 0)):
        adder = add_head.HeadAdder(TSer.load_merged(artifact), "SynC",
                                   TrainConfig(batch_size=2, epochs=2, workers=1),
                                   spec_cfg=SPEC, device="cpu")
        heads = []
        evaluate = adder._eval

        def fake_eval(head, trunk, batch, adder=adder, heads=heads, accs=accs):
            out = evaluate(head, trunk, batch)
            if adder.eval_steps_run % 2 == 0:  # an epoch's first eval step
                heads.append(adder._head_state())
            return {"correct": out["count"] * accs[len(heads) - 1], "count": out["count"]}

        monkeypatch.setattr(adder, "_eval", fake_eval)
        assert adder.fit(data) == max(accs)
        assert adder.train_steps_run == 4 and adder.eval_steps_run == 4 and len(heads) == 2
        assert not all(torch.equal(heads[0][k], heads[1][k]) for k in heads[0])
        assert all(torch.equal(adder._best_head[k], heads[kept][k]) for k in heads[kept])
        spliced = adder.spliced().classifier_state_dicts()[2]
        assert torch.equal(spliced["head.10.weight"], heads[kept]["10.weight"])


def test_splice_keeps_existing_heads_and_the_generic_head_last(caplog):
    """The new specialist goes after the named classes, before the generic
    head; the existing heads' logits stay bit-identical; a calibration is
    dropped with a warning; the result equals JAX's splice of the same
    head, entry for entry."""
    ens = build_ensemble(_shared_sds(2, generic=True), ["SynA", "SynB", "Real"],
                         generic_head=True, calibration={"temperature": [1.0] * 3})
    new_head = {k[len("head."):]: v for k, v in _seeded(20).items() if k.startswith("head.")}
    with caplog.at_level(logging.WARNING):
        grown = add_head.splice_head(ens, "SynC", new_head)
    assert "dropping stored calibration" in caplog.text and grown.calibration is None
    assert grown.class_names == ["SynA", "SynB", "SynC", "Real"] and grown.generic_head
    assert grown.shared_backbone and grown.num_heads == 4
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 3, 64, 64))
                         .astype(np.float32))
    old, new = ensemble_per_head_logits(ens, x), ensemble_per_head_logits(grown, x)
    assert torch.equal(new[0], old[0]) and torch.equal(new[1], old[1])
    assert torch.equal(new[3], old[2])  # the generic head, still last
    with pytest.raises(ValueError, match="already"):
        add_head.splice_head(ens, "SynA", new_head)


def test_splice_matches_jax(tmp_path):
    ens = build_ensemble(_shared_sds(2, generic=True), ["SynA", "SynB", "Real"],
                         generic_head=True)
    path = str(tmp_path / "gen.ckpt")
    TSer.save_merged_native(path, ens)
    head_sd = {k: v for k, v in _seeded(20).items() if k.startswith("head.")}
    from synthetic_audio_detection_tpu.checkpoints.torch_compat import (
        classifier_variables_from_torch,
    )

    hv = classifier_variables_from_torch({k: v.numpy() for k, v in head_sd.items()})
    jgrown = JA.splice_head(JSer.load_merged(path), "SynC", hv["params"]["head"],
                            hv["batch_stats"]["head"])
    JSer.save_merged_native(str(tmp_path / "jax.ckpt"), jgrown)
    want = TSer.load_merged(str(tmp_path / "jax.ckpt"))
    got = add_head.splice_head(TSer.load_merged(path), "SynC",
                               {k[len("head."):]: v for k, v in head_sd.items()})
    assert got.class_names == want.class_names and got.generic_head == want.generic_head
    for a, b in zip(got.classifier_state_dicts(), want.classifier_state_dicts()):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a if not k.endswith("num_batches_tracked"))
    x = jnp.asarray(np.random.default_rng(2).standard_normal((2, 64, 64, 3)), jnp.float32)
    np.testing.assert_allclose(
        got(torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2)).numpy(),
        np.asarray(JE.ensemble_forward(jgrown, x)), atol=1e-4, rtol=0)


def test_refuses_artifacts_without_a_shared_backbone():
    sds = [_seeded(i) for i in range(2)]
    dense = build_ensemble(sds, ["SynA", "SynB", "Real"])
    trunk = build_ensemble([{k: (sds[0][k] if k.startswith("base.") and "layer4" not in k
                                 else v) for k, v in sd.items()} for sd in sds],
                           ["SynA", "SynB", "Real"])
    assert not dense.shared_backbone and trunk.shared_trunk_stages == 1
    for ens in (dense, trunk):
        with pytest.raises(ValueError, match="shared-backbone artifact"):
            add_head.trunk_variables(ens)
        with pytest.raises(ValueError, match="shared-backbone artifact"):
            add_head.HeadAdder(ens, "SynC", TrainConfig(), spec_cfg=SPEC, device="cpu")


def test_cli_grows_an_artifact_on_cpu(artifact, tmp_path):
    """The CLI trains a head for SynC against the frozen trunk (the other
    class folders as hard negatives) and writes the grown artifact in both
    formats; the existing heads and the backbone are unchanged."""
    from synthetic_audio_detection_tpu_torch.cli import add_head as cli

    data = make_tree(str(tmp_path / "data"), classes=("Real", "SynA", "SynB", "SynC"))
    out = str(tmp_path / "grown.ckpt")
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert cli.main(["--merged-model", artifact, "--data-dir", data, "--new-class", "SynC",
                         "--output", out, "--epochs", "1", "--batch-size", "2",
                         "--input-size", "64", "--device", "cpu", "--workers", "1"]) == 0
    finally:
        os.chdir(cwd)
    before = TSer.load_merged(artifact).classifier_state_dicts()
    for path in (out, str(tmp_path / "grown.pth")):
        grown = TSer.load_merged(path)
        assert grown.class_names == ["SynA", "SynB", "SynC", "Real"] and grown.shared_backbone
        after = grown.classifier_state_dicts()
        for a, b in zip(after, before):
            assert all(torch.equal(a[k], b[k]) for k in b if not k.endswith("tracked"))
    shutil.rmtree(tmp_path, ignore_errors=True)
