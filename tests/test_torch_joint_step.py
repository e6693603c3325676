"""The port's joint train step in float32 and its eval step against the
JAX package's (``train/joint.py``), on the CPU, from the JAX package's
initial state: the sizes, helpers and tolerances of tests/test_torch_joint.py
(the bounds of tests/test_torch_train_step.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic_audio_detection_tpu.train import joint as JJ
from synthetic_audio_detection_tpu.train import steps as JS
from synthetic_audio_detection_tpu.utils.config import SpectrogramConfig as JSpec
from synthetic_audio_detection_tpu_torch.checkpoints import serialization as TSer
from synthetic_audio_detection_tpu_torch.train import joint
from synthetic_audio_detection_tpu_torch.train import steps as TS
from synthetic_audio_detection_tpu_torch.utils.config import SpectrogramConfig
from tests.test_torch_joint import (  # noqa: F401  (no_dropout and _two_threads are fixtures)
    CASE_IDS,
    CASES,
    INPUT,
    LR,
    N_HEADS,
    _batch,
    _jax_step,
    _named,
    _np,
    _port_step,
    _torch_batch,
    _two_threads,
    jax_state,
    no_dropout,
    port_state,
)


def assert_matches_jax(port, js, moments=True, n_steps=1):
    """tests/test_torch_train_step.py's float32 bounds, by joint-model name:
    parameters and BN statistics, and with ``moments`` the Adam moments
    (otherwise only which tensors have none)."""
    jv = TSer.joint_named(_np({"params": js.params, "batch_stats": js.batch_stats}))
    count, mu, nu = JS.extract_adam_state(js.opt_state)
    mu, nu = (TSer.joint_named({"params": _np(t)}) for t in (mu, nu))
    assert int(port.count) == count and int(port.step) == int(js.step)
    pmu, pnu = port.moments()
    top = {id(m): max(float(np.abs(v).max()) for v in m.values()) for m in (mu, nu)}
    for key in mu:
        for got, want, m in ((pmu[key].numpy(), mu[key], mu), (pnu[key].numpy(), nu[key], nu)):
            assert got.any() == want.any(), key
            if moments:
                scale = max(float(np.abs(want).max()), 1e-2 * top[id(m)])
                assert np.all(np.abs(got - want) <= 3e-4 * np.abs(want) + 3e-4 * scale), key
    got_sd = _named(port)
    assert set(got_sd) == set(jv)
    for key, want in jv.items():
        got = got_sd[key]
        if "running" in key:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=key)
            continue
        well = np.abs(mu[key]) / 0.1 > 1e-6
        d = np.abs(got - want)
        assert np.all(d[well] <= 1e-5 * np.abs(want[well]) + 1e-6), key
        assert np.all(d <= 2 * LR * n_steps + 1e-6), key


@pytest.mark.parametrize("case", [CASES[0], CASES[3]], ids=[CASE_IDS[0], CASE_IDS[3]])
def test_joint_step_matches_jax(case, no_dropout, monkeypatch):
    """One float32 step from a common state on the same model input (JAX's
    features of the batch, fed to both steps: the two packages' float32
    features differ by about 2e-6, which this tiny network amplifies past
    the bounds; the features are held to JAX's in
    tests/test_torch_train_step.py): loss and per-head losses to 1e-5
    relative, accuracies equal, the state within the bounds. Heads move,
    the frozen trunk does not (its BN statistics do); with K = 2 the
    tails' layer3, trainable with a zero gradient, moves by AdamW's decay
    alone, to JAX's bits."""
    x = np.array(JS._features_from_waveforms(jnp.asarray(_batch()["audio"]),
                                               JSpec(out_size=INPUT), None, None, 32_000))
    monkeypatch.setattr(JS, "_features_from_waveforms", lambda *a, **kw: jnp.asarray(x))
    monkeypatch.setattr(TS, "features_from_waveforms",
                        lambda *a, **kw: torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    k, hard, generic = case
    js = jax_state(k)
    new_js, jm = _jax_step(k, hard, generic)(js, _batch(), jax.random.PRNGKey(2))
    port = port_state(js, k)
    before = _named(port)
    pm = _port_step(k, hard, generic)(port, _torch_batch(_batch()), torch.Generator())
    assert float(pm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    np.testing.assert_allclose(pm["per_head_loss"].numpy(), np.asarray(jm["per_head_loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(pm["per_head_accuracy"].numpy(),
                               np.asarray(jm["per_head_accuracy"]), rtol=1e-6)
    assert_matches_jax(port, new_js)
    after = _named(port)
    moved = {n for n in after if not np.array_equal(after[n], before[n])}
    assert {n for n in after if n.startswith("heads.") and ".tail.layer3." not in n} <= moved
    assert not any(n.startswith(("base.conv1", "base.layer1", "base.layer2")) and
                   "running" not in n for n in moved)
    assert any(n.startswith("base.layer1") and "running" in n for n in moved)
    # the tails' layer3 (K = 2): zero moments, AdamW's decay alone, JAX's bits
    jv = TSer.joint_named(_np({"params": new_js.params}))
    pmu, _ = port.moments()
    tail3 = [n for n in jv if ".tail.layer3." in n]
    assert bool(tail3) == (k == 2)
    for n in tail3:
        np.testing.assert_array_equal(after[n], jv[n], err_msg=n)
        assert not pmu[n].any()


@pytest.fixture(scope="module")
def eval_steps():
    """JAX eval steps with the Pallas log-mel (interpret mode on the CPU)."""
    return {case: jax.jit(JJ.make_joint_eval_step(
        "resnet18", JSpec(out_size=INPUT), N_HEADS, dft_mode="pallas", per_head_stages=case[0],
        hard_negatives=case[1], generic_head=case[2])) for case in (CASES[0], CASES[1])}


@pytest.mark.parametrize("case", [CASES[0], CASES[1]], ids=[CASE_IDS[0], CASE_IDS[1]])
def test_eval_step_matches_jax_under_the_kernel_mel(case, eval_steps):
    """The eval step takes the train step's mel: dft_mode='pallas', the
    log-mel kernel's plain version here, against JAX's in interpret mode,
    on int16 audio (both dequantize it first). Confusion, count and
    ens_correct equal; loss sums, det_score and probabilities within 1e-4
    (the kernels agree to 1e-3 on z-scores)."""
    k, hard, generic = case
    js = jax_state(k)
    b = _batch(4)
    b["audio"] = np.round(b["audio"] * 32768).astype(np.int16)
    want = eval_steps[case]({"params": js.params, "batch_stats": js.batch_stats}, b)
    port = port_state(js, k)
    calls = []
    kernel = TS.fused_log_mel_factored
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TS, "fused_log_mel_factored",
                   lambda w, *a, **kw: calls.append(w.dtype) or kernel(w, *a, **kw))
        got = joint.make_joint_eval_step(SpectrogramConfig(out_size=INPUT), N_HEADS,
                                         dft_mode="pallas", hard_negatives=hard,
                                         generic_head=generic)(port.model, _torch_batch(b))
    assert calls == [torch.float32]  # the kernel's mel, on dequantized audio
    np.testing.assert_array_equal(got["confusion"].numpy(), np.asarray(want["confusion"]))
    assert float(got["count"]) == float(want["count"]) == 5.0
    assert float(got["ens_correct"]) == float(want["ens_correct"])
    np.testing.assert_allclose(got["loss_sum"].numpy(), np.asarray(want["loss_sum"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["det_score"].numpy(), np.asarray(want["det_score"]), atol=1e-4)
    np.testing.assert_allclose(got["probs"].numpy(), np.asarray(want["probs"]), atol=1e-4)


class _FixedLogits(torch.nn.Module):
    def __init__(self, logits):
        super().__init__()
        self.logits = logits

    def forward(self, x):
        return self.logits


def test_eval_verdict_leaves_out_the_generic_head_as_the_reference_does():
    """A known fault of the reference (ADVICE.md, round 5), kept on
    purpose, not the intended rule: the joint eval step's ensemble verdict
    aggregates the specialist heads only, while serving's ``_aggregate``
    puts the generic head's real logit into the real mean. The port keeps
    the reference's rule so that ``ensemble_acc`` picks the reference's best
    epoch. One row (label Real) where the two rules disagree: the
    specialists alone say Real; with the generic head's strong synthetic
    vote in the mean, serving would not. The detector score is the
    generic head's synthetic probability."""
    from synthetic_audio_detection_tpu_torch.ensemble import multihead

    logits = torch.tensor([[[3.0, -3.0]], [[3.0, -3.0]], [[-9.0, 0.0]]])  # [N=3, B=1, 2]
    step = joint.make_joint_eval_step(SpectrogramConfig(out_size=INPUT), 3, generic_head=True)
    batch = {"audio": torch.zeros((1, 32_000)), "label": torch.tensor([0]),
             "weight": torch.tensor([1.0])}
    got = step(_FixedLogits(logits), batch)
    assert float(got["ens_correct"]) == 1.0  # specialists only: Real (index 2), correct
    serving = multihead.decide(multihead._aggregate(logits))
    assert int(serving["label_idx"][0]) != 3  # all heads: not Real (index 3)
    np.testing.assert_allclose(got["det_score"].numpy(), torch.softmax(logits[-1], -1)[:, 1])
