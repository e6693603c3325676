"""The port's joint train step in float32 and its eval step against the
JAX package's (``train/joint.py``), on the CPU, from the JAX package's
initial state: the sizes, helpers and tolerances of tests/test_torch_joint.py
(the bounds of tests/test_torch_train_step.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import parity_bounds
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
    _cross_entropy_keeping_dtype,
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
from tests.test_torch_train_step import _f64


def _step_f64(case, js, x):
    """make_joint_train_step in float64 from the float32 state ``js`` on the
    model input ``x``: a float64 model, state and batch, the cross-entropy
    in the logits' dtype (JAX's fixes float32). → (state, metrics)."""
    k, hard, generic = case
    b = _batch()
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(JS, "_features_from_waveforms", lambda *a, **kw: jnp.asarray(x, jnp.float64))
        mp.setattr(JS, "cross_entropy", _cross_entropy_keeping_dtype)
        new, m = _jax_step(k, hard, generic, dtype=jnp.float64)(
            _f64(js), dict(b, weight=b["weight"].astype(np.float64)), jax.random.PRNGKey(2))
        return _np(new), _np(m)


def _model_input(monkeypatch):
    """JAX's features of the batch, fed to both packages' steps."""
    x = np.array(JS._features_from_waveforms(jnp.asarray(_batch()["audio"]),
                                               JSpec(out_size=INPUT), None, None, 32_000))
    monkeypatch.setattr(JS, "_features_from_waveforms", lambda *a, **kw: jnp.asarray(x))
    monkeypatch.setattr(TS, "features_from_waveforms",
                        lambda *a, **kw: torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    return x


def _assert_losses_within(pm, jm, tm):
    """The port's per-head losses and loss against JAX's float64 step
    (``tm``), within parity_bounds.reference_error_bound of JAX's float32
    step's (``jm``) error on them."""
    losses = lambda m: np.append(np.asarray(m["per_head_loss"]), float(m["loss"]))  # noqa: E731
    parity_bounds.assert_within_reference(losses(pm), losses(jm), losses(tm),
                                          float(np.abs(losses(tm)).max()), err_msg="losses")


def assert_matches_jax(port, js, truth=None, n_steps=1):
    """tests/test_torch_train_step.py's bounds, by joint-model name:
    parameters and BN statistics against JAX's float32 step ``js``, and
    with ``truth`` (JAX's step in float64 from the same state) the Adam
    moments within parity_bounds.reference_error_bound (otherwise only which
    tensors have none)."""
    jv = TSer.joint_named(_np({"params": js.params, "batch_stats": js.batch_stats}))
    count, mu, nu = JS.extract_adam_state(js.opt_state)
    mu, nu = (TSer.joint_named({"params": _np(t)}) for t in (mu, nu))
    assert int(port.count) == count and int(port.step) == int(js.step)
    pmu, pnu = port.moments()
    for key in mu:
        for got, want in ((pmu[key], mu[key]), (pnu[key], nu[key])):
            assert got.numpy().any() == want.any(), key
    if truth is not None:
        _, tmu, tnu = JS.extract_adam_state(truth.opt_state)
        parity_bounds.assert_moments_within(
            (pmu, pnu), (mu, nu), tuple(TSer.joint_named({"params": _np(t)}) for t in (tmu, tnu)))
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
    tests/test_torch_train_step.py): the per-head losses, the loss and the
    Adam moments against JAX's step in float64 from the same state, within
    parity_bounds.reference_error_bound of JAX's own float32 error; the
    accuracies equal, parameters and BN statistics within the bounds. Heads move,
    the frozen trunk does not (its BN statistics do); with K = 2 the
    tails' layer3, trainable with a zero gradient, moves by AdamW's decay
    alone, to JAX's bits."""
    x = _model_input(monkeypatch)
    k, hard, generic = case
    js = jax_state(k)
    new_js, jm = _jax_step(k, hard, generic)(js, _batch(), jax.random.PRNGKey(2))
    port = port_state(js, k)
    before = _named(port)
    pm = _port_step(k, hard, generic)(port, _torch_batch(_batch()), torch.Generator())
    truth, tm = _step_f64(case, js, x)
    _assert_losses_within(pm, jm, tm)
    np.testing.assert_allclose(pm["per_head_accuracy"].numpy(),
                               np.asarray(jm["per_head_accuracy"]), rtol=1e-6)
    assert_matches_jax(port, new_js, truth)
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


def test_loss_bound_rejects_zero_rows_in_the_denominator(no_dropout, monkeypatch):
    """The rows weighted 0 counted in each head's cross-entropy
    denominator (the loss at 5/6 of itself): the float64-derived bound
    rejects it, as the fixed 1e-5 against JAX's float32 step did."""
    x = _model_input(monkeypatch)
    case = CASES[0]
    js = jax_state(case[0])
    _, jm = _jax_step(*case)(js, _batch(), jax.random.PRNGKey(2))
    _, tm = _step_f64(case, js, x)
    ce = TS.cross_entropy
    monkeypatch.setattr(TS, "cross_entropy", lambda out, labels, weights=None, total=None: ce(
        out, labels, weights, torch.tensor(float(labels.shape[0]))))
    pm = _port_step(*case)(port_state(js, case[0]), _torch_batch(_batch()), torch.Generator())
    with pytest.raises(AssertionError, match="losses"):
        _assert_losses_within(pm, jm, tm)
    assert abs(float(pm["loss"]) - float(jm["loss"])) > 1e-5 * abs(float(jm["loss"]))


def test_moment_check_rejects_adam_b2_of_0_99899(no_dropout, monkeypatch):
    """Adam's b2 at 0.99899 in place of 0.999: ν one percent high after the
    first step, whose bias correction 1 − b2 cancels it in the update, so
    the parameters and BN statistics hold to their bounds, and only the
    moments' check against the float64 step rejects it (as the fixed 3e-4
    against JAX's float32 step did)."""
    x = _model_input(monkeypatch)
    case = CASES[0]
    js = jax_state(case[0])
    new_js, _ = _jax_step(*case)(js, _batch(), jax.random.PRNGKey(2))
    truth, _ = _step_f64(case, js, x)
    monkeypatch.setattr(TS, "B2", 0.99899)
    port = port_state(js, case[0])
    _port_step(*case)(port, _torch_batch(_batch()), torch.Generator())
    assert_matches_jax(port, new_js)
    with pytest.raises(AssertionError):
        assert_matches_jax(port, new_js, truth)


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
