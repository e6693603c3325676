"""The port's train and eval steps against the JAX package's, on the CPU:
ResNet-18 at 64², 1-s audio, 4 rows (the last weighted 0, as the trainer's
pad rows), float32, the same initial weights (the JAX package's init,
carried by checkpoints/from_jax.py) and the same batch. The row weighted 0
is quiet noise, not zeros: a zero row's log-mel is one constant, which
standardize turns into (c − mean) / (std + eps), rounding noise of the
mean's summation order in either package, so no two implementations agree
on it (both keep it finite).

Random draws cannot match between the packages, so the parity steps run
with SpecAugment and the crop off on both sides and dropout neutralised:
flax.linen.Dropout is swapped for an identity inside this module (the JAX
package is not touched) and the port's head rates are set to 0. The apply
parts of the augmentations are held against JAX's own draws in
tests/test_torch_train_ops.py; here the port's dropout is shown live and
driven by the step's generator.

Tolerances. In float64 the two packages' gradients agree to 1e-10
relative (test_gradients_match_jax_in_float64: the same function). In
float32 this tiny, randomly initialised network (layer4 at 2×2, BatchNorm
over 16 values a channel) amplifies rounding about a thousandfold, so its
float32 gradients lie up to about 5e-4 relative from the float64 ones, in
either package, and where the order of the float32 sums moves with the
CPU's instruction set, so does that error. So each float32 step is held to
the JAX package's own step in float64 from the same state and batch
(f64_side):
- Adam moments: parity_bounds.reference_error_bound, a multiple of the JAX
  package's own float32 error on each tensor;
- BN running statistics: 1e-5 relative + 1e-5 absolute of JAX's;
- parameters: 1e-5 relative + 1e-6 absolute of JAX's where the AdamW step
  is well conditioned (|g| > 1e-6, a hundred times Adam's eps, where the
  step g / (|g| + eps) damps the gradient's error a hundredfold); below
  that it amplifies it, so those elements are held to the most a step can
  move them, lr per step in either direction.
"""

import jax
import jax.numpy as jnp
import numpy as np
import parity_bounds
import pytest
import torch

import flax.linen as fnn
from synthetic_audio_detection_tpu.models.classifier import BinaryClassifier as JaxClassifier
from synthetic_audio_detection_tpu.train import steps as JS
from synthetic_audio_detection_tpu.checkpoints.torch_compat import torch_state_dict_from_variables
from synthetic_audio_detection_tpu.utils.config import SpecAugmentConfig as JAug
from synthetic_audio_detection_tpu.utils.config import SpectrogramConfig as JSpec
from synthetic_audio_detection_tpu.utils.config import TrainConfig as JCfg
from synthetic_audio_detection_tpu_torch.checkpoints.from_jax import classifier_state_dict
from synthetic_audio_detection_tpu_torch.models.classifier import BinaryClassifier
from synthetic_audio_detection_tpu_torch.train import steps as TS
from synthetic_audio_detection_tpu_torch.utils.config import SpecAugmentConfig, SpectrogramConfig
from synthetic_audio_detection_tpu_torch.utils.config import TrainConfig
from tests.test_torch_joint import _cross_entropy_keeping_dtype

# a small lr: an ill-conditioned element (below) moves by up to lr per
# step in either direction, and the next steps' gradients follow the
# parameters, so the packages' trajectories part at a rate set by lr
LR = 1e-5
INPUT = 64


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module's CPU work, restored after: the
    suite runs several workers on one machine's cores."""
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


def make_jax_side():
    """The JAX model's initial state and jitted steps; trace them with
    flax's Dropout swapped for _NoDropout."""
    cfg = JCfg(batch_size=2, lr=LR)
    spec = JSpec(out_size=INPUT)
    model = JaxClassifier(backbone="resnet18")
    state, tx = JS.create_train_state(model, jax.random.PRNGKey(0), cfg, input_size=INPUT)
    off = JAug(enabled=False)
    return {
        "state": state,
        "step": jax.jit(JS.make_train_step(model, tx, cfg, spec, off)),
        "quirk": jax.jit(JS.make_train_step(model, tx, cfg, spec, off,
                                            reference_quirk_loss=True)),
        "eval": jax.jit(JS.make_eval_step(model, spec)),
    }


@pytest.fixture(scope="module")
def jax_side():
    """make_jax_side, dropout swapped out for the module."""
    mp = pytest.MonkeyPatch()
    mp.setattr(fnn, "Dropout", _NoDropout)
    yield make_jax_side()
    mp.undo()


def make_f64_step():
    """→ step(js, batch, quirk=False): the JAX package's own train step
    (make_train_step) in float64 from the float32 state ``js``, the truth
    the float32 steps are held to: a float64 model, state and batch; its
    front end and its cross-entropy, which fix float32, swapped for
    _features_f64 and for the same formula in the logits' dtype while the
    step runs. Compiled once for the module, as jax_side's steps are."""
    cfg = JCfg(batch_size=2, lr=LR)
    with jax.enable_x64(True):
        model = JaxClassifier(backbone="resnet18", dtype=jnp.float64)
        tx = JS.make_optimizer(cfg)
        steps = {q: jax.jit(JS.make_train_step(model, tx, cfg, JSpec(out_size=INPUT),
                                               JAug(enabled=False), reference_quirk_loss=q))
                 for q in (False, True)}

    def step(js, batch, quirk=False):
        with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
            mp.setattr(JS, "_features_from_waveforms", lambda audio, *a, **kw: _features_f64(audio))
            mp.setattr(JS, "cross_entropy", _cross_entropy_keeping_dtype)
            new, _ = steps[quirk](_f64(js), dict(batch, weight=batch["weight"].astype(np.float64)),
                                  jax.random.PRNGKey(0))
            return jax.tree_util.tree_map(np.asarray, new)

    return step


@pytest.fixture(scope="module")
def f64_side(jax_side):
    """make_f64_step, compiled once for the module (traced with jax_side's
    dropout swap)."""
    return make_f64_step()


def _batch(seed=1, nan=False):
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((4, 32_000)) * 0.2).astype(np.float32)
    audio[3] *= 1e-3  # a row weighted 0, as the trainer's pad rows
    if nan:
        audio[0, 0] = np.nan
    return {"audio": audio, "label": np.array([0, 1, 1, 0], np.int32),
            "weight": np.array([1, 1, 1, 0], np.float32)}


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64) if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating)
        else a, tree)


def _features_f64(audio):
    """The JAX package's train-mode front end (gemm DFT, dB, standardize,
    the resize, three channels; SpecAugment and the crop off) in float64,
    its host constants (window, DFT basis, filterbank) as they are."""
    from synthetic_audio_detection_tpu.ops import melspec as JM

    spec = JSpec(out_size=INPUT)
    fb = JM.mel_filterbank(spec.n_freqs, spec.f_min, spec.f_max, spec.n_mels, 32_000,
                           spec.mel_norm, spec.mel_scale)
    n_cols = JM.significant_bins(fb)
    cos_m, sin_m = JM._dft_matrices(spec.n_fft, n_cols)
    frames = JM.frame_signal(jnp.asarray(audio, jnp.float64), spec.n_fft, spec.hop_length,
                             spec.center, spec.pad_mode)
    xw = frames * jnp.asarray(JM.hann_window(spec.win), jnp.float64)
    p = (xw @ jnp.asarray(cos_m, jnp.float64)) ** 2 + (xw @ jnp.asarray(sin_m, jnp.float64)) ** 2
    mel = jnp.swapaxes(p @ jnp.asarray(fb[:n_cols], jnp.float64), 1, 2)
    z = JM.standardize(JM.amplitude_to_db(mel, spec.top_db), spec.eps)
    return JM.replicate_channels(JM.finalize_features(z, spec), spec.out_channels)


def _torch_batch(b):
    return {"audio": torch.from_numpy(b["audio"]), "label": torch.from_numpy(b["label"]).long(),
            "weight": torch.from_numpy(b["weight"])}


def _port_state(jax_state, dropout=0.0):
    model = BinaryClassifier("resnet18")
    model.load_state_dict(classifier_state_dict(
        jax.tree_util.tree_map(np.asarray, jax_state.variables())), strict=False)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout) and dropout is not None:
            m.p = dropout
    return TS.create_train_state(model, TrainConfig(batch_size=2, lr=LR))


def _port_step(quirk=False, stage=0, augment=False):
    return TS.make_train_step(TrainConfig(batch_size=2, lr=LR), SpectrogramConfig(out_size=INPUT),
                              SpecAugmentConfig(enabled=augment), reference_quirk_loss=quirk,
                              stop_grad_stage=stage)


def _sd(state):
    return {k: v.detach().numpy().copy() for k, v in state.model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def _moments(state):
    """(count, μ, ν) of a JAX state by the port's parameter names."""
    count, mu, nu = JS.extract_adam_state(state.opt_state)
    return (int(count),) + tuple(torch_state_dict_from_variables(
        {"params": jax.tree_util.tree_map(np.asarray, t)}) for t in (mu, nu))


def assert_matches_jax(port, jax_state, truth, n_steps=1):
    """The port's float32 step against the JAX package's (``jax_state``),
    both against the JAX package's float64 step (``truth``): the Adam
    moments within parity_bounds.reference_error_bound, the parameters and
    BN statistics within the fixed bounds of the module docstring."""
    jv = torch_state_dict_from_variables(jax.tree_util.tree_map(np.asarray,
                                                                jax_state.variables()))
    count, mu, nu = _moments(jax_state)
    _, true_mu, true_nu = _moments(truth)
    assert int(port.count) == count and int(port.step) == int(jax_state.step)
    parity_bounds.assert_moments_within(port.moments(), (mu, nu), (true_mu, true_nu))
    got_sd = _sd(port)
    for k, want in jv.items():
        got = got_sd[k]
        if "running" in k:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=k)
            continue
        well = np.abs(mu[k]) / 0.1 > 1e-6 if k in mu else np.ones(want.shape, bool)
        d = np.abs(got - want)
        assert np.all(d[well] <= 1e-5 * np.abs(want[well]) + 1e-6), k
        assert np.all(d <= 2 * LR * n_steps + 1e-6), k


def test_gradients_match_jax_in_float64(jax_side):
    """The train-mode forward and backward (flax BatchNorm statistics, the
    weighted cross-entropy) are the JAX package's function: in float64
    their gradients agree to 1e-10 relative."""
    from synthetic_audio_detection_tpu.train.steps import _features_from_waveforms

    b = _batch()
    js = jax_side["state"]
    with jax.enable_x64(True):
        model = JaxClassifier(backbone="resnet18", dtype=jnp.float64)
        f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa
        x = np.asarray(_features_from_waveforms(b["audio"], JSpec(out_size=INPUT), None, None,
                                                32_000)).astype(np.float64)
        stats = f64(js.batch_stats)

        def loss_fn(p):
            out, _ = model.apply({"params": p, "batch_stats": stats}, x, train=True,
                                 mutable=["batch_stats"])
            logp = jax.nn.log_softmax(out, -1)
            nll = -jnp.take_along_axis(logp, b["label"][:, None], -1)[:, 0]
            return (nll * b["weight"]).sum() / b["weight"].sum()

        g = jax.jit(jax.grad(loss_fn))(f64(js.params))
        want = torch_state_dict_from_variables({"params": jax.tree_util.tree_map(np.asarray, g)})
    port = _port_state(js).model.double().train()
    out = port(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    tb = _torch_batch(b)
    loss = TS.cross_entropy(out, tb["label"], tb["weight"].double())
    names = [n for n, _ in port.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(port.parameters()))))
    top = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=1e-10, atol=1e-12 * top, err_msg=k)


@pytest.mark.parametrize("quirk", [False, True], ids=["head-loss", "reference-quirk-loss"])
def test_train_step_matches_jax(jax_side, f64_side, quirk):
    js = jax_side["state"]
    new_js, jm = jax_side["quirk" if quirk else "step"](js, _batch(), jax.random.PRNGKey(2))
    port = _port_state(js)
    pm = _port_step(quirk)(port, _torch_batch(_batch()), torch.Generator().manual_seed(0))
    assert float(pm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(pm["accuracy"]) == pytest.approx(float(jm["accuracy"]))
    assert_matches_jax(port, new_js, f64_side(js, _batch(), quirk))
    before, after = _sd(_port_state(js)), _sd(port)
    moved = {k for k in after if not np.array_equal(after[k], before[k])}
    head = {k for k in after if k.startswith("head.")}
    if quirk:  # the reference's bug: the head is not in the loss, and not updated
        assert not moved & head
    else:
        assert head & moved
    assert not any(k.startswith(("base.conv1", "base.layer1", "base.layer3"))
                   and "running" not in k for k in moved)
    assert any(k.startswith("base.layer1") and "running" in k for k in moved)


def test_unfreeze_then_step_matches_jax(jax_side, f64_side):
    """Two phase-1 steps, the layer3 unfreeze, one more step: the global
    Adam count makes layer3's first bias correction that of step 3 (a
    per-parameter count would make it step 1's). The third step starts
    from the JAX package's state after two steps, loaded into the port
    (weights, BN statistics, moments and count, as a resume does): over
    several float32 steps the two trajectories part, as any two float32
    runs of this network do (a ReLU unit near zero flips on a rounding
    difference), so each step is held from a common state. The port stops
    its gradient at the boundary (stage 4, then 3); the JAX steps are
    masked."""
    js = jax_side["state"]
    own = _port_state(js)
    for seed in (1, 2):
        js, _ = jax_side["step"](js, _batch(seed), jax.random.PRNGKey(seed))
        _port_step(stage=4)(own, _torch_batch(_batch(seed)), None)
    assert int(own.count) == 2 and int(own.step) == 2
    port = _port_state(js)
    count, mu, nu = JS.extract_adam_state(js.opt_state)
    to_sd = lambda t: torch_state_dict_from_variables(  # noqa: E731
        {"params": jax.tree_util.tree_map(np.asarray, t)})
    port.set_moments(count, to_sd(mu), to_sd(nu))
    port.step = torch.tensor(2)
    j_before = to_sd(js.params)
    js = JS.unfreeze_layer3(js)
    TS.unfreeze_layer3(port)
    truth = f64_side(js, _batch(3))
    js, _ = jax_side["step"](js, _batch(3), jax.random.PRNGKey(3))
    before = _sd(port)
    _port_step(stage=3)(port, _torch_batch(_batch(3)), None)
    assert int(port.count) == 3
    assert_matches_jax(port, js, truth)
    # layer3's first update: |Δp| ≈ lr·0.64 (count 3), not lr (count 1)
    k = "base.layer3.0.conv1.weight"
    got, want = _sd(port)[k] - before[k], to_sd(js.params)[k] - j_before[k]
    assert 0.5 * LR < float(np.median(np.abs(got))) < 0.8 * LR
    np.testing.assert_allclose(np.median(np.abs(got)), np.median(np.abs(want)), rtol=1e-3)


def _adamw_eps_inside_the_square_root(g, p, mu, nu, count, lr, weight_decay, ok):
    """TS.adamw_update_ with Adam's eps inside the square root: √(ν̂ + eps)
    in place of √ν̂ + eps."""
    b1, b2 = (torch.where(ok, b, 1.0) for b in (TS.B1, TS.B2))
    a1, a2 = (torch.where(ok, 1.0 - b, 0.0) for b in (TS.B1, TS.B2))
    torch._foreach_mul_(nu, b2)
    torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), a2))
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, torch._foreach_mul(g, a1))
    c = (count + 1).float()
    den = torch._foreach_div(nu, 1.0 - torch.pow(TS.B2, c))
    torch._foreach_add_(den, TS.EPS)
    torch._foreach_sqrt_(den)
    u = torch._foreach_div(mu, 1.0 - torch.pow(TS.B1, c))
    torch._foreach_div_(u, den)
    torch._foreach_add_(u, p, alpha=weight_decay)
    torch._foreach_mul_(u, torch.where(ok, -lr, 0.0))
    torch._foreach_add_(p, u)
    return torch.where(ok, count + 1, count)


def test_step_check_rejects_eps_inside_the_square_root(jax_side, f64_side, monkeypatch):
    """Adam's eps inside the square root: where |g| ≈ 1e-5 the update falls
    to a tenth; the parameters' bound rejects it, as it did before the
    moments were held to the float64 step."""
    monkeypatch.setattr(TS, "adamw_update_", _adamw_eps_inside_the_square_root)
    js = jax_side["state"]
    new_js, _ = jax_side["step"](js, _batch(), jax.random.PRNGKey(2))
    port = _port_state(js)
    _port_step()(port, _torch_batch(_batch()), torch.Generator().manual_seed(0))
    with pytest.raises(AssertionError):
        assert_matches_jax(port, new_js, f64_side(js, _batch()))


def test_moment_bound_rejects_a_clip_norm_1_5e_4_high(jax_side, f64_side, monkeypatch):
    """The fault the float64 step found in the port, made on any CPU: the
    clip's global norm 1.5e-4 relative high (as torch's float32 2-norm on
    one CPU was over layer4's 2.4M-gradient convs), which scales every
    moment by as much. Under the reference's quirk loss JAX's own float32
    error on layer4's μ is at most 3e-5 of each tensor's largest, and on
    most of them far less, so the derived bound rejects the fault; the
    fixed 3e-4 against JAX's float32 step let it through."""
    norms = TS.tensor_norms
    monkeypatch.setattr(TS, "tensor_norms", lambda ts: [n * (1 + 1.5e-4) for n in norms(ts)])
    js = jax_side["state"]
    new_js, _ = jax_side["quirk"](js, _batch(), jax.random.PRNGKey(2))
    port = _port_state(js)
    _port_step(True)(port, _torch_batch(_batch()), torch.Generator().manual_seed(0))
    with pytest.raises(AssertionError, match="layer4"):
        assert_matches_jax(port, new_js, f64_side(js, _batch(), True))


def test_nan_batch_skips_the_whole_update(jax_side):
    js = jax_side["state"]
    new_js, jm = jax_side["step"](js, _batch(nan=True), jax.random.PRNGKey(2))
    assert float(jm["skipped"]) == 1.0
    port = _port_state(js)
    fresh = _sd(port)
    _port_step(stage=4)(port, _torch_batch(_batch(nan=True)), None)  # at count 0, as JAX's
    assert int(port.count) == 0 and not any(t.any() for t in port.mu + port.nu)
    for k, v in _sd(port).items():
        np.testing.assert_array_equal(v, fresh[k], err_msg=k)
    _port_step(stage=4)(port, _torch_batch(_batch()), None)  # then a good step
    before, count = _sd(port), int(port.count)
    mu, nu = ([t.clone() for t in m] for m in (port.mu, port.nu))
    pm = _port_step(stage=4)(port, _torch_batch(_batch(nan=True)), None)
    assert float(pm["skipped"]) == 1.0 and not np.isfinite(float(pm["loss"]))
    after = _sd(port)
    for k in before:  # parameters and BN statistics
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    assert all(map(torch.equal, port.mu + port.nu, mu + nu))
    assert int(port.count) == count == 1 and int(port.step) == 3
    assert int(new_js.step) == int(js.step) + 1 and int(JS.extract_adam_state(
        new_js.opt_state)[0]) == 0


@pytest.mark.parametrize("phase", [1, 2])
def test_stop_grad_step_matches_masked_step(jax_side, phase):
    """The gradient stop at the boundary (4 in phase 1, 3 in phase 2) gives
    the masked step's parameters, statistics and moments, and BN statistics
    below the boundary still update (tests/test_stop_grad.py's contract)."""
    stage = 4 if phase == 1 else 3
    states = []
    for s in (0, stage):
        port = _port_state(jax_side["state"])
        if phase == 2:
            TS.unfreeze_layer3(port)
        _port_step(stage=s)(port, _torch_batch(_batch()), None)
        states.append(port)
    masked, stopped = states
    a, b = _sd(masked), _sd(stopped)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=1e-6, atol=1e-7, err_msg=k)
    torch.testing.assert_close(stopped.mu, masked.mu, rtol=1e-6, atol=1e-9)
    torch.testing.assert_close(stopped.nu, masked.nu, rtol=1e-6, atol=1e-12)
    init = _sd(_port_state(jax_side["state"]))
    assert not np.array_equal(b["base.layer1.0.bn1.running_mean"],
                              init["base.layer1.0.bn1.running_mean"])


def test_clip_norm_is_exact_over_a_large_tensor():
    """The clip's global norm over a ResNet-18 layer4 conv's 2.4M gradients
    and a small tensor, against the float64 norm: within 1e-6 relative
    (torch's float32 2-norm on the CPU is about 4e-5 off here)."""
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(2_359_296).astype(np.float32)
                         * 1e-2)
    small = torch.ones(8)
    exact = float(np.sqrt((g.double() ** 2).sum() + 8.0))
    got = [g.clone(), small.clone()]
    TS.clip_by_global_norm_(got, 0.5)
    assert float(got[1][0]) == pytest.approx(0.5 / exact, rel=1e-6)
    norm = torch.linalg.vector_norm(torch.stack(TS.tensor_norms([g, small])))
    assert float(norm) == pytest.approx(exact, rel=1e-12)


@pytest.mark.parametrize("scale", [1e-2, 10.0], ids=["below-the-clip", "above-the-clip"])
def test_clip_and_adamw_match_optax(scale):
    """The optimizer alone against optax.chain(clip_by_global_norm(0.5),
    adamw(1e-3, weight_decay=0.01)) on the same gradients, parameters,
    moments and count, with ‖g‖ below and above the clip. Each tensor is
    held to 1e-6 of its largest magnitude (a moment's two terms can cancel
    to a few ulps of either). At lr 1e-3 the decay term, 1e-5·|p|, is ten
    times that on the new parameters, so a missing, flipped or scaled
    decay fails."""
    import optax

    rng = np.random.default_rng(11)
    shapes = [(8, 3, 3, 3), (8,), (16, 8)]
    g = [(rng.standard_normal(sh) * scale).astype(np.float32) for sh in shapes]
    p = [rng.standard_normal(sh).astype(np.float32) for sh in shapes]
    mu = [(rng.standard_normal(sh) * 1e-2).astype(np.float32) for sh in shapes]
    nu = [(np.abs(rng.standard_normal(sh)) * 1e-4).astype(np.float32) for sh in shapes]
    lr, count = 1e-3, 5
    clip = optax.clip_by_global_norm(0.5)
    tx = optax.chain(clip, optax.adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01))
    empty, (_, *rest) = tx.init(p)
    adam = optax.ScaleByAdamState(count=jnp.asarray(count, jnp.int32), mu=mu, nu=nu)
    updates, (_, (new_adam, *_)) = tx.update(g, (empty, (adam, *rest)), p)
    want_p = optax.apply_updates(p, updates)
    want_g, _ = clip.update(g, clip.init(p))

    norm = float(np.sqrt(sum(float((x.astype(np.float64) ** 2).sum()) for x in g)))
    assert (norm > 0.5) == (scale > 1)
    t = lambda xs: [torch.tensor(x) for x in xs]  # noqa: E731  (copies: updates are in place)

    def run(weight_decay, ok=True, grads=g):
        gs, ps, ms, ns = t(grads), t(p), t(mu), t(nu)
        TS.clip_by_global_norm_(gs, 0.5)
        clipped = [x.clone() for x in gs]
        c = TS.adamw_update_(gs, ps, ms, ns, torch.tensor(count, dtype=torch.int32),
                             torch.tensor(lr, dtype=torch.float32), weight_decay,
                             torch.tensor(ok))
        return clipped, ps, ms, ns, c

    got_g, got_p, got_mu, got_nu, got_count = run(0.01)
    assert int(got_count) == int(new_adam.count) == count + 1
    close = lambda a, b: np.abs(a - b) <= 1e-6 * np.abs(b).max()  # noqa: E731
    for got, want in ((got_g, want_g), (got_p, want_p), (got_mu, new_adam.mu),
                      (got_nu, new_adam.nu)):
        for a, b in zip(got, want):
            assert close(a.numpy(), np.asarray(b)).all()
    # the check sees the decay: without it most new parameters fail
    no_decay = run(0.0)[1]
    assert close(no_decay[0].numpy(), np.asarray(want_p[0])).mean() < 0.5
    # a skipped step (ok false, its gradients zeroed as the train step
    # zeroes them) leaves the parameters, moments and count as they were
    _, sp, smu, snu, sc = run(0.01, ok=False, grads=[np.zeros_like(x) for x in g])
    assert int(sc) == count
    for a, b in zip(sp + smu + snu, p + mu + nu):
        np.testing.assert_array_equal(a.numpy(), b)


def test_eval_step_matches_jax(jax_side):
    js = jax_side["state"]
    want = jax_side["eval"](js.variables(), _batch(4))
    port = _port_state(js)
    got = TS.make_eval_step(SpectrogramConfig(out_size=INPUT))(port.model,
                                                                _torch_batch(_batch(4)))
    np.testing.assert_array_equal(got["confusion"].numpy(), np.asarray(want["confusion"]))
    assert float(got["count"]) == float(want["count"]) == 3.0
    np.testing.assert_allclose(got["probs"].numpy(), np.asarray(want["probs"]), atol=1e-5)
    assert float(got["loss_sum"]) == pytest.approx(float(want["loss_sum"]), rel=1e-5)


def test_features_in_kernel_mode_match_jax():
    """dft_mode='pallas': the dB-only log-mel kernel's plain version (on the
    CPU) against the Pallas kernel in interpret mode, int16 transport, one
    quiet row; the model input after standardize and the resize, within
    the K1 tests' 1e-3 of the dB plane carried through (z-scores). A zero
    row gives finite features."""
    from synthetic_audio_detection_tpu.train.steps import _features_from_waveforms

    rng = np.random.default_rng(6)
    audio = (rng.standard_normal((3, 32_000)) * 0.2).astype(np.float32)
    audio[2] *= 1e-3
    pcm = np.round(audio * 32768.0).astype(np.int16)
    want = np.asarray(_features_from_waveforms(jnp.asarray(pcm), JSpec(out_size=INPUT), None,
                                               None, 32_000, dft_mode="pallas"))
    got = TS.features_from_waveforms(torch.from_numpy(pcm), SpectrogramConfig(out_size=INPUT),
                                     None, None, 32_000, dft_mode="pallas")
    assert got.shape == (3, 3, INPUT, INPUT)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-3, rtol=0)
    zero = TS.features_from_waveforms(torch.zeros((1, 32_000), dtype=torch.int16),
                                      SpectrogramConfig(out_size=INPUT), None, None, 32_000,
                                      dft_mode="pallas")
    assert bool(torch.isfinite(zero).all())


def test_dropout_is_live_and_follows_the_generator(jax_side):
    """With the head's rates at 0.5 / 0.3 the step depends on its generator:
    the same seed gives the same step, another seed another."""
    outs = []
    for seed in (5, 5, 6):
        port = _port_state(jax_side["state"], dropout=None)
        _port_step(stage=4, augment=True)(port, _torch_batch(_batch()),
                                          torch.Generator().manual_seed(seed))
        outs.append(torch.cat([t.reshape(-1) for t in port.mu]))
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    port = _port_state(jax_side["state"], dropout=None)
    rates = [m.p for m in port.model.modules() if isinstance(m, torch.nn.Dropout)]
    assert rates == [0.5, 0.3]


def test_freeze_mask_prefixes_match_jax(jax_side):
    port = _port_state(jax_side["state"])
    names = port.names
    flat = dict(zip(names, [None] * len(names)))
    for prefixes in (TS.PHASE1_PREFIXES, TS.PHASE2_PREFIXES):
        params = jax_side["state"].params
        jm = torch_state_dict_from_variables({"params": jax.tree_util.tree_map(
            lambda m, p: np.full(p.shape, float(m), np.float32),
            JS.freeze_mask(params, prefixes), params)})
        got = TS.freeze_mask(names, prefixes)
        assert set(got) == set(flat) == set(jm)
        assert all(np.all(jm[k] == got[k]) for k in got)


@pytest.mark.parametrize("shape", [(4, 8), (4, 6, 5, 5)], ids=["BatchNorm1d", "BatchNorm2d"])
def test_batchnorm_train_mode_follows_flax(shape):
    """The fault this slice repairs in models/: torch's nn.BatchNorm*d
    updates running_var with the unbiased batch variance (4/3 of flax's
    at 4 rows). The port's FlaxBatchNorm*d gives flax's output and
    running statistics (momentum 0.9, biased variance) in train mode, and
    PyTorch's own eval mode."""
    from synthetic_audio_detection_tpu.models.resnet import BN_EPS as JEPS
    from synthetic_audio_detection_tpu.models.resnet import BN_MOMENTUM
    from synthetic_audio_detection_tpu_torch.models.resnet import FlaxBatchNorm1d, FlaxBatchNorm2d

    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32) * 2 + 0.5
    c = shape[1]
    bn = fnn.BatchNorm(use_running_average=False, momentum=BN_MOMENTUM, epsilon=JEPS)
    x_nhwc = x if x.ndim == 2 else x.transpose(0, 2, 3, 1)
    variables = bn.init(jax.random.PRNGKey(0), x_nhwc)
    variables = {"params": {"scale": jnp.linspace(0.5, 1.5, c), "bias": jnp.linspace(-1, 1, c)},
                 "batch_stats": variables["batch_stats"]}
    want, mutated = bn.apply(variables, x_nhwc, mutable=["batch_stats"])
    want = np.asarray(want) if x.ndim == 2 else np.asarray(want).transpose(0, 3, 1, 2)
    port = (FlaxBatchNorm1d if x.ndim == 2 else FlaxBatchNorm2d)(c, eps=1e-5, momentum=0.1)
    with torch.no_grad():
        port.weight.copy_(torch.linspace(0.5, 1.5, c))
        port.bias.copy_(torch.linspace(-1, 1, c))
    got = port.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=0)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(mutated["batch_stats"][key]), rtol=1e-6, atol=1e-7)
    plain = (torch.nn.BatchNorm1d if x.ndim == 2 else torch.nn.BatchNorm2d)(c)
    plain.train()(torch.from_numpy(x))
    assert not np.allclose(plain.running_var.numpy(), port.running_var.numpy(), rtol=1e-3)
    port.eval()
    plain.load_state_dict(port.state_dict())
    torch.testing.assert_close(port(torch.from_numpy(x)), plain.eval()(torch.from_numpy(x)))
