"""The port's joint train and eval steps against the JAX package's
(``train/joint.py``), on the CPU: ResNet-18 at 64², 3 heads (2 specialists
and the generic head, or 3 specialists), 6 rows of 1-s audio (the last
weighted 0, a quiet row as in tests/test_torch_train_step.py), the JAX
package's initial state carried into the port by
``checkpoints/from_jax.py:joint_state_from_jax``.

Random draws cannot match between the packages, so SpecAugment and the
crop are off and dropout is neutralised (flax.linen.Dropout swapped for an
identity inside this module; the port's rates set to 0), as in
tests/test_torch_train_step.py. Tolerances are that file's: float64
gradients to 1e-10 relative; one float32 step from a common state with BN
statistics to 1e-5 + 1e-5 relative, moments to 3e-4 relative + 3e-4 of
the tensor's scale, parameters to 1e-5 relative + 1e-6 where the AdamW
step is well conditioned and one step's reach (2·lr) elsewhere; the
optimizer alone to 1e-6 of each tensor's largest magnitude.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from synthetic_audio_detection_tpu.train import joint as JJ
from synthetic_audio_detection_tpu.train import steps as JS
from synthetic_audio_detection_tpu.utils.config import SpecAugmentConfig as JAug
from synthetic_audio_detection_tpu.utils.config import SpectrogramConfig as JSpec
from synthetic_audio_detection_tpu.utils.config import TrainConfig as JCfg
from synthetic_audio_detection_tpu_torch.checkpoints import serialization as TSer
from synthetic_audio_detection_tpu_torch.checkpoints.from_jax import joint_state_from_jax
from synthetic_audio_detection_tpu_torch.train import joint
from synthetic_audio_detection_tpu_torch.train import steps as TS
from synthetic_audio_detection_tpu_torch.utils.config import (
    SpecAugmentConfig,
    SpectrogramConfig,
    TrainConfig,
)

LR = 1e-5
INPUT = 64
N_HEADS = 3
# (per_head_stages, hard_negatives, generic_head): every K, both label
# regimes, with and without the generic head (K = 2 in both regimes)
CASES = [(0, True, False), (1, False, True), (2, True, False), (2, False, True)]
CASE_IDS = [f"K{k}-{'hard' if h else 'ovr'}{'-generic' if g else ''}" for k, h, g in CASES]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module's CPU work, restored after."""
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


@pytest.fixture(scope="module")
def no_dropout():
    mp = pytest.MonkeyPatch()
    mp.setattr(fnn, "Dropout", _NoDropout)
    yield
    mp.undo()


_STATES = {}


def jax_state(k: int):
    """The JAX package's initial joint state for K (jitted init, cached)."""
    if k not in _STATES:
        init = jax.jit(lambda key: JJ.init_joint_state(
            "resnet18", N_HEADS, key, JCfg(lr=LR), (INPUT, INPUT), per_head_stages=k)[0])
        _STATES[k] = init(jax.random.PRNGKey(k))
    return _STATES[k]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_state(js, k: int) -> TS.TrainState:
    """The port's joint state carrying ``js`` (weights, BN statistics,
    moments, count, step), dropout off."""
    state = joint.init_joint_state("resnet18", N_HEADS, torch.Generator().manual_seed(0),
                                   TrainConfig(lr=LR), k)
    joint_state_from_jax(state, _np({"params": js.params, "batch_stats": js.batch_stats}),
                         JS.extract_adam_state(js.opt_state), int(js.step))
    for m in state.model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return state


def _batch(seed=1, nan=False):
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((6, 32_000)) * 0.2).astype(np.float32)
    audio[5] *= 1e-3  # a row weighted 0, as the trainer's pad rows
    if nan:
        audio[0, 0] = np.nan
    return {"audio": audio, "label": np.array([0, 1, 2, 3, 1, 0], np.int32),
            "weight": np.array([1, 1, 1, 1, 1, 0], np.float32)}


def _torch_batch(b):
    return {"audio": torch.from_numpy(b["audio"]), "label": torch.from_numpy(b["label"]).long(),
            "weight": torch.from_numpy(b["weight"])}


def _named(state):
    return {k: v.detach().numpy().copy() for k, v in state.model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def _port_step(k, hard, generic, stage=4):
    return joint.make_joint_train_step(
        TrainConfig(lr=LR), SpectrogramConfig(out_size=INPUT), SpecAugmentConfig(enabled=False),
        N_HEADS, stop_grad_stage=stage, hard_negatives=hard, generic_head=generic)


def _jax_step(k, hard, generic, tx=None, dtype=jnp.float32, stage=4):
    return jax.jit(JJ.make_joint_train_step(
        "resnet18", tx or JS.make_optimizer(JCfg(lr=LR)), JCfg(lr=LR), JSpec(out_size=INPUT),
        JAug(enabled=False), N_HEADS, stop_grad_stage=stage, dtype=dtype, per_head_stages=k,
        hard_negatives=hard, generic_head=generic))


@pytest.mark.parametrize("generic", [False, True], ids=["specialists", "generic"])
def test_labels_and_masks_match_jax(generic):
    labels = np.array([0, 1, 2, 3, 2, 0], np.int32)
    weights = np.array([1, 1, 1, 1, 0, 1], np.float32)
    want_y = np.asarray(JJ.per_head_binary_labels(jnp.asarray(labels), 4, generic))
    want_w = np.asarray(JJ.per_head_own_mask(jnp.asarray(labels), 4, jnp.asarray(weights),
                                             generic))
    tl = torch.from_numpy(labels).long()
    np.testing.assert_array_equal(joint.per_head_binary_labels(tl, 4, generic).numpy(), want_y)
    np.testing.assert_array_equal(
        joint.per_head_own_mask(tl, 4, torch.from_numpy(weights), generic).numpy(), want_w)
    if generic:  # the generic head is last: positive on every synthetic row, sees every row
        np.testing.assert_array_equal(want_y[-1], labels != 0)
        np.testing.assert_array_equal(want_w[-1], weights)


def _capture_tx():
    """An optimizer whose state keeps the (masked) gradients it is given
    and whose updates are zero: the JAX step's gradients, read back."""
    tx = optax.GradientTransformation(
        lambda p: {"g": jax.tree_util.tree_map(jnp.zeros_like, p)},
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), {"g": g}))
    return optax.inject_hyperparams(lambda lr: tx)(lr=1.0)


def _cross_entropy_keeping_dtype(logits, labels, weights=None):
    """JAX's steps.cross_entropy without its cast of the logits to float32
    (the same formula), so that a float64 step stays float64."""
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, labels[:, None], axis=-1)[:, 0]
    if weights is None:
        return nll.mean()
    w = weights.astype(logits.dtype)
    return (nll * w).sum() / jnp.maximum(w.sum(), 1.0)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_gradients_match_jax_in_float64(case, no_dropout, monkeypatch):
    """make_joint_train_step's gradients (phase 1, the gradient stopped at
    stage 4, masked) against the port's joint forward and loss in float64,
    1e-10 relative, on the same model input (JAX's features and, for its
    float32 cast, its cross-entropy are swapped inside this test). With K = 2 each tail's layer3
    runs without autograd: the port gives it no gradient (a zero one in the
    step) though it is trainable, as JAX's is zero under mask 1."""
    k, hard, generic = case
    x = np.random.default_rng(3).standard_normal((6, INPUT, INPUT, 3))
    b = _batch()
    js = jax_state(k)
    monkeypatch.setattr(JS, "_features_from_waveforms", lambda *a, **kw: jnp.asarray(x))
    monkeypatch.setattr(JS, "cross_entropy", _cross_entropy_keeping_dtype)
    tx = _capture_tx()
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa
        p64 = f64(js.params)
        s64 = js.replace(params=p64, batch_stats=f64(js.batch_stats), opt_state=tx.init(p64),
                         lr_scale=jnp.ones((), jnp.float64))
        new, _ = _jax_step(k, hard, generic, tx=tx, dtype=jnp.float64)(
            s64, dict(b, weight=b["weight"].astype(np.float64)), jax.random.PRNGKey(0))
        want = TSer.joint_named({"params": _np(new.opt_state.inner_state["g"])})
    port = port_state(js, k)
    model = port.model.double().train()
    model.set_stop_grad_stage(4)
    tb = _torch_batch(b)
    labels, weights = tb["label"], tb["weight"].double()
    y = joint.per_head_binary_labels(labels, N_HEADS, generic)
    w = None if hard else joint.per_head_own_mask(labels, N_HEADS, weights, generic)
    loss, _ = joint.joint_loss(model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()), y,
                               weights, w)
    grads = dict(zip(port.names, torch.autograd.grad(loss, port.params, allow_unused=True)))
    mask = dict(zip(port.names, port.mask))
    top = max(float(np.abs(v).max()) for v in want.values())
    for name, g in grads.items():
        got = np.zeros_like(want[name]) if g is None else g.numpy() * mask[name]
        np.testing.assert_allclose(got, want[name], rtol=1e-10, atol=1e-12 * top, err_msg=name)
    tail3 = [n for n in port.names if ".tail.layer3." in n]
    assert bool(tail3) == (k == 2)
    assert all(grads[n] is None and mask[n] == 1.0 for n in tail3)
    assert all(not want[n].any() for n in tail3)


def test_nan_batch_changes_only_the_step_counter():
    """A non-finite loss keeps parameters, BN statistics, moments and the
    Adam count; the step counter advances (no host sync decides it)."""
    state = joint.init_joint_state("resnet18", N_HEADS, torch.Generator().manual_seed(1),
                                   TrainConfig(lr=LR), 1)
    step = _port_step(1, False, True)
    step(state, _torch_batch(_batch()), torch.Generator().manual_seed(0))  # nonzero moments
    before = _named(state)
    mu, nu = ([t.clone() for t in m] for m in (state.mu, state.nu))
    pm = step(state, _torch_batch(_batch(nan=True)), torch.Generator().manual_seed(0))
    assert float(pm["skipped"]) == 1.0 and not np.isfinite(float(pm["loss"]))
    after = _named(state)
    for n in before:
        np.testing.assert_array_equal(after[n], before[n], err_msg=n)
    assert all(map(torch.equal, state.mu + state.nu, mu + nu))
    assert int(state.count) == 1 and int(state.step) == 2


def test_optimizer_matches_optax_with_one_global_clip():
    """apply_update_ over a joint tree against the reference's masked step
    (inject_hyperparams(chain(clip_by_global_norm(0.5), adamw)), the
    gradients and updates masked): the norm is taken over the trunk and
    every head together (a per-subtree clip gives other parameters), a
    frozen trunk tensor keeps its value while its moments decay, and a
    trainable tail tensor without a gradient is decayed by AdamW."""
    rng = np.random.default_rng(7)
    shapes = {"base.a": (8, 3, 3, 3), "base.layer4.b": (16,), "heads.0.c": (16, 8),
              "heads.0.tail.d": (8,)}
    mask = {"base.a": 0.0, "base.layer4.b": 1.0, "heads.0.c": 1.0, "heads.0.tail.d": 1.0}
    p = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    g = {n: (rng.standard_normal(s) * 10).astype(np.float32) for n, s in shapes.items()}
    g["heads.0.tail.d"] = np.zeros(shapes["heads.0.tail.d"], np.float32)  # not in the graph
    mu = {n: (rng.standard_normal(s) * 1e-2).astype(np.float32) for n, s in shapes.items()}
    nu = {n: (np.abs(rng.standard_normal(s)) * 1e-4).astype(np.float32) for n, s in shapes.items()}
    mu["heads.0.tail.d"] = np.zeros_like(mu["heads.0.tail.d"])
    nu["heads.0.tail.d"] = np.zeros_like(nu["heads.0.tail.d"])
    count, lr, scale = 5, 1e-3, 0.5
    tree = lambda d: {"base": {k: d[k] for k in d if k.startswith("base")},  # noqa: E731
                      "heads": {k: d[k] for k in d if k.startswith("heads")}}

    cfg = JCfg(lr=lr)
    tx = JS.make_optimizer(cfg)
    opt = JS.replace_adam_state(tx.init(tree(p)), count, tree(mu), tree(nu))
    opt.hyperparams["lr"] = cfg.lr * scale
    jm = tree(mask)
    jg = jax.tree_util.tree_map(lambda a, m: a * m, tree(g), jm)
    updates, new_opt = tx.update(jg, opt, tree(p))
    want_p = optax.apply_updates(tree(p), jax.tree_util.tree_map(lambda u, m: u * m, updates, jm))
    want_count, want_mu, want_nu = JS.extract_adam_state(new_opt)

    class Params(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.ps = torch.nn.ParameterDict({n.replace(".", "_"): torch.nn.Parameter(
                torch.tensor(v)) for n, v in p.items()})

    module = Params()
    state = TS.create_train_state(module, TrainConfig(lr=lr))
    names = list(p)
    state.names, state.mask = [f"ps.{n.replace('.', '_')}" for n in names], [mask[n] for n in names]
    state.mu, state.nu = [torch.tensor(mu[n]) for n in names], [torch.tensor(nu[n]) for n in names]
    state.count = torch.tensor(count, dtype=torch.int32)
    state.lr_scale = torch.tensor(scale)
    grads = [None if n == "heads.0.tail.d" else torch.tensor(g[n]) for n in names]
    ok = TS.apply_update_(state, grads, torch.tensor(1.0), TrainConfig(lr=lr), [], [])
    assert bool(ok) and int(state.count) == want_count == count + 1
    flat = lambda t: {k: np.asarray(v) for sub in t.values() for k, v in sub.items()}  # noqa
    close = lambda a, b: np.all(np.abs(a - b) <= 1e-6 * np.abs(b).max())  # noqa: E731
    for i, n in enumerate(names):
        assert close(state.params[i].detach().numpy(), flat(want_p)[n]), n
        assert close(state.mu[i].numpy(), flat(want_mu)[n]), n
        assert close(state.nu[i].numpy(), flat(want_nu)[n]), n
    assert np.array_equal(state.params[0].detach().numpy(), p["base.a"])  # frozen
    d = state.params[names.index("heads.0.tail.d")].detach().numpy()
    np.testing.assert_allclose(d, p["heads.0.tail.d"] * (1 - lr * scale * 0.01), rtol=1e-6)
    # the clip is one norm over both subtrees: clipping each alone moves the heads otherwise
    live = [n for n in names if mask[n]]
    norm_all = np.sqrt(sum(float((g[n].astype(np.float64) ** 2).sum()) for n in live))
    norm_heads = np.sqrt(sum(float((g[n].astype(np.float64) ** 2).sum()) for n in live
                             if n.startswith("heads")))
    assert norm_all > norm_heads > 0.5
