"""The port's steps and serving over torch.distributed, on the CPU: gloo
process groups of 2-4 ranks (tests/torch_dist.py runs each rank in its own
process), the twins of the JAX package's multi-device tests.

Each ranked step is held to two references on the same initial weights
(the JAX package's init, carried by checkpoints/from_jax.py) and the same
global batch of 4 rows, the last quiet noise weighted 0 (a pad row, held
by the last data rank only, so the padding falls unevenly): the port's
one-process step on the global batch, and the JAX package's unsharded
step. Adam runs with eps = 1e-4 on every side, as the JAX package's own
sharded-step test does (tests/test_joint_train.py): with eps = 1e-8 the
first step's g / (|g| + eps) turns a last-ulp gradient difference on a
near-zero entry into ±lr.

Tolerances, against either reference: the loss 5e-5 relative; BN running
statistics 1e-5 relative + 1e-5 (tests/test_torch_train_step.py's);
parameters within twice what the gradients' difference explains
(_param_bound: the first step moves an element by lr·g / (|g| + eps), so
a gradient difference δ moves it by at most lr·eps·δ / (|g| + eps)², |g|
the smallest on the way; g is μ / (1 − b1) on either side); the Adam
moments 1e-3 relative + 1e-3 of the tensor's
scale (at least 1e-2 of the model's largest). Ranked against one process,
only the reduction order differs (the BatchNorm sums, the gradients summed
over the ranks), but this tiny network amplifies rounding a thousandfold
(layer4 at 2×2, BatchNorm over 16 values a channel): the one-process
step against itself at 1, 2 and 4 intra-op threads differs by 7e-6
relative in the loss (the joint step's by 2.1e-5) and by up to 0.73 of tests/test_torch_train_step.py's
3e-4 moment bound (the second moments of head.2.weight), the ranked step
by up to 1.13 of it, hence 1e-3. A Linear bias before a BatchNorm has a
gradient of rounding noise only: its moments are held below 1e-5 of the
model's largest on every side. The ranks agree with each other bit for
bit.
"""

import re
import shutil

import jax
import numpy as np
import optax
import parity_bounds
import pytest
import torch

import flax.linen as fnn
from synthetic_audio_detection_tpu.checkpoints.torch_compat import torch_state_dict_from_variables
from synthetic_audio_detection_tpu.models.classifier import BinaryClassifier as JaxClassifier
from synthetic_audio_detection_tpu.train import joint as JJ
from synthetic_audio_detection_tpu.train import steps as JS
from synthetic_audio_detection_tpu.utils.config import SpecAugmentConfig as JAug
from synthetic_audio_detection_tpu.utils.config import SpectrogramConfig as JSpec
from synthetic_audio_detection_tpu.utils.config import TrainConfig as JCfg
from synthetic_audio_detection_tpu_torch.checkpoints import serialization as TSer
from synthetic_audio_detection_tpu_torch.checkpoints.from_jax import classifier_state_dict
from synthetic_audio_detection_tpu_torch.checkpoints.serialization import save_merged_torch
from synthetic_audio_detection_tpu_torch.ensemble.multihead import build_ensemble
from synthetic_audio_detection_tpu_torch.infer.pipeline import InferencePipeline
from synthetic_audio_detection_tpu_torch.models.classifier import BinaryClassifier
from synthetic_audio_detection_tpu_torch.models.init import flax_default_init_
from synthetic_audio_detection_tpu_torch.utils.config import InferenceConfig, SpectrogramConfig
from tests import torch_dist as td

LR = 1e-3
EPS = 1e-4
STAGE = 4  # the trainer's phase-1 gradient stop
N_HEADS = 2
# a head's Linear biases before its BatchNorms (head.2, head.6): the
# BatchNorm takes out their effect, so their gradient is 0 but for rounding
BN_FED_BIAS = re.compile(r"heads?(\.\d+)?\.(2|6)\.bias$")


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


def _tx(cfg):
    """The JAX package's clip and AdamW with the large eps."""
    return optax.inject_hyperparams(lambda lr: optax.chain(
        optax.clip_by_global_norm(cfg.grad_clip_norm),
        optax.adamw(lr, eps=EPS, weight_decay=cfg.weight_decay)))(lr=cfg.lr)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX package's initial states and unsharded steps (dropout
    swapped out for the module, as tests/test_torch_train_step.py does),
    each run once on the global batch."""
    mp = pytest.MonkeyPatch()
    mp.setattr(fnn, "Dropout", _NoDropout)
    cfg = JCfg(batch_size=2, lr=LR)
    spec = JSpec(out_size=td.INPUT)
    tx = _tx(cfg)
    model = JaxClassifier(backbone="resnet18")
    state, _ = JS.create_train_state(model, jax.random.PRNGKey(0), cfg, input_size=td.INPUT)
    state = state.replace(opt_state=tx.init(state.params))
    step = jax.jit(JS.make_train_step(model, tx, cfg, spec, JAug(enabled=False),
                                      stop_grad_stage=STAGE))
    after, m = step(state, _batch(), jax.random.PRNGKey(2))
    jstate, _ = JJ.init_joint_state("resnet18", N_HEADS, jax.random.PRNGKey(0), cfg,
                                    (td.INPUT, td.INPUT))
    jstate = jstate.replace(opt_state=tx.init(jstate.params))
    jstep = jax.jit(JJ.make_joint_train_step("resnet18", tx, cfg, spec, JAug(enabled=False),
                                             num_heads=N_HEADS, stop_grad_stage=STAGE))
    jafter, jm = jstep(jstate, _batch(JOINT_LABELS), jax.random.PRNGKey(2))
    yield {"submodel": (state, after, m), "joint": (jstate, jafter, jm)}
    mp.undo()


def _batch(labels=(0, 1, 1, 0)):
    """The global batch; the joint steps' labels are corpus labels 0..N."""
    rng = np.random.default_rng(1)
    audio = (rng.standard_normal((4, 32_000)) * 0.2).astype(np.float32)
    audio[3] *= 1e-3  # the pad row: quiet noise, weighted 0 (tests/test_torch_train_step.py)
    return {"audio": audio, "label": np.array(labels, np.int64),
            "weight": np.array([1, 1, 1, 0], np.float32)}


JOINT_LABELS = (0, 1, 2, 1)


def _inputs(state_dict, augment=False, dropout=False, batch=None, **extra):
    return dict(state_dict=state_dict, batch=batch or _batch(), augment=augment,
                dropout=dropout, stage=STAGE, eps=EPS, lr=LR, seed=3, **extra)


def _submodel_sd(jax_state):
    return classifier_state_dict(_np(jax_state.variables()))


def _joint_sd(jax_state):
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in TSer.joint_named(
        _np({"params": jax_state.params, "batch_stats": jax_state.batch_stats})).items()}


def _assert_ranks_agree(ranks, keys=("sd", "mu", "nu")):
    """Every rank holds the same model and optimizer state, bit for bit
    (with a model axis: the same trunk, and each head where it is held)."""
    for other in ranks[1:]:
        for part in keys:
            for k in set(ranks[0][part]) & set(other[part]):
                assert torch.equal(ranks[0][part][k], other[part][k]), (part, k)
        assert other["count"] == ranks[0]["count"]
        assert other.get("loss") == ranks[0].get("loss")


def _assert_matches_one_process(got, one):
    assert got["count"] == one["count"] == 1
    assert set(got["sd"]) == set(one["sd"])
    _assert_close(got, one["sd"], one["mu"], one["nu"], one["loss"])


def _assert_close(got, sd, mu, nu, loss):
    np32 = lambda d: {k: np.asarray(v, np.float32) for k, v in d.items()}  # noqa: E731
    sd, mu, nu = np32(sd), np32(mu), np32(nu)
    assert got["loss"] == pytest.approx(float(loss), rel=5e-5)
    for part, want_tree in (("mu", mu), ("nu", nu)):
        top = max(float(np.abs(v).max()) for v in want_tree.values())
        for k, want in want_tree.items():
            if BN_FED_BIAS.search(k):  # its gradient is 0 but for rounding, on every side
                assert np.abs(got[part][k].numpy()).max() <= 1e-5 * top, (part, k)
                assert np.abs(want).max() <= 1e-5 * top, (part, k)
                continue
            scale = max(float(np.abs(want).max()), 1e-2 * top)
            d = np.abs(got[part][k].numpy() - want)
            assert np.all(d <= 1e-3 * np.abs(want) + 1e-3 * scale), (part, k)
    for k, want in sd.items():
        if k in mu:
            parity_bounds.assert_within(got["sd"][k].numpy(), want,
                                        _param_bound(got["mu"][k].numpy(), mu[k], want), k)
        else:
            np.testing.assert_allclose(got["sd"][k].numpy(), want, rtol=1e-5, atol=1e-5,
                                       err_msg=k)


def _param_bound(mu_got, mu_want, p):
    """How far two first AdamW steps from the same parameter ``p`` may lie
    apart given their first moments: the step's update is
    g / (√ν̂ + eps) = g / (|g| + eps) with g = μ / (1 − b1), whose slope
    eps / (|g| + eps)² is largest where |g| is smallest, so the two
    parameters differ by at most lr·eps·|Δg| / (m + eps)², m the smaller
    |g| of the two (0 where their signs differ). That bound is met to
    first order wherever Δg is small against |g| + eps, so it is taken
    twice, to hold a consistent pair at half of it. The update's own float32
    rounding (the bias corrections, the square root, the division, the
    decay and the product with lr) is within 8u of lr. Each side's
    parameter is then its own update rounded to float32, so where the
    updates agree to within that the two may still land an ulp apart, on
    either side of a rounding boundary: two ulps of ``p`` hold such a pair
    at half the bound."""
    g_got, g_want = (np.asarray(m, np.float64) / (1.0 - 0.9) for m in (mu_got, mu_want))
    m = np.where(np.sign(g_got) == np.sign(g_want), np.minimum(np.abs(g_got), np.abs(g_want)), 0)
    ulp = np.spacing(np.abs(np.asarray(p, np.float32))).astype(np.float64)
    first = LR * EPS * np.abs(g_got - g_want) / (m + EPS) ** 2
    return 2 * first + 8 * parity_bounds.U * LR + 2 * ulp


def _assert_matches_jax(got, jax_after, jax_m, named):
    count, mu, nu = JS.extract_adam_state(jax_after.opt_state)
    assert got["count"] == count
    _assert_close(got, named({"params": _np(jax_after.params),
                              "batch_stats": _np(jax_after.batch_stats)}),
                  named({"params": _np(mu)}), named({"params": _np(nu)}), jax_m["loss"])


def test_two_process_sum(tmp_path):
    """The twin of the JAX package's cross-process collective: each rank a
    [1, 2] block of rank + 1, summed over both."""
    ranks = td.run_ranks("sum", 2, tmp_path)
    for r in ranks:
        assert "DIST_SUM 6.0" in r["stdout"], r["stdout"]


def test_data_parallel_step_is_the_one_process_step(jax_steps, tmp_path):
    """The submodel step on 2 data ranks (the pad row on the second only)
    equals the port's one-process step on the global batch and the JAX
    package's unsharded step; both ranks end bit-identical."""
    state, after, m = jax_steps["submodel"]
    inp = _inputs(_submodel_sd(state))
    torch.save(inp, tmp_path / "inputs.pt")
    ranks = td.run_ranks("submodel", 2, tmp_path)
    _assert_ranks_agree(ranks)
    one = td.submodel_step(inp)
    _assert_matches_one_process(ranks[0], one)
    named = lambda t: {k: np.asarray(v)  # noqa: E731
                       for k, v in torch_state_dict_from_variables(t).items()}
    _assert_matches_jax(ranks[0], after, m, named)
    _assert_matches_jax(one, after, m, named)


def test_data_parallel_step_draws_the_global_batchs_augmentation(jax_steps, tmp_path):
    """With SpecAugment, the crop, the waveform augmentation and dropout
    live, each rank draws the global batch's random numbers and keeps its
    rows: the step is still the one-process step."""
    inp = _inputs(_submodel_sd(jax_steps["submodel"][0]), augment=True, dropout=True)
    torch.save(inp, tmp_path / "inputs.pt")
    ranks = td.run_ranks("submodel", 2, tmp_path)
    _assert_ranks_agree(ranks)
    one = td.submodel_step(inp)
    _assert_matches_one_process(ranks[0], one)
    off = td.submodel_step(dict(inp, seed=inp["seed"] + 1))
    assert abs(off["loss"] - one["loss"]) > 1e-6  # the draws do move the step


def test_parameter_bound_rejects_eps_inside_the_square_root(jax_steps, monkeypatch):
    """Adam's eps inside the square root in the port's one-process step:
    the moments do not change and hold to their bound; the parameters'
    bound rejects the update."""
    from tests.test_torch_train_step import _adamw_eps_inside_the_square_root

    state, after, m = jax_steps["submodel"]
    monkeypatch.setattr(td.steps, "adamw_update_", _adamw_eps_inside_the_square_root)
    one = td.submodel_step(_inputs(_submodel_sd(state)))
    named = lambda t: {k: np.asarray(v)  # noqa: E731
                       for k, v in torch_state_dict_from_variables(t).items()}
    with pytest.raises(AssertionError, match="beyond the bound"):
        _assert_matches_jax(one, after, m, named)


def test_head_parallel_joint_step_is_the_one_process_step(jax_steps, tmp_path):
    """The joint step on a 2 × 2 mesh (rows over data, one of the two heads
    a rank over model) equals the port's one-process joint step and the
    JAX package's unsharded one: every head where it is held, the trunk on
    every rank."""
    jstate, jafter, jm = jax_steps["joint"]
    inp = _inputs(_joint_sd(jstate), batch=_batch(JOINT_LABELS), num_heads=N_HEADS)
    torch.save(inp, tmp_path / "inputs.pt")
    ranks = td.run_ranks("joint", 4, tmp_path, model=2)
    _assert_ranks_agree(ranks)
    for rank, r in enumerate(ranks):  # rank = 2·d + m holds head m
        assert {k.split(".")[1] for k in r["sd"] if k.startswith("heads.")} == {str(rank % 2)}
    merged = {part: {k: v for r in ranks for k, v in r[part].items()} for part in ("sd", "mu", "nu")}
    got = dict(ranks[0], **merged)
    one = td.joint_step(inp)
    _assert_matches_one_process(got, one)
    np.testing.assert_allclose(ranks[0]["per_head_loss"], one["per_head_loss"], rtol=5e-5)
    np.testing.assert_array_equal(ranks[0]["per_head_accuracy"], one["per_head_accuracy"])
    named = lambda t: {k: np.asarray(v) for k, v in TSer.joint_named(t).items()}  # noqa: E731
    _assert_matches_jax(got, jafter, jm, named)


def test_data_parallel_serving_matches_one_process(tmp_path):
    """InferencePipeline(mesh=...) on 2 data ranks against the one-process
    pipeline (rtol/atol 1e-4, as tests/test_sharded_infer.py), an odd
    batch included; each batch makes exactly one all-gather and no other
    collective, per-head diagnostics included."""
    sds = []
    for i in range(2):
        clf = BinaryClassifier("resnet18")
        flax_default_init_(clf, torch.Generator().manual_seed(i))
        sds.append(clf.state_dict())
    ens = build_ensemble(sds, ["A", "B", "Real"], detect_shared_backbone=False)
    save_merged_torch(str(tmp_path / "m.pth"), ens)
    windows = (np.random.default_rng(4).standard_normal((16, 32_000)) * 0.3).astype(np.float32)
    calls = [("full", 16), ("odd", 7), ("per_head", 16)]
    torch.save({"merged": str(tmp_path / "m.pth"), "windows": windows, "batch_size": 16,
                "calls": calls}, tmp_path / "inputs.pt")
    ranks = td.run_ranks("serving", 2, tmp_path)
    single = InferencePipeline(ens, spec=SpectrogramConfig(mel_norm="slaney", out_size=td.INPUT),
                               infer=InferenceConfig(batch_size=16), device="cpu")
    ref, ref_nh = single.logits_and_per_head(windows)
    for r in ranks:
        np.testing.assert_allclose(r["full"], ref, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r["odd"], ref[:7], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r["per_head"][0], ref, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r["per_head"][1], ref_nh, rtol=1e-4, atol=1e-4)
        for name, _ in calls:
            assert r[name + "_counts"] == {"all_gather": 1}, (name, r[name + "_counts"])


def test_train_step_collectives_do_not_grow_with_ranks(jax_steps, tmp_path):
    """The submodel step's collectives on 2 and on 3 data ranks (6 rows):
    the same all-reduces, and nothing else."""
    batch = {"audio": (np.random.default_rng(5).standard_normal((6, 32_000)) * 0.2
                       ).astype(np.float32),
             "label": np.array([0, 1, 1, 0, 1, 0]), "weight": np.ones(6, np.float32)}
    counts = {}
    for world in (2, 3):
        work = tmp_path / str(world)
        work.mkdir()
        torch.save(_inputs(_submodel_sd(jax_steps["submodel"][0]), augment=True, batch=batch),
                   work / "inputs.pt")
        counts[world] = [r["counts"] for r in td.run_ranks("submodel", world, work)]
    assert all(c == counts[2][0] for w in counts for c in counts[w]), counts
    # the global weight sum, one a train-mode BatchNorm (20 + 2), one more
    # in the backward of each past the stop at stage 4 (5 + 2), the
    # gradients, the metrics: chip_smoke's STEP_ALL_REDUCES
    assert counts[2][0] == {"all_reduce": 1 + 22 + 7 + 1 + 1}, counts


@pytest.mark.parametrize("backend,workers", [("threads", 1), ("grain", 0)])
def test_data_parallel_trainer_fits_as_one_process(tmp_path, backend, workers):
    """Trainer.fit in a group of 2 ranks (the trainer's own data mesh;
    each rank decodes its file of each 2-file batch) against one process,
    one epoch on a tree of 4 train and 4 test files (2 steps, layer3
    unfrozen): the same step count, the same validation counts on every
    rank, rank 0 alone writing the checkpoint; the weights within 2·lr a
    step (the bound of tests/test_torch_train_step.py) and the BN running
    statistics within 1e-4 of one process's (2.6e-5 measured: the first
    step's rounding differences, amplified by the second step of this
    4-row batch)."""
    from tests.test_torch_trainer import make_tree

    data = make_tree(str(tmp_path / "data"))
    (tmp_path / "data" / "train" / "Real" / "short.wav").unlink()  # no file drops
    inp = {"data": data, "work": str(tmp_path), "backend": backend, "workers": workers,
           "eps": EPS, "lr": LR, "epochs": 1}
    torch.save(inp, tmp_path / "inputs.pt")
    try:
        ranks = td.run_ranks("trainer", 2, tmp_path)
        one = td.trainer_fit(inp)
    finally:  # the checkpoints: hundreds of MB
        for ck in ("ck", "ck0", "ck1"):
            shutil.rmtree(tmp_path / ck, ignore_errors=True)
    _assert_ranks_agree(ranks, keys=("sd", "mu", "nu"))
    assert all(r["mesh"] for r in ranks) and not one["mesh"]
    assert ranks[0]["written"] == one["written"] and "best_model.ckpt" in one["written"]
    assert ranks[1]["written"] == []
    for r in ranks:
        assert r["steps"] == one["steps"] == 2 and r["count"] == one["count"]
        assert r["confusion"].sum() == one["confusion"].sum() == 8  # 4 files, 2 rows each
        np.testing.assert_array_equal(r["confusion"], ranks[0]["confusion"])
        assert r["auc"] == ranks[0]["auc"] and r["best"] == ranks[0]["best"]
    for k, want in one["sd"].items():
        d = (ranks[0]["sd"][k] - want).abs().max()
        assert float(d) <= (1e-4 if "running" in k else 2 * LR * one["steps"]), k
