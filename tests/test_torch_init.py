"""The trainers' initial weights are flax's defaults, as the JAX package's
(``models/init.py:flax_default_init_``).

The port cannot draw JAX's random values (another generator), so each
tensor is held to the distribution: a Conv2d or Linear weight (flax
``lecun_normal``, a normal truncated at ±2σ whose std after truncation is
1/√fan_in) has std·√fan_in within 4/√n of 1 (n elements; the sample std of
this distribution has a standard error of about 0.58/√n, so this is about
seven of them) and max|w|·√fan_in at most 2 / 0.8796 = 2.2737 (and at
least 2.0 where n ≥ 4096); a Linear bias is zero; a BatchNorm starts at
weight 1, bias 0, mean 0, variance 1. JAX's ``model.init`` and
``init_joint_state`` pass the same check, and PyTorch's default init
(``kaiming_uniform(a=√5)``: std·√fan_in = 1/√3, max|w|·√fan_in ≤ 1,
uniform biases) fails it on every weight of at least 512 elements.
"""

import math

import jax
import numpy as np
import pytest
import torch

from synthetic_audio_detection_tpu.models.classifier import BinaryClassifier as JaxClassifier
from synthetic_audio_detection_tpu.models.classifier import init_classifier
from synthetic_audio_detection_tpu.train import joint as JJ
from synthetic_audio_detection_tpu.utils.config import TrainConfig as JCfg
from synthetic_audio_detection_tpu_torch.ensemble.merger import _complete_variables
from synthetic_audio_detection_tpu_torch.models.classifier import BinaryClassifier
from synthetic_audio_detection_tpu_torch.models.init import TRUNCATED_STD, flax_default_init_
from synthetic_audio_detection_tpu_torch.train import joint
from synthetic_audio_detection_tpu_torch.train.trainer import Trainer
from synthetic_audio_detection_tpu_torch.utils.config import SpectrogramConfig, TrainConfig

MAX_SCALED = 2.0 / TRUNCATED_STD  # the truncation point, in units of 1/√fan_in


def std_bound(n: int) -> float:
    return 4.0 / math.sqrt(n)


def kernel_stats(w: np.ndarray, fan_in: int) -> dict:
    scaled = np.asarray(w, np.float64).ravel() * math.sqrt(fan_in)
    return {"n": scaled.size, "std": float(scaled.std()), "max": float(np.abs(scaled).max()),
            "mean": float(scaled.mean())}


def flax_init_faults(stats: dict) -> list:
    """The ways one kernel's statistics leave flax's distribution."""
    faults = []
    n = stats["n"]
    if abs(stats["std"] - 1.0) > std_bound(n):
        faults.append(f"std·√fan_in {stats['std']:.4f}")
    if abs(stats["mean"]) > std_bound(n):
        faults.append(f"mean·√fan_in {stats['mean']:.4f}")
    if stats["max"] > MAX_SCALED + 1e-5:
        faults.append(f"max|w|·√fan_in {stats['max']:.4f} past the truncation")
    if n >= 4096 and stats["max"] < 2.0:
        faults.append(f"max|w|·√fan_in {stats['max']:.4f} short of the tail")
    return faults


def port_faults(module: torch.nn.Module) -> dict:
    """{tensor name: [faults]} for every Conv2d/Linear weight and bias and
    BatchNorm of a port module."""
    out = {}
    for name, m in module.named_modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            w = m.weight.detach().cpu().numpy()
            out[f"{name}.weight"] = flax_init_faults(kernel_stats(w, w[0].size))
            if m.bias is not None and m.bias.detach().abs().max() > 0:
                out[f"{name}.bias"] = ["nonzero bias"]
        elif isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            ok = (torch.all(m.weight == 1) and torch.all(m.bias == 0)
                  and torch.all(m.running_mean == 0) and torch.all(m.running_var == 1))
            out[name] = [] if ok else ["BatchNorm not at 1, 0, 0, 1"]
    return out


def jax_faults(params: dict, prefix: str = "") -> dict:
    """The same for one JAX params tree (kernels [kh, kw, I, O] or
    [in, out]; Dense and BatchNorm biases zero, scales one)."""
    out = {}
    for k, v in params.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(jax_faults(v, path + "."))
            continue
        a = np.asarray(v)
        if k == "kernel":
            fan_in = int(np.prod(a.shape[:-1]))
            out[path] = flax_init_faults(kernel_stats(a, fan_in))
        elif k == "bias" or k == "scale":
            want = 1.0 if k == "scale" else 0.0
            out[path] = [] if np.all(a == want) else [f"{k} not {want}"]
    return out


def assert_flax_init(faults: dict, what: str):
    assert faults, what
    bad = {k: v for k, v in faults.items() if v}
    assert not bad, f"{what}: {sorted(bad.items())[:4]}"


def _unstack(tree, i):
    return {k: _unstack(v, i) if isinstance(v, dict) else np.asarray(v)[i]
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def jax_init():
    model = JaxClassifier(backbone="resnet18")
    return jax.tree_util.tree_map(np.asarray, init_classifier(model, jax.random.PRNGKey(0),
                                                              input_size=64))


def test_jax_model_init_passes_the_check(jax_init):
    """The check's bound holds for the reference's own draws."""
    assert_flax_init(jax_faults(jax_init["params"]), "JAX model.init")
    stats = jax.tree_util.tree_leaves(jax_init["batch_stats"])
    assert all(np.all(a == 0) or np.all(a == 1) for a in stats)


@pytest.mark.parametrize("per_head_stages", [0, 1])
def test_jax_init_joint_state_passes_the_check(per_head_stages):
    state, _ = JJ.init_joint_state("resnet18", 2, jax.random.PRNGKey(0), JCfg(), (64, 64),
                                   per_head_stages=per_head_stages)
    params = jax.tree_util.tree_map(np.asarray, state.params)
    assert_flax_init(jax_faults(params["base"]), "JAX joint trunk")
    for i in range(2):
        assert_flax_init(jax_faults(_unstack(params["heads"], i)), f"JAX joint head {i}")


def test_trainer_draws_flax_defaults(jax_init, tmp_path):
    """The repair of the submodel trainer: its fresh model passes, tensor
    for tensor, the check JAX's model.init passes."""
    tr = Trainer(TrainConfig(seed=3), spec_cfg=SpectrogramConfig(out_size=64),
                 log_dir=str(tmp_path / "runs"), device="cpu")
    faults = port_faults(tr.model)
    assert_flax_init(faults, "port Trainer")
    n_jax = sum(1 for k in jax_faults(jax_init["params"]) if k.endswith("kernel"))
    assert sum(1 for k in faults if k.endswith(".weight")) == n_jax


@pytest.mark.parametrize("per_head_stages", [0, 1])
def test_joint_state_draws_flax_defaults_with_independent_heads(per_head_stages):
    """init_joint_state: trunk and every head (and its tail) pass; the
    heads start apart (one generator each), the same seed gives the same
    weights."""
    make = lambda: joint.init_joint_state(  # noqa: E731
        "resnet18", 2, torch.Generator().manual_seed(0), TrainConfig(), per_head_stages)
    state = make()
    assert_flax_init(port_faults(state.model), f"port joint state K={per_head_stages}")
    h0, h1 = (dict(h.named_parameters()) for h in state.model.heads)
    assert all(not torch.equal(h0[k], h1[k]) for k in h0 if k.endswith("weight")
               and h0[k].ndim > 1)
    again = make()
    assert all(torch.equal(a, b) for a, b in zip(state.params, again.params))


def test_head_adder_and_merger_fill_draw_flax_defaults():
    """HeadAdder's new head and the merger's fill of what a checkpoint lacks."""
    from synthetic_audio_detection_tpu_torch.ensemble.multihead import build_ensemble
    from synthetic_audio_detection_tpu_torch.train.add_head import HeadAdder

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        base = BinaryClassifier().state_dict()
    ens = build_ensemble([base, base], ["SynA", "SynB", "Real"])
    adder = HeadAdder(ens, "SynC", TrainConfig(seed=5), spec_cfg=SpectrogramConfig(out_size=64),
                      device="cpu")
    assert_flax_init(port_faults(adder.state.model), "HeadAdder head")
    filled = _complete_variables({k: v for k, v in base.items() if k.startswith("base.")})
    model = BinaryClassifier()
    model.load_state_dict(filled, strict=False)
    head = port_faults(model.head)
    assert_flax_init(head, "merger fill of a missing head")
    assert all(torch.equal(filled[k], base[k]) for k in filled if k.startswith("base."))


def test_the_check_rejects_torchs_default_init():
    """PyTorch's kaiming_uniform(a=√5) init, the trainer's before this
    repair: every Conv2d/Linear weight of at least 512 elements fails (its
    std·√fan_in is 0.577), and every Linear bias is nonzero."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = BinaryClassifier()
    faults = port_faults(model)
    weights = [k for k, v in faults.items() if k.endswith(".weight")]
    assert weights and all(any("std" in f for f in faults[k]) for k in weights)
    assert all(faults[k] == ["nonzero bias"] for k in ("head.2.bias", "head.6.bias",
                                                       "head.10.bias"))
    conv = model.base.conv1.weight.detach().numpy()
    assert kernel_stats(conv, conv[0].size)["std"] == pytest.approx(1 / math.sqrt(3), rel=0.05)
    # the same module redrawn in place passes
    assert_flax_init(port_faults(flax_default_init_(model, torch.Generator().manual_seed(1))),
                     "redrawn")
