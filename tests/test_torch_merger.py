"""The port's merger (``ensemble/merger.py``, ``cli/model_merger.py``)
against the JAX package's, on the CPU: the recipe, the real-class name,
both merge semantics on the same sub-model files (a reference-trainer
``.pth`` with unprefixed backbone keys, a port trainer ``.pth`` with
``base.*`` keys, a donor), with the merged ensembles' logits at 64² within
1e-4 (tests/test_torch_checkpoints.py's bound). What a checkpoint lacks is
filled from a fresh init; the port's fill is flax's default
(tests/test_torch_init.py's check), JAX's its own draws, so the fill is
held to the distribution only."""

import logging
import os
import shutil

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import parity_bounds
import pytest
import torch

from synthetic_audio_detection_tpu.ensemble import merger as JM
from synthetic_audio_detection_tpu.ensemble import multihead as JE
from synthetic_audio_detection_tpu_torch.checkpoints import serialization as TSer
from synthetic_audio_detection_tpu_torch.ensemble import merger
from synthetic_audio_detection_tpu_torch.models.classifier import BinaryClassifier
from tests.test_torch_init import assert_flax_init, port_faults
from tests.test_torch_train_step import _f64

TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _seeded(seed):
    """A classifier state dict with seeded weights (He's scale, so the
    features keep their spread through the eval-mode backbone) and BN
    parameters and statistics away from 1 / 0, so the logits depend on
    every entry and on the input."""
    g = torch.Generator().manual_seed(seed)
    with torch.random.fork_rng(devices=[]):
        model = BinaryClassifier()
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = v
        elif k.endswith("running_var"):
            sd[k] = torch.rand(v.shape, generator=g) + 0.5
        elif v.ndim > 1:
            sd[k] = torch.randn(v.shape, generator=g) * (2.0 / v[0].numel()) ** 0.5
        else:  # BN weights near 1; BN biases, running means and Linear biases near 0
            sd[k] = float(k.endswith("weight")) + 0.1 * torch.randn(v.shape, generator=g)
    return sd


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """ref.pth (the reference trainer's contract: unprefixed backbone keys,
    epoch and optimizer), port.pth (the port trainer's twin: base.* keys),
    donor.pth (a plain classifier state dict), donor.ckpt (native) and
    recipe.csv."""
    root = tmp_path_factory.mktemp("merge")
    ref = {(k[len("base."):] if k.startswith("base.") else k): v for k, v in _seeded(1).items()}
    torch.save({"epoch": 3, "state_dict": ref, "best_acc": 0.8, "optimizer": {},
                "scheduler": {}, "total_steps": 10}, root / "ref.pth")
    TSer.save_submodel_torch(str(root / "port.pth"),
                             {k: v.numpy() for k, v in _seeded(2).items()
                              if not k.endswith("num_batches_tracked")}, epoch=1, best_acc=0.6)
    donor = _seeded(3)
    torch.save(donor, root / "donor.pth")
    from synthetic_audio_detection_tpu_torch.checkpoints import torch_compat

    TSer.save_native(str(root / "donor.ckpt"), {"variables": torch_compat.
                     classifier_variables_from_torch({k: v.numpy() for k, v in donor.items()},
                                                     base_prefix="base.")})
    (root / "recipe.csv").write_text("model_filename, synthetic_class ,real_class\n"
                                     "ref.pth, SynA ,Real\n"
                                     ",ignored,Real\n"
                                     "port.pth,SynB,\n")
    yield root
    shutil.rmtree(root, ignore_errors=True)


def _x():
    return np.random.default_rng(5).standard_normal((2, 64, 64, 3)).astype(np.float32)


def _port_logits(ens):
    return ens.cpu()(torch.from_numpy(_x()).permute(0, 3, 1, 2)).numpy()


def _assert_logits_within(ens, je, x=None):
    """The port's logits on ``x`` (default _x()) against JAX's ensemble
    forward in float64 (the model at float64, its variables cast), within
    parity_bounds.reference_error_bound of JAX's float32 forward's error."""
    x = _x() if x is None else x
    want = np.asarray(JE.ensemble_forward(je, jnp.asarray(x)))
    with jax.enable_x64(True):
        je64 = dataclasses.replace(je, model=je.model.clone(dtype=jnp.float64),
                                   variables=_f64(je.variables))
        truth = np.asarray(JE.ensemble_forward(je64, jnp.asarray(x, jnp.float64)))
    got = ens.cpu()(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    parity_bounds.assert_within_reference(got, want, truth, float(np.abs(truth).max()),
                                          err_msg="logits")


def test_recipe_and_real_name_match_jax(folder, tmp_path, caplog):
    path = str(folder / "recipe.csv")
    assert merger.read_merge_recipe(path) == JM.read_merge_recipe(path)
    assert [r["real_class"] for r in merger.read_merge_recipe(path)] == ["Real", ""]
    empty = tmp_path / "empty.csv"
    empty.write_text("model_filename,synthetic_class,real_class\n,,\n")
    for fn in (merger.read_merge_recipe, JM.read_merge_recipe):
        with pytest.raises(ValueError, match="empty merge recipe"):
            fn(str(empty))
    for names in (["Real"] * 3, ["Real", "Bona", "Real"], ["B", "A", "A", "B", "B"]):
        assert merger.resolve_real_name(names) == JM.resolve_real_name(names)
    with caplog.at_level(logging.WARNING):
        assert merger.resolve_real_name(["Real", "Bona", "Real"]) == "Real"
    assert "disagree" in caplog.text


@pytest.mark.parametrize("semantics", ["default", "reference"])
def test_merge_matches_jax(folder, semantics):
    """Both semantics against JAX merge_models on the same files: class
    names, layout and logits (against JAX's forward in float64). Under the
    reference's strict=False semantics the reference-trainer file
    contributes only its head (the donor's backbone in its place); the
    port trainer's base.* file loads whole either way."""
    reference = semantics == "reference"
    donor = str(folder / "donor.pth") if reference else None
    kw = dict(reference_semantics=reference, backbone_weights=donor)
    je = JM.merge_models(str(folder), str(folder / "recipe.csv"), smoke_test=False, **kw)
    ens = merger.merge_models(str(folder), str(folder / "recipe.csv"), device="cpu",
                              smoke_test=reference, **kw)
    assert ens.class_names == list(je.class_names) == ["SynA", "SynB", "Real"]
    assert not ens.shared_backbone and not je.shared_backbone
    _assert_logits_within(ens, je)
    sds = ens.classifier_state_dicts()
    donor_sd = _seeded(3)
    ref_base = torch.load(folder / "ref.pth", weights_only=True)["state_dict"]
    for k in ("conv1.weight", "layer4.1.bn2.running_var"):
        want = donor_sd[f"base.{k}"] if reference else ref_base[k]
        assert torch.equal(sds[0][f"base.{k}"], want), k
    assert torch.equal(sds[0]["head.10.weight"], ref_base["head.10.weight"])
    assert torch.equal(sds[1]["base.conv1.weight"], _seeded(2)["base.conv1.weight"])


def test_logit_bound_rejects_a_batchnorm_eps_of_1e_3(folder):
    """Every BatchNorm's eps at 1e-3 in place of 1e-5 in the port's merged
    ensemble: the float64-derived bound rejects it, as the fixed 1e-4
    against JAX's float32 forward did."""
    je = JM.merge_models(str(folder), str(folder / "recipe.csv"), smoke_test=False)
    ens = merger.merge_models(str(folder), str(folder / "recipe.csv"), device="cpu",
                              smoke_test=False)
    for m in ens.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.eps = 1e-3
    with pytest.raises(AssertionError, match="logits"):
        _assert_logits_within(ens, je)
    want = np.asarray(JE.ensemble_forward(je, jnp.asarray(_x())))
    assert np.abs(_port_logits(ens) - want).max() > TOL


def test_reference_semantics_requires_a_donor(folder):
    for fn, kw in ((merger.merge_models, {"device": "cpu"}), (JM.merge_models, {})):
        with pytest.raises(ValueError, match="requires --backbone-weights"):
            fn(str(folder), str(folder / "recipe.csv"), reference_semantics=True, **kw)


def test_donor_and_fill(folder, caplog):
    """The donor's base.* entries come whole from a .pth or a native file;
    a checkpoint's entries are kept bit for bit and what it lacks, or holds
    at another shape (with a warning), comes from flax's default init."""
    donor = _seeded(3)
    for name in ("donor.pth", "donor.ckpt"):
        got = merger._load_backbone_donor(str(folder / name))
        assert set(got) == {k for k in donor if k.startswith("base.")
                            and not k.endswith("num_batches_tracked")}
        assert all(torch.equal(v, donor[k]) for k, v in got.items()), name
    partial = {k: v for k, v in donor.items() if not k.startswith("head.")}
    partial["base.conv1.weight"] = torch.zeros(64, 1, 7, 7)
    with caplog.at_level(logging.WARNING):
        full = merger._complete_variables(partial)
    assert "shape mismatch at base.conv1.weight" in caplog.text
    assert all(torch.equal(full[k], v) for k, v in partial.items()
               if k != "base.conv1.weight" and not k.endswith("num_batches_tracked"))
    model = BinaryClassifier()
    model.load_state_dict(full, strict=False)
    assert_flax_init(port_faults(model.head), "fill of the missing head")
    assert_flax_init({"conv1": port_faults(model.base.conv1)[".weight"]}, "fill of conv1")


def test_cli_merges_and_the_result_serves(folder, tmp_path):
    from synthetic_audio_detection_tpu_torch.audio import wavio
    from synthetic_audio_detection_tpu_torch.cli import inference_runner, model_merger

    for out in ("merged.pth", "merged.ckpt"):
        path = str(tmp_path / out)
        assert model_merger.main(["--submodels-folder", str(folder), "--csv-file",
                                  str(folder / "recipe.csv"), "--output-path", path,
                                  "--device", "cpu"]) == 0
        assert TSer.load_merged(path).class_names == ["SynA", "SynB", "Real"]
    wav = str(tmp_path / "clip.wav")
    wavio.write_wav(wav, (np.random.default_rng(0).standard_normal(32_000 * 8) * 0.2)
                    .astype(np.float32), 32_000)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert inference_runner.main(["--merged-model", str(tmp_path / "merged.pth"), "--audio",
                                      wav, "--input-size", "64", "--device", "cpu",
                                      "--output-json", "out.json"]) == 0
    finally:
        os.chdir(cwd)
    assert (tmp_path / "out.json").exists()
    shutil.rmtree(tmp_path, ignore_errors=True)
