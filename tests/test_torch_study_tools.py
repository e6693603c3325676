"""The port's study tools (tools/calibrate_ensemble.py, accuracy_study.py,
robustness_study.py, decision_ab.py, artifact_drive.py) through their
``main(argv)`` with ``--device cpu``, on a tiny merged checkpoint (64²,
ResNet-18, 2 heads) and the tiny tone tree.

Calibration files cross between the packages in both formats: the port
reads a JAX-calibrated file and the JAX package a port-calibrated one,
with the temperatures as written. The two packages' fits of the same tree
agree within 1e-3 relative (their logits agree within 1e-4; the fit
rounds to 6 decimals).

The reference tool does not pass ``generic_head`` to
``fit_ensemble_calibration`` (tools/calibrate_ensemble.py:109), so on a
generic-head checkpoint it raises where the port fits: a known fault of
the reference, kept out of the parity checks. The port's generic-head fit
is held to the JAX package's ``fit_ensemble_calibration(...,
generic_head=True)`` on the same logits.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from synthetic_audio_detection_tpu.checkpoints import serialization as JSer
from synthetic_audio_detection_tpu.ensemble.merger import save_merged as jax_save_merged
from synthetic_audio_detection_tpu.infer import pipeline as JP
from synthetic_audio_detection_tpu.infer import study as JS
from synthetic_audio_detection_tpu.utils import calibration as JCal
from synthetic_audio_detection_tpu.utils.config import InferenceConfig, SpectrogramConfig
from synthetic_audio_detection_tpu_torch.checkpoints import serialization as TSer
from synthetic_audio_detection_tpu_torch.infer import export as TX
from synthetic_audio_detection_tpu_torch.infer import study as TS
from synthetic_audio_detection_tpu_torch.infer.pipeline import InferencePipeline
from synthetic_audio_detection_tpu_torch.tools import (
    accuracy_study,
    artifact_drive,
    calibrate_ensemble,
    decision_ab,
    robustness_study,
)
from tests.torch_release import ensembles, tiny_tree

SIZE = ["--input-size", "64", "--batch-size", "8", "--device", "cpu"]
SPEC = SpectrogramConfig.inference(out_size=64)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("tree"))


@pytest.fixture(scope="module")
def merged(tmp_path_factory):
    """(the JAX ensemble, the port's, its merged .pth)."""
    je, te = ensembles()
    path = str(tmp_path_factory.mktemp("ck") / "merged.pth")
    TSer.save_merged_torch(path, te)
    return je, te, path


def run(tool, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tool.main(argv)
    lines = out.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]) if lines else None


@pytest.mark.parametrize("suffix", [".pth", ".ckpt"])
def test_calibrate_ensemble_round_trips_between_the_packages(merged, tree, tmp_path, suffix):
    je, _, path = merged
    out = str(tmp_path / f"cal{suffix}")
    rc, report = run(calibrate_ensemble, ["--merged-model", path, "--fit-dir", tree,
                                          "--eval-dir", tree, "--output", out,
                                          "--store-column-thresholds", *SIZE])
    assert rc == 0 and report["output"] == out
    cal = report["calibration"]
    assert cal["fit_on"] == f"{tree} (6 windows)" and len(cal["temperatures"]) == 3
    assert report["eval"]["n_windows"] == 6
    assert report["eval"]["ece_after"] == cal["ece_after"]  # the same tree, the same targets
    # the port's file, read by both packages
    assert TSer.load_merged(out).calibration == cal
    assert JSer.load_merged(out).calibration["temperatures"] == cal["temperatures"]
    # JAX's fit of the same tree, written by the JAX package, read by the port
    jp = JP.InferencePipeline(je, spec=SPEC, infer=InferenceConfig(batch_size=8),
                              use_pallas=False)
    fit = JS.collect_logits_tree(jp, tree)
    jcal = JCal.fit_ensemble_calibration(fit["logits"], fit["class_idx"], je.class_names,
                                         store_column_thresholds=True)
    je.calibration = jcal
    jout = str(tmp_path / f"jax{suffix}")
    jax_save_merged(je, jout)
    assert TSer.load_merged(jout).calibration["temperatures"] == jcal["temperatures"]
    np.testing.assert_allclose(cal["temperatures"], jcal["temperatures"], rtol=1e-3)
    # served, the port applies what it read
    pipe = InferencePipeline(TSer.load_merged(jout), spec=SPEC, device="cpu")
    assert pipe._cal["temperatures"] == jcal["temperatures"]


def test_calibrate_ensemble_fits_a_generic_head_checkpoint(tree, tmp_path):
    """The port passes ``generic_head`` (the reference tool does not, and
    raises here: its fault at :109, not pinned); the columns are the JAX
    package's fit with ``generic_head=True`` on the same logits."""
    _, te = ensembles(generic=True)
    path, out = str(tmp_path / "g.pth"), str(tmp_path / "g_cal.ckpt")
    TSer.save_merged_torch(path, te)
    rc, report = run(calibrate_ensemble, ["--merged-model", path, "--fit-dir", tree,
                                          "--output", out, "--store-column-thresholds",
                                          "--column-threshold-method", "sidak", *SIZE])
    assert rc == 0
    cal = report["calibration"]
    assert cal["column_names"] == ["SynA", "SynB", "__generic__", "Real"]
    pipe = InferencePipeline(TSer.load_merged(path), spec=SPEC,
                             infer=InferenceConfig(batch_size=8, apply_calibration=False),
                             device="cpu")
    fit = TS.collect_logits_tree(pipe, tree)
    want = JCal.fit_ensemble_calibration(
        fit["logits"], fit["class_idx"], te.class_names, store_column_thresholds=True,
        column_threshold_method="sidak", fit_on=cal["fit_on"], generic_head=True)
    assert cal == want
    assert TSer.load_merged(out).calibration == cal


def test_accuracy_and_robustness_studies(merged, tree):
    _, _, path = merged
    rc, acc = run(accuracy_study, ["--merged-model", path, "--data-dir", tree, *SIZE])
    assert rc == 0
    assert acc["input_size"] == 64 and acc["dtype"] == "f32"
    assert acc["decision"] == {"syn_override_k": 1, "per_column_thresholds": False,
                               "generic_verdict": False, "threshold": 0.5, "calibration": True}
    pipe = InferencePipeline(TSer.load_merged(path), spec=SPEC,
                             infer=InferenceConfig(batch_size=8), device="cpu")
    want = TS.evaluate_tree(pipe, tree)
    assert {k: acc[k] for k in want} == want and want["n_segments"] == 7
    rc, rob = run(robustness_study, ["--merged-model", path, "--data-dir", tree,
                                     "--perturbations", "clean", "noise_snr20", "lowpass_8k",
                                     *SIZE])
    assert rc == 0 and list(rob["perturbations"]) == ["clean", "noise_snr20", "lowpass_8k"]
    assert rob["perturbations"]["clean"] == {
        k: want[k] for k in ("n_segments", "binary_accuracy", "attribution_accuracy",
                             "binary_auc", "binary_eer")}


def test_decision_ab_reference_variant_is_the_pipelines_rule(merged, tree, tmp_path):
    """The reference variant (raw logits, 0.5, K = 1) scores each class as
    the uncalibrated pipeline's own labels do; the cached logits give the
    same report without the device."""
    _, _, path = merged
    out = str(tmp_path / "ab.json")
    rc, rep = run(decision_ab, ["--merged-model", path, "--fit-dir", tree, "--data-dir", tree,
                                "--holdout", "SynZ", "--output", out, *SIZE])
    assert rc == 0 and rep["n_files"] == 7
    _, acc = run(accuracy_study, ["--merged-model", path, "--data-dir", tree,
                                  "--no-calibration", *SIZE])
    assert rep["variants"]["reference_unanimity_k1"]["per_class"] == acc["per_class"]
    assert "unseen_tpr" in rep["variants"]["reference_unanimity_k1"]
    assert json.loads(open(out).read()) == rep
    rc, again = run(decision_ab, ["--merged-model", path, "--fit-dir", tree, "--data-dir",
                                  tree, "--holdout", "SynZ", "--from-logits",
                                  out + ".logits.npz"])
    assert rc == 0 and again == rep


def _calibrated(tmp_path, temperature):
    """The tiny ensemble with one temperature for every column, as a
    merged .pth: its raw logits lie within 0.25 of 0, so a temperature of
    0.02 spreads its sigmoids clear of the decision boundaries and one of
    1000 flattens them onto 0.5."""
    _, te = ensembles(calibration={"temperatures": [temperature] * 3})
    path = str(tmp_path / f"t{temperature}.pth")
    TSer.save_merged_torch(path, te)
    return te, path


def test_artifact_drive(tree, tmp_path):
    te, path = _calibrated(tmp_path, 0.02)
    rc, rep = run(artifact_drive, ["--merged-model", path, "--audio-dir", tree,
                                   "--max-files", "4", *SIZE])
    assert rc == 0 and rep["ok"]
    assert rep["n_files"] == 4 and rep["n_windows"] == 4
    assert rep["matched_bit_equal"] and rep["matched_max_abs_logit_diff"] == 0.0
    assert rep["production_clear_windows"] > 0
    assert rep["production_label_mismatches_on_clear"] == 0
    assert rep["artifact_nbytes"] > 0 and not any(rep["launches"]["artifact"].values())
    # an artifact given by path serves as exported
    art = str(tmp_path / "m.sadpt")
    TX.write_artifact(art, TX.export_serving(te, spec=SPEC, batch_sizes=(8,),
                                             compute_dtype=torch.float32, device="cpu"))
    rc, rep = run(artifact_drive, ["--merged-model", path, "--audio-dir", tree,
                                   "--artifact", art, "--max-files", "2", *SIZE])
    assert rc == 0 and rep["ok"] and rep["n_files"] == 2 and rep["artifact"] == art


def test_artifact_drive_fails_when_no_window_is_clear(tmp_path, tree, capsys):
    """With every sigmoid within the margin of its threshold the
    production check compares nothing: the drive fails and says so, with
    the calibration (a temperature at the fit's bound) and without it
    (``--no-calibration``: the tiny model's raw logits)."""
    _, path = _calibrated(tmp_path, 1000.0)
    argv = ["--merged-model", path, "--audio-dir", tree, "--max-files", "4", *SIZE]
    rc, rep = run(artifact_drive, argv)
    assert rc == 1 and not rep["ok"] and rep["calibration"]
    assert rep["production_clear_windows"] == 0 and rep["matched_bit_equal"]
    assert "compared nothing (try --no-calibration)" in capsys.readouterr().err
    rc, rep = run(artifact_drive, argv + ["--no-calibration"])
    assert rc == 1 and not rep["ok"] and not rep["calibration"]
    assert rep["production_clear_windows"] == 0
    assert capsys.readouterr().err.rstrip().endswith("compared nothing")


@pytest.mark.parametrize("tool", ["accuracy_study", "robustness_study", "calibrate_ensemble",
                                  "decision_ab", "artifact_drive", "export"])
def test_tools_need_cuda_unless_asked_for_the_cpu(tool, capsys):
    """--device defaults to cuda; without a GPU each tool exits 1 and says
    why, never falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = TX if tool == "export" else globals()[tool]
    argv = {"accuracy_study": ["--data-dir", "d"], "robustness_study": ["--data-dir", "d"],
            "calibrate_ensemble": ["--fit-dir", "d"],
            "decision_ab": ["--fit-dir", "d", "--data-dir", "d"],
            "artifact_drive": ["--audio-dir", "d"], "export": ["--output", "o"]}[tool]
    assert mod.main(["--merged-model", "missing.pth", *argv]) == 1
    assert "CUDA is not available" in capsys.readouterr().err
