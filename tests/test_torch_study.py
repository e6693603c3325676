"""The port's held-out study harness (infer/study.py) and the host helpers of
its tools against the JAX package's, on the CPU at 64² with the same
weights and the same tiny tree of 4-s tone clips (and a folder that names
no class).

Tolerances: class indices, counts, labels and confusion entries equal;
the logits within 1e-4 (the float32 end-to-end bound of
tests/test_torch_pipeline.py); accuracies equal; AUC and EER within 1e-4
(scores from those logits); the robustness perturbations within 1e-6 on
the same RNG; the decision A/B's verdicts and figures equal."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from synthetic_audio_detection_tpu.infer import pipeline as JP
from synthetic_audio_detection_tpu.infer import study as JS
from synthetic_audio_detection_tpu.utils.config import InferenceConfig, SpectrogramConfig
from synthetic_audio_detection_tpu_torch.infer import pipeline as TP
from synthetic_audio_detection_tpu_torch.infer import study as TS
from synthetic_audio_detection_tpu_torch.tools import decision_ab as TD
from synthetic_audio_detection_tpu_torch.tools import robustness_study as TR
from tests.torch_release import NAMES, SR, ensembles, tiny_tree

TOOLS = str(Path(__file__).resolve().parents[1] / "tools")
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)
import decision_ab as JD  # noqa: E402  (the reference tool, as tests/test_study.py imports it)
import robustness_study as JR  # noqa: E402

TOL = 1e-4
SPEC = SpectrogramConfig.inference(out_size=64)
CAL = {"temperatures": [1.2, 0.7, 2.0, 0.9], "column_thresholds": [0.35, 0.6, 0.4, 0.55]}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("tree"))


def _pipes(generic=False, calibration=None, **infer):
    je, te = ensembles(generic=generic, calibration=calibration)
    cfg = InferenceConfig(batch_size=8, **infer)
    return (JP.InferencePipeline(je, spec=SPEC, infer=cfg, use_pallas=False),
            TP.InferencePipeline(te, spec=SPEC, infer=cfg, device="cpu"))


@pytest.fixture(scope="module")
def plain():
    return _pipes()


@pytest.fixture(scope="module")
def generic():
    return _pipes(generic=True, calibration=CAL, generic_verdict=True)


def _same_report(got, want):
    for k in ("n_segments", "binary_accuracy", "attribution_accuracy", "per_class",
              "confusion"):
        assert got[k] == want[k], k
    assert got.keys() == want.keys()
    for k in ("binary_auc", "binary_eer"):
        if k in want:
            assert abs(got[k] - want[k]) <= TOL, k


def test_collect_logits_tree_matches_jax(plain, tree, caplog):
    jp, tp = plain
    want = JS.collect_logits_tree(jp, tree)
    got = TS.collect_logits_tree(tp, tree)
    np.testing.assert_array_equal(got["class_idx"], want["class_idx"])
    assert got["class_idx"].tolist() == [2, 2, 0, 0, 1, 1]  # sorted folders, SynZ skipped
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0, atol=TOL)
    assert "'SynZ' matches no ensemble class" in caplog.text


def test_collect_logits_tree_refuses_an_empty_tree(plain, tmp_path):
    (tmp_path / "Other").mkdir()
    with pytest.raises(ValueError, match="no usable labeled segments"):
        TS.collect_logits_tree(plain[1], str(tmp_path))


@pytest.mark.parametrize("case", ["plain", "generic", "perturbed"])
def test_evaluate_tree_matches_jax(plain, generic, tree, case):
    """The plain rule, the generic head's verdict and detector score on a
    calibrated generic-head ensemble, and a noise perturbation drawn from
    the per-file RNG (the reference tool's and the port's on the same
    draws)."""
    jp, tp = generic if case == "generic" else plain
    if case == "perturbed":
        want = JS.evaluate_tree(jp, tree, perturb=JR.PERTURBATIONS["noise_snr10"], seed=3)
        got = TS.evaluate_tree(tp, tree, perturb=TR.PERTURBATIONS["noise_snr10"], seed=3)
    else:
        want, got = JS.evaluate_tree(jp, tree), TS.evaluate_tree(tp, tree)
    _same_report(got, want)
    assert got["n_segments"] == 7 and "binary_auc" in got
    assert got["per_class"]["SynZ"]["attribution"] == 0.0  # scored, never attributed


def test_perturbed_run_is_deterministic(plain, tree):
    """The same seed gives the same report and the same draws, whatever
    the visit order; another seed other draws."""
    calls = []

    def noisy(wf, rng):
        calls.append(rng.standard_normal(4))
        return wf + 0.01 * rng.standard_normal(wf.shape).astype(np.float32)

    tp = plain[1]
    r1 = TS.evaluate_tree(tp, tree, perturb=noisy, seed=7)
    first = [c.copy() for c in calls]
    calls.clear()
    assert TS.evaluate_tree(tp, tree, perturb=noisy, seed=7) == r1
    for a, b in zip(first, calls):
        np.testing.assert_array_equal(a, b)
    calls.clear()
    TS.evaluate_tree(tp, tree, perturb=noisy, seed=8)
    assert not np.allclose(first[0], calls[0])


@pytest.mark.parametrize("name", sorted(JR.PERTURBATIONS))
def test_perturbations_match_reference_tool(name):
    t = np.arange(4 * SR) / SR
    tone = (0.5 * np.sin(2 * np.pi * 440.0 * t) + 0.3 * np.sin(2 * np.pi * 11_000.0 * t)
            ).astype(np.float32)
    got = TR.PERTURBATIONS[name](tone, np.random.default_rng(5))
    want = JR.PERTURBATIONS[name](tone, np.random.default_rng(5))
    assert got.shape == want.shape == tone.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_snr_and_lowpass_match_reference_tool():
    x = np.random.default_rng(6).standard_normal(3 * SR).astype(np.float32) * 0.2
    np.testing.assert_allclose(TR._with_snr(x, np.random.default_rng(1), 7.5),
                               JR._with_snr(x, np.random.default_rng(1), 7.5), rtol=0, atol=1e-6)
    np.testing.assert_allclose(TR._lowpass_8k(x), JR._lowpass_8k(x), rtol=0, atol=1e-6)
    np.testing.assert_allclose(TR._lowpass_8k(x[:48_000], 48_000),
                               JR._lowpass_8k(x[:48_000], 48_000), rtol=0, atol=1e-6)
    assert list(TR.PERTURBATIONS) == list(JR.PERTURBATIONS)


def test_collect_per_file_matches_reference_tool(plain, tree):
    jp, tp = plain
    want, got = JD.collect_per_file(jp, tree), TD.collect_per_file(tp, tree)
    assert [c for c, _ in got] == [c for c, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


def _files(rng, names, cols, holdout="Unseen"):
    files = []
    for cls in names + [holdout]:
        for _ in range(4):
            z = rng.standard_normal((int(rng.integers(1, 4)), cols)) * 2.5
            files.append((cls, z.astype(np.float32)))
    return files


@pytest.mark.parametrize("generic,generic_thr", [(False, None), (True, None), (True, 0.45)])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("calibrated", [False, True])
def test_decision_ab_variants_match_reference_tool(generic, generic_thr, k, calibrated):
    """verdict_label and evaluate_variant give tools/decision_ab.py's
    verdicts and figures on the same logits, every rule the tool
    compares (K-of-N, per-column points, temperatures, the generic verdict
    and its split of the generic column)."""
    rng = np.random.default_rng(k + 2 * generic + 4 * calibrated)
    cols = len(NAMES) + int(generic)
    files = _files(rng, NAMES, cols)
    temps = rng.uniform(0.5, 2.0, cols).astype(np.float32) if calibrated else None
    col_thr = rng.uniform(0.3, 0.7, cols).astype(np.float32)
    for _, z in files:
        probs = 1.0 / (1.0 + np.exp(-z))
        assert TD.verdict_label(probs, col_thr, k, NAMES, generic, generic_thr) == \
            JD.verdict_label(probs, col_thr, k, NAMES, generic, generic_thr)
    got = TD.evaluate_variant(files, NAMES, "Real", "Unseen", temps, col_thr, k, generic,
                              generic_thr)
    want = JD.evaluate_variant(files, NAMES, "Real", "Unseen", temps, col_thr, k, generic,
                               generic_thr)
    assert got == want
    assert "unseen_tpr" in got
