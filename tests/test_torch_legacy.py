"""The port's legacy 5-class path (``infer/legacy_analyzer.py``,
``cli/legacy_inference.py``, ``cli/legacy_trainer.py``, and
``ops/filters.median_filter1d``) against the JAX package's on the CPU,
with the same weights (ResNet-18 with five outputs) and the same inputs.

Tolerances: the host numpy steps (normalization, windows, the
sensitivity rescale, smoothing, segments) equal the reference's given the
same probabilities, up to the Gaussian convolution's float32 summation
order (1e-6); the probabilities of the two packages' float32 front ends
and ResNets within 1e-5 at 64² (their summation orders differ); the CLI's
JSON at 512² has the reference's labels, its confidences within 1e-4 and
its percentages, which both round to 2 decimals, within 0.011.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from synthetic_audio_detection_tpu.checkpoints.torch_compat import (
    classifier_variables_from_torch,
)
from synthetic_audio_detection_tpu.infer import legacy_analyzer as JL
from synthetic_audio_detection_tpu.models.classifier import BinaryClassifier as JaxClassifier
from synthetic_audio_detection_tpu.ops import filters as JF
from synthetic_audio_detection_tpu_torch.audio import wavio
from synthetic_audio_detection_tpu_torch.checkpoints.serialization import save_submodel_torch
from synthetic_audio_detection_tpu_torch.cli import legacy_inference, legacy_trainer
from synthetic_audio_detection_tpu_torch.infer import legacy_analyzer as TL
from synthetic_audio_detection_tpu_torch.models.classifier import BinaryClassifier
from synthetic_audio_detection_tpu_torch.ops import filters as TF

TOL_PROBS = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def state_dict():
    """A seeded five-output ResNet-18, its last layer scaled up so that
    the softmax is confident (O(1) logits)."""
    with torch.random.fork_rng():
        torch.manual_seed(5)
        sd = BinaryClassifier("resnet18", num_outputs=5).state_dict()
    sd["head.10.weight"] = sd["head.10.weight"] * 30.0
    return {k: v.numpy() for k, v in sd.items() if not k.endswith("num_batches_tracked")}


def _analyzers(sd, out_size=64):
    model = BinaryClassifier("resnet18", num_outputs=5)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=False)
    port = TL.LegacyAudioAnalyzer(model, device="cpu")
    ref = JL.LegacyAudioAnalyzer(JaxClassifier(backbone="resnet18", num_outputs=5),
                                 classifier_variables_from_torch(sd, base_prefix="base."))
    # the forward reads spec_cfg when it runs (the reference's at its trace)
    port.spec_cfg = dataclasses.replace(port.spec_cfg, out_size=out_size)
    ref.spec_cfg = dataclasses.replace(ref.spec_cfg, out_size=out_size)
    return port, ref


@pytest.fixture(scope="module")
def analyzers(state_dict):
    return _analyzers(state_dict)


@pytest.mark.parametrize("kind", ["noise", "silence", "constant"])
def test_normalize_audio_matches_reference(kind):
    y = {"noise": np.random.default_rng(0).standard_normal(32_000) * 3.0 + 0.5,
         "silence": np.zeros(32_000), "constant": np.full(32_000, 0.25)}[kind]
    y = y.astype(np.float32)
    got = TL.normalize_audio(y)
    np.testing.assert_array_equal(got, JL.normalize_audio(y))
    if kind == "noise":
        assert abs(np.sqrt(np.mean(got**2)) - 0.2) < 1e-5


@pytest.mark.parametrize("seconds", [6.0, 4.0, 9.37])
def test_windows_overlap_85_match_reference(analyzers, seconds):
    port, ref = analyzers
    wf = (np.random.default_rng(1).standard_normal(int(seconds * 32_000)) * 0.1)
    wf[32_000:96_000] = 0.0  # the gate keeps windows that reach past the silence
    wf = wf.astype(np.float32)
    (tw, ts), (jw, js) = port.windows(wf), ref.windows(wf)
    assert ts == js and len(ts) >= 1
    np.testing.assert_array_equal(tw, jw)
    assert port.windows(np.ones(6 * 32_000, np.float32) * 0.1)[1][:4] == [0.0, 0.6, 1.2, 1.8]


def varied_windows(n, seed):
    """n 4-s windows of differently coloured noise (white, low-passed,
    high-passed, amplitude-modulated), so that their spectra differ."""
    rng = np.random.default_rng(seed)
    t = np.arange(128_000) / 32_000
    out = []
    for i in range(n):
        x = rng.standard_normal(128_064)
        x = [x[:128_000], np.convolve(x, np.ones(16) / 4, "valid")[:128_000],
             np.diff(x)[:128_000] / 1.4, x[:128_000] * np.sin(2 * np.pi * 3 * t)][i % 4]
        out.append(rng.uniform(0.05, 0.3) * x)
    return np.stack(out).astype(np.float32)


def test_probabilities_match_reference(analyzers):
    """9 windows (the 16-row padding) and 3 (the 8-row one) at 64²."""
    port, ref = analyzers
    for n in (9, 3):
        w = varied_windows(n, n)
        got, want = port.probabilities(w), ref.probabilities(w)
        assert got.shape == want.shape == (n, 5) and got.dtype == np.float64
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL_PROBS)
        # the windows' probabilities differ by far more than the tolerance
        assert np.ptp(got, axis=0).max() > 100 * TOL_PROBS


def test_sensitivity_factors_match_reference(analyzers):
    port, ref = analyzers
    w = varied_windows(4, 3)
    base = port.probabilities(w)
    factors = {c.lower(): 1.0 for c in port.classes}
    factors["class3"] = 2.0
    port.sensitivity_factors, ref.sensitivity_factors = dict(factors), dict(factors)
    try:
        boosted = port.probabilities(w)
        np.testing.assert_allclose(boosted, ref.probabilities(w), rtol=0, atol=TOL_PROBS)
    finally:
        port.sensitivity_factors = {c.lower(): 1.0 for c in port.classes}
        ref.sensitivity_factors = {c.lower(): 1.0 for c in ref.classes}
    assert (boosted[:, 2] > base[:, 2]).all()
    np.testing.assert_allclose(boosted.sum(1), 1.0, atol=1e-12)


def _track(seed, n=23):
    p = np.random.default_rng(seed).dirichlet(np.full(5, 0.6), size=n)
    p[n // 2] = [0.22, 0.21, 0.19, 0.19, 0.19]  # a low-confidence row
    return p


@pytest.mark.parametrize("probs", [
    np.vstack([np.full((4, 5), 0.05) + np.eye(5)[0] * 0.75, [[0.22, 0.21, 0.19, 0.19, 0.19]],
               np.full((4, 5), 0.05) + np.eye(5)[0] * 0.75]),
    _track(4), _track(5, n=3), np.zeros((0, 5))], ids=["reference", "track", "short", "empty"])
def test_smoothing_and_fallback_match_reference(analyzers, probs):
    port, ref = analyzers
    (tp, ts), (jp, js) = port.smooth_predictions(probs), ref.smooth_predictions(probs)
    np.testing.assert_array_equal(tp, np.asarray(jp))
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-6)
    if probs.shape[0] == 9:
        assert (tp == 0).all()  # the fallback snaps the noisy row to the majority


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_run_length_segments_match_reference(analyzers, seed):
    port, ref = analyzers
    rng = np.random.default_rng(seed)
    preds = np.repeat(rng.integers(0, 5, 6), rng.integers(1, 4, 6))
    probs = rng.dirichlet(np.full(5, 0.3), size=len(preds))
    stamps = [0.6 * i for i in range(len(preds))]
    got = port.confident_segments(stamps, preds, probs)
    assert got == ref.confident_segments(stamps, preds, probs)
    assert port.confident_segments(stamps, preds, np.full_like(probs, 0.1)) == []


@pytest.mark.parametrize("kernel_size,shape,axis", [(5, (17,), -1), (3, (6, 11), 0),
                                                    (7, (4, 9), 1), (1, (8,), 0)])
def test_median_filter_matches_reference_and_scipy(kernel_size, shape, axis):
    x = np.random.default_rng(kernel_size).integers(0, 5, size=shape).astype(np.float32)
    got = TF.median_filter1d(torch.from_numpy(x), kernel_size, axis=axis).numpy()
    np.testing.assert_array_equal(got, np.asarray(JF.median_filter1d(jnp.asarray(x),
                                                                      kernel_size, axis=axis)))
    k = [1] * x.ndim
    k[axis] = kernel_size
    np.testing.assert_array_equal(got, scipy.signal.medfilt(x, k))
    with pytest.raises(ValueError):
        TF.median_filter1d(torch.from_numpy(x), 4)


def test_analyzer_defaults_to_cuda():
    import inspect

    assert inspect.signature(TL.LegacyAudioAnalyzer).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TL.LegacyAudioAnalyzer(BinaryClassifier("resnet18", num_outputs=5))


def test_legacy_inference_cli_matches_reference(state_dict, tmp_path):
    """The CLI on a 5-s clip (two windows at the analyzer's 512²) writes
    the JSON the reference's analyzer gives on the same weights (at a
    confidence threshold that the untrained model's segments clear)."""
    ckpt = str(tmp_path / "legacy.pth")
    save_submodel_torch(ckpt, state_dict)
    clip = str(tmp_path / "clip.wav")
    wavio.write_wav(clip, (np.random.default_rng(6).standard_normal(5 * 32_000) * 0.2)
                    .astype(np.float32), 32_000)
    out = tmp_path / "out"
    rc = legacy_inference.main(["--checkpoint_path", ckpt, "--audio_path", clip, "--output_dir",
                                str(out), "--model-name", "resnet18", "--device", "cpu",
                                "--confidence_threshold", "0.25"])
    os.remove(ckpt)
    assert rc == 0
    got = json.loads((out / "clip.json").read_text())
    _, ref = _analyzers(state_dict, out_size=512)
    ref.confidence_threshold = 0.25
    want = ref.analyze_audio(clip)
    assert got["filename"] == "clip.wav"
    assert list(got["percentages"]) == TL.DEFAULT_CLASSES
    for c, v in want["percentages"].items():
        assert abs(got["percentages"][c] - v) <= 0.011, c
    assert [(s["class"], s["start"], s["end"]) for s in got["segments"]] == \
        [(s["class"], s["start"], s["end"]) for s in want["segments"]]
    assert got["segments"], "no confident segment: the comparison would be empty"
    for g, w in zip(got["segments"], want["segments"]):
        assert abs(g["confidence"] - w["confidence"]) <= 1e-4


def test_legacy_trainer_cli_saves_every_epoch(tmp_path, monkeypatch):
    """One epoch on a tiny tree of the five legacy class folders at 64²:
    the per-epoch checkpoint and its .pth twin beside the best one."""
    rng = np.random.default_rng(7)
    for split, n in (("train", 2), ("test", 1)):
        for cls in legacy_trainer.LEGACY_CLASSES:
            (tmp_path / "data" / split / cls).mkdir(parents=True)
            for i in range(n):
                wavio.write_wav(str(tmp_path / "data" / split / cls / f"{i}.wav"),
                                (rng.standard_normal(8 * 32_000) * 0.2).astype(np.float32),
                                32_000)
    monkeypatch.chdir(tmp_path)  # the CLI writes logs/ and runs/ where it runs
    ck = tmp_path / "ck"
    try:
        rc = legacy_trainer.main(["--data-dir", "data", "--epochs", "1", "--batch-size", "4",
                                  "--input-size", "64", "--model-name", "resnet18",
                                  "--device", "cpu", "--checkpoint-dir", str(ck)])
        assert rc == 0
        saved = sorted(os.listdir(ck))
        epoch = [f for f in saved if f.startswith("epoch_0_acc_") and f.endswith(".ckpt")]
        assert len(epoch) == 1 and epoch[0] + ".pth" in saved, saved
        assert float(epoch[0][len("epoch_0_acc_"):-len(".ckpt")]) <= 1.0
    finally:
        for f in os.listdir(ck) if ck.exists() else []:
            os.remove(ck / f)  # hundreds of MB of checkpoints


def test_legacy_trainer_defaults():
    args = legacy_trainer.build_parser().parse_args([])
    assert (args.device, args.model_name, args.lr, args.classes) == (
        "cuda", "resnet152", 1e-4, ["Real", "class1", "class2", "class3", "class4"])
