"""The port's serving pipeline and CLI against the JAX package's, on the
CPU at 64² inputs with the same weights and the same audio.

Given the same logits the two pipelines must write the same JSON text byte
for byte (host-side float32 sigmoid, decision rule, percentages). With
smoothing the two Gaussian convolutions may differ in the last ulp, so
labels must agree and percentages within 1e-5. End to end (each package's
own float32 front end and ensemble) labels must agree and percentages
within 1e-4.
"""

import contextlib
import dataclasses
import io
import json

import jax
import numpy as np
import pytest
import torch

from synthetic_audio_detection_tpu.audio import wavio
from synthetic_audio_detection_tpu.checkpoints import serialization as jax_ser
from synthetic_audio_detection_tpu.checkpoints.torch_compat import (
    classifier_variables_from_torch,
)
from synthetic_audio_detection_tpu.ensemble import multihead as JE
from synthetic_audio_detection_tpu.infer import pipeline as JP
from synthetic_audio_detection_tpu.models.classifier import BinaryClassifier as JaxClassifier
from synthetic_audio_detection_tpu.utils.config import (
    AudioConfig,
    InferenceConfig,
    SpectrogramConfig,
)
from synthetic_audio_detection_tpu_torch.checkpoints import from_jax
from synthetic_audio_detection_tpu_torch.cli import inference_runner
from synthetic_audio_detection_tpu_torch.infer import pipeline as TP
from synthetic_audio_detection_tpu_torch.models.classifier import BinaryClassifier

NAMES = ["SynA", "SynB", "Real"]
SPEC = SpectrogramConfig.inference(out_size=64)
AUDIO = AudioConfig(overlap=0.0, silence_threshold=1e-3)


@pytest.fixture(scope="module")
def jax_vars():
    out = []
    for seed in range(3):
        with torch.random.fork_rng():
            torch.manual_seed(seed)
            sd = BinaryClassifier().state_dict()
        out.append(classifier_variables_from_torch({k: v.numpy() for k, v in sd.items()},
                                                   base_prefix="base."))
    return out


def _ensembles(jax_vars, generic=False, calibration=None):
    model = JaxClassifier(backbone="resnet18")
    vs = jax_vars if generic else jax_vars[:2]
    je = JE.build_ensemble(model, vs, NAMES, detect_shared_backbone=False,
                           generic_head=generic)
    je.calibration = calibration
    te = from_jax.ensemble_from_variables(jax.tree_util.tree_map(np.asarray, je.variables),
                                          NAMES, generic_head=generic,
                                          detect_shared_backbone=False,
                                          calibration=calibration)
    return je, te


def _pipelines(je, te, infer=None, **kw):
    infer = infer or InferenceConfig(batch_size=8)
    return (JP.InferencePipeline(je, audio=AUDIO, spec=SPEC, infer=infer, use_pallas=False, **kw),
            TP.InferencePipeline(te, audio=AUDIO, spec=SPEC, infer=infer, device="cpu", **kw))


@pytest.fixture(scope="module")
def dense_pipelines(jax_vars):
    return _pipelines(*_ensembles(jax_vars))


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """14 s at 32 kHz with a silent 4-8 s stretch (the silence gate drops
    that window)."""
    rng = np.random.default_rng(0)
    wav = (rng.standard_normal(32_000 * 14) * 0.2).astype(np.float32)
    wav[32_000 * 4 : 32_000 * 8] = 0.0
    path = str(tmp_path_factory.mktemp("audio") / "clip.wav")
    wavio.write_wav(path, wav, 32_000)
    return path


CAL = {"temperatures": [1.3, 0.8, 1.1, 0.9], "threshold": 0.45,
       "column_thresholds": [0.4, 0.55, 0.5, 0.6]}
CASES = {
    "default": ({}, InferenceConfig()),
    "round_floats": ({}, InferenceConfig(round_floats=True)),
    "syn_override_k": ({}, InferenceConfig(syn_override_k=2)),
    "generic_verdict": ({"generic": True}, InferenceConfig(generic_verdict=True)),
    "calibrated": ({"generic": True, "calibration": CAL}, InferenceConfig()),
    "column_thresholds": ({"generic": True, "calibration": CAL},
                          InferenceConfig(per_column_thresholds=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("smooth", [False, True])
def test_analyze_windows_same_logits(jax_vars, case, smooth):
    ens_kw, infer = CASES[case]
    je, te = _ensembles(jax_vars, **ens_kw)
    jp, tp = _pipelines(je, te, infer=infer)
    n = 13
    logits = (np.random.default_rng(1).standard_normal((n, je.num_heads + 1)) * 2
              ).astype(np.float32)
    windows = np.zeros((n, AUDIO.window_samples), np.float32)
    stamps = [(4.0 * i, 4.0 * i + 4.0) for i in range(n)]
    ref = jp.analyze_windows(windows, stamps, smooth=smooth, logits=logits)
    got = tp.analyze_windows(windows, stamps, smooth=smooth, logits=logits)
    if not smooth:
        assert TP.result_json("clip.wav", got) == JP.result_json("clip.wav", ref)
        return
    assert [s["label"] for s in got["segments"]] == [s["label"] for s in ref["segments"]]
    assert got["percentages"].keys() == ref["percentages"].keys()
    for k, v in ref["percentages"].items():
        assert abs(got["percentages"][k] - v) <= 1e-5


def test_silent_clip_json_identical(dense_pipelines):
    jp, tp = dense_pipelines
    empty = np.zeros((0, AUDIO.window_samples), np.float32)
    assert (TP.result_json("s.wav", tp.analyze_windows(empty, []))
            == JP.result_json("s.wav", jp.analyze_windows(empty, [])))


def test_end_to_end_float32_matches_jax(dense_pipelines, clip):
    jp, tp = dense_pipelines
    windows, stamps = TP.slice_waveform(TP.preprocess_waveform(clip, AUDIO), AUDIO)
    assert len(stamps) == 2
    np.testing.assert_allclose(tp.logits_for_windows(windows), jp.logits_for_windows(windows),
                               rtol=0, atol=1e-4)
    got, ref = tp.analyze_file(clip), jp.analyze_file(clip)
    assert got["segments"] == ref["segments"]
    for k, v in ref["percentages"].items():
        assert abs(got["percentages"][k] - v) <= 1e-4


def test_int16_transport_matches_jax(jax_vars, clip):
    jp, tp = _pipelines(*_ensembles(jax_vars), transport_dtype="int16")
    windows, _ = TP.slice_waveform(TP.preprocess_waveform(clip, AUDIO), AUDIO)
    np.testing.assert_allclose(tp.logits_for_windows(windows), jp.logits_for_windows(windows),
                               rtol=0, atol=1e-4)


def test_bucket_padding_does_not_change_rows(dense_pipelines):
    """Rows are independent of what shares their batch, up to float32
    reordering inside the batched kernels (1e-5)."""
    _, tp = dense_pipelines
    w = (np.random.default_rng(2).standard_normal((11, AUDIO.window_samples)) * 0.2
         ).astype(np.float32)
    full = tp.logits_for_windows(w)  # bucket 8, two batches
    np.testing.assert_allclose(tp.logits_for_windows(w[:3]), full[:3], rtol=0, atol=1e-5)
    assert tp._bucket(3) == 8 and tp._bucket(9) == 8  # batch_size 8 here


def test_per_head_views_agree_with_serving_logits(dense_pipelines):
    """The same pass feeds both views; 1e-6 allows only the float32
    reordering of separate calls."""
    _, tp = dense_pipelines
    w = (np.random.default_rng(3).standard_normal((3, AUDIO.window_samples)) * 0.2
         ).astype(np.float32)
    agg, nh = tp.logits_and_per_head(w)
    np.testing.assert_allclose(agg, tp.logits_for_windows(w), rtol=0, atol=1e-6)
    assert nh.shape == (3, 2, 2)
    np.testing.assert_allclose(agg[:, :2], nh[:, :, 1], rtol=0, atol=1e-6)
    np.testing.assert_allclose(agg[:, 2], nh[:, :, 0].mean(axis=1), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tp.per_head_sigmoids(w, serving_numerics=False),
                               tp.per_head_sigmoids(w), rtol=0, atol=1e-6)


def test_host_preprocessing_matches_jax(tmp_path):
    """Stereo 44.1 kHz input: mono mean, the port's own resampler, pad,
    overlapped windows and stamps — identical to the JAX package's (the
    same float32 sgemm resampler; 1e-6 for BLAS summation order)."""
    rng = np.random.default_rng(4)
    stereo = (rng.standard_normal((2, 44_100 * 9)) * 0.3).astype(np.float32)
    path = str(tmp_path / "stereo.wav")
    wavio.write_wav(path, stereo, 44_100)
    audio = AudioConfig(overlap=0.3, silence_threshold=1e-3)
    got = TP.preprocess_waveform(path, audio)
    ref = JP.preprocess_waveform(path, audio)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    gw, gs = TP.slice_waveform(ref, audio)
    rw, rs = JP.slice_waveform(ref, audio)
    np.testing.assert_array_equal(gw, rw)
    assert gs == rs


def test_decide_rows_matches_jax():
    rng = np.random.default_rng(5)
    syn, real = rng.random((64, 3)).astype(np.float32), rng.random(64).astype(np.float32)
    thr = rng.uniform(0.3, 0.7, 4).astype(np.float32)
    for k in (1, 2, 3):
        np.testing.assert_array_equal(TP.decide_rows(syn, real, thr, k),
                                      JP.decide_rows(syn, real, thr, k))


def test_front_end_gate_follows_device_and_dtype(jax_vars):
    _, te = _ensembles(jax_vars)
    cpu_bf16 = TP.InferencePipeline(te, spec=SPEC, compute_dtype=torch.bfloat16, device="cpu",
                                    conv3x3_max_channels=512)
    assert not cpu_bf16.use_kernel and not cpu_bf16.use_fast_backbone
    assert cpu_bf16.conv3x3_max_channels == 0  # the conv kernel rides on the fast backbone
    assert cpu_bf16.ensemble.dtype == torch.bfloat16


def test_cuda_device_without_cuda_raises(jax_vars):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, te = _ensembles(jax_vars)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TP.InferencePipeline(te, spec=SPEC, device="cuda")


def _run_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = inference_runner.main(argv)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def merged_pth(jax_vars, tmp_path_factory):
    je, _ = _ensembles(jax_vars)
    path = str(tmp_path_factory.mktemp("ckpt") / "merged.pth")
    jax_ser.save_merged_torch(path, je)
    return path


def test_cli_stdout_contract(merged_pth, clip, dense_pipelines, tmp_path):
    jp, _ = dense_pipelines
    out_json = str(tmp_path / "out.json")
    rc, text = _run_cli(["--merged-model", merged_pth, "--audio", clip, "--input-size", "64",
                         "--batch-size", "8", "--device", "cpu", "--output-json", out_json])
    assert rc == 0
    lines = text.splitlines()
    assert lines[:4] == ["Using metadata names:", "Synthetic names: ['SynA', 'SynB']",
                         "Real name: Real", f"Wrote results to {out_json}"]
    payload = "\n".join(lines[4:])
    with open(out_json, encoding="utf-8") as f:
        assert f.read() == payload
    result = json.loads(payload)
    assert result["filename"] == clip
    ref = jp.analyze_file(clip)
    assert result["segments"] == ref["segments"]


def test_cli_silent_clip_and_folder_mode(merged_pth, clip, tmp_path):
    audio_dir = tmp_path / "in"
    audio_dir.mkdir()
    silent = str(audio_dir / "silent.wav")
    wavio.write_wav(silent, np.zeros(32_000 * 5, np.float32), 32_000)
    rc, text = _run_cli(["--merged-model", merged_pth, "--audio", silent, "--input-size", "64",
                         "--device", "cpu", "--output-json", str(tmp_path / "s.json")])
    assert rc == 0
    assert text.splitlines()[-1] == ("No valid audio chunks found (all below silence "
                                      "threshold). Exiting.")
    assert json.loads((tmp_path / "s.json").read_text())["percentages"] == {}
    wavio.write_wav(str(audio_dir / "clip.wav"), wavio.read_wav(clip)[0], 32_000)
    rc, text = _run_cli(["--merged-model", merged_pth, "--audio-dir", str(audio_dir),
                         "--input-size", "64", "--batch-size", "8", "--device", "cpu",
                         "--output-json", str(tmp_path / "out")])
    assert rc == 0 and "Analyzed 2/2 files" in text
    assert json.loads((tmp_path / "out" / "clip.json").read_text())["filename"] == "clip.wav"


def test_cli_generic_verdict_requires_generic_head(merged_pth, clip, tmp_path):
    with pytest.raises(ValueError, match="generic head"):
        _run_cli(["--merged-model", merged_pth, "--audio", clip, "--input-size", "64",
                  "--device", "cpu", "--generic-verdict",
                  "--output-json", str(tmp_path / "o.json")])


def test_pipeline_dataclass_configs_are_shared():
    """The port keeps its own AudioConfig/SpectrogramConfig/InferenceConfig
    (it imports nothing of the JAX package), with the reference's fields and
    defaults, and its pipeline takes either package's config objects."""
    for name in ("AudioConfig", "SpectrogramConfig", "InferenceConfig"):
        port, ref = getattr(TP, name), getattr(JP, name)
        assert port is not ref and port.__module__.startswith("synthetic_audio_detection_tpu_torch")
        assert dataclasses.asdict(port()) == dataclasses.asdict(ref())
    assert dataclasses.is_dataclass(SPEC) and isinstance(SPEC, JP.SpectrogramConfig)
