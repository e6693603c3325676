"""The port's legacy 5-class analyzer (``infer/legacy_analyzer.py``) on a
ResNet-152 (bottleneck blocks) against the JAX package's
(``synthetic_audio_detection_tpu/infer/legacy_analyzer.py``) and against
the benchmark's plain reference (``portbench/reference/legacy.py``), at 64²
with 1-s windows, on the benchmark's calibrated seeded weights
(``portbench/reference/legacy.draw``), which make the top class change
along a track.

Tolerances: every side computes in float32 with its own summation order
(the two packages' GEMM DFT against the reference's FFT; XLA's, oneDNN's
and the functional forms' convolutions), so each strays from the float64
evaluation of the same function by its own rounding. The port's
probabilities are held to that float64 truth within
``parity_bounds.reference_error_bound`` of the JAX package's distance from
it, and its log-probabilities within four times the plain float32
reference's. The post-processing is compared exactly (labels, segment
times and classes) or within its float32 smoothing (confidences 1e-5;
percentages, which both round to 2 decimals, 0.011).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench import generate, run
from portbench.reference import backbone, frontend, resnet
from portbench.reference import legacy as ref_legacy
from portbench.work.frontend import filterbank
from synthetic_audio_detection_tpu.checkpoints.torch_compat import (
    classifier_variables_from_torch,
)
from synthetic_audio_detection_tpu.infer import legacy_analyzer as JL
from synthetic_audio_detection_tpu.models.classifier import BinaryClassifier as JaxClassifier
from synthetic_audio_detection_tpu_torch.audio import wavio
from synthetic_audio_detection_tpu_torch.audio.decode import load_audio
from synthetic_audio_detection_tpu_torch.infer.legacy_analyzer import (
    LegacyAudioAnalyzer,
    LegacyAudioConfig,
)
from synthetic_audio_detection_tpu_torch.models.classifier import BinaryClassifier
from synthetic_audio_detection_tpu_torch.utils import profiling
from tests import parity_bounds

SEED = 2**31 + 5
SR = 32_000
RANGES = ("legacy.request", "legacy.prepare", "legacy.window", "legacy.pad", "legacy.forward",
          "legacy.frontend", "legacy.backbone", "legacy.d2h", "legacy.smooth")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def cfg():
    c = run.cell_files("r152-legacy5.bulk")["config"]
    c["spectrogram"]["out_size"] = 64
    c["audio"]["window_seconds"] = 1.0
    c["serve"]["batch_size"] = 16
    return c


@pytest.fixture(scope="module")
def weights(cfg):
    pool = generate.window_pool(ref_legacy.CALIBRATION_POOL, SR, SR, SEED, "cpu")
    calibration = ref_legacy.calibration_windows(pool, cfg["audio"])
    return ref_legacy.draw(cfg, SEED, "cpu", torch.from_numpy(calibration))


@pytest.fixture(scope="module")
def state_dict(weights):
    sd = {f"base.{k}": t for k, t in weights["backbones"][0].items()}
    sd.update({f"head.{k}": t for k, t in weights["heads"][0].items()})
    return sd


def _audio(cfg):
    a = cfg["audio"]
    return dict(target_sample_rate=a["sample_rate"], window_size=a["window_seconds"],
                overlap=a["overlap"], silence_threshold=a["silence_threshold"],
                normalize_audio=a["normalize"], batch_size=cfg["serve"]["batch_size"])


@pytest.fixture(scope="module")
def analyzer(cfg, state_dict):
    """The port's analyzer, as the legacy CLI builds it, and the
    classifier's output rows of each forward."""
    m = cfg["model"]
    model = BinaryClassifier(m["arch"], m["in_channels"], num_outputs=m["outputs"])
    missing, unexpected = model.load_state_dict(state_dict, strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    an = LegacyAudioAnalyzer(model, classes=m["class_names"],
                             audio=LegacyAudioConfig(**_audio(cfg)),
                             confidence_threshold=cfg["serve"]["confidence_threshold"],
                             device="cpu")
    spec = {k: getattr(an.spec_cfg, k) for k in cfg["spectrogram"] if hasattr(an.spec_cfg, k)}
    assert spec == dict(cfg["spectrogram"], out_size=an.spec_cfg.out_size)  # the CLI's front end
    an.spec_cfg = dataclasses.replace(an.spec_cfg, out_size=cfg["spectrogram"]["out_size"])
    rows, classifier = [], an.model

    def keep_rows(x):
        rows.append(classifier(x))
        return rows[-1]
    an.model = keep_rows
    return an, rows


@pytest.fixture(scope="module")
def jax_analyzer(cfg, state_dict):
    m = cfg["model"]
    variables = classifier_variables_from_torch({k: v.numpy() for k, v in state_dict.items()},
                                                base_prefix="base.")
    an = JL.LegacyAudioAnalyzer(JaxClassifier(backbone=m["arch"], num_outputs=m["outputs"]),
                                variables, classes=m["class_names"],
                                audio=JL.LegacyAudioConfig(**_audio(cfg)))
    an.spec_cfg = dataclasses.replace(an.spec_cfg, out_size=cfg["spectrogram"]["out_size"])
    return an


def _clip(n_windows, seed=SEED):
    return generate.window_pool(n_windows, SR, SR, seed, "cpu").reshape(-1)


def _truth(windows, cfg, weights):
    """The reference's log-probabilities evaluated in float64 throughout."""
    spec, m = cfg["spectrogram"], cfg["model"]
    x = torch.from_numpy(windows).double()
    n_fft, hop = spec["n_fft"], spec["hop_length"]
    frames = F.pad(x[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0].unfold(1, n_fft, hop)
    n = torch.arange(n_fft, dtype=torch.float64)
    X = torch.fft.rfft(frames * (0.5 - 0.5 * torch.cos(2.0 * math.pi * n / n_fft)), dim=-1)
    mel = ((X.real ** 2 + X.imag ** 2) @ torch.from_numpy(filterbank(spec, SR))).transpose(1, 2)
    z = frontend.resize(frontend.standardize(frontend.to_db(mel, spec["top_db"]), spec["eps"]),
                        spec["out_size"])
    bb = {k: v.double() for k, v in weights["backbones"][0].items()}
    hd = {k: v.double() for k, v in weights["heads"][0].items()}
    pooled = backbone(m).forward(z[:, None].expand(-1, m["in_channels"], -1, -1), bb, m)
    return torch.log_softmax(resnet.head(pooled, hd, dropout=m["head_dropout"]), -1).numpy()


@pytest.fixture(scope="module")
def windows(cfg):
    w, _ = ref_legacy.windows_of(_clip(4), cfg["audio"])
    assert len(w) == 21  # a full batch of 16 and a tail padded to 8
    return w


@pytest.fixture(scope="module")
def truth(windows, cfg, weights):
    return _truth(windows, cfg, weights)


def test_probabilities_match_the_jax_package_within_float32_rounding(analyzer, jax_analyzer,
                                                                     windows, truth):
    an, _ = analyzer
    port, jax_probs = an.probabilities(windows), jax_analyzer.probabilities(windows)
    assert port.shape == jax_probs.shape == (21, 5)
    want = np.exp(truth)
    parity_bounds.assert_within_reference(port, jax_probs, want, 1.0, err_msg="probabilities")
    bound = parity_bounds.reference_error_bound(jax_probs, want, 1.0)
    assert np.ptp(want, axis=0).min() > 100 * bound  # the windows differ by far more
    assert len(set(want.argmax(1))) > 1  # and not every window has the same top class


def test_log_probabilities_match_the_reference_within_float32_rounding(cfg, analyzer, weights,
                                                                       windows, truth):
    an, rows = analyzer
    rows.clear()
    an.probabilities(windows)
    z = torch.cat(rows)[:len(windows)].double()
    port = (z - torch.logsumexp(z, 1, keepdim=True)).numpy()
    x = torch.from_numpy(windows)
    ref = ref_legacy.log_probs(x, cfg, weights).double().numpy()
    bound = 4.0 * np.abs(ref - truth).max()
    assert np.abs(port - truth).max() <= bound
    spread = np.sqrt(np.mean((truth - truth.mean(0)) ** 2))
    assert bound < 1e-3 * spread  # the windows differ by far more than the rounding
    low = ref_legacy.log_probs(x, cfg, weights, resnet.quantizer(torch.bfloat16)).double().numpy()
    assert np.abs(low - truth).max() > 100 * bound  # a lower precision falls outside


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_post_processing_matches_the_reference_on_the_same_probabilities(cfg, analyzer, seed):
    """A varied probability track through the port's smoothing and segments
    and through the reference's."""
    an, _ = analyzer
    rng = np.random.default_rng(seed)
    n = 40
    probs = rng.dirichlet(np.full(5, 0.3), size=n)
    probs[::7] = rng.dirichlet(np.full(5, 5.0), size=len(probs[::7]))  # low-confidence rows
    stamps = [0.15 * i for i in range(n)]
    final, sm = an.smooth_predictions(probs)
    got = an.confident_segments(stamps, final, sm)
    thr = cfg["serve"]["confidence_threshold"]
    ref = ref_legacy.analyze(probs, stamps, cfg["model"]["class_names"],
                             ref_legacy.sensitivity_of(cfg), thr, cfg["audio"]["window_seconds"])
    tip = ref_legacy.tippable(ref, thr, 1e-4)
    assert not tip.all()
    np.testing.assert_array_equal(final[~tip], ref["final"][~tip])
    np.testing.assert_allclose(sm, ref["sm"], rtol=0, atol=1e-6)
    _assert_judged_segments(got, ref, tip, stamps, thr)


def _assert_judged_segments(got, ref, tip, stamps, thr):
    """Each run of labels no rounding can change is a segment on both sides
    (same end, class, and confidence within 1e-5) or on neither."""
    by_start = {s["start"]: s for s in got}
    want = {s["start"]: s for s in ref["segments"]}
    runs = ref_legacy.judged_runs(ref, tip, thr, 1e-4)
    assert runs
    for a, _ in runs:
        g, e = by_start.get(float(stamps[a])), want.get(float(stamps[a]))
        assert (g is None) == (e is None), stamps[a]
        if e is not None:
            assert (g["end"], g["class"]) == (e["end"], e["class"])
            assert abs(g["confidence"] - e["confidence"]) <= 1e-5


def test_analyze_waveform_matches_the_reference_post_processing(cfg, analyzer):
    an, _ = analyzer
    clip = _clip(3, seed=11)
    captured = {}
    probabilities = an.probabilities

    def keep(w):
        captured["p"] = probabilities(w)
        return captured["p"]
    an.probabilities = keep
    try:
        out = an.analyze_waveform(clip, SR)
    finally:
        del an.probabilities
    _, stamps = ref_legacy.windows_of(clip, cfg["audio"])
    starts = [a for a, _ in stamps]
    thr = cfg["serve"]["confidence_threshold"]
    ref = ref_legacy.analyze(captured["p"], starts, cfg["model"]["class_names"],
                             ref_legacy.sensitivity_of(cfg), thr, cfg["audio"]["window_seconds"])
    tip = ref_legacy.tippable(ref, thr, 1e-4)
    _assert_judged_segments(out["segments"], ref, tip, starts, thr)
    assert out["segments"]
    for c, v in ref["percentages"].items():
        assert abs(out["percentages"][c] - v) <= 0.011, c


@pytest.mark.parametrize("channels,rate,seconds", [(2, 48_000, 2.5), (1, SR, 0.5)])
def test_analyze_audio_is_decode_plus_analyze_waveform(analyzer, tmp_path, channels, rate,
                                                       seconds):
    """A stereo 48-kHz file (mono fold, resample) and a short mono one (the
    5-s pad)."""
    an, _ = analyzer
    rng = np.random.default_rng(channels)
    path = str(tmp_path / "clip.wav")
    wave = (0.2 * rng.standard_normal((channels, int(seconds * rate)))).astype(np.float32)
    wavio.write_wav(path, wave if channels > 1 else wave[0], rate)
    got = an.analyze_audio(path)
    assert got == an.analyze_waveform(*load_audio(path))
    assert got["segments"] and set(got["percentages"]) == set(an.classes)


def test_every_legacy_range_and_counter_is_recorded(cfg, analyzer):
    an, _ = analyzer
    clip = _clip(4, seed=13)
    clip[SR:3 * SR] = 0.0  # the gate drops the windows inside the two silent seconds,
    loud = clip != 0.0  # which stay silent once the normalization subtracts the mean
    clip[loud] -= clip[loud].mean()
    profiling.reset_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        an.analyze_waveform(clip, SR)
    names = {e.name for e in prof.events()}
    assert set(RANGES) <= names, set(RANGES) - names
    windows, _ = ref_legacy.windows_of(clip, cfg["audio"])
    a = cfg["audio"]
    hop = int((1.0 - a["overlap"]) * SR)
    total = len(range(0, clip.shape[0] - SR + 1, hop))
    bs = cfg["serve"]["batch_size"]
    rows = [min(bs, len(windows) - i) for i in range(0, len(windows), bs)]
    padded = [r if r % 8 == 0 else r + 8 - r % 8 for r in rows]
    assert 0 < len(windows) < total
    assert profiling.counters() == {
        "legacy.windows": len(windows), "legacy.silent_windows": total - len(windows),
        "legacy.batches": len(rows), "legacy.rows": sum(padded)}
