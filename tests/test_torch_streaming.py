"""The port's live streaming (``infer/streaming.py``) on the CPU at 64²:
the incremental resampler against the JAX package's and the offline
``resample_poly_np``; a stream's ``finalize`` against the port's own
offline ``analyze_windows`` over the concatenated audio; and the port's
analyzer against the JAX package's on the same weights and chunks.

Tolerances: streamed resample 1e-5 absolute (float32 GEMMs whose BLAS
kernel varies with the row count); finalize against offline and the port
against JAX, labels equal and percentages within 1e-4 (the end-to-end
bound of tests/test_torch_pipeline.py: the packages' float32 front ends
and ResNets differ in summation order).
"""

import jax
import numpy as np
import pytest
import torch

from synthetic_audio_detection_tpu.checkpoints.torch_compat import (
    classifier_variables_from_torch,
)
from synthetic_audio_detection_tpu.ensemble import multihead as JE
from synthetic_audio_detection_tpu.infer import pipeline as JP
from synthetic_audio_detection_tpu.infer import streaming as JS
from synthetic_audio_detection_tpu.models.classifier import BinaryClassifier as JaxClassifier
from synthetic_audio_detection_tpu_torch.audio.resample import resample_poly_np
from synthetic_audio_detection_tpu_torch.checkpoints import from_jax
from synthetic_audio_detection_tpu_torch.infer import pipeline as TP
from synthetic_audio_detection_tpu_torch.infer import streaming as TS
from synthetic_audio_detection_tpu_torch.models.classifier import BinaryClassifier
from synthetic_audio_detection_tpu_torch.utils.config import (
    AudioConfig,
    InferenceConfig,
    SpectrogramConfig,
)

NAMES = ["SynA", "SynB", "Real"]
SPEC = SpectrogramConfig(mel_norm="slaney", out_size=64)
INFER = InferenceConfig(batch_size=8)
TOL_PCT = 1e-4
TOL_RESAMPLE = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def jax_variables(heads=2):
    """Seeded torch inits as JAX variables, each head's last layer scaled
    up so that the logits are O(1) and no verdict sits on a tie."""
    out = []
    for seed in range(heads):
        with torch.random.fork_rng():
            torch.manual_seed(seed)
            sd = BinaryClassifier().state_dict()
        sd["head.10.weight"] = sd["head.10.weight"] * 30.0
        out.append(classifier_variables_from_torch({k: v.numpy() for k, v in sd.items()},
                                                   base_prefix="base."))
    return out


def both_pipelines(audio, infer=INFER):
    """(the JAX package's pipeline, the port's on the CPU) on the same
    weights."""
    je = JE.build_ensemble(JaxClassifier(backbone="resnet18"), jax_variables(), NAMES,
                           detect_shared_backbone=False)
    te = from_jax.ensemble_from_variables(jax.tree_util.tree_map(np.asarray, je.variables),
                                          NAMES, detect_shared_backbone=False)
    return (JP.InferencePipeline(je, audio=audio, spec=SPEC, infer=infer, use_pallas=False),
            TP.InferencePipeline(te, audio=audio, spec=SPEC, infer=infer, device="cpu"))


@pytest.fixture(scope="module")
def pipes():
    return both_pipelines(AudioConfig(overlap=0.3, silence_threshold=1e-3))


def _chunks(x, rng, lo=1_000, hi=90_000):
    """x in random-sized chunks, some of them tiny."""
    out, pos = [], 0
    while pos < len(x):
        n = int(rng.integers(lo, hi)) if rng.random() > 0.2 else int(rng.integers(1, 50))
        out.append(x[pos : pos + n])
        pos += n
    return out


def assert_same_result(got, want, atol=TOL_PCT):
    assert [s["label"] for s in got["segments"]] == [s["label"] for s in want["segments"]]
    assert [(s["start_sec"], s["end_sec"]) for s in got["segments"]] == \
        [(s["start_sec"], s["end_sec"]) for s in want["segments"]]
    assert set(got["percentages"]) == set(want["percentages"])
    for k, v in want["percentages"].items():
        assert abs(got["percentages"][k] - v) <= atol, k


@pytest.mark.parametrize("orig,new", [(44_100, 32_000), (48_000, 32_000), (16_000, 32_000),
                                      (22_050, 32_000)])
def test_streaming_resampler_matches_jax_and_offline(orig, new):
    rng = np.random.default_rng(orig)
    x = (rng.standard_normal(orig * 3 + 137) * 0.5).astype(np.float32)
    chunks = _chunks(x, rng, lo=500, hi=20_000)
    port, ref = TS.StreamingResampler(orig, new), JS.StreamingResampler(orig, new)
    got = np.concatenate([port.feed(c) for c in chunks] + [port.finalize()])
    want = np.concatenate([ref.feed(c) for c in chunks] + [ref.finalize()])
    offline = resample_poly_np(x, orig, new)
    assert got.shape == want.shape == offline.shape == (-(-len(x) * new // orig),)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_RESAMPLE)
    np.testing.assert_allclose(got, offline, rtol=0, atol=TOL_RESAMPLE)
    np.testing.assert_allclose(want, offline, rtol=0, atol=TOL_RESAMPLE)


def test_streaming_resampler_single_feed_and_equal_rates():
    x = (np.random.default_rng(0).standard_normal(44_100 * 2) * 0.5).astype(np.float32)
    rs = TS.StreamingResampler(44_100, 32_000)
    got = np.concatenate([rs.feed(x), rs.finalize()])
    np.testing.assert_allclose(got, resample_poly_np(x, 44_100, 32_000), rtol=0,
                               atol=TOL_RESAMPLE)
    assert rs.finalize().size == 0
    with pytest.raises(RuntimeError):
        rs.feed(x)
    with pytest.raises(ValueError):
        TS.StreamingResampler(32_000, 32_000)


def _offline(pipe, wf, smooth=None):
    if len(wf) < pipe.audio.window_samples:
        wf = np.pad(wf, (0, pipe.audio.window_samples - len(wf)))
    windows, stamps = TP.slice_waveform(wf, pipe.audio)
    return pipe.analyze_windows(windows, stamps, smooth=smooth)


def _stream(pipe, chunks, source_rate=None, smooth=None):
    sa = TS.StreamingAnalyzer(pipe, source_rate=source_rate)
    live = [v for c in chunks for v in sa.feed(c)]
    return sa, live, sa.finalize(smooth=smooth)


def test_stream_equals_offline_at_target_rate(pipes):
    pipe = pipes[1]
    rng = np.random.default_rng(1)
    wf = (rng.standard_normal(32_000 * 11) * 0.3).astype(np.float32)
    want = _offline(pipe, wf)
    sa, live, got = _stream(pipe, _chunks(wf, rng))
    assert_same_result(got, want)
    # the live verdicts are the final (unsmoothed) segments
    assert [v["label"] for v in live] == [s["label"] for s in want["segments"]]
    assert sa.windows_completed == len(want["segments"]) == 3


def test_stream_equals_offline_with_resample(pipes):
    pipe = pipes[1]
    rng = np.random.default_rng(2)
    raw = (rng.standard_normal(44_100 * 10) * 0.3).astype(np.float32)
    want = _offline(pipe, resample_poly_np(raw, 44_100, 32_000))
    _, _, got = _stream(pipe, _chunks(raw, rng), source_rate=44_100)
    assert_same_result(got, want)


def test_stream_smoothing_matches_offline(pipes):
    pipe = pipes[1]
    rng = np.random.default_rng(3)
    wf = (rng.standard_normal(32_000 * 13) * 0.3).astype(np.float32)
    _, _, got = _stream(pipe, _chunks(wf, rng), smooth=True)
    assert_same_result(got, _offline(pipe, wf, smooth=True))


def test_stream_silence_gate_matches_offline(pipes):
    pipe = pipes[1]
    rng = np.random.default_rng(4)
    win, hop = pipe.audio.window_samples, pipe.audio.hop_samples
    # loud | silent (spanning whole windows) | loud
    wf = np.concatenate([rng.standard_normal(hop * 2) * 0.3, np.zeros(win + hop * 2),
                         rng.standard_normal(win + hop) * 0.3]).astype(np.float32)
    want = _offline(pipe, wf)
    n_all = 1 + (len(wf) - win) // hop
    assert 0 < len(want["segments"]) < n_all  # the gate dropped some windows, not all
    _, _, got = _stream(pipe, _chunks(wf, rng))
    assert_same_result(got, want)


def test_stream_shorter_than_window_pads(pipes):
    pipe = pipes[1]
    wf = (np.random.default_rng(5).standard_normal(32_000) * 0.3).astype(np.float32)
    want = _offline(pipe, wf)
    assert len(want["segments"]) == 1
    _, _, got = _stream(pipe, [wf])
    assert_same_result(got, want)


def test_silent_stream_and_feed_after_finalize(pipes):
    sa = TS.StreamingAnalyzer(pipes[1])
    assert sa.feed(np.zeros(200_000, np.float32)) == []
    assert sa.finalize() == {"segments": [], "percentages": {}}
    with pytest.raises(RuntimeError):
        sa.feed(np.zeros(10, np.float32))
    with pytest.raises(RuntimeError):
        sa.finalize()


@pytest.mark.parametrize("source_rate,smooth", [(None, False), (44_100, False), (16_000, True)])
def test_port_stream_matches_jax_stream(pipes, source_rate, smooth):
    """The same chunks through both packages' StreamingAnalyzer on the same
    weights: the same live verdicts and the same final result."""
    rate = source_rate or 32_000
    rng = np.random.default_rng(rate)
    raw = (rng.standard_normal(rate * 9 + 321) * 0.3).astype(np.float32)
    chunks = _chunks(raw, rng)
    results = []
    for pipe, mod in zip(pipes, (JS, TS)):
        sa = mod.StreamingAnalyzer(pipe, source_rate=source_rate)
        live = [v for c in chunks for v in sa.feed(c)]
        results.append((live, sa.finalize(smooth=smooth)))
    (j_live, j_res), (t_live, t_res) = results
    assert len(t_live) == len(j_live) > 0
    for t, j in zip(t_live, j_live):
        assert (t["start_sec"], t["end_sec"], t["label"]) == (j["start_sec"], j["end_sec"],
                                                             j["label"])
        np.testing.assert_allclose(t["probs"], j["probs"], rtol=0, atol=TOL_PCT / 100)
    assert_same_result(t_res, j_res)
