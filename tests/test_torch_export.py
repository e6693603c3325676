"""The port's serving artifact (infer/export.py: a ``torch.export`` program,
``InferencePipeline.from_artifact``, ``cli/serve.py --artifact``), the
twins of tests/test_export.py, on the CPU at 64² with the JAX package's
weights.

Tolerances: the artifact against the live ``forward_windows`` it was
traced from, rtol 1e-5 and atol 1e-6 (the reference's own bound for its
round trip; the same operators run, so they come out equal); the
artifact-backed pipeline against the checkpoint pipeline, labels equal
and percentages within 1e-3 (the reference's bound); the port's artifact
against the JAX package's of the same weights, 1e-4 on the logits (the
float32 end-to-end bound of tests/test_torch_pipeline.py). The artifact's
bytes stay within the weights' and the lifted constants' bytes plus 5%:
the weights are stored once.
"""

import dataclasses
import json
import logging
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic_audio_detection_tpu.infer import export as JX
from synthetic_audio_detection_tpu.utils.config import SpectrogramConfig as JaxSpectrogramConfig
from synthetic_audio_detection_tpu_torch.audio import wavio
from synthetic_audio_detection_tpu_torch.cli import serve as serve_cli
from synthetic_audio_detection_tpu_torch.ensemble.multihead import in_compute_dtype, with_dtype
from synthetic_audio_detection_tpu_torch.infer import export as TX
from synthetic_audio_detection_tpu_torch.infer.pipeline import InferencePipeline, forward_windows
from synthetic_audio_detection_tpu_torch.infer.server import serve
from synthetic_audio_detection_tpu_torch.utils.config import (
    AudioConfig,
    InferenceConfig,
    SpectrogramConfig,
)
from tests.torch_release import ensembles

SPEC = SpectrogramConfig.inference(out_size=64)
CAL = {"temperatures": [1.3, 0.8, 1.1], "threshold": 0.45}
TOL_PCT = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def models():
    return ensembles(calibration=CAL)


@pytest.fixture(scope="module")
def artifact(models):
    """The int16 entry point at batch entries 2 and 8, traced at 2."""
    return TX.export_serving(models[1], spec=SPEC, batch_sizes=(2, 8), transport_dtype="int16",
                             compute_dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def float_artifact(models):
    return TX.export_serving(models[1], spec=SPEC, batch_sizes=(2,), transport_dtype="float32",
                             compute_dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    rng = np.random.default_rng(3)
    path = tmp_path_factory.mktemp("audio") / "clip.wav"
    wavio.write_wav(str(path), (rng.standard_normal(13 * 32_000) * 0.2).clip(-1, 1), 32_000)
    return str(path)


def _windows(dtype, n=2):
    ints = np.random.default_rng(0).integers(-32768, 32768, size=(n, 128_000), dtype=np.int16)
    return ints if dtype == np.int16 else ints.astype(np.float32) / 32768.0


def _live(te, w):
    return forward_windows(te, torch.from_numpy(w), SPEC, 32_000).numpy()


def test_artifact_roundtrip_matches_forward_windows(models, float_artifact):
    program, meta = TX.load_artifact(float_artifact, device="cpu")
    w = _windows(np.float32)
    got = program(torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, _live(models[1], w), rtol=1e-5, atol=1e-6)
    assert got.shape == (2, 3)
    assert meta["class_names"] == ["SynA", "SynB", "Real"]
    assert meta["entries"] == [{"batch_size": 2}]
    assert meta["spec"] == dataclasses.asdict(SPEC)
    assert meta["platforms"] == ["cpu"] and meta["compute_dtype"] == "float32"
    assert meta["calibration"] == CAL


@pytest.mark.parametrize("batch", [2, 8])
def test_artifact_int16_entry_point_at_each_batch(models, artifact, batch):
    """Traced at 2, served at both entries: the batch dimension stayed
    dynamic through the front end, the backbones and the heads."""
    program, meta = TX.load_artifact(artifact, device="cpu")
    assert meta["transport_dtype"] == "int16" and meta["entries"] == [
        {"batch_size": 2}, {"batch_size": 8}]
    got = program(torch.from_numpy(_windows(np.int16, batch))).numpy()
    np.testing.assert_allclose(got, _live(models[1], _windows(np.float32, batch)),
                               rtol=1e-5, atol=1e-6)


def test_pipeline_from_artifact_matches_checkpoint_pipeline(models, artifact, clip):
    live = InferencePipeline(models[1], spec=SPEC, infer=InferenceConfig(batch_size=8),
                             transport_dtype="int16", device="cpu")
    pipe = InferencePipeline.from_artifact(artifact, device="cpu")
    assert pipe._bucket_sizes == [2, 8]
    assert [pipe._bucket(n) for n in (1, 2, 3, 8, 30)] == [2, 2, 8, 8, 8]
    assert pipe.ensemble.class_names == ["SynA", "SynB", "Real"]
    assert pipe.transport_dtype == "int16" and pipe.device == torch.device("cpu")
    assert pipe._cal == CAL and pipe._threshold == 0.45  # the header's calibration
    # a float32 artifact runs with TF32 off (a process flag, outside the graph)
    flags = []
    program = pipe._program
    pipe._program = lambda x: flags.append(
        torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32) or program(x)
    got, want = pipe.analyze_file(clip), live.analyze_file(clip)
    assert flags == [False]
    assert [s["label"] for s in got["segments"]] == [s["label"] for s in want["segments"]]
    for k in got["percentages"]:
        assert got["percentages"][k] == pytest.approx(want["percentages"][k], abs=TOL_PCT)

    w = _windows(np.float32)
    with pytest.raises(NotImplementedError, match="artifact"):
        pipe.per_head_sigmoids(w)
    with pytest.raises(NotImplementedError, match="artifact"):
        pipe.per_head_sigmoids(w, serving_numerics=False)
    with pytest.raises(NotImplementedError, match="artifact"):
        pipe.logits_and_per_head(w)


def _relabeled(data, **changes):
    meta, off = TX.read_header(data)
    head = json.dumps({**meta, **changes}, sort_keys=True).encode()
    return TX._MAGIC + len(head).to_bytes(4, "little") + head + data[off:]


def test_from_artifact_honours_host_audio_config(float_artifact):
    """Host knobs (overlap, silence gate, threshold, calibration switch)
    come from the caller; the sample rate from the artifact's header."""
    pipe = InferencePipeline.from_artifact(
        _relabeled(float_artifact, sample_rate=16_000),
        audio=AudioConfig(overlap=0.5, silence_threshold=1e-4),
        infer=InferenceConfig(threshold=0.6, apply_calibration=False), device="cpu")
    assert pipe.audio.overlap == 0.5 and pipe.audio.silence_threshold == 1e-4
    assert pipe.audio.sample_rate == 16_000  # the artifact wins
    assert pipe._cal is None and pipe._threshold == 0.6
    assert pipe.transport_dtype == "float32" and pipe._bucket_sizes == [2]


def test_artifact_refusals(artifact, tmp_path):
    with pytest.raises(ValueError, match="bad magic"):
        TX.load_artifact(b"NOPE" + b"\0" * 32, device="cpu")
    with pytest.raises(ValueError, match="length mismatch"):
        TX.load_artifact(artifact[:-7], device="cpu")
    with pytest.raises(ValueError, match="length mismatch"):
        TX.load_artifact(artifact + b"\0", device="cpu")
    # a program exported for the CPU is refused on the card, and one
    # recorded for the card on the CPU: the constants are baked there
    with pytest.raises(ValueError, match="exported for cpu"):
        TX.load_artifact(artifact, device="cuda")
    with pytest.raises(ValueError, match="exported for cuda"):
        TX.load_artifact(_relabeled(artifact, platforms=["cuda"]), device="cpu")
    path = tmp_path / "m.sadpt"
    TX.write_artifact(str(path), artifact)
    assert TX.load_artifact(str(path), device="cpu")[1]["entries"] == [
        {"batch_size": 2}, {"batch_size": 8}]


def test_the_two_packages_refuse_each_others_artifacts(models, float_artifact):
    """The JAX package's StableHLO file and the port's torch.export file
    do not read each other, and say so; and of the same weights the two
    artifacts compute the same logits within 1e-4."""
    je = models[0]
    jax_data = JX.export_serving(je, spec=JaxSpectrogramConfig.inference(out_size=64),
                                 batch_sizes=(2,), transport_dtype="float32",
                                 compute_dtype=jnp.float32)
    with pytest.raises(ValueError, match="JAX package"):
        TX.load_artifact(jax_data, device="cpu")
    with pytest.raises(ValueError, match="bad magic"):
        JX.load_artifact(float_artifact)
    jcalls, jmeta = JX.load_artifact(jax_data)
    tprogram, tmeta = TX.load_artifact(float_artifact, device="cpu")
    w = _windows(np.float32)
    got = tprogram(torch.from_numpy(w)).numpy()
    want = np.asarray(jcalls[2](w))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    for key in ("class_names", "generic_head", "window_samples", "sample_rate",
                "transport_dtype", "compute_dtype", "spec", "calibration"):
        assert tmeta.get(key) == jmeta.get(key), key


@pytest.mark.parametrize("dtype,shared", [(torch.float32, False), (torch.bfloat16, True)])
def test_artifact_stores_the_weights_once(models, artifact, dtype, shared):
    """The artifact's bytes are at most the weights' bytes (each parameter
    and buffer of the compute-dtype program once) plus the lifted
    constants' (the front end's window, DFT bases and mel filterbank)
    plus 5%. A bf16 artifact holds the bf16 copies of the backbone, not
    the float32 weights beside them."""
    if dtype == torch.float32:
        te, data = models[1], artifact
    else:
        te = ensembles(shared=True)[1]
        assert te.shared_backbone
        data = TX.export_serving(te, spec=SPEC, batch_sizes=(2, 8), compute_dtype=dtype,
                                 device="cpu")
    meta, _ = TX.read_header(data)
    program = in_compute_dtype(with_dtype(te, dtype))
    weights = sum(t.numel() * t.element_size() for t in program.state_dict().values())
    assert meta["weights_nbytes"] == weights
    # the four front-end constants: Hann window [2048], cos and sin bases
    # [2048, 768], the mel filterbank [768, 128], float32
    assert meta["constants_nbytes"] == 4 * (2048 + 2 * 2048 * 768 + 768 * 128)
    bound = meta["weights_nbytes"] + meta["constants_nbytes"]
    print(f"artifact {len(data)} bytes, weights {meta['weights_nbytes']}, constants "
          f"{meta['constants_nbytes']}, {len(data) / bound:.4f} of their sum")
    assert len(data) <= 1.05 * bound


def _post(url, data=b""):
    req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_serve_answers_from_an_artifact(artifact, clip):
    """serve() over a from_artifact pipeline: /analyze gives the
    pipeline's JSON, calibration applied; per_head=1 answers 400 naming
    the artifact, as the reference's server does; a live /stream session
    finalizes to /analyze's result."""
    pipe = InferencePipeline.from_artifact(artifact, device="cpu")
    srv = serve(pipe, port=0, warmup=True)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        data = open(clip, "rb").read()
        got = _post(f"{url}/analyze?filename=clip.wav", data)
        want = pipe.analyze_file(clip)
        assert got == {"filename": "clip.wav", **json.loads(json.dumps(want))}
        assert pipe._cal == CAL
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(f"{url}/analyze?per_head=1", data)
        assert exc.value.code == 400 and "artifact" in json.loads(exc.value.read())["error"]
        sid = _post(f"{url}/stream/start")["stream_id"]
        wav, _ = wavio.read_wav(clip)
        pcm = (np.clip(wav[0], -1, 1 - 2 ** -15) * 32768).astype("<i2")
        for i in range(0, len(pcm), 50_000):
            _post(f"{url}/stream/{sid}/feed", pcm[i:i + 50_000].tobytes())
        fin = _post(f"{url}/stream/{sid}/finalize")
        assert [s["label"] for s in fin["segments"]] == [s["label"] for s in got["segments"]]
        for k, v in got["percentages"].items():
            assert abs(fin["percentages"][k] - v) <= TOL_PCT
    finally:
        srv.shutdown()
        srv.server_close()
        srv.serving_state.close()
        thread.join(timeout=10)


def test_serve_cli_builds_the_artifact_pipeline(artifact, tmp_path, caplog):
    """--artifact: the compute flags are baked in (a warning), the host
    ones are honoured."""
    path = str(tmp_path / "m.sadpt")
    TX.write_artifact(path, artifact)
    args = serve_cli.build_parser().parse_args(
        ["--artifact", path, "--device", "cpu", "--bf16", "--overlap", "0.5", "--threshold",
         "0.7", "--no-calibration"])
    with caplog.at_level(logging.WARNING):
        pipe, source = serve_cli.build_pipeline(args)
    assert source == path and "baked into the artifact" in caplog.text
    assert pipe._program is not None and pipe.compute_dtype == torch.float32
    assert pipe.audio.overlap == 0.5 and pipe._threshold == 0.7 and pipe._cal is None


def test_export_cli(models, tmp_path, capsys):
    from synthetic_audio_detection_tpu_torch.checkpoints.serialization import save_merged_torch

    merged, out = str(tmp_path / "merged.pth"), str(tmp_path / "m.sadpt")
    save_merged_torch(merged, models[1])
    assert TX.main(["--merged-model", merged, "--output", out, "--input-size", "64",
                    "--batch-sizes", "2,8", "--device", "cpu"]) == 0
    assert "Wrote serving artifact" in capsys.readouterr().out
    _, meta = TX.load_artifact(out, device="cpu")
    assert meta["entries"] == [{"batch_size": 2}, {"batch_size": 8}]
    assert meta["calibration"] == CAL
    assert meta["compute_dtype"] == "float32" and meta["spec"]["out_size"] == 64
