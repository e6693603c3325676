"""The port's serving daemon (``infer/server.py``, ``cli/serve.py``) on the
CPU at 64², through a real socket, against the JAX package's
``ServingState.analyze_wav_bytes`` called directly on the same bytes and
weights: labels equal, percentages within 1e-4 (the end-to-end bound of
tests/test_torch_pipeline.py; per-head sigmoids, which both round to 4
decimals, within 1.5e-4). Requests that coalesce run in another bucket
than alone, so they are held to the same bound against their sequential
results."""

import base64
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from synthetic_audio_detection_tpu.infer.server import ServingState as JaxServingState
from synthetic_audio_detection_tpu_torch.audio import wavio
from synthetic_audio_detection_tpu_torch.checkpoints.serialization import save_merged_torch
from synthetic_audio_detection_tpu_torch.cli import serve as serve_cli
from synthetic_audio_detection_tpu_torch.infer.server import serve
from synthetic_audio_detection_tpu_torch.utils.config import AudioConfig
from tests.test_torch_streaming import assert_same_result, both_pipelines

TOL_PER_HEAD = 1.5e-4  # 1e-4 and the two roundings to 4 decimals


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def daemon():
    """(url, the port's ServingState, the JAX package's ServingState)."""
    jax_pipe, port_pipe = both_pipelines(AudioConfig())
    srv = serve(port_pipe, host="127.0.0.1", port=0, warmup=True)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield (f"http://127.0.0.1:{srv.server_address[1]}", srv.serving_state,
               JaxServingState(jax_pipe, micro_batch=False))
    finally:
        srv.shutdown()
        srv.server_close()
        srv.serving_state.close()
        thread.join(timeout=10)


def wav_bytes(tmp_path, seconds=5.0, sr=32_000, channels=1, seed=0):
    x = (np.random.default_rng(seed).standard_normal((channels, int(seconds * sr))) * 0.3)
    path = tmp_path / f"clip_{seed}_{sr}.wav"
    wavio.write_wav(str(path), np.clip(x, -1, 1).astype(np.float32), sr)
    return path.read_bytes()


def post(url, data=b"", timeout=120):
    req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def http_error(url, data=b""):
    with pytest.raises(urllib.error.HTTPError) as exc:
        post(url, data)
    return exc.value.code


def test_healthz(daemon):
    url, _, _ = daemon
    with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
        assert json.loads(r.read()) == {"status": "ok", "classes": ["SynA", "SynB", "Real"]}
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(f"{url}/nope", timeout=30)
    assert exc.value.code == 404


@pytest.mark.parametrize("seconds,sr,channels,smooth", [(5.0, 32_000, 1, False),
                                                        (13.0, 44_100, 2, False),
                                                        (21.0, 16_000, 1, True),
                                                        (2.5, 32_000, 1, False)])
def test_analyze_matches_jax_serving_state(daemon, tmp_path, seconds, sr, channels, smooth):
    url, _, jax_state = daemon
    data = wav_bytes(tmp_path, seconds, sr, channels, seed=int(seconds))
    got = post(f"{url}/analyze?filename=x.wav&smooth={int(smooth)}", data)
    want = jax_state.analyze_wav_bytes(data, smooth)
    assert got["filename"] == "x.wav"
    assert set(got) == {"filename", "segments", "percentages"}
    assert len(got["segments"]) == max(int(seconds // 4), 1)
    assert_same_result(got, want)


def test_analyze_batch_isolates_errors(daemon, tmp_path):
    url, _, jax_state = daemon
    good = {f"{i}.wav": wav_bytes(tmp_path, 4.5, seed=10 + i) for i in range(2)}
    files = {n: base64.b64encode(b).decode() for n, b in good.items()}
    files["broken.wav"] = base64.b64encode(b"not a wav").decode()
    body = post(f"{url}/analyze_batch", json.dumps({"files": files}).encode())
    assert set(body["results"]) == set(files)
    assert "error" in body["results"]["broken.wav"]
    for name, data in good.items():
        assert_same_result(body["results"][name], jax_state.analyze_wav_bytes(data, False))
    # a malformed WAV is a 400, and the server keeps serving
    assert http_error(f"{url}/analyze", b"garbage") == 400
    with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
        assert json.loads(r.read())["status"] == "ok"


def test_analyze_per_head(daemon, tmp_path):
    url, _, jax_state = daemon
    data = wav_bytes(tmp_path, 9.0, seed=3)
    got = post(f"{url}/analyze?per_head=1", data)
    want = jax_state.analyze_wav_bytes(data, False, per_head=True)
    assert set(got) == {"filename", "segments", "percentages", "per_head"}
    assert np.asarray(got["per_head"]).shape == (2, 2, 2)  # windows, heads, [real, syn]
    np.testing.assert_allclose(got["per_head"], want["per_head"], rtol=0, atol=TOL_PER_HEAD)
    assert_same_result(got, want)
    assert "per_head" not in post(f"{url}/analyze", data)
    # an all-silent clip keeps the key
    silent = post(f"{url}/analyze?per_head=1", wav_bytes(tmp_path, 5.0, seed=4)[:44]
                  + bytes(2 * 5 * 32_000))
    assert silent["per_head"] == [] and silent["segments"] == []


def test_concurrent_requests_coalesce_and_match_sequential(daemon, tmp_path):
    """Six one-window clips posted while the device lock is held queue
    behind the first: fewer dispatches than requests, and each result
    equal to the same clip posted alone."""
    url, state, _ = daemon
    clips = {f"c{i}.wav": wav_bytes(tmp_path, 4.5, seed=20 + i) for i in range(6)}
    sequential = {n: post(f"{url}/analyze?filename={n}", d) for n, d in clips.items()}
    concurrent, errors = {}, []

    def run(name, data):
        try:
            concurrent[name] = post(f"{url}/analyze?filename={name}", data)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append((name, e))

    threads = [threading.Thread(target=run, args=item) for item in clips.items()]
    before = state.batcher.dispatch_count
    with state.lock:
        for t in threads:
            t.start()
        time.sleep(1.0)  # every request decoded and queued behind the lock
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors, errors
    dispatches = state.batcher.dispatch_count - before
    assert 1 <= dispatches < len(clips)
    for name, seq in sequential.items():
        assert concurrent[name]["filename"] == name
        assert_same_result(concurrent[name], seq)


def test_stream_lifecycle_matches_analyze(daemon, tmp_path):
    """start → int16 chunked feeds → finalize equals /analyze of the same
    audio; the session is gone afterwards."""
    url, _, _ = daemon
    data = wav_bytes(tmp_path, 9.0, seed=6)
    want = post(f"{url}/analyze", data)
    sid = post(f"{url}/stream/start")["stream_id"]
    pcm = wavio.pcm16_quantize(wavio.read_wav_bytes(data)[0].mean(axis=0))
    rng = np.random.default_rng(6)
    live, pos = [], 0
    while pos < len(pcm):
        n = int(rng.integers(10_000, 120_000))
        live += post(f"{url}/stream/{sid}/feed", pcm[pos : pos + n].tobytes())["windows"]
        pos += n
    got = post(f"{url}/stream/{sid}/finalize")
    assert_same_result(got, want)
    assert [v["label"] for v in live] == [s["label"] for s in want["segments"]]
    assert http_error(f"{url}/stream/{sid}/feed", b"\x00\x00") == 404


def test_stream_source_rate_and_abort(daemon, tmp_path):
    url, _, _ = daemon
    sid = post(f"{url}/stream/start?source_rate=16000")["stream_id"]
    chunk = (np.random.default_rng(7).standard_normal(16_000) * 0.3).astype(np.float32)
    assert post(f"{url}/stream/{sid}/feed?dtype=float32", chunk.tobytes())["windows"] == []
    assert post(f"{url}/stream/{sid}/abort") == {"status": "aborted"}
    assert http_error(f"{url}/stream/{sid}/finalize") == 404
    assert http_error(f"{url}/stream/{sid}/abort") == 404
    # a 44.1-kHz stream's finalize equals /analyze of the same audio
    data = wav_bytes(tmp_path, 8.5, sr=44_100, seed=8)
    x = wavio.read_wav_bytes(data)[0].mean(axis=0).astype(np.float32)
    sid = post(f"{url}/stream/start?source_rate=44100")["stream_id"]
    for i in range(0, len(x), 44_100):
        post(f"{url}/stream/{sid}/feed?dtype=float32", x[i : i + 44_100].tobytes())
    assert_same_result(post(f"{url}/stream/{sid}/finalize"), post(f"{url}/analyze", data))


def test_stream_errors(daemon):
    url, state, _ = daemon
    sid = post(f"{url}/stream/start")["stream_id"]
    assert http_error(f"{url}/stream/{sid}/feed?dtype=int8", b"\x00") == 400
    assert http_error(f"{url}/stream/nope/finalize") == 404
    assert http_error(f"{url}/stream/{sid}/rewind") == 404
    sids = [sid] + [post(f"{url}/stream/start")["stream_id"]
                    for _ in range(state.max_streams - len(state.streams))]
    assert len(state.streams) == state.max_streams
    assert http_error(f"{url}/stream/start") == 429
    for s in sids:
        post(f"{url}/stream/{s}/abort")
    assert post(f"{url}/stream/start")["stream_id"]


def test_serve_cli_refuses_artifact(tmp_path):
    """--artifact serves the port's own artifacts (tests/test_torch_export.py)
    and refuses the JAX package's StableHLO ``.sadx``, saying why."""
    path = tmp_path / "model.sadx"
    path.write_bytes(b"SADX1\n" + b"\0" * 64)
    with pytest.raises(ValueError, match="JAX package"):
        serve_cli.main(["--artifact", str(path), "--device", "cpu", "--port", "0"])


def test_serve_cli_defaults_to_cuda(tmp_path):
    """--device defaults to cuda: without a GPU the CLI raises instead of
    serving on the CPU."""
    assert serve_cli.build_parser().parse_args(["--merged-model", "m.pth"]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, port_pipe = both_pipelines(AudioConfig())
    path = str(tmp_path / "merged.pth")
    save_merged_torch(path, port_pipe.ensemble)
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve_cli.main(["--merged-model", path, "--port", "0"])
    finally:
        os.remove(path)
