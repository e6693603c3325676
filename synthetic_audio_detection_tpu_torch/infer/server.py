"""HTTP serving daemon: one warm pipeline behind a JSON API (the reference
package's ``infer/server.py``: the same routes, status codes and keys).

The one-shot CLI loads the checkpoint again for every clip. The daemon
keeps ONE ``InferencePipeline`` on the card behind a stdlib HTTP server (no
web-framework dependency). Host decode runs per request in the handler
thread; every device dispatch runs under one lock (``ServingState.lock``),
inside the pipeline's CUDA device. The lock also keeps a float32 forward's
``exact_float32()``, which sets two process-wide flags, from overlapping a
bf16 one. Concurrent verdict requests coalesce into shared device batches
(infer/batching.py, on by default), so bursts of short clips fill the
large bucket instead of dispatching one 8-window batch each.

API:
    GET  /healthz            → {"status": "ok", "classes": [...]}
    POST /analyze            → body: WAV bytes (Content-Type: audio/wav)
                               query: ?smooth=1&filename=clip.wav
                                      [&per_head=1 → adds "per_head": per-
                                      window [head][real, syn] sigmoids]
                               → the reference JSON schema
                                 {filename, segments[], percentages{}}
    POST /analyze_batch      → body: JSON {"files": {"name": <base64 wav>, ...}}
                               → {"results": {"name": {...}, ...}}; files fan
                               out through the micro-batcher so one request's
                               clips share device batches; a bad file yields
                               {"error": ...} for that name only
    POST /stream/start       → query: ?source_rate=44100 (default: pipeline
                               rate). Opens a live session (infer/streaming.py)
                               → {"stream_id": ...}
    POST /stream/<id>/feed   → body: raw PCM chunk (mono little-endian;
                               ?dtype=int16 default, or float32)
                               → {"windows": [{start_sec, end_sec, label,
                               probs}...]}: the verdicts of every analysis
                               window this chunk completed (live view;
                               smoothing is whole-stream, so finalize only)
    POST /stream/<id>/finalize → flush + whole-stream reference JSON
                               (?smooth=1); closes the session
    POST /stream/<id>/abort  → drop the session
                               Idle sessions evict after --stream-ttl (300 s);
                               at most --max-streams (32) at once (429 beyond).

Start:  python -m synthetic_audio_detection_tpu_torch.cli.serve \\
            --merged-model merged.pth --port 8321 [--bf16]
"""

from __future__ import annotations

import base64
import contextlib
import json
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Iterator, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from synthetic_audio_detection_tpu_torch.audio import wavio
from synthetic_audio_detection_tpu_torch.audio.resample import resample_poly_np
from synthetic_audio_detection_tpu_torch.infer.batching import MicroBatcher
from synthetic_audio_detection_tpu_torch.infer.pipeline import InferencePipeline, slice_waveform
from synthetic_audio_detection_tpu_torch.infer.streaming import StreamingAnalyzer


class ServingState:
    """Warm pipeline + dispatch lock shared across handler threads.

    With ``micro_batch`` (the default), verdict forwards from concurrent
    requests coalesce into shared device batches (infer/batching.py). The
    per-head diagnostics path keeps the plain lock (it returns another
    view of the same pass)."""

    def __init__(self, pipeline: InferencePipeline, micro_batch: bool = True,
                 linger_ms: float = 0.0, stream_ttl: float = 300.0, max_streams: int = 32):
        self.pipeline = pipeline
        self.lock = threading.Lock()
        self.batcher: Optional[MicroBatcher] = None
        if micro_batch:
            self.batcher = MicroBatcher(self.locked_logits,
                                        max_windows=pipeline.infer.batch_size,
                                        linger_ms=linger_ms)
        # live streaming sessions: id → [analyzer, session lock, last touch]
        self.streams: Dict[str, list] = {}
        self.streams_lock = threading.Lock()
        self.stream_ttl = stream_ttl
        self.max_streams = max_streams

    @contextlib.contextmanager
    def dispatching(self) -> Iterator[None]:
        """The dispatch lock, and the pipeline's CUDA device as the calling
        thread's current device: a thread other than the main one starts on
        device 0, and the kernels launch on the current device."""
        device = self.pipeline.device
        with self.lock, (torch.cuda.device(device) if device.type == "cuda"
                         else contextlib.nullcontext()):
            yield

    def locked_logits(self, windows: np.ndarray) -> np.ndarray:
        with self.dispatching():
            return self.pipeline.logits_for_windows(windows)

    def close(self) -> None:
        """Stop the micro-batcher's dispatcher thread (idempotent)."""
        if self.batcher is not None:
            self.batcher.stop()

    # ------------------------------------------------------------------
    # live streaming sessions (infer/streaming.py behind the same warm
    # pipeline; device work rides the micro-batcher when enabled, so
    # concurrent streams share batches)
    def stream_start(self, source_rate: Optional[int]) -> str:
        with self.streams_lock:
            now = time.monotonic()
            for sid in [s for s, v in self.streams.items() if now - v[2] > self.stream_ttl]:
                del self.streams[sid]
            if len(self.streams) >= self.max_streams:
                raise OverflowError(f"too many concurrent streams (max {self.max_streams})")
            fwd = self.batcher.logits if self.batcher is not None else self.locked_logits
            sa = StreamingAnalyzer(self.pipeline, source_rate=source_rate, logits_fn=fwd)
            sid = uuid.uuid4().hex[:16]
            self.streams[sid] = [sa, threading.Lock(), now]
            return sid

    def _stream(self, sid: str) -> list:
        with self.streams_lock:
            entry = self.streams.get(sid)
            if entry is None:
                raise KeyError(f"unknown stream {sid}")
            entry[2] = time.monotonic()
            return entry

    def stream_feed(self, sid: str, chunk: np.ndarray) -> list:
        sa, slock, _ = self._stream(sid)
        with slock:  # feeds to one session are ordered
            verdicts = sa.feed(chunk)
        return [{"start_sec": v["start_sec"], "end_sec": v["end_sec"], "label": v["label"],
                 "probs": [round(float(p), 6) for p in v["probs"]]} for v in verdicts]

    def stream_finalize(self, sid: str, smooth: bool) -> Dict[str, Any]:
        sa, slock, _ = self._stream(sid)
        with slock:
            result = sa.finalize(smooth=smooth)
        with self.streams_lock:
            self.streams.pop(sid, None)
        return result

    def stream_abort(self, sid: str) -> None:
        with self.streams_lock:
            if self.streams.pop(sid, None) is None:
                raise KeyError(f"unknown stream {sid}")

    def analyze_wav_bytes(self, data: bytes, smooth: bool,
                          per_head: bool = False) -> Dict[str, Any]:
        wf, sr = wavio.read_wav_bytes(data)
        mono = wf.mean(axis=0)
        audio_cfg = self.pipeline.audio
        if sr != audio_cfg.sample_rate:
            mono = resample_poly_np(mono, sr, audio_cfg.sample_rate)
        if mono.shape[0] < audio_cfg.window_samples:
            mono = np.pad(mono, (0, audio_cfg.window_samples - mono.shape[0]))
        windows, stamps = slice_waveform(mono.astype(np.float32), audio_cfg)
        if per_head and windows.shape[0]:
            with self.dispatching():
                # ONE pass yields the serving logits AND the pre-aggregation
                # view, bucketed like serving
                logits, nh = self.pipeline.logits_and_per_head(windows)
            result = self.pipeline.analyze_windows(windows, stamps, smooth=smooth, logits=logits)
            probs = 1.0 / (1.0 + np.exp(-nh))
            # under a NEW key, so the reference schema stays intact
            result["per_head"] = [[[round(float(p), 4) for p in head] for head in window]
                                  for window in probs]
            return result
        if self.batcher is not None and windows.shape[0]:
            # the verdict path shares the device batch with concurrent
            # requests; the lock rides inside the batcher's forward
            logits = self.batcher.logits(windows)
        elif windows.shape[0]:
            logits = self.locked_logits(windows)
        else:
            logits = None  # all silent: analyze_windows answers without the device
        result = self.pipeline.analyze_windows(windows, stamps, smooth=smooth, logits=logits)
        if per_head:  # all-silent clip: keep the key present
            result["per_head"] = []
        return result

    def warmup(self) -> None:
        """Run both serving buckets (8 and the batch size) once, so that no
        request pays the first call's setup (cuDNN's algorithm choice, the
        kernels' build and the compute-dtype weight copies)."""
        T = self.pipeline.audio.window_samples
        for n in (1, self.pipeline.infer.batch_size):
            dummy = np.zeros((n, T), np.float32)
            dummy[:, 0] = 1.0
            self.locked_logits(dummy)


def make_handler(state: ServingState):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: Dict[str, Any]) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet default stderr chatter
            pass

        def do_GET(self):
            if urlparse(self.path).path == "/healthz":
                self._send(200, {"status": "ok", "classes": state.pipeline.ensemble.class_names})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            parsed = urlparse(self.path)
            length = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(length)
            q = parse_qs(parsed.query)
            try:
                if parsed.path == "/analyze":
                    smooth = q.get("smooth", ["0"])[0] in ("1", "true")
                    per_head = q.get("per_head", ["0"])[0] in ("1", "true")
                    name = q.get("filename", ["audio.wav"])[0]
                    result = state.analyze_wav_bytes(data, smooth, per_head)
                    self._send(200, {"filename": name, **result})
                elif parsed.path == "/analyze_batch":
                    self._send(200, {"results": self._analyze_batch(json.loads(data))})
                elif parsed.path.startswith("/stream/"):
                    self._stream(parsed.path.split("/")[2:], q, data)
                else:
                    self._send(404, {"error": "not found"})
            except KeyError as e:
                self._send(404, {"error": str(e)})
            except OverflowError as e:
                self._send(429, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 - per-request isolation
                self._send(400, {"error": str(e)})

        def _analyze_batch(self, req: Dict[str, Any]) -> Dict[str, Any]:
            files = req.get("files", {})
            smooth = bool(req.get("smooth"))

            def one(item):
                name, b64 = item
                try:
                    return name, state.analyze_wav_bytes(base64.b64decode(b64), smooth)
                except Exception as e:  # noqa: BLE001 - a bad file reports, the rest analyze
                    return name, {"error": str(e)}

            if state.batcher is not None and len(files) > 1:
                # fan the files out so that their windows coalesce into
                # shared device batches
                with ThreadPoolExecutor(max_workers=min(8, len(files))) as pool:
                    return dict(pool.map(one, files.items()))
            return dict(map(one, files.items()))

        def _stream(self, parts, q, data: bytes) -> None:
            if parts == ["start"]:
                rate = q.get("source_rate", [None])[0]
                self._send(200, {"stream_id": state.stream_start(int(rate) if rate else None)})
            elif len(parts) == 2 and parts[1] == "feed":
                dtype = q.get("dtype", ["int16"])[0]
                if dtype == "int16":
                    chunk = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
                elif dtype == "float32":
                    chunk = np.frombuffer(data, "<f4").astype(np.float32)
                else:
                    raise ValueError(f"unsupported dtype {dtype}")
                self._send(200, {"windows": state.stream_feed(parts[0], chunk)})
            elif len(parts) == 2 and parts[1] == "finalize":
                smooth = q.get("smooth", ["0"])[0] in ("1", "true")
                self._send(200, state.stream_finalize(parts[0], smooth))
            elif len(parts) == 2 and parts[1] == "abort":
                state.stream_abort(parts[0])
                self._send(200, {"status": "aborted"})
            else:
                self._send(404, {"error": "not found"})

    return Handler


def serve(pipeline: InferencePipeline, host: str = "127.0.0.1", port: int = 8321,
          warmup: bool = True, micro_batch: bool = True, linger_ms: float = 0.0,
          stream_ttl: float = 300.0, max_streams: int = 32) -> ThreadingHTTPServer:
    """Create (and return) the server; the caller runs serve_forever(), and
    at the end shutdown(), server_close() and ``serving_state.close()``."""
    state = ServingState(pipeline, micro_batch=micro_batch, linger_ms=linger_ms,
                         stream_ttl=stream_ttl, max_streams=max_streams)
    if warmup:
        state.warmup()
    srv = ThreadingHTTPServer((host, port), make_handler(state))
    srv.serving_state = state  # tests and observability (dispatch_count)
    return srv
