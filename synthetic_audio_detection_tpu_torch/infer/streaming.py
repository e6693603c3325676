"""Live streaming inference: feed audio chunks, get verdicts as windows
complete (the reference package's ``infer/streaming.py``).

The one-shot CLI analyzes a whole file at once. This module is the live
counterpart, for audio that ARRIVES over time (a capture device, a network
stream): each ``feed(chunk)`` resamples incrementally, completes as many
analysis windows as the new samples cover, runs ONE bucketed device batch
over them, and returns their verdicts at once; ``finalize()`` returns the
reference result dict for the whole stream, equal to
``InferencePipeline.analyze_windows`` over the concatenated audio.

Window extraction, the silence gate, timestamp arithmetic, the decision
rule, smoothing, calibration and the percentages all reuse the pipeline's
implementations, so the streaming path cannot drift from the offline one.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from synthetic_audio_detection_tpu_torch.audio.resample import sinc_kernels
from synthetic_audio_detection_tpu_torch.ensemble.multihead import labels_from_indices
from synthetic_audio_detection_tpu_torch.utils.calibration import apply_calibration


class StreamingResampler:
    """Incremental twin of ``audio/resample.resample_poly_np`` (the same
    windowed-sinc polyphase bank, torchaudio semantics).

    Output block ``k`` (``new_g`` samples) reads padded input
    ``xp[k*orig_g : k*orig_g + L]``, where ``xp`` is the stream with
    ``width`` virtual zeros in front; so a block is final as soon as the raw
    stream covers its tap span, and streamed output equals the offline
    resample of the concatenated input (same frames, same GEMM; to float
    tolerance, since the BLAS kernel choice varies with the row count)."""

    def __init__(self, orig_sr: int, new_sr: int):
        if orig_sr == new_sr:
            raise ValueError("no resampling needed for equal rates")
        kernels, width, orig_g, new_g = sinc_kernels(orig_sr, new_sr)
        self._k = np.ascontiguousarray(kernels.T, np.float32)  # [L, new_g]
        self._L = self._k.shape[0]
        self._orig_g = orig_g
        self._new_g = new_g
        # the buffer holds xp from absolute padded index _buf_start
        self._buf = np.zeros(width, np.float32)  # the virtual left pad
        self._buf_start = 0
        self._next_block = 0
        self._total_in = 0
        self._width = width
        self._emitted = 0
        self._done = False

    def _emit_ready(self, final: bool) -> np.ndarray:
        avail = self._buf_start + len(self._buf)
        out_blocks = []
        while self._next_block * self._orig_g + self._L <= avail:
            lo = self._next_block * self._orig_g - self._buf_start
            n_pos = (len(self._buf) - lo - self._L) // self._orig_g + 1
            frames = np.lib.stride_tricks.as_strided(
                self._buf[lo:], shape=(n_pos, self._L),
                strides=(self._buf.strides[0] * self._orig_g, self._buf.strides[0]))
            out_blocks.append((np.ascontiguousarray(frames) @ self._k).reshape(-1))
            self._next_block += n_pos
        # drop the consumed prefix (keep the tap context for the next block)
        keep_from = self._next_block * self._orig_g - self._buf_start
        if keep_from > 0:
            self._buf = self._buf[keep_from:].copy()
            self._buf_start += keep_from
        if not out_blocks:
            return np.zeros(0, np.float32)
        out = np.concatenate(out_blocks)
        target = int(math.ceil(self._new_g * self._total_in / self._orig_g))
        out = out[: max(target - self._emitted, 0) if final else len(out)]
        self._emitted += len(out)
        return out

    def feed(self, chunk: np.ndarray) -> np.ndarray:
        """Append raw samples; return every output sample now final."""
        if self._done:
            raise RuntimeError("finalize() already called")
        chunk = np.asarray(chunk, np.float32).reshape(-1)
        self._buf = np.concatenate([self._buf, chunk])
        self._total_in += len(chunk)
        return self._emit_ready(final=False)

    def finalize(self) -> np.ndarray:
        """Flush: pad right as the offline path does, emit the tail up to
        ``ceil(new_g * T / orig_g)`` output samples in all."""
        if self._done:
            return np.zeros(0, np.float32)
        self._done = True
        self._buf = np.concatenate([self._buf, np.zeros(self._width + self._orig_g, np.float32)])
        return self._emit_ready(final=True)


class StreamingAnalyzer:
    """Chunk-fed analyzer over an ``InferencePipeline``.

    feed(chunk) → [{"start_sec", "end_sec", "label", "probs"}, ...]: the
    verdicts of every window COMPLETED by this chunk (unsmoothed: smoothing
    is a whole-stream operation, applied at finalize, as offline). One
    bucketed device batch per feed call that completes windows.

    finalize() → the reference result dict {segments, percentages}, equal
    to analyzing the concatenated stream offline (the short-stream zero pad
    of ``preprocess_waveform`` included).
    """

    def __init__(self, pipeline: Any, source_rate: Optional[int] = None,
                 logits_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None):
        """``logits_fn`` overrides the forward (windows → logits), e.g. the
        serving daemon's micro-batcher, so that concurrent streams share
        device batches; defaults to ``pipeline.logits_for_windows``."""
        self._p = pipeline
        self._logits_fn = logits_fn or pipeline.logits_for_windows
        audio = pipeline.audio
        self._sr = audio.sample_rate
        self._win = audio.window_samples
        self._hop = audio.hop_samples
        self._rs = (StreamingResampler(source_rate, self._sr)
                    if source_rate is not None and source_rate != self._sr else None)
        self._buf = np.zeros(0, np.float32)  # resampled, from _buf_start
        self._buf_start = 0  # absolute resampled-sample index of _buf[0]
        self._next_win = 0  # next window index (absolute: start = i * hop)
        self._total = 0  # resampled samples seen
        self._stamps: List[Tuple[float, float]] = []
        self._logits: List[np.ndarray] = []
        self._done = False

    def _consume(self) -> List[Dict[str, Any]]:
        """Extract every complete window from the buffer, run one bucketed
        batch, record logits and stamps, and return the verdicts."""
        audio = self._p.audio
        chunks, stamps = [], []
        while self._next_win * self._hop + self._win <= self._buf_start + len(self._buf):
            s = self._next_win * self._hop
            seg = self._buf[s - self._buf_start : s - self._buf_start + self._win]
            self._next_win += 1
            if np.abs(seg).max() < audio.silence_threshold:
                continue
            chunks.append(seg)
            # the reference's stamp arithmetic (pipeline.slice_waveform)
            start = s / self._sr
            stamps.append((start, start + audio.window_seconds))
        keep_from = self._next_win * self._hop - self._buf_start
        if keep_from > 0:
            self._buf = self._buf[keep_from:].copy()
            self._buf_start += keep_from
        if not chunks:
            return []
        logits = np.asarray(self._logits_fn(np.stack(chunks).astype(np.float32)), np.float32)
        # RAW logits are kept: finalize hands them to analyze_windows, which
        # applies the pipeline's calibration itself; the live verdicts below
        # calibrate their own copy, so both views agree
        self._logits.append(logits)
        self._stamps.extend(stamps)
        if self._p._cal is not None:
            logits = apply_calibration(logits, self._p._cal)
        # the pipeline's host float32 sigmoid, generic-column split and
        # decision rule, as analyze_windows applies them
        probs = (1.0 / (1.0 + np.exp(-logits))).astype(np.float32)
        probs, generic = self._p._split_generic(probs)
        syn, real = probs[:, :-1], probs[:, -1]
        is_real = self._p._decide_rows(syn, real, generic)
        idx = np.where(is_real, probs.shape[1] - 1, syn.argmax(axis=1))
        labels = labels_from_indices(idx, self._p.ensemble.synthetic_names,
                                     self._p.ensemble.real_name)
        return [{"start_sec": float(s), "end_sec": float(e), "label": lab, "probs": probs[j]}
                for j, ((s, e), lab) in enumerate(zip(stamps, labels))]

    def feed(self, chunk: np.ndarray) -> List[Dict[str, Any]]:
        if self._done:
            raise RuntimeError("finalize() already called")
        chunk = np.asarray(chunk, np.float32).reshape(-1)
        if self._rs is not None:
            chunk = self._rs.feed(chunk)
        self._buf = np.concatenate([self._buf, chunk])
        self._total += len(chunk)
        return self._consume()

    def finalize(self, smooth: Optional[bool] = None) -> Dict[str, Any]:
        """Flush and assemble the whole-stream reference result."""
        if self._done:
            raise RuntimeError("finalize() already called")
        self._done = True
        if self._rs is not None:
            flushed = self._rs.finalize()
            self._buf = np.concatenate([self._buf, flushed])
            self._total += len(flushed)
        # a stream shorter than one window is zero-padded to one window
        # (preprocess_waveform)
        if self._total < self._win:
            self._buf = np.concatenate([self._buf, np.zeros(self._win - self._total, np.float32)])
        self._consume()
        if not self._logits:
            return {"segments": [], "percentages": {}}
        logits = np.concatenate(self._logits)
        # the windows argument only carries the row count beside the
        # precomputed logits; calibration and smoothing happen inside
        return self._p.analyze_windows(np.empty((len(logits), 0), np.float32), self._stamps,
                                       smooth=smooth, logits=logits)

    @property
    def windows_completed(self) -> int:
        return len(self._stamps)
