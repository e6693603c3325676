"""Legacy 5-class audio analyzer (the reference package's
``infer/legacy_analyzer.py``: the richer inference path of the reference's
legacy script).

Feature set:
- audio normalization: mean-subtract → peak-normalize → RMS 0.2 rescale;
  clips shorter than one window are zero-padded to 5 s
- 85% window overlap, silence gate 1e-4
- per-window softmax → per-class sensitivity rescale → renormalize
- smoothing: Gaussian σ=2 per class → row renorm → argmax → median filter
  k=5 → low-confidence windows fall back to the majority class
- run-length merge of equal-label windows, kept when their mean confidence
  is ≥ 0.45; segments carry a confidence field
- batch-folder mode

The forward is the reference's: the float32 GEMM log-mel with the Slaney
mel norm, channel replication, the 5-output ``BinaryClassifier`` in
float32 (plain cuDNN under ``exact_float32()``: no hand-written kernel, as
the reference runs no Pallas kernel here) and a float32 softmax. bf16
changes only the features' dtype, as in the reference, whose float32
model then computes on the bf16-rounded features. The smoothing, median,
fallback and segments run on the host in numpy. The analyzer runs on the
GPU unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from synthetic_audio_detection_tpu_torch.models.classifier import BinaryClassifier
from synthetic_audio_detection_tpu_torch.ops import melspec
from synthetic_audio_detection_tpu_torch.ops.filters import gaussian_filter1d, median_filter1d
from synthetic_audio_detection_tpu_torch.ops.precision import exact_float32
from synthetic_audio_detection_tpu_torch.utils.config import SpectrogramConfig

DEFAULT_CLASSES = ["Class1", "Class2", "Class3", "Class4", "Class5"]


@dataclasses.dataclass
class LegacyAudioConfig:
    """The legacy script's defaults."""

    target_sample_rate: int = 32_000
    window_size: float = 4.0
    overlap: float = 0.85
    silence_threshold: float = 1e-4
    normalize_audio: bool = True
    batch_size: int = 256

    @property
    def window_samples(self) -> int:
        return int(self.window_size * self.target_sample_rate)

    @property
    def hop_samples(self) -> int:
        return max(int((1.0 - self.overlap) * self.window_samples), 1)


def normalize_audio(waveform: np.ndarray, target_rms: float = 0.2) -> np.ndarray:
    """mean-subtract → peak normalize → RMS rescale."""
    wf = waveform - waveform.mean()
    peak = np.abs(wf).max()
    if peak > 0:
        wf = wf / peak
    rms = float(np.sqrt(np.mean(wf**2)))
    if rms > 0:
        wf = wf * (target_rms / rms)
    return wf


class LegacyAudioAnalyzer:
    """5-class analyzer over a single multi-class model (``model`` carries
    its weights; it is moved to ``device`` and put in eval mode)."""

    def __init__(
        self,
        model: BinaryClassifier,
        classes: Optional[Sequence[str]] = None,
        audio: Optional[LegacyAudioConfig] = None,
        sensitivity_factors: Optional[Dict[str, float]] = None,
        confidence_threshold: float = 0.45,
        compute_dtype: torch.dtype = torch.float32,
        device: Any = "cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device cuda requested but CUDA is not available")
        self.model = model.to(self.device).eval()
        self.classes = list(classes or DEFAULT_CLASSES)
        self.audio = audio or LegacyAudioConfig()
        # the reference keys its factors by lowercased class name
        self.sensitivity_factors = sensitivity_factors or {c.lower(): 1.0 for c in self.classes}
        self.confidence_threshold = confidence_threshold
        # the legacy spectrogram: norm='slaney', power 2, top_db 80; read at
        # each forward, so a caller may replace it
        self.spec_cfg = SpectrogramConfig(mel_norm="slaney")
        self.compute_dtype = compute_dtype

    @torch.no_grad()
    def _forward(self, windows: torch.Tensor) -> torch.Tensor:
        """[B, T] → [B, C] float32 softmax probabilities."""
        with exact_float32():
            feats = melspec.log_mel_features(windows, self.spec_cfg, self.audio.target_sample_rate,
                                             use_gemm_dft=True, out_dtype=self.compute_dtype)
            x = melspec.replicate_channels(feats, 3).float()
            return torch.softmax(self.model(x).float(), dim=-1)

    # -- preprocessing -------------------------------------------------------

    def preprocess(self, path: str) -> np.ndarray:
        from synthetic_audio_detection_tpu_torch.audio.decode import load_audio
        from synthetic_audio_detection_tpu_torch.audio.resample import resample_poly_np

        wf, sr = load_audio(path)
        mono = wf.mean(axis=0)
        if sr != self.audio.target_sample_rate:
            mono = resample_poly_np(mono, sr, self.audio.target_sample_rate)
        seconds = mono.shape[0] / self.audio.target_sample_rate
        if seconds < self.audio.window_size:
            # the reference pads short clips to 5 s
            out = np.zeros(int(5.0 * self.audio.target_sample_rate), np.float32)
            out[: mono.shape[0]] = mono
            mono = out
        if self.audio.normalize_audio:
            mono = normalize_audio(mono)
        return mono.astype(np.float32)

    def windows(self, waveform: np.ndarray) -> Tuple[np.ndarray, List[float]]:
        win, hop = self.audio.window_samples, self.audio.hop_samples
        chunks, stamps = [], []
        for s in range(0, max(len(waveform) - win + 1, 1), hop):
            seg = waveform[s : s + win]
            if seg.shape[0] < win:
                break
            if np.abs(seg).max() < self.audio.silence_threshold:
                continue
            chunks.append(seg)
            stamps.append(s / self.audio.target_sample_rate)
        if not chunks:
            return np.zeros((0, win), np.float32), []
        return np.stack(chunks), stamps

    # -- inference -----------------------------------------------------------

    def probabilities(self, windows: np.ndarray) -> np.ndarray:
        """Batched softmax probabilities [N, C] with sensitivity rescaling
        (float64, as the reference's)."""
        out = []
        bs = self.audio.batch_size
        for i in range(0, windows.shape[0], bs):
            batch = windows[i : i + bs]
            # the reference's padding: at least min(bs, 8) rows, else a
            # multiple of 8
            pad = 0
            if batch.shape[0] < min(bs, 8):
                pad = min(bs, 8) - batch.shape[0]
            elif batch.shape[0] % 8:
                pad = 8 - batch.shape[0] % 8
            if pad:
                batch = np.concatenate([batch, np.zeros((pad, batch.shape[1]), batch.dtype)])
            x = torch.from_numpy(np.ascontiguousarray(batch, np.float32)).to(self.device)
            probs = self._forward(x).cpu().numpy()
            out.append(probs[: probs.shape[0] - pad if pad else None])
        probs = np.concatenate(out, axis=0)
        factors = np.array([self.sensitivity_factors.get(c.lower(), 1.0) for c in self.classes],
                           np.float64)
        adjusted = probs * factors[None, :]
        return adjusted / adjusted.sum(axis=1, keepdims=True)

    def smooth_predictions(self, probs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """gaussian σ=2 → renorm → argmax → medfilt(5) → majority fallback.
        Returns (final_preds, smoothed_probs)."""
        if probs.shape[0] == 0:
            return np.zeros(0, np.int64), probs
        sm = gaussian_filter1d(torch.from_numpy(np.asarray(probs)), 2.0, axis=0).numpy()
        sm = sm / sm.sum(axis=1, keepdims=True)
        preds = np.argmax(sm, axis=1)
        final = median_filter1d(torch.from_numpy(preds.astype(np.float32)), 5).numpy()
        final = final.astype(np.int64)
        confident = sm.max(axis=1) >= self.confidence_threshold
        majority = np.argmax(np.bincount(final, minlength=len(self.classes)))
        final[~confident] = majority
        return final, sm

    def confident_segments(self, timestamps: Sequence[float], predictions: np.ndarray,
                           probabilities: np.ndarray) -> List[Dict[str, Any]]:
        """Run-length merge equal-label windows; keep those whose mean
        confidence is ≥ the threshold. Segments carry a confidence field."""
        segments: List[Dict[str, Any]] = []
        preds = list(predictions)
        idx = 0
        while idx < len(preds):
            current = preds[idx]
            start = idx
            while idx + 1 < len(preds) and preds[idx + 1] == current:
                idx += 1
            end = idx
            conf = float(np.mean([probabilities[i][current] for i in range(start, end + 1)]))
            if conf >= self.confidence_threshold:
                segments.append({
                    "start": float(timestamps[start]),
                    "end": float(timestamps[end] + self.audio.window_size),
                    "class": self.classes[current],
                    "confidence": conf,
                })
            idx += 1
        return segments

    def analyze_audio(self, path: str) -> Dict[str, Any]:
        windows, stamps = self.windows(self.preprocess(path))
        if windows.shape[0] == 0:
            return {"percentages": {c: 0.0 for c in self.classes}, "segments": []}
        preds, smoothed = self.smooth_predictions(self.probabilities(windows))
        segments = self.confident_segments(stamps, preds, smoothed)
        percentages = {c: round(float(smoothed[:, i].mean()) * 100.0, 2)
                       for i, c in enumerate(self.classes)}
        return {"percentages": percentages, "segments": segments}

    def analyze_batch(self, folder: str) -> Dict[str, Dict[str, Any]]:
        """Folder mode: every .wav in ``folder``, by name."""
        return {f: self.analyze_audio(os.path.join(folder, f))
                for f in sorted(os.listdir(folder)) if f.lower().endswith(".wav")}
