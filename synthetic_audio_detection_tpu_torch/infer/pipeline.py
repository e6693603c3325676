"""End-to-end inference: waveform → windows → log-mel + ensemble → verdicts
→ JSON (the reference package's ``infer/pipeline.py``).

Host side (numpy): decode, mono mean, resample to 32 kHz, pad to one
window, 4-s windows with the silence gate, and after the device pass the
float32 sigmoid, decision rule, optional smoothing and the reference JSON.
Device side (one call per bucket): int16 dequantisation, the log-mel front
end, the resize or native pad, channel replication or the mono stem, and
the ensemble. Windows go through two static bucket sizes (8, and the batch
size), as in the reference package.

Front-end gate, as the reference package sets it: on CUDA with a reduced
compute dtype the front end is the factored log-mel kernel
(ops/cuda_melspec.py, bf16 DFT); otherwise the float32 GEMM front end. The
gate reads the device and dtype only. A float32 forward runs inside
``exact_float32()`` (ops/precision.py): TF32 off for its convolutions and
matmuls, so float32 is float32, and the process's flags as they were
outside it.

The same gate, with a shared backbone, engages the fast backbone
(models/fast_resnet.py, the reference's ``_conv_bn`` numerics for every
conv); ``conv3x3_max_channels`` (default 512: every 3x3 conv and 1x1
downsample of ResNet-18/34) routes its convs with at most that many input
channels through the hand-written conv kernel (ops/cuda_conv.py), and 0
through the kernel's plain composition, with the same numerics. Elsewhere
the knob has no effect.

``use_s2d_layer1`` True runs the plain backbones with stage 1 in
space-to-depth form (the model-level flag, ``models/resnet.py``) and turns
the fast backbone off, as the reference's flag does; the front-end gate
stays. Its auto (None) follows the reference's rule, which engages on a
TPU only: off.

The pipeline runs on the GPU unless the caller asks for ``device="cpu"``.

Data-parallel serving (``mesh``, a ``parallel.sharding.Mesh``, as the
reference's pure data-parallel ``shard_map`` path): each bucket is rounded
up to a multiple of the ``data`` size, each rank copies and forwards only
its rows on its own device (the ranks along ``model`` the same rows), and
one ``all_gather_into_tensor`` over ``data`` per batch returns the whole
batch's logits (and per-head logits, in the same gather) to every rank.
The forward itself makes no collective.

``InferencePipeline.from_artifact`` serves an exported artifact
(infer/export.py) with the same host side: its device pass is the exported
program (the float32 GEMM mel and the plain backbone, no hand-written
kernel), at the artifact's batch entries only.

Spans (``utils/profiling.span``, ranges in a profiler's trace, nothing
without one): ``serve.request`` around ``analyze_windows``; in it, per
device batch, ``serve.pad`` (slice, int16 quantize, the tail's zero
block, the contiguous copy), then the host-to-device copy (no range of its
own), ``serve.forward`` (``_forward``) with ``serve.frontend`` and
``serve.backbone`` inside ``forward_windows``, ``serve.d2h`` (the logits'
read-back, which waits for the device); then ``serve.decide``
(calibration, sigmoid, decision, smoothing, the result). A generator's
span opens and closes between two of its yields.
Counters (``utils/profiling.count``): ``serve.batches``, ``serve.rows``
(bucket rows, padding included) and ``serve.useful_rows``, per device
batch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from synthetic_audio_detection_tpu_torch.audio import wavio
from synthetic_audio_detection_tpu_torch.utils.config import (
    AudioConfig,
    InferenceConfig,
    SpectrogramConfig,
)
from synthetic_audio_detection_tpu_torch.ensemble.multihead import (
    MultiHeadEnsemble,
    _aggregate,
    ensemble_per_head_logits,
    fold_to_mono,
    labels_from_indices,
    with_dtype,
)
from synthetic_audio_detection_tpu_torch.ops import melspec
from synthetic_audio_detection_tpu_torch.ops.cuda_melspec import dequantize, serving_log_mel
from synthetic_audio_detection_tpu_torch.ops.filters import gaussian_filter1d
from synthetic_audio_detection_tpu_torch.ops.precision import exact_float32
from synthetic_audio_detection_tpu_torch.parallel.sharding import pad_batch_to_multiple, shard_batch
from synthetic_audio_detection_tpu_torch.utils.profiling import count, span


# ---------------------------------------------------------------------------
# Host side
# ---------------------------------------------------------------------------

def preprocess_waveform(path: str, audio: AudioConfig) -> np.ndarray:
    """Load → mono mean → resample to the target rate → pad to ≥ 1 window.
    Returns float32 [T]."""
    from synthetic_audio_detection_tpu_torch.audio.decode import load_audio
    from synthetic_audio_detection_tpu_torch.audio.resample import resample_poly_np

    wf, sr = load_audio(path)
    mono = wf.mean(axis=0)
    if sr != audio.sample_rate:
        mono = resample_poly_np(mono, sr, audio.sample_rate)
    if mono.shape[0] < audio.window_samples:
        mono = np.pad(mono, (0, audio.window_samples - mono.shape[0]))
    return mono.astype(np.float32)


def slice_waveform(waveform: np.ndarray, audio: AudioConfig
                   ) -> Tuple[np.ndarray, List[Tuple[float, float]]]:
    """[T] → (windows [num, window_samples], [(start_sec, end_sec), ...]),
    skipping windows with max|x| below the silence threshold."""
    win, hop = audio.window_samples, audio.hop_samples
    T = waveform.shape[0]
    n = max(1, 1 + (T - win) // hop) if T >= win else 0
    chunks, stamps = [], []
    for i in range(n):
        s = i * hop
        seg = waveform[s : s + win]
        if seg.shape[0] < win:
            break
        if np.abs(seg).max() < audio.silence_threshold:
            continue
        chunks.append(seg)
        # the reference's arithmetic: end = start + window_seconds, not
        # (s + win) / sr, whose last ulp can differ and change the JSON text
        start = s / audio.sample_rate
        stamps.append((start, start + audio.window_seconds))
    if not chunks:
        return np.zeros((0, win), np.float32), []
    return np.stack(chunks).astype(np.float32), stamps


# ---------------------------------------------------------------------------
# Device side
# ---------------------------------------------------------------------------

@torch.no_grad()
def forward_windows(
    ensemble: MultiHeadEnsemble,
    windows: torch.Tensor,
    spec_cfg: SpectrogramConfig,
    sample_rate: int,
    use_kernel: bool = False,
    use_fast_backbone: bool = False,
    return_per_head: bool = False,
    conv3x3_max_channels: int = 512,
    use_s2d_layer1: bool = False,
):
    """[B, T] windows (float32, or int16 PCM) → [B, N+1] logits, and with
    ``return_per_head`` also the per-head logits [N, B, 2] of the same
    pass. ``use_s2d_layer1`` runs the plain backbones with stage 1 in
    space-to-depth form, in place of the fast backbone."""
    with span("serve.frontend"):
        windows = dequantize(windows)
        dtype = ensemble.dtype
        if use_kernel:
            z = serving_log_mel(windows, spec_cfg, sample_rate)  # [B, mels, frames]
            feats = melspec.finalize_features(z, spec_cfg).to(dtype)
        else:
            feats = melspec.log_mel_features(windows, spec_cfg, sample_rate,
                                             use_gemm_dft=True, out_dtype=dtype)
        if ensemble.in_channels == 1:
            x = feats[:, None]
        else:
            x = melspec.replicate_channels(feats, spec_cfg.out_channels)
    with span("serve.backbone"):
        logits_nh = ensemble_per_head_logits(
            ensemble, x, fast_backbone=use_fast_backbone and not use_s2d_layer1,
            conv3x3_max_channels=conv3x3_max_channels, s2d_stage1=use_s2d_layer1)
        agg = _aggregate(logits_nh)
    return (agg, logits_nh) if return_per_head else agg


class InferencePipeline:
    """Windows → logits on one device, in two bucket sizes."""

    def __init__(
        self,
        ensemble: MultiHeadEnsemble,
        audio: Optional[AudioConfig] = None,
        spec: Optional[SpectrogramConfig] = None,
        infer: Optional[InferenceConfig] = None,
        compute_dtype: torch.dtype = torch.float32,
        device: Any = "cuda",
        transport_dtype: str = "float32",
        conv3x3_max_channels: int = 512,
        mesh=None,
        use_s2d_layer1: Optional[bool] = None,
    ):
        self.mesh = mesh
        self.device = torch.device(device) if mesh is None else mesh.device
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("device cuda requested but CUDA is not available")
        reduced = compute_dtype != torch.float32
        on_gpu = self.device.type == "cuda"
        self.spec = spec or SpectrogramConfig.inference()
        # the reference package's mono-stem gate: native resolution,
        # accelerator, reduced dtype (an exact transform either way)
        if self.spec.is_native and on_gpu and reduced and ensemble.in_channels == 3:
            ensemble = fold_to_mono(ensemble)
        if ensemble.dtype != compute_dtype:
            ensemble = with_dtype(ensemble, compute_dtype)
        self.ensemble = ensemble.to(self.device)
        self.audio = audio or AudioConfig()
        self.infer = infer or InferenceConfig()
        self._resolve_calibration()
        self.compute_dtype = compute_dtype
        # the bf16-DFT kernel serves only reduced-precision pipelines: a
        # float32 pipeline stays on the float32 front end end to end
        self.use_kernel = on_gpu and reduced
        if transport_dtype not in ("float32", "int16"):
            raise ValueError(f"unsupported transport_dtype {transport_dtype!r}")
        self.transport_dtype = transport_dtype
        # the reference's auto rule needs a TPU backend (and a reduced
        # dtype, a basic-block backbone, batches of at most 32)
        self.use_s2d_layer1 = bool(use_s2d_layer1)
        self.use_fast_backbone = (on_gpu and reduced and self.ensemble.shared_backbone
                                  and not self.use_s2d_layer1)
        self.conv3x3_max_channels = conv3x3_max_channels if self.use_fast_backbone else 0
        self._bucket_sizes: Optional[List[int]] = None
        self._program = None

    @classmethod
    def from_artifact(cls, path_or_bytes, audio: Optional[AudioConfig] = None,
                      infer: Optional[InferenceConfig] = None,
                      device: Any = "cuda") -> "InferencePipeline":
        """Serve from an exported artifact (infer/export.py): no model code,
        no checkpoint, the exported program is the forward. The host side
        (windowing, silence gate, calibration from the header, decision
        rule, smoothing, JSON) is the checkpoint pipeline's; only the
        exported batch sizes exist (``_bucket`` snaps to them). Per-head
        diagnostics need the parameters and are refused. The host audio
        knobs come from the caller, the sample rate from the artifact."""
        from synthetic_audio_detection_tpu_torch.infer import export

        program, meta = export.load_artifact(path_or_bytes, device=device)
        sizes = sorted(e["batch_size"] for e in meta["entries"])
        self = cls.__new__(cls)
        self.mesh = None
        self.device = torch.device(device)
        self.ensemble = export.ArtifactEnsemble(
            class_names=list(meta["class_names"]), calibration=meta.get("calibration") or None,
            generic_head=bool(meta.get("generic_head", False)))
        self.audio = dataclasses.replace(audio or AudioConfig(), sample_rate=meta["sample_rate"])
        self.spec = SpectrogramConfig(**meta["spec"])
        self.infer = infer or InferenceConfig(batch_size=sizes[-1])
        self._resolve_calibration()
        self.compute_dtype = getattr(torch, meta["compute_dtype"])
        self.use_kernel = self.use_fast_backbone = self.use_s2d_layer1 = False
        self.conv3x3_max_channels = 0
        self.transport_dtype = meta["transport_dtype"]
        self._bucket_sizes = sizes
        self._program = program
        return self

    def _forward(self, batch: torch.Tensor, return_per_head: bool = False):
        # a float32 program runs with TF32 off: a process flag, not part of
        # an exported graph, so the artifact's forward takes the scope too
        exact = self.compute_dtype == torch.float32
        with span("serve.forward"), exact_float32() if exact else contextlib.nullcontext():
            if self._program is not None:
                return self._program(batch)
            return forward_windows(
                self.ensemble, batch, self.spec, self.audio.sample_rate,
                use_kernel=self.use_kernel,
                use_fast_backbone=self.use_fast_backbone, return_per_head=return_per_head,
                conv3x3_max_channels=self.conv3x3_max_channels,
                use_s2d_layer1=self.use_s2d_layer1)

    # -- calibration --------------------------------------------------------

    def _resolve_calibration(self) -> None:
        """Engage the checkpoint's temperature calibration, its stored
        threshold (only while ``infer.threshold`` is the 0.5 default) and
        the per-column operating points, as the reference package does."""
        cal = self.ensemble.calibration
        self._cal = cal if (cal and self.infer.apply_calibration) else None
        self._threshold = self.infer.threshold
        if self._cal and "threshold" in self._cal and self.infer.threshold == 0.5:
            self._threshold = float(self._cal["threshold"])
        n_cols = self.ensemble.num_heads + 1
        self._col_thr = np.full(n_cols, self._threshold, np.float32)
        if self.infer.per_column_thresholds:
            if not (self._cal and "column_thresholds" in self._cal):
                raise ValueError(
                    "per_column_thresholds requires a checkpoint calibrated "
                    "with column thresholds (tools/calibrate_ensemble.py "
                    "--store-column-thresholds)")
            ct = np.asarray(self._cal["column_thresholds"], np.float32)
            if ct.shape != (n_cols,):
                raise ValueError(f"column_thresholds {ct.shape} vs {n_cols} columns")
            self._col_thr = ct
        if self.ensemble.generic_head:
            n_spec = len(self.ensemble.synthetic_names)
            self._col_thr_vis = np.delete(self._col_thr, n_spec)
            self._thr_generic = float(self._col_thr[n_spec])
        else:
            self._col_thr_vis = self._col_thr
            self._thr_generic = float(self._col_thr[-1])
        if self.infer.generic_verdict and not self.ensemble.generic_head:
            raise ValueError(
                "generic_verdict requires a checkpoint trained with a "
                "generic head (ensemble_trainer --generic-head)")

    # -- bucketing ----------------------------------------------------------

    def _bucket(self, n: int) -> int:
        # two levels: 8 for short clips, the batch size otherwise; chosen
        # once per call, so a long recording's tail pads into the same bucket
        if self._bucket_sizes is not None:  # an artifact: its exported sizes only
            return next((s for s in self._bucket_sizes if n <= s), self._bucket_sizes[-1])
        bucket = 8 if n <= 8 else self.infer.batch_size
        if self.mesh is not None:
            bucket = pad_batch_to_multiple(bucket, self.mesh)
        return bucket

    def _bucketed_batches(self, windows: np.ndarray, quantize: bool = True):
        """Yield (device batch padded to the bucket, rows to keep), with the
        int16 transport applied unless ``quantize`` is False; under a mesh
        the device batch is this rank's rows of the bucket."""
        num = windows.shape[0]
        bucket = self._bucket(num)
        pcm16 = quantize and self.transport_dtype == "int16" and windows.dtype != np.int16
        i = 0
        while i < num:
            take = min(bucket, num - i)
            with span("serve.pad"):
                batch = windows[i : i + take]
                if pcm16:
                    batch = wavio.pcm16_quantize(batch)
                if take < bucket:
                    batch = np.concatenate(
                        [batch, np.zeros((bucket - take, windows.shape[1]), batch.dtype)])
                if self.mesh is not None:
                    batch = shard_batch(self.mesh, {"w": batch})["w"]
                batch = np.ascontiguousarray(batch)
            batch = torch.from_numpy(batch).to(self.device)
            count("serve.batches")
            count("serve.rows", bucket)
            count("serve.useful_rows", take)
            yield batch, take
            i += take

    def _whole_batch(self, agg: torch.Tensor, nh: Optional[torch.Tensor] = None):
        """Under a mesh: this rank's rows of the serving logits [R, N+1] (and
        per-head logits [N, R, 2]) → the whole batch's, by one all-gather
        over ``data``; otherwise as given."""
        if self.mesh is None:
            return agg if nh is None else (agg, nh)
        r, n = agg.shape[0], self.ensemble.num_heads
        parts = [agg.float()] if nh is None else [agg.float(),
                                                  nh.float().transpose(0, 1).reshape(r, 2 * n)]
        whole = self.mesh.all_gather(torch.cat(parts, dim=1))
        if nh is None:
            return whole
        return whole[:, :n + 1], whole[:, n + 1:].reshape(-1, n, 2).transpose(0, 1)

    def logits_for_windows(self, windows: np.ndarray) -> np.ndarray:
        """[num, T] → [num, N+1] float32 logits."""
        if windows.shape[0] == 0:
            return np.zeros((0, self.ensemble.num_heads + 1), np.float32)
        out = []
        for batch, take in self._bucketed_batches(windows):
            agg = self._forward(batch)
            with span("serve.d2h"):
                out.append(self._whole_batch(agg)[:take].float().cpu().numpy())
        return np.concatenate(out, axis=0)

    # -- diagnostics --------------------------------------------------------

    def logits_and_per_head(self, windows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """[num, T] → (serving logits [num, N+1], per-head logits
        [num, N, 2]) from the same pass, so the two never disagree."""
        n = self.ensemble.num_heads
        if windows.shape[0] == 0:
            return np.zeros((0, n + 1), np.float32), np.zeros((0, n, 2), np.float32)
        self._refuse_artifact()
        agg_out, nh_out = [], []
        for batch, take in self._bucketed_batches(windows):
            agg, nh = self._whole_batch(*self._forward(batch, return_per_head=True))
            agg_out.append(agg[:take].float().cpu().numpy())
            nh_out.append(nh.float().cpu().numpy().transpose(1, 0, 2)[:take])
        return np.concatenate(agg_out, axis=0), np.concatenate(nh_out, axis=0)

    def per_head_sigmoids(self, windows: np.ndarray,
                          serving_numerics: bool = True) -> np.ndarray:
        """[num, T] → [num, N, 2] per-head sigmoids. ``serving_numerics``
        False uses the float32 front end and float32 ensemble, TF32 off,
        whatever the pipeline's configuration."""
        if windows.shape[0] == 0:
            return np.zeros((0, self.ensemble.num_heads, 2), np.float32)
        if serving_numerics:
            _, logits_bn2 = self.logits_and_per_head(windows)
            return (1.0 / (1.0 + np.exp(-logits_bn2))).astype(np.float32)
        self._refuse_artifact()
        ens32 = with_dtype(self.ensemble, torch.float32)
        out = []
        for batch, take in self._bucketed_batches(windows, quantize=False):
            with exact_float32():
                agg, nh = forward_windows(ens32, batch, self.spec, self.audio.sample_rate,
                                          return_per_head=True)
            _, nh = self._whole_batch(agg, nh)
            out.append(nh.cpu().numpy().transpose(1, 0, 2)[:take])
        probs = 1.0 / (1.0 + np.exp(-np.concatenate(out, axis=0)))
        return probs.astype(np.float32)

    def _refuse_artifact(self) -> None:
        if self._program is not None:
            raise NotImplementedError(
                "per-head diagnostics need the parameters; this pipeline serves from an "
                "exported artifact (from_artifact)")

    # -- full clip ----------------------------------------------------------

    def analyze_file(self, path: str, smooth: Optional[bool] = None) -> Dict[str, Any]:
        windows, stamps = slice_waveform(preprocess_waveform(path, self.audio), self.audio)
        return self.analyze_windows(windows, stamps, smooth=smooth)

    def analyze_windows(self, windows: np.ndarray, stamps: Sequence[Tuple[float, float]],
                        smooth: Optional[bool] = None,
                        logits: Optional[np.ndarray] = None) -> Dict[str, Any]:
        """Windows → the reference result dict {segments, percentages}.
        ``logits`` skips the device pass with precomputed serving logits."""
        if windows.shape[0] == 0:
            return {"segments": [], "percentages": {}}
        with span("serve.request"):
            if logits is None:
                logits = self.logits_for_windows(windows)
            with span("serve.decide"):
                return self._decide(stamps, smooth, logits)

    def _decide(self, stamps: Sequence[Tuple[float, float]], smooth: Optional[bool],
                logits: np.ndarray) -> Dict[str, Any]:
        """Serving logits [num, C] → the reference result dict."""
        smooth = self.infer.smooth if smooth is None else smooth
        class_names = self.ensemble.class_names
        if self._cal is not None:
            from synthetic_audio_detection_tpu_torch.utils.calibration import apply_calibration

            logits = apply_calibration(logits, self._cal)
        # float32 numpy sigmoid on the host: the reference's text, byte for byte
        probs = (1.0 / (1.0 + np.exp(-np.asarray(logits, np.float32)))).astype(np.float32)
        probs, generic = self._split_generic(probs)
        syn, real = probs[:, :-1], probs[:, -1]
        is_real = self._decide_rows(syn, real, generic)
        label_idx = np.where(is_real, probs.shape[1] - 1, syn.argmax(axis=1))
        if smooth:
            probs, label_idx = self.smooth_probs(probs, generic)
        labels = labels_from_indices(label_idx, self.ensemble.synthetic_names,
                                     self.ensemble.real_name)
        round_floats = self.infer.round_floats
        segments = [
            {"start_sec": round(float(s), 3) if round_floats else float(s),
             "end_sec": round(float(e), 3) if round_floats else float(e),
             "label": lab}
            for (s, e), lab in zip(stamps, labels)
        ]
        final = np.mean(probs, axis=0)
        percentages = {
            c: (round(float(final[j]) * 100.0, 2) if round_floats else float(final[j] * 100))
            for j, c in enumerate(class_names)
        }
        return {"segments": segments, "percentages": percentages}

    def _split_generic(self, probs: np.ndarray) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """[B, C] → (visible [B, N+1], generic [B] or None); the generic
        column sits at index N_spec."""
        if not self.ensemble.generic_head:
            return probs, None
        n_spec = len(self.ensemble.synthetic_names)
        return np.delete(probs, n_spec, axis=1), probs[:, n_spec]

    def smooth_probs(self, probs: np.ndarray, generic: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Gaussian-smooth each column over the windows, renormalize rows,
        re-decide. At the defaults the re-decision reads the renormalized
        rows (the reference's quirk); with per-column thresholds, K != 1 or
        the generic verdict it reads the smoothed sigmoids."""
        sigma = self.infer.smooth_sigma
        sm_raw = gaussian_filter1d(torch.from_numpy(probs), sigma, axis=0).numpy()
        sm = sm_raw / np.maximum(sm_raw.sum(axis=1, keepdims=True), 1e-8)
        n = probs.shape[1] - 1
        custom_points = (self.infer.per_column_thresholds
                         or int(self.infer.syn_override_k) != 1
                         or self.infer.generic_verdict)
        decide_on = sm_raw if custom_points else sm
        if generic is not None:
            generic = gaussian_filter1d(torch.from_numpy(generic[:, None]), sigma,
                                        axis=0).numpy()[:, 0]
        is_real = self._decide_rows(decide_on[:, :n], decide_on[:, n], generic)
        label_idx = np.where(is_real, n, decide_on[:, :n].argmax(axis=1))
        return sm, label_idx

    def _decide_rows(self, syn: np.ndarray, real: np.ndarray,
                     generic: Optional[np.ndarray] = None) -> np.ndarray:
        if self.infer.generic_verdict:
            if generic is None:
                raise ValueError(
                    "generic_verdict requires an ensemble trained with a "
                    "generic head (train/joint.py --generic-head)")
            return generic < self._thr_generic
        return decide_rows(syn, real, self._col_thr_vis, int(self.infer.syn_override_k))


def decide_rows(syn: np.ndarray, real: np.ndarray, col_thr: np.ndarray,
                syn_override_k: int = 1) -> np.ndarray:
    """Real iff the real column clears its threshold and fewer than
    ``syn_override_k`` synthetic columns clear theirs (K = 1: the
    reference's unanimity rule)."""
    strong = syn >= col_thr[:-1]
    k = max(int(syn_override_k), 1)
    return (real >= col_thr[-1]) & (strong.sum(axis=1) < k)


def result_json(filename: str, result: Dict[str, Any], indent: int = 4) -> str:
    """The reference output text: {filename, segments, percentages},
    ``json.dumps(..., indent=4)``."""
    return json.dumps(
        {"filename": filename, "segments": result["segments"],
         "percentages": result["percentages"]},
        indent=indent,
    )
