"""A catalogue scan with the legacy 5-class analyzer: one closed-loop client
sends clip after clip to ``LegacyAudioAnalyzer.analyze_waveform``, as the
legacy CLI's folder mode (``--IsBatch``) does for a folder of tracks.

The clips are views into a pool of seeded windows (traffic
``pool_windows``), ``clip_lengths`` of them spread evenly over
[``min_windows``, ``max_windows``] pool windows and the same for every
seed; the seed draws the audio, each clip's start in the pool and the
order, a fresh permutation of the clips each cycle. The analyzer
normalizes each clip, cuts it into windows at the configuration's overlap
and runs them in batches of ``serve.batch_size``. Set-up warms the full
batch and every clip's last, shorter batch. The window runs whole clips
until ``seconds`` have passed; a rate is taken over every clip completed
and the time until the last one completed.

The weights are ``reference.legacy.draw``'s: the seed's, calibrated on a
track of the pool's first windows so that the top class changes along a
track, some windows fall back to the majority and a track has several
segments.

The driver wraps the analyzer's calls, without editing the port: spans
(``dispatch`` around ``probabilities``, ``forward``, ``frontend`` around
the log-mel, ``backbone`` around the classifier), the rows of every
forward, as ``serving.Probe`` counts them, and captures what each clip was
decided from: its window starts, the classifier's output rows (kept on
the device until the window ends), the probabilities the smoothing read
and the final labels. ``fault`` plants one of ``FAULTS``.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from portbench import correct, generate, serving, trace
from portbench.reference import legacy as ref_legacy

FAULTS = ("half", "permuted", "post")
PROB_TOL = 1e-5  # served probabilities against the float64 softmax of the served output rows
CONF_TOL = 1e-5  # a segment's confidence, a mean of float32-smoothed probabilities
PERCENT_TOL = 0.011  # percentages rounded to 2 decimals on either side of a rounding edge


class Capture:
    """What one clip's call produced, as the analyzer handed it on."""

    def __init__(self):
        self.stamps: List[float] = []
        self.rows: List[torch.Tensor] = []
        self.probs = None
        self.final = None


class Driver:
    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device, tracer, fault=None):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"no fault {fault!r} for the legacy cell; choose from {FAULTS}")
        self.cfg, self.traffic, self.seed, self.device, self.tracer = cfg, traffic, seed, device, tracer
        self.fault = fault
        self.failed = 0

    def setup(self) -> None:
        from synthetic_audio_detection_tpu_torch.infer.legacy_analyzer import LegacyAudioAnalyzer

        if not hasattr(LegacyAudioAnalyzer, "analyze_waveform"):
            raise RuntimeError("the port's LegacyAudioAnalyzer has no analyze_waveform")
        a, t = self.cfg["audio"], self.traffic
        self.T = int(a["window_seconds"] * a["sample_rate"])
        self.pool = generate.window_pool(t["pool_windows"], self.T, a["sample_rate"], self.seed,
                                         self.device)
        self.lengths = generate.even_lengths(t["min_windows"], t["max_windows"], t["clip_lengths"])
        self.starts = generate.clip_offsets(self.lengths, self.pool.shape[0], self.seed)
        self.clips = [self.pool[s:s + n].reshape(-1) for s, n in zip(self.starts, self.lengths)]
        self.analyzer = build_analyzer(self.cfg, self.seed, self.device, self.calibration())
        trace.reset_peak(self.device)
        self._wrap()
        bs = self.analyzer.audio.batch_size
        hop = self.analyzer.audio.hop_samples
        tails = {((n - 1) * self.T // hop + 1) % bs or bs for n in self.lengths}
        for rows in sorted(tails | {bs}):
            self.analyzer.probabilities(self.pool[:rows])
        trace.sync(self.device)

    def _wrap(self) -> None:
        """Spans and captures around the analyzer's calls; ``release`` undoes
        the module-level one."""
        from synthetic_audio_detection_tpu_torch.ops import melspec

        an, tracer, fault = self.analyzer, self.tracer, self.fault
        self.cap = Capture()
        self.rows: List[int] = []
        windows, probabilities, smooth = an.windows, an.probabilities, an.smooth_predictions
        segments, fwd, model = an.confident_segments, an._forward, an.model
        self._saved = (melspec, "log_mel_features", melspec.log_mel_features)
        log_mel = melspec.log_mel_features

        def log_mel_features(*a, **k):
            with tracer.span("frontend"):
                return log_mel(*a, **k)

        def classifier(x):
            with tracer.span("backbone"):
                if fault == "half":
                    h = max(1, x.shape[0] // 2)
                    out = model(x[:h])
                    out = torch.cat([out, out.new_zeros((x.shape[0] - h, out.shape[1]))])
                elif fault == "permuted":
                    out = torch.roll(model(x), 1, dims=0)
                else:
                    out = model(x)
            self.cap.rows.append(out.detach())
            return out

        def forward(x):
            self.rows.append(int(x.shape[0]))
            with tracer.span("forward"):
                return fwd(x)

        def windows_(wave):
            w, stamps = windows(wave)
            self.cap.stamps = list(stamps)
            return w, stamps

        def probabilities_(w):
            with tracer.span("dispatch"):
                p = probabilities(w)
            self.cap.probs = p
            return p

        def smooth_(p):
            final, sm = smooth(p)
            self.cap.final = np.array(final)
            return final, sm

        def segments_(stamps, preds, probs):
            out = segments(stamps, preds, probs)
            if fault == "post" and out:
                names = an.classes
                out[0] = dict(out[0], **{"class": names[(names.index(out[0]["class"]) + 1)
                                                       % len(names)]})
            return out

        melspec.log_mel_features = log_mel_features
        an.model, an._forward = classifier, forward
        an.windows, an.probabilities, an.smooth_predictions = windows_, probabilities_, smooth_
        an.confident_segments = segments_

    def window(self, seconds: float) -> Dict:
        sr = self.cfg["audio"]["sample_rate"]
        order = generate.cycle_order(len(self.clips), self.seed)
        self.rows.clear()
        self.done, failed = [], 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            k = next(order)
            self.cap = Capture()
            try:
                result = self.analyzer.analyze_waveform(self.clips[k], sr)
            except Exception as e:  # noqa: BLE001 - an answer that never comes is counted
                print(f"clip {k}: {type(e).__name__}: {e}", flush=True)
                failed += 1
                continue
            self.done.append((k, result, self.cap))
        window_s = time.perf_counter() - t0
        self.failed += failed
        useful = sum(len(cap.stamps) for _, _, cap in self.done)
        return {"window_s": window_s, "attempted": len(self.done) + failed, "failed": failed,
                "useful_windows": useful, "requests": len(self.done)}

    def context(self) -> Dict:
        """The rows of each forward in the last window, padding included."""
        return {"rows": list(self.rows), "forwards": len(self.rows)}

    def calibration(self) -> torch.Tensor:
        """The windows ``reference.legacy.draw`` calibrates the head on."""
        w = ref_legacy.calibration_windows(self.pool, self.cfg["audio"])
        return torch.from_numpy(w).to(self.device)

    def release(self) -> None:
        for _, _, cap in self.done:
            cap.rows = torch.cat(cap.rows)[:len(cap.stamps)].double().cpu().numpy()
        mod, name, fn = self._saved
        setattr(mod, name, fn)
        del self.analyzer
        trace.sync(self.device)
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def check(self, limits: Dict, control=None) -> Dict:
        """``logit_gap`` on ``check_windows`` sampled windows of the completed
        clips (their reference windows sliced again from the pool);
        ``stamp_errors`` and ``post_errors`` over every completed clip.
        With ``control`` (a quantizer) the reference at that precision
        stands in for the served output rows."""
        cfg, audio = self.cfg, self.cfg["audio"]
        index = [(j, i) for j, (_, _, cap) in enumerate(self.done) for i in range(len(cap.stamps))]
        pick = [index[p] for p in serving.sample(len(index), self.traffic["check_windows"], self.seed)]
        by_clip: Dict[int, List[int]] = {}
        for n, (j, _) in enumerate(pick):
            by_clip.setdefault(self.done[j][0], []).append(n)
        windows = np.zeros((len(pick), self.T), np.float32)
        starts = {}
        for k in sorted({k for k, _, _ in self.done}):
            w, stamps = ref_legacy.windows_of(self.clips[k], audio)
            starts[k] = [a for a, _ in stamps]
            for n in by_clip.get(k, []):
                windows[n] = w[pick[n][1]]
            del w
        stamp_errors = sum(int(cap.stamps != starts[k]) for k, _, cap in self.done)
        weights = ref_legacy.draw(cfg, self.seed, self.device, self.calibration())
        x = torch.from_numpy(windows).to(self.device)
        ref = ref_legacy.log_probs(x, cfg, weights).double().cpu().numpy()
        if control is None:
            rows = np.stack([self.done[j][2].rows[i] for j, i in pick])
            served = rows - _logsumexp(rows)
        else:
            served = ref_legacy.log_probs(x, cfg, weights, control).double().cpu().numpy()
        del weights, x
        gap, spread = correct.logit_gap(served, ref)
        post = self.post_errors()
        return {"logit_gap": {"value": gap, "limit": limits["logit_gap"], "spread": spread},
                "stamp_errors": {"value": stamp_errors, "limit": limits["stamp_errors"]},
                "post_errors": dict(post, limit=limits["post_errors"]),
                "failed": {"value": self.failed, "limit": limits["failed"]}}

    def post_errors(self) -> Dict:
        """Completed clips whose served probabilities are not the softmax of
        the served output rows, or whose final labels (on windows that no
        rounding can tip), segments (on runs of labels that no rounding can
        change) or percentages differ from the reference's post-processing
        of the served probabilities. Besides the count: the labels and the
        runs compared, the runs, the segments among the runs compared, the
        windows the majority fallback relabelled, and the share of windows
        whose top probability is above 0.99."""
        v, names = self.cfg["serve"], self.cfg["model"]["class_names"]
        thr, sens = v["confidence_threshold"], ref_legacy.sensitivity_of(self.cfg)
        errors, labels, judged, runs, segs, fallback = 0, 0, 0, 0, 0, 0
        ws = self.cfg["audio"]["window_seconds"]
        for _, result, cap in self.done:
            soft = np.exp(cap.rows - _logsumexp(cap.rows))
            want = soft * np.asarray(sens)[None]
            want = want / want.sum(axis=1, keepdims=True)
            ref = ref_legacy.analyze(cap.probs, cap.stamps, names, sens, thr, ws)
            tip = ref_legacy.tippable(ref, thr, correct.TIE)
            fallback += int((ref["sm"].max(axis=1) < thr).sum())
            bad = not np.allclose(cap.probs, want, rtol=0, atol=PROB_TOL)
            bad |= bool(np.any(cap.final[~tip] != ref["final"][~tip]))
            labels += int((~tip).sum())
            runs += int(np.count_nonzero(np.diff(ref["final"]))) + 1
            got = {s["start"]: s for s in result["segments"]}
            exp = {s["start"]: s for s in ref["segments"]}
            for a, b in ref_legacy.judged_runs(ref, tip, thr, correct.TIE):
                judged += 1
                start = float(cap.stamps[a])
                g, e = got.get(start), exp.get(start)
                if e is None:
                    bad |= g is not None
                    continue
                segs += 1
                bad |= g is None or (g["end"], g["class"]) != (e["end"], e["class"]) or \
                    abs(g["confidence"] - e["confidence"]) > CONF_TOL
            bad |= any(abs(result["percentages"][c] - ref["percentages"][c]) > PERCENT_TOL
                       for c in names)
            errors += int(bad)
        probs = [cap.probs for _, _, cap in self.done]
        top = float(np.mean(np.concatenate(probs).max(axis=1) > 0.99)) if probs else 0.0
        return {"value": errors, "of": len(self.done), "labels_of": labels, "runs_of": judged,
                "runs": runs, "segments": segs, "fallback_windows": fallback, "top_share": top}


def _logsumexp(rows: np.ndarray) -> np.ndarray:
    top = rows.max(axis=1, keepdims=True)
    return top + np.log(np.exp(rows - top).sum(axis=1, keepdims=True))


def build_analyzer(cfg: Dict, seed: int, device, calibration: torch.Tensor):
    """The port's ``LegacyAudioAnalyzer`` on a ``BinaryClassifier`` made on
    ``device`` and loaded with ``reference.legacy.draw``'s weights of the
    seed, configured from the configuration file."""
    from synthetic_audio_detection_tpu_torch.infer.legacy_analyzer import (
        LegacyAudioAnalyzer, LegacyAudioConfig)
    from synthetic_audio_detection_tpu_torch.models.classifier import BinaryClassifier
    from synthetic_audio_detection_tpu_torch.utils.config import SpectrogramConfig

    m, a, v = cfg["model"], cfg["audio"], cfg["serve"]
    with torch.device(device):
        model = BinaryClassifier(m["arch"], m["in_channels"], num_outputs=m["outputs"])
    w = ref_legacy.draw(cfg, seed, device, calibration)
    sd = {f"base.{k}": t for k, t in w["backbones"][0].items()}
    sd.update({f"head.{k}": t for k, t in w["heads"][0].items()})
    serving.load_strict(model, sd)
    del w, sd
    audio = LegacyAudioConfig(target_sample_rate=a["sample_rate"], window_size=a["window_seconds"],
                              overlap=a["overlap"], silence_threshold=a["silence_threshold"],
                              normalize_audio=a["normalize"], batch_size=v["batch_size"])
    an = LegacyAudioAnalyzer(model, classes=m["class_names"], audio=audio,
                             sensitivity_factors=dict(v["sensitivity_factors"]),
                             confidence_threshold=v["confidence_threshold"],
                             compute_dtype=getattr(torch, v["compute_dtype"]), device=device)
    an.spec_cfg = SpectrogramConfig(**cfg["spectrogram"])
    return an
