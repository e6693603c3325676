"""The legacy 5-class analyzer, plainly (the reference script's
``analyze_waveform``): normalization (mean-subtract, peak, RMS 0.2; a clip
shorter than one window zero-padded to 5 s first), windows at the
configuration's overlap with the silence gate (``serve.windows_of``), the
float32 log-mel image on three channels, the backbone and head, the
log-softmax; then, from the probabilities, the sensitivity rescale,
Gaussian smoothing (σ 2), the row renorm, the argmax, the median filter of
5, the majority fallback under the confidence threshold, the run-length
merge into confident segments and the percentages.

Departures from the script: no AMP autocast (the configuration's float32
with TF32 off is what is served); the normalization runs in float64 and is
cast to float32 once; the post-processing runs in float64 with scipy's
``gaussian_filter1d`` and ``medfilt``, as the script called them.

The weights (``draw``) are ``weights.draw``'s, made to decide as a trained
5-class model would on this traffic. Drawn as they are, every window's top
class is above 0.99 and the same across a track: ``weights.py`` halves a
bottleneck's middle BN (``bn2``), not its last, so the residual stream
grows through 50 blocks (pooled features near 200 at 64²), and the
features' part common to every window outweighs their window-dependent
part about 20 to 1. So each bottleneck's ``bn3`` scale is multiplied by
``BN3_SCALE`` (pooled features near 1), and the head's last Linear is
replaced: its logits are the head's hidden layer projected on that layer's
principal directions over a calibration track's analysis windows
(``calibration_windows``), each centred there and scaled to standard
deviation ``LOGIT_SCALE``. The logits are then uncorrelated and move with
the audio, so on every seed the top class changes along a track, some
windows fall below the confidence threshold, and a track has several
segments. Standardizing each of the drawn head's logits instead left one
label across whole tracks on some seeds: there the drawn logits move
together, or the pool's own windows differ from a track's normalized,
overlapping ones.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import scipy.ndimage
import scipy.signal
import torch

from portbench.reference import backbone, frontend, resnet, serve
from portbench.reference import weights as ref_weights

BN3_SCALE = 0.5
LOGIT_SCALE = 2.0
CALIBRATION_POOL = 16  # pool windows of the calibration track: 101 analysis windows at 85% overlap


def normalize(wave: np.ndarray, target_rms: float = 0.2) -> np.ndarray:
    x = wave.astype(np.float64)
    x = x - x.mean()
    peak = np.abs(x).max()
    if peak > 0:
        x = x / peak
    rms = np.sqrt(np.mean(x ** 2))
    if rms > 0:
        x = x * (target_rms / rms)
    return x.astype(np.float32)


def prepare(wave: np.ndarray, audio: Dict) -> np.ndarray:
    """A mono clip at the configuration's rate → the analyzer's input."""
    sr = audio["sample_rate"]
    if wave.shape[0] < audio["window_seconds"] * sr:
        wave = np.pad(wave, (0, int(5.0 * sr) - wave.shape[0]))
    return normalize(wave)


def windows_of(wave: np.ndarray, audio: Dict) -> Tuple[np.ndarray, List[Tuple[float, float]]]:
    """A mono clip → its windows and (start, end) stamps, normalized first."""
    return serve.windows_of(prepare(wave, audio), audio)


def calibration_windows(pool: np.ndarray, audio: Dict) -> np.ndarray:
    """The windows ``draw`` calibrates the head on: the analysis windows of
    a track made of the pool's first ``CALIBRATION_POOL`` windows."""
    return windows_of(pool[:CALIBRATION_POOL].reshape(-1), audio)[0]


@torch.no_grad()
def draw(cfg: Dict, seed: int, device, calibration: torch.Tensor):
    """``weights.draw``'s weights of the seed with each ``bn3`` scale times
    ``BN3_SCALE`` and the head's last Linear set from ``calibration`` ([n, T]
    float32 windows on ``device``, ``calibration_windows``): logit k =
    LOGIT_SCALE · v_k · (h − h̄) / σ_k, with h the hidden layer the last
    Linear reads, h̄ its mean over those windows, v_k its k-th principal
    direction there (sign fixed: the largest entry positive) and σ_k the
    standard deviation along it."""
    m = cfg["model"]
    w = ref_weights.draw(m, seed, device)
    bb, hd = w["backbones"][0], w["heads"][0]
    for k in bb:
        if k.endswith("bn3.weight"):
            bb[k] = bb[k] * BN3_SCALE
    last = 2 + 4 * len(m["head_hidden"])  # weights.head_shapes' index
    width, dev = m["head_hidden"][-1], hd[f"{last}.weight"].device
    identity = dict(hd, **{f"{last}.weight": torch.eye(width, device=dev),
                           f"{last}.bias": torch.zeros(width, device=dev)})
    h = logits(calibration, cfg, {"backbones": [bb], "heads": [identity]}).double().cpu()
    mean = h.mean(0)
    _, s, vt = torch.linalg.svd(h - mean, full_matrices=False)
    v = vt[:m["outputs"]]
    v = v * torch.sign(v.gather(1, v.abs().argmax(1, keepdim=True)))
    weight = v * (LOGIT_SCALE * (h.shape[0] - 1) ** 0.5 / s[:m["outputs"]])[:, None]
    hd[f"{last}.weight"] = weight.float().to(dev)
    hd[f"{last}.bias"] = (-(weight @ mean)).float().to(dev)
    return w


@torch.no_grad()
def logits(windows: torch.Tensor, cfg: Dict, weights, q=None, block: int = 32) -> torch.Tensor:
    """[n, T] float32 windows on the device → [n, outputs] float32 logits,
    in blocks of ``block`` rows."""
    m, out = cfg["model"], []
    bb, hd = weights["backbones"][0], weights["heads"][0]
    with frontend.exact():
        for i in range(0, windows.shape[0], block):
            z = frontend.serving_features(windows[i:i + block], cfg["spectrogram"],
                                          cfg["audio"]["sample_rate"], q)
            x = z[:, None].expand(-1, m["in_channels"], -1, -1)
            pooled = backbone(m).forward(x, bb, m, q=q)
            out.append(resnet.head(pooled, hd, q=q, dropout=m["head_dropout"]))
    return torch.cat(out) if out else windows.new_zeros((0, m["outputs"]))


def log_probs(windows: torch.Tensor, cfg: Dict, weights, q=None, block: int = 32) -> torch.Tensor:
    """[n, T] float32 windows on the device → [n, outputs] float32
    log-probabilities, in blocks of ``block`` rows."""
    return torch.log_softmax(logits(windows, cfg, weights, q, block), dim=-1)


def smooth(probs: np.ndarray, sensitivity: Sequence[float]) -> np.ndarray:
    """[n, C] probabilities → the rescaled, Gaussian-smoothed, renormalized
    probabilities the decisions are read from (float64)."""
    p = probs.astype(np.float64) * np.asarray(sensitivity, np.float64)[None]
    p = p / p.sum(axis=1, keepdims=True)
    sm = scipy.ndimage.gaussian_filter1d(p, 2.0, axis=0)
    return sm / sm.sum(axis=1, keepdims=True)


def decide(sm: np.ndarray, threshold: float) -> Tuple[np.ndarray, np.ndarray]:
    """Smoothed probabilities → (the argmax median-filtered, the final labels
    after the majority fallback)."""
    med = scipy.signal.medfilt(np.argmax(sm, axis=1).astype(np.float64), 5).astype(np.int64)
    final = med.copy()
    final[sm.max(axis=1) < threshold] = np.argmax(np.bincount(med, minlength=sm.shape[1]))
    return med, final


def segments(stamps: Sequence[float], final: np.ndarray, sm: np.ndarray, classes: Sequence[str],
             threshold: float, window_seconds: float) -> List[Dict]:
    """Runs of equal labels, kept where their mean confidence reaches the
    threshold."""
    out, i = [], 0
    while i < len(final):
        j = i
        while j + 1 < len(final) and final[j + 1] == final[i]:
            j += 1
        conf = float(np.mean(sm[i:j + 1, final[i]]))
        if conf >= threshold:
            out.append({"start": float(stamps[i]), "end": float(stamps[j] + window_seconds),
                        "class": classes[final[i]], "confidence": conf})
        i = j + 1
    return out


def analyze(probs: np.ndarray, stamps: Sequence[float], classes: Sequence[str],
            sensitivity: Sequence[float], threshold: float, window_seconds: float) -> Dict:
    """The post-processing of one clip's probabilities: {'sm', 'median',
    'final', 'segments', 'percentages'}."""
    sm = smooth(probs, sensitivity)
    med, final = decide(sm, threshold)
    return {"sm": sm, "median": med, "final": final,
            "segments": segments(stamps, final, sm, classes, threshold, window_seconds),
            "percentages": {c: round(float(sm[:, i].mean()) * 100.0, 2)
                            for i, c in enumerate(classes)}}


def tippable(ref: Dict, threshold: float, tie: float) -> np.ndarray:
    """The windows whose final label a rounding of ``tie`` in the smoothed
    probabilities could change: where a row in the median filter's reach
    has its top two within ``tie``, where the window's own confidence is
    within ``tie`` of the threshold, or where it falls back to a majority
    that as many tippable medians could change."""
    sm, med = ref["sm"], ref["median"]
    top2 = np.sort(sm, axis=1)[:, -2:]
    loose = top2[:, 1] - top2[:, 0] < tie
    reach = np.convolve(loose.astype(np.int64), np.ones(5, np.int64), "same") > 0
    near = np.abs(sm.max(axis=1) - threshold) < tie
    counts = np.sort(np.bincount(med, minlength=sm.shape[1]))
    majority_loose = counts[-1] - counts[-2] <= 2 * int(reach.sum())
    falls_back = sm.max(axis=1) < threshold
    return reach | near | (falls_back & majority_loose)


def judged_runs(ref: Dict, tip: np.ndarray, threshold: float, tie: float) -> List[Tuple[int, int]]:
    """The runs of equal final labels ([first, last] windows) that no
    rounding of ``tie`` can change: no window of the run or next to it can
    tip, so the run has the same bounds and class on both sides, and its
    mean confidence is not within ``tie`` of the threshold, so it is kept
    (a segment) or dropped on both sides."""
    final, sm, n = ref["final"], ref["sm"], len(ref["final"])
    cuts = np.flatnonzero(np.diff(final)) + 1
    out = []
    for a, b in zip(np.r_[0, cuts], np.r_[cuts, n] - 1):
        if tip[max(a - 1, 0):b + 2].any():
            continue
        if abs(float(np.mean(sm[a:b + 1, final[a]])) - threshold) >= tie:
            out.append((int(a), int(b)))
    return out


def sensitivity_of(cfg: Dict) -> List[float]:
    """The configuration's sensitivity factor of each class, in class order."""
    v, names = cfg["serve"], cfg["model"]["class_names"]
    return [v["sensitivity_factors"].get(c.lower(), 1.0) for c in names]
