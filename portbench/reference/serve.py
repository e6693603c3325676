"""The serving path, plainly: a mono float32 recording → 4-s windows with
the silence gate and their time stamps → features → the ensemble's logits
→ each window's verdict (Real iff the Real column clears the threshold and
no synthetic column does; otherwise the synthetic column with the largest
probability). Logits are computed in blocks of rows, so the reference fits
beside whatever the process holds."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.reference import frontend, resnet


def windows_of(wave: np.ndarray, audio: Dict) -> Tuple[np.ndarray, List[Tuple[float, float]]]:
    """[T] → ([n, win] windows whose peak reaches the silence threshold,
    [(start s, start s + window s)]), a shorter wave padded to one window."""
    sr = audio["sample_rate"]
    win = int(audio["window_seconds"] * sr)
    hop = max(int((1.0 - audio["overlap"]) * win), 1)
    if wave.shape[0] < win:
        wave = np.pad(wave, (0, win - wave.shape[0]))
    starts = range(0, wave.shape[0] - win + 1, hop)
    keep = [s for s in starts if np.abs(wave[s:s + win]).max() >= audio["silence_threshold"]]
    if not keep:
        return np.zeros((0, win), np.float32), []
    return (np.stack([wave[s:s + win] for s in keep]).astype(np.float32),
            [(s / sr, s / sr + audio["window_seconds"]) for s in keep])


@torch.no_grad()
def logits(windows: torch.Tensor, cfg: Dict, weights, q=None, block: int = 32) -> torch.Tensor:
    """[n, T] float32 windows on the device → [n, N+1] float32 logits."""
    out = []
    m = cfg["model"]
    with frontend.exact():
        for i in range(0, windows.shape[0], block):
            x = frontend.serving_features(windows[i:i + block], cfg["spectrogram"],
                                          cfg["audio"]["sample_rate"], q)
            out.append(resnet.ensemble_logits(x, weights, m, q))
    return torch.cat(out) if out else windows.new_zeros((0, m["heads"] + 1))


def verdicts(logits: np.ndarray, class_names: List[str], threshold: float) -> List[str]:
    """[n, N+1] logits → each window's label."""
    p = 1.0 / (1.0 + np.exp(-logits.astype(np.float64)))
    syn, real = p[:, :-1], p[:, -1]
    is_real = (real >= threshold) & np.all(syn < threshold, axis=1)
    return [class_names[-1] if r else class_names[int(j)]
            for r, j in zip(is_real, syn.argmax(axis=1))]
