"""Synthesize a seeded N-generator study corpus for end-to-end drives (the
port's copy of the repository's ``tools/gen_study_corpus.py``: the same
classes, artifacts, seeds and files).

The reference's internal test trains one head per synthetic *generator*
(6 classes, README.md:77-80) but ships no data. This tool makes the full
pipeline reproducible without a proprietary corpus: every class shares the
same natural "utterance" synthesis (pitch-contoured glottal harmonics
through random formant resonances plus breath noise), and each synthetic
class differs ONLY by a characteristic generator artifact — the spectral
signatures real deepfake detectors key on (band-limit cutoffs, frame-rate
buzz, tonal GAN peaks, quantization fuzz, AM tremolo, inharmonicity).

Output: ``<out>/raw/<ClassName>/srcNNN.wav`` — 44.1 kHz PCM_16, alternating
mono/stereo so the downstream ETL chain (file_renamer -> audio_convert ->
audio_augmenter -> audio_segmenter -> dataset_manager -> file_manager,
SURVEY.md section 3.4) exercises its resample + downmix paths.

Usage:
    python -m synthetic_audio_detection_tpu_torch.tools.gen_study_corpus \
        --out /tmp/sad6 --classes 6 --files-per-class 24 --seconds 13
"""

from __future__ import annotations

import argparse
import os

import numpy as np
from scipy.signal import lfilter

from synthetic_audio_detection_tpu_torch.audio import wavio

CLASS_NAMES = ["SynthA", "SynthB", "SynthC", "SynthD", "SynthE", "SynthF"]


def _resonator(x: np.ndarray, freq: float, bw: float, sr: int) -> np.ndarray:
    """Second-order resonant IIR (formant) applied in direct form."""
    r = np.exp(-np.pi * bw / sr)
    theta = 2 * np.pi * freq / sr
    a1, a2 = -2 * r * np.cos(theta), r * r
    b0 = (1 - r) * np.sqrt(1 - 2 * r * np.cos(2 * theta) + r * r)
    return lfilter([b0], [1.0, a1, a2], x)


def _utterance(rng: np.random.Generator, n: int, sr: int) -> np.ndarray:
    """Speech-like base signal: voiced harmonic source + formants + breath."""
    t = np.arange(n) / sr
    # Pitch contour: slow random walk around a per-file register.
    f0_base = rng.uniform(85.0, 240.0)
    drift = np.cumsum(rng.standard_normal(n)) / np.sqrt(n)
    f0 = f0_base * (1.0 + 0.08 * drift / (np.abs(drift).max() + 1e-9))
    vibrato = 1.0 + 0.01 * np.sin(2 * np.pi * rng.uniform(4.5, 6.5) * t)
    phase = 2 * np.pi * np.cumsum(f0 * vibrato) / sr

    voiced = np.zeros(n, dtype=np.float64)
    n_harm = int(min(40, (sr / 2 - 200) / f0_base))
    for h in range(1, n_harm + 1):
        voiced += (1.0 / h) * np.sin(h * phase + rng.uniform(0, 2 * np.pi))

    # 3 random formant resonances shape the spectrum per file ("speaker").
    sig = voiced
    for lo, hi in ((300, 900), (900, 2400), (2400, 3800)):
        sig = _resonator(sig, rng.uniform(lo, hi), rng.uniform(80, 200), sr)
    sig /= np.abs(sig).max() + 1e-9

    # Syllabic energy envelope (2-5 Hz) with pauses, plus breath noise.
    env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2.0, 5.0) * t
                             + rng.uniform(0, 2 * np.pi))
    env = np.clip(env, 0.05, None) ** 1.5
    breath = _resonator(rng.standard_normal(n), 4000.0, 3500.0, sr)
    breath /= np.abs(breath).max() + 1e-9
    out = env * (sig + 0.06 * breath)
    return (0.5 * out / (np.abs(out).max() + 1e-9)).astype(np.float64)


def _apply_artifact(x: np.ndarray, cls: str, rng: np.random.Generator,
                    sr: int) -> np.ndarray:
    """Per-generator artifact. Parameters jitter per file within a band."""
    n = len(x)
    t = np.arange(n) / sr
    if cls == "SynthA":
        # Amplitude tremolo (AM artifact): 10-14 Hz, depth 0.35-0.55 —
        # above the natural syllabic envelope band (2-5 Hz) so the artifact
        # is a generator signature, not speech prosody.
        depth = rng.uniform(0.35, 0.55)
        return x * (1.0 - depth + depth
                    * np.sin(2 * np.pi * rng.uniform(10.0, 14.0) * t))
    if cls == "SynthB":
        # Metallic ring modulation: sideband pair around 2.5-3.5 kHz.
        f = rng.uniform(2500.0, 3500.0)
        return 0.75 * x + 0.25 * x * np.sin(2 * np.pi * f * t)
    if cls == "SynthC":
        # Band-limited vocoder: brick-ish low-pass at 6.5-8 kHz via FFT.
        cut = rng.uniform(6500.0, 8000.0)
        spec = np.fft.rfft(x)
        freqs = np.fft.rfftfreq(n, 1.0 / sr)
        roll = 1.0 / (1.0 + np.exp((freqs - cut) / 150.0))
        return np.fft.irfft(spec * roll, n)
    if cls == "SynthD":
        # Bit-crush quantization fuzz: 5-7 bits.
        levels = 2.0 ** rng.integers(5, 8)
        return np.round(x * levels) / levels
    if cls == "SynthE":
        # Frame-rate buzz: energy modulation at the vocoder frame rate
        # (hop 512 @ 44.1k ~ 86 Hz), soft square wave.
        fr = sr / 512.0
        sq = np.tanh(6.0 * np.sin(2 * np.pi * fr * t))
        depth = rng.uniform(0.15, 0.3)
        return x * (1.0 - depth + depth * 0.5 * (1 + sq))
    if cls == "SynthF":
        # GAN tonal peaks: 2 fixed narrowband tones in the 9-12 kHz band.
        y = x.copy()
        for f in (9500.0, 11300.0):
            fj = f * rng.uniform(0.99, 1.01)
            y += rng.uniform(0.01, 0.025) * np.sin(2 * np.pi * fj * t)
        return y
    if cls == "Real":
        return x
    raise ValueError(f"unknown class {cls!r}")


def generate(out: str, classes: int, files_per_class: int, seconds: float,
             sr: int, seed: int) -> int:
    names = ["Real"] + CLASS_NAMES[:classes]
    n = int(seconds * sr)
    total = 0
    for ci, cls in enumerate(names):
        folder = os.path.join(out, "raw", cls)
        os.makedirs(folder, exist_ok=True)
        for fi in range(files_per_class):
            rng = np.random.default_rng(seed + 10_000 * ci + fi)
            x = _apply_artifact(_utterance(rng, n, sr), cls, rng, sr)
            x = np.clip(x, -1.0, 1.0).astype(np.float32)
            if fi % 2:  # alternate stereo to exercise the downmix path
                x = np.stack([x, np.roll(x, 7)])
            wavio.write_wav(os.path.join(folder, f"src{fi:03d}.wav"), x, sr)
            total += 1
    return total


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--classes", type=int, default=6,
                   help="number of synthetic generator classes (<=6)")
    p.add_argument("--files-per-class", type=int, default=24)
    p.add_argument("--seconds", type=float, default=13.0)
    p.add_argument("--sr", type=int, default=44_100)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    total = generate(args.out, args.classes, args.files_per_class,
                     args.seconds, args.sr, args.seed)
    print(f"wrote {total} source files under {args.out}/raw")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
