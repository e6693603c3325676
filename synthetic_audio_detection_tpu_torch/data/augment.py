"""Offline audio augmentation: 1 input → 11 outputs (original + 10 effects);
the port's copy of the reference package's ``data/augment.py``.

The reference augmenter's DSP (audio_augmneter.py:55-145) with
identical parameter distributions and output contracts, librosa-free:

| name                      | params                               | ref     |
|---------------------------|--------------------------------------|---------|
| speed_up                  | phase-vocoder stretch, rate U[1,1.5] | :55-58  |
| slow_down                 | rate U[0.5,1]                        | :61-64  |
| pitch_up                  | U[0,2] semitones                     | :67-70  |
| pitch_down                | U[-2,0] semitones                    | :73-76  |
| dynamic_range_compression | sign(y)*|y|^a, a U[0.01,0.5]         | :79-82  |
| add_white_noise           | RMS-scaled, vol U[0.001,0.05]        | :85-90  |
| tremolo                   | LFO 3-6 Hz, depth 0.2-0.5            | :93-103 |
| phaser                    | 3 all-pass stages 500/1500/2500 Hz   | :106-126|
| time_shift                | roll ±0.5 s, zero-fill               | :129-137|
| time_pitch_shift          | stretch U[0.8,1.2] + shift U[-1,1]   | :140-145|

Output contract (audio_augmneter.py:148-212): load at 44.1 kHz mono, clip to
[-1,1], duplicate to stereo, write PCM_16 as
``{base}_{augmentation}_{param}.wav``, and record a CSV row per output.

The (file × augmentation) tasks fan out over worker processes forked from
a fork server (``_worker_context``), not from the caller: a forked child of
a process that holds a CUDA context or threads is unsafe. Nothing here
imports torch, so the workers hold NumPy and SciPy only.
"""

from __future__ import annotations

import concurrent.futures as cf
import csv
import multiprocessing
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.signal import lfilter

from synthetic_audio_detection_tpu_torch.audio import wavio
from synthetic_audio_detection_tpu_torch.audio.decode import load_audio
from synthetic_audio_detection_tpu_torch.audio.dsp import (
    pitch_shift,
    resample_poly_np,
    time_stretch,
)

AUGMENT_SR = 44_100

AUGMENTATIONS = (
    "original",
    "speed_up",
    "slow_down",
    "pitch_up",
    "pitch_down",
    "dynamic_range_compression",
    "add_white_noise",
    "tremolo",
    "phaser",
    "time_shift",
    "time_pitch_shift",
)


def augment_speed_up(y, rng, min_rate=1.0, max_rate=1.5):
    rate = rng.uniform(min_rate, max_rate)
    return time_stretch(y, rate), rate


def augment_slow_down(y, rng, min_rate=0.5, max_rate=1.0):
    rate = rng.uniform(min_rate, max_rate)
    return time_stretch(y, rate), rate


def augment_pitch_up(y, sr, rng, min_steps=0.0, max_steps=2.0):
    n_steps = rng.uniform(min_steps, max_steps)
    return pitch_shift(y, sr, n_steps), n_steps


def augment_pitch_down(y, sr, rng, min_steps=-2.0, max_steps=0.0):
    n_steps = rng.uniform(min_steps, max_steps)
    return pitch_shift(y, sr, n_steps), n_steps


def augment_dynamic_range_compression(y, rng, min_amount=0.01, max_amount=0.5):
    amount = rng.uniform(min_amount, max_amount)
    return np.sign(y) * (np.abs(y) ** amount), amount


def augment_add_white_noise(y, rng, min_vol=0.001, max_vol=0.05):
    rms = float(np.sqrt(np.mean(y**2)))
    noise_amp = rng.uniform(min_vol, max_vol) * rms
    return y + noise_amp * rng.normal(size=y.shape[0]), noise_amp


def augment_tremolo(y, sr, rng, min_rate=3.0, max_rate=6.0,
                    min_depth=0.2, max_depth=0.5):
    lfo_rate = rng.uniform(min_rate, max_rate)
    depth = rng.uniform(min_depth, max_depth)
    t = np.linspace(0, len(y) / sr, num=len(y))
    lfo = (1 - depth) + depth * np.sin(2 * np.pi * lfo_rate * t)
    return y * lfo, {"lfo_rate": lfo_rate, "depth": depth}


def augment_phaser(y, sr, rng, min_rate=0.1, max_rate=1.0,
                   min_depth=0.5, max_depth=0.9):
    depth = rng.uniform(min_depth, max_depth)
    rate = rng.uniform(min_rate, max_rate)
    t = np.arange(len(y)) / sr
    lfo = depth * np.sin(2 * np.pi * rate * t)
    y_phased = y.astype(np.float64).copy()
    for f0 in (500, 1500, 2500):
        omega = 2 * np.pi * f0 / sr
        alpha = np.sin(omega) / 2
        b = [alpha, 0, -alpha]
        a = [1 + alpha, -2 * np.cos(omega), 1 - alpha]
        y_filtered = lfilter(b, a, y_phased)
        y_phased += lfo * y_filtered
    return y_phased, {"rate": rate, "depth": depth}


def augment_time_shift(y, sr, rng, min_shift=-0.5, max_shift=0.5):
    shift = rng.uniform(min_shift, max_shift)
    k = int(shift * sr)
    out = np.roll(y, k)
    if k > 0:
        out[:k] = 0
    elif k < 0:
        out[k:] = 0
    return out, shift


def augment_time_pitch_shift(y, sr, rng):
    rate = rng.uniform(0.8, 1.2)
    n_steps = rng.uniform(-1, 1)
    return pitch_shift(time_stretch(y, rate), sr, n_steps), (rate, n_steps)


def _param_str(param) -> str:
    s = str(param)
    for a, b in ((" ", "_"), (",", "_"), (":", "_"), ("{", ""), ("}", "")):
        s = s.replace(a, b)
    return s


def apply_augmentation(
    y: np.ndarray, sr: int, name: str, rng: np.random.Generator
) -> Tuple[np.ndarray, Optional[object]]:
    if name == "original":
        return y, None
    if name == "speed_up":
        return augment_speed_up(y, rng)
    if name == "slow_down":
        return augment_slow_down(y, rng)
    if name == "pitch_up":
        return augment_pitch_up(y, sr, rng)
    if name == "pitch_down":
        return augment_pitch_down(y, sr, rng)
    if name == "dynamic_range_compression":
        return augment_dynamic_range_compression(y, rng)
    if name == "add_white_noise":
        return augment_add_white_noise(y, rng)
    if name == "tremolo":
        return augment_tremolo(y, sr, rng)
    if name == "phaser":
        return augment_phaser(y, sr, rng)
    if name == "time_shift":
        return augment_time_shift(y, sr, rng)
    if name == "time_pitch_shift":
        return augment_time_pitch_shift(y, sr, rng)
    raise ValueError(f"unknown augmentation {name!r}")


def process_augmentation(
    input_file: str,
    output_folder: str,
    augmentation_name: str,
    seed: Optional[int] = None,
) -> Optional[Dict[str, object]]:
    """One (file × augmentation) task → one stereo PCM_16 WAV + CSV record
    (audio_augmneter.py:148-212 contract). Returns None on failure.

    WAV inputs decode through the native parser; anything else (the reference
    accepts .mp3 too, audio_augmneter.py:233,242) routes through the ffmpeg
    shim in audio/decode.py — a clear error without ffmpeg, mirroring
    librosa.load's backend behavior."""
    try:
        if input_file.lower().endswith(".wav"):
            wf, sr = wavio.read_wav(input_file)
        else:
            wf, sr = load_audio(input_file)
        y = wf.mean(axis=0)
        if sr != AUGMENT_SR:
            y = resample_poly_np(y, sr, AUGMENT_SR)
            sr = AUGMENT_SR
        rng = np.random.default_rng(seed)
        y_aug, param = apply_augmentation(y, sr, augmentation_name, rng)
        y_aug = np.clip(y_aug, -1.0, 1.0)
        stereo = np.stack([y_aug, y_aug], axis=0)

        base = os.path.splitext(os.path.basename(input_file))[0]
        if param is not None:
            out_name = f"{base}_{augmentation_name}_{_param_str(param)}.wav"
        else:
            out_name = f"{base}_{augmentation_name}.wav"
        os.makedirs(output_folder, exist_ok=True)
        wavio.write_wav(os.path.join(output_folder, out_name), stereo, sr, "PCM_16")
        return {
            "input_file": input_file,
            "output_file": out_name,
            "augmentation": augmentation_name,
            "param": param,
        }
    except Exception as e:  # noqa: BLE001 - per-task isolation like the reference
        print(f"Error processing {input_file} with {augmentation_name}: {e}")
        return None


def augment_directory(
    input_path: str,
    output_folder: str,
    csv_path: Optional[str] = None,
    pool_size: int = 0,
    augmentations: Sequence[str] = AUGMENTATIONS,
    seed: Optional[int] = None,
) -> List[Dict[str, object]]:
    """Fan (files × augmentations) over a process pool; write the provenance
    CSV (audio_augmneter.py:267-284)."""
    if os.path.isfile(input_path):
        files = [input_path]
    else:
        # .wav AND .mp3, matching the reference's listing
        # (audio_augmneter.py:233,242)
        files = [
            os.path.join(input_path, f)
            for f in sorted(os.listdir(input_path))
            if f.lower().endswith((".wav", ".mp3"))
        ]
    tasks = []
    for i, f in enumerate(files):
        for j, aug in enumerate(augmentations):
            task_seed = None if seed is None else seed * 1_000_003 + i * 101 + j
            tasks.append((f, output_folder, aug, task_seed))

    pool_size = pool_size or os.cpu_count() or 1
    records: List[Dict[str, object]] = []
    if pool_size == 1:
        # inline: no worker-process spawn overhead for tiny batches
        for rec in map(_process_star, tasks):
            if rec is not None:
                records.append(rec)
    else:
        with cf.ProcessPoolExecutor(max_workers=pool_size, mp_context=_worker_context()) as ex:
            for rec in ex.map(_process_star, tasks):
                if rec is not None:
                    records.append(rec)

    if csv_path:
        with open(csv_path, "w", newline="") as f:
            writer = csv.DictWriter(
                f, fieldnames=["input_file", "output_file", "augmentation", "param"]
            )
            writer.writeheader()
            writer.writerows(records)
    return records


def _worker_context():
    """Workers forked from a fork server that has imported this module (and
    so NumPy and SciPy) once: never a fork of the caller, which may hold a
    CUDA context or threads, and no import per worker, as spawn would pay."""
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload([__name__])
    return ctx


def _process_star(task):
    return process_augmentation(*task)
