"""Detector robustness study: a perturbation sweep over a held-out tree
(the reference's ``tools/robustness_study.py``, the same flags,
perturbations and JSON, plus ``--device``).

Measures how the merged ensemble's operating metrics (binary accuracy,
attribution, AUC, EER; infer/study.py) move under host-side
perturbations of the held-out clips, each deterministic per file (its RNG
seeded from ``--seed`` and the relative path):

* ``clean``        no change
* ``noise_snr20``  additive white noise at 20 dB SNR
* ``noise_snr10``  10 dB SNR
* ``gain_-12db``   0.25x level
* ``lowpass_8k``   resample round trip 32k → 16k → 32k: nothing above 8 kHz
* ``clip_2x``      2x gain hard-clipped to [-1, 1]
* ``shift_0.5s``   circular time shift by 0.5 s

    python -m synthetic_audio_detection_tpu_torch.tools.robustness_study \\
        --merged-model merged.pth --data-dir dataset/test --bf16 \\
        [--perturbations clean noise_snr20 lowpass_8k]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from synthetic_audio_detection_tpu_torch.audio.resample import resample_poly_np
from synthetic_audio_detection_tpu_torch.tools.pipeline_args import (
    add_pipeline_args,
    cuda_missing,
    load_pipeline,
)


def _with_snr(wf: np.ndarray, rng: np.random.Generator, snr_db: float):
    rms = float(np.sqrt(np.mean(wf**2))) or 1e-6
    noise_rms = rms / (10.0 ** (snr_db / 20.0))
    return wf + noise_rms * rng.standard_normal(wf.shape).astype(np.float32)


def _lowpass_8k(wf: np.ndarray, sr: int = 32_000) -> np.ndarray:
    down = resample_poly_np(wf, sr, sr // 2)
    return resample_poly_np(down, sr // 2, sr)[: wf.shape[0]]


PERTURBATIONS = {
    "clean": lambda wf, rng: wf,
    "noise_snr20": lambda wf, rng: _with_snr(wf, rng, 20.0),
    "noise_snr10": lambda wf, rng: _with_snr(wf, rng, 10.0),
    "gain_-12db": lambda wf, rng: 0.25 * wf,
    "lowpass_8k": lambda wf, rng: _lowpass_8k(wf),
    "clip_2x": lambda wf, rng: np.clip(2.0 * wf, -1.0, 1.0),
    "shift_0.5s": lambda wf, rng: np.roll(wf, 16_000),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_pipeline_args(p)
    p.add_argument("--data-dir", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--perturbations", nargs="+", default=list(PERTURBATIONS),
                   choices=list(PERTURBATIONS))
    args = p.parse_args(argv)
    if cuda_missing("robustness_study", args.device):
        return 1

    from synthetic_audio_detection_tpu_torch.infer.study import evaluate_tree

    _, pipe = load_pipeline(args)
    out = {"input_size": args.input_size or "native",
           "dtype": "bf16" if args.bf16 else "f32",
           "perturbations": {}}
    for name in args.perturbations:
        res = evaluate_tree(pipe, args.data_dir, perturb=PERTURBATIONS[name], seed=args.seed)
        out["perturbations"][name] = {
            k: res[k] for k in ("n_segments", "binary_accuracy", "attribution_accuracy",
                                "binary_auc", "binary_eer") if k in res
        }
        print(json.dumps({name: out["perturbations"][name]}), file=sys.stderr, flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
