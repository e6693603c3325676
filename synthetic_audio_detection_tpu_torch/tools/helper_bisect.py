"""The three helper probes on bf16 arrays of ones, on one device.

    python -m synthetic_audio_detection_tpu_torch.tools.helper_bisect [--device cuda|cpu]

The counterpart of the reference repository's
``benchmarks/pallas_helper_bisect.py``. There the probes bisected which
Pallas features the TPU's remote compile helper rejected: a dot behind a
program-id-dependent dynamic slice (F1) and a lane-axis concatenation
before a K = 2C dot (F2) crashed it, nine static tap slices with a 3-D
weight index (F3) compiled. On Hopper the three are one hand-written kernel
(``ops/cuda_probes.py`` → ``csrc/helper_probes.cu``), and the probes check
its per-tile row offset (F1) and its multi-tap addressing (F2, F3).

On arrays of ones every output element is the same constant (64, 128,
576), so each probe's sum is exact: 14680064, 4194304 and 18874368. Each
prints ``<probe> : OK <sum>``; a wrong sum or a raised error prints
``<probe> : FAIL <reason>``, and then the exit code is 1. Unlike the TPU
script, no failure is swallowed. ``--device cuda`` (the default) without a
GPU exits 1.
"""

from __future__ import annotations

import argparse
import sys

import torch

from synthetic_audio_detection_tpu_torch.ops import cuda_probes

# (label, entry, weight name, exact sum of the output on ones)
PROBES = [
    ("F1 dyn-dslice", cuda_probes.dyn_slice_dot, "w", 2 * 1792 * 64 * 64),
    ("F2 lane-concat", cuda_probes.lane_concat_dot, "w", 2 * 256 * 64 * 128),
    ("F3 9-tap-static", cuda_probes.nine_tap_dot, "w9", 2 * 256 * 64 * 576),
]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:N or cpu)")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("helper_bisect: CUDA is not available", file=sys.stderr)
        return 1
    inputs = {
        "x": torch.ones(cuda_probes.X_SHAPE, dtype=torch.bfloat16, device=device),
        "w": torch.ones(64, 64, dtype=torch.bfloat16, device=device),
        "w9": torch.ones(9, 64, 64, dtype=torch.bfloat16, device=device),
    }
    failed = 0
    for label, entry, weight, expected in PROBES:
        try:
            total = float(entry(inputs["x"], inputs[weight]).double().sum())
        except (RuntimeError, ValueError) as e:
            print(label, ": FAIL", repr(e)[:110])
            failed += 1
            continue
        if total != expected:
            print(label, ": FAIL", f"sum {total} != {float(expected)}")
            failed += 1
        else:
            print(label, ": OK", total)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
