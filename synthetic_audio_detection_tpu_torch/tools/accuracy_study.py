"""Held-out accuracy study: a merged ensemble against a segment tree (the
reference's ``tools/accuracy_study.py``, the same flags and JSON, plus
``--device``).

Drives one warm serving pipeline over ``<data-dir>/<ClassName>/*.wav``
held-out segments and prints binary detection accuracy (Real vs any
synthetic), attribution accuracy (the exact class) and the detector's
AUC/EER (infer/study.py evaluate_tree) as one JSON line.

    python -m synthetic_audio_detection_tpu_torch.tools.accuracy_study \\
        --merged-model merged.pth --data-dir dataset/test --bf16
"""

from __future__ import annotations

import argparse
import json
import sys

from synthetic_audio_detection_tpu_torch.tools.pipeline_args import (
    add_pipeline_args,
    cuda_missing,
    load_pipeline,
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_pipeline_args(p)
    p.add_argument("--data-dir", required=True,
                   help="Folder of <ClassName>/*.wav held-out segments")
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--syn-override-k", type=int, default=1,
                   help="Decision-layer K (reference unanimity = 1): synthetic columns needed "
                   "to override a Real verdict")
    p.add_argument("--per-column-thresholds", action="store_true",
                   help="Use the checkpoint calibration's per-column EER operating points as "
                   "the decision thresholds")
    p.add_argument("--generic-verdict", action="store_true",
                   help="Decide Real/Synthetic from the generic head (ensembles trained with "
                   "ensemble_trainer --generic-head); the detector AUC/EER score becomes the "
                   "generic head's probability")
    p.add_argument("--no-calibration", action="store_true")
    args = p.parse_args(argv)
    if cuda_missing("accuracy_study", args.device):
        return 1

    from synthetic_audio_detection_tpu_torch.infer.study import evaluate_tree

    _, pipe = load_pipeline(
        args, threshold=args.threshold, apply_calibration=not args.no_calibration,
        syn_override_k=args.syn_override_k, per_column_thresholds=args.per_column_thresholds,
        generic_verdict=args.generic_verdict)
    out = {
        "input_size": args.input_size or "native",
        "dtype": "bf16" if args.bf16 else "f32",
        "decision": {"syn_override_k": args.syn_override_k,
                     "per_column_thresholds": args.per_column_thresholds,
                     "generic_verdict": args.generic_verdict,
                     "threshold": args.threshold,
                     "calibration": not args.no_calibration},
        **evaluate_tree(pipe, args.data_dir),
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
