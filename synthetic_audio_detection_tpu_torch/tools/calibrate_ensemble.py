"""Fit temperature calibration for a merged ensemble and write it back (the
reference's ``tools/calibrate_ensemble.py``, the same flags and JSON, plus
``--device``).

Drives the serving pipeline (raw logits: any calibration the checkpoint
already carries is not applied) over a labeled segment tree
(``<fit-dir>/<ClassName>/*.wav``), fits one temperature per aggregated
output column (utils/calibration.py) and writes the calibration into the
merged checkpoint's metadata, in the input's format: a ``.pth``/``.pt``
output in the torch format, anything else native
(ensemble/merger.save_merged). Serving then applies it
(infer/pipeline.py; ``--no-calibration`` opts out).

A generic-head checkpoint is fitted with its generic column
(``generic_head=ensemble.generic_head``), where the reference omits the
flag and raises on such a checkpoint.

Fit on a validation split, not the final test set; report the held-out
ECE there with ``--eval-dir``.

    python -m synthetic_audio_detection_tpu_torch.tools.calibrate_ensemble \\
        --merged-model merged.pth --fit-dir dataset/train --eval-dir dataset/test \\
        --bf16 --output merged_cal.pth
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from synthetic_audio_detection_tpu_torch.tools.pipeline_args import (
    add_pipeline_args,
    cuda_missing,
    load_pipeline,
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_pipeline_args(p)
    p.add_argument("--fit-dir", required=True,
                   help="Labeled tree <dir>/<ClassName>/*.wav to fit on (use a validation "
                   "split, not the final test set)")
    p.add_argument("--eval-dir",
                   help="Optional second tree: report held-out ECE before/after with the "
                   "fitted temperatures")
    p.add_argument("--output",
                   help="Output checkpoint path (default: overwrite --merged-model in place)")
    p.add_argument("--store-eer-threshold", action="store_true",
                   help="Also store the calibrated real column's EER operating point as the "
                   "serving threshold (otherwise the 0.5 default stays)")
    p.add_argument("--store-column-thresholds", action="store_true",
                   help="Also store per-column operating points (serve with "
                   "--per-column-thresholds)")
    p.add_argument("--column-threshold-method", default="eer", choices=["eer", "sidak"],
                   help="'eer': each column's own calibrated EER point. 'sidak': per-head "
                   "real-FPR q=1-(1-alpha)^(1/N), so the ensemble's compounded real-FPR is "
                   "bounded by --sidak-alpha")
    p.add_argument("--sidak-alpha", type=float, default=0.05,
                   help="target ensemble real-FPR for --column-threshold-method sidak")
    args = p.parse_args(argv)
    if cuda_missing("calibrate_ensemble", args.device):
        return 1

    from synthetic_audio_detection_tpu_torch.ensemble.merger import save_merged
    from synthetic_audio_detection_tpu_torch.infer.study import collect_logits_tree
    from synthetic_audio_detection_tpu_torch.utils import calibration as cal_mod

    # raw logits, whatever calibration the checkpoint already carries
    ensemble, pipe = load_pipeline(args, apply_calibration=False)
    fit = collect_logits_tree(pipe, args.fit_dir)
    cal = cal_mod.fit_ensemble_calibration(
        fit["logits"], fit["class_idx"], ensemble.class_names,
        store_eer_threshold=args.store_eer_threshold,
        store_column_thresholds=args.store_column_thresholds,
        column_threshold_method=args.column_threshold_method,
        sidak_alpha=args.sidak_alpha,
        fit_on=f"{args.fit_dir} ({fit['logits'].shape[0]} windows)",
        generic_head=ensemble.generic_head,
    )
    report = {"calibration": cal}

    if args.eval_dir:
        ev = collect_logits_tree(pipe, args.eval_dir)
        temps = np.asarray(cal["temperatures"], np.float64)
        n_named = len(ensemble.class_names) - 1
        ece_b, ece_a = [], []
        for j in range(temps.shape[0]):
            target = cal_mod.column_target(ev["class_idx"], j, n_named, ensemble.generic_head)
            col = np.asarray(ev["logits"][:, j], np.float64)
            p_raw = 1.0 / (1.0 + np.exp(-col))
            p_cal = 1.0 / (1.0 + np.exp(-col / temps[j]))
            ece_b.append(round(cal_mod.expected_calibration_error(p_raw, target), 6))
            ece_a.append(round(cal_mod.expected_calibration_error(p_cal, target), 6))
        report["eval"] = {"dir": args.eval_dir, "n_windows": int(ev["logits"].shape[0]),
                          "ece_before": ece_b, "ece_after": ece_a}

    # write back in the input's format (the float32 weights as loaded)
    out_path = args.output or args.merged_model
    ensemble.calibration = cal
    save_merged(ensemble, out_path, torch_format=out_path.endswith((".pth", ".pt")))
    report["output"] = out_path
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
