"""Merge sub-models into a multi-head ensemble checkpoint (the reference
package's ``cli/model_merger.py``: the same flags).

An output path ending in ``.pth`` gets the reference's torch contract; any
other the native msgpack format. ``--device`` is where the smoke forward
runs (default ``cuda``; without a usable GPU that is an error).

Usage:
    python -m synthetic_audio_detection_tpu_torch.cli.model_merger \\
        --submodels-folder ckpts/ --csv-file recipe.csv --output-path merged.pth
"""

from __future__ import annotations

import argparse
import logging
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Merge sub-models into a multi-head classifier with a merged Real output.")
    p.add_argument("--submodels-folder", type=str, required=True,
                   help="Folder containing sub-model .pth files.")
    p.add_argument("--csv-file", type=str, required=True,
                   help='CSV file with columns "model_filename", "synthetic_class", '
                   'and "real_class".')
    p.add_argument("--model-name", type=str, default="resnet18")
    p.add_argument("--output-path", type=str, required=True)
    p.add_argument("--reference-merge-semantics", action="store_true",
                   help="Reproduce the reference merger's strict=False load: reference-trainer "
                   "checkpoints contribute only their head; backbones come from "
                   "--backbone-weights (the stand-in for timm's ImageNet weights).")
    p.add_argument("--backbone-weights", type=str, default=None,
                   help="Donor checkpoint (.pth or native) supplying backbone weights under "
                   "--reference-merge-semantics.")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the smoke forward (cuda, cuda:N or cpu)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")

    from synthetic_audio_detection_tpu_torch.ensemble.merger import merge_models, save_merged

    ensemble = merge_models(args.submodels_folder, args.csv_file, backbone=args.model_name,
                            reference_semantics=args.reference_merge_semantics,
                            backbone_weights=args.backbone_weights, device=args.device)
    save_merged(ensemble, args.output_path)
    print(f"Merged {ensemble.num_heads} sub-models "
          f"(classes: {ensemble.class_names}) -> {args.output_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
