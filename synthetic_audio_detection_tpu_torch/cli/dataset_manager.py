"""Train/test split by moving class-folder files
(reference dataset_manager.py flag surface: -i/--input_dir, -o/--output_dir,
-s/--split, -t/--threads). Adds --seed and --no-group-aware (the default
group-aware split avoids the train/test leakage the reference creates and
then repairs with file_manager).

The port's copy of the reference package's ``cli/dataset_manager.py``: the same
flags, defaults, exit codes and printed summary. Run with
``python -m synthetic_audio_detection_tpu_torch.cli.dataset_manager``.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Split audio files from class folders into Train and "
        "Test sets based on split ratio."
    )
    p.add_argument("-i", "--input_dir", required=True,
                   help="Directory of class subfolders with WAV files.")
    p.add_argument("-o", "--output_dir", required=True,
                   help="Output dataset root ({train,test}/<class>/).")
    p.add_argument("-s", "--split", type=float, default=0.5,
                   help="Train fraction (default 0.5).")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--no-group-aware", action="store_true",
                   help="Reproduce the reference's file-level random split "
                   "(may leak source groups across the split).")
    args = p.parse_args(argv)

    from synthetic_audio_detection_tpu_torch.data.etl import split_dataset

    report = split_dataset(
        args.input_dir, args.output_dir, args.split, args.threads,
        seed=args.seed, group_aware=not args.no_group_aware,
    )
    for cls, (tr, te) in sorted(report.per_class.items()):
        print(f"{cls}: train={tr} test={te}")
    for e in report.errors:
        print(f"ERROR: {e}", file=sys.stderr)
    return 1 if report.errors else 0


if __name__ == "__main__":
    sys.exit(main())
