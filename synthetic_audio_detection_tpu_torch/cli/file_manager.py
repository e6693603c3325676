"""Train/test leakage audit + repair
(reference file_manager.py flag surface: -i/--input_dir, --fix).

The port's copy of the reference package's ``cli/file_manager.py``: the same
flags, defaults, exit codes and printed summary. Run with
``python -m synthetic_audio_detection_tpu_torch.cli.file_manager``.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Check for overlapping audio files between train and "
        "test and optionally fix them."
    )
    p.add_argument("-i", "--input_dir", required=True,
                   help="Dataset root containing train/ and test/.")
    p.add_argument("--fix", action="store_true",
                   help="Move minority-side files into the majority side.")
    args = p.parse_args(argv)

    from synthetic_audio_detection_tpu_torch.data.etl import check_overlap

    report = check_overlap(args.input_dir, fix=args.fix)
    total = 0
    for cls, overlaps in sorted(report.overlaps.items()):
        if overlaps:
            # per-class detail table (reference prints per-group counts,
            # file_manager.py:176-210)
            print(f"\nClass: {cls} — {len(overlaps)} overlapping group(s)")
            print(f"  {'group':<20} {'train':>6} {'test':>6} {'moves':>6}")
        for key, (n_tr, n_te) in sorted(overlaps.items()):
            print(f"  {key:<20} {n_tr:>6} {n_te:>6} {min(n_tr, n_te):>6}")
            total += 1
    if args.fix:
        print(f"Fixed: moved {report.moved}, deleted {report.deleted}")
    elif total:
        print(f"{total} overlapping group(s) found; rerun with --fix to repair")
    else:
        print("No overlaps found")
    for e in report.errors:
        print(f"ERROR: {e}", file=sys.stderr)
    return 1 if report.errors else 0


if __name__ == "__main__":
    sys.exit(main())
