"""11-way audio augmentation
(reference audio_augmneter.py flag surface: -i/--input, -o/--output,
-c/--csv, -p/--pool-size). Note the reference filename carries a typo
('augmneter'); this module uses the corrected spelling — a console alias with
the original spelling is not provided.

The port's copy of the reference package's ``cli/audio_augmenter.py``: the same
flags, defaults, exit codes and printed summary. Run with
``python -m synthetic_audio_detection_tpu_torch.cli.audio_augmenter``.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Audio Augmentation Script")
    p.add_argument("-i", "--input", required=True, help="Input file or folder")
    p.add_argument("-o", "--output", required=True, help="Output folder")
    p.add_argument("-c", "--csv", required=False, help="CSV output file path")
    p.add_argument("-p", "--pool-size", type=int, default=0,
                   help="Worker processes (0 = all cores)")
    p.add_argument("--seed", type=int, default=None,
                   help="Deterministic augmentation parameters")
    args = p.parse_args(argv)

    from synthetic_audio_detection_tpu_torch.data.augment import augment_directory

    records = augment_directory(
        args.input, args.output, csv_path=args.csv,
        pool_size=args.pool_size, seed=args.seed,
    )
    print(f"Wrote {len(records)} augmented file(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
