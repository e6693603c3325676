"""Rename audio files to their content hash
(reference file_renamer.py:46-53 flag surface: -i/--input_dir, -r/--recursive).

The port's copy of the reference package's ``cli/file_renamer.py``: the same
flags, defaults, exit codes and printed summary. Run with
``python -m synthetic_audio_detection_tpu_torch.cli.file_renamer``.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Rename all audio files in a directory to the first 16 "
        "characters of their SHA-256 hash."
    )
    p.add_argument("-i", "--input_dir", type=str, required=True,
                   help="The directory containing audio files to be renamed.")
    p.add_argument("-r", "--recursive", action="store_true",
                   help="Recursively process subdirectories")
    args = p.parse_args(argv)

    from synthetic_audio_detection_tpu_torch.data.etl import rename_files

    for old, new in rename_files(args.input_dir, args.recursive):
        print(f"Renamed {old} to {new}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
