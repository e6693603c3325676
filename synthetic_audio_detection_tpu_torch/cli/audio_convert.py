"""Normalize audio to 32 kHz mono 16-bit WAV
(reference audio_convert.py:38-55 flag surface: -i/--input, -o/--output).

WAV inputs decode natively (no ffmpeg needed); other containers use ffmpeg
when present.

The port's copy of the reference package's ``cli/audio_convert.py``: the same
flags, defaults, exit codes and printed summary. Run with
``python -m synthetic_audio_detection_tpu_torch.cli.audio_convert``.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Convert audio files within a directory to 32 kHz mono "
        "16-bit WAV."
    )
    p.add_argument("-i", "--input", type=str, required=True,
                   help="Path to the input directory containing audio files.")
    p.add_argument("-o", "--output", type=str, required=True,
                   help="Path to the output directory for converted WAVs.")
    p.add_argument("--workers", type=int, default=0,
                   help="Worker threads (0 = all cores)")
    args = p.parse_args(argv)

    from synthetic_audio_detection_tpu_torch.data.etl import convert_directory

    errors = convert_directory(args.input, args.output, workers=args.workers)
    for e in errors:
        print(f"ERROR: {e}", file=sys.stderr)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
