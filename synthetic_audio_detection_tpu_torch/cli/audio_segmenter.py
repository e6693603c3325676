"""Split audio into 4-second mono 32 kHz segments
(reference audio_segmenter.py:61-67 flag surface: -i/--input, -o/--output;
output naming contract {base}_Segment_%03d.wav from :24).

The port's copy of the reference package's ``cli/audio_segmenter.py``: the same
flags, defaults, exit codes and printed summary. Run with
``python -m synthetic_audio_detection_tpu_torch.cli.audio_segmenter``.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Split audio files into 4-second mono segments."
    )
    p.add_argument("-i", "--input", required=True,
                   help="Input directory or file path containing audio files.")
    p.add_argument("-o", "--output", required=True,
                   help="Output directory for segmented audio files.")
    p.add_argument("--workers", type=int, default=0)
    args = p.parse_args(argv)

    from synthetic_audio_detection_tpu_torch.data.etl import segment_directory

    done, errors = segment_directory(args.input, args.output, args.workers)
    print(f"Segmented {done} file(s)")
    for e in errors:
        print(f"ERROR: {e}", file=sys.stderr)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
