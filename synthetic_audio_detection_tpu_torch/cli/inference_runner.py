"""Multi-head inference on one audio file or a folder, on a GPU (the
reference package's ``cli/inference_runner.py``: the same flags, the same
stdout and JSON contract).

``--device`` picks the torch device (default ``cuda``); ``--device cuda``
without a usable GPU is an error, never a CPU run.

Usage:
    python -m synthetic_audio_detection_tpu_torch.cli.inference_runner \\
        --merged-model merged.pth --audio clip.wav --output-json out.json --bf16
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from synthetic_audio_detection_tpu_torch.utils.config import parse_input_size


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Multi-head inference with overlapping windows using "
        "metadata from the merged model.")
    p.add_argument("--merged-model", type=str, required=True,
                   help="Path to the merged .pth checkpoint")
    p.add_argument("--audio", type=str, help="Path to WAV file")
    p.add_argument("--audio-dir", type=str,
                   help="Folder mode: analyze every audio file in the directory "
                   "through one pipeline; writes <stem>.json per file into "
                   "--output-json (treated as a directory). Mutually exclusive "
                   "with --audio.")
    p.add_argument("--threshold", type=float, default=0.5,
                   help="Threshold for deciding Real vs Synthetic")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda, cuda:N or cpu)")
    p.add_argument("--confidence-threshold", type=float, default=0.45,
                   help="Confidence threshold for segments.")
    p.add_argument("--smooth", action="store_true", help="Apply smoothing across windows.")
    p.add_argument("--output-json", type=str, default="results.json")
    p.add_argument("--backbone", type=str, default="resnet18")
    p.add_argument("--overlap", type=float, default=0.0,
                   help="Window overlap fraction (reference main uses 0.0)")
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (the log-mel kernel front end on CUDA)")
    p.add_argument("--input-size", type=parse_input_size, default=512,
                   help="Spectrogram image size: 512 (reference fidelity), 256, "
                   "or 'native' (the mel's own 128-by-frames resolution)")
    p.add_argument("--per-head-diagnostics", action="store_true",
                   help="Log each window's per-head [real, synthetic] sigmoids. "
                   "Output JSON is unchanged.")
    p.add_argument("--round-floats", action="store_true",
                   help="Round JSON floats (3 dp timestamps, 2 dp percentages).")
    p.add_argument("--no-calibration", action="store_true",
                   help="Ignore checkpoint-carried temperature calibration.")
    p.add_argument("--syn-override-k", type=int, default=1,
                   help="Synthetic columns that must clear their threshold to "
                   "override a Real verdict (1 = the reference's unanimity rule).")
    p.add_argument("--per-column-thresholds", action="store_true",
                   help="Use the checkpoint calibration's per-column operating "
                   "points instead of the single --threshold.")
    p.add_argument("--generic-verdict", action="store_true",
                   help="Decide Real/Synthetic from the generic "
                   "Real-vs-any-synthetic head; the JSON schema is unchanged.")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if bool(args.audio) == bool(args.audio_dir):
        parser.error("exactly one of --audio / --audio-dir is required")
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")

    import numpy as np
    import torch

    from synthetic_audio_detection_tpu_torch.utils.config import (
        AudioConfig,
        InferenceConfig,
        SpectrogramConfig,
    )
    from synthetic_audio_detection_tpu_torch.checkpoints import serialization
    from synthetic_audio_detection_tpu_torch.infer.pipeline import (
        InferencePipeline,
        preprocess_waveform,
        result_json,
        slice_waveform,
    )

    ensemble = serialization.load_merged(args.merged_model, backbone=args.backbone)
    print("Using metadata names:")
    print("Synthetic names:", ensemble.synthetic_names)
    print("Real name:", ensemble.real_name)

    pipeline = InferencePipeline(
        ensemble,
        audio=AudioConfig(overlap=args.overlap, silence_threshold=1e-3),
        spec=SpectrogramConfig.inference(out_size=args.input_size),
        infer=InferenceConfig(
            threshold=args.threshold,
            confidence_threshold=args.confidence_threshold,
            smooth=args.smooth,
            batch_size=args.batch_size,
            round_floats=args.round_floats,
            apply_calibration=not args.no_calibration,
            syn_override_k=args.syn_override_k,
            per_column_thresholds=args.per_column_thresholds,
            generic_verdict=args.generic_verdict,
        ),
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        device=args.device,
    )

    def run_one(audio_path: str, display_name: str = ""):
        """→ (JSON text, had_windows). ``display_name`` replaces the JSON
        "filename" (folder mode writes the basename; single-file mode the
        path as passed)."""
        windows, stamps = slice_waveform(preprocess_waveform(audio_path, pipeline.audio),
                                         pipeline.audio)
        if args.per_head_diagnostics and windows.shape[0]:
            logits, nh = pipeline.logits_and_per_head(windows)
            result = pipeline.analyze_windows(windows, stamps, smooth=args.smooth,
                                              logits=logits)
            probs = 1.0 / (1.0 + np.exp(-nh))  # [num, N, 2]
            names = ensemble.synthetic_names
            for (s, e), row in zip(stamps, probs):
                cells = ", ".join(f"{n}: real={row[i][0]:.3f} syn={row[i][1]:.3f}"
                                  for i, n in enumerate(names))
                logging.info("per-head %6.2f-%6.2fs  %s", s, e, cells)
        else:
            result = pipeline.analyze_windows(windows, stamps, smooth=args.smooth)
        return result_json(display_name or audio_path, result), bool(windows.shape[0])

    if args.audio_dir:
        if os.path.exists(args.output_json) and not os.path.isdir(args.output_json):
            parser.error(f"--output-json {args.output_json!r} exists and is a file; "
                         "folder mode writes per-file JSONs into it as a directory")
        exts = (".wav", ".mp3", ".flac", ".ogg", ".aac", ".wma", ".opus")
        files = sorted(f for f in os.listdir(args.audio_dir) if f.lower().endswith(exts))
        if not files:
            logging.warning("no audio files in %s", args.audio_dir)
        os.makedirs(args.output_json, exist_ok=True)
        stems: dict = {}
        for name in files:
            stems.setdefault(os.path.splitext(name)[0], []).append(name)

        def out_name(name: str) -> str:
            stem, ext = os.path.splitext(name)
            return f"{stem}{ext}.json" if len(stems[stem]) > 1 else stem + ".json"

        failed = 0
        for name in files:
            try:
                payload, _ = run_one(os.path.join(args.audio_dir, name), display_name=name)
            except Exception as e:  # noqa: BLE001 - per-file isolation, reported
                logging.error("FAILED %s: %r", name, e)
                failed += 1
                continue
            out = os.path.join(args.output_json, out_name(name))
            with open(out, "w", encoding="utf-8") as f:
                f.write(payload)
            logging.info("wrote %s", out)
        print(f"Analyzed {len(files) - failed}/{len(files)} files -> {args.output_json}")
        return 1 if failed else 0

    payload, had_windows = run_one(args.audio)
    with open(args.output_json, "w", encoding="utf-8") as f:
        f.write(payload)
    if not had_windows:
        print("No valid audio chunks found (all below silence threshold). Exiting.")
        return 0
    print("Wrote results to", args.output_json)
    print(payload)
    return 0


if __name__ == "__main__":
    sys.exit(main())
