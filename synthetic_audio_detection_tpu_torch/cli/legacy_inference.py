"""Compat CLI: the legacy 5-class analyzer on a GPU (the reference package's
``cli/legacy_inference.py``, the legacy script's flag surface:
--audio_path, --checkpoint_path, --output_dir, --confidence_threshold,
--device, --IsBatch, --parallel).

``--device`` picks the torch device (default ``cuda``); ``--device cuda``
without a usable GPU is an error, never a CPU run. Per-file results are
written to <output_dir>/<stem>.json with the legacy schema {filename,
percentages, segments[{start, end, class, confidence}]}.

    python -m synthetic_audio_detection_tpu_torch.cli.legacy_inference \\
        --checkpoint_path legacy.pth --audio_path clip.wav --output_dir out
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Legacy 5-class audio analyzer")
    p.add_argument("--audio_path", type=str, help="Path to single audio file")
    p.add_argument("--checkpoint_path", type=str, required=True,
                   help="Model checkpoint path (must be for 5 classes)")
    p.add_argument("--output_dir", type=str, default="results_json")
    p.add_argument("--confidence_threshold", type=float, default=0.45)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda, cuda:N or cpu)")
    p.add_argument("--IsBatch", type=str, default=None, help="Folder for batch mode")
    p.add_argument("--parallel", action="store_true",
                   help="Accepted for compatibility; ignored")
    p.add_argument("--model-name", type=str, default="resnet152",
                   help="Backbone (the legacy default resnet152)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 features (the model stays float32, as in the reference)")
    return p


def load_classifier(path: str, model_name: str, num_outputs: int = 5):
    """A trainer-style or BinaryClassifier-style ``.pth`` → a
    ``BinaryClassifier`` holding its weights (on the CPU)."""
    from synthetic_audio_detection_tpu_torch.checkpoints import serialization
    from synthetic_audio_detection_tpu_torch.ensemble.multihead import _load
    from synthetic_audio_detection_tpu_torch.models.classifier import BinaryClassifier

    sd, _ = serialization.load_submodel_torch(path)
    model = BinaryClassifier(model_name, num_outputs=num_outputs)
    _load(model, sd, f"{path} as a {model_name} with {num_outputs} outputs")
    return model


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")

    import torch

    from synthetic_audio_detection_tpu_torch.infer.legacy_analyzer import (
        DEFAULT_CLASSES,
        LegacyAudioAnalyzer,
    )

    analyzer = LegacyAudioAnalyzer(
        load_classifier(args.checkpoint_path, args.model_name),
        classes=DEFAULT_CLASSES,
        confidence_threshold=args.confidence_threshold,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        device=args.device,
    )
    os.makedirs(args.output_dir, exist_ok=True)

    def write(name: str, result):
        stem = os.path.splitext(os.path.basename(name))[0]
        with open(os.path.join(args.output_dir, f"{stem}.json"), "w") as f:
            json.dump({"filename": os.path.basename(name), **result}, f, indent=2)
        print(f"{name}: {result['percentages']}")

    if args.IsBatch:
        for name, result in analyzer.analyze_batch(args.IsBatch).items():
            write(name, result)
    elif args.audio_path:
        write(args.audio_path, analyzer.analyze_audio(args.audio_path))
    else:
        print("provide --audio_path or --IsBatch", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
