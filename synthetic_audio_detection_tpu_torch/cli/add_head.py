"""Grow one class onto a merged artifact, on a GPU (the reference
package's ``cli/add_head.py``: the same flags).

The artifact's shared backbone is frozen (bit-identical before and after,
so existing verdicts cannot move) and one new binary head trains against
it, then is spliced into the ensemble and its metadata
(``train/add_head.py``). Writes ``--output`` (native) and its ``.pth``
twin, inputs of ``cli/inference_runner.py``. ``--device`` picks the torch
device (default ``cuda``); ``--device cuda`` without a usable GPU is an
error, never a CPU run.

Usage:
    python -m synthetic_audio_detection_tpu_torch.cli.add_head \\
        --merged-model merged.ckpt --data-dir ./dataset \\
        --new-class SynthD --epochs 4 --bf16 --output merged_plus_SynthD.ckpt
"""

from __future__ import annotations

import argparse
import sys

from synthetic_audio_detection_tpu_torch.cli.submodel_trainer import setup_logging
from synthetic_audio_detection_tpu_torch.utils.config import parse_input_size


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train one new head against a frozen merged-artifact trunk and splice it "
                    "into the ensemble")
    p.add_argument("--merged-model", required=True,
                   help="existing merged artifact (.ckpt native or .pth)")
    p.add_argument("--data-dir", default="./dataset", type=str,
                   help="dataset tree with train/ and test/ class folders (must contain the "
                   "new class and the real class)")
    p.add_argument("--new-class", required=True)
    p.add_argument("--real-class", default="Real", type=str)
    p.add_argument("--output", required=True,
                   help="path for the grown artifact (.ckpt; a .pth twin is written alongside)")
    p.add_argument("--epochs", default=4, type=int)
    p.add_argument("--batch-size", default=32, type=int,
                   help="files per batch (2 segments per file)")
    p.add_argument("--lr", default=0.001, type=float)
    p.add_argument("--workers", default=20, type=int)
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--backbone", default="resnet18")
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device (cuda, cuda:N or cpu)")
    p.add_argument("--input-size", default=512, type=parse_input_size,
                   help="512/256/native: must match how the artifact is served (the trunk is "
                   "frozen; its features must look like what it was trained on)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute; on the card it also selects the log-mel kernel")
    p.add_argument("--mel-dft", default="", choices=["", "fft", "gemm", "factored", "pallas"])
    p.add_argument("--hard-negatives", action=argparse.BooleanOptionalAction, default=True,
                   help="Default: other class folders are extra negatives for the new head; "
                   "--no-hard-negatives trains Real against the new class only")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    setup_logging()

    from synthetic_audio_detection_tpu_torch.checkpoints import serialization
    from synthetic_audio_detection_tpu_torch.train.add_head import HeadAdder
    from synthetic_audio_detection_tpu_torch.utils.config import SpectrogramConfig, TrainConfig

    ensemble = serialization.load_merged(args.merged_model, backbone=args.backbone)
    cfg = TrainConfig(
        data_dir=args.data_dir,
        batch_size=args.batch_size,
        epochs=args.epochs,
        lr=args.lr,
        workers=args.workers,
        seed=args.seed,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        mel_dft=args.mel_dft,
    )
    adder = HeadAdder(ensemble, args.new_class, cfg,
                      spec_cfg=SpectrogramConfig(mel_norm=None, out_size=args.input_size),
                      real_class=args.real_class, hard_negatives=args.hard_negatives,
                      model_name=args.backbone, device=args.device)
    best = adder.fit(args.data_dir)
    grown = adder.spliced()
    serialization.save_merged_native(args.output, grown)
    serialization.save_merged_torch(args.output.removesuffix(".ckpt") + ".pth", grown)
    print(f"Best new-head validation accuracy: {best:.4f}")
    print(f"Grown ensemble: {grown.class_names} -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
