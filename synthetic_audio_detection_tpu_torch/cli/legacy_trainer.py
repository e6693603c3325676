"""Compat CLI: the legacy single-model 5-class trainer on a GPU (the
reference package's ``cli/legacy_trainer.py``, the legacy train script's
flag surface). Differences from the submodel trainer: the five fixed
classes ['Real', 'class1'..'class4'], a default lr of 1e-4, and a
checkpoint every epoch, named epoch_{e}_acc_{a:.2f}.ckpt (with its .pth
twin), beside the best-only one. It drives ``train/trainer.Trainer`` in
float32 with the training mel (no mel norm).

``--device`` picks the torch device (default ``cuda``); ``--device cuda``
without a usable GPU is an error, never a CPU run. The legacy script's
default --model-name, 'resnet151', is no valid model; resnet152 is meant.

    python -m synthetic_audio_detection_tpu_torch.cli.legacy_trainer \\
        --data-dir ./dataset --epochs 30
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

from synthetic_audio_detection_tpu_torch.models.resnet import RESNET_SPECS
from synthetic_audio_detection_tpu_torch.utils.config import parse_input_size

BACKBONES = tuple(sorted(RESNET_SPECS))
LEGACY_CLASSES = ["Real", "class1", "class2", "class3", "class4"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Legacy 5-class Audio Classification Training")
    p.add_argument("--data-dir", default="./dataset", type=str)
    p.add_argument("--batch-size", default=32, type=int)
    p.add_argument("--epochs", default=30, type=int)
    p.add_argument("--lr", default=0.0001, type=float)
    p.add_argument("--workers", default=1, type=int)
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--gpu", default=0, type=int, help="Ignored")
    p.add_argument("--num_gpus", default=1, type=int, help="Ignored")
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device (cuda, cuda:N or cpu)")
    p.add_argument("--checkpoint-dir", default="./checkpoints", type=str)
    p.add_argument("--resume", default="", type=str)
    p.add_argument("--evaluate", action="store_true")
    p.add_argument("--model-name", default="resnet152", type=str, choices=BACKBONES)
    p.add_argument("--input-size", default=512, type=parse_input_size)
    p.add_argument("--classes", nargs="*", default=LEGACY_CLASSES,
                   help="Class folder names (default the legacy 5)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    os.makedirs("logs", exist_ok=True)
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s",
        handlers=[logging.FileHandler(os.path.join("logs",
                                                   f"legacy_train_{int(time.time())}.log")),
                  logging.StreamHandler()])

    from synthetic_audio_detection_tpu_torch.train.trainer import Trainer
    from synthetic_audio_detection_tpu_torch.utils.config import SpectrogramConfig, TrainConfig

    cfg = TrainConfig(data_dir=args.data_dir, batch_size=args.batch_size, epochs=args.epochs,
                      lr=args.lr, workers=args.workers, seed=args.seed,
                      checkpoint_dir=args.checkpoint_dir, resume=args.resume)
    trainer = Trainer(cfg, model_name=args.model_name,
                      spec_cfg=SpectrogramConfig(mel_norm=None, out_size=args.input_size),
                      class_names=list(args.classes), device=args.device)
    if args.evaluate:
        trainer.evaluate()
        return 0
    # the legacy behaviour: save EVERY epoch as epoch_{e}_acc_{a:.2f}, from
    # the validate hook that Trainer.fit calls once per epoch
    validate = trainer.validate

    def validate_and_save(batcher, epoch):
        result = validate(batcher, epoch)
        os.makedirs(cfg.checkpoint_dir, exist_ok=True)
        trainer.save_checkpoint(
            epoch, os.path.join(cfg.checkpoint_dir, f"epoch_{epoch}_acc_{result.val_acc:.2f}.ckpt"))
        return result

    trainer.validate = validate_and_save
    best = trainer.fit()
    print(f"Best validation accuracy: {best:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
