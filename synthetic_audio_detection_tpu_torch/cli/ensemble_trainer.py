"""Train N heads on one backbone pass over the corpus, on a GPU (the
reference package's ``cli/ensemble_trainer.py``: the same flags).

Writes ``joint_model.ckpt`` (the resume state) and its merged ensemble,
``joint_model.ckpt.merged.ckpt`` (native) and ``.merged.pth`` (the
reference's merged format), both inputs of ``cli/inference_runner.py``.
``--device`` picks the torch device (default ``cuda``); ``--device cuda``
without a usable GPU is an error, never a CPU run. Under torchrun it
trains data-parallel, as cli/submodel_trainer.py does.

Usage:
    python -m synthetic_audio_detection_tpu_torch.cli.ensemble_trainer \\
        --data-dir ./dataset --real-class Real \\
        --synthetic-classes SynthA SynthB SynthC --epochs 12 --bf16
"""

from __future__ import annotations

import argparse
import sys

from synthetic_audio_detection_tpu_torch.cli.submodel_trainer import (
    BACKBONES,
    join_group,
    rank,
    setup_logging,
)
from synthetic_audio_detection_tpu_torch.utils.config import (
    add_wave_augment_args,
    parse_input_size,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Joint multi-head ensemble training (one pass, N heads)")
    p.add_argument("--data-dir", default="./dataset", type=str)
    p.add_argument("--real-class", default="Real", type=str,
                   help="Folder name of the Real class (corpus label 0)")
    p.add_argument("--synthetic-classes", nargs="+", required=True, metavar="CLASS",
                   help="One head per class, in this order; each head's positives are its "
                   "class, its negatives Real and every other class (hard negatives)")
    p.add_argument("--batch-size", default=32, type=int,
                   help="Files per batch (each yields 2 segments)")
    p.add_argument("--epochs", default=100, type=int)
    p.add_argument("--lr", default=0.001, type=float)
    p.add_argument("--workers", default=20, type=int)
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device (cuda, cuda:N or cpu)")
    p.add_argument("--checkpoint-dir", default="./checkpoints", type=str)
    p.add_argument("--resume", default="", type=str,
                   help="Path to a joint_model.ckpt to resume from")
    p.add_argument("--model-name", default="resnet18", type=str, choices=BACKBONES)
    p.add_argument("--log-dir", default="", type=str)
    p.add_argument("--input-size", default=512, type=parse_input_size,
                   help="512 = reference fidelity; 'native' = the mel's own resolution, "
                   "no resize")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (parameters, optimizer and loss stay float32); on "
                   "the card it also selects the log-mel kernel and the int16 transport")
    p.add_argument("--mel-dft", default="", choices=("", "fft", "gemm", "factored", "pallas"),
                   help="The train and eval steps' mel DFT. Default '' = 'pallas' (the log-mel "
                   "kernel) under --bf16 on the card, 'gemm' otherwise")
    p.add_argument("--transport-dtype", default="", choices=("", "float32", "int16"))
    p.add_argument("--stop-grad-boundary", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--per-head-stages", default=0, type=int,
                   help="Trailing ResNet stages trained per head on the shared trunk (0 = a "
                   "fully shared backbone; 1 = each head owns its layer4)")
    p.add_argument("--hard-negatives", action=argparse.BooleanOptionalAction, default=True,
                   help="Default: each head's negatives are Real and every other class. "
                   "--no-hard-negatives masks each head's loss to Real and its own class")
    p.add_argument("--generic-head", action="store_true",
                   help="Train one extra Real-vs-any-synthetic head beyond the named classes")
    add_wave_augment_args(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    joined = join_group(args.device)
    try:
        return _run(args)
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()


def _run(args) -> int:
    setup_logging(rank())

    from synthetic_audio_detection_tpu_torch.train.joint import JointTrainer
    from synthetic_audio_detection_tpu_torch.utils.config import (
        SpectrogramConfig,
        TrainConfig,
        spec_augment_from_args,
    )

    cfg = TrainConfig(
        data_dir=args.data_dir,
        batch_size=args.batch_size,
        epochs=args.epochs,
        lr=args.lr,
        workers=args.workers,
        seed=args.seed,
        checkpoint_dir=args.checkpoint_dir,
        resume=args.resume,
        stop_grad_boundary=args.stop_grad_boundary,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        mel_dft=args.mel_dft,
        transport_dtype=args.transport_dtype,
    )
    spec_cfg = SpectrogramConfig(mel_norm=None, out_size=args.input_size)
    trainer = JointTrainer(
        cfg,
        synthetic_classes=args.synthetic_classes,
        real_class=args.real_class,
        model_name=args.model_name,
        spec_cfg=spec_cfg,
        augment=spec_augment_from_args(args),
        log_dir=args.log_dir or None,
        per_head_stages=args.per_head_stages,
        hard_negatives=args.hard_negatives,
        generic_head=args.generic_head,
        device=args.device,
    )
    best = trainer.fit()
    if rank() == 0:
        print(f"Best ensemble validation accuracy: {best:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
