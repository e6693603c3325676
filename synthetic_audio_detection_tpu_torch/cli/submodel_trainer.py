"""Train one binary sub-model (Real vs one synthetic class) on a GPU (the
reference package's ``cli/submodel_trainer.py``: the same flags).

``--device`` picks the torch device (default ``cuda``); ``--device cuda``
without a usable GPU is an error, never a CPU run. ``--gpu`` and
``--num_gpus`` are accepted and ignored, as in the reference package. Not
ported, and refused with a message: ``--s2d-layer1`` (the space-to-depth
stage 1 works around the TPU's conv emitter).

Usage:
    python -m synthetic_audio_detection_tpu_torch.cli.submodel_trainer \\
        --data-dir ./dataset --Class0 Real --Class1 SynthA --epochs 30 --bf16

Data-parallel over N cards (train/trainer.py): the same command under
torchrun, one process a card, which joins the group from torchrun's
variables (NCCL; gloo with ``--device cpu``); only rank 0 logs and writes:
    torchrun --nproc-per-node N -m synthetic_audio_detection_tpu_torch.cli.submodel_trainer ...
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

from synthetic_audio_detection_tpu_torch.models.resnet import RESNET_SPECS
from synthetic_audio_detection_tpu_torch.utils.config import (
    add_wave_augment_args,
    parse_input_size,
)

BACKBONES = tuple(sorted(RESNET_SPECS))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Audio Classification Training")
    p.add_argument("--data-dir", default="./dataset", type=str, help="Path to dataset")
    p.add_argument("--batch-size", default=32, type=int,
                   help="Batch size (files; each file yields 2 segments)")
    p.add_argument("--epochs", default=100, type=int, help="Number of total epochs to run")
    p.add_argument("--lr", default=0.001, type=float, help="Initial learning rate")
    p.add_argument("--workers", default=20, type=int, help="Number of data loading workers")
    p.add_argument("--seed", default=42, type=int, help="Seed for initializing training.")
    p.add_argument("--gpu", default=0, type=int, help="Ignored (reference compatibility)")
    p.add_argument("--num_gpus", default=1, type=int, help="Ignored (one device)")
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device (cuda, cuda:N or cpu)")
    p.add_argument("--checkpoint-dir", default="./checkpoints", type=str)
    p.add_argument("--resume", default="", type=str, help="Path to resume checkpoint")
    p.add_argument("--evaluate", action="store_true", help="Evaluate model on validation set")
    p.add_argument("--Class0", default="Real", type=str, help="Name of Class 0 eg. Real")
    p.add_argument("--Class1", default="Class1", type=str,
                   help="Name of Class 1 eg. Training platform")
    p.add_argument("--hard-negative-classes", nargs="*", default=[], metavar="CLASS",
                   help="Additional class folders trained as Class0 (hard negatives): the "
                   "head then answers 'this generator?' instead of 'synthetic?'")
    p.add_argument("--model-name", default="resnet18", type=str, choices=BACKBONES)
    p.add_argument("--log-dir", default="", type=str,
                   help="TensorBoard log dir (default runs/experiment_<ts>)")
    p.add_argument("--input-size", default=512, type=parse_input_size,
                   help="Spectrogram image size (512 = reference fidelity; 'native' trains "
                   "at the mel's own 128-by-frames resolution with no resize)")
    p.add_argument("--s2d-layer1", action=argparse.BooleanOptionalAction, default=None,
                   help="Not ported (the space-to-depth stage 1 works around the TPU "
                   "conv emitter); --s2d-layer1 is refused")
    p.add_argument("--data-backend", default="threads", choices=("threads", "grain"),
                   help="Input pipeline: thread pool (default) or worker processes "
                   "(a torch DataLoader)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute in the train step (parameters, optimizer, loss "
                   "and BN statistics stay float32); on the card it also selects the "
                   "log-mel kernel and the int16 transport")
    p.add_argument("--mel-dft", default="", choices=("", "fft", "gemm", "factored", "pallas"),
                   help="The train step's mel DFT. Default '' = 'pallas' under --bf16 on the "
                   "card, 'gemm' otherwise; 'pallas' = the log-mel kernel "
                   "(ops/cuda_melspec.py) in dB-only mode")
    p.add_argument("--transport-dtype", default="", choices=("", "float32", "int16"),
                   help="Host-to-device waveform transport. Default '' = int16 under --bf16 "
                   "on the card, float32 otherwise (int16 is exact for PCM_16 sources)")
    p.add_argument("--stop-grad-boundary", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="No backward pass through the frozen stages (identical updates). "
                   "Default: on.")
    p.add_argument("--reference-quirk-loss", action="store_true",
                   help="Reproduce the reference trainer's head-not-in-loss bug exactly "
                   "(CE over pooled backbone features)")
    p.add_argument("--reference-quirk-frozen-layer3", action="store_true",
                   help="Reproduce the reference's layer3-unfreeze no-op exactly (its "
                   "optimizer never holds layer3)")
    add_wave_augment_args(p)
    return p


def setup_logging(rank: int = 0) -> None:
    """File and console logging (logs/train_<ts>.log, as the reference); a
    rank other than 0 logs warnings to the console only."""
    if rank:
        logging.basicConfig(level=logging.WARNING,
                            format=f"%(asctime)s rank {rank} %(levelname)s %(message)s")
        return
    os.makedirs("logs", exist_ok=True)
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s",
        handlers=[logging.FileHandler(os.path.join("logs", f"train_{int(time.time())}.log")),
                  logging.StreamHandler()])


def join_group(device: str) -> bool:
    """Join torchrun's group when this process is one of several (NCCL, or
    gloo for ``--device cpu``); → whether this call joined it (and the
    caller leaves it at the end)."""
    import torch.distributed as dist

    from synthetic_audio_detection_tpu_torch.parallel.sharding import initialize_distributed

    was = dist.is_initialized()
    initialize_distributed(backend="gloo" if device == "cpu" else "nccl")
    return dist.is_initialized() and not was


def rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.s2d_layer1:
        parser.error("--s2d-layer1 is not ported: the space-to-depth stage 1 works around "
                     "the TPU conv emitter and has no GPU counterpart")
    joined = join_group(args.device)
    try:
        return _run(args)
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()


def _run(args) -> int:
    setup_logging(rank())

    from synthetic_audio_detection_tpu_torch.train.trainer import Trainer
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
        class0=args.Class0,
        class1=args.Class1,
        hard_negative_classes=tuple(args.hard_negative_classes),
        data_backend=args.data_backend,
        stop_grad_boundary=args.stop_grad_boundary,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        mel_dft=args.mel_dft,
        transport_dtype=args.transport_dtype,
        reference_quirk_frozen_layer3=args.reference_quirk_frozen_layer3,
    )
    spec_cfg = SpectrogramConfig(mel_norm=None, out_size=args.input_size)
    trainer = Trainer(cfg, model_name=args.model_name, spec_cfg=spec_cfg,
                      augment=spec_augment_from_args(args), log_dir=args.log_dir or None,
                      reference_quirk_loss=args.reference_quirk_loss, device=args.device)
    if args.evaluate:
        trainer.evaluate()
        return 0
    best = trainer.fit()
    if rank() == 0:
        print(f"Best validation accuracy: {best:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
