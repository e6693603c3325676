"""The flags and the pipeline that the study tools share
(tools/accuracy_study.py, robustness_study.py, calibrate_ensemble.py,
decision_ab.py, artifact_drive.py): a merged checkpoint served by the
port's InferencePipeline, on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys

import torch

from synthetic_audio_detection_tpu_torch.utils.config import parse_input_size


def add_pipeline_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--merged-model", required=True)
    p.add_argument("--input-size", type=parse_input_size, default=512)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--backbone", default="resnet18")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N or cpu); cuda without a GPU is an error")


def cuda_missing(tool: str, device: str) -> bool:
    """True, with the reason on stderr, when ``device`` is CUDA and there
    is none: the tools never fall back to the CPU."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print(f"{tool}: CUDA is not available (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return True
    return False


def compute_dtype(args) -> torch.dtype:
    return torch.bfloat16 if args.bf16 else torch.float32


def load_pipeline(args, **infer_kw):
    """→ (the float32 ensemble as loaded, the serving pipeline over it at
    ``--input-size``, ``--bf16``, ``--batch-size`` on ``--device``;
    ``infer_kw`` are further InferenceConfig fields)."""
    from synthetic_audio_detection_tpu_torch.checkpoints import serialization
    from synthetic_audio_detection_tpu_torch.infer.pipeline import InferencePipeline
    from synthetic_audio_detection_tpu_torch.utils.config import (
        AudioConfig,
        InferenceConfig,
        SpectrogramConfig,
    )

    ensemble = serialization.load_merged(args.merged_model, backbone=args.backbone)
    pipe = InferencePipeline(
        ensemble,
        audio=AudioConfig(),
        spec=SpectrogramConfig.inference(out_size=args.input_size),
        infer=InferenceConfig(batch_size=args.batch_size, **infer_kw),
        compute_dtype=compute_dtype(args),
        device=args.device,
    )
    return ensemble, pipe
