"""Serving daemon CLI: one warm ensemble on the GPU behind an HTTP JSON API
(infer/server.py; the reference package's ``cli/serve.py``, the same
flags).

``--device`` picks the torch device (default ``cuda``); ``--device cuda``
without a usable GPU is an error, never a CPU run. ``--artifact`` serves an
exported artifact (infer/export.py) instead of a checkpoint: its compute
dtype, input size and batch entries were fixed at export, so ``--bf16``,
``--input-size`` and ``--batch-size`` are ignored with a warning, while
``--overlap``, ``--threshold`` and ``--no-calibration`` (host side) hold.

    python -m synthetic_audio_detection_tpu_torch.cli.serve \\
        --merged-model merged.pth --port 8321 --bf16
    python -m synthetic_audio_detection_tpu_torch.cli.serve --artifact merged.sadpt
"""

from __future__ import annotations

import argparse
import logging
import sys

from synthetic_audio_detection_tpu_torch.utils.config import parse_input_size


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Synthetic-audio detection server")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--merged-model", help="merged checkpoint (.pth or native msgpack)")
    src.add_argument("--artifact",
                     help="serve from an exported artifact (infer/export.py): no model code "
                     "or checkpoint at load time")
    p.add_argument("--backbone", default="resnet18")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8321)
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--overlap", type=float, default=0.0)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (the log-mel kernel front end on CUDA, and the conv "
                   "kernel on a shared backbone)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda, cuda:N or cpu)")
    p.add_argument("--no-warmup", action="store_true")
    p.add_argument("--no-micro-batch", action="store_true",
                   help="dispatch each request's windows alone instead of coalescing "
                   "concurrent requests into shared device batches (infer/batching.py)")
    p.add_argument("--linger-ms", type=float, default=0.0,
                   help="micro-batching: wait up to this long for more requests before "
                   "dispatching an idle-device batch (0 = drain-and-go; the device's own "
                   "execution time already accumulates the next burst)")
    p.add_argument("--stream-ttl", type=float, default=300.0,
                   help="live /stream sessions: evict after this many seconds idle")
    p.add_argument("--max-streams", type=int, default=32,
                   help="max concurrent live /stream sessions (429 beyond)")
    p.add_argument("--input-size", type=parse_input_size, default=512,
                   help="Spectrogram image size: 512 (reference fidelity), 256, or 'native'")
    p.add_argument("--no-calibration", action="store_true",
                   help="Ignore checkpoint-carried temperature calibration; uncalibrated "
                   "models are unaffected either way")
    return p


def build_pipeline(args):
    """→ (the pipeline the flags ask for, what it serves)."""
    import torch

    from synthetic_audio_detection_tpu_torch.infer.pipeline import InferencePipeline
    from synthetic_audio_detection_tpu_torch.utils.config import (
        AudioConfig,
        InferenceConfig,
        SpectrogramConfig,
    )

    if args.artifact:
        if args.bf16 or args.input_size != 512 or args.batch_size != 128:
            logging.warning("--bf16/--input-size/--batch-size are baked into the artifact at "
                            "export time; ignoring the CLI values")
        # --overlap and --threshold stay host-side (windowing, decision rule)
        pipeline = InferencePipeline.from_artifact(
            args.artifact, audio=AudioConfig(overlap=args.overlap),
            infer=InferenceConfig(threshold=args.threshold,
                                  apply_calibration=not args.no_calibration),
            device=args.device)
        return pipeline, args.artifact

    from synthetic_audio_detection_tpu_torch.checkpoints import serialization

    ensemble = serialization.load_merged(args.merged_model, backbone=args.backbone)
    pipeline = InferencePipeline(
        ensemble,
        audio=AudioConfig(overlap=args.overlap),
        spec=SpectrogramConfig.inference(out_size=args.input_size),
        infer=InferenceConfig(threshold=args.threshold, batch_size=args.batch_size,
                              apply_calibration=not args.no_calibration),
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        device=args.device,
    )
    return pipeline, args.merged_model


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")

    from synthetic_audio_detection_tpu_torch.infer.server import serve

    pipeline, source = build_pipeline(args)
    server = serve(pipeline, args.host, args.port, warmup=not args.no_warmup,
                   micro_batch=not args.no_micro_batch, linger_ms=args.linger_ms,
                   stream_ttl=args.stream_ttl, max_streams=args.max_streams)
    logging.info("serving %s on http://%s:%d (classes: %s)", source, args.host,
                 server.server_address[1], pipeline.ensemble.class_names)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        server.serving_state.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
