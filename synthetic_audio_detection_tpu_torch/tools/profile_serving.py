"""Where the device time of one serving batch goes, on one NVIDIA GPU.

    python -m synthetic_audio_detection_tpu_torch.tools.profile_serving
    python -m synthetic_audio_detection_tpu_torch.tools.profile_serving \
        --routes front-k2,front-k1,front-k1-lowp

Builds a shared-backbone ResNet-18 ensemble (3 heads, weights from
``--seed``) and a batch of seeded noise windows, runs the bf16
``InferencePipeline`` at 512² on each route (``kernel``: the default,
``conv3x3_max_channels=512``, the 3x3 convs and 1x1 downsamples through the
hand-written conv kernel; ``knob-0``: every conv the kernel's plain
composition, a float32 cuDNN conv of the bf16 values with TF32 off, the
same numerics; the 7x7 stem is the plain composition on both), warms it
up, then traces ``--batches``
128-window batches with ``torch.profiler``. The ``front-*`` routes trace
the mel-only front end alone on the same windows, already on the card:
log-mel (``front-k2``: the strip kernel's ``fused_log_mel``; ``front-k1``:
the factored kernel; ``front-k1-lowp``: the factored kernel with
``lowp_tail``) → ``finalize_features`` at 512² → bf16. Prints, per route,
the host wall per batch, the device's busy and idle share of that wall, and
the device time per batch by part, largest first, and with ``--out`` writes
the same as JSON. Without CUDA it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Tuple

import numpy as np

# (part, substrings of the device kernel's name), first match wins
PARTS: List[Tuple[str, Tuple[str, ...]]] = [
    ("H2D copy", ("Memcpy HtoD",)),
    ("D2H copy", ("Memcpy DtoH",)),
    ("conv kernel (K3)", ("conv3x3_",)),  # before "conv", which would take it
    ("K1 log-mel kernel", ("pad_bf16_kernel", "dft_mel_kernel", "db_standardize_kernel")),
    ("K2 log-mel kernel", ("strip_bf16_kernel", "strip_dft_kernel", "strip_tail_kernel")),
    ("max-pool", ("max_pool",)),
    ("resize", ("upsample", "bilinear", "interpolate")),
    ("cuDNN convolutions", ("conv", "xmma", "implicit", "cudnn", "fprop", "nhwc", "nchw")),
    ("heads (GEMM)", ("gemm", "gemv", "cutlass", "bmm")),
    ("multiply (BN scale)", ("mul",)),
    ("add (BN bias, residual)", ("add",)),
    ("ReLU", ("clamp", "relu", "threshold")),
    ("mean (pooling)", ("reduce", "mean")),
    ("casts and copies", ("copy", "to_copy", "cast", "direct_copy")),
]


def classify(name: str) -> str:
    low = name.lower()
    for part, keys in PARTS:
        if any(k.lower() in low for k in keys):
            return part
    return "other"


def busy_us(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def profile_route(run, batches: int) -> Dict:
    """Trace ``batches`` calls of ``run()`` (one batch each) after warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(batches):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        raise RuntimeError("the profiler recorded no device activity")
    parts: Dict[str, float] = {}
    names: Dict[str, float] = {}
    for e in device:
        ms = e.time_range.elapsed_us() / 1e3 / batches
        part = classify(e.name)
        parts[part] = parts.get(part, 0.0) + ms
        names[e.name] = names.get(e.name, 0.0) + ms
    busy_ms = busy_us([(e.time_range.start, e.time_range.end) for e in device]) / 1e3
    total = sum(parts.values())
    return {
        "wall_ms_per_batch": wall_ms / batches,
        "device_busy_ms_per_batch": busy_ms / batches,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "device_ms_per_batch": dict(sorted(parts.items(), key=lambda kv: -kv[1])),
        "device_ms_total_per_batch": total,
        "top_kernels_ms_per_batch": dict(sorted(names.items(), key=lambda kv: -kv[1])[:15]),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batches", type=int, default=3)
    p.add_argument("--routes", default="knob-0,kernel")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="", help="write the result as JSON to this file")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_serving: CUDA is not available", file=sys.stderr)
        return 1
    from synthetic_audio_detection_tpu_torch.ensemble.multihead import build_ensemble
    from synthetic_audio_detection_tpu_torch.infer.pipeline import InferencePipeline
    from synthetic_audio_detection_tpu_torch.models.classifier import BinaryClassifier
    from synthetic_audio_detection_tpu_torch.ops import cuda_melspec, cuda_melspec_strip, melspec
    from synthetic_audio_detection_tpu_torch.utils.config import InferenceConfig, SpectrogramConfig

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.manual_seed(args.seed)
    base = {k: v for k, v in BinaryClassifier("resnet18").state_dict().items()
            if k.startswith("base.")}
    sds = [{**base, **{k: v for k, v in BinaryClassifier("resnet18").state_dict().items()
                       if k.startswith("head.")}} for _ in range(3)]
    ens = build_ensemble(sds, ["SynA", "SynB", "SynC", "Real"])
    windows = (np.random.default_rng(args.seed).standard_normal((128, 128_000)) * 0.1
               ).astype(np.float32)
    spec = SpectrogramConfig.inference(512)
    log_mels = {
        "front-k2": cuda_melspec_strip.fused_log_mel,
        "front-k1": cuda_melspec.fused_log_mel_factored,
        "front-k1-lowp": lambda x, c: cuda_melspec.fused_log_mel_factored(x, c, lowp_tail=True),
    }
    x = torch.from_numpy(windows).cuda()

    def runner(route):
        if route in log_mels:
            return lambda: melspec.finalize_features(log_mels[route](x, spec), spec).to(
                torch.bfloat16)
        pipe = InferencePipeline(ens, spec=spec, infer=InferenceConfig(),
                                 compute_dtype=torch.bfloat16, device="cuda",
                                 conv3x3_max_channels={"knob-0": 0, "kernel": 512}[route])
        return lambda: pipe.logits_for_windows(windows)

    result = {"device": smi, "torch": torch.__version__, "batch": 128, "input": 512,
              "routes": {}}
    for route in args.routes.split(","):
        r = profile_route(runner(route), args.batches)
        result["routes"][route] = r
        print(f"[profile] {route}: wall {r['wall_ms_per_batch']:.3f} ms per 128-window batch, "
              f"device busy {r['device_busy_ms_per_batch']:.3f} ms (idle "
              f"{100 * r['idle_share']:.1f}%); {smi}")
        for part, ms in r["device_ms_per_batch"].items():
            share = 100 * ms / r["device_ms_total_per_batch"]
            print(f"[profile] {route}:   {part:22s} {ms:8.3f} ms  {share:5.1f}%")
        for name, ms in r["top_kernels_ms_per_batch"].items():
            print(f"[profile] {route}:     {ms:8.3f} ms  {classify(name):22s} {name[:100]}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
