"""Where the device time of one serving batch goes, on one NVIDIA GPU.

    python -m synthetic_audio_detection_tpu_torch.tools.profile_serving
    python -m synthetic_audio_detection_tpu_torch.tools.profile_serving \
        --routes front-k2,front-k1,front-k1-lowp
    python -m synthetic_audio_detection_tpu_torch.tools.profile_serving --routes kernel,artifact
    python -m synthetic_audio_detection_tpu_torch.tools.profile_serving --input-size native --mono

Builds a shared-backbone ResNet-18 ensemble (3 heads, weights from
``--seed``; ``--mono`` folds its stem to one input plane with
``fold_to_mono``, the native serving default) and a batch of seeded noise
windows, serves them as one request (``analyze_windows``, one 128-window
device batch) through the bf16 ``InferencePipeline`` at ``--input-size``
(512, 256, ... or ``native``; default 512) on each route (``kernel``: the default,
``conv3x3_max_channels=512``, the 3x3 convs and 1x1 downsamples through the
hand-written conv kernel; ``knob-0``: every conv the kernel's plain
composition, a float32 cuDNN conv of the bf16 values with TF32 off, the
same numerics; the 7x7 stem is the plain composition on both;
``artifact``: the same ensemble exported on the card by infer/export.py,
bf16, int16 transport, entries 8 and 128, served by
``InferencePipeline.from_artifact``: the float32 GEMM mel and the plain
bf16 ResNet), warms it up, then traces ``--batches``
128-window batches with ``torch.profiler``. The ``front-*`` routes trace
the mel-only front end alone on the same windows, already on the card:
log-mel (``front-k2``: the strip kernel's ``fused_log_mel``; ``front-k1``:
the factored kernel; ``front-k1-lowp``: the factored kernel with
``lowp_tail``) → ``finalize_features`` at ``--input-size`` → bf16. Prints, per route,
the host wall per batch, the device's busy and idle share of that wall, and
the device time per batch by part, largest first, and by the program's
``serve.*`` range (``infer/pipeline.py``) with its host time, and the
program's feed counters over the traced batches (``serve.batches``, the
bucket rows per device batch, the share of them that are windows and not
padding), and with ``--out`` writes the same as JSON. It runs on CUDA only: without it, or with ``--device``
naming another device type, it exits non-zero.
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

from synthetic_audio_detection_tpu_torch.utils.config import parse_input_size

# (part, substrings of the device kernel's name), first match wins
PARTS: List[Tuple[str, Tuple[str, ...]]] = [
    ("H2D copy", ("Memcpy HtoD",)),
    ("D2H copy", ("Memcpy DtoH",)),
    ("conv kernel (K3)", ("conv3x3_",)),  # before "conv", which would take it
    # cuBLAS's dense GEMMs (the artifact's float32 mel DFT), before cuDNN's
    # "xmma" convolutions, whose implicit GEMMs say "fprop" or "convolve"
    ("GEMM (mel DFT)", ("xmma_gemm", "_sgemm_")),
    ("BatchNorm (eval)", ("batch_norm",)),
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


# the program's ranges (utils/profiling.span); a profiler also lays each one
# that launched device work on the device timeline, where it is no kernel
RANGE_PREFIXES = ("serve.", "train_step.")


def own_kernel_us(e) -> float:
    """Device time of the kernels that host event ``e`` itself launched."""
    return sum(k.duration for k in e.kernels if not k.name.startswith(RANGE_PREFIXES))


def kernel_us(e) -> float:
    """Device time of the kernels that ``e`` and its children launched on
    its thread."""
    return own_kernel_us(e) + sum(kernel_us(c) for c in e.cpu_children)


def feed_counts(counts: Dict[str, int]) -> Dict[str, float]:
    """The serving feed's counters (``utils/profiling.count`` in
    ``infer/pipeline.py``) → device batches, bucket rows per batch and the
    share of those rows that are windows, in %; empty without batches."""
    batches = counts.get("serve.batches", 0)
    if not batches:
        return {}
    rows = counts["serve.rows"]
    return {"device_batches": batches, "rows_per_device_batch": rows / batches,
            "useful_row_share": 100.0 * counts["serve.useful_rows"] / rows}


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

    from synthetic_audio_detection_tpu_torch.utils import profiling

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(batches):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    feed = feed_counts(profiling.counters())
    cuda = torch.autograd.DeviceType.CUDA
    device = [e for e in prof.events()
              if e.device_type == cuda and not e.name.startswith(RANGE_PREFIXES)]
    ranges = [e for e in prof.events() if e.device_type != cuda and e.name.startswith("serve.")]
    range_names = sorted({e.name for e in ranges})
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
        "device_ms_by_range": {r: sum(kernel_us(e) for e in ranges if e.name == r) / 1e3
                               / batches for r in range_names},
        "host_ms_by_range": {r: sum(e.cpu_time_total for e in ranges if e.name == r) / 1e3
                             / batches for r in range_names},
        "feed": feed,
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batches", type=int, default=3)
    p.add_argument("--routes", default="knob-0,kernel")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="", help="write the result as JSON to this file")
    p.add_argument("--input-size", type=parse_input_size, default=512,
                   help="square resize target, or native / 0")
    p.add_argument("--mono", action="store_true",
                   help="mono-folded stem (the native serving default)")
    p.add_argument("--device", default="cuda", help="a CUDA device (cuda or cuda:N)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    if torch.device(args.device).type != "cuda":
        print(f"profile_serving: runs on CUDA only, not {args.device}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("profile_serving: CUDA is not available", file=sys.stderr)
        return 1
    if torch.device(args.device).index is not None:
        torch.cuda.set_device(torch.device(args.device))
    from synthetic_audio_detection_tpu_torch.ensemble.multihead import build_ensemble, fold_to_mono
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
    if args.mono:
        ens = fold_to_mono(ens)
    windows = (np.random.default_rng(args.seed).standard_normal((128, 128_000)) * 0.1
               ).astype(np.float32)
    spec = SpectrogramConfig.inference(args.input_size)
    log_mels = {
        "front-k2": cuda_melspec_strip.fused_log_mel,
        "front-k1": cuda_melspec.fused_log_mel_factored,
        "front-k1-lowp": lambda x, c: cuda_melspec.fused_log_mel_factored(x, c, lowp_tail=True),
    }
    stamps = [(4.0 * i, 4.0 * (i + 1)) for i in range(len(windows))]
    x = torch.from_numpy(windows).to(args.device)

    def runner(route):
        if route in log_mels:
            return lambda: melspec.finalize_features(log_mels[route](x, spec), spec).to(
                torch.bfloat16)
        if route == "artifact":
            from synthetic_audio_detection_tpu_torch.infer import export

            pipe = InferencePipeline.from_artifact(export.export_serving(
                ens, spec=spec, compute_dtype=torch.bfloat16, device=args.device),
                device=args.device)
            return lambda: pipe.analyze_windows(windows, stamps)
        pipe = InferencePipeline(ens, spec=spec, infer=InferenceConfig(),
                                 compute_dtype=torch.bfloat16, device=args.device,
                                 conv3x3_max_channels={"knob-0": 0, "kernel": 512}[route])
        return lambda: pipe.analyze_windows(windows, stamps)

    size = args.input_size or "native"
    result = {"device": smi, "torch": torch.__version__, "batch": 128, "input": size,
              "mono": args.mono, "routes": {}}
    for route in args.routes.split(","):
        r = profile_route(runner(route), args.batches)
        result["routes"][route] = r
        print(f"[profile] {route}: wall {r['wall_ms_per_batch']:.3f} ms per 128-window batch at "
              f"{size}{' (mono stem)' if args.mono else ''}, "
              f"device busy {r['device_busy_ms_per_batch']:.3f} ms (idle "
              f"{100 * r['idle_share']:.1f}%); {smi}")
        for part, ms in r["device_ms_per_batch"].items():
            share = 100 * ms / r["device_ms_total_per_batch"]
            print(f"[profile] {route}:   {part:22s} {ms:8.3f} ms  {share:5.1f}%")
        for rng, ms in r["device_ms_by_range"].items():
            print(f"[profile] {route}:   {rng:22s} {ms:8.3f} ms  (host "
                  f"{r['host_ms_by_range'][rng]:.3f} ms)")
        if r["feed"]:
            f = r["feed"]
            print(f"[profile] {route}:   serve.batches {f['device_batches']}, "
                  f"{f['rows_per_device_batch']:.1f} bucket rows a batch, "
                  f"{f['useful_row_share']:.1f}% of them windows")
        for name, ms in r["top_kernels_ms_per_batch"].items():
            print(f"[profile] {route}:     {ms:8.3f} ms  {classify(name):22s} {name[:100]}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
