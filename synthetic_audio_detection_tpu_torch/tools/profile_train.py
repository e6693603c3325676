"""Where the time of one submodel train step goes, on one NVIDIA GPU.

    python -m synthetic_audio_detection_tpu_torch.tools.profile_train --out profile.json

Builds the bf16 ``Trainer`` at 512² (ResNet-18, flax's default init from
``--seed``) and one batch of ``--rows`` seeded int16 noise windows on the
card, the trainer's own input (the log-mel kernel front end, int16
transport). Per phase (1: the gradient stops at stage 4; 2: at stage 3,
after layer3 unfreezes) it times the step with CUDA events (median of 20
back-to-back steps after warm-up), the host wall per step with a
synchronise after each, and traces ``--steps`` steps with ``torch.profiler``:
the device's busy and idle share of the wall, the device time of the
step's ``record_function`` parts (``train_step.features``, ``.forward``,
``.optimizer``; the rest is the backward, which runs on autograd's device
thread) with their host time, the tensors allocated a step, and the device
time by kind of kernel. Prints it all and with
``--out`` writes it as JSON. Without CUDA it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict

import numpy as np

from synthetic_audio_detection_tpu_torch.tools.profile_serving import busy_us, classify

RANGES = ("train_step.features", "train_step.forward", "train_step.optimizer")
# the step's own kinds of kernel, before profile_serving's table
TRAIN_PARTS = [
    ("multi-tensor (optimizer)", ("multi_tensor_apply",)),
    ("concatenate", ("CatArrayBatchedCopy",)),
    ("subtract", ("sub",)),
    ("where (NaN-skip)", ("where",)),
    ("divide, sqrt, rsqrt, pow", ("div", "sqrt", "rsqrt", "pow")),
    ("fill (zeros)", ("fill",)),
    ("cuDNN backward", ("dgrad", "wgrad", "bprop")),
]


def kind(name: str) -> str:
    low = name.lower()
    for part, keys in TRAIN_PARTS:
        if any(k.lower() in low for k in keys):
            return part
    return classify(name)


def trace(step, steps: int) -> Dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    # the ranges appear on the device timeline too, as annotations: kernels only
    device = [e for e in events if e.device_type == cuda and e.name not in RANGES]
    if not device:
        raise RuntimeError("the profiler recorded no device activity")
    total = sum(e.time_range.elapsed_us() for e in device) / 1e3 / steps
    ranges = {r: sum(e.device_time_total for e in events
                     if e.name == r and e.device_type != cuda) / 1e3 / steps for r in RANGES}
    ranges["backward and the rest"] = total - sum(ranges.values())
    host_ms = {r: sum(e.cpu_time_total for e in events
                      if e.name == r and e.device_type != cuda) / 1e3 / steps for r in RANGES}
    allocations = sum(e.name in ("aten::empty", "aten::empty_strided")
                      for e in events if e.device_type != cuda) / steps
    kinds: Dict[str, float] = {}
    names: Dict[str, float] = {}
    for e in device:
        ms = e.time_range.elapsed_us() / 1e3 / steps
        kinds[kind(e.name)] = kinds.get(kind(e.name), 0.0) + ms
        names[e.name] = names.get(e.name, 0.0) + ms
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in device]) / 1e3
    return {"wall_ms_per_step": wall_ms / steps, "device_busy_ms_per_step": busy / steps,
            "idle_share": 1.0 - busy / wall_ms, "device_ms_total_per_step": total,
            "device_ms_by_part": ranges, "host_ms_by_part": host_ms,
            "tensor_allocations_per_step": allocations,
            "device_ms_by_kind": dict(sorted(kinds.items(), key=lambda kv: -kv[1])),
            "top_kernels_ms_per_step": dict(sorted(names.items(), key=lambda kv: -kv[1])[:20]),
            "kernels_per_step": len(device) / steps}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rows", type=int, default=32)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="", help="write the result as JSON to this file")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_train: CUDA is not available", file=sys.stderr)
        return 1
    from synthetic_audio_detection_tpu_torch.train.trainer import Trainer
    from synthetic_audio_detection_tpu_torch.utils.config import SpectrogramConfig, TrainConfig

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cfg = TrainConfig(batch_size=args.rows // 2, compute_dtype="bfloat16", seed=args.seed)
    log_dir = tempfile.mkdtemp(prefix="profile_train_")  # the trainer's scalars, unused
    tr = Trainer(cfg, spec_cfg=SpectrogramConfig(mel_norm=None, out_size=512),
                 log_dir=log_dir, device="cuda")
    audio = np.random.default_rng(args.seed).standard_normal((args.rows, 128_000)) * 0.1
    batch = {"audio": torch.from_numpy(np.round(audio * 32768).astype(np.int16)).cuda(),
             "label": torch.arange(args.rows, device="cuda") % 2,
             "weight": torch.ones(args.rows, device="cuda")}

    def step():
        return tr._train_step(tr.state, batch, tr.generator)

    result = {"device": smi, "torch": torch.__version__, "rows": args.rows, "input": 512,
              "phases": {}}
    for phase in (1, 2):
        if phase == 2:
            tr._unfreeze()
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        events = [torch.cuda.Event(enable_timing=True) for _ in range(21)]
        events[0].record()
        for i in range(20):
            step()
            events[i + 1].record()
        torch.cuda.synchronize()
        ms = float(np.median([a.elapsed_time(b) for a, b in zip(events, events[1:])]))
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        r = trace(step, args.steps)
        r.update(step_ms_events=ms, rows_per_s=args.rows / ms * 1e3,
                 synced_wall_ms=float(np.median(walls)))
        result["phases"][phase] = r
        print(f"[profile_train] phase {phase}: {ms:.3f} ms a step (CUDA events), "
              f"{r['rows_per_s']:.1f} rows/s, synchronised wall {r['synced_wall_ms']:.3f} ms; "
              f"traced wall {r['wall_ms_per_step']:.3f} ms, device busy "
              f"{r['device_busy_ms_per_step']:.3f} ms (idle {100 * r['idle_share']:.1f}%), "
              f"{r['kernels_per_step']:.0f} kernels a step; {smi}", flush=True)
        for part, v in r["device_ms_by_part"].items():
            host = r["host_ms_by_part"].get(part)
            print(f"[profile_train] phase {phase}:   {part:24s} {v:8.3f} ms"
                  + (f" (host {host:.3f} ms)" if host is not None else ""))
        print(f"[profile_train] phase {phase}:   {r['tensor_allocations_per_step']:.0f} tensor "
              "allocations a step (aten::empty, aten::empty_strided)")
        for k, v in r["device_ms_by_kind"].items():
            print(f"[profile_train] phase {phase}:     {k:34s} {v:8.3f} ms")
        for name, v in r["top_kernels_ms_per_step"].items():
            print(f"[profile_train] phase {phase}:       {v:8.3f} ms  {kind(name):34s} {name[:90]}")
    shutil.rmtree(log_dir, ignore_errors=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
