"""The clip's global norm over a submodel's gradients, float32 sums against
float64 ones, on one device.

    python -m synthetic_audio_detection_tpu_torch.tools.time_clip_norm [--device cuda|cpu]

A train step clips its gradients by their global norm
(``train/steps.py:clip_by_global_norm_``), each tensor's 2-norm from
``tensor_norms``, which accumulates in float64. This times that norm
against the same one from torch's float32 ``_foreach_norm``, over random
gradients of the shapes of a ResNet-18 ``BinaryClassifier``'s parameters,
and the whole clip with each. Times are CUDA events around ``--iters``
calls after a warm-up, the two forms alternated in ``--rounds`` rounds;
each row is the median of the rounds, in ms a call. It prints the card's
name and power limit as nvidia-smi gives them, then one JSON object.
``--device cpu`` runs the same calls for a check, with wall-clock times.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

from synthetic_audio_detection_tpu_torch.models.classifier import BinaryClassifier
from synthetic_audio_detection_tpu_torch.train import steps


def _float32_norms(ts):
    return torch._foreach_norm(ts)


def _global(norms_fn, grads):
    return torch.linalg.vector_norm(torch.stack(norms_fn(grads)))


def _timer(device):
    if device.type == "cuda":
        def run(fn, iters):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / iters
    else:
        def run(fn, iters):
            t = time.perf_counter()
            for _ in range(iters):
                fn()
            return (time.perf_counter() - t) * 1e3 / iters
    return run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--rounds", type=int, default=5)
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    gen = torch.Generator().manual_seed(0)
    shapes = [q.shape for q in BinaryClassifier("resnet18").parameters()]
    grads = [(torch.randn(s, generator=gen) * 1e-2).to(device) for s in shapes]
    exact = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads)))
    forms = {"float32": _float32_norms, "float64": steps.tensor_norms}
    row = {"tensors": len(grads), "elements": sum(g.numel() for g in grads)}
    for name, fn in forms.items():
        row[f"norm_{name}_rel_err"] = abs(float(_global(fn, grads)) / exact - 1.0)
    run = _timer(device)
    work = [g.clone() for g in grads]
    calls = {f"{kind}_{name}": (lambda f=fn, k=kind: _global(f, grads) if k == "norm"
                                else steps.clip_by_global_norm_(work, 0.5, _global(f, work)))
             for kind in ("norm", "clip") for name, fn in forms.items()}
    for fn in calls.values():
        run(fn, 5)
    times = {k: [] for k in calls}
    for _ in range(args.rounds):
        for k, fn in calls.items():
            times[k].append(run(fn, args.iters))
    row.update({f"{k}_ms": statistics.median(v) for k, v in times.items()})
    if device.type == "cuda":
        row["device"] = torch.cuda.get_device_name(0)
        try:
            print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 timeout=30).stdout.strip())
        except (OSError, subprocess.SubprocessError) as e:
            print(f"nvidia-smi: {e}")
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
