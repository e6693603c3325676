#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; the first that fails ends the run with a non-zero exit:

1. device  CUDA must be available; prints the card's name and power limit.
2. build   compiles every CUDA source of the path (one nvcc per source, all
           at once) into synthetic_audio_detection_tpu_torch/build/.
3. kernels each kernel against its plain PyTorch version on the same
           inputs at the serving shape ([128, 128000] waveforms, numpy seed),
           with the stated tolerance, and both timed with CUDA events
           (median of 20 after warm-up).
4. main    writes two merged ResNet-18 ensembles (3 heads each, seeded
           random weights, BN statistics estimated on log-mel windows of a
           seeded clip and perturbed; one shared backbone, one dense)
           and two 32 kHz WAVs (10 min = 150 windows, so the 128 bucket runs
           twice; 20 s = 5 windows, the 8 bucket), then runs the port's CLI
           main() with --bf16 at --input-size 512 for each checkpoint and
           clip, and once in float32. Every kernel's launch count is zeroed
           before and read after. Checks: the JSON parses and covers every
           window, each kernel launched during the bf16 runs and not during
           the float32 run, bf16 and float32 labels agree on every window
           whose float32 sigmoids all lie more than 0.05 from the threshold
           (and whose leading synthetic head, for a synthetic verdict, leads
           the runner-up by more than 0.05),
           and the CUDA float32 logits match the CPU float32 logits on a
           small input. Then the steady-state windows per second of the
           pipeline at batch 128.
5. report  one JSON line of kernels, the nvidia-smi line, and last
           {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SR = 32_000
THRESHOLD = 0.5
NAMES = ["SynA", "SynB", "SynC", "Real"]
# kernel vs plain version at bf16 DFT precision: the products are exact in
# float32 on both sides, only the float32 summation order differs
TOL_Z = 1e-3    # standardized log-mel (z-scores)
TOL_DB = 1e-2   # dB plane (standardize=False)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def median_ms(fn, n: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def make_clip(seconds: int, seed: int) -> np.ndarray:
    """Four-second stretches of broadband noise — white, low-passed,
    high-passed, amplitude-modulated — at random levels, so windows differ
    from one another. Broadband on purpose: pure tones and chirps put most
    of the mel plane more than 54 dB below its peak, below the rounding
    floor of the kernel's bf16 DFT operands (a property of the reference
    kernel's numerics, PERF.md), where bf16 and float32 verdicts need not
    agree."""
    rng = np.random.default_rng(seed)
    n = 4 * SR
    t = np.arange(n) / SR
    parts = []
    for i in range(seconds // 4):
        noise = rng.standard_normal(n + 64)
        kind = i % 4
        if kind == 0:
            x = noise[:n]
        elif kind == 1:
            width = int(rng.integers(2, 33))
            x = np.convolve(noise, np.ones(width) / np.sqrt(width), "valid")[:n]
        elif kind == 2:
            x = np.diff(noise)[:n] / np.sqrt(2)
        else:
            x = noise[:n] * (0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(2, 8) * t))
        parts.append(rng.uniform(0.05, 0.3) * x)
    return np.clip(np.concatenate(parts), -1.0, 1.0).astype(np.float32)


def make_classifiers(images, count: int = 3):
    """Seeded ResNet-18 classifiers on ``images``' device: PyTorch's default
    initialisation drawn from a torch.Generator, a wider last layer, and BN
    statistics estimated on ``images`` (log-mel windows, so the logits come
    out O(1) on real inputs), then perturbed from the seed."""
    import math

    import torch

    from synthetic_audio_detection_tpu_torch.models.classifier import BinaryClassifier

    out = []
    for seed in range(count):
        g = torch.Generator().manual_seed(seed)
        model = BinaryClassifier("resnet18")
        bns = [m for m in model.modules()
               if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d))]
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                    torch.nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=g)
                    if m.bias is not None:
                        bound = 1.0 / math.sqrt(m.weight[0].numel())
                        m.bias.uniform_(-bound, bound, generator=g)
            last = model.head[-1].weight
            last.copy_(0.2 * torch.randn(last.shape, generator=g))
            model.to(images.device).train()
            for m in model.modules():
                if isinstance(m, torch.nn.Dropout):
                    m.eval()  # no draws from the global generator
            for m in bns:
                m.reset_running_stats()
                m.momentum = None  # cumulative average over the batches below
            for batch in images.split(8):
                model(batch)
            for m in bns:
                m.momentum = 0.1
                shape = m.running_var.shape
                scale = torch.empty(shape).uniform_(0.8, 1.25, generator=g).to(images.device)
                shift = 0.05 * torch.randn(shape, generator=g).to(images.device)
                m.running_mean.add_(shift * torch.sqrt(m.running_var))
                m.running_var.mul_(scale)
        out.append({k: v.cpu() for k, v in model.eval().state_dict().items()})
    return out


def calibration_images(device):
    """16 standardized 512² log-mel windows of a seeded clip, 3 channels."""
    import torch

    from synthetic_audio_detection_tpu.utils.config import SpectrogramConfig
    from synthetic_audio_detection_tpu_torch.ops import melspec

    windows = torch.from_numpy(make_clip(64, seed=1).reshape(16, 4 * SR)).to(device)
    feats = melspec.log_mel_features(windows, SpectrogramConfig.inference(), SR,
                                     use_gemm_dft=True)
    return melspec.replicate_channels(feats, 3).contiguous()


def run_cli(argv):
    from synthetic_audio_detection_tpu_torch.cli import inference_runner

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = inference_runner.main(argv)
    seconds = time.perf_counter() - t0
    check(rc == 0, f"CLI exit code {rc} for {argv}")
    text = buf.getvalue()
    marker = "Wrote results to "
    check(marker in text, "CLI printed no result")
    payload = text[text.index("\n", text.index(marker)) + 1:]
    return json.loads(payload), seconds


def main() -> int:
    import torch

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    sys.path.insert(0, REPO)
    from synthetic_audio_detection_tpu.audio import wavio
    from synthetic_audio_detection_tpu.utils.config import (
        AudioConfig,
        InferenceConfig,
        SpectrogramConfig,
    )
    from synthetic_audio_detection_tpu_torch.checkpoints.serialization import (
        load_merged_torch,
        save_merged_torch,
    )
    from synthetic_audio_detection_tpu_torch.ensemble.multihead import build_ensemble
    from synthetic_audio_detection_tpu_torch.infer.pipeline import (
        InferencePipeline,
        preprocess_waveform,
        slice_waveform,
    )
    from synthetic_audio_detection_tpu_torch.ops import build, cuda_melspec, melspec

    kernels = {cuda_melspec.KERNEL.name: cuda_melspec.KERNEL}

    # 2. build
    t0 = time.perf_counter()
    build.build(list(kernels))
    print(f"[build] {len(kernels)} source(s) in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in kernels:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    # 3. kernels against their plain versions
    cfg = SpectrogramConfig.inference()
    x = torch.from_numpy((np.random.default_rng(0).standard_normal((128, 128_000)) * 0.3)
                         .astype(np.float32)).cuda()
    k1 = cuda_melspec.KERNEL
    report = {}
    for standardize, tol in ((True, TOL_Z), (False, TOL_DB)):
        got = k1(x, cfg, standardize=standardize)
        ref = melspec.log_mel_factored(x, cfg, standardize=standardize,
                                       dft_dtype=torch.bfloat16)
        ref32 = melspec.log_mel_factored(x, cfg, standardize=standardize,
                                         dft_dtype=torch.float32)
        torch.cuda.synchronize()
        check(got.shape == (128, 128, 251) and bool(torch.isfinite(got).all()),
              "K1 output shape/finite")
        err = float((got - ref).abs().max())
        err32 = float((got - ref32).abs().max())
        # the reference's bounds for bf16 DFT rounding against float32:
        # tests/test_pallas_melspec.py:64 and :161-162
        if standardize:
            excess32 = float(((got - ref32).abs() - 0.05 * ref32.abs()).max())
            ok32 = excess32 <= 0.15
        else:
            ok32 = err32 <= 1.5 and float((got - ref32).abs().mean()) < 0.05
        ms = median_ms(lambda: k1(x, cfg, standardize=standardize))
        plain_ms = median_ms(lambda: melspec.log_mel_factored(
            x, cfg, standardize=standardize, dft_dtype=torch.bfloat16))
        mode = "z" if standardize else "dB"
        print(f"[kernels] K1 {mode}: max|kernel-plain bf16| {err:.3g} (tol {tol}), "
              f"max|kernel-plain f32| {err32:.3g} (reference bound {'ok' if ok32 else 'FAILED'}), "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
        check(err <= tol, f"K1 ({mode}) disagrees with its plain version: {err} > {tol}")
        check(ok32, f"K1 ({mode}) outside the reference bound against float32")
        report[standardize] = (err, tol, ms, plain_ms, err32)
    del x

    # 4. main path through the CLI
    work = os.path.join(REPO, "synthetic_audio_detection_tpu_torch", "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        sds = make_classifiers(calibration_images("cuda"))
        shared = [{**{k: v for k, v in sds[0].items() if k.startswith("base.")},
                   **{k: v for k, v in sd.items() if k.startswith("head.")}} for sd in sds]
        ckpts = {"shared": build_ensemble(shared, NAMES), "dense": build_ensemble(sds, NAMES)}
        check(ckpts["shared"].shared_backbone and not ckpts["dense"].shared_backbone,
              "checkpoint layouts")
        paths = {}
        for layout, ens in ckpts.items():
            paths[layout] = os.path.join(work, f"{layout}.pth")
            save_merged_torch(paths[layout], ens)
        clips = {"10min": (600, 150), "20s": (20, 5)}
        for name, (seconds, _) in clips.items():
            wavio.write_wav(os.path.join(work, f"{name}.wav"), make_clip(seconds, seed=seconds), SR)

        for k in kernels.values():
            k.launches = 0
        results = {}
        for layout in paths:
            for name, (_, n_windows) in clips.items():
                res, sec = run_cli(["--merged-model", paths[layout],
                                    "--audio", os.path.join(work, f"{name}.wav"),
                                    "--output-json", os.path.join(work, f"{layout}_{name}.json"),
                                    "--bf16", "--input-size", "512", "--device", "cuda"])
                check(len(res["segments"]) == n_windows, f"{layout}/{name}: window count")
                check(all(s["label"] in NAMES for s in res["segments"]), "labels")
                check(all(np.isfinite(v) for v in res["percentages"].values()), "percentages")
                results[(layout, name, "bf16")] = res
                print(f"[main] bf16 {layout:6s} {name:5s}: {sec:.3f} s per clip, "
                      f"{n_windows / sec:.1f} windows/s (CLI wall, checkpoint load included)",
                      flush=True)
        bf16_launches = {name: k.launches for name, k in kernels.items()}
        res32, sec = run_cli(["--merged-model", paths["shared"],
                              "--audio", os.path.join(work, "10min.wav"),
                              "--output-json", os.path.join(work, "f32.json"),
                              "--input-size", "512", "--device", "cuda"])
        print(f"[main] f32  shared 10min: {sec:.3f} s per clip, {150 / sec:.1f} windows/s "
              "(CLI wall, checkpoint load included)", flush=True)
        launches = {name: k.launches for name, k in kernels.items()}
        print(f"[main] launches in the bf16 runs {bf16_launches}, after the f32 run {launches}")
        for name in kernels:
            check(bf16_launches[name] > 0, f"{name} was not launched by the main path")
            check(launches[name] == bf16_launches[name], f"{name} launched by the f32 path")

        # bf16 vs float32 verdicts away from the threshold
        audio = AudioConfig(overlap=0.0, silence_threshold=1e-3)
        windows, _ = slice_waveform(preprocess_waveform(os.path.join(work, "10min.wav"), audio),
                                    audio)
        spec512 = SpectrogramConfig.inference(out_size=512)
        p32 = InferencePipeline(ckpts["shared"], audio=audio, spec=spec512,
                                infer=InferenceConfig(), device="cuda")
        probs = 1.0 / (1.0 + np.exp(-p32.logits_for_windows(windows)))
        # a label is clear when no sigmoid lies within 0.05 of the threshold
        # and, for a synthetic verdict, the argmax head leads the runner-up
        # by more than 0.05 (the label is that argmax)
        syn = np.sort(probs[:, :-1], axis=1)
        is_real = (probs[:, -1] >= THRESHOLD) & (syn[:, -1] < THRESHOLD)
        clear = (np.all(np.abs(probs - THRESHOLD) > 0.05, axis=1)
                 & (is_real | (syn[:, -1] - syn[:, -2] > 0.05)))
        lab16 = [s["label"] for s in results[("shared", "10min", "bf16")]["segments"]]
        lab32 = [s["label"] for s in res32["segments"]]
        flips = [i for i in range(len(lab32)) if clear[i] and lab16[i] != lab32[i]]
        print(f"[main] bf16 vs f32 labels: {int(clear.sum()) - len(flips)}/{int(clear.sum())} "
              f"clear windows agree ({sum(a == b for a, b in zip(lab16, lab32))}/150 overall)",
              flush=True)
        if flips:
            p16 = InferencePipeline(load_merged_torch(paths["shared"]), audio=audio, spec=spec512,
                                    infer=InferenceConfig(), compute_dtype=torch.bfloat16,
                                    device="cuda")
            probs16 = 1.0 / (1.0 + np.exp(-p16.logits_for_windows(windows[flips])))
            for i, q in zip(flips, probs16):
                print(f"[main]   window {i}: f32 {lab32[i]} {np.round(probs[i], 3).tolist()}, "
                      f"bf16 {lab16[i]} {np.round(q, 3).tolist()}")
        check(not flips, "bf16 and f32 verdicts differ on clear windows")

        # CUDA float32 against the CPU float32 path (the one the tests hold
        # against the JAX package) on a small input; TF32 is off, so only
        # the summation order differs
        small = windows[:4]
        cpu = InferencePipeline(load_merged_torch(paths["shared"]), audio=audio, spec=spec512,
                                infer=InferenceConfig(batch_size=8), device="cpu")
        l_cpu = cpu.logits_for_windows(small)
        l_gpu = p32.logits_for_windows(small)
        diff = float(np.abs(l_cpu - l_gpu).max())
        print(f"[main] f32 logits, CUDA vs CPU, 4 windows: max diff {diff:.3g} (tol 1e-3)")
        check(diff <= 1e-3, "CUDA float32 logits disagree with the CPU path")

        # steady-state pipeline throughput at batch 128 (host clock around
        # work that ends with the logits on the host)
        for dtype in (torch.bfloat16, torch.float32):
            pipe = InferencePipeline(ckpts["shared"], audio=audio, spec=spec512,
                                     infer=InferenceConfig(), compute_dtype=dtype,
                                     device="cuda")
            pipe.logits_for_windows(windows)
            runs = []
            for _ in range(3):
                t0 = time.perf_counter()
                pipe.logits_for_windows(windows)
                runs.append(time.perf_counter() - t0)
            sec = float(np.median(runs))
            print(f"[main] pipeline {str(dtype).split('.')[-1]:8s} 150 windows at 512²: "
                  f"{sec:.4f} s, {150 / sec:.1f} windows/s (median of 3)", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # 5. report
    err, tol, ms, plain_ms, err32 = report[True]
    print(json.dumps({"kernels": [{
        "name": "K1 melspec_factored",
        "route": "cuda",
        "source": cuda_melspec.SOURCE,
        "replaces": cuda_melspec.REPLACES,
        "tpu_kernel": "_factored_kernel",
        "launches": launches[k1.name],
        "max_abs_err": err,
        "max_abs_diff": err,
        "tol": f"{tol:g} on z-scores at [128, 128000], against the plain version",
        "max_abs_diff_db": report[False][0],
        "tol_db": f"{report[False][1]:g} dB, standardize=False",
        "max_abs_diff_vs_f32": err32,
        "ms": ms,
        "kernel_ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
