#!/usr/bin/env python3
"""Drive the PyTorch port's serving paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, in order; the first that fails ends the run with a non-zero exit:

1. device  CUDA must be available; prints the card's name and power limit.
2. build   compiles every CUDA source of the paths (one nvcc per source, all
           started together) into synthetic_audio_detection_tpu_torch/build/.
3. kernels each kernel against its plain PyTorch version on the same
           inputs at the shapes the serving path gives it, with the stated
           tolerance, timed with CUDA events (median of 20 back-to-back
           launches after warm-up) beside its bound and, where one PyTorch
           call computes the same function, that call:
           - K1, the log-mel kernel, at [128, 128000] waveforms (numpy seed);
           - the 3x3 conv + BN + ReLU kernel (K3-K6) at the seven 3x3 conv
             shapes of ResNet-18 at 512² input and batch 128, ReLU on and
             off, and its other three entries (tiled, flat, flat_static) at
             the layer-1 shape.
4. main    writes two merged ResNet-18 ensembles (3 heads each, seeded
           random weights, BN statistics estimated on log-mel windows of a
           seeded clip and perturbed; one shared backbone, one dense)
           and two 32 kHz WAVs (10 min = 150 windows, so the 128 bucket runs
           twice; 20 s = 5 windows, the 8 bucket), then runs the port's CLI
           main() with --bf16 at --input-size 512 for each checkpoint and
           clip, and once in float32. Every kernel's launch count is zeroed
           before and read after. Checks: the JSON parses and covers every
           window, K1 launched during the bf16 runs and not during the
           float32 run, the conv kernel in none of them (the CLI keeps the
           cuDNN route), bf16 and float32 labels agree on every window
           whose float32 sigmoids all lie more than 0.05 from the threshold
           (and whose leading synthetic head, for a synthetic verdict, leads
           the runner-up by more than 0.05), and the CUDA float32 logits
           match the CPU float32 logits on a small input.
5. conv    the conv path: InferencePipeline(compute_dtype=bfloat16,
           conv3x3_max_channels=512) on the shared checkpoint over the 150
           windows, counts zeroed before and read after: 16 conv launches
           per 128-window batch (32) and one K1 launch per batch, none of
           the conv kernel in float32 with the same knob. Its logits
           against the cuDNN route of the same pipeline, and its labels on
           every clear window against the cuDNN route and float32. Then
           the steady-state windows per second of both bf16 routes and of
           float32, in turns, at batch 128.
6. report  one JSON line of kernels, the nvidia-smi line, and last
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
# conv kernel vs its plain version: both round x and w to bf16, form every
# product exactly in float32 and sum in float32 in different orders, then
# apply the same float32 affine and round once, so the bf16 outputs differ
# by at most one bf16 ulp (relative 2^-7) where the two sums straddle a
# rounding boundary; 1e-5 absolute covers the float32 sums' order near 0
CONV_RTOL, CONV_ATOL = 2.0 ** -7, 1e-5
# kernel route vs cuDNN route of the bf16 pipeline: the same function
# rounded to bf16 at different places (folded bf16 weights and bias against
# bf16 weights and a float32 affine); the whole bf16 backbone moved logits
# by up to 0.249 against float32 (PERF.md), so two bf16 roundings may
# differ by up to twice that
TOL_ROUTE = 0.5

# published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of its bytes over the memory rate and its operations over
# the peak rate for their type
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM_BYTES_S = 3.35e12

BATCH = 128
# the sixteen 3x3 convs of ResNet-18 at 512² input: (where, H, W, C, F,
# stride, convs per batch); layer1 runs at 128² after the stem and max-pool
CONV_SHAPES = [
    ("layer1", 128, 128, 64, 64, 1, 4),
    ("layer2.0.conv1", 128, 128, 64, 128, 2, 1),
    ("layer2", 64, 64, 128, 128, 1, 3),
    ("layer3.0.conv1", 64, 64, 128, 256, 2, 1),
    ("layer3", 32, 32, 256, 256, 1, 3),
    ("layer4.0.conv1", 32, 32, 256, 512, 2, 1),
    ("layer4", 16, 16, 512, 512, 1, 3),
]
CONVS_PER_BATCH = sum(s[-1] for s in CONV_SHAPES)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def median_ms(fn, n: int = 20, warmup: int = 3) -> float:
    """Median device time of one call: ``n`` calls enqueued back to back
    with an event between each two, so a kernel's time excludes the host's
    launch work wherever the host keeps ahead of the device."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    events[0].record()
    for i in range(n):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in zip(events, events[1:])]))


def bound(flops_by_peak, nbytes: float):
    """(bound ms, 'bytes' or 'operations') for operations
    [(count, peak rate)] and bytes moved."""
    t_ops = sum(n / peak for n, peak in flops_by_peak) * 1e3
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


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

    from synthetic_audio_detection_tpu_torch.ops import melspec
    from synthetic_audio_detection_tpu_torch.utils.config import SpectrogramConfig

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


def check_k1(k1, cfg):
    """K1 against its plain version at [128, 128000]; → report fields."""
    import torch

    from synthetic_audio_detection_tpu_torch.ops import melspec

    x = torch.from_numpy((np.random.default_rng(0).standard_normal((BATCH, 128_000)) * 0.3)
                         .astype(np.float32)).cuda()
    report = {}
    for standardize, tol in ((True, TOL_Z), (False, TOL_DB)):
        got = k1(x, cfg, standardize=standardize)
        ref = melspec.log_mel_factored(x, cfg, standardize=standardize,
                                       dft_dtype=torch.bfloat16)
        ref32 = melspec.log_mel_factored(x, cfg, standardize=standardize,
                                         dft_dtype=torch.float32)
        torch.cuda.synchronize()
        check(got.shape == (BATCH, 128, 251) and bool(torch.isfinite(got).all()),
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
        report[standardize] = dict(err=err, tol=tol, ms=ms, plain_ms=plain_ms, err32=err32)

    # bound: the block DFT on the tensor cores in bf16 and the float32 mel
    # product, the waveforms in and the z-scores out (the constants too);
    # the filterbank is triangular, so the mel product needs one multiply
    # and add per nonzero weight, not the dense [n_sig, n_mels] product
    blocks, n_frames = melspec.factored_blocks(x, cfg)
    cs_t, fb, ncp, n_sig = k1._constants(cfg, SR, x.device)
    B, nb, hop = blocks.shape
    dft = 2.0 * B * nb * hop * 2 * ncp
    mel = 2.0 * B * n_frames * int(torch.count_nonzero(fb))
    nbytes = (x.numel() * 4 + B * cfg.n_mels * n_frames * 4
              + cs_t.numel() * 2 + fb.numel() * 4)
    b_ms, b_by = bound([(dft, PEAK_BF16), (mel, PEAK_F32)], nbytes)
    print(f"[kernels] K1 bound {b_ms:.4f} ms ({b_by}): block DFT {dft / 1e9:.2f} GFLOP bf16, "
          f"mel product {mel / 1e9:.3f} GFLOP float32, {nbytes / 1e6:.1f} MB", flush=True)
    report["bound"] = (b_ms, b_by)
    return report


def conv_inputs(B, H, W, C, F, seed):
    """x bf16 NHWC, the packed weight's HWIO view, scale and bias, on the
    card from a seeded generator; He-scaled weights keep outputs O(1)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (0.5 * torch.randn(B, H, W, C, generator=g, device="cuda")).to(torch.bfloat16)
    w = torch.randn(F, 3, 3, C, generator=g, device="cuda") * (2.0 / (9 * C)) ** 0.5
    scale = 0.5 + torch.rand(F, generator=g, device="cuda")
    bias = 0.1 * torch.randn(F, generator=g, device="cuda")
    # [F, 3, 3, C] bf16 as FastResNet packs it, passed as its [3, 3, C, F] view
    return x, w.to(torch.bfloat16).contiguous().permute(1, 2, 3, 0), scale, bias


def conv_err(got, ref):
    """(max |got − ref|, whether every element is within the tolerance)."""
    d = (got.float() - ref.float()).abs()
    excess = d - (CONV_RTOL * ref.float().abs() + CONV_ATOL)
    return float(d.max()), float(excess.max()) <= 0.0


def check_conv():
    """The conv kernel against its plain version at ResNet-18's 3x3 shapes
    at 512² and batch 128, and its other entries at the layer-1 shape;
    → (per-shape rows, per-entry rows)."""
    import torch
    import torch.nn.functional as F

    from synthetic_audio_detection_tpu_torch.ops import cuda_conv, cuda_conv_flat

    rows, entries = [], {}
    for i, (where, H, W, C, Fo, stride, count) in enumerate(CONV_SHAPES):
        x, w, scale, bias = conv_inputs(BATCH, H, W, C, Fo, seed=100 + i)
        errs = []
        for relu in (True, False):
            got = cuda_conv.conv3x3_bn_relu(x, w, scale, bias, stride=stride, relu=relu)
            ref = cuda_conv.conv3x3_bn_relu_plain(x, w, scale, bias, stride, relu)
            torch.cuda.synchronize()
            check(got.shape == ref.shape == (BATCH, H // stride, W // stride, Fo),
                  f"conv {where} shape")
            err, ok = conv_err(got, ref)
            check(ok, f"conv {where} relu={relu} disagrees with its plain version ({err})")
            errs.append(err)
        # the port's cuDNN route for the same function: BN folded into the
        # bf16 weight and bias, channels_last, then the ReLU
        x_nchw = x.permute(0, 3, 1, 2)
        w_fold = (w.float() * scale).permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        b_fold = bias.to(torch.bfloat16)
        ms = median_ms(lambda: cuda_conv.conv3x3_bn_relu(x, w, scale, bias, stride=stride))
        plain_ms = median_ms(lambda: cuda_conv.conv3x3_bn_relu_plain(x, w, scale, bias, stride))
        library_ms = median_ms(lambda: torch.relu(F.conv2d(x_nchw, w_fold, b_fold, stride, 1)))
        Ho, Wo = H // stride, W // stride
        flops = 2.0 * BATCH * Ho * Wo * Fo * 9 * C
        nbytes = 2.0 * (x.numel() + w.numel() + BATCH * Ho * Wo * Fo) + 8.0 * Fo
        b_ms, b_by = bound([(flops, PEAK_BF16)], nbytes)
        row = dict(where=where, x=[BATCH, H, W, C], F=Fo, stride=stride, per_batch=count,
                   max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=b_ms, bound_by=b_by, gflop=flops / 1e9, mb=nbytes / 1e6)
        rows.append(row)
        print(f"[kernels] conv {where:15s} [{BATCH},{H},{W},{C}]→{Fo} s{stride}: "
              f"max|kernel-plain| {max(errs):.3g} (≤ 2^-7·|ref| + 1e-5), kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f}, cuDNN {library_ms:.4f}, "
              f"bound {b_ms:.4f} ms ({b_by})", flush=True)

        if where == "layer1":
            # the other three TPU layouts' entries, the same kernel
            calls = {
                "K4": ("conv3x3_bn_relu_tiled(tile_h=32)",
                       lambda: cuda_conv.conv3x3_bn_relu_tiled(x, w, scale, bias, tile_h=32)),
                "K5": ("conv3x3_bn_relu_flat",
                       lambda: cuda_conv_flat.conv3x3_bn_relu_flat(x, w, scale, bias)),
                "K6": ("conv3x3_bn_relu_flat_static",
                       lambda: cuda_conv_flat.conv3x3_bn_relu_flat_static(x, w, scale, bias)),
            }
            ref = cuda_conv.conv3x3_bn_relu_plain(x, w, scale, bias)
            for kid, (entry, fn) in calls.items():
                err, ok = conv_err(fn(), ref)
                check(ok, f"{entry} disagrees with the plain version ({err})")
                e_ms = median_ms(fn)
                entries[kid] = dict(row, entry=entry, max_abs_err=err, ms=e_ms, per_batch=0)
                print(f"[kernels] {kid} {entry} at layer1: max|kernel-plain| {err:.3g}, "
                      f"kernel {e_ms:.4f} ms", flush=True)
        del x, w
    torch.cuda.empty_cache()  # the layer-1 buffers go back before the pipelines run
    total = {k: sum(r[k] * r["per_batch"] for r in rows)
             for k in ("ms", "plain_ms", "library_ms", "bound_ms", "gflop", "mb")}
    # the batch's bound is the sum of its launches' bounds; what bounds it
    # is what its operations and its bytes would each take over the batch
    _, total["bound_by"] = bound([(total["gflop"] * 1e9, PEAK_BF16)], total["mb"] * 1e6)
    print(f"[kernels] conv, the {CONVS_PER_BATCH} 3x3 convs of one 128-window batch: kernel "
          f"{total['ms']:.3f} ms, plain {total['plain_ms']:.3f}, cuDNN {total['library_ms']:.3f}, "
          f"bound {total['bound_ms']:.3f} ({total['bound_by']}; {total['gflop'] / 1e3:.3f} TFLOP, "
          f"{total['mb'] / 1e3:.3f} GB)", flush=True)
    return rows, entries, total


def windows_per_s(pipe, windows, runs: int = 5) -> float:
    """Steady state: one warm-up pass, then the median of ``runs`` passes
    over all windows, host clock around work that ends with the logits on
    the host."""
    pipe.logits_for_windows(windows)
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        pipe.logits_for_windows(windows)
        times.append(time.perf_counter() - t0)
    return windows.shape[0] / float(np.median(times))


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
    from synthetic_audio_detection_tpu_torch.audio import wavio
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
    from synthetic_audio_detection_tpu_torch.ops import build, cuda_conv, cuda_melspec
    from synthetic_audio_detection_tpu_torch.utils.config import (
        AudioConfig,
        InferenceConfig,
        SpectrogramConfig,
    )

    k1, conv = cuda_melspec.KERNEL, cuda_conv.KERNEL
    kernels = {k1.name: k1, conv.name: conv}

    def zero_counts():
        for k in kernels.values():
            k.launches = 0

    def counts():
        return {name: k.launches for name, k in kernels.items()}

    # 2. build
    t0 = time.perf_counter()
    build.build(list(kernels))
    print(f"[build] {len(kernels)} source(s) in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in kernels:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    # 3. kernels against their plain versions
    k1_report = check_k1(k1, SpectrogramConfig.inference())
    conv_rows, conv_entries, conv_total = check_conv()

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

        zero_counts()
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
        bf16_launches = counts()
        res32, sec = run_cli(["--merged-model", paths["shared"],
                              "--audio", os.path.join(work, "10min.wav"),
                              "--output-json", os.path.join(work, "f32.json"),
                              "--input-size", "512", "--device", "cuda"])
        print(f"[main] f32  shared 10min: {sec:.3f} s per clip, {150 / sec:.1f} windows/s "
              "(CLI wall, checkpoint load included)", flush=True)
        cli_launches = counts()
        print(f"[main] launches in the bf16 runs {bf16_launches}, after the f32 run "
              f"{cli_launches}")
        check(bf16_launches[k1.name] > 0, "K1 was not launched by the main path")
        check(cli_launches[k1.name] == bf16_launches[k1.name], "K1 launched by the f32 path")
        check(cli_launches[conv.name] == 0, "the CLI's default route launched the conv kernel")

        # bf16 vs float32 verdicts away from the threshold
        audio = AudioConfig(overlap=0.0, silence_threshold=1e-3)
        windows, stamps = slice_waveform(
            preprocess_waveform(os.path.join(work, "10min.wav"), audio), audio)
        check(windows.shape[0] == 150, "10-minute clip windows")
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

        # 5. the conv path: the shared backbone's 3x3 convs through the kernel
        pk = InferencePipeline(ckpts["shared"], audio=audio, spec=spec512,
                               infer=InferenceConfig(), compute_dtype=torch.bfloat16,
                               device="cuda", conv3x3_max_channels=512)
        check(pk.use_fast_backbone and pk.conv3x3_max_channels == 512, "conv route engaged")
        zero_counts()
        l_kernel = pk.logits_for_windows(windows)
        path_launches = counts()
        n_batches = -(-windows.shape[0] // BATCH)
        print(f"[conv] launches on the conv path, {windows.shape[0]} windows in {n_batches} "
              f"batches: {path_launches}", flush=True)
        check(path_launches[conv.name] == CONVS_PER_BATCH * n_batches,
              f"conv kernel launches {path_launches[conv.name]} != "
              f"{CONVS_PER_BATCH} per batch × {n_batches}")
        check(path_launches[k1.name] == n_batches, "K1 launches on the conv path")
        p32k = InferencePipeline(ckpts["shared"], audio=audio, spec=spec512,
                                 infer=InferenceConfig(), device="cuda", conv3x3_max_channels=512)
        zero_counts()
        p32k.logits_for_windows(windows[:8])
        check(p32k.conv3x3_max_channels == 0 and counts()[conv.name] == 0,
              "the conv kernel ran in float32")

        p16 = InferencePipeline(ckpts["shared"], audio=audio, spec=spec512,
                                infer=InferenceConfig(), compute_dtype=torch.bfloat16,
                                device="cuda")
        l_cudnn = p16.logits_for_windows(windows)
        l_f32 = p32.logits_for_windows(windows)
        check(l_kernel.shape == l_cudnn.shape == (150, len(NAMES))
              and bool(np.isfinite(l_kernel).all()), "conv path logits")
        route_diff = np.abs(l_kernel - l_cudnn)
        corr = float(np.corrcoef(l_kernel.ravel(), l_cudnn.ravel())[0, 1])
        print(f"[conv] logits, kernel vs cuDNN route: max diff {route_diff.max():.4g}, mean "
              f"{route_diff.mean():.4g}, corr {corr:.6f} (tol {TOL_ROUTE}); against float32: "
              f"kernel max {np.abs(l_kernel - l_f32).max():.4g} mean "
              f"{np.abs(l_kernel - l_f32).mean():.4g}, cuDNN max "
              f"{np.abs(l_cudnn - l_f32).max():.4g} mean {np.abs(l_cudnn - l_f32).mean():.4g}",
              flush=True)
        check(float(route_diff.max()) <= TOL_ROUTE, "kernel route logits off the cuDNN route")

        def labels(pipe, logits):
            return [s["label"] for s in pipe.analyze_windows(windows, stamps,
                                                             logits=logits)["segments"]]

        lab_k, lab_c = labels(pk, l_kernel), labels(p16, l_cudnn)
        for other, labs in (("cuDNN bf16", lab_c), ("float32", lab32)):
            bad = [i for i in range(150) if clear[i] and lab_k[i] != labs[i]]
            print(f"[conv] kernel route vs {other} labels: {int(clear.sum()) - len(bad)}/"
                  f"{int(clear.sum())} clear windows agree "
                  f"({sum(a == b for a, b in zip(lab_k, labs))}/150 overall)", flush=True)
            check(not bad, f"kernel route and {other} verdicts differ on clear windows {bad}")

        # steady-state throughput at batch 128, the routes in turns
        wps = {"cudnn": [], "kernel": [], "float32": []}
        for route, pipe in (("cudnn", p16), ("kernel", pk), ("kernel", pk), ("cudnn", p16),
                            ("float32", p32)):
            wps[route].append(windows_per_s(pipe, windows))
        for route, vals in wps.items():
            print(f"[conv] pipeline {route:8s} 150 windows at 512², batch 128: "
                  f"{' / '.join(f'{v:.1f}' for v in vals)} windows/s (median of 5 each)",
                  flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # 6. report
    z = k1_report[True]
    k1_bound, k1_by = k1_report["bound"]
    report = [{
        "name": "K1 melspec_factored",
        "route": "cuda",
        "source": cuda_melspec.SOURCE,
        "replaces": cuda_melspec.REPLACES,
        "launches": cli_launches[k1.name],
        "max_abs_err": z["err"],
        "tol": f"{z['tol']:g} on z-scores at [128, 128000], against the plain version",
        "max_abs_err_db": k1_report[False]["err"],
        "tol_db": f"{k1_report[False]['tol']:g} dB, standardize=False",
        "max_abs_diff_vs_f32": z["err32"],
        "ms": z["ms"],
        "plain_ms": z["plain_ms"],
        "bound_ms": k1_bound,
        "bound_by": k1_by,
        "library_ms": None,
    }]
    conv_launches = path_launches[conv.name]
    tol = "|kernel − plain| ≤ 2^-7·|plain| + 1e-5 (one bf16 ulp), bf16 out"
    report.append({
        "name": "K3 conv3x3_bn_relu",
        "route": "cuda",
        "source": cuda_conv.SOURCE,
        "replaces": cuda_conv.REPLACES["K3"],
        "entry": "cuda_conv.conv3x3_bn_relu",
        "launches": conv_launches,
        "max_abs_err": max(r["max_abs_err"] for r in conv_rows),
        "tol": tol,
        "per": f"the {CONVS_PER_BATCH} 3x3 convs of one 128-window batch at 512²",
        "ms": conv_total["ms"],
        "plain_ms": conv_total["plain_ms"],
        "bound_ms": conv_total["bound_ms"],
        "bound_by": conv_total["bound_by"],
        "library_ms": conv_total["library_ms"],
        "shapes": conv_rows,
    })
    for kid, e in conv_entries.items():
        report.append({
            "name": f"{kid} {e['entry'].split('(')[0]}",
            "route": "cuda",
            "source": cuda_conv.SOURCE,
            "replaces": cuda_conv.REPLACES[kid],
            "entry": e["entry"],
            # the entry is not on the conv path; the launches of the kernel
            # it shares are on the K3 row
            "shares_kernel_of": "K3 conv3x3_bn_relu",
            "launches": 0,
            "max_abs_err": e["max_abs_err"],
            "tol": tol,
            "per": "one call at the layer-1 shape [128, 128, 128, 64] → 64",
            "ms": e["ms"],
            "plain_ms": e["plain_ms"],
            "bound_ms": e["bound_ms"],
            "bound_by": e["bound_by"],
            "library_ms": e["library_ms"],
        })
    print(json.dumps({"kernels": report}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
