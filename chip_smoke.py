#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, in order; the first that fails ends the run with a non-zero exit:

1. device  CUDA must be available; prints the card's name and power limit.
2. build   compiles every CUDA source of the paths (one nvcc per source, all
           started together) into synthetic_audio_detection_tpu_torch/build/.
3. kernels each kernel against its plain PyTorch version on the same
           inputs at the shapes its path gives it, with the stated
           tolerance, timed with CUDA events (median of 20 back-to-back
           launches after warm-up) beside its bound and, where one PyTorch
           call computes the same function, that call:
           - K1, the factored log-mel kernel (bf16 pre-pass; wgmma DFT fed
             by TMA with frames, Hann, power and the sparse mel product in
             its epilogue; the dB / standardize tail), at [128, 128000]
             waveforms (numpy seed), with the float32 tail and with
             lowp_tail (bf16 mel product and output), as z-scores and as
             dB; its device time split by launch (torch.profiler); and the
             same function as a composition of library calls (torch.stft →
             |X|² → filterbank matmul → dB → standardize), the yardstick of
             K1 and K2;
           - K2, the strip log-mel kernel (Hann-weighted bf16 strips;
             wgmma DFT fed by TMA, tiles of one band in a cluster sharing
             the cos|sin loads, with the power and the sparse mel product in
             its epilogue; the tail), on the same windows: against its plain
             version, against the float32 GEMM front end within the
             reference's bound, against K1, and against itself (identical
             bits across runs); its device time split by launch
             (torch.profiler);
           - the 3x3 conv + BN + ReLU kernel (K3-K6, wgmma fed by a TMA
             ring) at the seven 3x3 conv shapes of ResNet-18 at 512² input
             and batch 128 and at its three 1x1 downsamples (the 1x1 weight
             at the centre tap of a zero 3x3 weight, against the 1x1 conv's
             plain composition), bf16 out with ReLU on and off and float32
             out, with its TFLOP/s per shape; then its other three entries
             (tiled, flat, flat_static) at the layer-1 shape; then the 7x7
             stem on one plane and on three channels against the BN-folded
             bf16 cuDNN stem;
           - P1-P3, the helper probes' kernel (wgmma fed by TMA, one block
             per 64-row output tile), at the Pallas shapes on seeded numpy
             bf16 inputs, with each probe's grid and its kernel's ptxas
             line, their device time (torch.profiler) beside the event
             time, and the same for the library calls, faster or slower on
             the device.
4. front   the mel-only front end as the reference's benchmark drives it:
           fused_log_mel (K2) → finalize_features → bf16 on 128 seeded 4-s
           windows at out_size 512, 256 and 0 (native), counts zeroed
           before and read after (one K2 launch per call, nothing else).
           Checks shapes, finite values and agreement with the plain
           composition; then the front end's windows per second with K2,
           with K1 in its place, and with K1 and lowp_tail, in turns.
5. probes  tools/helper_bisect.main() on the card, counts zeroed before and
           read after: the three exact sums, three launches of the probes'
           kernel (one per probe: each entry launches it or raises) and no
           other kernel.
6. main    writes two merged ResNet-18 ensembles (3 heads each, seeded
           random weights, BN statistics estimated on log-mel windows of a
           seeded clip and perturbed; one shared backbone, one dense)
           and two 32 kHz WAVs (10 min = 150 windows, so the 128 bucket runs
           twice; 20 s = 5 windows, the 8 bucket), then runs the port's CLI
           main() with --bf16 at --input-size 512 for each checkpoint and
           clip, and once in float32, every kernel's launch count zeroed
           before each run and read after it. Checks: the JSON parses and
           covers every window, K1 launched in every bf16 run and not in the
           float32 run, the conv kernel 19 times per batch on the shared
           checkpoint (38 for the 150 windows, 19 for the 5) and never on
           the dense one or in float32, bf16 and float32 labels agree on
           every window whose float32 sigmoids all lie more than 0.05 from
           the threshold (and whose leading synthetic head, for a synthetic
           verdict, leads the runner-up by more than 0.05), the CUDA float32
           logits match the CPU float32 logits on a small input, and K2
           never ran.
7. conv    the conv path: the default bf16 InferencePipeline
           (conv3x3_max_channels=512) on the shared checkpoint over the 150
           windows, counts zeroed before and read after: 19 conv launches
           per 128-window batch (38) and one K1 launch per batch, none of
           K2; none of the conv kernel in float32. Its logits against the
           knob-0 route of the same pipeline (every conv the plain
           composition, the same numerics) within TOL_ROUTE at most and
           TOL_ROUTE_MEAN on average, and both
           routes' labels on every clear window against float32. Then the
           steady-state windows per second of both bf16 routes and of
           float32, in turns, at batch 128.
8. report  one JSON line of kernels, the nvidia-smi line, and last
           {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
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
# rounding boundary; near 0 (where the affine cancels the sum) the sums'
# order shows, which grows like the square root of their length: 1e-5
# absolute at K = 576 products (layer 1), 1e-5·√(K / 576) deeper, as the
# GPU tests hold it (tests/test_torch_cuda.py)
CONV_RTOL, CONV_ATOL = 2.0 ** -7, 1e-5
# the default route (conv kernel) vs the knob-0 route (every conv the
# plain composition) of the bf16 pipeline: the same operands and function,
# so they differ only where a conv's two float32 summation orders straddle
# a bf16 rounding boundary; the flipped ulp then propagates through the
# following layers and grows as bf16 rounding itself does, whose distance
# from float32 on these logits is about 0.5 at most and 0.08 on average
# (PERF.md). The bounds: 0.3 at most (about ten bf16 ulps of the largest
# logits, O(5)) and 0.05 on average
TOL_ROUTE, TOL_ROUTE_MEAN = 0.3, 0.05

# published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of its bytes over the memory rate and its operations over
# the peak rate for their type
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM_BYTES_S = 3.35e12

BATCH = 128
LIBRARY_LOG_MEL = ("a composition of library calls, not one call: torch.stft (cuFFT) → |X|² → "
                   "filterbank torch.matmul → dB → standardize, at [128, 128000]")
# the nineteen conv-kernel launches of one ResNet-18 batch at 512² input:
# (where, H, W, C, F, stride, kernel side, convs per batch); layer1 runs at
# 128² after the stem and max-pool; a 1x1 downsample runs as a 3x3 with its
# weight at the centre tap
CONV_SHAPES = [
    ("layer1", 128, 128, 64, 64, 1, 3, 4),
    ("layer2.0.conv1", 128, 128, 64, 128, 2, 3, 1),
    ("layer2.0.downsample", 128, 128, 64, 128, 2, 1, 1),
    ("layer2", 64, 64, 128, 128, 1, 3, 3),
    ("layer3.0.conv1", 64, 64, 128, 256, 2, 3, 1),
    ("layer3.0.downsample", 64, 64, 128, 256, 2, 1, 1),
    ("layer3", 32, 32, 256, 256, 1, 3, 3),
    ("layer4.0.conv1", 32, 32, 256, 512, 2, 3, 1),
    ("layer4.0.downsample", 32, 32, 256, 512, 2, 1, 1),
    ("layer4", 16, 16, 512, 512, 1, 3, 3),
]
CONV_LAUNCHES_PER_BATCH = sum(s[-1] for s in CONV_SHAPES)


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


def kernel_windows():
    """The kernels' [128, 128000] float32 windows on the card (numpy seed)."""
    import torch

    return torch.from_numpy((np.random.default_rng(0).standard_normal((BATCH, 128_000)) * 0.3)
                            .astype(np.float32)).cuda()


def check_lowp_tail(k1, x, cfg, standardize, f32_out, db_std):
    """K1 with lowp_tail against its plain version and against the float32
    tail's output ``f32_out``; → report fields."""
    import torch

    from synthetic_audio_detection_tpu_torch.ops import cuda_melspec, melspec

    got = k1(x, cfg, standardize=standardize, lowp_tail=True)
    ref = melspec.log_mel_factored(x, cfg, standardize=standardize, lowp_tail=True)
    torch.cuda.synchronize()
    mode = "z" if standardize else "dB"
    check(got.dtype == ref.dtype == torch.bfloat16 and got.shape == f32_out.shape,
          f"K1 lowp_tail ({mode}) dtype/shape")
    d = (got.float() - ref.float()).abs()
    one_ulp = float((d <= 2.0 ** -7 * ref.float().abs() + 2.0 ** -9).float().mean())
    sd = db_std if standardize else None
    ok = bool((d <= cuda_melspec.lowp_tail_tolerance(ref, sd)).all())
    d32 = (got.float() - f32_out).abs()
    # the reference's budget against the float32 tail on z-scores
    # (tests/test_pallas_melspec.py:131-132); on both planes the same bound,
    # since rounding each power and weight to bf16 moves a mel by at most
    # 2^-8 of itself
    ok32 = bool((d32 <= cuda_melspec.lowp_tail_tolerance(f32_out, sd)).all())
    if standardize:
        ok32 = ok32 and float(d32.max()) <= 0.05 and float(d32.mean()) < 5e-3
    ms = median_ms(lambda: k1(x, cfg, standardize=standardize, lowp_tail=True))
    print(f"[kernels] K1 lowp_tail {mode}: max|kernel-plain| {float(d.max()):.3g} "
          f"({one_ulp:.6f} of cells within one bf16 ulp, all within the straddle bound: {ok}), "
          f"max|lowp-f32 tail| {float(d32.max()):.3g} mean {float(d32.mean()):.3g} "
          f"({'ok' if ok32 else 'FAILED'}), kernel {ms:.4f} ms", flush=True)
    check(ok, f"K1 lowp_tail ({mode}) outside the bound of its plain version")
    check(ok32, f"K1 lowp_tail ({mode}) outside the bound of the float32 tail")
    return dict(err=float(d.max()), one_ulp_share=one_ulp, err_vs_f32_tail=float(d32.max()),
                ms=ms)


def check_k1(k1, cfg):
    """K1 against its plain version at [128, 128000], with the float32 tail
    and with lowp_tail; → report fields."""
    import torch

    from synthetic_audio_detection_tpu_torch.ops import cuda_melspec, melspec

    x = kernel_windows()
    report = {}
    for standardize, tol in ((False, TOL_DB), (True, TOL_Z)):
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
        if not standardize:
            db_std = ref.std(dim=(1, 2))  # each window's dB spread, for the z bound
        report[standardize] = dict(err=err, tol=tol, ms=ms, plain_ms=plain_ms, err32=err32,
                                   ref32=ref32,
                                   lowp=check_lowp_tail(k1, x, cfg, standardize, got, db_std))

    # bound, from the work the function needs (cuda_melspec.work): each hop
    # block's DFT against the bins up to the guard bin on the tensor cores
    # in bf16, and one float32 multiply-add per filterbank nonzero a frame;
    # the waveforms in, the z-scores out and the constants read once. The
    # tiling's halos and its groups of 4 bins are printed beside it.
    c = k1.constants(cfg, SR, x.device)
    B, T = x.shape
    w = cuda_melspec.work(c, cfg, B, T)
    nbytes = (x.numel() * 4 + B * cfg.n_mels * (1 + T // cfg.hop_length) * 4
              + sum(c[k].numel() * c[k].element_size() for k in ("cs", "f0", "weights", "ends",
                                                                  "quads")))
    b_ms, b_by = bound([(w["dft_min"], PEAK_BF16), (w["mel_min"], PEAK_F32)], nbytes)
    z = report[True]
    print(f"[kernels] K1 bound {b_ms:.4f} ms ({b_by}): DFT {w['dft_min'] / 1e9:.2f} GFLOP bf16, "
          f"mel product {w['mel_min'] / 1e9:.4f} GFLOP float32 "
          f"({int(torch.count_nonzero(c['weights']))} filterbank nonzeros a frame), "
          f"{nbytes / 1e6:.1f} MB; the kernel at {100 * b_ms / z['ms']:.1f}% of it. "
          f"The tiling's own work: DFT {w['dft'] / 1e9:.2f} GFLOP "
          f"({w['dft'] / w['dft_min']:.3f}× with the tiles' and bands' halos), mel product "
          f"{w['mel'] / 1e9:.4f} GFLOP ({w['mel'] / w['mel_min']:.3f}× in groups of 4 bins)",
          flush=True)
    report["bound"] = (b_ms, b_by)
    report["dft_halo_factor"] = w["dft"] / w["dft_min"]
    report["launch_ms"] = launch_ms("K1", lambda: k1(x, cfg),
                                    ("pad_bf16_kernel", "dft_mel_kernel", "db_standardize_kernel"))
    report["library_ms"] = library_log_mel_ms(x, cfg, z["ref32"])
    return report


def device_ms(fn, names=(), calls: int = 10):
    """Device time per call of ``fn`` from torch.profiler over ``calls``
    calls after warm-up, by kernel: {name: ms per call}, a kernel whose name
    contains one of ``names`` counted under that name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = next((k for k in names if k in e.name), e.name)
            split[name] = split.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
    return split


def launch_ms(label, fn, names, calls: int = 10):
    """A log-mel kernel's device time per call split by its launches
    ``names`` (torch.profiler); → {launch: ms per call}."""
    split = device_ms(fn, names, calls)
    check(sorted(split) == sorted(names), f"{label}'s {len(names)} launches in the profile: "
                                          f"{sorted(split)}")
    print(f"[kernels] {label} by launch (torch.profiler, {calls} calls): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items()), flush=True)
    return split


def library_log_mel_ms(x, cfg, ref32):
    """The standardized log-mel as a composition of library calls, not one
    call: torch.stft (cuFFT; centre reflect pad, periodic Hann) → |X|² →
    the filterbank's torch.matmul → dB with the top_db clamp → standardize.
    Checked against the float32 factored front end (the same function to
    float32 rounding); → its median time in ms."""
    import torch

    from synthetic_audio_detection_tpu_torch.ops import melspec

    fb_t = torch.as_tensor(melspec.config_filterbank(cfg, SR).T.copy()).cuda()  # [n_mels, bins]
    window = torch.hann_window(cfg.n_fft, periodic=True, device="cuda")

    def library():
        spec = torch.stft(x, cfg.n_fft, cfg.hop_length, window=window, center=True,
                          pad_mode=cfg.pad_mode, return_complex=True)
        mel = torch.matmul(fb_t, spec.real.square() + spec.imag.square())
        return melspec.standardize(melspec.amplitude_to_db(mel, cfg.top_db), cfg.eps)

    got = library()
    torch.cuda.synchronize()
    err = float((got - ref32).abs().max())
    ms = median_ms(library)
    print(f"[kernels] K1/K2's function as library calls (torch.stft → |X|² → filterbank matmul → "
          f"dB → standardize): {ms:.4f} ms, max|library - float32 factored| {err:.3g} (≤ 1e-3)",
          flush=True)
    check(err <= 1e-3, "the library composition disagrees with the float32 front end")
    return ms


def check_k2(k2, k1, cfg, library_ms):
    """K2 against its plain version, the float32 GEMM front end and K1 at
    [128, 128000], its bits across two runs and its time by launch; →
    report fields."""
    import torch

    from synthetic_audio_detection_tpu_torch.ops import cuda_melspec_strip, melspec

    x = kernel_windows()
    got = k2(x, cfg)
    again = k2(x, cfg)
    ref = melspec.log_mel_strip(x, cfg)
    ref32 = melspec.log_mel_features(x, cfg, SR, use_gemm_dft=True, resize=False)
    z1 = k1(x, cfg)
    torch.cuda.synchronize()
    check(got.shape == (BATCH, 128, 251) and got.dtype == torch.float32
          and bool(torch.isfinite(got).all()), "K2 output shape/finite")
    deterministic = torch.equal(got, again)
    err = float((got - ref).abs().max())
    # the reference's bound for the strip kernel's bf16 DFT against float32
    # (tests/test_pallas_melspec.py:30-33)
    excess32 = float(((got - ref32).abs() - 0.05 - 0.05 * ref32.abs()).max())
    d_mean = abs(float(got.mean() - ref32.mean()))
    d_std = abs(float(got.std() - ref32.std()))
    ok32 = excess32 <= 0.0 and d_mean < 1e-3 and d_std < 1e-2
    # the two formulations' budget against each other (:67)
    vs_k1 = float((got - z1).abs().mean())
    ms = median_ms(lambda: k2(x, cfg))
    plain_ms = median_ms(lambda: melspec.log_mel_strip(x, cfg))
    print(f"[kernels] K2 z: max|kernel-plain bf16| {err:.3g} (tol {TOL_Z}), against the float32 "
          f"GEMM front end: max {float((got - ref32).abs().max()):.3g}, excess over "
          f"0.05 + 0.05·|ref| {excess32:.3g}, |Δmean| {d_mean:.3g}, |Δstd| {d_std:.3g} "
          f"({'ok' if ok32 else 'FAILED'}); mean|K2-K1| {vs_k1:.3g} (< 5e-3); identical bits "
          f"across two runs: {deterministic}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms",
          flush=True)
    check(err <= TOL_Z, f"K2 disagrees with its plain version: {err} > {TOL_Z}")
    check(ok32, "K2 outside the reference bound against the float32 front end")
    check(vs_k1 < 5e-3, f"K2 and K1 differ by {vs_k1} on average")
    check(deterministic, "K2 gave other bits on a second run")

    split = launch_ms("K2", lambda: k2(x, cfg),
                      ("strip_bf16_kernel", "strip_dft_kernel", "strip_tail_kernel"))

    # bound, from the work the function needs (cuda_melspec_strip.work):
    # each frame's DFT against the table's bins on the tensor cores in bf16
    # and one float32 multiply-add per filterbank nonzero a frame; the
    # waveforms in, the z-scores out and the constants read once. The
    # tiling's own work (the bands' overlap, the rows that start no frame,
    # groups of 4 bins) is printed beside it.
    c = k2.constants(cfg, SR, x.device)
    B, T = x.shape
    w = cuda_melspec_strip.work(c, cfg, B, T)
    nbytes = (x.numel() * 4 + got.numel() * 4
              + sum(t.numel() * t.element_size() for t in c.values()))
    b_ms, b_by = bound([(w["dft_min"], PEAK_BF16), (w["mel_min"], PEAK_F32)], nbytes)
    dft_ms = split["strip_dft_kernel"]
    print(f"[kernels] K2 bound {b_ms:.4f} ms ({b_by}): strip DFT {w['dft_min'] / 1e9:.2f} GFLOP "
          f"bf16, mel product {w['mel_min'] / 1e9:.4f} GFLOP float32 "
          f"({int(torch.count_nonzero(c['weights']))} filterbank nonzeros a frame), "
          f"{nbytes / 1e6:.1f} MB; the kernel at {100 * b_ms / ms:.1f}% of it, "
          f"{ms / library_ms:.3f}× the library composition's time. The tiling's own work: DFT "
          f"{w['dft'] / 1e9:.2f} GFLOP ({w['dft'] / w['dft_min']:.3f}×: {c['f0'].numel()} bands "
          f"of 128 bins, the rows that start no frame), mel product {w['mel'] / 1e9:.4f} GFLOP "
          f"({w['mel'] / w['mel_min']:.3f}×). The DFT launch: {w['dft'] / dft_ms / 1e9:.1f} "
          f"TFLOP/s of the tiling's work, {w['dft_min'] / dft_ms / 1e9:.1f} of the function's",
          flush=True)
    return dict(err=err, excess32=excess32, d_mean=d_mean, d_std=d_std, vs_k1=vs_k1, ms=ms,
                plain_ms=plain_ms, bound=(b_ms, b_by), launch_ms=split,
                deterministic=deterministic,
                dft_tiling_factor=w["dft"] / w["dft_min"],
                dft_launch_tflops=w["dft"] / dft_ms / 1e9)


def front_end(log_mel, x, cfg):
    """The mel-only front end: log-mel → finalize_features → bf16."""
    import torch

    from synthetic_audio_detection_tpu_torch.ops import melspec

    return melspec.finalize_features(log_mel(x, cfg), cfg).to(torch.bfloat16)


FRONT_SIZES = {512: (128, 512, 512), 256: (128, 256, 256), 0: (128, 128, 256)}


def drive_front_end(zero_counts, counts):
    """Phase 4: the mel-only front end on K2 at the three input sizes,
    counts zeroed before and read after; then windows/s with K2, K1 and K1
    with lowp_tail in turns. → (launch counts, {size: {route: [w/s, ...]}})."""
    import torch

    from synthetic_audio_detection_tpu_torch.ops import cuda_melspec, cuda_melspec_strip, melspec
    from synthetic_audio_detection_tpu_torch.utils.config import SpectrogramConfig

    x = torch.from_numpy(make_clip(4 * BATCH, seed=4).reshape(BATCH, 4 * SR)).cuda()
    cfgs = {size: SpectrogramConfig.inference(out_size=size) for size in FRONT_SIZES}
    zero_counts()
    feats = {size: front_end(cuda_melspec_strip.fused_log_mel, x, cfg)
             for size, cfg in cfgs.items()}
    torch.cuda.synchronize()
    launches = counts()
    print(f"[front] launches over the three front-end calls: {launches}", flush=True)
    check(launches[cuda_melspec_strip.KERNEL.name] == len(cfgs), "one K2 launch per call")
    check(sum(launches.values()) == len(cfgs), "only K2 runs on the mel-only front end")
    for size, cfg in cfgs.items():
        got = feats[size]
        plain = front_end(melspec.log_mel_strip, x, cfg).float()
        # the resize is a convex combination, so the kernel's z error (TOL_Z)
        # carries over; then one bf16 rounding on each side
        excess = float(((got.float() - plain).abs() - TOL_Z - 2.0 ** -7 * plain.abs()).max())
        print(f"[front] out_size {size}: {tuple(got.shape)} {got.dtype}, max|front end - plain| "
              f"{float((got.float() - plain).abs().max()):.3g}", flush=True)
        check(tuple(got.shape) == FRONT_SIZES[size] and got.dtype == torch.bfloat16
              and bool(torch.isfinite(got).all()), f"front end at out_size {size}")
        check(excess <= 0.0, f"front end at out_size {size} off its plain composition")

    routes = {
        "K2": cuda_melspec_strip.fused_log_mel,
        "K1": cuda_melspec.fused_log_mel_factored,
        "K1 lowp_tail": lambda w, c: cuda_melspec.fused_log_mel_factored(w, c, lowp_tail=True),
    }
    wps = {size: {route: [] for route in routes} for size in cfgs}
    for size, cfg in cfgs.items():
        for route in list(routes) + list(routes)[::-1]:
            ms = median_ms(lambda: front_end(routes[route], x, cfg))
            wps[size][route].append(BATCH / ms * 1e3)
        print(f"[front] out_size {size}, {BATCH} windows: "
              + ", ".join(f"{route} {' / '.join(f'{v:.1f}' for v in vals)}"
                          for route, vals in wps[size].items())
              + " windows/s (front end alone, median of 20 each)", flush=True)
    return launches, wps


def conv_inputs(B, H, W, C, Fo, k, seed):
    """x bf16 NHWC, the conv's own [Fo, k, k, C] weight in float32, the packed
    [F, 3, 3, C] bf16 weight's HWIO view as FastResNet passes it (a 1x1
    weight at the centre tap of zeros), scale and bias, on the card from a
    seeded generator; He-scaled weights keep outputs O(1)."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (0.5 * torch.randn(B, H, W, C, generator=g, device="cuda")).to(torch.bfloat16)
    w = torch.randn(Fo, k, k, C, generator=g, device="cuda") * (2.0 / (k * k * C)) ** 0.5
    scale = 0.5 + torch.rand(Fo, generator=g, device="cuda")
    bias = 0.1 * torch.randn(Fo, generator=g, device="cuda")
    packed = w.to(torch.bfloat16)
    if k == 1:
        packed = F.pad(packed, (0, 0, 1, 1, 1, 1))
    return x, w, packed.contiguous().permute(1, 2, 3, 0), scale, bias


def conv_err(got, ref, k_terms: int):
    """(max |got − ref|, whether every element is within the tolerance for
    sums of ``k_terms`` products)."""
    d = (got.float() - ref.float()).abs()
    atol = CONV_ATOL * max(1.0, (k_terms / 576) ** 0.5)
    excess = d - (CONV_RTOL * ref.float().abs() + atol)
    return float(d.max()), float(excess.max()) <= 0.0


def check_conv():
    """The conv kernel against its plain version at ResNet-18's conv-kernel
    shapes at 512² and batch 128 (bf16 out with ReLU on and off, float32
    out), and its other entries at the layer-1 shape; → (per-shape rows,
    per-entry rows, per-batch totals)."""
    import torch
    import torch.nn.functional as F

    from synthetic_audio_detection_tpu_torch.ops import cuda_conv, cuda_conv_flat

    rows, entries = [], {}
    for i, (where, H, W, C, Fo, stride, k, count) in enumerate(CONV_SHAPES):
        x, w, w_hwio, scale, bias = conv_inputs(BATCH, H, W, C, Fo, k, seed=100 + i)
        x_nchw, w_oihw = x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2)

        def plain(relu=True, out_dtype=torch.bfloat16):
            # the conv's own plain composition: the knob-0 route's, and for
            # a downsample the 1x1 conv itself, not the centre-tap 3x3
            return cuda_conv.conv_bn_relu_plain(x_nchw, w_oihw, scale, bias, stride, k // 2, relu,
                                                out_dtype=out_dtype).permute(0, 2, 3, 1)

        errs = []
        for relu, out_dtype in ((True, torch.bfloat16), (False, torch.bfloat16),
                                (True, torch.float32)):
            got = cuda_conv.conv3x3_bn_relu(x, w_hwio, scale, bias, stride=stride, relu=relu,
                                            out_dtype=out_dtype)
            ref = plain(relu, out_dtype)
            torch.cuda.synchronize()
            check(got.shape == ref.shape == (BATCH, H // stride, W // stride, Fo)
                  and got.dtype == out_dtype, f"conv {where} shape")
            err, ok = conv_err(got, ref, k * k * C)
            check(ok, f"conv {where} relu={relu} {out_dtype} disagrees with its plain version "
                      f"({err})")
            errs.append(err)
        # one PyTorch call for the same function: cuDNN on BN folded into
        # the bf16 weight and bias (the port's route before the reference's
        # numerics), channels_last, then the ReLU of the 3x3 convs
        relu = k == 3
        w_fold = (w_oihw.float() * scale[:, None, None, None]).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        b_fold = bias.to(torch.bfloat16)

        def library():
            y = F.conv2d(x_nchw, w_fold, b_fold, stride, k // 2)
            return torch.relu(y) if relu else y

        ms = median_ms(lambda: cuda_conv.conv3x3_bn_relu(x, w_hwio, scale, bias, stride=stride,
                                                         relu=relu))
        plain_ms = median_ms(lambda: plain(relu))
        library_ms = median_ms(library)
        Ho, Wo = H // stride, W // stride
        flops = 2.0 * BATCH * Ho * Wo * Fo * k * k * C
        # a 1x1 conv at stride 2 reads a quarter of the input's pixels
        x_bytes = 2.0 * (x.numel() if k == 3 else BATCH * Ho * Wo * C)
        nbytes = x_bytes + 2.0 * (w.numel() + BATCH * Ho * Wo * Fo) + 8.0 * Fo
        b_ms, b_by = bound([(flops, PEAK_BF16)], nbytes)
        row = dict(where=where, x=[BATCH, H, W, C], F=Fo, stride=stride, kernel=k,
                   per_batch=count, tiles=cuda_conv.tile_plan(Fo, Ho, Wo, stride),
                   max_abs_err=max(errs), ms=ms, tflops=flops / ms / 1e9, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=b_ms, bound_by=b_by, gflop=flops / 1e9,
                   mb=nbytes / 1e6)
        rows.append(row)
        print(f"[kernels] conv {where:19s} [{BATCH},{H},{W},{C}]→{Fo} {k}x{k} s{stride}: "
              f"max|kernel-plain| {max(errs):.3g} (≤ 2^-7·|ref| + 1e-5·√(K/576); bf16 ReLU "
              f"on/off, float32), kernel {ms:.4f} ms ({row['tflops']:.1f} TFLOP/s of the {k}x{k}'s "
              f"products), plain {plain_ms:.4f}, cuDNN folded {library_ms:.4f}, bound "
              f"{b_ms:.4f} ms ({b_by})", flush=True)

        if where == "layer1":
            # the other three TPU layouts' entries, the same kernel
            calls = {
                "K4": ("conv3x3_bn_relu_tiled(tile_h=32)",
                       lambda: cuda_conv.conv3x3_bn_relu_tiled(x, w_hwio, scale, bias, tile_h=32)),
                "K5": ("conv3x3_bn_relu_flat",
                       lambda: cuda_conv_flat.conv3x3_bn_relu_flat(x, w_hwio, scale, bias)),
                "K6": ("conv3x3_bn_relu_flat_static",
                       lambda: cuda_conv_flat.conv3x3_bn_relu_flat_static(x, w_hwio, scale,
                                                                          bias)),
            }
            ref = plain()
            for kid, (entry, fn) in calls.items():
                err, ok = conv_err(fn(), ref, 9 * C)
                check(ok, f"{entry} disagrees with the plain version ({err})")
                e_ms = median_ms(fn)
                entries[kid] = dict(row, entry=entry, max_abs_err=err, ms=e_ms,
                                    tflops=flops / e_ms / 1e9, per_batch=0)
                print(f"[kernels] {kid} {entry} at layer1: max|kernel-plain| {err:.3g}, "
                      f"kernel {e_ms:.4f} ms", flush=True)
        del x, w, w_hwio, x_nchw, w_oihw
    torch.cuda.empty_cache()  # the layer-1 buffers go back before the pipelines run
    total = {k: sum(r[k] * r["per_batch"] for r in rows)
             for k in ("ms", "plain_ms", "library_ms", "bound_ms", "gflop", "mb")}
    # the batch's bound is the sum of its launches' bounds; what bounds it
    # is what its operations and its bytes would each take over the batch
    _, total["bound_by"] = bound([(total["gflop"] * 1e9, PEAK_BF16)], total["mb"] * 1e6)
    ds = [r for r in rows if r["kernel"] == 1]
    total["downsample_ms"] = sum(r["ms"] for r in ds)
    total["downsample_plain_ms"] = sum(r["plain_ms"] for r in ds)
    total["downsample_library_ms"] = sum(r["library_ms"] for r in ds)
    print(f"[kernels] conv, the {CONV_LAUNCHES_PER_BATCH} conv-kernel launches of one "
          f"128-window batch: kernel {total['ms']:.3f} ms ({total['gflop'] / total['ms']:.1f} "
          f"TFLOP/s), plain {total['plain_ms']:.3f}, cuDNN folded {total['library_ms']:.3f}, "
          f"bound {total['bound_ms']:.3f} ({total['bound_by']}; {total['gflop'] / 1e3:.3f} TFLOP, "
          f"{total['mb'] / 1e3:.3f} GB); the three 1x1 downsamples of them: kernel "
          f"{total['downsample_ms']:.4f} ms, plain composition {total['downsample_plain_ms']:.4f},"
          f" cuDNN folded {total['downsample_library_ms']:.4f}", flush=True)
    return rows, entries, total


def check_stem():
    """The 7x7 stem with its max-pool and ReLU (FastResNet.stem_pool) at 512²
    and batch 128, on the serving input (one log-mel plane on three
    channels as a broadcast view: the channel-summed weight on the plane)
    and on three materialized channels (the plain composition: a float32
    cuDNN conv of the bf16 values, TF32 off, the float32 affine, one
    rounding), against BN folded into a bf16 cuDNN conv (the route they
    replaced), in turns; → report."""
    import torch
    import torch.nn.functional as F

    from synthetic_audio_detection_tpu_torch.models.fast_resnet import FastResNet
    from synthetic_audio_detection_tpu_torch.models.resnet import create_resnet

    g = torch.Generator(device="cuda").manual_seed(7)
    net = create_resnet("resnet18").cuda().eval()
    with torch.no_grad():
        net.conv1.weight.copy_(torch.randn(64, 3, 7, 7, generator=g, device="cuda")
                               * (2.0 / 147) ** 0.5)
        net.bn1.weight.uniform_(0.5, 1.5, generator=g)
        net.bn1.bias.normal_(0.0, 0.1, generator=g)
    fast = FastResNet(net, torch.bfloat16, 512)
    plane = torch.randn(BATCH, 1, 512, 512, generator=g, device="cuda").to(torch.bfloat16)
    one_plane = plane.expand(BATCH, 3, 512, 512)
    three = one_plane.contiguous(memory_format=torch.channels_last)
    scale, bias = fast.stem.scale, fast.stem.bias
    w_fold = (net.conv1.weight * scale[:, None, None, None]).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    b_fold = bias.to(torch.bfloat16)
    routes = {
        "one plane": lambda: fast.stem_pool(one_plane),
        "three channels": lambda: fast.stem_pool(three),
        "folded bf16": lambda: F.max_pool2d(torch.relu(F.conv2d(three, w_fold, b_fold, 2, 3)),
                                            3, 2, 1),
    }
    out = {route: fn() for route, fn in routes.items()}
    torch.cuda.synchronize()
    check(all(o.shape == (BATCH, 64, 128, 128) and o.dtype == torch.bfloat16
              and bool(torch.isfinite(o).all()) for o in out.values()), "stem output")
    # the one-plane form sums the three bf16 weights first: the same
    # function to the float32 summation order, so within one bf16 ulp
    err, ok = conv_err(out["one plane"], out["three channels"], 147)
    check(ok, f"the one-plane stem disagrees with the three-channel one ({err})")
    ms = {route: [] for route in routes}
    for route in list(routes) + list(routes)[::-1]:
        ms[route].append(median_ms(routes[route], n=10))
    print(f"[kernels] stem [{BATCH},3,512,512] 7x7 s2 + max-pool + ReLU: "
          + ", ".join(f"{route} {' / '.join(f'{v:.4f}' for v in vals)} ms"
                      for route, vals in ms.items())
          + f" (in turns); max|one plane - three channels| {err:.3g}, max|one plane - folded| "
          f"{float((out['one plane'].float() - out['folded bf16'].float()).abs().max()):.3g}",
          flush=True)
    return ms


PROBE_SHAPES = {"P1": (64, 64), "P2": (64, 64), "P3": (9, 64, 64)}


def ptxas_by_instance(name: str, kernel: str):
    """{n: ptxas lines} for each instance kernel<n> in the build log of
    csrc/<name>.cu."""
    from synthetic_audio_detection_tpu_torch.ops import build

    out, entry = {}, None
    for line in build.build_log(name).splitlines():
        if "Compiling entry function" in line:
            m = re.search(kernel + r"ILi(\d+)E", line)
            entry = int(m.group(1)) if m else None
        elif entry is not None and ("Used" in line or "spill" in line):
            out.setdefault(entry, []).append(line.split(":", 1)[-1].strip())
    return out


def check_probes():
    """P1-P3 against their plain versions at the Pallas shapes on seeded
    numpy bf16 inputs: one bf16 ulp, like the conv kernel (the same exact
    products summed in another order); → rows."""
    import torch
    import torch.nn.functional as F

    from synthetic_audio_detection_tpu_torch.ops import cuda_probes

    entries = {"P1": (cuda_probes.dyn_slice_dot, cuda_probes.dyn_slice_dot_plain),
               "P2": (cuda_probes.lane_concat_dot, cuda_probes.lane_concat_dot_plain),
               "P3": (cuda_probes.nine_tap_dot, cuda_probes.nine_tap_dot_plain)}
    ptxas = ptxas_by_instance(cuda_probes.LIBRARY, "shifted_taps_kernel")
    rows = {}
    for i, (pid, (entry, plain)) in enumerate(entries.items()):
        rng = np.random.default_rng(200 + i)
        x = torch.from_numpy(rng.standard_normal(cuda_probes.X_SHAPE).astype(np.float32))
        w = torch.from_numpy((rng.standard_normal(PROBE_SHAPES[pid]) / 8).astype(np.float32))
        x, w = x.to(torch.bfloat16).cuda(), w.to(torch.bfloat16).cuda()
        got, ref = entry(x, w), plain(x, w)
        torch.cuda.synchronize()
        check(got.shape == ref.shape and got.dtype == torch.bfloat16, f"{pid} shape")
        taps = 1 if pid == "P1" else 2 if pid == "P2" else 9
        err, ok = conv_err(got, ref, 64 * taps)
        check(ok, f"{pid} disagrees with its plain version ({err})")
        out_rows = got.shape[1]
        row0 = cuda_probes.P1_ROW0 if pid == "P1" else 0
        x_rows = x[:, row0:row0 + out_rows + taps - 1]
        if pid == "P1":
            def library():
                return torch.matmul(x_rows, w)
        else:
            # [F, C, taps]: tap i's weight W_i[c, f] at [f, c, i]
            wc = (w if pid == "P3" else w.expand(2, 64, 64)).permute(2, 1, 0).contiguous()

            def library():
                return F.conv1d(x_rows.transpose(1, 2), wc).transpose(1, 2)
        check(library().shape == got.shape, f"{pid} library call shape")
        ms = median_ms(lambda: entry(x, w))
        plain_ms = median_ms(lambda: plain(x, w))
        library_ms = median_ms(library)
        # the device's own time (torch.profiler, every kernel of the call),
        # apart from the host's launch work that the event times include
        dev_ms = sum(device_ms(lambda: entry(x, w), calls=20).values())
        library_dev_ms = sum(device_ms(library, calls=20).values())
        flops = 2.0 * got.numel() * 64 * taps
        nbytes = 2.0 * (x_rows.numel() + w.numel() + got.numel())
        b_ms, b_by = bound([(flops, PEAK_BF16)], nbytes)
        rows[pid] = dict(entry=entry.__name__, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, device_ms=dev_ms, library_device_ms=library_dev_ms,
                         bound_ms=b_ms, bound_by=b_by, mflop=flops / 1e6, mb=nbytes / 1e6)
        lib = "matmul" if pid == "P1" else "conv1d"
        plan = cuda_probes.tiles(out_rows, taps, row0)
        print(f"[kernels] {pid} grid: {x.shape[0] * len(plan)} blocks ({len(plan)} tiles of "
              f"{cuda_probes.TILE_ROWS} rows × {x.shape[0]} images, no cluster); ptxas "
              f"shifted_taps_kernel<{taps}>: {'; '.join(ptxas.get(taps, ['not in the log']))}",
              flush=True)
        print(f"[kernels] {pid} {entry.__name__} {list(x.shape)} × {list(w.shape)} → "
              f"{list(got.shape)}: max|kernel-plain| {err:.3g} (≤ 2^-7·|ref| + 1e-5), kernel "
              f"{ms:.4f} ms (device {dev_ms:.4f}), plain {plain_ms:.4f}, {lib} {library_ms:.4f} "
              f"(device {library_dev_ms:.4f}), bound {b_ms:.6f} ms ({b_by}; "
              f"{flops / 1e6:.1f} MFLOP, {nbytes / 1e6:.3f} MB); on the device "
              f"{'faster' if dev_ms < library_dev_ms else 'slower'} than {lib} "
              f"({lib} / kernel {library_dev_ms / dev_ms:.2f})", flush=True)
    return rows


def drive_probes(zero_counts, counts):
    """Phase 5: tools/helper_bisect on the card; → launch counts."""
    from synthetic_audio_detection_tpu_torch.ops import cuda_probes
    from synthetic_audio_detection_tpu_torch.tools import helper_bisect

    zero_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = helper_bisect.main([])
    launches = counts()
    lines = buf.getvalue().splitlines()
    for line in lines:
        print(f"[probes] {line}", flush=True)
    print(f"[probes] launches: {launches}", flush=True)
    check(rc == 0, f"helper_bisect exit code {rc}")
    check(lines == [f"{label} : OK {float(total)}" for label, _, _, total in helper_bisect.PROBES],
          "helper_bisect sums")
    # each probe's entry launches the kernel on a CUDA tensor or raises, so
    # three probes that print OK with three launches launched once each
    check(launches[cuda_probes.KERNEL.name] == len(helper_bisect.PROBES),
          "one probe-kernel launch per probe")
    check(sum(launches.values()) == len(helper_bisect.PROBES), "only the probes' kernel ran")
    return launches


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
    from synthetic_audio_detection_tpu_torch.ops import (
        build,
        cuda_conv,
        cuda_melspec,
        cuda_melspec_strip,
        cuda_probes,
    )
    from synthetic_audio_detection_tpu_torch.utils.config import (
        AudioConfig,
        InferenceConfig,
        SpectrogramConfig,
    )

    k1, k2, conv = cuda_melspec.KERNEL, cuda_melspec_strip.KERNEL, cuda_conv.KERNEL
    probes = cuda_probes.KERNEL
    kernels = {k1.name: k1, k2.name: k2, conv.name: conv, probes.name: probes}

    def zero_counts():
        for k in kernels.values():
            k.launches = 0

    def counts():
        return {name: k.launches for name, k in kernels.items()}

    # 2. build
    t0 = time.perf_counter()
    sources = [k1.name, k2.name, cuda_conv.LIBRARY, cuda_probes.LIBRARY]
    build.build(sources)
    print(f"[build] {len(sources)} source(s) in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in sources:
        for line in build.build_log(name).splitlines():
            if any(k in line for k in ("registers", "spill", "warning", "Compiling entry")):
                print(f"[build] {name}: {line.strip()}")

    # 3. kernels against their plain versions
    k1_report = check_k1(k1, SpectrogramConfig.inference())
    t0 = time.perf_counter()
    k2_report = check_k2(k2, k1, SpectrogramConfig.inference(), k1_report["library_ms"])
    print(f"[kernels] K2 checks took {time.perf_counter() - t0:.1f} s", flush=True)
    conv_rows, conv_entries, conv_total = check_conv()
    stem = check_stem()
    probe_rows = check_probes()

    # 4. the mel-only front end
    t0 = time.perf_counter()
    front_launches, front_wps = drive_front_end(zero_counts, counts)
    print(f"[front] phase took {time.perf_counter() - t0:.1f} s", flush=True)

    # 5. the helper probes
    probe_launches = drive_probes(zero_counts, counts)

    # 6. main path through the CLI
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

        results, cli_launches = {}, {}
        for layout in paths:
            for name, (_, n_windows) in clips.items():
                zero_counts()
                res, sec = run_cli(["--merged-model", paths[layout],
                                    "--audio", os.path.join(work, f"{name}.wav"),
                                    "--output-json", os.path.join(work, f"{layout}_{name}.json"),
                                    "--bf16", "--input-size", "512", "--device", "cuda"])
                cli_launches[(layout, name, "bf16")] = launches = counts()
                check(len(res["segments"]) == n_windows, f"{layout}/{name}: window count")
                check(all(s["label"] in NAMES for s in res["segments"]), "labels")
                check(all(np.isfinite(v) for v in res["percentages"].values()), "percentages")
                results[(layout, name, "bf16")] = res
                print(f"[main] bf16 {layout:6s} {name:5s}: {sec:.3f} s per clip, "
                      f"{n_windows / sec:.1f} windows/s (CLI wall, checkpoint load included); "
                      f"launches {launches}", flush=True)
                batches = -(-n_windows // BATCH)
                want = CONV_LAUNCHES_PER_BATCH * batches if layout == "shared" else 0
                check(launches[conv.name] == want,
                      f"{layout}/{name}: {launches[conv.name]} conv launches, not {want}")
                check(launches[k1.name] == batches, f"{layout}/{name}: K1 launches")
                check(launches[k2.name] == launches[probes.name] == 0,
                      f"{layout}/{name}: K2 or the probes' kernel launched")
        zero_counts()
        res32, sec = run_cli(["--merged-model", paths["shared"],
                              "--audio", os.path.join(work, "10min.wav"),
                              "--output-json", os.path.join(work, "f32.json"),
                              "--input-size", "512", "--device", "cuda"])
        cli_launches[("shared", "10min", "float32")] = counts()
        print(f"[main] f32  shared 10min: {sec:.3f} s per clip, {150 / sec:.1f} windows/s "
              f"(CLI wall, checkpoint load included); launches {counts()}", flush=True)
        check(sum(counts().values()) == 0, "a kernel launched in the float32 CLI run")

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

        # 7. the conv path: the default bf16 pipeline against its knob-0 route
        pk = InferencePipeline(ckpts["shared"], audio=audio, spec=spec512,
                               infer=InferenceConfig(), compute_dtype=torch.bfloat16,
                               device="cuda")
        check(pk.use_fast_backbone and pk.conv3x3_max_channels == 512, "conv route engaged")
        zero_counts()
        l_kernel = pk.logits_for_windows(windows)
        path_launches = counts()
        n_batches = -(-windows.shape[0] // BATCH)
        print(f"[conv] launches on the conv path, {windows.shape[0]} windows in {n_batches} "
              f"batches: {path_launches}", flush=True)
        check(path_launches[conv.name] == CONV_LAUNCHES_PER_BATCH * n_batches,
              f"conv kernel launches {path_launches[conv.name]} != "
              f"{CONV_LAUNCHES_PER_BATCH} per batch × {n_batches}")
        check(path_launches[k1.name] == n_batches, "K1 launches on the conv path")
        check(path_launches[k2.name] == path_launches[probes.name] == 0,
              "K2 or the probes' kernel launched on the conv path")
        zero_counts()
        p32.logits_for_windows(windows[:8])
        check(p32.conv3x3_max_channels == 0 and counts()[conv.name] == 0,
              "the conv kernel ran in float32")

        p0 = InferencePipeline(ckpts["shared"], audio=audio, spec=spec512,
                               infer=InferenceConfig(), compute_dtype=torch.bfloat16,
                               device="cuda", conv3x3_max_channels=0)
        zero_counts()
        l_plain = p0.logits_for_windows(windows)
        check(counts()[conv.name] == 0, "the knob-0 route launched the conv kernel")
        l_f32 = p32.logits_for_windows(windows)
        check(l_kernel.shape == l_plain.shape == (150, len(NAMES))
              and bool(np.isfinite(l_kernel).all()) and bool(np.isfinite(l_plain).all()),
              "conv path logits")
        route_diff = np.abs(l_kernel - l_plain)
        corr = float(np.corrcoef(l_kernel.ravel(), l_plain.ravel())[0, 1])
        print(f"[conv] logits, default (kernel) vs knob-0 route: max diff {route_diff.max():.4g} "
              f"(tol {TOL_ROUTE}), mean {route_diff.mean():.4g} (tol {TOL_ROUTE_MEAN}), corr "
              f"{corr:.6f}; against float32: default max {np.abs(l_kernel - l_f32).max():.4g} mean "
              f"{np.abs(l_kernel - l_f32).mean():.4g}, knob-0 max "
              f"{np.abs(l_plain - l_f32).max():.4g} mean {np.abs(l_plain - l_f32).mean():.4g}",
              flush=True)
        check(float(route_diff.max()) <= TOL_ROUTE and float(route_diff.mean()) <= TOL_ROUTE_MEAN,
              "default route logits off the knob-0 route")

        def labels(pipe, logits):
            return [s["label"] for s in pipe.analyze_windows(windows, stamps,
                                                             logits=logits)["segments"]]

        lab_k, lab_0 = labels(pk, l_kernel), labels(p0, l_plain)
        for route, labs in (("default", lab_k), ("knob-0", lab_0)):
            bad = [i for i in range(150) if clear[i] and labs[i] != lab32[i]]
            print(f"[conv] {route} route vs float32 labels: {int(clear.sum()) - len(bad)}/"
                  f"{int(clear.sum())} clear windows agree "
                  f"({sum(a == b for a, b in zip(labs, lab32))}/150 overall; "
                  f"{sum(a == b for a, b in zip(lab_k, lab_0))}/150 between the routes)",
                  flush=True)
            check(not bad, f"{route} route and float32 verdicts differ on clear windows {bad}")

        # steady-state throughput at batch 128, the routes in turns
        wps = {"default": [], "knob-0": [], "float32": []}
        for route, pipe in (("default", pk), ("knob-0", p0), ("knob-0", p0), ("default", pk),
                            ("float32", p32)):
            wps[route].append(windows_per_s(pipe, windows))
        for route, vals in wps.items():
            print(f"[conv] pipeline {route:8s} 150 windows at 512², batch 128: "
                  f"{' / '.join(f'{v:.1f}' for v in vals)} windows/s (median of 5 each)",
                  flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # 8. report
    z = k1_report[True]
    k1_bound, k1_by = k1_report["bound"]
    report = [{
        "name": "K1 melspec_factored",
        "route": "cuda",
        "source": cuda_melspec.SOURCE,
        "replaces": cuda_melspec.REPLACES,
        "launches": sum(c[k1.name] for c in cli_launches.values()),
        "max_abs_err": z["err"],
        "tol": f"{z['tol']:g} on z-scores at [128, 128000], against the plain version",
        "max_abs_err_db": k1_report[False]["err"],
        "tol_db": f"{k1_report[False]['tol']:g} dB, standardize=False",
        "max_abs_diff_vs_f32": z["err32"],
        "ms": z["ms"],
        "plain_ms": z["plain_ms"],
        "bound_ms": k1_bound,
        "bound_by": k1_by,
        "bound_share": k1_bound / z["ms"],
        "dft_halo_factor": k1_report["dft_halo_factor"],
        "launch_ms": k1_report["launch_ms"],
        "library_ms": k1_report["library_ms"],
        "library": LIBRARY_LOG_MEL,
        "lowp_tail_max_abs_err": z["lowp"]["err"],
        "lowp_tail_max_abs_err_db": k1_report[False]["lowp"]["err"],
        "lowp_tail_one_ulp_share": z["lowp"]["one_ulp_share"],
        "lowp_tail_tol": "bf16 out; |kernel − plain| ≤ 2^-7·|plain| + 2^-9 + 10·log10(1 + 2^-7) "
                         "dB (on z-scores over the window's dB std), on z-scores and dB",
        "lowp_tail_max_abs_diff_vs_f32_tail": z["lowp"]["err_vs_f32_tail"],
        "lowp_tail_ms": z["lowp"]["ms"],
    }, {
        "name": "K2 melspec_strip",
        "route": "cuda",
        "source": cuda_melspec_strip.SOURCE,
        "replaces": cuda_melspec_strip.REPLACES,
        "entry": "cuda_melspec_strip.fused_log_mel",
        "launches": front_launches[k2.name],
        "max_abs_err": k2_report["err"],
        "tol": f"{TOL_Z:g} on z-scores at [128, 128000], against the plain version",
        "vs_f32_front_end": {"excess_over_0.05+0.05|ref|": k2_report["excess32"],
                             "abs_mean_diff": k2_report["d_mean"],
                             "abs_std_diff": k2_report["d_std"]},
        "mean_abs_diff_vs_k1": k2_report["vs_k1"],
        "deterministic": k2_report["deterministic"],
        "ms": k2_report["ms"],
        "plain_ms": k2_report["plain_ms"],
        "bound_ms": k2_report["bound"][0],
        "bound_by": k2_report["bound"][1],
        "bound_share": k2_report["bound"][0] / k2_report["ms"],
        "dft_tiling_factor": k2_report["dft_tiling_factor"],
        "launch_ms": k2_report["launch_ms"],
        "dft_launch_tflops": k2_report["dft_launch_tflops"],
        "library_ms": k1_report["library_ms"],
        "library": LIBRARY_LOG_MEL,
        "front_end_windows_per_s": {str(size): v for size, v in front_wps.items()},
    }]
    conv_launches = path_launches[conv.name]
    tol = ("|kernel − plain| ≤ 2^-7·|plain| + 1e-5·max(1, √(K / 576)) for sums of K products "
           "(one bf16 ulp, and the sums' order near 0), bf16 out with ReLU on and off, and "
           "float32 out")
    report.append({
        "name": "K3 conv3x3_bn_relu",
        "route": "cuda",
        "source": cuda_conv.SOURCE,
        "replaces": cuda_conv.REPLACES["K3"],
        "entry": "cuda_conv.conv3x3_bn_relu",
        "kernel": f"{cuda_conv.LIBRARY}: wgmma fed by a TMA ring",
        "launches": conv_launches,
        "max_abs_err": max(r["max_abs_err"] for r in conv_rows),
        "tol": tol,
        "per": f"the {CONV_LAUNCHES_PER_BATCH} conv-kernel launches of one 128-window batch "
               "at 512² (sixteen 3x3 convs, three 1x1 downsamples at the centre tap)",
        "ms": conv_total["ms"],
        "plain_ms": conv_total["plain_ms"],
        "bound_ms": conv_total["bound_ms"],
        "bound_by": conv_total["bound_by"],
        "library_ms": conv_total["library_ms"],
        "library": "cuDNN on BN folded into the bf16 weight and bias, then the ReLU",
        "downsamples": {"ms": conv_total["downsample_ms"],
                        "plain_ms": conv_total["downsample_plain_ms"],
                        "library_ms": conv_total["downsample_library_ms"]},
        "stem_ms": stem,
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
    library = {"P1": "torch.matmul on the slice",
               "P2": "F.conv1d with 2 taps on the sliced rows",
               "P3": "F.conv1d with 9 taps on the sliced rows"}
    for pid, r in probe_rows.items():
        report.append({
            "name": f"{pid} helper probe",
            "route": "cuda",
            "source": cuda_probes.SOURCE,
            "replaces": cuda_probes.REPLACES[pid],
            "entry": f"cuda_probes.{r['entry']}",
            # one kernel for the three probes: three launches on the probes
            # path, one per probe (drive_probes)
            "launches": probe_launches[probes.name] // len(probe_rows),
            "max_abs_err": r["max_abs_err"],
            "tol": "|kernel − plain| ≤ 2^-7·|plain| + 1e-5 (one bf16 ulp)",
            "per": "one call at the Pallas shapes",
            "ms": r["ms"],
            "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "library_device_ms": r["library_device_ms"],
            "library": library[pid],
        })
    print(json.dumps({"kernels": report}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
