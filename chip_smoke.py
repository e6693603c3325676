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
             (tiled, flat, flat_static) at the layer-1 shape;
           - the stem kernel (7x7/2 conv, BN affine, one bf16 rounding, 3x3/2
             max-pool and ReLU in one launch) at [128, 3, 512, 512], on one
             plane as a broadcast view and on three channels, against its
             plain version, timed in turns with the knob-0 route and the
             BN-folded bf16 cuDNN stem, with its bound and ptxas lines;
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
           per 128-window batch (38), one K1 and one stem-kernel launch per
           batch, none of K2; none of the conv kernel in float32. Its logits against the
           knob-0 route of the same pipeline (every conv the plain
           composition, the same numerics) within TOL_ROUTE at most and
           TOL_ROUTE_MEAN on average, and both
           routes' labels on every clear window against float32. Then the
           steady-state windows per second of both bf16 routes and of
           float32, in turns, at batch 128.
8. train   the submodel trainer through its CLI main() at full width
           (ResNet-18, 512², --bf16, --batch-size 16 = 32 rows) on a seeded
           split tree written to the build directory (47 8-s files and one
           too short in train/, 16 in test/): 3 epochs (layer3 unfreezes
           at epoch 1), --resume from the best checkpoint's .pth twin to 4
           epochs, --evaluate; counts zeroed before each run and read after:
           K1 launched once per train step, never in an eval step (its
           mel is the float32 GEMM mel, as the reference's), and no other
           kernel.
           Checks: finite losses; epoch 0 moves layer4 and the head and every
           BN statistic of the stem and layer1-3 but no frozen weight; epoch
           1 moves layer3; the resume starts at the saved epoch + 1 with the
           .pth's moments bit for bit. Then the bf16 step's median ms, rows/s
           and peak memory at 512², 32 rows, both phases; and one float32
           step on the card against the same step on the CPU (128², 4 rows).
           Before all this, in the kernels phase, K1 under
           SpectrogramConfig.train() (dB only) at [32, 128000] against its
           plain version: float32 and int16 windows and 8 zero tail rows,
           identical bits across runs, z-scores too, and its time beside
           the library composition of the same dB plane (torch.stft → |X|²
           → filterbank matmul → dB).
9. trunk   a trunk-shared ensemble (stem to layer3 shared, layer4 and the
           heads per sub-model) through the CLI from its .pth and from
           save_merged_native's file: the JSON of the dense layout of the
           same weights, and one trunk pass per batch.
10. ensemble the ensemble-building path at full width (ResNet-18, 512²,
           --bf16, 16 files = 32 rows a step) on a seeded split tree (Real
           and SynA-SynD, 8 train and 4 test files each), every run
           through a CLI's main() with the counts zeroed before and read
           after: cli/ensemble_trainer with K = 0 (3 epochs), with
           --per-head-stages 1 --generic-head (3 epochs), and --resume of
           the first to 4 epochs: K1 once per train and per eval step (the
           eval step takes the train step's mel), no other kernel; finite
           losses; epoch 0 moves the heads and layer4 (each head's own for
           K = 1) and no frozen weight, epoch 1 moves layer3; the resume
           starts at the saved epoch + 1 with its moments bit for bit.
           cli/add_head grows the K = 0 artifact by SynD (2 epochs): K1
           once per train and eval step; the backbone and existing heads
           bit-identical. cli/model_merger merges phase 8's two sub-model
           .pth files, with the default and the reference's strict=False
           semantics. Each artifact served by the CLI on the 10-minute
           clip: every window labelled; K1 once per batch; the conv kernel
           19 times per batch on the shared backbones (the K = 0 and the
           grown artifact), never on the others; the K = 1 artifact's trunk
           once per batch. Then the bf16 joint step (3 heads, K = 0 and
           K = 1) and the add-head step: median ms of 20, rows/s, peak
           memory.
11. daemon  infer/server.serve() on 127.0.0.1:0 in a thread, over phase 6's
           shared checkpoint as cli/serve builds it (bf16, 512², batch 128,
           micro-batching on, warmed up), beside a second server without
           micro-batching on the same pipeline; counts zeroed after the
           warm-up and read at the end, the rows of every device dispatch
           recorded. Checks: /healthz; /analyze of the 20-s clip has the
           CLI's labels on every clear window; per_head=1 adds the per-head
           key; 16 concurrent /analyze (8 client threads, 20-s clips of 5
           windows) take fewer dispatches than requests, with each clip's
           lone labels (but where a lone sigmoid lies within 0.01 of a
           decision boundary) and logits within TOL_ROUTE of the lone ones;
           a /stream session at source_rate=44100 fed 1-s int16 chunks
           finalizes to /analyze's labels on the same samples, percentages
           within 1e-3; ops/resample.resample_bucketed on the card within
           1e-5 of resample_poly_np; K1 once and the conv kernel 19 times
           per bucket batch dispatched, nothing else. Prints windows/s and
           requests/s of the 16-request burst with and without
           micro-batching in turns, the p50 latency of a lone /analyze, one
           dispatch's ms at 5, 10, 35 and 128 windows, and the median ms of
           a 1-s stream feed.
12. legacy  a seeded 5-class ResNet-152 .pth (flax's default init) through
           cli/legacy_inference main() on the 20-s clip in float32 and with
           --bf16: the JSON covers the 5 classes with time-ordered segments;
           bf16 and float32 argmax agree where the float32 top probability
           leads by more than 0.05; the card's float32 probabilities within
           1e-4 of the CPU's on a 5-s clip; then cli/legacy_trainer main()
           for one epoch at 512², --batch-size 8, on a seeded tree of the
           five legacy class folders: finite losses, epoch_0_acc_*.ckpt.
           No kernel launches anywhere in the phase (float32 cuDNN and the
           GEMM mel, as the reference runs no Pallas kernel here).
13. release the release path at full width on phase 10's K = 0 joint
           artifact (shared backbone) and its split tree (Real, SynA-SynD;
           SynD names no class of the artifact: skipped by the calibration
           fit, scored as unseen), every tool through its main(argv) with
           --bf16 at 512², batch 128, counts zeroed before each run and read
           after, the device batches counted: tools/calibrate_ensemble fits
           on train/ with the held-out ECE on test/, written as .pth and as
           native (the same temperatures, reloaded, engaged by serving), and
           fits the K = 1 generic-head artifact with its generic column;
           tools/accuracy_study on test/ with and without the calibration,
           tools/robustness_study at 20 dB SNR and the 8-kHz lowpass,
           tools/decision_ab (its reference variant scores each class as the
           uncalibrated pipeline's labels do). K1 once per batch and the conv
           kernel 19 times per batch on the K = 0 artifact, K1 only on the
           K = 1 one, nothing else. Then infer/export main() exports the
           calibrated checkpoint on the card (bf16, 512², int16, entries 8
           and 128; its bytes within 5% of its weights' and lifted constants'
           bytes) and InferencePipeline.from_artifact loads it;
           tools/artifact_drive holds it on test/ to the matched live forward
           (bit for bit) and the production pipeline's labels on windows
           clear by 0.05 (at least one in each drive), with no hand-written
           kernel launched by the artifact: on the raw logits
           (--no-calibration: the short fit's temperatures, at their bound,
           put every calibrated sigmoid near 0.5), and the same for phase 6's
           shared checkpoint, exported by the tool, with its calibration;
           cli/serve --artifact's pipeline behind server.serve() answers
           /analyze of the 20-s clip with from_artifact's JSON, calibration
           applied, launching no kernel. Prints each tool's
           seconds, the export's seconds and bytes, the windows/s on the
           150 windows of the artifact, of the same artifact exported with
           the float32 transport and of the live pipeline, in turns, and
           the host's int16 quantization of those windows.
14. data    the data-preparation path at full width on the host's cores and
           the card: tools/gen_study_corpus writes a seeded raw corpus (Real,
           SynthA, SynthB; 4 sources each, 13 s at 44.1 kHz, alternating mono
           and stereo); tools/study_pipeline runs the six ETL CLIs over it,
           each in a subprocess (rename, convert, augment, segment per class;
           split; leakage audit): the renamed sources carry their
           SHA-256[:16] names, every converted file is 32 kHz mono PCM_16,
           11 augmented files a source with the CSV, segments of 4 s or a
           source's trailing part, no source group on both sides, and an
           .mp3 without ffmpeg gives the clear error, counted; each CLI's
           seconds. audio/native builds libsadio from native/sadio.cpp in
           this run: decode_batch over every segment within 1e-7 of wavio,
           resample_poly within both float32 sums' rounding bound of
           resample_poly_np, both paths' seconds. Then at 512², --bf16, 16
           files a step, counts zeroed before and read after each run: the
           submodel trainer CLI (Real vs SynthA, 2 epochs) and a Trainer
           under checkpoint_backend="orbax" (Real vs SynthB, 2 epochs, then
           an epoch at a time to a third save; max_to_keep 2): K1 once per
           train step and no other kernel, finite losses; the retained step
           directories (named by total_steps, the newest 2) restore bit for
           bit to host copies taken at save time; the .pth twin resumes at
           its epoch + 1 with its moments bit for bit; save()'s median ms
           against wait()'s after an epoch of training. cli/model_merger
           merges the two heads; cli/inference_runner (folder mode) serves
           every test segment: every window labelled, K1 once per batch, the
           conv kernel as the layout implies. utils/profiling.trace around
           one serving batch writes a trace naming K1's DFT launch; a
           StageTimer over 16 files reports each stage.
15. parallel torch.distributed in an NCCL group of world size 1 (a file
           store in the build directory) at full width: the data-parallel
           Trainer (its mesh) and the plain Trainer from one seed, 3 bf16
           train steps (512², 32 rows, phase 1) on the same batches of phase
           8's tree: parameters, BN statistics, moments and count bit for
           bit, K1 once a step and nothing else, every step the same
           all-reduces (STEP_ALL_REDUCES, the count of the CPU test on 2 and
           3 ranks) and no other collective; python -m torch.distributed.run
           --standalone --nproc-per-node 1 -m ...cli.submodel_trainer for one
           epoch on phase 8's tree: exit 0, the checkpoint written once;
           InferencePipeline(mesh=...) on phase 6's shared checkpoint over
           the 150 windows (bf16, 512², batch 128): logits bit for bit with
           the pipeline without a mesh, K1 once and the conv kernel 19 times
           a batch, one all-gather a batch and no other collective; the
           step's median ms without and with the group, in turns.
16. int8   models/quantized.py on phase 6's shared checkpoint, on the 512²
           bf16 features of the 150 windows (K1, the resize) in the 128
           bucket: 20 _int_mm launches a batch; the card against the CPU on
           2 windows (stem accumulators bit for bit, logits within 1e-4);
           argmax agreement with the float32 pipeline: reported for windows
           whose float32 top logit leads by more than 0.05, and required on
           every window whose lead exceeds the largest change int8 makes to
           such a lead on 128 held-out windows of another clip (at least
           one); windows/s of the int8 backbone and heads against the bf16
           default route on the same features, in turns.
17. campaigns the study-campaign drivers (tools/campaign and the seven
           ports of the repository's tools/*.sh) on phase 14's prepared tree
           (Real, SynthA, SynthB) at the drivers' defaults (native input,
           bf16, batch 128) but EPOCHS=1, every step a fresh process on the
           card: the drivers' step interpreter is swapped for CHILD, which
           runs the step's main(argv) with the kernels' counts zeroed and
           appends the step, its exit code, seconds and launches to a JSON
           file. train_study_ensemble with HARD_NEG=1 (two heads, recipe.csv,
           merged dense, studied), with JOINT=1 PER_HEAD_STAGES=1 and with
           JOINT=1 (K = 0); generalization_study holding out SynthA (a
           one-head joint ensemble on SynthB; the full and unseen studies,
           the symlinked unseen tree, the summary row);
           logo_calibration_followup on it; round5_addhead_study growing
           SynthA back; round4_campaign's A/B of the LOGO artifact, then
           round5_phase2 on it (carve_eval_split, the CAL-fitted A/B, the
           synthesized train-fit cache and the offline A/B); round 4's
           native profile (tools/profile_serving --input-size native
           --mono). Checks: every driver and step exits 0 (campaign.log's
           rc=0 lines); K1 launched in every trainer, study, calibration and
           A/B step that touches the card; the conv kernel a positive
           multiple of 19 in the serving steps of the shared-backbone
           artifacts (K = 0, LOGO, calibrated, grown) and none on the dense
           and K = 1 ones; every study's per_class finite; the recipe, class
           orders, symlinks and tables. Prints each step's seconds and
           launches and the phase's seconds.
18. s2d     the space-to-depth stage 1 (ops/space_to_depth.py) at full
           width: (a) InferencePipeline(use_s2d_layer1=True) on phase 6's
           shared checkpoint and the 150 windows, float32 (logits within
           TOL_S2D_F32 of the default pipeline's, no kernel) and bf16 (the
           plain backbones with the s2d stage 1 instead of the fast
           backbone: one K1 launch a batch and nothing else, clear labels
           equal to float32's, the gap to the bf16 default printed), the
           module path alone with the flag on and off on the same bf16
           features (clear labels equal), windows/s of the four routes in
           turns; (b) the submodel trainer CLI on phase 8's tree, bf16 at
           512², one epoch (3 steps of 32 rows), with and without
           --s2d-layer1, with and without the stop-grad boundary: exit 0,
           one K1 launch a step, the first step's loss within TOL_S2D_LOSS
           of the plain run's, the step's ms and rows/s; and the bound's
           control: fresh trainers from the CLI's configuration take one
           step on one batch, plain, s2d and s2d with a broken fold (the
           H-mirrored kernel), the s2d loss within TOL_S2D_LOSS of the
           plain one and the broken one beyond it.
19. report the train step's, the trunk runs', the ensemble, daemon, legacy,
           release, data, parallel, int8, campaign and s2d phases' numbers,
           one JSON line of kernels, the nvidia-smi line, and last {"ok":
           true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import glob
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
    # the profiler on the card has come back with no device event at all
    # now and then (one trace in the runs of this script so far); such a
    # trace measured nothing, so it is taken again, up to twice
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            break
        print(f"[kernels] torch.profiler recorded no device event (trace {attempt + 1}); "
              "tracing again", flush=True)
    split = {}
    for e in events:
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


def library_log_mel_ms(x, cfg, ref32, standardize=True, tol=1e-3):
    """The standardized log-mel (or with ``standardize`` False the clamped
    dB plane) as a composition of library calls, not one call: torch.stft
    (cuFFT; centre reflect pad, periodic Hann) → |X|² → the filterbank's
    torch.matmul → dB with the top_db clamp (→ standardize). Checked
    against the float32 factored front end (the same function to float32
    rounding) within ``tol``; → its median time in ms."""
    import torch

    from synthetic_audio_detection_tpu_torch.ops import melspec

    fb_t = torch.as_tensor(melspec.config_filterbank(cfg, SR).T.copy()).cuda()  # [n_mels, bins]
    window = torch.hann_window(cfg.n_fft, periodic=True, device="cuda")

    def library():
        spec = torch.stft(x, cfg.n_fft, cfg.hop_length, window=window, center=True,
                          pad_mode=cfg.pad_mode, return_complex=True)
        mel = torch.matmul(fb_t, spec.real.square() + spec.imag.square())
        db = melspec.amplitude_to_db(mel, cfg.top_db)
        return melspec.standardize(db, cfg.eps) if standardize else db

    got = library()
    torch.cuda.synchronize()
    err = float((got - ref32).abs().max())
    ms = median_ms(library)
    what = "dB → standardize" if standardize else "dB"
    print(f"[kernels] K1/K2's function as library calls (torch.stft → |X|² → filterbank matmul → "
          f"{what}) at {list(x.shape)}: {ms:.4f} ms, max|library - float32 factored| {err:.3g} "
          f"(≤ {tol:g})", flush=True)
    check(err <= tol, f"the library composition ({what}) disagrees with the float32 front end")
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
    """The stem kernel (ops/cuda_stem.py: the 7x7/2 conv, the BN affine, one
    bf16 rounding, the 3x3/2 max-pool and the ReLU in one launch) as
    FastResNet.stem_pool runs it at 512² and batch 128, on the serving input
    (one log-mel plane on three channels as a broadcast view) and on three
    materialized channels, against its plain version (one bf16 ulp, at most
    0.1% of the outputs not bit-equal, one launch a call); then timed in
    turns with the knob-0 route (the plain composition: a float32 cuDNN conv
    of the one plane with the channel-summed bf16 weight, TF32 off, the
    float32 affine, one rounding, the max-pool) and with BN folded into a
    bf16 cuDNN conv (the yardstick; the port never calls it); → report."""
    import torch
    import torch.nn.functional as F

    from synthetic_audio_detection_tpu_torch.models.fast_resnet import FastResNet
    from synthetic_audio_detection_tpu_torch.models.resnet import create_resnet
    from synthetic_audio_detection_tpu_torch.ops import cuda_stem

    g = torch.Generator(device="cuda").manual_seed(7)
    net = create_resnet("resnet18").cuda().eval()
    with torch.no_grad():
        net.conv1.weight.copy_(torch.randn(64, 3, 7, 7, generator=g, device="cuda")
                               * (2.0 / 147) ** 0.5)
        net.bn1.weight.uniform_(0.5, 1.5, generator=g)
        net.bn1.bias.normal_(0.0, 0.1, generator=g)
    fast, plain = FastResNet(net, torch.bfloat16, 512), FastResNet(net, torch.bfloat16, 0)
    stem = fast.kernel_stem
    plane = torch.randn(BATCH, 1, 512, 512, generator=g, device="cuda").to(torch.bfloat16)
    one_plane = plane.expand(BATCH, 3, 512, 512)
    three = one_plane.contiguous()
    errs, not_equal = [], []
    for label, x in (("one plane", one_plane), ("three channels", three)):
        before = cuda_stem.KERNEL.launches
        got = fast.stem_pool(x)
        torch.cuda.synchronize()
        check(cuda_stem.KERNEL.launches == before + 1, f"one stem launch on {label}")
        ref = cuda_stem.stem_pool_plain(x, stem.weight, stem.scale, stem.bias)
        got = got.permute(0, 2, 3, 1)
        check(got.shape == ref.shape == (BATCH, 128, 128, 64) and got.dtype == torch.bfloat16,
              "stem output shape")
        err, ok = conv_err(got, ref, 147)
        frac = float((got != ref).float().mean())
        check(ok and frac <= 1e-3, f"the stem kernel on {label} disagrees with its plain version "
                                   f"(max {err}, {frac:.2e} not bit-equal)")
        errs.append(err)
        not_equal.append(frac)
    w_fold = (net.conv1.weight * plain.stem.scale[:, None, None, None]).to(torch.bfloat16)
    w_fold = w_fold.contiguous(memory_format=torch.channels_last)
    b_fold = plain.stem.bias.to(torch.bfloat16)
    three_cl = one_plane.contiguous(memory_format=torch.channels_last)
    routes = {
        "kernel": lambda: fast.stem_pool(one_plane),
        "plain": lambda: plain.stem_pool(one_plane),
        "library": lambda: F.max_pool2d(torch.relu(F.conv2d(three_cl, w_fold, b_fold, 2, 3)),
                                        3, 2, 1),
    }
    ms = {route: [] for route in routes}
    for route in list(routes) + list(routes)[::-1]:
        ms[route].append(median_ms(routes[route], n=20))
    three_ms = median_ms(lambda: fast.stem_pool(three), n=20)
    ops, nbytes = cuda_stem.work(BATCH, 3, 512, 512, planes=1)
    b_ms, b_by = bound([(ops, PEAK_BF16)], nbytes)
    ptxas = ptxas_by_instance(cuda_stem.LIBRARY, "stem_wgmma_kernel")
    k_ms = float(np.median(ms["kernel"]))
    print(f"[kernels] stem [{BATCH},3,512,512] (one plane) 7x7 s2 + BN + max-pool + ReLU: kernel "
          f"{' / '.join(f'{v:.4f}' for v in ms['kernel'])} ms, plain (knob 0) "
          f"{' / '.join(f'{v:.4f}' for v in ms['plain'])}, cuDNN folded bf16 "
          f"{' / '.join(f'{v:.4f}' for v in ms['library'])} (in turns); three materialized "
          f"channels {three_ms:.4f}; bound {b_ms:.4f} ms ({b_by}: {ops / 1e9:.1f} GFLOP of the "
          f"three channels' products, {ops / PEAK_BF16 * 1e3:.4f} ms; {nbytes / 1e6:.1f} MB, "
          f"{nbytes / HBM_BYTES_S * 1e3:.4f} ms), {b_ms / k_ms:.1%} of it; max|kernel-plain| "
          f"{max(errs):.3g}, not bit-equal {max(not_equal):.2e}", flush=True)
    for inst, lines in sorted(ptxas.items(), key=str):
        print(f"[kernels] stem ptxas <C, one plane> = {inst}: {'; '.join(lines)}", flush=True)
    check(k_ms <= 1.0, f"the stem kernel took {k_ms:.4f} ms at [{BATCH}, 3, 512, 512]")
    return dict(ms=k_ms, runs_ms=ms, three_channels_ms=three_ms,
                plain_ms=float(np.median(ms["plain"])),
                library_ms=float(np.median(ms["library"])), bound_ms=b_ms, bound_by=b_by,
                gflop=ops / 1e9, mb=nbytes / 1e6, max_abs_err=max(errs),
                not_equal=max(not_equal), ptxas={str(k): v for k, v in ptxas.items()})


PROBE_SHAPES = {"P1": (64, 64), "P2": (64, 64), "P3": (9, 64, 64)}


def ptxas_by_instance(name: str, kernel: str):
    """{n: ptxas lines} for each instance kernel<n> in the build log of
    csrc/<name>.cu ({(a, b): lines} for kernel<a, b>)."""
    from synthetic_audio_detection_tpu_torch.ops import build

    out, entry = {}, None
    for line in build.build_log(name).splitlines():
        if "Compiling entry function" in line:
            # template arguments: Li<n>E (int), Lb<n>E (bool); one int is
            # the key, several a tuple
            m = re.search(kernel + r"I((?:L[a-z]\d+E)+)E", line)
            args = [int(v) for v in re.findall(r"L[a-z](\d+)E", m.group(1))] if m else []
            entry = None if not args else args[0] if len(args) == 1 else tuple(args)
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


# ---------------------------------------------------------------------------
# The training path
# ---------------------------------------------------------------------------

TRAIN_ROWS = 32  # --batch-size 16: two 4-s segments a file
TRAIN_FILES = 47  # + one too short: three full batches of 16 files an epoch
TEST_FILES = 8    # per class: one batch of 16 files


def check_k1_train(k1, smi):
    """K1 under the training configuration (SpectrogramConfig.train():
    mel_norm None, dB only) against its plain version at [32, 128000]:
    seeded float32 windows, the same as int16 PCM, and a batch whose last 8
    rows are zero padding; TOL_DB on the dB plane and identical bits across
    runs; TOL_Z on z-scores. Its time at that shape; → report fields."""
    import torch

    from synthetic_audio_detection_tpu_torch.ops import cuda_melspec, melspec
    from synthetic_audio_detection_tpu_torch.utils.config import SpectrogramConfig

    cfg = SpectrogramConfig.train()
    x = torch.from_numpy((np.random.default_rng(2).standard_normal((TRAIN_ROWS, 128_000)) * 0.3)
                         .astype(np.float32)).cuda()
    pcm = torch.round(x * 32768).clamp(-32768, 32767).to(torch.int16)
    padded = pcm.clone()
    padded[TRAIN_ROWS - 8:] = 0
    errs = {}
    for name, inp in (("float32", x), ("int16", pcm), ("padded", padded)):
        got = k1(inp, cfg, standardize=False)
        again = k1(inp, cfg, standardize=False)
        ref = melspec.log_mel_factored(cuda_melspec.dequantize(inp), cfg, standardize=False,
                                       dft_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        check(got.shape == (TRAIN_ROWS, 128, 251) and bool(torch.isfinite(got).all()),
              f"K1 train config ({name}) shape/finite")
        check(torch.equal(got, again), f"K1 train config ({name}): bits differ across runs")
        errs[name] = float((got - ref).abs().max())
        check(errs[name] <= TOL_DB, f"K1 train config ({name}) dB off its plain version: "
                                    f"{errs[name]} > {TOL_DB}")
    z = k1(x, cfg, standardize=True)
    z_ref = melspec.log_mel_factored(x, cfg, standardize=True, dft_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    errs["z"] = float((z - z_ref).abs().max())
    check(errs["z"] <= TOL_Z, f"K1 train config z-scores off: {errs['z']} > {TOL_Z}")
    ms = median_ms(lambda: k1(x, cfg, standardize=False))
    ms_int16 = median_ms(lambda: k1(pcm, cfg, standardize=False))
    plain_ms = median_ms(lambda: melspec.log_mel_factored(x, cfg, standardize=False,
                                                          dft_dtype=torch.bfloat16))
    library_ms = library_log_mel_ms(x, cfg, melspec.log_mel_factored(
        x, cfg, standardize=False, dft_dtype=torch.float32), standardize=False, tol=TOL_DB)
    c = k1.constants(cfg, SR, x.device)
    w = cuda_melspec.work(c, cfg, TRAIN_ROWS, 128_000)
    nbytes = (x.numel() * 4 + TRAIN_ROWS * cfg.n_mels * 251 * 4
              + sum(c[k].numel() * c[k].element_size() for k in ("cs", "f0", "weights", "ends",
                                                                  "quads")))
    b_ms, b_by = bound([(w["dft_min"], PEAK_BF16), (w["mel_min"], PEAK_F32)], nbytes)
    print(f"[kernels] K1 SpectrogramConfig.train() dB at [{TRAIN_ROWS}, 128000]: max|kernel-plain| "
          f"float32 {errs['float32']:.3g}, int16 {errs['int16']:.3g}, 8 zero tail rows "
          f"{errs['padded']:.3g} dB (tol {TOL_DB}), identical bits across runs; z {errs['z']:.3g} "
          f"(tol {TOL_Z}); kernel {ms:.4f} ms float32 in, {ms_int16:.4f} ms int16 in, plain "
          f"{plain_ms:.4f} ms, library (torch.stft → |X|² → filterbank matmul → dB) "
          f"{library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) | {smi}", flush=True)
    return dict(errs=errs, ms=ms, ms_int16=ms_int16, plain_ms=plain_ms, library_ms=library_ms,
                bound=(b_ms, b_by))


def write_train_tree(root):
    """train/ and test/ × Real, SynthA: 8-s 32 kHz PCM_16 WAVs (two
    segments each) from a seed, Real broadband noise and SynthA noise under
    a few harmonics; plus one 1-s file in train/Real that the short-file
    policy drops."""
    from synthetic_audio_detection_tpu_torch.audio import wavio

    rng = np.random.default_rng(11)
    t = np.arange(8 * SR) / SR
    counts = {"train": {"Real": TRAIN_FILES - TRAIN_FILES // 2, "SynthA": TRAIN_FILES // 2},
              "test": {"Real": TEST_FILES, "SynthA": TEST_FILES}}
    for split, per in counts.items():
        for cls, n in per.items():
            os.makedirs(os.path.join(root, split, cls))
            for i in range(n):
                x = rng.standard_normal(t.size) * rng.uniform(0.05, 0.2)
                if cls == "SynthA":
                    f0 = rng.uniform(150, 600)
                    x = x + sum(0.2 / k * np.sin(2 * np.pi * k * f0 * t) for k in (1, 2, 3))
                wavio.write_wav(os.path.join(root, split, cls, f"{cls}_{i:02d}.wav"),
                                np.clip(x, -1, 1).astype(np.float32), SR)
    wavio.write_wav(os.path.join(root, "train", "Real", "short.wav"),
                    np.zeros(SR, np.float32), SR)


def _stage(key: str) -> int:
    """base.layer3.1.conv1.weight → 3; the stem → 0; the head → 5."""
    if key.startswith("head."):
        return 5
    part = key.split(".")[1]
    return int(part[len("layer"):]) if part.startswith("layer") else 0


def _changed(a, b, keys):
    import torch

    return {k for k in keys if not torch.equal(a[k], b[k])}


@contextlib.contextmanager
def observing(cls):
    """While open, the trainer class ``cls``'s train_epoch, validate and
    resume also record what they do, without changing it, into the yielded
    dict: the trainers seen (``trainers``), each epoch's (trainer, epoch,
    layer3_unfrozen, weights before, weights after) (``epochs``), the
    train and val losses (``losses``), and each resume's (path, start
    epoch, Adam count, mu, nu) (``resumed``)."""
    seen = {"trainers": [], "epochs": [], "losses": [], "resumed": []}
    names = ("train_epoch", "validate", "resume")
    orig = {n: getattr(cls, n) for n in names}
    own = {n: n in cls.__dict__ for n in names}

    def cpu_state(tr):
        return {k: v.detach().float().cpu().clone() for k, v in tr.model.state_dict().items()
                if not k.endswith("num_batches_tracked")}

    def note(tr):
        if tr not in seen["trainers"]:
            seen["trainers"].append(tr)

    def train_epoch(self, batcher, epoch):
        note(self)
        before = cpu_state(self)
        out = orig["train_epoch"](self, batcher, epoch)
        seen["epochs"].append((self, epoch, self.layer3_unfrozen, before, cpu_state(self)))
        seen["losses"].append(out["loss"])
        return out

    def validate(self, batcher, epoch):
        note(self)
        out = orig["validate"](self, batcher, epoch)
        seen["losses"].append(out.val_loss)
        return out

    def resume(self, path):
        orig["resume"](self, path)
        mu, nu = self.state.moments()
        seen["resumed"].append((path, self.start_epoch, int(self.state.count),
                                {k: v.detach().cpu().clone() for k, v in mu.items()},
                                {k: v.detach().cpu().clone() for k, v in nu.items()}))

    for name, fn in zip(names, (train_epoch, validate, resume)):
        setattr(cls, name, fn)
    try:
        yield seen
    finally:
        for name in names:
            if own[name]:
                setattr(cls, name, orig[name])
            else:
                delattr(cls, name)


def drive_trainer(zero_counts, counts, k1_name, work):
    """The submodel trainer through its CLI main() on the card: --bf16 at
    512², batch 16 files (32 rows), 3 epochs, then --resume from the best
    checkpoint's .pth twin to 4 epochs, then --evaluate; counts zeroed
    before each run and read after it, the Trainer observed
    (``observing``). → report fields."""
    import torch

    from synthetic_audio_detection_tpu_torch.checkpoints import torch_compat
    from synthetic_audio_detection_tpu_torch.cli import submodel_trainer
    from synthetic_audio_detection_tpu_torch.train.trainer import Trainer

    data = os.path.join(work, "train_data")
    write_train_tree(data)
    common = ["--data-dir", data, "--Class0", "Real", "--Class1", "SynthA", "--batch-size", "16",
              "--input-size", "512", "--bf16", "--device", "cuda", "--workers", "8",
              "--log-dir", os.path.join(work, "runs")]
    ck = os.path.join(work, "ck")
    runs = [("fit", ["--epochs", "3", "--checkpoint-dir", ck]),
            ("resume", ["--epochs", "4", "--checkpoint-dir", os.path.join(work, "ck2"),
                        "--resume", os.path.join(ck, "best_model.ckpt.pth")]),
            ("evaluate", ["--evaluate", "--resume", os.path.join(ck, "best_model.ckpt")])]
    cwd = os.getcwd()
    launches, steps, seconds = {}, {}, {}
    os.chdir(work)  # the CLI writes its logs/ where it runs
    try:
        with observing(Trainer) as seen:
            for run, args in runs:
                seen["trainers"].clear()
                zero_counts()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    rc = submodel_trainer.main(common + args)
                seconds[run] = time.perf_counter() - t0
                check(rc == 0, f"trainer CLI ({run}) exit code {rc}")
                launches[run] = counts()
                tr = seen["trainers"][0]
                steps[run] = (tr.train_steps_run, tr.eval_steps_run)
                print(f"[train] {run}: {seconds[run]:.1f} s, {tr.train_steps_run} train and "
                      f"{tr.eval_steps_run} eval steps, launches {launches[run]}", flush=True)
                check(launches[run][k1_name] == steps[run][0],
                      f"{run}: K1 launched {launches[run][k1_name]} times for {steps[run][0]} "
                      "train steps (the eval step takes the GEMM mel)")
                check(sum(v for k, v in launches[run].items() if k != k1_name) == 0,
                      f"{run}: a kernel other than K1 launched")
    finally:
        os.chdir(cwd)

    check(steps["fit"] == (9, 3), f"fit ran {steps['fit']} train and eval steps, not (9, 3)")
    check(steps["evaluate"] == (0, 1), f"evaluate ran {steps['evaluate']}")
    check(all(np.isfinite(v) for v in seen["losses"]), "a train or val loss is not finite")
    # the freeze schedule, from the per-epoch weights of the fit run
    (_, e0, unf0, s0, s1), (_, e1, unf1, _, s2) = seen["epochs"][0], seen["epochs"][1]
    check(e0 == 0 and not unf0 and e1 == 1 and unf1, "epochs 0 and 1 and the unfreeze at 1")
    params = [k for k in s0 if "running" not in k]
    running = [k for k in s0 if "running" in k]
    frozen = [k for k in params if _stage(k) <= 3]
    moved0 = _changed(s0, s1, params)
    check(not moved0 & set(frozen),
          f"epoch 0 moved frozen weights: {sorted(moved0 & set(frozen))[:3]}")
    check(set(k for k in running if _stage(k) <= 3) <= _changed(s0, s1, running),
          "epoch 0 left a BN running statistic of the stem or layer1-3 unchanged")
    for blk in ("base.layer4.0.", "base.layer4.1.", "head."):
        check(any(k.startswith(blk) for k in moved0), f"epoch 0 did not move {blk}*")
    moved1 = _changed(s1, s2, params)
    check(any(_stage(k) == 3 for k in moved1), "epoch 1 (layer3 unfrozen) did not move layer3")
    check(not any(_stage(k) <= 2 for k in moved1), "epoch 1 moved the stem or layer1-2")
    # the resume: start epoch and the .pth's moments, bit for bit
    path, start, count, mu, nu = seen["resumed"][0]
    obj = torch.load(path, map_location="cpu", weights_only=True)
    check(start == int(obj["epoch"]) + 1, f"resume started at {start}, saved epoch {obj['epoch']}")
    keys = torch_compat.trainable_param_keys(obj["state_dict"], base_prefix="base.")
    state = obj["optimizer"]["state"]
    check(len(keys) == len(state) and count == int(state[0]["step"]), "resumed optimizer state")
    for i, k in enumerate(keys):
        check(torch.equal(mu[k], state[i]["exp_avg"])
              and torch.equal(nu[k], state[i]["exp_avg_sq"]),
              f"resumed moments of {k} differ from the .pth")
    check(steps["resume"] == (3 * (4 - start), 4 - start),
          f"resume ran {steps['resume']} steps from epoch {start}")
    print(f"[train] freeze checks: epoch 0 moved {len(moved0)} tensors (layer4 and the head) and "
          f"every stem/layer1-3 BN statistic, no frozen weight; epoch 1 moved layer3; resume at "
          f"epoch {start} with {len(keys)} moment pairs bit-equal to the .pth (step {count}); "
          f"losses {['%.4f' % v for v in seen['losses']]}", flush=True)
    return {"launches": launches, "steps": steps, "seconds": seconds,
            "k1_launches": sum(v[k1_name] for v in launches.values())}


def time_train_step(work, smi):
    """The bf16 train step at 512², 32 rows, on one batch of the tree: the
    median ms over back-to-back steps after warm-up (CUDA events), rows a
    second, and the peak memory allocated. The trained weights are saved
    (ck_timed/best_model.ckpt and its .pth twin) for the merger."""
    import torch

    from synthetic_audio_detection_tpu_torch.data import dataset as ds
    from synthetic_audio_detection_tpu_torch.train.trainer import Trainer
    from synthetic_audio_detection_tpu_torch.utils.config import SpectrogramConfig, TrainConfig

    cfg = TrainConfig(batch_size=16, compute_dtype="bfloat16", class1="SynthA", workers=8)
    tr = Trainer(cfg, spec_cfg=SpectrogramConfig(mel_norm=None, out_size=512),
                 log_dir=os.path.join(work, "runs_t"), device="cuda")
    samples = ds.list_samples(os.path.join(work, "train_data"), "train", ["Real", "SynthA"])
    batch = next(tr._batches(ds.WaveformBatcher(samples[:16], 16, shuffle=False, workers=8), 0,
                             TRAIN_ROWS))
    check(batch["audio"].dtype == torch.int16 and batch["audio"].shape[0] == TRAIN_ROWS,
          "bf16 on the card takes the int16 transport, 32 rows")
    out = {}
    for phase in (1, 2):
        if phase == 2:
            tr._unfreeze()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = median_ms(lambda: tr._train_step(tr.state, batch, tr.generator), n=20, warmup=3)
        out[phase] = dict(ms=ms, rows_per_s=TRAIN_ROWS / ms * 1e3,
                          peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        print(f"[train] bf16 train step, 512², {TRAIN_ROWS} rows, phase {phase} (gradient stops "
              f"at stage {4 if phase == 1 else 3}): {ms:.3f} ms median of 20 after 3 warm-up "
              f"(CUDA events), {out[phase]['rows_per_s']:.1f} rows/s, peak "
              f"{out[phase]['peak_gib']:.2f} GiB allocated | {smi}", flush=True)
    # its weights after these 46 steps: the merger phase's second sub-model
    os.makedirs(os.path.join(work, "ck_timed"))
    tr.save_checkpoint(0, os.path.join(work, "ck_timed", "best_model.ckpt"))
    return out


def check_float32_step_cuda_vs_cpu():
    """One float32 train step (128², 4 rows, the last weighted 0; the same
    initial weights and batch; dropout off) on the card and on the CPU:
    BN statistics within 1e-4·|cpu| + 1e-5, parameters within
    1e-5·|cpu| + 1e-6 where the AdamW step is well conditioned (|g| > 1e-6,
    from the CPU moments) and within 2·lr elsewhere (the bound of one
    step), the loss within 1e-5 relative. TF32 is off, so only the
    summation order differs."""
    import copy

    import torch

    from synthetic_audio_detection_tpu_torch.models.classifier import BinaryClassifier
    from synthetic_audio_detection_tpu_torch.train import steps
    from synthetic_audio_detection_tpu_torch.utils.config import (
        SpecAugmentConfig,
        SpectrogramConfig,
        TrainConfig,
    )

    cfg = TrainConfig(batch_size=2)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        model = BinaryClassifier()
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    audio = (np.random.default_rng(9).standard_normal((4, 128_000)) * 0.2).astype(np.float32)
    audio[3] *= 1e-3
    batch = {"audio": torch.from_numpy(audio), "label": torch.tensor([0, 1, 1, 0]),
             "weight": torch.tensor([1.0, 1.0, 1.0, 0.0])}
    step = steps.make_train_step(cfg, SpectrogramConfig(mel_norm=None, out_size=128),
                                 SpecAugmentConfig(enabled=False), stop_grad_stage=4)
    states, losses = [], []
    for dev in ("cpu", "cuda"):
        st = steps.create_train_state(copy.deepcopy(model).to(dev), cfg)
        m = step(st, {k: v.to(dev) for k, v in batch.items()}, None)
        losses.append(float(m["loss"]))
        states.append(st)
    cpu, gpu = states
    mu_cpu, _ = cpu.moments()
    a = {k: v.detach().cpu() for k, v in cpu.model.state_dict().items()}
    b = {k: v.detach().cpu() for k, v in gpu.model.state_dict().items()}
    worst = {"stats": 0.0, "well": 0.0, "ill": 0.0}
    for k, ref in a.items():
        if k.endswith("num_batches_tracked"):
            continue
        d = (b[k] - ref).abs()
        if "running" in k:
            worst["stats"] = max(worst["stats"], float((d - 1e-4 * ref.abs() - 1e-5).max()))
            continue
        well = (mu_cpu[k].abs() / 0.1 > 1e-6) if k in mu_cpu else torch.ones_like(d, dtype=bool)
        if well.any():
            worst["well"] = max(worst["well"], float((d - 1e-5 * ref.abs() - 1e-6)[well].max()))
        worst["ill"] = max(worst["ill"], float(d.max()) - 2 * cfg.lr)
    rel = abs(losses[0] - losses[1]) / abs(losses[0])
    print(f"[train] float32 step, CUDA vs CPU at 128², 4 rows: loss {losses[1]:.7f} vs "
          f"{losses[0]:.7f} (rel {rel:.2g}); worst excess over the bound: BN statistics "
          f"{worst['stats']:.3g}, well-conditioned parameters {worst['well']:.3g}, others "
          f"{worst['ill']:.3g} (all must be ≤ 0)", flush=True)
    check(rel <= 1e-5 and all(v <= 0 for v in worst.values()),
          "float32 train step on the card disagrees with the CPU")
    return dict(loss_rel=rel, **worst)


def trunk_state_dicts(sds):
    """Three sub-models sharing the stem and layer1-3 of the first (K = 1:
    each keeps its own layer4 and head)."""
    out = []
    for sd in sds:
        out.append({k: (sds[0][k] if k.startswith("base.") and _stage(k) <= 3 else v)
                    for k, v in sd.items()})
    return out


def drive_trunk_serving(zero_counts, counts, sds, work, clip, n_windows, k1_name):
    """A trunk-shared ensemble (K = 1) through the CLI, from its .pth and
    from save_merged_native's file, against the dense layout of the same
    weights (the pipeline with detection off): the same JSON; the trunk runs
    once per batch (a forward hook on the loaded trunk counts it)."""
    import torch

    from synthetic_audio_detection_tpu_torch.checkpoints import serialization
    from synthetic_audio_detection_tpu_torch.ensemble.multihead import build_ensemble
    from synthetic_audio_detection_tpu_torch.infer.pipeline import (
        InferencePipeline,
        preprocess_waveform,
        result_json,
        slice_waveform,
    )
    from synthetic_audio_detection_tpu_torch.utils.config import (
        AudioConfig,
        InferenceConfig,
        SpectrogramConfig,
    )

    trunk_sds = trunk_state_dicts(sds)
    ens = build_ensemble(trunk_sds, NAMES)
    check(ens.shared_trunk_stages == 1 and not ens.shared_backbone, "trunk-shared layout")
    paths = {"pth": os.path.join(work, "trunk.pth"), "native": os.path.join(work, "trunk.msgpack")}
    serialization.save_merged_torch(paths["pth"], ens)
    serialization.save_merged_native(paths["native"], ens)
    audio = AudioConfig(overlap=0.0, silence_threshold=1e-3)
    windows, stamps = slice_waveform(preprocess_waveform(clip, audio), audio)
    dense = InferencePipeline(build_ensemble(trunk_sds, NAMES, detect_shared_backbone=False),
                              audio=audio, spec=SpectrogramConfig.inference(out_size=512),
                              infer=InferenceConfig(), compute_dtype=torch.bfloat16, device="cuda")
    want = json.loads(result_json(clip, dense.analyze_windows(windows, stamps)))
    batches = -(-n_windows // BATCH)
    out = {}
    for fmt, path in paths.items():
        zero_counts()
        with counting_trunk_passes() as passes:
            res, sec = run_cli(["--merged-model", path, "--audio", clip,
                                "--output-json", os.path.join(work, f"trunk_{fmt}.json"),
                                "--bf16", "--input-size", "512", "--device", "cuda"])
        launches = counts()
        print(f"[trunk] {fmt}: {sec:.3f} s for {n_windows} windows (CLI wall), trunk passes "
              f"{passes[0]} for {batches} batches, launches {launches}; JSON equal to the "
              f"dense layout's: {res == want}", flush=True)
        check(passes[0] == batches, f"{fmt}: the trunk ran {passes[0]} times, not {batches}")
        check(launches[k1_name] == batches and sum(launches.values()) == batches,
              f"{fmt}: launches {launches}")
        check(res == want, f"{fmt}: the trunk-shared JSON differs from the dense layout's")
        out[fmt] = dict(seconds=sec, trunk_passes=passes[0], launches=launches)
    return out


@contextlib.contextmanager
def counting_trunk_passes():
    """While open, every ensemble that serialization.load_merged returns
    counts its shared trunk's forward passes into the yielded [count] (a
    forward hook; the loader is put back on exit)."""
    from synthetic_audio_detection_tpu_torch.checkpoints import serialization

    passes = [0]
    load = serialization.load_merged

    def counted(path, backbone="resnet18"):
        e = load(path, backbone)
        if e.trunk is not None:
            e.trunk.register_forward_hook(lambda *_: passes.__setitem__(0, passes[0] + 1))
        return e

    serialization.load_merged = counted
    try:
        yield passes
    finally:
        serialization.load_merged = load


# ---------------------------------------------------------------------------
# The ensemble-building path
# ---------------------------------------------------------------------------

ENSEMBLE_CLASSES = ["SynA", "SynB", "SynC"]
NEW_CLASS = "SynD"
ENSEMBLE_TRAIN_FILES = 8  # per class: Real + 3 classes = 32 files, two steps of 16
ENSEMBLE_TEST_FILES = 4   # per class: one eval step of 16 files


def write_ensemble_tree(root):
    """train/ and test/ × Real, SynA-SynD (write_class_tree)."""
    write_class_tree(root, ["Real"] + ENSEMBLE_CLASSES + [NEW_CLASS],
                     (ENSEMBLE_TRAIN_FILES, ENSEMBLE_TEST_FILES), seed=13)


def write_class_tree(root, classes, files, seed):
    """train/ and test/ × ``classes``, ``files`` = (train, test) files a
    class: 8-s 32 kHz PCM_16 WAVs from a seed; the first class broadband
    noise, class c noise under three harmonics of an f0 drawn from its own
    band (c · 150 Hz to c · 150 Hz + 100)."""
    from synthetic_audio_detection_tpu_torch.audio import wavio

    rng = np.random.default_rng(seed)
    t = np.arange(8 * SR) / SR
    for split, n in zip(("train", "test"), files):
        for c, cls in enumerate(classes):
            os.makedirs(os.path.join(root, split, cls))
            for i in range(n):
                x = rng.standard_normal(t.size) * rng.uniform(0.05, 0.2)
                if c:
                    f0 = 150 * c + rng.uniform(0, 100)
                    x = x + sum(0.2 / k * np.sin(2 * np.pi * k * f0 * t) for k in (1, 2, 3))
                wavio.write_wav(os.path.join(root, split, cls, f"{cls}_{i:02d}.wav"),
                                np.clip(x, -1, 1).astype(np.float32), SR)


def _quiet(fn, *args):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


def drive_joint_trainer(zero_counts, counts, k1_name, work, data):
    """cli/ensemble_trainer main() on the card at 512², --bf16, 16 files a
    step: K = 0 for 3 epochs (layer3 unfreezes at epoch 1), K = 1 with the
    generic head for 3 epochs, then --resume of the first run to 4 epochs;
    counts zeroed before each run and read after. JointTrainer's methods
    are wrapped to observe (per-epoch weights, losses, step counts, the
    resumed moments), not to change what they do. → report fields and the
    two runs' checkpoint paths."""
    import torch

    from synthetic_audio_detection_tpu_torch.checkpoints import serialization
    from synthetic_audio_detection_tpu_torch.cli import ensemble_trainer
    from synthetic_audio_detection_tpu_torch.train.joint import JointTrainer

    common = ["--data-dir", data, "--synthetic-classes", *ENSEMBLE_CLASSES, "--batch-size", "16",
              "--input-size", "512", "--bf16", "--device", "cuda", "--workers", "8",
              "--log-dir", os.path.join(work, "runs_joint")]
    ck = {0: os.path.join(work, "joint_k0"), 1: os.path.join(work, "joint_k1")}
    runs = [("K0", ["--epochs", "3", "--checkpoint-dir", ck[0]]),
            ("K1-generic", ["--epochs", "3", "--checkpoint-dir", ck[1], "--per-head-stages", "1",
                            "--generic-head"]),
            ("K0-resume", ["--epochs", "4", "--checkpoint-dir", os.path.join(work, "joint_k0b"),
                           "--resume", os.path.join(ck[0], "joint_model.ckpt")])]
    launches, steps, seconds = {}, {}, {}
    with observing(JointTrainer) as seen:
        for run, args in runs:
            seen["trainers"].clear()
            zero_counts()
            t0 = time.perf_counter()
            rc = _quiet(ensemble_trainer.main, common + args)
            seconds[run] = time.perf_counter() - t0
            check(rc == 0, f"ensemble trainer CLI ({run}) exit code {rc}")
            launches[run] = counts()
            tr = seen["trainers"][0]
            steps[run] = (tr.train_steps_run, tr.eval_steps_run)
            print(f"[ensemble] joint {run}: {seconds[run]:.1f} s, {steps[run][0]} train and "
                  f"{steps[run][1]} eval steps, launches {launches[run]}", flush=True)
            check(launches[run][k1_name] == sum(steps[run]),
                  f"{run}: K1 launched {launches[run][k1_name]} times for {steps[run]} train and "
                  "eval steps (both take the kernel's mel)")
            check(sum(v for k, v in launches[run].items() if k != k1_name) == 0,
                  f"{run}: a kernel other than K1 launched")

    for run in ("K0", "K1-generic"):
        check(steps[run] == (6, 3), f"{run} ran {steps[run]} train and eval steps, not (6, 3)")
    check(all(np.isfinite(v) for v in seen["losses"]), "a joint train or val loss is not finite")
    # the freeze schedule, from the per-epoch weights of the two fit runs
    for k in (0, 1):
        (_, e0, unf0, s0, s1), (_, e1, unf1, _, s2) = [
            e for e in seen["epochs"] if e[0].per_head_stages == k][:2]
        check(e0 == 0 and not unf0 and e1 == 1 and unf1, f"K={k}: epochs 0, 1 and the unfreeze")
        params = [n for n in s0 if "running" not in n]
        moved0, moved1 = _changed(s0, s1, params), _changed(s1, s2, params)
        trainable0 = "base.layer4." if k == 0 else "heads."
        check(all(n.startswith(("heads.", trainable0)) for n in moved0),
              f"K={k}: epoch 0 moved frozen weights {sorted(moved0)[:3]}")
        for i in range(4 if k else 3):
            own = f"heads.{i}.tail.layer4." if k else f"heads.{i}."
            check(any(n.startswith(own) for n in moved0), f"K={k}: epoch 0 did not move {own}*")
        if k == 0:
            check(any(n.startswith("base.layer4.") for n in moved0), "epoch 0 left layer4")
        check(any(n.startswith("base.layer3.") for n in moved1),
              f"K={k}: epoch 1 (layer3 unfrozen) did not move layer3")
        check(not any(n.startswith(("base.conv1", "base.bn1", "base.layer1", "base.layer2"))
                      for n in moved1), f"K={k}: epoch 1 moved the stem or layer1-2")
    # the resume: start epoch and the saved moments, bit for bit
    path, start, count, mu, nu = seen["resumed"][0]
    tree, meta = serialization.load_native(path)
    adam = tree["opt_state"]["inner_state"]["1"]["0"]
    check(start == int(meta["epoch"]) + 1, f"resume started at {start}, saved {meta['epoch']}")
    check(count == int(np.asarray(adam["count"])), "resumed Adam count")
    for name, saved in (("mu", adam["mu"]), ("nu", adam["nu"])):
        want = serialization.joint_named({"params": saved})
        got = mu if name == "mu" else nu
        check(set(want) == set(got) and all(
            torch.equal(got[n], torch.from_numpy(np.array(want[n]))) for n in want),
            f"resumed {name} differs from the checkpoint's")
    check(steps["K0-resume"] == (2 * (4 - start), 4 - start),
          f"resume ran {steps['K0-resume']} steps from epoch {start}")
    print(f"[ensemble] freeze checks hold for K = 0 and K = 1 (epoch 0 moves the heads and "
          f"layer4, each head's own for K = 1, no frozen weight; epoch 1 moves layer3); resume "
          f"at epoch {start} with {len(mu)} moment pairs bit-equal to the checkpoint (step "
          f"{count}); losses {['%.4f' % v for v in seen['losses']]}", flush=True)
    artifacts = {k: os.path.join(ck[k], "joint_model.ckpt") for k in (0, 1)}
    return {"launches": launches, "steps": steps, "seconds": seconds}, artifacts


def serve(zero_counts, counts, model, clip, out_json):
    """The port's CLI on one artifact (bf16, 512²): → (JSON, seconds,
    launches, trunk passes)."""
    zero_counts()
    with counting_trunk_passes() as passes:
        res, sec = run_cli(["--merged-model", model, "--audio", clip, "--output-json", out_json,
                            "--bf16", "--input-size", "512", "--device", "cuda"])
    return res, sec, counts(), passes[0]


def drive_ensemble_serving(zero_counts, counts, names, artifacts, work, clip, n_windows):
    """Each grown artifact through the CLI: the JSON covers every window
    with the artifact's labels; K1 once per batch; the conv kernel 19 times
    per batch on a shared backbone, never on another layout; a trunk-shared
    artifact's trunk once per batch."""
    from synthetic_audio_detection_tpu_torch.checkpoints import serialization

    batches = -(-n_windows // BATCH)
    out = {}
    for label, (path, classes) in artifacts.items():
        ens = serialization.load_merged(path)
        res, sec, launches, passes = serve(zero_counts, counts, path, clip,
                                           os.path.join(work, f"serve_{label}.json"))
        layout = ("shared" if ens.shared_backbone else
                  f"trunk K={ens.shared_trunk_stages}" if ens.trunk is not None else "dense")
        print(f"[ensemble] serve {label} ({layout}, {ens.num_heads} heads): {sec:.3f} s for "
              f"{n_windows} windows (CLI wall), launches {launches}, trunk passes {passes}",
              flush=True)
        check(len(res["segments"]) == n_windows, f"{label}: window count")
        check(all(s["label"] in classes for s in res["segments"]), f"{label}: labels")
        check(all(np.isfinite(v) for v in res["percentages"].values()), f"{label}: percentages")
        check(launches[names["k1"]] == batches, f"{label}: K1 launches {launches}")
        conv = CONV_LAUNCHES_PER_BATCH * batches if ens.shared_backbone else 0
        check(launches[names["conv"]] == conv, f"{label}: conv launches {launches}, not {conv}")
        check(sum(launches.values()) == batches + conv, f"{label}: other kernels {launches}")
        check(passes == (batches if ens.trunk is not None else 0),
              f"{label}: {passes} trunk passes for {batches} batches")
        out[label] = dict(layout=layout, seconds=sec, launches=launches, trunk_passes=passes)
    return out


def drive_add_head(zero_counts, counts, k1_name, work, data, artifact):
    """cli/add_head main() on the K = 0 artifact with a fourth class, 2
    epochs at 512², --bf16, 16 files a step (the other classes as hard
    negatives). K1 launched once per train and eval step; the grown
    artifact's backbone and existing heads bit-identical to the
    artifact's. → report fields and the grown artifact's .pth."""
    import torch

    from synthetic_audio_detection_tpu_torch.checkpoints import serialization
    from synthetic_audio_detection_tpu_torch.cli import add_head
    from synthetic_audio_detection_tpu_torch.train.add_head import HeadAdder

    adders = []
    fit = HeadAdder.fit

    def observed_fit(self, data_dir):
        adders.append(self)
        return fit(self, data_dir)

    out = os.path.join(work, "grown.ckpt")
    HeadAdder.fit = observed_fit
    try:
        zero_counts()
        t0 = time.perf_counter()
        rc = _quiet(add_head.main, ["--merged-model", artifact, "--data-dir", data,
                                    "--new-class", NEW_CLASS, "--output", out, "--epochs", "2",
                                    "--batch-size", "16", "--input-size", "512", "--bf16",
                                    "--device", "cuda", "--workers", "8"])
        seconds = time.perf_counter() - t0
    finally:
        HeadAdder.fit = fit
    check(rc == 0, f"add-head CLI exit code {rc}")
    launches = counts()
    adder = adders[0]
    steps = (adder.train_steps_run, adder.eval_steps_run)
    print(f"[ensemble] add-head {NEW_CLASS}: {seconds:.1f} s, {steps[0]} train and {steps[1]} "
          f"eval steps, launches {launches}", flush=True)
    check(steps == (6, 4), f"add-head ran {steps} train and eval steps, not (6, 4)")
    check(launches[k1_name] == sum(steps) and sum(launches.values()) == sum(steps),
          f"add-head: launches {launches} for {steps} train and eval steps")
    before = serialization.load_merged(artifact).classifier_state_dicts()
    grown_pth = out.removesuffix(".ckpt") + ".pth"
    for path in (out, grown_pth):
        grown = serialization.load_merged(path)
        check(grown.class_names == ENSEMBLE_CLASSES + [NEW_CLASS, "Real"] and grown.shared_backbone,
              f"grown artifact {grown.class_names}")
        after = grown.classifier_state_dicts()
        check(all(torch.equal(a[k], b[k]) for a, b in zip(after, before) for k in b
                  if not k.endswith("num_batches_tracked")),
              f"{os.path.basename(path)}: an existing head or the backbone changed")
    print("[ensemble] the grown artifact's backbone and 3 existing heads are bit-identical in "
          "both formats", flush=True)
    return {"launches": launches, "steps": steps, "seconds": seconds}, grown_pth


def drive_merger(work):
    """cli/model_merger main() on phase 8's two sub-model .pth files, with
    the default and the reference's strict=False semantics (the first file
    as the donor); both load whole (base.* keys), so the two merges hold
    the same weights. → the two merged .pth paths."""
    import torch

    from synthetic_audio_detection_tpu_torch.checkpoints import serialization
    from synthetic_audio_detection_tpu_torch.cli import model_merger

    recipe = os.path.join(work, "recipe.csv")
    with open(recipe, "w") as f:
        f.write("model_filename,synthetic_class,real_class\n"
                "ck/best_model.ckpt.pth,SynthA,Real\nck_timed/best_model.ckpt.pth,SynthB,Real\n")
    paths = {"default": os.path.join(work, "merged.pth"),
             "reference": os.path.join(work, "merged_ref.pth")}
    extra = {"default": [], "reference": ["--reference-merge-semantics", "--backbone-weights",
                                          os.path.join(work, "ck", "best_model.ckpt.pth")]}
    for kind, path in paths.items():
        t0 = time.perf_counter()
        rc = _quiet(model_merger.main, ["--submodels-folder", work, "--csv-file", recipe,
                                        "--output-path", path, "--device", "cuda"] + extra[kind])
        check(rc == 0, f"merger CLI ({kind}) exit code {rc}")
        print(f"[ensemble] merge ({kind}): {time.perf_counter() - t0:.1f} s", flush=True)
    a, b = (serialization.load_merged(p).classifier_state_dicts() for p in paths.values())
    check(all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x),
          "the two merges of base.* sub-models differ")
    return paths


def time_ensemble_steps(work, data, artifact, smi):
    """The bf16 joint train step (3 heads; K = 0 and K = 1, phase 1) and the
    add-head step at 512², 32 rows, on one batch of the tree: median ms of
    20 back-to-back steps after 3 warm-up (CUDA events), rows a second,
    peak memory allocated, K1 launches a step, and from a torch.profiler
    trace of 3 steps (tools/profile_train.trace) the kernels, device busy
    time and idle share a step."""
    import torch

    from synthetic_audio_detection_tpu_torch.checkpoints import serialization
    from synthetic_audio_detection_tpu_torch.data import dataset as ds
    from synthetic_audio_detection_tpu_torch.ops import cuda_melspec
    from synthetic_audio_detection_tpu_torch.tools import profile_train
    from synthetic_audio_detection_tpu_torch.train.add_head import HeadAdder
    from synthetic_audio_detection_tpu_torch.train.joint import JointTrainer
    from synthetic_audio_detection_tpu_torch.train.trainer import device_batches
    from synthetic_audio_detection_tpu_torch.utils.config import SpectrogramConfig, TrainConfig

    cfg = TrainConfig(batch_size=16, compute_dtype="bfloat16", workers=8)
    spec = SpectrogramConfig(mel_norm=None, out_size=512)
    samples = ds.list_samples(data, "train", ["Real"] + ENSEMBLE_CLASSES)
    batcher = ds.WaveformBatcher(samples[::2][:16], 16, shuffle=False, workers=8)
    out = {}

    def timed(name, step):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = cuda_melspec.KERNEL.launches
        ms = median_ms(step, n=20, warmup=3)
        k1 = (cuda_melspec.KERNEL.launches - before) / 23
        r = profile_train.trace(step, 3)
        out[name] = dict(ms=ms, rows_per_s=TRAIN_ROWS / ms * 1e3,
                         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30, k1_per_step=k1,
                         kernels_per_step=r["kernels_per_step"],
                         device_busy_ms=r["device_busy_ms_per_step"], idle_share=r["idle_share"])
        print(f"[ensemble] bf16 {name} step, 512², {TRAIN_ROWS} rows: {ms:.3f} ms median of 20 "
              f"after 3 warm-up (CUDA events), {out[name]['rows_per_s']:.1f} rows/s, peak "
              f"{out[name]['peak_gib']:.2f} GiB allocated, K1 {k1:g} a step; traced (3 steps, "
              f"torch.profiler): {r['kernels_per_step']:.0f} kernels and "
              f"{r['device_busy_ms_per_step']:.3f} ms device busy a step, idle "
              f"{100 * r['idle_share']:.1f}% | {smi}", flush=True)

    for k in (0, 1):
        tr = JointTrainer(cfg, ENSEMBLE_CLASSES, spec_cfg=spec,
                          log_dir=os.path.join(work, "runs_t"), per_head_stages=k, device="cuda")
        batch = next(tr._batches(batcher, 0, TRAIN_ROWS))
        check(batch["audio"].dtype == torch.int16 and batch["audio"].shape[0] == TRAIN_ROWS,
              "the joint trainer takes the int16 transport, 32 rows")
        timed(f"joint N=3 K={k}", lambda: tr._train_step(tr.state, batch, tr.generator))
        del tr
    adder = HeadAdder(serialization.load_merged(artifact), NEW_CLASS, cfg, spec_cfg=spec,
                      device="cuda")
    batch = next(device_batches(batcher, 0, TRAIN_ROWS, "float32", adder.device))
    batch["label"] = (batch["label"] == 1).long()  # the new head is binary
    timed("add-head", lambda: adder._step(adder.state, adder.trunk, batch, adder.generator))
    return out


def drive_ensemble(zero_counts, counts, names, work, clip, n_windows, smi):
    """Phase 10: the ensemble-building path, run from ``work`` (the CLIs
    write their logs/ where they run). → report fields."""
    data = os.path.join(work, "ensemble_data")
    write_ensemble_tree(data)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        t0 = time.perf_counter()
        joint, ckpts = drive_joint_trainer(zero_counts, counts, names["k1"], work, data)
        print(f"[ensemble] joint trainer runs took {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        add, grown_pth = drive_add_head(zero_counts, counts, names["k1"], work, data,
                                        ckpts[0] + ".merged.pth")
        print(f"[ensemble] add-head took {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        merged = drive_merger(work)
        print(f"[ensemble] merges took {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        os.chdir(cwd)
    names3 = ENSEMBLE_CLASSES + ["Real"]
    grown = {"joint-K0": (ckpts[0] + ".merged.pth", names3),
             "joint-K1-generic": (ckpts[1] + ".merged.pth", names3),
             "grown": (grown_pth, ENSEMBLE_CLASSES + [NEW_CLASS, "Real"]),
             "merged": (merged["default"], ["SynthA", "SynthB", "Real"]),
             "merged-reference": (merged["reference"], ["SynthA", "SynthB", "Real"])}
    t0 = time.perf_counter()
    served = drive_ensemble_serving(zero_counts, counts, names, grown, work, clip, n_windows)
    check(served["joint-K0"]["layout"] == "shared", "the K = 0 artifact is not a shared backbone")
    check(served["joint-K1-generic"]["layout"] == "trunk K=1", "the K = 1 artifact's layout")
    print(f"[ensemble] serving took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    steps = time_ensemble_steps(work, data, ckpts[0] + ".merged.pth", smi)
    print(f"[ensemble] step timing took {time.perf_counter() - t0:.1f} s", flush=True)
    k1 = (sum(v[names["k1"]] for v in joint["launches"].values()) + add["launches"][names["k1"]]
          + sum(v["launches"][names["k1"]] for v in served.values()))
    conv = sum(v["launches"][names["conv"]] for v in served.values())
    return {"joint": joint, "add_head": add, "serving": served, "steps": steps,
            "k1_launches": k1, "conv_launches": conv,
            "paths": {"data": data, "k0": ckpts[0] + ".merged.pth",
                      "k1": ckpts[1] + ".merged.pth"}}


# ---------------------------------------------------------------------------
# The serving daemon
# ---------------------------------------------------------------------------

DAEMON_CLIENTS = 8    # client threads of a burst
DAEMON_REQUESTS = 16  # 20-s clips (5 windows each) in a burst
DAEMON_LONE_POSTS = 10
TOL_STREAM_PCT = 1e-3  # stream finalize against /analyze, percentage points
TOL_RESAMPLE = 1e-5    # the device resample against resample_poly_np
# a coalesced window's label must equal its lone label unless a lone
# sigmoid lies within this of a decision boundary (a bf16 rounding in a
# library call at another batch size can move a logit by up to TOL_ROUTE)
TIE_MARGIN = 0.01


def clear_windows(probs, margin=0.05):
    """[n, N+1] sigmoids → which labels are clear: no sigmoid within
    ``margin`` of the threshold and, for a synthetic verdict, the argmax
    head ahead of the runner-up by more than ``margin`` (the label is that
    argmax)."""
    syn = np.sort(probs[:, :-1], axis=1)
    is_real = (probs[:, -1] >= THRESHOLD) & (syn[:, -1] < THRESHOLD)
    return (np.all(np.abs(probs - THRESHOLD) > margin, axis=1)
            & (is_real | (syn[:, -1] - syn[:, -2] > margin)))


def sigmoid(logits):
    return 1.0 / (1.0 + np.exp(-logits))


def http(url, data=None, timeout=120):
    """GET (no data) or POST ``url`` → the JSON answer."""
    import urllib.request

    req = urllib.request.Request(url, data=data, method="GET" if data is None else "POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def labels_of(result):
    return [s["label"] for s in result["segments"]]


def burst(url, clips):
    """Every clip posted to /analyze by DAEMON_CLIENTS client threads at
    once → (results in clip order, wall seconds)."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(DAEMON_CLIENTS) as pool:
        out = list(pool.map(lambda c: http(f"{url}/analyze", c), clips))
    return out, time.perf_counter() - t0


def drive_daemon(zero_counts, counts, names, shared_path, work, cli_res, p32, smi):
    """Phase 11: infer/server.serve() on 127.0.0.1:0 over the shared
    checkpoint (bf16, 512², batch 128, micro-batching on), warmed up, with
    a second server without micro-batching on the same pipeline for the
    comparison; counts zeroed after the warm-up and read at the end, every
    device dispatch's rows recorded. → report fields."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from synthetic_audio_detection_tpu_torch.audio import wavio
    from synthetic_audio_detection_tpu_torch.audio.resample import resample_poly_np
    from synthetic_audio_detection_tpu_torch.checkpoints.serialization import load_merged
    from synthetic_audio_detection_tpu_torch.infer import server
    from synthetic_audio_detection_tpu_torch.infer.pipeline import (
        InferencePipeline,
        preprocess_waveform,
        slice_waveform,
    )
    from synthetic_audio_detection_tpu_torch.ops import resample as device_resample
    from synthetic_audio_detection_tpu_torch.utils.config import (
        AudioConfig,
        InferenceConfig,
        SpectrogramConfig,
    )

    # the pipeline cli/serve builds for --merged-model ... --bf16
    audio = AudioConfig(overlap=0.0)
    pipe = InferencePipeline(load_merged(shared_path), audio=audio,
                             spec=SpectrogramConfig.inference(out_size=512),
                             infer=InferenceConfig(batch_size=BATCH),
                             compute_dtype=torch.bfloat16, device="cuda")
    check(pipe.use_kernel and pipe.use_fast_backbone, "the daemon's pipeline takes K1 and the "
          "conv kernel")
    rows = []  # the rows of every device dispatch

    def recorded(fn):
        def call(windows):
            rows.append(windows.shape[0])
            return fn(windows)
        return call

    pipe.logits_for_windows = recorded(pipe.logits_for_windows)
    pipe.logits_and_per_head = recorded(pipe.logits_and_per_head)
    t0 = time.perf_counter()
    srvs = {"micro-batch": server.serve(pipe, port=0),
            "alone": server.serve(pipe, port=0, warmup=False, micro_batch=False)}
    warm_s = time.perf_counter() - t0
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in srvs.values()]
    for t in threads:
        t.start()
    url = {k: f"http://127.0.0.1:{s.server_address[1]}" for k, s in srvs.items()}
    state = srvs["micro-batch"].serving_state
    rows.clear()
    zero_counts()
    out = {"warmup_s": warm_s}
    try:
        u = url["micro-batch"]
        check(http(f"{u}/healthz") == {"status": "ok", "classes": NAMES}, "/healthz")

        # the 20-s clip: the CLI's labels on every clear window
        clip20 = os.path.join(work, "20s.wav")
        data20 = open(clip20, "rb").read()
        res = http(f"{u}/analyze?filename=20s.wav", data20)
        windows, _ = slice_waveform(preprocess_waveform(clip20, audio), audio)
        clear = clear_windows(sigmoid(p32.logits_for_windows(windows)))
        flips = [i for i, (a, b) in enumerate(zip(labels_of(res), labels_of(cli_res)))
                 if clear[i] and a != b]
        same = {k: res[k] == cli_res[k] for k in ("segments", "percentages")}
        print(f"[daemon] /analyze 20-s clip: {len(res['segments'])} windows, labels equal to the "
              f"CLI's on {int(clear.sum()) - len(flips)}/{int(clear.sum())} clear windows; "
              f"equal to the CLI's JSON: {same}", flush=True)
        check(len(res["segments"]) == 5 and not flips, f"/analyze labels differ from the CLI's "
              f"on clear windows {flips}")
        ph = http(f"{u}/analyze?per_head=1", data20)
        check(np.asarray(ph["per_head"]).shape == (5, len(NAMES) - 1, 2)
              and labels_of(ph) == labels_of(res), "per_head=1")

        # DAEMON_REQUESTS clips: alone, then at once
        clips = []
        for i in range(DAEMON_REQUESTS):
            path = os.path.join(work, f"daemon_{i}.wav")
            wavio.write_wav(path, make_clip(20, seed=200 + i), SR)
            clips.append(open(path, "rb").read())
        lone = [http(f"{u}/analyze", c) for c in clips]
        per_clip = [slice_waveform(preprocess_waveform(os.path.join(work, f"daemon_{i}.wav"),
                                                       audio), audio)[0]
                    for i in range(DAEMON_REQUESTS)]
        lone_logits = [state.locked_logits(w) for w in per_clip]
        before = state.batcher.dispatch_count
        together, _ = burst(u, clips)
        dispatches = state.batcher.dispatch_count - before
        # the same windows through the batcher from the client threads, for
        # their logits (the JSON carries none)
        before_direct = state.batcher.dispatch_count
        with ThreadPoolExecutor(DAEMON_CLIENTS) as pool:
            coalesced_logits = list(pool.map(state.batcher.logits, per_clip))
        direct_dispatches = state.batcher.dispatch_count - before_direct
        dlogit = max(float(np.abs(a - b).max()) for a, b in zip(lone_logits, coalesced_logits))
        near = [~clear_windows(sigmoid(lg), TIE_MARGIN) for lg in lone_logits]
        bad = [(i, j) for i, (a, b) in enumerate(zip(lone, together))
               for j, (x, y) in enumerate(zip(labels_of(a), labels_of(b)))
               if x != y and not near[i][j]]
        n_near = int(sum(n.sum() for n in near))
        print(f"[daemon] {DAEMON_REQUESTS} concurrent /analyze ({DAEMON_CLIENTS} clients, 5 "
              f"windows each): {dispatches} dispatches (the same windows straight into the "
              f"batcher: {direct_dispatches}); labels equal to each clip's lone result on "
              f"{5 * DAEMON_REQUESTS - len(bad)}/{5 * DAEMON_REQUESTS} windows ({n_near} within "
              f"{TIE_MARGIN} of a boundary exempt); max |Δlogit| coalesced vs lone {dlogit:.4g} "
              f"(tol {TOL_ROUTE})", flush=True)
        check(dispatches < DAEMON_REQUESTS,
              f"{dispatches} dispatches for {DAEMON_REQUESTS} requests")
        check(not bad, f"coalesced labels differ from lone ones at (clip, window) {bad}")
        check(dlogit <= TOL_ROUTE, f"coalesced logits {dlogit} from lone ones")

        # throughput of a burst with and without micro-batching, in turns
        rates = {"micro-batch": [], "alone": []}
        for mode in ("micro-batch", "alone", "alone", "micro-batch"):
            _, wall = burst(url[mode], clips)
            rates[mode].append((5 * DAEMON_REQUESTS / wall, DAEMON_REQUESTS / wall))
        for mode, vals in rates.items():
            print(f"[daemon] burst of {DAEMON_REQUESTS} × 20-s clips, {DAEMON_CLIENTS} clients, "
                  f"{mode:11s}: {' / '.join(f'{w:.1f}' for w, _ in vals)} windows/s, "
                  f"{' / '.join(f'{r:.2f}' for _, r in vals)} requests/s | {smi}", flush=True)
        out["burst"] = {m: [{"windows_per_s": w, "requests_per_s": r} for w, r in v]
                        for m, v in rates.items()}

        lat = []
        for _ in range(DAEMON_LONE_POSTS):
            t0 = time.perf_counter()
            http(f"{u}/analyze", data20)
            lat.append(time.perf_counter() - t0)
        out["p50_latency_ms"] = float(np.median(lat)) * 1e3
        print(f"[daemon] lone /analyze of the 20-s clip: p50 {out['p50_latency_ms']:.2f} ms "
              f"(min {min(lat) * 1e3:.2f}, max {max(lat) * 1e3:.2f}) of {DAEMON_LONE_POSTS} | "
              f"{smi}", flush=True)

        # one dispatch by its window count, host clock around work that ends
        # with the logits on the host: a count above 8 pads to the batch size
        pool_windows = np.concatenate(per_clip + per_clip)
        out["dispatch_ms"] = {}
        for n in (5, 10, 35, BATCH):
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                state.locked_logits(pool_windows[:n])
                times.append((time.perf_counter() - t0) * 1e3)
            out["dispatch_ms"][n] = float(np.median(times))
        print(f"[daemon] one dispatch, host clock, median of 5: " + ", ".join(
            f"{n} windows {ms:.2f} ms (bucket {pipe._bucket(n)})"
            for n, ms in out["dispatch_ms"].items()) + f" | {smi}", flush=True)

        # a live stream at 44.1 kHz against /analyze of the same samples
        x44 = resample_poly_np(make_clip(20, seed=20), SR, 44_100)
        pcm = wavio.pcm16_quantize(x44)
        path44 = os.path.join(work, "20s_44k.wav")
        wavio.write_wav(path44, pcm, 44_100)
        want = http(f"{u}/analyze", open(path44, "rb").read())
        sid = http(f"{u}/stream/start?source_rate=44100", b"")["stream_id"]
        feed_ms, live = [], []
        for i in range(0, len(pcm), 44_100):
            t0 = time.perf_counter()
            live += http(f"{u}/stream/{sid}/feed", pcm[i : i + 44_100].tobytes())["windows"]
            feed_ms.append((time.perf_counter() - t0) * 1e3)
        got = http(f"{u}/stream/{sid}/finalize", b"")
        dpct = max(abs(got["percentages"][k] - v) for k, v in want["percentages"].items())
        out["feed_ms"] = {"median": float(np.median(feed_ms)), "max": max(feed_ms),
                          "feeds": len(feed_ms)}
        print(f"[daemon] /stream at 44.1 kHz, {len(feed_ms)} 1-s int16 chunks: feed median "
              f"{out['feed_ms']['median']:.2f} ms, max {max(feed_ms):.2f} ms (the feeds that "
              f"complete a window dispatch it); finalize vs /analyze: labels equal "
              f"{labels_of(got) == labels_of(want)}, the {len(live)} live verdicts (the last "
              f"window completes at the resampler's flush) equal "
              f"{[v['label'] for v in live] == labels_of(want)[:len(live)]}, max |Δ%| {dpct:.3g} "
              f"(tol {TOL_STREAM_PCT}) | {smi}", flush=True)
        check(labels_of(got) == labels_of(want) and len(got["segments"]) == 5,
              "stream finalize labels")
        check(dpct <= TOL_STREAM_PCT, f"stream percentages {dpct} from /analyze's")

        # the device resampler (off every serving path) on the card
        t0 = time.perf_counter()
        y = device_resample.resample_bucketed(x44, 44_100, SR)
        err = float(np.abs(y - resample_poly_np(x44, 44_100, SR)).max())
        print(f"[daemon] ops/resample.resample_bucketed on the card, 20 s at 44.1 kHz: max |Δ| "
              f"{err:.3g} against resample_poly_np (tol {TOL_RESAMPLE}), "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms wall", flush=True)
        check(y.shape == (20 * SR,) and err <= TOL_RESAMPLE, "resample_bucketed")
    finally:
        for s in srvs.values():
            s.shutdown()
            s.server_close()
            s.serving_state.close()
        for t in threads:
            t.join(timeout=10)
    launches = counts()
    batches = sum(-(-n // pipe._bucket(n)) for n in rows)
    print(f"[daemon] {len(rows)} device dispatches, {batches} bucket batches "
          f"(rows {sorted(set(rows))}); launches {launches}", flush=True)
    check(launches[names["k1"]] == batches, f"K1 launched {launches[names['k1']]} times for "
          f"{batches} bucket batches")
    check(launches[names["conv"]] == CONV_LAUNCHES_PER_BATCH * batches,
          f"the conv kernel launched {launches[names['conv']]} times for {batches} batches")
    check(sum(launches.values()) == launches[names["k1"]] + launches[names["conv"]],
          "a kernel other than K1 and the conv kernel launched")
    out.update(dispatches=len(rows), bucket_batches=batches, k1_launches=launches[names["k1"]],
               conv_launches=launches[names["conv"]], max_dlogit_coalesced=dlogit,
               stream_max_dpct=dpct, resample_max_err=err)
    return out


# ---------------------------------------------------------------------------
# The legacy path
# ---------------------------------------------------------------------------

LEGACY_CLASSES = ["Real", "class1", "class2", "class3", "class4"]
LEGACY_TOL_CPU = 1e-4  # CUDA float32 probabilities against the CPU's


def drive_legacy(zero_counts, counts, work, smi):
    """Phase 12: a seeded 5-class ResNet-152 .pth (flax's default init)
    through cli/legacy_inference main() on the 20-s clip in float32 and
    with --bf16, then cli/legacy_trainer main() for one epoch at 512² on a
    seeded tree of the five legacy class folders; counts zeroed before
    each run and read after. → report fields."""
    import torch

    from synthetic_audio_detection_tpu_torch.checkpoints.serialization import save_submodel_torch
    from synthetic_audio_detection_tpu_torch.cli import legacy_inference, legacy_trainer
    from synthetic_audio_detection_tpu_torch.infer.legacy_analyzer import (
        DEFAULT_CLASSES,
        LegacyAudioAnalyzer,
    )
    from synthetic_audio_detection_tpu_torch.models.classifier import BinaryClassifier
    from synthetic_audio_detection_tpu_torch.models.init import flax_default_init_
    from synthetic_audio_detection_tpu_torch.train.trainer import Trainer

    model = BinaryClassifier("resnet152", num_outputs=5)
    flax_default_init_(model, torch.Generator().manual_seed(0))
    ckpt = os.path.join(work, "legacy.pth")
    save_submodel_torch(ckpt, {k: v.numpy() for k, v in model.state_dict().items()
                               if not k.endswith("num_batches_tracked")})
    clip20 = os.path.join(work, "20s.wav")
    out = {"inference": {}}
    for mode in ("float32", "bf16"):
        zero_counts()
        t0 = time.perf_counter()
        argv = ["--checkpoint_path", ckpt, "--audio_path", clip20, "--output_dir",
                os.path.join(work, f"legacy_{mode}"), "--model-name", "resnet152",
                "--device", "cuda"]
        with contextlib.redirect_stdout(io.StringIO()):
            rc = legacy_inference.main(argv + (["--bf16"] if mode == "bf16" else []))
        sec = time.perf_counter() - t0
        launches = counts()
        check(rc == 0, f"legacy inference ({mode}) exit code {rc}")
        res = json.load(open(os.path.join(work, f"legacy_{mode}", "20s.json")))
        starts = [s["start"] for s in res["segments"]]
        check(res["filename"] == "20s.wav" and list(res["percentages"]) == DEFAULT_CLASSES
              and all(np.isfinite(v) for v in res["percentages"].values()),
              f"legacy {mode} JSON: {res['percentages']}")
        check(starts == sorted(starts) and all(s["end"] > s["start"] and s["class"] in
                                               DEFAULT_CLASSES for s in res["segments"]),
              f"legacy {mode} segments")
        check(sum(launches.values()) == 0, f"a kernel launched on the legacy path: {launches}")
        print(f"[legacy] cli/legacy_inference {mode:7s} ResNet-152, 20-s clip: {sec:.3f} s per "
              f"clip (CLI wall, checkpoint load included), {len(res['segments'])} segments, "
              f"percentages {res['percentages']}, launches {launches} | {smi}", flush=True)
        out["inference"][mode] = {"seconds": sec, "segments": len(res["segments"])}

    # per window: bf16 against float32 on the card, the card against the CPU
    model = legacy_inference.load_classifier(ckpt, "resnet152")
    an = {dt: LegacyAudioAnalyzer(model, compute_dtype=dt, device="cuda")
          for dt in (torch.float32, torch.bfloat16)}
    windows, _ = an[torch.float32].windows(an[torch.float32].preprocess(clip20))
    p32, p16 = (an[dt].probabilities(windows) for dt in (torch.float32, torch.bfloat16))
    top = np.sort(p32, axis=1)
    clear = top[:, -1] - top[:, -2] > 0.05
    agree = p32.argmax(1) == p16.argmax(1)
    print(f"[legacy] bf16 vs float32 argmax: {int((agree & clear).sum())}/{int(clear.sum())} "
          f"windows whose float32 top probability leads by > 0.05 agree ({int(agree.sum())}/"
          f"{len(agree)} overall); max |Δp| {float(np.abs(p32 - p16).max()):.3g}", flush=True)
    check(bool(agree[clear].all()), "bf16 and float32 argmax differ on clear windows")
    cpu = LegacyAudioAnalyzer(legacy_inference.load_classifier(ckpt, "resnet152"), device="cpu")
    w5, _ = cpu.windows(cpu.preprocess(clip20)[: 5 * SR])
    check(w5.shape[0] == 2, "the 5-s clip's windows")
    d_cpu = float(np.abs(cpu.probabilities(w5) - an[torch.float32].probabilities(w5)).max())
    print(f"[legacy] float32 probabilities, CUDA vs CPU, 2 windows: max diff {d_cpu:.3g} "
          f"(tol {LEGACY_TOL_CPU})", flush=True)
    check(d_cpu <= LEGACY_TOL_CPU, "CUDA float32 legacy probabilities disagree with the CPU")
    out["cuda_vs_cpu"] = d_cpu
    del model, an, cpu

    # the legacy trainer: one epoch, float32, the GEMM mel
    data = os.path.join(work, "legacy_data")
    write_class_tree(data, LEGACY_CLASSES, (4, 2), seed=17)
    ck = os.path.join(work, "legacy_ck")
    cwd = os.getcwd()
    os.chdir(work)  # the CLI writes its logs/ and runs/ where it runs
    try:
        with observing(Trainer) as seen:
            zero_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                rc = legacy_trainer.main(["--data-dir", data, "--epochs", "1", "--batch-size", "8",
                                          "--model-name", "resnet152", "--input-size", "512",
                                          "--device", "cuda", "--workers", "8",
                                          "--checkpoint-dir", ck])
            sec = time.perf_counter() - t0
            launches = counts()
    finally:
        os.chdir(cwd)
    tr = seen["trainers"][0]
    saved = sorted(os.listdir(ck))
    epoch = [f for f in saved if re.fullmatch(r"epoch_0_acc_\d\.\d\d\.ckpt", f)]
    print(f"[legacy] cli/legacy_trainer ResNet-152 at 512², --batch-size 8, 1 epoch: {sec:.1f} s "
          f"({tr.train_steps_run} train and {tr.eval_steps_run} eval steps), losses "
          f"{['%.4f' % v for v in seen['losses']]}, saved {saved}, launches {launches} | {smi}",
          flush=True)
    check(rc == 0, f"legacy trainer exit code {rc}")
    check(all(np.isfinite(v) for v in seen["losses"]), "a legacy train or val loss is not finite")
    check(len(epoch) == 1 and epoch[0] + ".pth" in saved, f"no epoch_0_acc_*.ckpt in {saved}")
    check(sum(launches.values()) == 0, f"a kernel launched in the legacy trainer: {launches}")
    shutil.rmtree(ck, ignore_errors=True)
    out["trainer"] = {"seconds": sec, "train_steps": tr.train_steps_run,
                      "eval_steps": tr.eval_steps_run}
    return out


# ---------------------------------------------------------------------------
# The release path
# ---------------------------------------------------------------------------

def run_tool(mod, argv):
    """A study tool's main(argv) → (exit code, the JSON of its last stdout
    line, seconds)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    seconds = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]) if lines else None, seconds


@contextlib.contextmanager
def counting_dispatches():
    """While open, counts (in the yielded list) the device batches every
    InferencePipeline dispatches, without changing what it does."""
    from synthetic_audio_detection_tpu_torch.infer.pipeline import InferencePipeline

    seen = [0]
    forward = InferencePipeline._forward

    def observed(self, batch, return_per_head=False):
        seen[0] += 1
        return forward(self, batch, return_per_head)

    InferencePipeline._forward = observed
    try:
        yield seen
    finally:
        InferencePipeline._forward = forward


def drive_release(zero_counts, counts, names, work, paths, clip20, windows, smi,
                  device="cuda", size=512, bf16=True):
    """Phase 13: the release path on phase 10's K = 0 joint artifact
    (shared backbone) and its split tree (Real, SynA-SynD; SynD names no
    class of the artifact), every tool through its main(argv), counts
    zeroed before each run and read after, the device batches counted:
    calibrate (fit on train/, ECE on test/, written as .pth and native,
    and the K = 1 generic-head artifact), study (accuracy with and
    without the calibration, robustness at 20 dB SNR and the 8-kHz
    lowpass, the decision A/B), export the calibrated checkpoint (bf16,
    512², int16, entries 8 and 128) and load it, drive it (artifact_drive
    on test/, and on phase 6's shared checkpoint ``paths["shared"]``),
    serve it (cli/serve --artifact's pipeline behind
    infer/server.serve()), and the artifact's windows/s against the live
    pipeline's, in turns. → report fields."""
    import threading

    import torch

    from synthetic_audio_detection_tpu_torch.checkpoints.serialization import load_merged
    from synthetic_audio_detection_tpu_torch.cli import serve as serve_cli
    from synthetic_audio_detection_tpu_torch.infer import export, server
    from synthetic_audio_detection_tpu_torch.infer.pipeline import InferencePipeline
    from synthetic_audio_detection_tpu_torch.tools import (
        accuracy_study,
        artifact_drive,
        calibrate_ensemble,
        decision_ab,
        robustness_study,
    )
    from synthetic_audio_detection_tpu_torch.utils.config import (
        AudioConfig,
        InferenceConfig,
        SpectrogramConfig,
    )

    kernels = device == "cuda" and bf16  # K1, and the conv kernel on a shared backbone
    flags = ["--input-size", str(size), "--batch-size", str(BATCH), "--device", device]
    flags += ["--bf16"] if bf16 else []
    train, test = (os.path.join(paths["data"], s) for s in ("train", "test"))
    k0, k1 = paths["k0"], paths["k1"]
    cal_pth, cal_native = (os.path.join(work, f"release_k0_cal{e}") for e in (".pth", ".ckpt"))
    out = {"seconds": {}, "launches": {}, "batches": {}}

    def tool(label, mod, argv, shared=True):
        zero_counts()
        with counting_dispatches() as batches:
            rc, rep, sec = run_tool(mod, argv + flags)
        launches = counts()
        check(rc == 0 and rep is not None, f"{label}: exit code {rc}")
        n = batches[0]
        want_conv = CONV_LAUNCHES_PER_BATCH * n if kernels and shared else 0
        want_k1 = n if kernels else 0
        print(f"[release] {label}: {sec:.2f} s, {n} device batches, launches {launches}",
              flush=True)
        check(n > 0 and launches[names["k1"]] == want_k1,
              f"{label}: K1 launched {launches[names['k1']]} times for {n} batches")
        check(launches[names["conv"]] == want_conv,
              f"{label}: the conv kernel launched {launches[names['conv']]} times for {n} "
              f"batches, not {want_conv}")
        check(sum(launches.values()) == want_k1 + want_conv, f"{label}: other kernels {launches}")
        out["seconds"][label], out["launches"][label], out["batches"][label] = sec, launches, n
        return rep

    # 1. calibrate
    for path in (cal_pth, cal_native):
        rep = tool(f"calibrate_ensemble → {os.path.basename(path)}", calibrate_ensemble,
                   ["--merged-model", k0, "--fit-dir", train, "--eval-dir", test, "--output",
                    path, "--store-column-thresholds"])
        cal = rep["calibration"]
        check(len(cal["temperatures"]) == len(names["classes"])
              and all(np.isfinite(cal["temperatures"])), f"temperatures {cal['temperatures']}")
        check(load_merged(path).calibration == cal, f"{path}: the calibration did not reload")
        out.setdefault("calibration", cal)
        out.setdefault("eval", rep["eval"])
    print(f"[release] calibration of the K = 0 artifact: temperatures {cal['temperatures']}, "
          f"fit ECE {cal['ece_before']} → {cal['ece_after']}; test/ ({rep['eval']['n_windows']} "
          f"windows) ECE {rep['eval']['ece_before']} → {rep['eval']['ece_after']}", flush=True)
    check(out["calibration"]["temperatures"] == cal["temperatures"],
          "the .pth and native fits of the same tree differ")
    served = InferencePipeline(load_merged(cal_native), spec=SpectrogramConfig.inference(size),
                               compute_dtype=torch.bfloat16 if bf16 else torch.float32,
                               device=device)
    check(served._cal == cal, "serving did not engage the calibration")
    rep = tool("calibrate_ensemble K = 1 generic", calibrate_ensemble,
               ["--merged-model", k1, "--fit-dir", train, "--output",
                os.path.join(work, "release_k1_cal.ckpt"), "--store-column-thresholds",
                "--column-threshold-method", "sidak"], shared=False)
    gcal = rep["calibration"]
    check(gcal["column_names"] == names["classes"][:-1] + ["__generic__", "Real"]
          and len(gcal["temperatures"]) == len(names["classes"]) + 1,
          f"the generic-head fit's columns {gcal['column_names']}")
    out["generic_calibration"] = gcal

    # 2. study
    acc = tool("accuracy_study", accuracy_study, ["--merged-model", cal_pth, "--data-dir", test])
    raw = tool("accuracy_study --no-calibration", accuracy_study,
               ["--merged-model", cal_pth, "--data-dir", test, "--no-calibration"])
    rob = tool("robustness_study", robustness_study,
               ["--merged-model", cal_pth, "--data-dir", test, "--perturbations", "noise_snr20",
                "lowpass_8k"])
    ab = tool("decision_ab", decision_ab,
              ["--merged-model", k0, "--fit-dir", train, "--data-dir", test, "--holdout",
               names["holdout"], "--k", "1", "2"])
    n_test = sum(len(fs) for _, _, fs in os.walk(test))
    for label, rep in (("accuracy", acc), ("accuracy raw", raw)):
        check(rep["n_segments"] == n_test and 0 <= rep["binary_accuracy"] <= 1
              and np.isfinite(rep.get("binary_auc", 0.5)), f"{label}: {rep}")
    check(all(v["n_segments"] == n_test for v in rob["perturbations"].values()),
          f"robustness: {rob}")
    check(ab["n_files"] == n_test and ab["variants"]["reference_unanimity_k1"]["per_class"]
          == raw["per_class"], "decision_ab's reference variant is not the pipeline's rule")
    print(f"[release] accuracy (calibrated): binary {acc['binary_accuracy']}, attribution "
          f"{acc['attribution_accuracy']}, AUC {acc.get('binary_auc')}, EER "
          f"{acc.get('binary_eer')}; uncalibrated binary {raw['binary_accuracy']}; robustness "
          f"{json.dumps(rob['perturbations'])}; decision_ab reference Real TNR "
          f"{ab['variants']['reference_unanimity_k1']['real_tnr']}, unseen TPR "
          f"{ab['variants']['reference_unanimity_k1'].get('unseen_tpr')} (the pipeline's "
          f"labels, class by class)", flush=True)
    out["study"] = {"accuracy": {k: acc[k] for k in ("binary_accuracy", "attribution_accuracy",
                                                     "binary_auc", "binary_eer") if k in acc},
                    "robustness": rob["perturbations"],
                    "decision_ab_reference": ab["variants"]["reference_unanimity_k1"]}

    # 3. export and load
    art = os.path.join(work, "release.sadpt")
    zero_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = export.main(["--merged-model", cal_pth, "--output", art, "--input-size", str(size),
                          "--batch-sizes", f"8,{BATCH}", "--device", device]
                         + (["--bf16"] if bf16 else []))
    export_s = time.perf_counter() - t0
    check(rc == 0, f"export exit code {rc}")
    with open(art, "rb") as f:
        meta, _ = export.read_header(f.read())
    nbytes = os.path.getsize(art)
    bound = meta["weights_nbytes"] + meta["constants_nbytes"]
    t0 = time.perf_counter()
    pipe = InferencePipeline.from_artifact(art)
    load_s = time.perf_counter() - t0
    print(f"[release] export (--bf16 {bf16}, {size}², int16, entries 8 and {BATCH}): "
          f"{export_s:.2f} s; {nbytes} bytes = {nbytes / bound:.4f} × (weights "
          f"{meta['weights_nbytes']} + lifted constants {meta['constants_nbytes']}); load "
          f"{load_s:.2f} s; launches {counts()}", flush=True)
    check(nbytes <= 1.05 * bound, "the artifact stores more than its weights once")
    check(sum(counts().values()) == 0, "the export launched a hand-written kernel")
    check(pipe._bucket_sizes == [8, BATCH] and pipe._cal == cal
          and meta["platforms"] == [torch.device(device).type],
          "the loaded artifact's buckets, calibration or platform")
    out["export"] = {"seconds": export_s, "load_seconds": load_s, "nbytes": nbytes,
                     "weights_nbytes": meta["weights_nbytes"],
                     "constants_nbytes": meta["constants_nbytes"]}

    # 4. drive: matched numerics and production labels, on the release
    # artifact and on phase 6's shared checkpoint (exported by the tool).
    # Each must leave windows clear of the decision boundaries, or its
    # production check compares nothing: the release artifact's are its
    # raw logits, as its fitted temperatures sit at the fit's bound and
    # flatten every calibrated sigmoid onto 0.5
    out["drive"] = {}
    for label, model, extra in (("release artifact, raw logits", cal_pth,
                                 ["--artifact", art, "--no-calibration"]),
                                ("phase 6 shared checkpoint", paths["shared"], [])):
        zero_counts()
        rc, drive, sec = run_tool(artifact_drive, ["--merged-model", model, "--audio-dir", test,
                                                   "--max-files", str(n_test)] + extra + flags)
        print(f"[release] artifact_drive on test/, {label}: {sec:.2f} s, {json.dumps(drive)}",
              flush=True)
        check(rc == 0 and drive["ok"], f"artifact_drive failed ({label})")
        check(drive["matched_bit_equal"], f"the matched logits are not bit for bit ({label})")
        check(drive["production_clear_windows"] > 0,
              f"no window clear of the decision boundaries ({label}): the production label "
              f"check is empty")
        check(drive["n_files"] == n_test and not any(drive["launches"]["artifact"].values()),
              f"the artifact launched a hand-written kernel ({label})")
        if kernels:
            check(drive["launches"]["production"][names["k1"]] > 0,
                  "the production pipeline did not take K1")
        out["drive"][label] = {k: drive[k] for k in drive if k != "launches"}

    # 5. serve: cli/serve --artifact's pipeline behind serve()
    args = serve_cli.build_parser().parse_args(["--artifact", art, "--device", device])
    spipe, _ = serve_cli.build_pipeline(args)
    srv = server.serve(spipe, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        zero_counts()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        got = http(f"{url}/analyze?filename=20s.wav", open(clip20, "rb").read())
        launches = counts()
    finally:
        srv.shutdown()
        srv.server_close()
        srv.serving_state.close()
        thread.join(timeout=10)
    want = json.loads(json.dumps(spipe.analyze_file(clip20)))
    check(spipe._cal == cal and got == {"filename": "20s.wav", **want},
          "/analyze on the artifact is not from_artifact's JSON with the calibration")
    check(sum(launches.values()) == 0, f"serving the artifact launched {launches}")
    print(f"[release] serve --artifact: /analyze of the 20-s clip = from_artifact's JSON "
          f"(calibration applied), labels {[s['label'] for s in got['segments']]}", flush=True)

    # 6. the artifact's windows/s against the live pipeline's, in turns
    live = InferencePipeline(load_merged(cal_pth), audio=AudioConfig(overlap=0.0),
                             spec=SpectrogramConfig.inference(size),
                             infer=InferenceConfig(batch_size=BATCH),
                             compute_dtype=torch.bfloat16 if bf16 else torch.float32,
                             device=device)
    # and the same artifact exported with the float32 transport, the live
    # pipeline's: what the host's int16 quantization costs
    f32t = InferencePipeline.from_artifact(export.export_serving(
        load_merged(cal_pth), spec=SpectrogramConfig.inference(size), batch_sizes=(8, BATCH),
        transport_dtype="float32", compute_dtype=torch.bfloat16 if bf16 else torch.float32,
        device=device))
    wps = {"artifact": [], "artifact, float32 transport": [], "live": []}
    for label, p in (("artifact", pipe), ("artifact, float32 transport", f32t), ("live", live),
                     ("live", live), ("artifact, float32 transport", f32t),
                     ("artifact", pipe)):
        wps[label].append(windows_per_s(p, windows))
    print(f"[release] windows/s at {size}², bf16 {bf16}, batch {BATCH}, {windows.shape[0]} "
          f"windows (in turns, median of 5 each): "
          + "; ".join(f"{k} {' / '.join(f'{v:.1f}' for v in vals)}" for k, vals in wps.items())
          + f" | {smi}", flush=True)
    # the host's share of the artifact's int16 transport: the quantization
    # of the float32 windows before the copy (the live pipeline sends
    # float32)
    from synthetic_audio_detection_tpu_torch.audio.wavio import pcm16_quantize

    quantize_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        pcm16_quantize(windows)
        quantize_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"[release] host int16 quantization of the {windows.shape[0]} windows: "
          f"{np.median(quantize_ms):.2f} ms (median of 5, host clock)", flush=True)
    out["windows_per_s"] = wps
    out["host_quantize_ms"] = float(np.median(quantize_ms))
    out["k1_launches"] = sum(v[names["k1"]] for v in out["launches"].values())
    out["conv_launches"] = sum(v[names["conv"]] for v in out["launches"].values())
    return out


# ---------------------------------------------------------------------------
# The data-preparation path
# ---------------------------------------------------------------------------

# the seeded raw corpus of phase 14 (tools/gen_study_corpus): Real and two
# synthetic generators, 44.1 kHz, alternating mono and stereo
DATA_SYNTHETIC = 2
DATA_FILES = 4  # sources a class: 8 took phase 14 past 100 s on the H100 machine (PERF.md §6)
DATA_SECONDS = 13.0
DATA_KEEP = 2  # max_to_keep of the trainer's step checkpointer


def _host_tree(tree):
    """A deep host copy of a payload tree (numpy leaves)."""
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    return np.array(tree, copy=True)


def _trees_equal(a, b) -> bool:
    if isinstance(b, dict):
        return isinstance(a, dict) and a.keys() == b.keys() and all(
            _trees_equal(a[k], b[k]) for k in b)
    return a.dtype == b.dtype and a.shape == b.shape and bool(np.array_equal(a, b))


def check_etl(root, raw_names, seconds):
    """The prepared tree: renamed sources carry their SHA-256[:16] names,
    converted files are 32 kHz mono PCM_16, 11 augmented files a source with
    the CSV, segments of 4 s or a source's trailing part, and no source
    group on both sides of the split. → counts."""
    import csv

    from synthetic_audio_detection_tpu_torch.data import augment, etl

    classes = sorted(raw_names)
    n_segments = 0
    for cls in classes:
        renamed = sorted(os.listdir(os.path.join(root, "raw", cls)))
        check(renamed == sorted(raw_names[cls]), f"{cls}: renamed files {renamed[:2]} are not "
                                                 "the SHA-256[:16] names of the sources")
        conv = sorted(os.listdir(os.path.join(root, "conv", cls)))
        check(conv == renamed, f"{cls}: converted files {conv[:2]}")
        for name in conv:
            with open(os.path.join(root, "conv", cls, name), "rb") as f:
                head = f.read(36)
            tag, channels, rate = (int.from_bytes(head[20:22], "little"),
                                   int.from_bytes(head[22:24], "little"),
                                   int.from_bytes(head[24:28], "little"))
            check((tag, channels, rate, int.from_bytes(head[34:36], "little")) == (1, 1, 32_000, 16),
                  f"{cls}/{name}: not 32 kHz mono PCM_16 ({tag}, {channels}, {rate})")
        aug = os.listdir(os.path.join(root, "aug", cls))
        with open(os.path.join(root, f"aug_{cls}.csv"), newline="") as f:
            rows = list(csv.DictReader(f))
        check(len(aug) == len(rows) == len(augment.AUGMENTATIONS) * DATA_FILES
              and sorted(r["output_file"] for r in rows) == sorted(aug),
              f"{cls}: {len(aug)} augmented files, {len(rows)} CSV rows")
        for src in conv:
            base = os.path.splitext(src)[0]
            check(sum(n.startswith(base + "_") for n in aug) == len(augment.AUGMENTATIONS),
                  f"{cls}/{src}: not 11 augmented files")
        # segments, by augmented file: 4 s each but the last, which is the rest
        segs = {}
        for side in ("train", "test"):
            for name in os.listdir(os.path.join(root, "dataset", side, cls)):
                base, idx = name[:-len(".wav")].rsplit("_Segment_", 1)
                with open(os.path.join(root, "dataset", side, cls, name), "rb") as f:
                    head = f.read(44)
                segs.setdefault(base, {})[int(idx)] = int.from_bytes(head[40:44], "little") // 2
        check(sorted(segs) == sorted(os.path.splitext(n)[0] for n in aug),
              f"{cls}: segments do not cover the augmented files")
        for base, parts in segs.items():
            n = sorted(parts)
            check(n == list(range(len(n))) and all(parts[i] == 4 * SR for i in n[:-1])
                  and 0 < parts[n[-1]] <= 4 * SR, f"{cls}/{base}: segments {parts}")
        n_segments += sum(len(p) for p in segs.values())
    audit = etl.check_overlap(os.path.join(root, "dataset"))
    check(audit.clean and set(audit.overlaps) == set(classes), "a source group on both sides")
    # a non-WAV input without ffmpeg: the clear error, counted, no crash
    bad = os.path.join(root, "mp3")
    os.makedirs(bad)
    with open(os.path.join(bad, "clip.mp3"), "wb") as f:
        f.write(b"\xff\xfb\x90\x00not an mp3")
    errors = etl.convert_directory(bad, bad + "_out")
    if etl.have_ffmpeg():
        print("[data] ffmpeg is installed here: the non-WAV error path is not reachable")
    else:
        check(errors == [f"{bad}/clip.mp3: non-WAV input requires ffmpeg (not installed)"],
              f"the .mp3 without ffmpeg gave {errors}")
    print(f"[data] ETL over {len(classes)} classes × {DATA_FILES} sources of {DATA_SECONDS:g} s "
          f"at 44.1 kHz: {n_segments} segments; seconds per CLI (summed over classes): "
          + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items())
          + f"; the .mp3 without ffmpeg: {len(errors)} error(s), no crash", flush=True)
    return n_segments


def check_native(root):
    """libsadio built from native/sadio.cpp in this run; decode_batch over
    the prepared segments against wavio (the JAX test's 1e-7), and
    resample_poly against resample_poly_np within both float32 sums'
    rounding bound. → report fields."""
    from synthetic_audio_detection_tpu_torch.audio import native, wavio
    from synthetic_audio_detection_tpu_torch.audio.resample import resample_poly_np, sinc_kernels
    from synthetic_audio_detection_tpu_torch.ops import build

    lib = build.host_library_path(native.SOURCE)
    if lib.exists():
        lib.unlink()  # built in this run, from the checkout's source
    t0 = time.perf_counter()
    check(native.available() and lib.exists(), "libsadio was not built into the build directory")
    build_s = time.perf_counter() - t0
    paths = sorted(os.path.join(d, n) for d, _, names in os.walk(os.path.join(root, "dataset"))
                   for n in names)
    t0 = time.perf_counter()
    out, lengths, rates = native.decode_batch(paths, 4 * SR)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = [wavio.read_wav(p)[0].mean(axis=0) for p in paths]
    wavio_s = time.perf_counter() - t0
    err = 0.0
    for i, r in enumerate(ref):
        check(lengths[i] == len(r) and rates[i] == SR, f"{paths[i]}: decoded {lengths[i]} frames")
        err = max(err, float(np.abs(out[i, :len(r)] - r).max()))
        check(not out[i, len(r):].any(), f"{paths[i]}: padding not zero")
    check(err <= 1e-7, f"native decode off wavio: {err} > 1e-7")
    raw = sorted(os.path.join(d, n) for d, _, names in os.walk(os.path.join(root, "raw"))
                 for n in names)
    x = wavio.read_wav(raw[0])[0].mean(axis=0)
    t0 = time.perf_counter()
    got = native.resample_poly(x, 44_100, SR)
    res_native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = resample_poly_np(x, 44_100, SR)
    res_np_s = time.perf_counter() - t0
    kern, *_ = sinc_kernels(44_100, SR)
    tol = 2 * kern.shape[1] * 2.0 ** -24 * float(np.abs(kern).sum(axis=1).max()) \
        * float(np.abs(x).max())
    res_err = float(np.abs(got - want).max())
    check(got.shape == want.shape and res_err <= tol,
          f"native resample off resample_poly_np: {res_err} > {tol}")
    print(f"[data] native: libsadio built from native/sadio.cpp in {build_s:.2f} s; decode_batch "
          f"of {len(paths)} segments {native_s:.3f} s (host clock, all cores) against wavio "
          f"{wavio_s:.3f} s, max |diff| {err:.3g} (tol 1e-7); resample_poly of a "
          f"{len(x) / 44_100:.1f}-s source to 32 kHz {res_native_s * 1e3:.1f} ms against "
          f"resample_poly_np {res_np_s * 1e3:.1f} ms, max |diff| {res_err:.3g} (tol {tol:.3g})",
          flush=True)
    return dict(segments=len(paths), decode_native_s=native_s, decode_wavio_s=wavio_s,
                decode_max_abs_err=err, resample_native_ms=res_native_s * 1e3,
                resample_numpy_ms=res_np_s * 1e3, resample_max_abs_err=res_err,
                resample_tol=tol, build_s=build_s)


def drive_data_training(zero_counts, counts, k1_name, work, data):
    """The submodel trainer CLI (Real vs SynthA, 2 epochs) and a Trainer
    under checkpoint_backend="orbax" (Real vs SynthB, 2 epochs, then an
    epoch at a time until three saves: the step checkpointer keeps
    DATA_KEEP) on the prepared tree, bf16 at 512², 16 files a step; K1 once
    per train step and no other kernel; the retained steps, their trees
    against host copies taken at save time, and the .pth twin's resume.
    → report fields."""
    import torch

    from synthetic_audio_detection_tpu_torch.checkpoints import torch_compat
    from synthetic_audio_detection_tpu_torch.checkpoints.orbax_io import OrbaxCheckpointer
    from synthetic_audio_detection_tpu_torch.cli import submodel_trainer
    from synthetic_audio_detection_tpu_torch.data import dataset as ds
    from synthetic_audio_detection_tpu_torch.train.trainer import Trainer
    from synthetic_audio_detection_tpu_torch.utils.config import SpectrogramConfig, TrainConfig

    out = {"launches": {}, "steps": {}, "seconds": {}}
    cwd = os.getcwd()
    os.chdir(work)  # the CLI writes its logs/ where it runs
    try:
        with observing(Trainer) as seen:
            zero_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                rc = submodel_trainer.main([
                    "--data-dir", data, "--Class0", "Real", "--Class1", "SynthA", "--epochs",
                    "2", "--batch-size", "16", "--input-size", "512", "--bf16", "--device",
                    "cuda", "--workers", "8", "--checkpoint-dir", os.path.join(work, "ck_data"),
                    "--log-dir", os.path.join(work, "runs_data")])
            out["seconds"]["cli"] = time.perf_counter() - t0
            check(rc == 0, f"trainer CLI on the prepared tree: exit code {rc}")
            out["launches"]["cli"] = launches = counts()
            tr = seen["trainers"][0]
            out["steps"]["cli"] = (tr.train_steps_run, tr.eval_steps_run)
    finally:
        os.chdir(cwd)
    check(launches[k1_name] == tr.train_steps_run > 0
          and sum(launches.values()) == launches[k1_name],
          f"trainer CLI: launches {launches} for {tr.train_steps_run} train steps")
    check(all(np.isfinite(v) for v in seen["losses"]), "a loss of the CLI run is not finite")
    print(f"[data] trainer CLI, Real vs SynthA, 2 epochs: {out['seconds']['cli']:.1f} s, "
          f"{tr.train_steps_run} train and {tr.eval_steps_run} eval steps, launches {launches}; "
          f"losses {['%.4f' % v for v in seen['losses']]}", flush=True)

    # the Trainer under checkpoint_backend="orbax"
    ck_dir = os.path.join(work, "ck_orbax")
    path = os.path.join(ck_dir, "best_model.ckpt")
    cfg = TrainConfig(data_dir=data, batch_size=16, epochs=2, compute_dtype="bfloat16",
                      class1="SynthB", workers=8, checkpoint_dir=ck_dir,
                      checkpoint_backend="orbax")
    tr = Trainer(cfg, spec_cfg=SpectrogramConfig(mel_norm=None, out_size=512),
                 log_dir=os.path.join(work, "runs_orbax"), device="cuda")
    ckpt = tr.checkpointer = OrbaxCheckpointer(path + ".orbax", max_to_keep=DATA_KEEP)
    saved, save_ms, wait_ms = {}, [], []
    real_save = ckpt.save

    def save(step, tree, metadata=None):
        t0 = time.perf_counter()
        ckpt.wait()  # the previous write, which an epoch of training overlapped
        wait_ms.append((time.perf_counter() - t0) * 1e3)
        saved[int(step)] = (_host_tree(tree), json.loads(json.dumps(metadata)))
        t0 = time.perf_counter()
        real_save(step, tree, metadata)
        save_ms.append((time.perf_counter() - t0) * 1e3)

    ckpt.save = save
    with observing(Trainer) as seen:
        zero_counts()
        t0 = time.perf_counter()
        tr.fit()
        samples = ds.list_samples(data, "train", tr.class_names)
        batcher = ds.WaveformBatcher(samples, cfg.batch_size, shuffle=True, workers=8,
                                     seed=cfg.seed)
        epoch = cfg.epochs
        while len(saved) < DATA_KEEP + 1:  # an epoch at a time until retention shows
            tr.train_epoch(batcher, epoch)
            tr.save_checkpoint(epoch, path)
            epoch += 1
        t1 = time.perf_counter()
        ckpt.wait()
        final_wait_ms = (time.perf_counter() - t1) * 1e3
        out["seconds"]["orbax"] = time.perf_counter() - t0
        out["launches"]["orbax"] = launches = counts()
    out["steps"]["orbax"] = (tr.train_steps_run, tr.eval_steps_run)
    check(launches[k1_name] == tr.train_steps_run > 0
          and sum(launches.values()) == launches[k1_name],
          f"orbax Trainer: launches {launches} for {tr.train_steps_run} train steps")
    check(all(np.isfinite(v) for v in seen["losses"]), "a loss of the orbax run is not finite")
    steps = sorted(saved)
    on_disk = sorted(int(n) for n in os.listdir(ckpt.directory) if n.isdigit())
    check(on_disk == steps[-DATA_KEEP:] and ckpt.latest_step() == steps[-1],
          f"retained steps {on_disk}, saved {steps}")
    for step in on_disk:
        tree, meta = ckpt.restore(step)
        check(meta == saved[step][1] and meta["total_steps"] == step,
              f"step {step}: metadata {meta}")
        check(_trees_equal(tree, saved[step][0]),
              f"step {step}: the restored tree differs from its host copy at save time")
    # the .pth twin (the last save's) resumes at its epoch + 1, moments bit for bit
    obj = torch.load(path + ".pth", map_location="cpu", weights_only=True)
    res = Trainer(TrainConfig(data_dir=data, batch_size=16, epochs=epoch + 1,
                              compute_dtype="bfloat16", class1="SynthB", workers=8,
                              checkpoint_dir=os.path.join(work, "ck_orbax_resume"),
                              resume=path + ".pth"),
                  spec_cfg=SpectrogramConfig(mel_norm=None, out_size=512),
                  log_dir=os.path.join(work, "runs_orbax"), device="cuda")
    check(res.start_epoch == int(obj["epoch"]) + 1 == epoch,
          f"resume started at {res.start_epoch}, saved epoch {obj['epoch']}")
    mu, nu = res.state.moments()
    keys = torch_compat.trainable_param_keys(obj["state_dict"], base_prefix="base.")
    state = obj["optimizer"]["state"]
    check(len(keys) == len(state) and int(res.state.count) == int(state[0]["step"]),
          "resumed optimizer state")
    for i, k in enumerate(keys):
        check(torch.equal(mu[k].cpu(), state[i]["exp_avg"])
              and torch.equal(nu[k].cpu(), state[i]["exp_avg_sq"]),
              f"resumed moments of {k} differ from the .pth")
    out["save_ms"] = float(np.median(save_ms))
    out["wait_after_epoch_ms"] = float(np.median(wait_ms[1:]))
    out["final_wait_ms"] = final_wait_ms
    out["saved_steps"], out["retained_steps"] = steps, on_disk
    print(f"[data] orbax Trainer, Real vs SynthB: {out['seconds']['orbax']:.1f} s, "
          f"{tr.train_steps_run} train and {tr.eval_steps_run} eval steps, launches {launches}; "
          f"saves at steps {steps}, kept {on_disk} (max_to_keep {DATA_KEEP}), each restored bit "
          f"for bit; save() {out['save_ms']:.1f} ms median of {len(save_ms)} (host copy), wait() "
          f"after an epoch of training {out['wait_after_epoch_ms']:.2f} ms median of "
          f"{len(wait_ms) - 1}, wait() right after the last save {final_wait_ms:.1f} ms (host "
          f"clock); the .pth twin resumes at epoch {res.start_epoch} with {len(keys)} moment "
          f"pairs bit-equal; losses {['%.4f' % v for v in seen['losses']]}", flush=True)
    del res
    return out


def trace_serving_batch(merged, logdir, *paths):
    """One bf16 serving batch of ``paths``' windows at 512² under
    utils/profiling.trace into ``logdir``, after a warm-up batch; prints the
    window count."""
    import torch

    from synthetic_audio_detection_tpu_torch.checkpoints import serialization
    from synthetic_audio_detection_tpu_torch.infer.pipeline import (
        InferencePipeline,
        preprocess_waveform,
        slice_waveform,
    )
    from synthetic_audio_detection_tpu_torch.utils import profiling
    from synthetic_audio_detection_tpu_torch.utils.config import (
        AudioConfig,
        InferenceConfig,
        SpectrogramConfig,
    )

    audio = AudioConfig(overlap=0.0, silence_threshold=1e-3)
    pipe = InferencePipeline(serialization.load_merged(merged), audio=audio,
                             spec=SpectrogramConfig.inference(out_size=512),
                             infer=InferenceConfig(), compute_dtype=torch.bfloat16, device="cuda")
    windows = np.concatenate([slice_waveform(preprocess_waveform(p, audio), audio)[0]
                              for p in paths])[:BATCH]
    pipe.logits_for_windows(windows)  # warm
    with profiling.trace(logdir):
        with profiling.annotate("serving batch"):
            pipe.logits_for_windows(windows)
        torch.cuda.synchronize()
    print(windows.shape[0])


def drive_data_serving(zero_counts, counts, names, work, data):
    """cli/model_merger merges the two heads trained on the prepared tree,
    cli/inference_runner serves every test segment (folder mode, one JSON
    a file): every window labelled, K1 once per batch, the conv kernel 19
    times per batch on a shared backbone and never on another layout; then
    utils/profiling.trace around one serving batch (K1 named in the trace)
    and a StageTimer over the stages of a few files. → report fields."""
    import logging

    import torch

    from synthetic_audio_detection_tpu_torch.checkpoints import serialization
    from synthetic_audio_detection_tpu_torch.cli import inference_runner, model_merger
    from synthetic_audio_detection_tpu_torch.infer.pipeline import (
        InferencePipeline,
        preprocess_waveform,
        slice_waveform,
    )
    from synthetic_audio_detection_tpu_torch.utils import profiling
    from synthetic_audio_detection_tpu_torch.utils.config import (
        AudioConfig,
        InferenceConfig,
        SpectrogramConfig,
    )

    recipe = os.path.join(work, "data_recipe.csv")
    with open(recipe, "w") as f:
        f.write("model_filename,synthetic_class,real_class\n"
                "ck_data/best_model.ckpt.pth,SynthA,Real\n"
                "ck_orbax/best_model.ckpt.pth,SynthB,Real\n")
    merged = os.path.join(work, "data_merged.pth")
    rc = _quiet(model_merger.main, ["--submodels-folder", work, "--csv-file", recipe,
                                    "--output-path", merged, "--device", "cuda"])
    check(rc == 0, f"merger on the prepared tree's heads: exit code {rc}")
    ens = serialization.load_merged(merged)
    layout = ("shared" if ens.shared_backbone else
              f"trunk K={ens.shared_trunk_stages}" if ens.trunk is not None else "dense")
    audio = AudioConfig(overlap=0.0, silence_threshold=1e-3)
    classes = ens.synthetic_names + [ens.real_name]
    out = {"layout": layout, "seconds": {}, "launches": {}, "windows": 0, "batches": 0}
    root_logger = logging.getLogger()
    level = root_logger.level
    for cls in sorted(os.listdir(os.path.join(data, "test"))):
        folder = os.path.join(data, "test", cls)
        files = sorted(os.listdir(folder))
        n_windows = {f: slice_waveform(preprocess_waveform(os.path.join(folder, f), audio),
                                       audio)[0].shape[0] for f in files}
        batches = sum(-(-n // BATCH) for n in n_windows.values())
        zero_counts()
        t0 = time.perf_counter()
        root_logger.setLevel(logging.WARNING)  # one "wrote" line a file otherwise
        try:
            with counting_trunk_passes() as passes:
                rc = _quiet(inference_runner.main, [
                    "--merged-model", merged, "--audio-dir", folder, "--output-json",
                    os.path.join(work, "data_serve", cls), "--bf16", "--input-size", "512",
                    "--device", "cuda"])
        finally:
            root_logger.setLevel(level)
        sec = time.perf_counter() - t0
        launches = counts()
        check(rc == 0, f"inference_runner on test/{cls}: exit code {rc}")
        for f in files:
            with open(os.path.join(work, "data_serve", cls, os.path.splitext(f)[0] + ".json")) as g:
                res = json.load(g)
            check(len(res["segments"]) == n_windows[f]
                  and all(s["label"] in classes for s in res["segments"]),
                  f"test/{cls}/{f}: {len(res['segments'])} labelled windows of {n_windows[f]}")
        conv = CONV_LAUNCHES_PER_BATCH * batches if ens.shared_backbone else 0
        check(launches[names["k1"]] == batches and launches[names["conv"]] == conv
              and sum(launches.values()) == batches + conv,
              f"test/{cls}: launches {launches} for {batches} batches ({layout})")
        check(passes[0] == (batches if ens.trunk is not None else 0), f"test/{cls}: trunk passes")
        out["seconds"][cls] = sec
        out["launches"][cls] = launches
        out["windows"] += sum(n_windows.values())
        out["batches"] += batches
        print(f"[data] serve test/{cls} ({len(files)} files, {sum(n_windows.values())} windows, "
              f"{layout}, {ens.num_heads} heads): {sec:.2f} s (CLI wall), launches {launches}",
              flush=True)

    # one serving batch under the profiler, in a fresh interpreter: in this
    # process, after the earlier phases' profiler sessions, torch.profiler's
    # device trace kept every kernel of the batch but the three that the
    # log-mel kernel's library launches (three full runs of this script; run
    # alone, phase 14 traced them)
    folder = os.path.join(data, "test", "Real")
    paths = [os.path.join(folder, f) for f in sorted(os.listdir(folder))][:BATCH]
    logdir = os.path.join(work, "data_trace")
    traced = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
         "chip_smoke.trace_serving_batch(*sys.argv[2:])", REPO, merged, logdir, *paths],
        capture_output=True, text=True, timeout=300)
    check(traced.returncode == 0, f"the traced serving batch failed: {traced.stderr[-2000:]}")
    traced_windows = int(traced.stdout.split()[-1])
    files = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
    check(len(files) == 1, f"trace files {files}")
    with open(os.path.join(logdir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1_events = [e for e in kernels if "dft_mel_kernel" in e.get("name", "")]
    check(any(e.get("name") == "serving batch" for e in events),
          "the trace lacks the annotated serving batch")
    check(len(k1_events) == 1, f"{len(k1_events)} K1 DFT launches among the trace's "
                               f"{len(kernels)} kernels, not 1")
    pipe = InferencePipeline(ens, audio=audio, spec=SpectrogramConfig.inference(out_size=512),
                             infer=InferenceConfig(), compute_dtype=torch.bfloat16, device="cuda")
    timer = profiling.StageTimer()
    for p in paths[:16]:
        with timer.stage("decode+window"):
            w, stamps = slice_waveform(preprocess_waveform(p, audio), audio)
        with timer.stage("device"):
            logits = pipe.logits_for_windows(w)
        with timer.stage("decide+json"):
            pipe.analyze_windows(w, stamps, logits=logits)
    report = timer.report()
    check(sorted(timer.counts) == ["decide+json", "decode+window", "device"]
          and all(v == 16 for v in timer.counts.values()), f"stage counts {timer.counts}")
    print(f"[data] profiling.trace of one batch of {traced_windows} windows: "
          f"{os.path.getsize(os.path.join(logdir, files[0]))} bytes, {len(kernels)} kernel "
          f"events, {len(k1_events)} of K1's dft_mel_kernel | StageTimer over 16 files:\n"
          + "\n".join(f"[data]   {line}" for line in report.splitlines()), flush=True)
    out["trace_k1_events"] = len(k1_events)
    out["stages"] = {k: timer.totals[k] / timer.counts[k] * 1e3 for k in timer.totals}
    out["k1_launches"] = sum(v[names["k1"]] for v in out["launches"].values())
    out["conv_launches"] = sum(v[names["conv"]] for v in out["launches"].values())
    return out


def drive_data(zero_counts, counts, names, work):
    """Phase 14: a seeded raw corpus → the port's six ETL CLIs
    (tools/study_pipeline, each CLI in a subprocess) → the native library →
    two heads trained on the prepared tree (the CLI; the Trainer under the
    orbax backend) → merged and served, with a trace. → report fields."""
    import hashlib

    from synthetic_audio_detection_tpu_torch.tools import gen_study_corpus, study_pipeline

    root = os.path.join(work, "data_prep")
    t0 = time.perf_counter()
    gen_study_corpus.generate(root, DATA_SYNTHETIC, DATA_FILES, DATA_SECONDS, 44_100, 7)
    corpus_s = time.perf_counter() - t0
    raw_names = {}
    for cls in os.listdir(os.path.join(root, "raw")):
        folder = os.path.join(root, "raw", cls)
        raw_names[cls] = []
        for name in os.listdir(folder):
            with open(os.path.join(folder, name), "rb") as f:
                raw_names[cls].append(hashlib.sha256(f.read()).hexdigest()[:16] + ".wav")
    print(f"[data] corpus: {sum(map(len, raw_names.values()))} sources in {corpus_s:.1f} s",
          flush=True)
    seconds = study_pipeline.run(root)  # the CLIs' own lines go to the output
    out = {"corpus_s": corpus_s, "cli_seconds": seconds,
           "segments": check_etl(root, raw_names, seconds)}
    out["native"] = check_native(root)
    data = os.path.join(root, "dataset")
    out["train"] = drive_data_training(zero_counts, counts, names["k1"], work, data)
    out["serve"] = drive_data_serving(zero_counts, counts, names, work, data)
    out["k1_launches"] = (out["train"]["launches"]["cli"][names["k1"]]
                          + out["train"]["launches"]["orbax"][names["k1"]]
                          + out["serve"]["k1_launches"])
    out["conv_launches"] = out["serve"]["conv_launches"]
    return out


# ---------------------------------------------------------------------------
# Phase 15: torch.distributed on one card (an NCCL group of world size 1)
# ---------------------------------------------------------------------------

PARALLEL_STEPS = 3
# the data-parallel submodel step's collectives in phase 1 (the gradient
# stops at stage 4), all all-reduces, as tests/test_torch_distributed.py
# counts them on 2 and 3 CPU ranks: the global weight sum, one per
# train-mode BatchNorm (20 in the ResNet-18, 2 in the head), one more in
# the backward pass of each BatchNorm past the stop (5 in layer4, 2 in the
# head), the gradients, the metrics
STEP_ALL_REDUCES = 1 + 22 + 7 + 1 + 1


def drive_parallel(zero_counts, counts, names, work, shared_path, windows, smi):
    """Phase 15: an NCCL group of world size 1 at full width. The
    data-parallel Trainer (its mesh) and the plain one from one seed, 3
    bf16 steps on the same batches of phase 8's tree: parameters, BN
    statistics, moments and count bit for bit, K1 once a step, the same
    all-reduces every step; the submodel trainer CLI under torchrun
    (--nproc-per-node 1) for one epoch; InferencePipeline(mesh=...) on
    phase 6's shared checkpoint over the 150 windows, logits bit for bit
    with the pipeline without a mesh, K1 once and the conv kernel 19 times
    a batch, one all-gather a batch; the step's median ms with and
    without the group, in turns. → report fields."""
    import torch
    import torch.distributed as dist

    from synthetic_audio_detection_tpu_torch.checkpoints.serialization import load_merged_torch
    from synthetic_audio_detection_tpu_torch.data import dataset as ds
    from synthetic_audio_detection_tpu_torch.infer.pipeline import InferencePipeline
    from synthetic_audio_detection_tpu_torch.parallel import sharding as sh
    from synthetic_audio_detection_tpu_torch.train.trainer import Trainer
    from synthetic_audio_detection_tpu_torch.utils.config import (
        AudioConfig,
        InferenceConfig,
        SpectrogramConfig,
        TrainConfig,
    )

    out = {}
    dist.init_process_group("nccl", init_method="file://" + os.path.join(work, "nccl_init"),
                            world_size=1, rank=0, device_id=torch.device("cuda", 0))
    try:
        mesh = sh.create_mesh()
        check(mesh.shape == {"data": 1, "model": 1} and mesh.device == torch.device("cuda", 0),
              f"the one-rank mesh: {mesh.shape} on {mesh.device}")
        cfg = TrainConfig(batch_size=16, compute_dtype="bfloat16", class1="SynthA", workers=8)
        spec = SpectrogramConfig(mel_norm=None, out_size=512)
        trainers = {name: Trainer(cfg, spec_cfg=spec, log_dir=os.path.join(work, f"runs_{name}"),
                                  device="cuda", use_mesh=False, mesh=m)
                    for name, m in (("plain", None), ("mesh", mesh))}
        data = os.path.join(work, "train_data")
        samples = [s for s in ds.list_samples(data, "train", ["Real", "SynthA"])
                   if not s[0].endswith("short.wav")][:16 * PARALLEL_STEPS]
        batches = list(trainers["plain"]._batches(
            ds.WaveformBatcher(samples, 16, shuffle=False, workers=8), 0, TRAIN_ROWS))
        check(len(batches) == PARALLEL_STEPS and all(
            b["audio"].shape[0] == TRAIN_ROWS and b["audio"].dtype == torch.int16 for b in batches),
            "phase 15's batches")
        launches, per_step = {}, []
        for name, tr in trainers.items():
            zero_counts()
            for b in batches:
                mesh.counts.clear()
                tr._train_step(tr.state, b, tr.generator)
                if name == "mesh":
                    per_step.append(dict(mesh.counts))
            torch.cuda.synchronize()
            launches[name] = counts()
        plain, meshed = trainers["plain"], trainers["mesh"]
        a, b = plain.model.state_dict(), meshed.model.state_dict()
        differ = [k for k in a if not torch.equal(a[k], b[k])]
        differ += [n for n, x, y in zip(plain.state.names * 2, plain.state.mu + plain.state.nu,
                                        meshed.state.mu + meshed.state.nu)
                   if not torch.equal(x, y)]
        print(f"[parallel] {PARALLEL_STEPS} bf16 steps at 512², {TRAIN_ROWS} rows, NCCL world "
              f"size 1 against no group: {len(differ)} tensors differ (parameters, BN "
              f"statistics, moments); count {int(plain.state.count)} / "
              f"{int(meshed.state.count)}; collectives a step {per_step}; launches {launches}",
              flush=True)
        check(not differ, f"the data-parallel steps differ from the plain ones: {differ[:4]}")
        check(int(plain.state.count) == int(meshed.state.count) == PARALLEL_STEPS, "Adam count")
        check(all(c == {"all_reduce": STEP_ALL_REDUCES} for c in per_step),
              f"collectives a step {per_step}, not {STEP_ALL_REDUCES} all-reduces")
        for name in trainers:
            check(launches[name][names["k1"]] == PARALLEL_STEPS
                  and sum(launches[name].values()) == PARALLEL_STEPS,
                  f"{name} steps: K1 once a step and nothing else, {launches[name]}")
        out["steps"] = {"tensors_differing": len(differ), "collectives_per_step": per_step[0],
                        "launches": launches["mesh"]}

        # the trainer CLI under torchrun, one process
        ck = os.path.join(work, "ck_torchrun")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1",
             "-m", "synthetic_audio_detection_tpu_torch.cli.submodel_trainer", "--data-dir", data,
             "--Class0", "Real", "--Class1", "SynthA", "--batch-size", "16", "--input-size", "512",
             "--bf16", "--device", "cuda", "--workers", "8", "--epochs", "1",
             "--checkpoint-dir", ck, "--log-dir", os.path.join(work, "runs_torchrun")],
            cwd=work, env=env, capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        saves = (proc.stdout + proc.stderr).count("saved best checkpoint")
        print(f"[parallel] torchrun --nproc-per-node 1 submodel_trainer, 1 epoch: exit "
              f"{proc.returncode} in {seconds:.1f} s, {saves} checkpoint save(s)", flush=True)
        check(proc.returncode == 0, f"torchrun trainer exit {proc.returncode}:\n"
                                    f"{proc.stderr[-3000:]}")
        check(saves == 1 and all(os.path.exists(os.path.join(ck, f))
                                 for f in ("best_model.ckpt", "best_model.ckpt.pth")),
              "the torchrun trainer's checkpoint, written once")
        out["torchrun"] = {"seconds": seconds, "saves": saves}

        # data-parallel serving on the shared checkpoint
        kw = dict(audio=AudioConfig(overlap=0.0, silence_threshold=1e-3),
                  spec=SpectrogramConfig.inference(out_size=512), infer=InferenceConfig(),
                  compute_dtype=torch.bfloat16, device="cuda")
        p_plain = InferencePipeline(load_merged_torch(shared_path), **kw)
        p_mesh = InferencePipeline(load_merged_torch(shared_path), mesh=mesh, **kw)
        zero_counts()
        mesh.counts.clear()
        l_mesh = p_mesh.logits_for_windows(windows)
        serve_launches, coll = counts(), dict(mesh.counts)
        l_plain = p_plain.logits_for_windows(windows)
        n_batches = -(-windows.shape[0] // BATCH)
        print(f"[parallel] InferencePipeline(mesh=...) on {windows.shape[0]} windows: logits "
              f"{'bit-equal' if np.array_equal(l_mesh, l_plain) else 'DIFFERENT'} to no mesh "
              f"(max diff {float(np.abs(l_mesh - l_plain).max()):.3g}); launches "
              f"{serve_launches}; collectives {coll}", flush=True)
        check(np.array_equal(l_mesh, l_plain), "data-parallel serving logits differ")
        check(serve_launches[names["k1"]] == n_batches
              and serve_launches[names["conv"]] == CONV_LAUNCHES_PER_BATCH * n_batches
              and sum(serve_launches.values()) == (1 + CONV_LAUNCHES_PER_BATCH) * n_batches,
              f"data-parallel serving launches {serve_launches}")
        check(coll == {"all_gather": n_batches}, f"serving collectives {coll}")
        out["serving"] = {"launches": serve_launches, "collectives": coll}

        # the step with and without the group, in turns
        times = {"plain": [], "mesh": []}
        for name in ("plain", "mesh", "mesh", "plain"):
            tr, b = trainers[name], batches[0]
            times[name].append(median_ms(lambda: tr._train_step(tr.state, b, tr.generator)))
        print(f"[parallel] bf16 train step, 512², {TRAIN_ROWS} rows, median of 20 (CUDA "
              f"events): no group {' / '.join(f'{v:.3f}' for v in times['plain'])} ms, NCCL "
              f"world size 1 {' / '.join(f'{v:.3f}' for v in times['mesh'])} ms | {smi}",
              flush=True)
        out["step_ms"] = times
        out["k1_launches"] = launches["mesh"][names["k1"]] + serve_launches[names["k1"]]
        out["conv_launches"] = serve_launches[names["conv"]]
    finally:
        dist.destroy_process_group()
    return out


# ---------------------------------------------------------------------------
# Phase 16: the int8 PTQ backbone on the card
# ---------------------------------------------------------------------------

def lead_error(l32, l8):
    """The largest change, over the windows, that ``l8`` makes to the lead
    of ``l32``'s top logit over any other logit of its window."""
    rows = np.arange(l32.shape[0])
    top = l32.argmax(1)
    lead32 = l32[rows, top][:, None] - l32
    lead8 = l8[rows, top][:, None] - l8
    return float(np.abs(lead8 - lead32).max())


def int8_features(windows):
    """The bf16 serving pipeline's 512² features of ``windows`` (numpy
    [n, T]), in 128-window buckets (the last padded with silent windows):
    K1, the resize, bf16, three channels. → [buckets × 128, 3, 512, 512]."""
    import torch

    from synthetic_audio_detection_tpu_torch.ops import melspec
    from synthetic_audio_detection_tpu_torch.ops.cuda_melspec import serving_log_mel
    from synthetic_audio_detection_tpu_torch.utils.config import SpectrogramConfig

    spec = SpectrogramConfig.inference(out_size=512)
    n = -(-windows.shape[0] // BATCH) * BATCH
    padded = np.zeros((n, windows.shape[1]), np.float32)
    padded[:windows.shape[0]] = windows
    out = []
    for b in torch.from_numpy(padded).cuda().split(BATCH):
        z = serving_log_mel(b, spec, SR)
        out.append(melspec.replicate_channels(melspec.finalize_features(z, spec)
                                              .to(torch.bfloat16), 3))
    return torch.cat(out)


def drive_int8(shared_path, windows, l32, p32, smi):
    """Phase 16: the int8 ensemble (models/quantized.py) of phase 6's
    shared checkpoint on the 512² bf16 features of the 150 windows, in the
    128 bucket: the card against the CPU on 2 windows (stem accumulators
    bit for bit, logits within 1e-4); argmax agreement with the float32
    pipeline on clear windows; int8 windows/s against the bf16 default
    route on the same features, in turns; _int_mm launches a batch.
    → report fields.

    Clear windows. Agreement where the float32 top logit leads by 0.05 is
    reported; the check uses the margin the reference's int8 scheme
    itself needs, since its per-tensor activation scales over a 128-window
    batch flip windows clear by 0.05 (PERF.md §6): the largest
    change int8 makes, on 128 held-out windows of another clip, to a
    float32 top logit's lead over any other (``lead_error``). A window
    clear by more than that must keep its argmax, and at least one must
    be clear."""
    import torch

    from synthetic_audio_detection_tpu_torch.checkpoints.serialization import load_merged_torch
    from synthetic_audio_detection_tpu_torch.ensemble.multihead import (
        _aggregate,
        ensemble_per_head_logits,
        with_dtype,
    )
    from synthetic_audio_detection_tpu_torch.infer.pipeline import slice_waveform
    from synthetic_audio_detection_tpu_torch.models import quantized
    from synthetic_audio_detection_tpu_torch.utils.config import AudioConfig

    ens = load_merged_torch(shared_path)
    check(ens.shared_backbone, "phase 6's checkpoint has a shared backbone")
    t0 = time.perf_counter()
    q = quantized.quantize_ensemble(ens, device="cuda")
    quant_s = time.perf_counter() - t0
    n = windows.shape[0]
    x = int8_features(windows)

    def int8_logits(feats):
        return torch.cat([quantized.quantized_ensemble_forward(q, b)
                          for b in feats.split(BATCH)]).cpu().numpy()

    quantized.INT_MM.launches = 0
    li8 = int8_logits(x)[:n]
    torch.cuda.synchronize()
    per_batch = quantized.INT_MM.launches / (x.shape[0] // BATCH)
    check(li8.shape == (n, len(NAMES)) and np.isfinite(li8).all(), "int8 logits")
    check(per_batch == 20, f"{per_batch} _int_mm launches a batch, not 20 (one a conv)")

    # the card against the CPU on 2 windows
    small = x[:2].float()
    q_cpu = quantized.quantize_ensemble(ens, device="cpu")
    acc_gpu, s_gpu = quantized.qconv_accumulators(small.permute(0, 2, 3, 1),
                                                  q.qbackbone["stem"], 2)
    acc_cpu, s_cpu = quantized.qconv_accumulators(small.cpu().permute(0, 2, 3, 1),
                                                  q_cpu.qbackbone["stem"], 2)
    stem_equal = float(s_gpu) == float(s_cpu) and torch.equal(acc_gpu.cpu(), acc_cpu)
    l_gpu = quantized.quantized_ensemble_forward(q, small).cpu().numpy()
    l_cpu = quantized.quantized_ensemble_forward(q_cpu, small.cpu()).numpy()
    card_vs_cpu = float(np.abs(l_gpu - l_cpu).max())
    print(f"[int8] card against CPU, 2 windows at 512²: stem accumulators "
          f"{'bit-equal' if stem_equal else 'DIFFERENT'}; logits max diff {card_vs_cpu:.3g} "
          f"(tol 1e-4)", flush=True)
    check(stem_equal, "the card's stem accumulators differ from the CPU's")
    check(card_vs_cpu <= 1e-4, "the card's int8 logits differ from the CPU's")

    # argmax agreement with the float32 pipeline
    audio = AudioConfig(overlap=0.0, silence_threshold=1e-3)
    held, _ = slice_waveform(make_clip(4 * BATCH, seed=16), audio)
    check(held.shape[0] == BATCH, "the held-out clip's windows")
    err_cal = lead_error(p32.logits_for_windows(held), int8_logits(int8_features(held)))
    top = np.sort(l32, axis=1)
    margin = top[:, -1] - top[:, -2]
    agree = l32.argmax(1) == li8.argmax(1)
    need = max(0.05, err_cal)
    clear, clear05 = margin > need, margin > 0.05
    bad = [(int(i), round(float(margin[i]), 3)) for i in np.flatnonzero(clear05 & ~agree)]
    print(f"[int8] argmax against float32: {int(agree[clear05].sum())}/{int(clear05.sum())} "
          f"windows clear by 0.05 agree (disagreeing windows and margins {bad}); int8 moved "
          f"a top logit's lead by up to {err_cal:.3f} on 128 held-out windows, so "
          f"{int(agree[clear].sum())}/{int(clear.sum())} windows clear by {need:.3f} agree; "
          f"{int(agree.sum())}/{n} overall; |int8 − float32| max "
          f"{float(np.abs(li8 - l32).max()):.3f} mean {float(np.abs(li8 - l32).mean()):.3f}, "
          f"corr {float(np.corrcoef(li8.ravel(), l32.ravel())[0, 1]):.5f}", flush=True)
    check(clear.sum() >= 1, f"no window clear by {need:.3f}")
    check(bool(agree[clear].all()), "int8 and float32 verdicts differ on clear windows")

    # windows/s against the bf16 default route on the same features, in turns
    ens16 = with_dtype(load_merged_torch(shared_path).to("cuda"), torch.bfloat16)
    batch = x[:BATCH]
    routes = {
        "int8": lambda: quantized.quantized_ensemble_forward(q, batch),
        "bf16": lambda: _aggregate(ensemble_per_head_logits(
            ens16, batch, fast_backbone=True, conv3x3_max_channels=512)),
    }
    wps = {"int8": [], "bf16": []}
    for route in ("int8", "bf16", "bf16", "int8"):
        wps[route].append(BATCH / median_ms(routes[route], n=10) * 1e3)
    print(f"[int8] backbone and heads on 128 features at 512², median of 10 (CUDA events): "
          f"int8 {' / '.join(f'{v:.1f}' for v in wps['int8'])} windows/s, bf16 default route "
          f"{' / '.join(f'{v:.1f}' for v in wps['bf16'])} windows/s; {per_batch:.0f} _int_mm "
          f"launches a batch; quantized in {quant_s:.2f} s | {smi}", flush=True)
    return {"int_mm_per_batch": per_batch, "card_vs_cpu_max_abs": card_vs_cpu,
            "clear_05": int(clear05.sum()), "agree_05": int(agree[clear05].sum()),
            "err_calibration": err_cal, "margin": need, "clear": int(clear.sum()),
            "agree": int(agree[clear].sum()), "agree_all": int(agree.sum()),
            "windows_per_s": wps, "quantize_s": quant_s}


# ---------------------------------------------------------------------------
# Phase 17: the study campaigns
# ---------------------------------------------------------------------------

# A campaign step's interpreter in phase 17 (the drivers' campaign.INTERPRETER):
# the step's module main(argv) in a fresh process as the step's own command
# would run it, every kernel's launch count zeroed first; then one JSON line
# (the step, its exit code, main()'s seconds, the launches) appended to the
# file named by the first argument, and main()'s exit code.
CHILD = r"""
import importlib, importlib.util, json, sys, time
out, args = sys.argv[1], sys.argv[2:]
if args[0] == "-m":
    name, argv = args[1], args[2:]
    mod = importlib.import_module(name)
else:
    name, argv = args[0], args[1:]
    spec = importlib.util.spec_from_file_location("campaign_step", name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
kernels = []
if name.startswith("synthetic_audio_detection_tpu_torch."):
    from synthetic_audio_detection_tpu_torch.ops import (
        cuda_conv, cuda_melspec, cuda_melspec_strip, cuda_probes)
    kernels = [cuda_melspec.KERNEL, cuda_melspec_strip.KERNEL, cuda_conv.KERNEL,
               cuda_probes.KERNEL]
for k in kernels:
    k.launches = 0
t0 = time.perf_counter()
try:
    rc = mod.main(argv)
except SystemExit as e:
    rc = e.code
except Exception:
    import traceback
    traceback.print_exc()
    rc = 1
rc = rc if isinstance(rc, int) else int(rc is not None)
seconds = time.perf_counter() - t0
sys.stdout.flush()
with open(out, "a") as f:
    step = name.rsplit("/", 1)[-1].removesuffix(".py").rsplit(".", 1)[-1]
    f.write(json.dumps({"step": step, "argv": argv, "rc": rc, "seconds": seconds,
                        "launches": {k.name: k.launches for k in kernels}}) + "\n")
sys.exit(rc)
"""


@contextlib.contextmanager
def output_to(path):
    """File descriptors 1 and 2 (this process's and its children's) into
    ``path`` while open."""
    sys.stdout.flush()
    sys.stderr.flush()
    saved = os.dup(1), os.dup(2)
    try:
        with open(path, "ab") as f:
            os.dup2(f.fileno(), 1)
            os.dup2(f.fileno(), 2)
            yield
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        os.dup2(saved[0], 1)
        os.dup2(saved[1], 2)
        os.close(saved[0])
        os.close(saved[1])


def per_class_finite(path, classes):
    """A study JSON's per_class: a finite binary rate for each of
    ``classes``. → the per_class dict."""
    with open(path) as f:
        pc = json.load(f)["per_class"]
    check(sorted(pc) == sorted(classes)
          and all(np.isfinite(v["binary"]) and np.isfinite(v["attribution"])
                  for v in pc.values()), f"{path}: per_class {pc}")
    return pc


def drive_campaigns(names, work, smi):
    """Phase 17: the seven campaign drivers' steps on phase 14's prepared
    tree (Real, SynthA, SynthB), each step a fresh process on the card
    through CHILD. → report fields."""
    from synthetic_audio_detection_tpu_torch.checkpoints import serialization
    from synthetic_audio_detection_tpu_torch.tools import (
        campaign,
        generalization_study,
        logo_calibration_followup,
        round4_campaign,
        round5_addhead_study,
        round5_phase2,
        train_study_ensemble,
    )

    root = os.path.join(work, "data_prep")
    classes = campaign.classes(os.path.join(root, "dataset", "test"))
    check(classes == ["SynthA", "SynthB"], f"phase 14's classes {classes}")
    steps_path = os.path.join(work, "campaign_steps.jsonl")
    out_path = os.path.join(work, "campaign_output.log")
    runs, steps = {}, []
    c4 = round4_campaign.open_campaign(root)

    def drive(label, fn, *args, **kw):
        """One driver call with its steps' output in out_path; → its steps."""
        start = len(steps)
        t0 = time.perf_counter()
        with output_to(out_path):
            rc = fn(*args, **kw)
        seconds = time.perf_counter() - t0
        if os.path.exists(steps_path):
            with open(steps_path) as f:
                steps[:] = [json.loads(line) for line in f]
        mine = steps[start:]
        runs[label] = {"rc": rc, "seconds": seconds, "steps": mine}
        print(f"[campaigns] {label}: exit {rc} in {seconds:.1f} s; steps (main() seconds, "
              f"launches K1/conv): " + ", ".join(
                  f"{s['step']} {s['seconds']:.1f} s "
                  f"{s['launches'].get(names['k1'], '-')}/{s['launches'].get(names['conv'], '-')}"
                  for s in mine), flush=True)
        if rc != 0 or any(s["rc"] != 0 for s in mine):
            logs = [out_path] + sorted(glob.glob(os.path.join(root, "campaign_logs", "*.log")))
            for path in logs:
                with open(path, errors="replace") as f:
                    print(f"--- {path}\n{f.read()[-4000:]}", file=sys.stderr)
        check(rc == 0 and all(s["rc"] == 0 for s in mine), f"{label}: exit {rc}, steps "
                                                         f"{[(s['step'], s['rc']) for s in mine]}")
        return mine

    def kernels_of(step, serving, conv_layout):
        """K1 in every trainer and serving step; the conv kernel a positive
        multiple of 19 on a shared backbone, none otherwise; nothing else."""
        n = step["launches"]
        k1, conv = n[names["k1"]], n[names["conv"]]
        check(k1 > 0, f"{step['step']} {step['argv'][:4]}: no K1 launch")
        want_conv = serving and conv_layout
        check((conv > 0 and conv % CONV_LAUNCHES_PER_BATCH == 0) if want_conv else conv == 0,
              f"{step['step']} {step['argv'][:4]}: {conv} conv launches")
        check(sum(n.values()) == k1 + conv, f"{step['step']}: launches {n}")

    interpreter = campaign.INTERPRETER
    campaign.INTERPRETER = [sys.executable, "-c", CHILD, steps_path]
    cwd = os.getcwd()
    os.chdir(work)  # the trainers write their logs/ where they run
    t_phase = time.perf_counter()
    try:
        # 1. one head per class with hard negatives, merged (dense), studied
        seq = drive("train_study_ensemble HARD_NEG=1", train_study_ensemble.run, root,
                    epochs="1", hard_neg=True)
        e = os.path.join(root, "ensemble")
        with open(os.path.join(e, "recipe.csv")) as f:
            check(f.read() == "model_filename,synthetic_class,real_class\n"
                  "heads/SynthA/best_model.ckpt,SynthA,Real\n"
                  "heads/SynthB/best_model.ckpt,SynthB,Real\n", "recipe.csv")
        check([s["step"] for s in seq] == ["submodel_trainer", "submodel_trainer", "model_merger",
                                           "accuracy_study"], f"steps {seq}")
        for s in seq[:2]:
            check(s["argv"][s["argv"].index("--hard-negative-classes") + 1]
                  == ({"SynthA", "SynthB"} - {s["argv"][s["argv"].index("--Class1") + 1]}).pop(),
                  f"hard negatives of {s['argv']}")
            kernels_of(s, False, False)
        studies = {}
        ens = serialization.load_merged(os.path.join(e, "merged.pth"))
        check(ens.class_names == ["SynthA", "SynthB", "Real"] and not ens.shared_backbone
              and ens.trunk is None, f"merged heads {ens.class_names}")
        kernels_of(seq[3], True, False)
        studies["dense"] = per_class_finite(os.path.join(e, "study.json"), ["Real", *classes])

        # 2. the joint ensembles: trunk-shared (K = 1) and shared backbone (K = 0)
        for k, conv_layout in (("1", False), ("0", True)):
            out = os.path.join(root, f"ensemble_k{k}")
            kw = {"per_head_stages": "1"} if k == "1" else {}
            joint = drive(f"train_study_ensemble JOINT=1 PER_HEAD_STAGES={k}",
                          train_study_ensemble.run, root, epochs="1", joint=True, out=out, **kw)
            check([s["step"] for s in joint] == ["ensemble_trainer", "accuracy_study"],
                  f"steps {joint}")
            ens = serialization.load_merged(os.path.join(out, "merged.pth"))
            check(ens.class_names == ["SynthA", "SynthB", "Real"]
                  and ens.shared_backbone == conv_layout
                  and ens.shared_trunk_stages == int(k),
                  f"K = {k} artifact: shared {ens.shared_backbone}, "
                  f"trunk {ens.shared_trunk_stages}")
            kernels_of(joint[0], False, False)
            kernels_of(joint[1], True, conv_layout)
            studies[f"joint_k{k}"] = per_class_finite(os.path.join(out, "study.json"),
                                                      ["Real", *classes])

        # 3. LOGO: SynthA held out, a one-head joint ensemble on SynthB
        logo = drive("generalization_study SynthA", generalization_study.run, root, ["SynthA"],
                     epochs="1")
        check([s["step"] for s in logo] == ["ensemble_trainer", "accuracy_study",
                                            "accuracy_study"], f"steps {logo}")
        check(logo[0]["argv"][logo[0]["argv"].index("--synthetic-classes") + 1:][:2]
              == ["SynthB", "--epochs"], f"LOGO trainer {logo[0]['argv']}")
        kernels_of(logo[0], False, False)
        for s in logo[1:]:
            kernels_of(s, True, True)
        full = per_class_finite(os.path.join(root, "logo_SynthA_full.json"), ["Real", *classes])
        per_class_finite(os.path.join(root, "logo_SynthA_unseen.json"), ["Real", "SynthA"])
        ev = os.path.join(root, "logo_SynthA_eval")
        check(sorted(os.listdir(ev)) == ["Real", "SynthA"]
              and os.readlink(os.path.join(ev, "SynthA"))
              == os.path.join(root, "dataset", "test", "SynthA"), "the unseen tree's links")
        table = generalization_study.summary_table(root, "", ["SynthA"])
        with open(os.path.join(root, "logo_SynthA_unseen.json")) as f:
            unseen = json.load(f)
        row = (f"| SynthA | {full['SynthA']['binary']:.3f} | {full['SynthB']['binary']:.3f} | "
               f"{full['Real']['binary']:.3f} | {unseen['binary_auc']:.3f} | "
               f"{unseen['binary_eer']:.3f} |")
        check(table.splitlines()[2] == row, f"LOGO table {table!r}")

        # 4. its calibration follow-up
        cal = drive("logo_calibration_followup SynthA", logo_calibration_followup.run, root, "",
                    ["SynthA"])
        check([s["step"] for s in cal] == ["calibrate_ensemble", "accuracy_study"],
              f"steps {cal}")
        for s in cal:
            kernels_of(s, True, True)
        cal_table = logo_calibration_followup.summary_table(root, "", ["SynthA"])
        per_class_finite(os.path.join(root, "logo_SynthA_cal_full.json"), ["Real", *classes])

        # 5. SynthA grown back onto its LOGO artifact
        grow = drive("round5_addhead_study SynthA", round5_addhead_study.run, root, cls="SynthA")
        check([s["step"] for s in grow] == ["add_head", "accuracy_study"], f"steps {grow}")
        kernels_of(grow[0], False, False)
        kernels_of(grow[1], True, True)
        grown = serialization.load_merged(os.path.join(root, "logo_SynthA_plusA.ckpt"))
        check(grown.class_names == ["SynthB", "SynthA", "Real"], f"grown {grown.class_names}")
        per_class_finite(os.path.join(root, "logo_SynthA_plusA_full.json"), ["Real", *classes])

        # 6. round 4's A/B of the LOGO artifact, then round 5's calibration split
        ab = drive("round4_campaign ab_arm SynthA", round4_campaign.ab_arm, c4, "SynthA")
        check([s["step"] for s in ab] == ["decision_ab"], f"steps {ab}")
        kernels_of(ab[0], True, True)
        phase2 = drive("round5_phase2 SynthA", round5_phase2.run, root, cls="SynthA")
        check([s["step"] for s in phase2] == ["carve_eval_split", "decision_ab", "decision_ab"],
              f"steps {phase2}")
        kernels_of(phase2[1], True, True)
        check("--from-logits" in phase2[2]["argv"] and not any(phase2[2]["launches"].values()),
              "the offline A/B launched a kernel")
        with np.load(os.path.join(root, "calsplit_trainfit.synth.npz")) as z, \
                np.load(os.path.join(root, "logo_SynthA_decision_ab.json.logits.npz")) as old:
            check(np.array_equal(z["fit_logits"], old["fit_logits"]), "the synthesized cache")

        # 7. round 4's native profile with the mono stem
        prof = drive("round4_campaign stage_decomp_native", round4_campaign.stage_decomp_native,
                     c4)
        kernels_of(prof[0], True, True)
        with open(os.path.join(c4.log, "stage_decomp_native.log")) as f:
            profile_lines = [line for line in f if "ms per 128-window batch" in line]
        check(len(profile_lines) == 2 and all("native (mono stem)" in line
                                              for line in profile_lines),
              f"profile lines {profile_lines}")
    finally:
        os.chdir(cwd)
        campaign.INTERPRETER = interpreter
    phase_s = time.perf_counter() - t_phase
    with open(c4.campaign_log) as f:
        logged = [line for line in f if " rc=" in line]
    check(len(logged) == 2 and all(" rc=0 " in line for line in logged), f"campaign.log {logged}")
    print(f"[campaigns] LOGO table:\n{table.rstrip()}\n[campaigns] calibration follow-up:\n"
          f"{cal_table.rstrip()}", flush=True)
    for line in profile_lines:
        print(f"[campaigns] {line.strip()}")
    launches = {n: sum(s["launches"].get(n, 0) for s in steps) for n in names.values()}
    print(f"[campaigns] {len(steps)} steps in {phase_s:.1f} s, launches {launches} | {smi}",
          flush=True)
    return {"phase_s": phase_s, "k1_launches": launches[names["k1"]],
            "conv_launches": launches[names["conv"]],
            "runs": {label: {"seconds": r["seconds"],
                             "steps": [(s["step"], s["seconds"], s["launches"])
                                       for s in r["steps"]]}
                     for label, r in runs.items()},
            "studies": studies, "logo_table": table, "calibration_table": cal_table}


# ---------------------------------------------------------------------------
# The space-to-depth stage 1 (phase 18)
# ---------------------------------------------------------------------------

TOL_S2D_F32 = 1e-3   # float32 serving logits, s2d against the default pipeline
# the first train step's loss, s2d against none: bf16 autocast rounds each
# activation to 2^-8 relative and the two stage-1 forms round different
# float32 sums; a few such roundings of the loss. s2d_loss_control shows
# that a broken fold lands beyond it.
TOL_S2D_LOSS = 1e-2  # relative
S2D_STEPS = 3        # train steps a run: --epochs 1 on phase 8's 47 files, 16 a step


@contextlib.contextmanager
def stepping(cls):
    """While open, each train step that the trainer class ``cls`` builds
    also records (loss, start event, end event) into the yielded list, CUDA
    events on the current stream around the step's enqueued work."""
    import torch

    seen = []
    orig = cls._build_train_step

    def build(self):
        step = orig(self)

        def timed(state, batch, generator):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            m = step(state, batch, generator)
            b.record()
            seen.append((m["loss"], a, b))
            return m

        return timed

    cls._build_train_step = build
    try:
        yield seen
    finally:
        cls._build_train_step = orig


def s2d_serving(zero_counts, counts, names, ens, windows, stamps, p32, pk, l_f32, l_kernel):
    """Phase 18 (a): InferencePipeline(use_s2d_layer1=True) in float32 and
    bf16 on the 150 windows against the default pipelines of the same
    dtype; the module path alone with the flag on and off on the same bf16
    features; windows/s of the routes in turns. → report fields."""
    import torch

    from synthetic_audio_detection_tpu_torch.ensemble.multihead import (
        _aggregate,
        ensemble_per_head_logits,
        with_dtype,
    )
    from synthetic_audio_detection_tpu_torch.infer.pipeline import InferencePipeline
    from synthetic_audio_detection_tpu_torch.utils.config import (
        AudioConfig,
        InferenceConfig,
        SpectrogramConfig,
    )

    audio = AudioConfig(overlap=0.0, silence_threshold=1e-3)
    spec = SpectrogramConfig.inference(out_size=512)
    n_batches = -(-windows.shape[0] // BATCH)
    s32 = InferencePipeline(ens, audio=audio, spec=spec, infer=InferenceConfig(), device="cuda",
                            use_s2d_layer1=True)
    s16 = InferencePipeline(ens, audio=audio, spec=spec, infer=InferenceConfig(),
                            compute_dtype=torch.bfloat16, device="cuda", use_s2d_layer1=True)
    check(s16.use_s2d_layer1 and not s16.use_fast_backbone and s16.use_kernel,
          "the s2d bf16 pipeline: module path, K1 front end")
    zero_counts()
    l_s16 = s16.logits_for_windows(windows)
    launches = counts()
    check(launches[names["k1"]] == n_batches, f"K1 launches on the s2d route: {launches}")
    check(sum(launches.values()) == n_batches, f"a kernel other than K1 on the s2d route: "
                                               f"{launches}")
    zero_counts()
    l_s32 = s32.logits_for_windows(windows)
    check(sum(counts().values()) == 0, "a kernel launched in the float32 s2d pipeline")
    check(l_s16.shape == l_s32.shape == l_f32.shape and bool(np.isfinite(l_s16).all())
          and bool(np.isfinite(l_s32).all()), "s2d logits")
    d32 = float(np.abs(l_s32 - l_f32).max())
    check(d32 <= TOL_S2D_F32, f"float32 s2d logits {d32} from the default's")

    def labels(pipe, logits):
        return [s["label"] for s in pipe.analyze_windows(windows, stamps,
                                                         logits=logits)["segments"]]

    clear = clear_windows(sigmoid(l_f32))
    lab32, lab_s16 = labels(p32, l_f32), labels(s16, l_s16)
    bad = [i for i in range(len(lab32)) if clear[i] and lab_s16[i] != lab32[i]]
    check(not bad, f"bf16 s2d and float32 verdicts differ on clear windows {bad}")
    gap16 = float(np.abs(l_s16 - l_kernel).max())

    # the module path alone, flag on and off, on the same bf16 features
    ens16 = with_dtype(ens, torch.bfloat16).to("cuda")
    feats = int8_features(windows)
    module = {}
    for flag in (False, True):
        module[flag] = np.concatenate([
            _aggregate(ensemble_per_head_logits(ens16, x, s2d_stage1=flag)).float().cpu().numpy()
            for x in feats.split(BATCH)])[:windows.shape[0]]
    lab_on, lab_off = labels(s16, module[True]), labels(s16, module[False])
    bad_module = [i for i in range(len(lab32)) if clear[i] and lab_on[i] != lab_off[i]]
    check(not bad_module, f"module path, s2d on and off: clear labels differ {bad_module}")
    gap_module = float(np.abs(module[True] - module[False]).max())

    wps = {"bf16 default": [], "bf16 s2d": [], "float32 default": [], "float32 s2d": []}
    for route, pipe in (("bf16 default", pk), ("bf16 s2d", s16), ("bf16 s2d", s16),
                        ("bf16 default", pk), ("float32 default", p32), ("float32 s2d", s32),
                        ("float32 s2d", s32), ("float32 default", p32)):
        wps[route].append(windows_per_s(pipe, windows))
    print(f"[s2d] serving, 150 windows at 512², batch 128: float32 s2d vs default max "
          f"{d32:.4g} (tol {TOL_S2D_F32}); bf16 s2d (module path) vs the bf16 default (fast "
          f"backbone) max {gap16:.4g} mean {float(np.abs(l_s16 - l_kernel).mean()):.4g}; "
          f"{int(clear.sum())}/{int(clear.sum())} clear windows keep the float32 label; "
          f"module path s2d on vs off max {gap_module:.4g} mean "
          f"{float(np.abs(module[True] - module[False]).mean()):.4g}, clear labels equal; "
          f"launches {launches}", flush=True)
    for route, vals in wps.items():
        print(f"[s2d] pipeline {route:15s}: {' / '.join(f'{v:.1f}' for v in vals)} windows/s "
              "(median of 5 each, in turns)", flush=True)
    return {"k1_launches": launches[names["k1"]], "f32_max_diff": d32,
            "bf16_max_gap_to_default": gap16, "module_max_gap": gap_module,
            "clear_windows": int(clear.sum()), "windows_per_s": wps}


def s2d_training(zero_counts, counts, k1_name, work, smi):
    """Phase 18 (b): the submodel trainer CLI on phase 8's tree, bf16 at
    512², one epoch of 3 steps at 32 rows (layer 3 unfreezes at epoch 0),
    with and without --s2d-layer1, with and without the stop-grad
    boundary; each run's steps recorded (``stepping``); then the two
    trainers of a boundary timed in turns on one batch, and with the
    boundary the first-loss bound's control (``s2d_loss_control``). →
    report fields."""
    import torch

    from synthetic_audio_detection_tpu_torch.cli import submodel_trainer
    from synthetic_audio_detection_tpu_torch.data import dataset as ds
    from synthetic_audio_detection_tpu_torch.train.trainer import Trainer

    data = os.path.join(work, "train_data")
    common = ["--data-dir", data, "--Class0", "Real", "--Class1", "SynthA", "--batch-size", "16",
              "--input-size", "512", "--bf16", "--device", "cuda", "--workers", "8",
              "--epochs", "1", "--log-dir", os.path.join(work, "runs_s2d")]
    samples = ds.list_samples(data, "train", ["Real", "SynthA"])
    out = {}
    cwd = os.getcwd()
    os.chdir(work)
    try:
        for boundary in ("stop-grad-boundary", "no-stop-grad-boundary"):
            trainers = {}
            for s2d in (False, True):
                key = f"{'s2d' if s2d else 'plain'} {boundary}"
                argv = common + [f"--{boundary}", "--checkpoint-dir", os.path.join(work, "ck_s2d")]
                if s2d:
                    argv.append("--s2d-layer1")
                zero_counts()
                t0 = time.perf_counter()
                with observing(Trainer) as seen, stepping(Trainer) as steps, \
                        contextlib.redirect_stdout(io.StringIO()):
                    rc = submodel_trainer.main(argv)
                seconds = time.perf_counter() - t0
                launches = counts()
                check(rc == 0, f"trainer CLI ({key}) exit code {rc}")
                tr = trainers[s2d] = seen["trainers"][0]
                check(tr.model.base.s2d_stage1 is s2d, f"{key}: the model's s2d flag")
                check(tr.train_steps_run == S2D_STEPS == len(steps),
                      f"{key}: {tr.train_steps_run} train steps")
                check(launches[k1_name] == S2D_STEPS and sum(launches.values()) == S2D_STEPS,
                      f"{key}: launches {launches}, not one K1 a train step")
                torch.cuda.synchronize()
                losses = [float(m) for m, _, _ in steps]
                check(all(np.isfinite(losses)), f"{key}: losses {losses}")
                out[key] = {"first_loss": losses[0], "losses": losses, "ms": [],
                            "cli_step_ms": [a.elapsed_time(b) for _, a, b in steps],
                            "seconds": seconds, "launches": launches}
                shutil.rmtree(os.path.join(work, "ck_s2d"), ignore_errors=True)
            batch = next(trainers[False]._batches(ds.WaveformBatcher(
                samples[:16], 16, shuffle=False, workers=8), 0, TRAIN_ROWS))
            for s2d in (False, True, True, False):
                tr = trainers[s2d]
                out[f"{'s2d' if s2d else 'plain'} {boundary}"]["ms"].append(median_ms(
                    lambda: tr._train_step(tr.state, batch, tr.generator), n=20, warmup=3))
            if boundary == "stop-grad-boundary":
                out["control"] = s2d_loss_control(trainers[True], batch, work)
            del trainers, tr, seen
            torch.cuda.empty_cache()
    finally:
        os.chdir(cwd)
    for boundary in ("stop-grad-boundary", "no-stop-grad-boundary"):
        a, b = out[f"plain {boundary}"], out[f"s2d {boundary}"]
        for r in (a, b):
            r["rows_per_s"] = [TRAIN_ROWS / ms * 1e3 for ms in r["ms"]]
        rel = abs(b["first_loss"] - a["first_loss"]) / abs(a["first_loss"])
        out[f"loss_rel_diff {boundary}"] = rel
        print(f"[s2d] trainer CLI, bf16 512², {TRAIN_ROWS} rows, --{boundary}: first loss plain "
              f"{a['first_loss']:.6f} s2d {b['first_loss']:.6f} (rel {rel:.3g}, tol "
              f"{TOL_S2D_LOSS}); step plain {' / '.join(f'{t:.3f}' for t in a['ms'])} ms, s2d "
              f"{' / '.join(f'{t:.3f}' for t in b['ms'])} ms (median of 20 after 3, CUDA events, "
              f"in turns; rows/s plain {' / '.join(f'{r:.1f}' for r in a['rows_per_s'])}, s2d "
              f"{' / '.join(f'{r:.1f}' for r in b['rows_per_s'])}); in the CLI "
              f"{' '.join(f'{t:.1f}' for t in a['cli_step_ms'])} / "
              f"{' '.join(f'{t:.1f}' for t in b['cli_step_ms'])} ms; run "
              f"{a['seconds']:.1f} / {b['seconds']:.1f} s | {smi}", flush=True)
        check(rel <= TOL_S2D_LOSS, f"--{boundary}: the s2d first loss off the plain one")
    ctl = out["control"]
    print(f"[s2d] the loss bound's control, one step of fresh trainers on one batch: loss plain "
          f"{ctl['loss']['plain']:.6f}, s2d {ctl['loss']['s2d']:.6f} (rel "
          f"{ctl['rel']['s2d']:.3g}), broken fold {ctl['loss']['broken fold']:.6f} (rel "
          f"{ctl['rel']['broken fold']:.3g}); tol {TOL_S2D_LOSS}", flush=True)
    check(ctl["rel"]["s2d"] <= TOL_S2D_LOSS, "the control's s2d loss off the plain one")
    check(ctl["rel"]["broken fold"] > TOL_S2D_LOSS,
          "the loss bound does not tell a broken fold from the s2d stage")
    return out


def s2d_loss_control(tr, batch, work):
    """The first-loss bound's control: fresh trainers from ``tr``'s
    configuration (the s2d CLI run's, so the same seed, initial weights and
    augmentation draws) take one step on ``batch``: plain, s2d, and s2d
    with a broken fold (each folded kernel built from the H-mirrored
    kernel, a conv the s2d stage must not compute). → {"loss": ..., "rel":
    each loss's relative distance to the plain one}."""
    import dataclasses

    from synthetic_audio_detection_tpu_torch.ops import space_to_depth as s2d
    from synthetic_audio_detection_tpu_torch.train.trainer import Trainer

    fold = s2d.fold_conv3x3_s2d_h
    loss = {}
    for key, flag, patched in (("plain", False, fold), ("s2d", True, fold),
                               ("broken fold", True, lambda w: fold(w.flip(2)))):
        fresh = Trainer(dataclasses.replace(tr.cfg, s2d_stage1=flag), model_name=tr.model_name,
                        spec_cfg=tr.spec_cfg, augment=tr.augment, class_names=tr.class_names,
                        log_dir=os.path.join(work, "runs_s2d_control"), device="cuda")
        s2d.fold_conv3x3_s2d_h = patched
        try:
            loss[key] = float(fresh._train_step(fresh.state, batch, fresh.generator)["loss"])
        finally:
            s2d.fold_conv3x3_s2d_h = fold
        del fresh
    return {"loss": loss, "rel": {k: abs(loss[k] - loss["plain"]) / abs(loss["plain"])
                                  for k in ("s2d", "broken fold")}}


def drive_s2d(zero_counts, counts, names, work, ens, windows, stamps, p32, pk, l_f32, l_kernel,
              smi):
    """Phase 18: the space-to-depth stage 1, serving and training
    (s2d_serving, s2d_training)."""
    import torch

    t0 = time.perf_counter()
    serving = s2d_serving(zero_counts, counts, names, ens, windows, stamps, p32, pk, l_f32,
                          l_kernel)
    torch.cuda.empty_cache()
    training = s2d_training(zero_counts, counts, names["k1"], work, smi)
    return {"serving": serving, "training": training,
            "k1_launches": serving["k1_launches"] + sum(
                v["launches"][names["k1"]] for k, v in training.items()
                if isinstance(v, dict) and "launches" in v),
            "phase_s": time.perf_counter() - t0}


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
        cuda_stem,
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
    sources = [k1.name, k2.name, cuda_conv.LIBRARY, cuda_probes.LIBRARY, cuda_stem.LIBRARY]
    build.build(sources)
    print(f"[build] {len(sources)} source(s) in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in sources:
        for line in build.build_log(name).splitlines():
            if any(k in line for k in ("registers", "spill", "warning", "Compiling entry")):
                print(f"[build] {name}: {line.strip()}")

    # 3. kernels against their plain versions
    k1_report = check_k1(k1, SpectrogramConfig.inference())
    k1_train = check_k1_train(k1, smi)
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
        probs = sigmoid(p32.logits_for_windows(windows))
        clear = clear_windows(probs)
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
        stem_before = cuda_stem.KERNEL.launches
        l_kernel = pk.logits_for_windows(windows)
        path_launches = counts()
        stem_launches = cuda_stem.KERNEL.launches - stem_before
        n_batches = -(-windows.shape[0] // BATCH)
        print(f"[conv] launches on the conv path, {windows.shape[0]} windows in {n_batches} "
              f"batches: {path_launches}", flush=True)
        check(path_launches[conv.name] == CONV_LAUNCHES_PER_BATCH * n_batches,
              f"conv kernel launches {path_launches[conv.name]} != "
              f"{CONV_LAUNCHES_PER_BATCH} per batch × {n_batches}")
        check(path_launches[k1.name] == n_batches, "K1 launches on the conv path")
        check(stem_launches == n_batches, f"stem kernel launches {stem_launches} != one per "
                                          f"batch × {n_batches}")
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

        # 8. the training path
        t0 = time.perf_counter()
        train = drive_trainer(zero_counts, counts, k1.name, work)
        train["step"] = time_train_step(work, smi)
        train["f32_vs_cpu"] = check_float32_step_cuda_vs_cpu()
        print(f"[train] phase took {time.perf_counter() - t0:.1f} s | {smi}", flush=True)

        # 9. trunk-shared serving
        t0 = time.perf_counter()
        trunk = drive_trunk_serving(zero_counts, counts, sds, work,
                                    os.path.join(work, "10min.wav"), 150, k1.name)
        print(f"[trunk] phase took {time.perf_counter() - t0:.1f} s", flush=True)

        # 10. the ensemble-building path
        t0 = time.perf_counter()
        ensemble = drive_ensemble(zero_counts, counts, {"k1": k1.name, "conv": conv.name}, work,
                                  os.path.join(work, "10min.wav"), 150, smi)
        print(f"[ensemble] phase took {time.perf_counter() - t0:.1f} s | {smi}", flush=True)

        # 11. the serving daemon
        t0 = time.perf_counter()
        daemon = drive_daemon(zero_counts, counts, {"k1": k1.name, "conv": conv.name},
                              paths["shared"], work, results[("shared", "20s", "bf16")], p32, smi)
        print(f"[daemon] phase took {time.perf_counter() - t0:.1f} s | {smi}", flush=True)

        # 12. the legacy path
        t0 = time.perf_counter()
        legacy = drive_legacy(zero_counts, counts, work, smi)
        print(f"[legacy] phase took {time.perf_counter() - t0:.1f} s | {smi}", flush=True)

        # 13. the release path
        t0 = time.perf_counter()
        release = drive_release(
            zero_counts, counts, {"k1": k1.name, "conv": conv.name, "holdout": NEW_CLASS,
                                  "classes": ENSEMBLE_CLASSES + ["Real"]},
            work, {**ensemble.pop("paths"), "shared": paths["shared"]},
            os.path.join(work, "20s.wav"), windows, smi)
        print(f"[release] phase took {time.perf_counter() - t0:.1f} s | {smi}", flush=True)

        # 14. the data-preparation path
        t0 = time.perf_counter()
        data = drive_data(zero_counts, counts, {"k1": k1.name, "conv": conv.name}, work)
        data["phase_s"] = time.perf_counter() - t0
        print(f"[data] phase took {data['phase_s']:.1f} s | {smi}", flush=True)

        # 15. torch.distributed on one card
        t0 = time.perf_counter()
        parallel = drive_parallel(zero_counts, counts, {"k1": k1.name, "conv": conv.name}, work,
                                  paths["shared"], windows, smi)
        print(f"[parallel] phase took {time.perf_counter() - t0:.1f} s | {smi}", flush=True)

        # 16. the int8 backbone
        t0 = time.perf_counter()
        int8 = drive_int8(paths["shared"], windows, l_f32, p32, smi)
        print(f"[int8] phase took {time.perf_counter() - t0:.1f} s | {smi}", flush=True)

        # 17. the study campaigns on phase 14's prepared tree
        campaigns = drive_campaigns({"k1": k1.name, "conv": conv.name}, work, smi)
        print(f"[campaigns] phase took {campaigns['phase_s']:.1f} s | {smi}", flush=True)

        # 18. the space-to-depth stage 1
        s2d = drive_s2d(zero_counts, counts, {"k1": k1.name, "conv": conv.name}, work,
                        ckpts["shared"], windows, stamps, p32, pk, l_f32, l_kernel, smi)
        print(f"[s2d] phase took {s2d['phase_s']:.1f} s | {smi}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # 19. report
    z = k1_report[True]
    k1_bound, k1_by = k1_report["bound"]
    report = [{
        "name": "K1 melspec_factored",
        "route": "cuda",
        "source": cuda_melspec.SOURCE,
        "replaces": cuda_melspec.REPLACES,
        "launches": (sum(c[k1.name] for c in cli_launches.values()) + train["k1_launches"]
                     + sum(t["launches"][k1.name] for t in trunk.values())
                     + ensemble["k1_launches"] + daemon["k1_launches"]
                     + release["k1_launches"] + data["k1_launches"]
                     + parallel["k1_launches"] + campaigns["k1_launches"]
                     + s2d["k1_launches"]),
        "serving_launches": sum(c[k1.name] for c in cli_launches.values()),
        "train_launches": train["k1_launches"],
        "ensemble_launches": ensemble["k1_launches"],
        "daemon_launches": daemon["k1_launches"],
        "release_launches": release["k1_launches"],
        "data_launches": data["k1_launches"],
        "parallel_launches": parallel["k1_launches"],
        "campaign_launches": campaigns["k1_launches"],
        "s2d_launches": s2d["k1_launches"],
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
        "train_config": {
            "what": f"SpectrogramConfig.train() (mel_norm None), dB only, [{TRAIN_ROWS}, 128000]",
            "max_abs_err_db": k1_train["errs"],
            "tol_db": TOL_DB,
            "ms": k1_train["ms"],
            "ms_int16_in": k1_train["ms_int16"],
            "plain_ms": k1_train["plain_ms"],
            "bound_ms": k1_train["bound"][0],
            "bound_by": k1_train["bound"][1],
        },
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
    conv_launches = (path_launches[conv.name] + ensemble["conv_launches"]
                     + daemon["conv_launches"] + release["conv_launches"]
                     + data["conv_launches"] + parallel["conv_launches"]
                     + campaigns["conv_launches"])
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
        "conv_path_launches": path_launches[conv.name],
        "ensemble_launches": ensemble["conv_launches"],
        "daemon_launches": daemon["conv_launches"],
        "release_launches": release["conv_launches"],
        "data_launches": data["conv_launches"],
        "parallel_launches": parallel["conv_launches"],
        "campaign_launches": campaigns["conv_launches"],
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
        "shapes": conv_rows,
    })
    report.append({
        "name": "stem stem_pool",
        "route": "cuda",
        "source": cuda_stem.SOURCE,
        "replaces": "no TPU kernel: the reference's lax.conv + reduce_window stem "
                    "(synthetic_audio_detection_tpu/models/fast_resnet.py:151, :153)",
        "entry": "cuda_stem.stem_pool (FastResNet.stem_pool at knob > 0)",
        "kernel": f"{cuda_stem.LIBRARY}: wgmma with A from registers, conv tile and max-pool "
                  "in shared memory",
        "conv_path_launches": stem_launches,
        "max_abs_err": stem["max_abs_err"],
        "not_equal": stem["not_equal"],
        "tol": "|kernel − plain| ≤ 2^-7·|plain| + 1e-5 (one bf16 ulp), at most 0.1% of the "
               "outputs not bit-equal",
        "per": f"one call at [{BATCH}, 3, 512, 512], one plane as a broadcast view",
        "ms": stem["ms"],
        "three_channels_ms": stem["three_channels_ms"],
        "plain_ms": stem["plain_ms"],
        "bound_ms": stem["bound_ms"],
        "bound_by": stem["bound_by"],
        "gflop": stem["gflop"],
        "mb": stem["mb"],
        "library_ms": stem["library_ms"],
        "library": "cuDNN on BN folded into the bf16 weight and bias, ReLU, max-pool",
        "ptxas": stem["ptxas"],
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
    print(json.dumps({"train_step": {"ms": train["step"][1]["ms"],
                                     "rows_per_s": train["step"][1]["rows_per_s"],
                                     "peak_gib": train["step"][1]["peak_gib"],
                                     "phase2": train["step"][2],
                                     "what": f"bf16, ResNet-18, 512², {TRAIN_ROWS} rows, phase 1",
                                     "f32_vs_cpu": train["f32_vs_cpu"],
                                     "cli_seconds": train["seconds"]},
                      "trunk_serving": trunk,
                      "ensemble": {"steps": ensemble["steps"],
                                   "what": f"bf16, ResNet-18, 512², {TRAIN_ROWS} rows, phase 1",
                                   "joint_cli": ensemble["joint"], "add_head_cli": ensemble[
                                       "add_head"], "serving": ensemble["serving"]},
                      "daemon": daemon, "legacy": legacy, "release": release,
                      "data": data, "parallel": parallel, "int8": int8,
                      "campaigns": campaigns,
                      "s2d": {k: v for k, v in s2d.items() if k != "k1_launches"}}))
    print(json.dumps({"kernels": report}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
