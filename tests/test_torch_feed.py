"""The serving feed's staging ring (``infer/feed.py``) under
``InferencePipeline``: logits bit-equal to a batch-at-a-time feed that pads
each tail with a host zero block, no stale slot rows, zero padding rows,
the slots' reuse, the lookahead's hold on yielded batches and one dispatch
at a time. CPU: ResNet-18 at 64², three heads on one shared backbone, 1-s
windows, buckets 8 and 16, float32 and int16 transport. On the card
(``cuda``): the bench's two layouts at 512² bf16 on the default route.

Imports neither JAX nor the test suite's conftest, so the card tests run
where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_feed.py -m cuda
"""

import contextlib

import numpy as np
import pytest
import torch

from synthetic_audio_detection_tpu_torch.audio import wavio
from synthetic_audio_detection_tpu_torch.ensemble.multihead import build_ensemble
from synthetic_audio_detection_tpu_torch.infer.pipeline import InferencePipeline, forward_windows
from synthetic_audio_detection_tpu_torch.models.classifier import BinaryClassifier
from synthetic_audio_detection_tpu_torch.ops.precision import exact_float32
from synthetic_audio_detection_tpu_torch.utils import profiling
from synthetic_audio_detection_tpu_torch.utils.config import (
    AudioConfig,
    InferenceConfig,
    SpectrogramConfig,
)

SEED = 2**31 + 11
CLIPS = (1, 8, 9, 16, 17, 33)  # bucket 8 full and not; bucket 16 one tail, full, 1- and 2-batch tails
TRANSPORTS = ("float32", "int16")


def state_dicts(heads: int, shared: bool, seed: int):
    """``heads`` ResNet-18 classifiers' weights, one backbone for all when
    ``shared``."""
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        base = {k: v for k, v in BinaryClassifier("resnet18").state_dict().items()
                if k.startswith("base.")}
        sds = []
        for _ in range(heads):
            sd = BinaryClassifier("resnet18").state_dict()
            sds.append({**sd, **base} if shared else sd)
    return sds


def reference_logits(pipe: InferencePipeline, windows: np.ndarray) -> np.ndarray:
    """The feed as it was, batch at a time: slice, int16 quantize, the
    tail padded with a host zero block by ``np.concatenate``, the batch
    copied to the device, ``forward_windows``, the logits read back."""
    num, T = windows.shape
    bucket = pipe._bucket(num)
    out = []
    for i in range(0, num, bucket):
        batch = windows[i:i + bucket]
        take = batch.shape[0]
        if pipe.transport_dtype == "int16":
            batch = wavio.pcm16_quantize(batch)
        if take < bucket:
            batch = np.concatenate([batch, np.zeros((bucket - take, T), batch.dtype)])
        x = torch.from_numpy(np.ascontiguousarray(batch)).to(pipe.device)
        exact = pipe.compute_dtype == torch.float32
        with exact_float32() if exact else contextlib.nullcontext():
            agg = forward_windows(pipe.ensemble, x, pipe.spec, pipe.audio.sample_rate,
                                  use_kernel=pipe.use_kernel,
                                  use_fast_backbone=pipe.use_fast_backbone,
                                  conv3x3_max_channels=pipe.conv3x3_max_channels)
        out.append(agg[:take].float().cpu().numpy())
    return np.concatenate(out, axis=0)


def noise(n: int, samples: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, samples)) * 0.1).astype(np.float32)


# -- CPU ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    """transport → a pipeline on the CPU; the clips' windows; and each
    clip's reference logits by transport."""
    ens = build_ensemble(state_dicts(3, True, SEED), ["SynA", "SynB", "SynC", "Real"])
    audio = AudioConfig(window_seconds=1.0, overlap=0.0)
    pipes = {t: InferencePipeline(ens, audio=audio, spec=SpectrogramConfig.inference(out_size=64),
                                  infer=InferenceConfig(batch_size=16), device="cpu",
                                  transport_dtype=t) for t in TRANSPORTS}
    clips = {n: noise(n, audio.window_samples, SEED + n) for n in CLIPS + (3,)}
    refs = {t: {n: reference_logits(p, w) for n, w in clips.items()} for t, p in pipes.items()}
    return pipes, clips, refs


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("n", CLIPS)
def test_logits_equal_the_batch_at_a_time_feed(served, transport, n):
    pipes, clips, refs = served
    got = pipes[transport].logits_for_windows(clips[n])
    assert got.shape == (n, 4) and np.array_equal(got, refs[transport][n])
    logits, per_head = pipes[transport].logits_and_per_head(clips[n])
    assert np.array_equal(logits, refs[transport][n]) and per_head.shape == (n, 3, 2)


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_no_stale_slot_rows_leak_into_the_next_clip(served, transport):
    """33 windows fill both bucket-16 slots; a 3-window clip (bucket 8)
    and a 9-window clip (bucket 16, 7 padding rows) right after each get
    the logits they get alone."""
    pipes, clips, refs = served
    for n in (33, 3, 9):
        assert np.array_equal(pipes[transport].logits_for_windows(clips[n]), refs[transport][n]), n


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_padding_rows_are_zero_on_the_device(served, transport):
    pipes, clips, _ = served
    pipe = pipes[transport]
    pipe.logits_for_windows(clips[33])  # both bucket-16 slots hold full batches
    batches = list(pipe._bucketed_batches(clips[9]))
    assert len(batches) == 1
    batch, take = batches[0]
    assert take == 9 and batch.shape == (16, clips[9].shape[1])
    want = clips[9] if transport == "float32" else wavio.pcm16_quantize(clips[9])
    assert np.array_equal(batch[:9].numpy(), want)
    assert batch.dtype == (torch.float32 if transport == "float32" else torch.int16)
    assert not batch[9:].any()


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_a_yielded_batch_is_intact_until_the_generator_resumes_twice(served, transport):
    """Batch 0 of a 33-window clip holds its rows while batch 1 is staged;
    batch 2 takes batch 0's slot."""
    pipes, clips, _ = served
    with contextlib.closing(pipes[transport]._bucketed_batches(clips[33])) as batches:
        b0, _ = next(batches)
        kept = b0.clone()
        b1, _ = next(batches)
        assert torch.equal(b0, kept) and b1.data_ptr() != b0.data_ptr()
        b2, take = next(batches)
        assert take == 1 and b2.data_ptr() == b0.data_ptr() and not b2[1:].any()
        assert next(batches, None) is None


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_one_dispatch_at_a_time(served, transport, monkeypatch):
    """A second dispatch while one is open raises; closing the first, or a
    forward that raises, frees the pipeline for the next."""
    pipes, clips, refs = served
    pipe = pipes[transport]
    with contextlib.closing(pipe._bucketed_batches(clips[17])) as open_one:
        next(open_one)
        with pytest.raises(RuntimeError, match="one at a time"):
            pipe.logits_for_windows(clips[8])
        with pytest.raises(RuntimeError, match="one at a time"):
            next(pipe._bucketed_batches(clips[8]))
    assert np.array_equal(pipe.logits_for_windows(clips[8]), refs[transport][8])

    def broken(batch, *a, **k):
        raise ValueError("broken forward")

    monkeypatch.setattr(pipe, "_forward", broken)
    with pytest.raises(ValueError, match="broken forward"):
        pipe.logits_for_windows(clips[17])
    monkeypatch.undo()
    assert np.array_equal(pipe.logits_for_windows(clips[17]), refs[transport][17])


def test_prefetched_batches_count_every_batch_after_a_dispatchs_first(served):
    pipes, clips, _ = served
    profiling.reset_counters()
    for n in (1, 16, 17, 33):
        pipes["float32"].logits_for_windows(clips[n])
    counts = profiling.counters()
    profiling.reset_counters()
    assert counts["serve.batches"] == 1 + 1 + 2 + 3
    assert counts["serve.prefetched_batches"] == 0 + 0 + 1 + 2


# -- on the card ------------------------------------------------------------------

def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _stream_ids(prof, names):
    """The CUDA streams of the device events whose names hold one of
    ``names``."""
    cuda = torch.autograd.DeviceType.CUDA
    return {e.device_resource_id() for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda and any(n in e.name() for n in names)}


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False], ids=["shared6", "dense6"])
def test_card_feed_is_pinned_side_streamed_and_bit_equal(shared):
    """Six heads on one or six ResNet-18s at 512² bf16 on the default route
    (the log-mel kernel, and for the shared layout the fast backbone with
    the conv kernel), 4-s windows, buckets of 128: clips of 75, 128 and
    200 windows give the batch-at-a-time feed's logits bit for bit, from
    pinned slots, with the copies on a stream of their own, and 0, 0 and
    1 prefetched batches."""
    from torch.profiler import ProfilerActivity, profile

    _cuda_or_skip()
    names = [f"Syn{i}" for i in range(1, 7)] + ["Real"]
    ens = build_ensemble(state_dicts(6, shared, SEED), names)
    pipe = InferencePipeline(ens, infer=InferenceConfig(batch_size=128),
                             compute_dtype=torch.bfloat16, device="cuda")
    assert pipe.use_kernel and pipe.use_fast_backbone == shared
    T = pipe.audio.window_samples
    for n in (75, 128, 200):
        windows = noise(n, T, SEED + n)
        want = reference_logits(pipe, windows)
        profiling.reset_counters()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            got = pipe.logits_for_windows(windows)
            torch.cuda.synchronize()
        counts = profiling.counters()
        assert np.array_equal(got, want), n
        assert counts.get("serve.prefetched_batches", 0) == {75: 0, 128: 0, 200: 1}[n]
        copies = _stream_ids(prof, ["Memcpy HtoD (Pinned"])
        kernels = _stream_ids(prof, ["dft_mel_kernel"])
        assert copies and kernels and not copies & kernels, (copies, kernels)
    slots = [s for pair in pipe._feed._slots.values() for s in pair]
    assert slots and all(s.host.is_pinned() and s.device.is_cuda for s in slots)
    assert pipe._feed.stream != torch.cuda.current_stream()
    profiling.reset_counters()
