"""The port's spans and counters (``utils/profiling.py``): the ``serve.*``
ranges of ``infer/pipeline.py`` nested per request and batch, the serving
counters and the profile tool's reading of them, the ``train_step.*``
ranges of the train steps and of ``trainer.device_batches`` (none open
across a yield), and the profile tools' arithmetic on the ranges. CPU,
ResNet-18 at 64²."""

import contextlib
import types

import numpy as np
import pytest
import torch
from torch.profiler import profile, record_function

from synthetic_audio_detection_tpu_torch.ensemble.multihead import build_ensemble
from synthetic_audio_detection_tpu_torch.infer.pipeline import InferencePipeline
from synthetic_audio_detection_tpu_torch.models.classifier import BinaryClassifier
from synthetic_audio_detection_tpu_torch.tools import profile_serving, profile_train
from synthetic_audio_detection_tpu_torch.train import joint
from synthetic_audio_detection_tpu_torch.train import steps as TS
from synthetic_audio_detection_tpu_torch.train.trainer import device_batches
from synthetic_audio_detection_tpu_torch.utils import profiling
from synthetic_audio_detection_tpu_torch.utils.config import (
    AudioConfig,
    InferenceConfig,
    SpecAugmentConfig,
    SpectrogramConfig,
    TrainConfig,
)

SEED = 2**31 + 5
CLIPS = (5, 16, 19)  # windows: bucket 8 padded; one full 16; a full 16 and a padded tail
SERVE = ("serve.request", "serve.pad", "serve.forward", "serve.frontend", "serve.backbone",
         "serve.d2h", "serve.decide")
TRAIN = ("train_step.feed", "train_step.features", "train_step.forward", "train_step.backward",
         "train_step.optimizer")


def ranges(prof, names):
    """name → [(start, end, thread)] of the host ranges, by start."""
    out = {n: [] for n in names}
    for e in prof.events():
        if e.name in out and e.device_type == torch.autograd.DeviceType.CPU:
            out[e.name].append((e.time_range.start, e.time_range.end, e.thread))
    return {n: sorted(v) for n, v in out.items()}


def inside(a, b) -> bool:
    return b[0] <= a[0] and a[1] <= b[1] and a[2] == b[2]


# -- the helpers --------------------------------------------------------------

@pytest.mark.parametrize("all_threads", [False, True], ids=["this-thread", "all-threads"])
def test_span_is_the_shared_null_context_without_a_profiler(all_threads):
    """Off: one shared null context. On: a range in the trace, also under a
    profiler that records every thread."""
    off = profiling.span("serve.pad")
    assert off is profiling.span("train_step.feed") and isinstance(off, contextlib.nullcontext)
    assert profiling.annotate is profiling.span
    extra = ({"experimental_config": torch._C._profiler._ExperimentalConfig(
        profile_all_threads=True)} if all_threads else {})
    with profile(**extra) as prof:
        on = profiling.span("serve.pad")
        assert on is not off
        with on:
            torch.ones(2).sum()
    assert len(ranges(prof, ["serve.pad"])["serve.pad"]) == 1
    assert profiling.span("serve.pad") is off


def test_counters_add_and_are_copied_and_reset():
    profiling.reset_counters()
    profiling.count("serve.batches")
    profiling.count("serve.rows", 16)
    profiling.count("serve.rows", 8)
    snap = profiling.counters()
    assert snap == {"serve.batches": 1, "serve.rows": 24}
    snap["serve.rows"] = 0
    assert profiling.counters()["serve.rows"] == 24
    profiling.reset_counters()
    assert profiling.counters() == {}


# -- serving ------------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    """Three heads on one shared ResNet-18 at 64², 1-s windows, buckets of
    8 and 16, int16 transport, on the CPU, and three clips of seeded noise
    windows with their stamps."""
    with torch.random.fork_rng():
        torch.manual_seed(SEED)
        base = {k: v for k, v in BinaryClassifier("resnet18").state_dict().items()
                if k.startswith("base.")}
        sds = [{**base, **{k: v for k, v in BinaryClassifier("resnet18").state_dict().items()
                           if k.startswith("head.")}} for _ in range(3)]
    audio = AudioConfig(window_seconds=1.0, overlap=0.0)
    pipe = InferencePipeline(build_ensemble(sds, ["SynA", "SynB", "SynC", "Real"]), audio=audio,
                             spec=SpectrogramConfig.inference(out_size=64),
                             infer=InferenceConfig(batch_size=16), device="cpu",
                             transport_dtype="int16")
    rng = np.random.default_rng(SEED)
    clips = [((rng.standard_normal((n, audio.window_samples)) * 0.1).astype(np.float32),
              [(float(i), float(i + 1)) for i in range(n)]) for n in CLIPS]
    return pipe, clips


def test_serving_spans_nest_per_request_and_batch(served):
    pipe, clips = served
    with profile() as prof:
        for windows, stamps in clips:
            pipe.analyze_windows(windows, stamps)
    r = ranges(prof, SERVE)
    batches = sum(-(-n // 16) for n in CLIPS)
    assert {n: len(v) for n, v in r.items()} == {
        "serve.request": 3, "serve.decide": 3, **{n: batches for n in SERVE[1:6]}}
    for n in ("serve.pad", "serve.forward", "serve.d2h", "serve.decide"):
        assert all(any(inside(a, b) for b in r["serve.request"]) for a in r[n]), n
    for n in ("serve.frontend", "serve.backbone"):
        assert all(any(inside(a, b) for b in r["serve.forward"]) for a in r[n]), n
    # one batch after another: the generator's span closes before the
    # consumer's forward opens, and the read-back follows the forward
    for pad, fwd, d2h in zip(*(r[n] for n in ("serve.pad", "serve.forward", "serve.d2h"))):
        assert pad[1] <= fwd[0] and fwd[1] <= d2h[0]
    for i, decide in enumerate(r["serve.decide"]):
        assert all(d2h[1] <= decide[0] for d2h in r["serve.d2h"] if d2h[0] < decide[0])
        assert i == 0 or r["serve.decide"][i - 1][1] <= decide[0]


def test_serving_counters_count_the_device_batches_and_their_rows(served):
    """Per device batch: one batch, the bucket's rows and the clip's windows
    in it; the profile tool reads batches, rows a batch and the share that
    are windows from them."""
    pipe, clips = served
    profiling.reset_counters()
    for windows, stamps in clips:
        pipe.analyze_windows(windows, stamps)
    counts = profiling.counters()
    assert counts == {"serve.batches": 4, "serve.rows": 8 + 16 + 16 + 16,
                      "serve.useful_rows": sum(CLIPS)}
    assert profile_serving.feed_counts(counts) == pytest.approx(
        {"device_batches": 4, "rows_per_device_batch": 14.0,
         "useful_row_share": 100.0 * sum(CLIPS) / 56})


@pytest.mark.parametrize("counts", [{}, {"serve.rows": 0}, {"serve.batches": 0}],
                         ids=["empty", "rows-only", "no-batches"])
def test_profile_serving_reads_no_feed_without_a_device_batch(counts):
    """A route that runs no pipeline (the front end alone) counts no batch,
    and the tool prints no feed line for it."""
    assert profile_serving.feed_counts(counts) == {}


# -- training -----------------------------------------------------------------

class _Batcher:
    """An epoch of 4-row int16 batches out of ``pool``, as the port's
    batchers hand them to ``device_batches``."""

    def __init__(self, pool: np.ndarray):
        self.pool = pool

    def epoch(self, epoch, rows=None):
        for i in range(0, len(self.pool), 4):
            yield {"audio": self.pool[i:i + 4], "label": np.arange(4, dtype=np.int32) % 2}


def _single(cfg):
    state = TS.create_train_state(BinaryClassifier("resnet18"), cfg)
    return state, TS.make_train_step(cfg, SpectrogramConfig(out_size=64),
                                     SpecAugmentConfig(enabled=False))


def _joint(cfg):
    state = joint.init_joint_state("resnet18", 2, torch.Generator().manual_seed(0), cfg)
    return state, joint.make_joint_train_step(cfg, SpectrogramConfig(out_size=64),
                                              SpecAugmentConfig(enabled=False), num_heads=2)


@pytest.mark.parametrize("build", [_single, _joint], ids=["submodel", "joint"])
def test_train_step_ranges_and_the_feed_close_before_each_yield(build):
    """Two steps fed by ``device_batches`` over an in-memory batcher (int16
    transport): per step the feed, features, forward, backward and
    optimizer ranges, one after another on the stepping thread; the
    consumer's own range between two pulls lies in no feed range; the last
    pull, which finds the epoch's end, has a feed range too."""
    cfg = TrainConfig(batch_size=2)
    state, step = build(cfg)
    rng = np.random.default_rng(SEED)
    batcher = _Batcher(np.round(rng.standard_normal((8, 32_000)) * 3000).astype(np.int16))
    with profile() as prof:
        for batch in device_batches(batcher, 0, 4, "int16", torch.device("cpu")):
            with record_function("consumer"):
                step(state, batch, torch.Generator().manual_seed(1))
    r = ranges(prof, TRAIN + ("consumer",))
    assert [len(r[n]) for n in TRAIN] == [3, 2, 2, 2, 2]
    feeds = r["train_step.feed"]
    assert not any(inside(c, f) or inside(f, c) for c in r["consumer"] for f in feeds)
    for i in range(2):
        parts = [r[n][i] for n in TRAIN]
        assert all(a[1] <= b[0] and a[2] == b[2] for a, b in zip(parts, parts[1:]))
        assert all(inside(p, r["consumer"][i]) for p in parts[1:])


# -- the profile tools ----------------------------------------------------------

def _host(name, thread, kernels, children=()):
    kern = [types.SimpleNamespace(name=k, duration=d) for k, d in kernels]
    return types.SimpleNamespace(name=name, thread=thread, kernels=kern,
                                 cpu_children=list(children))


def test_profile_tools_count_a_ranges_kernels_without_its_device_annotation():
    conv = _host("aten::conv2d", 1, [("implicit_convolve_sgemm", 30.0)])
    cast = _host("aten::to", 1, [("elementwise_kernel", 2.0)])
    rng = _host("serve.forward", 1, [("serve.forward", 40.0)], [conv, cast])
    assert profile_serving.own_kernel_us(rng) == 0.0
    assert profile_serving.kernel_us(rng) == 32.0
    assert profile_serving.kernel_us(_host("x", 1, [("train_step.backward", 5.0)])) == 0.0
    # the tool runs one device batch and no feed: the step's four ranges
    assert profile_train.RANGES == TRAIN[1:]
