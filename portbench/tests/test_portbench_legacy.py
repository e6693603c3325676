"""The legacy cell's pieces: the bottleneck work count against published
figures, the bottleneck reference's tensors against the port's ResNet-152,
the serving cells' per-layer metrics on the legacy driver's context, the
calibrated weights' varied tracks, and the planted faults that the legacy
check has to catch at the small size."""

import pytest

from portbench import run, trace
from portbench.reference import resnet_bottleneck_v1_5
from portbench.tests import small
from portbench.work import model, peaks, resnet_bottleneck_v1_5 as rb

CELL = "r152-legacy5.bulk"


@pytest.mark.parametrize("stages,gmac", [((3, 4, 6, 3), 4.09), ((3, 4, 23, 3), 7.80),
                                         ((3, 8, 36, 3), 11.51)])
def test_bottleneck_count_at_224_is_the_published_one(stages, gmac):
    """torchvision's ResNet-50/101/152 v1.5 figures count three stem planes;
    the count has one, so the two left out (0.079 GMAC) are added."""
    convs = rb.resnet_convs(224, 224, stages)
    macs = sum(c.work(1).ops_bf16 for c in convs) / 2 + convs[0].work(1).ops_bf16
    assert macs / 1e9 == pytest.approx(gmac, rel=0.01)


def test_resnet152_at_512_counts_float32_bytes_and_tensor_core_products():
    w = rb.backbone_work(1, 512, 512)
    assert w.ops_bf16 / 2e9 == pytest.approx(59.73, abs=0.01)
    one = sum(c.work(1).ops_bf16 for c in rb.resnet_convs(512, 512) if c.k == 1)
    assert one / w.ops_bf16 == pytest.approx(0.49, abs=0.005)
    c = rb.resnet_convs(512, 512)[1]  # layer1.0.conv1: 64 → 64 at 128², float32
    assert c.work(1).bytes == 4 * (128 * 128 * 64 * 2 + 64 * 64 + 2 * 64)


def test_bottleneck_shapes_are_the_ports_resnet152():
    from synthetic_audio_detection_tpu_torch.models.resnet import create_resnet

    cfg = run.cell_files(CELL)["config"]
    want = {k: tuple(v.shape) for k, v in create_resnet("resnet152").state_dict().items()
            if not k.endswith("num_batches_tracked")}
    got = resnet_bottleneck_v1_5.shapes(cfg["model"])
    assert dict(got) == want and len(got) == len(want)
    assert model.block(cfg) is rb


def test_the_serving_metrics_read_the_legacy_drivers_context():
    """The six serving metrics the cell lists read the legacy driver's
    ``rows`` (one entry a forward, padding included) and ``forwards`` as
    they read the Probe's: a full batch of 256 and a tail padded to 248."""
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    names = [m["name"] for m in run.metrics_of(bench, CELL, True)]
    assert names == ["useful_row_share", "h2d_ms_per_batch", "frontend_roofline_share",
                     "backbone_roofline_share", "mfu.serve", "idle_share.serve"]
    cfg = run.cell_files(CELL)["config"]
    s = trace.TraceSummary(window_s=2.0, busy_s=1.8, h2d_s=0.04, unattributed_s=0.0,
                           span_device_s={"portbench.frontend": 0.01, "portbench.backbone": 1.5},
                           device_by_name={}, gap_by_host={})
    ctx = {"cfg": cfg, "trace": s, "setup_s": 3.0,
           "run": {"window_s": 2.0, "useful_windows": 500},
           "untraced": {"window_s": 2.5, "useful_windows": 600},
           "port": {"rows": [256, 248], "forwards": 2}}
    read = lambda name: run.metric_module(name).read(ctx)  # noqa: E731
    per_batch = [(model.backbone_work(cfg, r) + model.heads_work(cfg, r)).bound()[0]
                 for r in (256, 248)]
    assert model.backbones_run(cfg) == 1
    assert read("backbone_roofline_share") == pytest.approx(100 * sum(per_batch) / 1.5)
    from portbench.work import frontend
    fe = sum(frontend.frontend_work(cfg["spectrogram"], 32000, r, 128000).bound()[0]
             for r in (256, 248))
    assert read("frontend_roofline_share") == pytest.approx(100 * fe / 0.01)
    assert read("mfu.serve") == pytest.approx(
        100 * 600 * model.serve_ops_per_window(cfg) / 2.5 / peaks.PEAK_BF16)
    assert read("idle_share.serve") == pytest.approx(10.0)
    assert read("useful_row_share") == pytest.approx(100 * 500 / 504)
    assert read("h2d_ms_per_batch") == pytest.approx(20.0)
    assert run.reads_untraced(bench, CELL)


def test_the_calibrated_weights_give_varied_tracks():
    """Every clip of a small run is compared segment by segment; the tracks
    have several segments and fallback windows, and few windows above 0.99."""
    r = small.run_cell(CELL)
    post = r["checks"]["post_errors"]
    assert r["correct"] and post["of"] >= 1, r["checks"]
    assert post["runs_of"] > 0.8 * post["runs"] and post["runs"] > 2 * post["of"]
    assert post["segments"] > post["of"] and post["fallback_windows"] > 0
    assert post["top_share"] < 0.25


@pytest.mark.parametrize("fault", ["half", "permuted", "post"])
def test_a_planted_fault_makes_the_legacy_run_incorrect(fault):
    r = small.run_cell(CELL, fault=fault)
    assert r["correct"] is False
    failing = {k for k, c in r["checks"].items() if c["value"] > c["limit"]}
    assert failing == ({"post_errors"} if fault == "post" else {"logit_gap"}), r["checks"]
