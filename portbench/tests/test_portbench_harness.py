"""The harness: BENCHMARK.json's shape, every name resolving to its file,
the traffic generator's determinism, the metric arithmetic on synthetic
events, the cells end to end at a small size on the CPU, and the planted
faults that the check has to catch. The cells on the card carry the
``cuda`` marker and skip where there is none."""

import contextlib
import importlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import generate, run, trace
from portbench.tests import small

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_has_the_contracts_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).exists()
        assert c["reduced"] == json.loads((ROOT / c["file"]).read_text())["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        for cell in m["workloads"]:  # the cell reports what the metric moves
            assert cell in next(e for e in BENCH["end_to_end"]
                                if e["name"] == m["moves"]).get("workloads", CELLS)
    for cell in CELLS:
        reported = run.metrics_of(BENCH, cell, trace=False)
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert run.metrics_of(BENCH, cell, trace=True)
    roofs = [m for m in BENCH["per_layer"] if m["name"].endswith("_roofline_share")
             or "mfu" in m["name"]]
    assert roofs and all(m["unit"] == "%" for m in roofs)


@pytest.mark.parametrize("cell", CELLS)
def test_every_name_resolves_to_its_files(cell):
    files = run.cell_files(cell)
    assert importlib.import_module(f"portbench.drivers.{files['traffic']['driver']}").Driver
    for m in run.metrics_of(BENCH, cell, False) + run.metrics_of(BENCH, cell, True):
        assert callable(run.metric_module(m["name"]).read)
    assert files["workload"]["limits"]


def test_traffic_is_the_same_for_the_same_seed():
    a = generate.window_pool(6, 4000, 32000, 2**31 + 3, "cpu")
    b = generate.window_pool(6, 4000, 32000, 2**31 + 3, "cpu")
    c = generate.window_pool(6, 4000, 32000, 2**31 + 4, "cpu")
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert np.abs(a).max(axis=1).min() > 1e-3  # every window clears the silence gate
    assert generate.clip_offsets([3, 5], 64, 9) == generate.clip_offsets([3, 5], 64, 9)


def test_every_seed_gets_the_same_sizes_in_another_order():
    assert generate.even_lengths(75, 450, 12) == generate.even_lengths(75, 450, 12)
    assert generate.even_lengths(75, 450, 12)[::11] == [75, 450]
    order = generate.cycle_order(5, 7)
    cycles = [sorted(next(order) for _ in range(5)) for _ in range(3)]
    assert cycles == [[0, 1, 2, 3, 4]] * 3
    first = lambda seed: [next(o) for o in [generate.cycle_order(12, seed)] for _ in range(12)]  # noqa: E731
    assert sorted(first(1)) == sorted(first(2)) and first(1) != first(2)


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert trace.union_length(iv) == pytest.approx(3.0)
    assert trace.gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]


def test_summary_attributes_device_time_to_the_launching_span():
    spans = [trace.Span(trace.WINDOW, 1, 0.0, 10.0),
             trace.Span("portbench.frontend", 7, 1.0, 2.0),
             trace.Span("portbench.backbone", 7, 2.0, 5.0),
             trace.Span("portbench.dispatch", 7, 0.5, 6.0)]
    dev = [trace.DeviceEvent("k1", 1.2, 1.5, 7, 1.1),
           trace.DeviceEvent("Memcpy HtoD (Pageable -> Device)", 0.6, 1.0, 7, 0.6),
           trace.DeviceEvent("conv", 2.5, 4.5, 7, 2.1),
           trace.DeviceEvent("conv", 9.5, 11.0, 8, 9.0)]
    s = trace.summarize(dev, spans)
    assert s.window_s == 10.0 and s.busy_s == pytest.approx(0.3 + 0.4 + 2.0 + 0.5)
    assert s.span_device_s["portbench.frontend"] == pytest.approx(0.3)
    assert s.span_device_s["portbench.backbone"] == pytest.approx(2.0)
    assert s.span_device_s["portbench.dispatch"] == pytest.approx(2.7)
    assert s.h2d_s == pytest.approx(0.4) and s.unattributed_s == pytest.approx(0.5)
    # gaps 0-0.6, 1.0-1.2, 1.5-2.5 and 4.5-9.5, each labelled at its midpoint
    assert s.gap_by_host["portbench.frontend"] == pytest.approx(0.2 + 1.0)
    assert s.gap_by_host["host outside spans"] == pytest.approx(0.6 + 5.0)
    b = s.breakdown()
    assert b["device_ops"][0] == ["conv", pytest.approx(2.5)] and len(b["idle_gaps"]) <= 10


def test_metric_arithmetic_on_a_synthetic_context():
    cfg = run.cell_files("r18-shared6.bulk")["config"]
    s = trace.TraceSummary(window_s=2.0, busy_s=1.5, h2d_s=0.02, unattributed_s=0.0,
                           span_device_s={"portbench.frontend": 0.001, "portbench.backbone": 0.05},
                           device_by_name={}, gap_by_host={})
    ctx = {"cfg": cfg, "trace": s, "setup_s": 3.0,
           "run": {"window_s": 2.0, "useful_windows": 200},
           "untraced": {"window_s": 2.5, "useful_windows": 300},
           "port": {"rows": [128, 128], "forwards": 2}}
    read = lambda name: run.metric_module(name).read(ctx)  # noqa: E731
    assert read("windows_per_s") == 100.0 and read("setup_s") == 3.0
    assert read("useful_row_share") == pytest.approx(100 * 200 / 256)
    assert read("h2d_ms_per_batch") == pytest.approx(10.0)
    assert read("idle_share.serve") == pytest.approx(25.0)
    from portbench.work import frontend, model, peaks, resnet_basic
    fe = 2 * frontend.frontend_work(cfg["spectrogram"], 32000, 128, 128000).bound()[0]
    assert read("frontend_roofline_share") == pytest.approx(100 * fe / 0.001)
    bb = 2 * (resnet_basic.backbone_work(128, 512, 512) + resnet_basic.heads_work(128, 6)).bound()[0]
    assert read("backbone_roofline_share") == pytest.approx(100 * bb / 0.05)
    # the untraced window's rate, not the traced one's
    assert read("mfu.serve") == pytest.approx(
        100 * 300 * model.serve_ops_per_window(cfg) / 2.5 / peaks.PEAK_BF16)
    assert run.reads_untraced(BENCH, "r18-shared6.bulk")
    ctx["trace"] = ctx["untraced"] = None
    for name in ("frontend_roofline_share", "backbone_roofline_share", "mfu.serve",
                 "h2d_ms_per_batch", "idle_share.serve"):
        assert read(name) is None  # nothing to read: left out, never 0


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_runs_correct_at_a_small_size(cell):
    r = small.run_cell(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    expected = {m["name"] for m in run.metrics_of(BENCH, cell, False)}
    assert set(r["metrics"]) == expected and all(v["value"] > 0 for v in r["metrics"].values())


@pytest.mark.parametrize("cell,fault", [
    ("r18-shared6.bulk", "half"), ("r18-shared6.bulk", "altered"),
    ("r18-shared6.bulk", "permuted"),
    ("r18-dense6.bulk", "half"), ("r18-dense6.bulk", "altered"),
    ("r18-dense6.bulk", "permuted"),
    ("r18-dense6.train", "half"), ("r18-dense6.train", "unchanged"),
])
def test_a_planted_fault_makes_the_run_incorrect(cell, fault):
    assert small.run_cell(cell, fault=fault)["correct"] is False


def test_the_serving_comparison_judges_the_decision_and_counts_what_it_can():
    from portbench import correct

    rng = np.random.default_rng(3)
    ref = 0.5 + 0.1 * rng.standard_normal((8, 7))
    ref[:, 2] += 1.0  # Syn3 leads
    served = ref + 1e-3 * rng.standard_normal(ref.shape)
    decided = ["Syn3"] * 8
    c = correct.serving(served, ref, decided, decided, 0, 0, {"logit_gap": 1.0})
    assert correct.passed(c) and c["verdict_errors"]["of"] == 8
    assert c["logit_gap"]["value"] < 0.1
    wrong = ["Syn3"] * 7 + ["Real"]  # a label that its own logits do not give
    c = correct.serving(served, ref, wrong, decided, 0, 0, {"logit_gap": 1.0})
    assert c["verdict_errors"]["value"] == 1 and not correct.passed(c)
    tied = served.copy()
    tied[:2, 0] = 0.0  # on the threshold: either label is right
    c = correct.serving(tied, ref, ["Real"] * 2 + decided[2:], decided, 0, 0, {"logit_gap": 1.0})
    assert c["verdict_errors"]["of"] == 6 and c["verdict_errors"]["value"] == 0


def test_the_traced_run_reads_mfu_from_an_untraced_window_first(monkeypatch):
    class Off(trace.Tracer):  # the traced run's path, without the profiler
        def window(self):
            return contextlib.nullcontext()

        def summary(self):
            return None
    monkeypatch.setattr(trace, "Tracer", Off)
    r = run.run(small.args("r18-dense6.train", trace=1), small.cell("r18-dense6.train"), "cpu",
                require_cuda=False)
    assert r["correct"] and set(r["metrics"]) == {"mfu.train"}
    assert r["attempted"] > 1 and r["metrics"]["mfu.train"]["value"] > 0


def test_without_cuda_the_run_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_without_the_port_the_run_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_on_the_card(card, cell):
    files = run.cell_files(cell)
    r = run.run(small.args(cell, seconds=2.0), files, "cuda")
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["memory_peak_bytes"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card_is_incorrect(card, cell):
    from portbench import correct, readings

    rows = readings.readings(run.cell_files(cell), [2**31 + 21], 2.0, "cuda")
    assert correct.passed(rows[0]["port"]) and not correct.passed(rows[0]["control"])
