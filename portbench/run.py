"""Run one cell of the port's benchmark and print its result.

    python -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` names the cell's configuration and traffic; the harness
finds ``portbench/workloads/<cell>.json`` (its limits),
``portbench/configs/<config>.json``, ``portbench/traffic/<traffic>.json``,
the driver ``portbench/drivers/<driver>.py`` that the traffic file names,
and one module ``portbench/metrics/<metric>.py`` per metric.

Set-up (imports, CUDA context, the kernels' build or load, the seeded
pools and weights, the warm-up of this cell's shapes) is timed from the
process's start to the first timed request. Then the window runs for
``--seconds``, traced by the profiler with ``--trace 1``; where a
per-layer metric of the cell reads the untraced window (its module sets
``WINDOW = "untraced"``: the profiler slows the host), the traced run
first runs the window untraced as well. After it the peak
memory is read, the port's state freed, and the reference checks what the
timed path produced. The last lines of standard error give each compared
number beside its limit; the last line of standard output is the result.
The run exits non-zero without a result where CUDA or the cell's cards
are missing, or where JAX or the JAX package got loaded.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / ".portbench_cache"
_T_IMPORT = time.time()


def since_start() -> float:
    """Seconds since this process started (from /proc; the module's import
    where /proc has no answer)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time() - _T_IMPORT


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def cell_files(name: str, root: Path = ROOT) -> Dict:
    """The cell's entry in BENCHMARK.json and the data files it names."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    workload = load_json(HERE / "workloads" / f"{name}.json")
    if (workload["config"], workload["traffic"]) != (cell["config"], cell["traffic"]):
        raise SystemExit(f"{name}: workloads/{name}.json names {workload['config']}/"
                         f"{workload['traffic']}, BENCHMARK.json {cell['config']}/{cell['traffic']}")
    return {"bench": bench, "cell": cell, "workload": workload,
            "config": load_json(HERE / "configs" / f"{cell['config']}.json"),
            "traffic": load_json(HERE / "traffic" / f"{cell['traffic']}.json")}


def metric_module(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The cell's end-to-end metrics (untraced run) or per-layer metrics
    (traced run)."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reads_untraced(bench: Dict, cell: str) -> bool:
    """Whether a per-layer metric of the cell reads the untraced window."""
    return any(getattr(metric_module(m["name"]), "WINDOW", "traced") == "untraced"
               for m in metrics_of(bench, cell, True))


def read_metrics(bench: Dict, cell: str, trace: bool, ctx: Dict) -> Dict[str, Dict]:
    out = {}
    for m in metrics_of(bench, cell, trace):
        value = metric_module(m["name"]).read(ctx)
        if value is None:
            if not trace:
                raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        return out[0] if out else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def run(args, files: Dict, device, require_cuda: bool = True,
        fault: Optional[str] = None) -> Optional[Dict]:
    """Set up, run the window, check; → the result (None: refused).
    ``fault`` plants one of the driver's faults under the timed path (the
    check's own tests)."""
    import torch

    from portbench import correct, guard
    from portbench.trace import Tracer

    name = args.workload
    if require_cuda:
        chips = files["cell"]["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"{name}: needs {chips} CUDA device(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return None
    driver_mod = importlib.import_module(f"portbench.drivers.{files['traffic']['driver']}")
    tracer = Tracer(bool(args.trace))
    drv = driver_mod.Driver(files["config"], files["traffic"], args.seed, device, tracer, fault)
    drv.setup()
    setup_s = since_start()
    untraced = None
    if tracer.on and reads_untraced(files["bench"], name):
        untraced = drv.window(args.seconds)
    with tracer.window():
        e2e = drv.window(args.seconds)
    summary = tracer.summary()
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    ctx = {"cfg": files["config"], "traffic": files["traffic"], "cell": name,
           "setup_s": setup_s, "run": e2e, "untraced": untraced, "port": drv.context(),
           "trace": summary}
    drv.release()
    checks = drv.check(files["workload"]["limits"])
    metrics = read_metrics(files["bench"], name, bool(args.trace), ctx)
    bad = guard.loaded()
    if bad:
        print(f"{name}: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return None
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    if cuda:
        device_info["power"] = power_limit()
    runs = [e2e] if untraced is None else [untraced, e2e]
    result = {"correct": correct.passed(checks), "attempted": sum(r["attempted"] for r in runs),
              "failed": sum(r["failed"] for r in runs), "metrics": metrics,
              "device": device_info}
    if summary is not None:
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
        result["breakdown"] = summary.breakdown()
        result["trace_counts"] = summary.counts
    result["checks"] = correct.compared(checks)
    return result


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    CACHE.mkdir(exist_ok=True)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    files = cell_files(args.workload)
    result = run(args, files, "cuda")
    if result is None:
        return 2
    from portbench import correct

    for line in correct.lines(result["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
