"""The readings that the comparison's limits are set from: for each seed,
the port's numbers (a short window at the cell's own load, then the same
check as a run) and the control's, the reference computed in the nearest
precision below the configuration's bf16 (fp8 e4m3 operands, one scale a
tensor, float32 accumulation) standing in the port's place on the same
sample. One process runs every seed, so set-up is paid once per seed and
the import once. ``--control k`` reads the control on the first k seeds
only; ``--fault`` reads the port with a planted fault instead.

    python -m portbench.readings --workload <name> --seeds 1,2,3 --seconds 4 [--control 2] [--out f.json]
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys

import torch

from portbench import run
from portbench.reference.resnet import quantizer
from portbench.trace import Tracer

CONTROL = torch.float8_e4m3fn


def readings(files, seeds, seconds: float, device, control: int = 10**9, fault=None):
    driver_mod = importlib.import_module(f"portbench.drivers.{files['traffic']['driver']}")
    limits = files["workload"]["limits"]
    out = []
    for i, seed in enumerate(seeds):
        drv = driver_mod.Driver(files["config"], files["traffic"], seed, device, Tracer(False),
                                fault)
        drv.setup()
        drv.window(seconds)
        drv.release()
        row = {"seed": seed, "port": drv.check(limits)}
        if i < control:
            row["control"] = drv.check(limits, control=quantizer(CONTROL))
        out.append(row)
        print(json.dumps(row), flush=True)
        del drv
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--out", default="")
    p.add_argument("--control", type=int, default=10**9, help="seeds that also read the control")
    p.add_argument("--fault", default=None, help="plant this fault in the port (no control)")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: needs CUDA", file=sys.stderr)
        return 2
    rows = readings(run.cell_files(a.workload), [int(s) for s in a.seeds.split(",")], a.seconds,
                    "cuda", control=a.control if a.fault is None else 0, fault=a.fault)
    if a.out:
        with open(a.out, "w") as f:
            json.dump({"workload": a.workload, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
