"""The benchmark's cells cut to a size a CPU test run holds: 1-s windows,
64² images, batches of 16, a few clips. Widths and layouts are the
configurations' own."""

from __future__ import annotations

import types

from portbench import run


def cell(name: str):
    """The cell's files with the small sizes written over them."""
    files = run.cell_files(name)
    cfg, t = files["config"], files["traffic"]
    cfg["spectrogram"]["out_size"] = 64
    cfg["audio"]["window_seconds"] = 1.0
    cfg["serve"]["batch_size"] = 16
    if t["driver"] == "bulk":
        t.update(pool_windows=64, min_windows=10, max_windows=40, clip_lengths=4, check_windows=24)
    else:
        cfg["train"].update(batch_files=4, rows=8)
        t.update(pool_rows=32)
    return files


def args(name: str, seed: int = 2**31 + 11, seconds: float = 1.0, trace: int = 0):
    return types.SimpleNamespace(workload=name, seed=seed, seconds=seconds, trace=trace)


def run_cell(name: str, seed: int = 2**31 + 11, seconds: float = 1.0, fault=None):
    return run.run(args(name, seed, seconds), cell(name), "cpu", require_cuda=False, fault=fault)
