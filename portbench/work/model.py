"""Whole-model operation counts of a configuration, for ``mfu``: a serving
forward of one window (front end, every backbone the configuration runs,
the heads) and a training step (phase 2: the forward of every stage, the
backward through stages 3 and 4 and the head)."""

from __future__ import annotations

import importlib
from typing import Dict, List

from portbench.work import frontend
from portbench.work.peaks import Work


def spec_of(cfg: Dict) -> Dict:
    return cfg["spectrogram"]


def window_samples(cfg: Dict) -> int:
    return int(cfg["audio"]["window_seconds"] * cfg["audio"]["sample_rate"])


def block(cfg: Dict):
    """The work module of the configuration's backbone, found by its
    ``model.block``: ``portbench/work/resnet_<block>.py``. A new block adds
    a module; a block without one is refused, never counted as another."""
    name = cfg["model"]["block"]
    module = f"portbench.work.resnet_{name}"
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise ValueError(f"no work count for a {name!r} block: portbench/work/resnet_{name}.py "
                         "is missing") from None


def backbone_work(cfg: Dict, batch: int) -> Work:
    """One backbone's forward over ``batch`` inputs at the configuration's size."""
    m, size = cfg["model"], cfg["spectrogram"]["out_size"]
    return block(cfg).backbone_work(batch, size, size, m["stages"], m["widths"])


def backbone_convs(cfg: Dict) -> List:
    """The backbone's convs in order, each with its ``name`` and ``work(batch)``."""
    m, size = cfg["model"], cfg["spectrogram"]["out_size"]
    return block(cfg).resnet_convs(size, size, m["stages"], m["widths"])


def heads_work(cfg: Dict, batch: int, n_heads: int = 0) -> Work:
    """``n_heads`` (all, by default) binary heads on ``batch`` pooled rows."""
    m = cfg["model"]
    return block(cfg).heads_work(batch, n_heads or m["heads"], m["widths"][-1], m["head_hidden"],
                                 m["outputs"])


def backbones_run(cfg: Dict) -> int:
    """Backbone passes a serving forward makes: one for the shared layout,
    one per head for the dense."""
    return 1 if cfg["model"]["layout"] == "shared" else cfg["model"]["heads"]


def serve_ops_per_window(cfg: Dict) -> float:
    """FLOP of one window's serving forward."""
    spec, sr = spec_of(cfg), cfg["audio"]["sample_rate"]
    fe = frontend.frontend_work(spec, sr, 1, window_samples(cfg))
    return fe.ops + backbone_work(cfg, 1).ops * backbones_run(cfg) + heads_work(cfg, 1).ops


def train_ops_per_row(cfg: Dict, trainable_from_stage: int = 3) -> float:
    """FLOP of one row of a training step that trains the head and the
    stages from ``trainable_from_stage`` on: the forward of everything,
    and for the trainable part the weight gradients (one forward's
    products) and the input gradients (another), except the input
    gradients of the first trainable stage's convs that read the frozen
    part's output."""
    spec, sr = spec_of(cfg), cfg["audio"]["sample_rate"]
    fe = frontend.frontend_work(spec, sr, 1, window_samples(cfg))
    convs = backbone_convs(cfg)
    fwd = sum(c.work(1).ops for c in convs)
    head = heads_work(cfg, 1, n_heads=1).ops
    bwd = 2.0 * head
    first = f"layer{trainable_from_stage}.0."
    for c in convs:
        stage = int(c.name[5]) if c.name.startswith("layer") else 0
        if stage < trainable_from_stage:
            continue
        ops = c.work(1).ops
        bwd += ops if c.name.startswith(first) and not c.name.endswith("conv2") else 2.0 * ops
    return fe.ops + fwd + head + bwd
