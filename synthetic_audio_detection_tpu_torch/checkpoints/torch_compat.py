"""Merged-checkpoint key handling and the JAX variable tree → torch key map
(the port's copy of ``split_merged_state_dict`` and
``torch_state_dict_from_variables`` from the reference package's
``checkpoints/torch_compat.py``).

The torch head is an ``nn.Sequential`` whose learnable entries sit at
indices 2 (Linear F→512), 3 (BatchNorm1d), 6 (Linear 512→256), 7
(BatchNorm1d) and 10 (Linear 256→2); the JAX package's ``BinaryHead`` names
them fc1/bn1/fc2/bn2/out. Layouts: conv ``[kh, kw, I, O]`` → ``[O, I, kh,
kw]``, linear ``[in, out]`` → ``[out, in]``, BN scale → weight and
mean/var → running_mean/running_var.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

import numpy as np

_FLAX_HEAD_TO_SEQ = {"fc1": "2", "bn1": "3", "fc2": "6", "bn2": "7", "out": "10"}


def split_merged_state_dict(
    state_dict: Dict[str, np.ndarray],
) -> List[Dict[str, np.ndarray]]:
    """Split merged-style ``sub_models.<i>.*`` keys into per-sub-model
    dicts, in index order."""
    per_idx: Dict[int, Dict[str, np.ndarray]] = {}
    for key, value in state_dict.items():
        m = re.match(r"sub_models\.(\d+)\.(.+)", key)
        if not m:
            continue
        per_idx.setdefault(int(m.group(1)), {})[m.group(2)] = value
    return [per_idx[i] for i in sorted(per_idx)]


def _flatten(tree: Any, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
    else:
        out[prefix] = np.asarray(tree)
    return out


def torch_state_dict_from_variables(
    variables: Dict[str, Any], base_prefix: str = "base."
) -> Dict[str, np.ndarray]:
    """Classifier variables ``{'params', 'batch_stats'}`` (numpy) → torch
    state dict in the BinaryClassifier key space (``base.*`` +
    ``head.<idx>.*``)."""
    sd: Dict[str, np.ndarray] = {}

    def backbone_key(path: Tuple[str, ...]) -> str:
        mod = path[0]
        m = re.match(r"layer(\d+)_(\d+)", mod)
        if m:
            mod = f"layer{m.group(1)}.{m.group(2)}"
        rest = [p.replace("downsample_", "downsample.") for p in path[1:-1]]
        return ".".join([mod] + rest) if rest else mod

    for path, arr in _flatten(variables.get("params", {})).items():
        scope, inner, leaf = path[0], path[1:-1], path[-1]
        if scope == "base":
            key = backbone_key(path[1:])
            if leaf == "kernel":
                sd[f"{base_prefix}{key}.weight"] = arr.transpose(3, 2, 0, 1)
            elif leaf == "scale":
                sd[f"{base_prefix}{key}.weight"] = arr
            else:
                sd[f"{base_prefix}{key}.{leaf}"] = arr
        elif scope == "head":
            name = inner[0]
            idx = _FLAX_HEAD_TO_SEQ[name]
            if leaf == "kernel":
                sd[f"head.{idx}.weight"] = arr.transpose(1, 0)
            elif leaf == "scale":
                sd[f"head.{idx}.weight"] = arr
            else:
                sd[f"head.{idx}.{leaf}"] = arr

    for path, arr in _flatten(variables.get("batch_stats", {})).items():
        scope, inner, leaf = path[0], path[1:-1], path[-1]
        tname = {"mean": "running_mean", "var": "running_var"}[leaf]
        if scope == "base":
            key = backbone_key(path[1:])
            sd[f"{base_prefix}{key}.{tname}"] = arr
        else:
            idx = _FLAX_HEAD_TO_SEQ[inner[0]]
            sd[f"head.{idx}.{tname}"] = arr
    return sd
