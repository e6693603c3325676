"""Torch state dicts ↔ the JAX package's variable trees, and the torch
AdamW state ↔ Adam moments (the port's copy of the reference package's
``checkpoints/torch_compat.py``: ``split_merged_state_dict``,
``torch_state_dict_from_variables``, ``classifier_variables_from_torch``,
``detect_checkpoint_flavor``, ``trainable_param_keys``,
``adam_moments_from_torch``, ``overlay_tree`` and
``torch_optimizer_state_dict``; ``tests/test_torch_host.py`` pins them).
The native checkpoint stores the JAX layout, so the port's native reader
and writer go through these maps.

The torch head is an ``nn.Sequential`` whose learnable entries sit at
indices 2 (Linear F→512), 3 (BatchNorm1d), 6 (Linear 512→256), 7
(BatchNorm1d) and 10 (Linear 256→2); the JAX package's ``BinaryHead`` names
them fc1/bn1/fc2/bn2/out. Layouts: conv ``[kh, kw, I, O]`` → ``[O, I, kh,
kw]``, linear ``[in, out]`` → ``[out, in]``, BN scale → weight and
mean/var → running_mean/running_var.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

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


_FLAX_HEAD_TO_SEQ = {"fc1": "2", "bn1": "3", "fc2": "6", "bn2": "7", "out": "10"}


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


# torch Sequential index → flax module name inside BinaryHead
_HEAD_SEQ_TO_FLAX = {
    "2": ("params", "fc1", "linear"),
    "3": ("bn", "bn1"),
    "6": ("params", "fc2", "linear"),
    "7": ("bn", "bn2"),
    "10": ("params", "out", "linear"),
}

_BN_PARAM_MAP = {"weight": "scale", "bias": "bias"}
_BN_STATS_MAP = {"running_mean": "mean", "running_var": "var"}


def _strip_module_prefix(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    if sd and all(k.startswith("module.") for k in sd):
        return {k[len("module."):]: v for k, v in sd.items()}
    return sd


def _set(tree: dict, path: Tuple[str, ...], value: np.ndarray) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _convert_backbone_key(
    key: str, value: np.ndarray
) -> Optional[Tuple[str, Tuple[str, ...], np.ndarray]]:
    """One unprefixed torch ResNet key → (collection, flax path, array).

    Returns None for keys to drop (num_batches_tracked, fc.*).
    collection is 'params' or 'batch_stats'.
    """
    parts = key.split(".")
    if parts[-1] == "num_batches_tracked":
        return None
    if parts[0] in ("fc", "classifier"):  # timm classifier head — unused here
        return None

    # stem
    if parts[0] == "conv1" and parts[-1] == "weight":
        return "params", ("conv1", "kernel"), value.transpose(2, 3, 1, 0)
    if parts[0] == "bn1":
        leaf = parts[1]
        if leaf in _BN_PARAM_MAP:
            return "params", ("bn1", _BN_PARAM_MAP[leaf]), value
        if leaf in _BN_STATS_MAP:
            return "batch_stats", ("bn1", _BN_STATS_MAP[leaf]), value
        return None

    # stages: layer<j>.<b>.<sub>.<leaf>  (flax module: layer<j>_<b>)
    m = re.match(r"layer(\d+)\.(\d+)\.(.+)", key)
    if not m:
        return None
    stage, block, rest = m.group(1), m.group(2), m.group(3)
    mod = f"layer{stage}_{block}"
    rparts = rest.split(".")
    if rparts[0] == "downsample":
        sub = f"downsample_{rparts[1]}"
        leaf = rparts[2]
    else:
        sub = rparts[0]
        leaf = rparts[1]

    if sub.startswith("conv") or sub == "downsample_0":
        if leaf != "weight":
            return None
        return "params", (mod, sub, "kernel"), value.transpose(2, 3, 1, 0)
    # batch norm
    if leaf in _BN_PARAM_MAP:
        return "params", (mod, sub, _BN_PARAM_MAP[leaf]), value
    if leaf in _BN_STATS_MAP:
        return "batch_stats", (mod, sub, _BN_STATS_MAP[leaf]), value
    return None


def _convert_head_key(
    key: str, value: np.ndarray
) -> Optional[Tuple[str, Tuple[str, ...], np.ndarray]]:
    """'head.<idx>.<leaf>' → (collection, flax path under the head module)."""
    parts = key.split(".")
    if len(parts) != 3 or parts[0] != "head":
        return None
    idx, leaf = parts[1], parts[2]
    if leaf == "num_batches_tracked":
        return None
    spec = _HEAD_SEQ_TO_FLAX.get(idx)
    if spec is None:
        return None
    if spec[0] == "params":  # Linear
        name = spec[1]
        if leaf == "weight":
            return "params", (name, "kernel"), value.transpose(1, 0)
        if leaf == "bias":
            return "params", (name, "bias"), value
        return None
    # BatchNorm1d
    name = spec[1]
    if leaf in _BN_PARAM_MAP:
        return "params", (name, _BN_PARAM_MAP[leaf]), value
    if leaf in _BN_STATS_MAP:
        return "batch_stats", (name, _BN_STATS_MAP[leaf]), value
    return None


def classifier_variables_from_torch(
    state_dict: Dict[str, np.ndarray],
    base_prefix: str = "",
) -> Dict[str, Any]:
    """Build BinaryClassifier variables {'params', 'batch_stats'} from a torch
    state dict.

    base_prefix='' handles trainer-style checkpoints (unprefixed backbone);
    base_prefix='base.' handles BinaryClassifier/merged-style.
    """
    sd = _strip_module_prefix(state_dict)
    variables: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for key, value in sd.items():
        value = np.asarray(value)
        if key.startswith("head."):
            conv = _convert_head_key(key, value)
            if conv is not None:
                coll, path, arr = conv
                _set(variables[coll], ("head",) + path, arr)
            continue
        bkey = key
        if base_prefix and key.startswith(base_prefix):
            bkey = key[len(base_prefix):]
        elif base_prefix:
            continue  # key outside the base namespace
        conv = _convert_backbone_key(bkey, value)
        if conv is not None:
            coll, path, arr = conv
            _set(variables[coll], ("base",) + path, arr)
    return variables


def detect_checkpoint_flavor(obj: Any) -> str:
    """'trainer' | 'merged' | 'classifier' | 'raw_state_dict'."""
    if isinstance(obj, dict):
        if "state_dict" in obj:
            sd = obj["state_dict"]
            if any(k.startswith("sub_models.") for k in sd):
                return "merged"
            if "epoch" in obj or "best_acc" in obj:
                return "trainer"
            return "classifier"
        if any(k.startswith("sub_models.") for k in obj):
            return "merged"
        keys = list(obj.keys())
        if any(k.startswith(("base.", "module.base.")) for k in keys):
            return "classifier"
        if any(k.startswith(("conv1.", "layer1.", "module.conv1.")) for k in keys):
            return "trainer"
    return "raw_state_dict"


# ---------------------------------------------------------------------------
# Torch AdamW optimizer state ↔ optax Adam moments
# ---------------------------------------------------------------------------

# The reference builds its optimizer ONCE, before the epoch loop, over
# `filter(lambda p: p.requires_grad, model.parameters())`
# (submodel_trainer.py:647-651) — at that moment only layer4 + the head are
# trainable (:609-633), so every reference checkpoint's optimizer dict indexes
# exactly that parameter set, in model.parameters() order, regardless of the
# epoch it was saved at.
_PHASE1_PREFIXES = ("layer4", "head")
_PHASE2_PREFIXES = ("layer3", "layer4", "head")


def trainable_param_keys(
    state_dict: Dict[str, np.ndarray],
    prefixes: Tuple[str, ...] = _PHASE1_PREFIXES,
    base_prefix: str = "",
) -> List[str]:
    """Ordered torch PARAMETER keys (weight/bias only, buffers excluded)
    under the trainable prefixes — the order `filter(requires_grad,
    model.parameters())` yields at the reference's optimizer construction,
    because state-dict insertion order follows the same module traversal.
    ``base_prefix='base.'`` handles BinaryClassifier-flavor dicts (backbone
    namespaced, head unprefixed either way)."""
    pref = tuple(
        (p + ".") if p == "head" else (base_prefix + p + ".") for p in prefixes
    )
    out = []
    for k in _strip_module_prefix(state_dict):
        if not k.startswith(pref):
            continue
        if k.rsplit(".", 1)[-1] in ("weight", "bias"):
            out.append(k)
    return out


def _as_int(x) -> int:
    return int(np.asarray(x).reshape(-1)[0])


def adam_moments_from_torch(
    optimizer_sd: Dict[str, Any],
    state_dict: Dict[str, np.ndarray],
) -> Optional[Tuple[int, Dict[str, Any], Dict[str, Any]]]:
    """Torch AdamW ``optimizer.state_dict()`` → (step, mu_partial, nu_partial).

    mu/nu are PARTIAL BinaryClassifier param trees (only the leaves the torch
    optimizer tracked), already layout-transposed like the params themselves.
    Returns None when the dict is empty or its parameter count matches no
    known trainable set. Reference save/restore: submodel_trainer.py:707-714 /
    :669-682."""
    if not isinstance(optimizer_sd, dict) or not optimizer_sd.get("state"):
        return None
    stripped = _strip_module_prefix(state_dict)
    base_prefix = (
        "base." if any(k.startswith("base.") for k in stripped) else ""
    )
    groups = optimizer_sd.get("param_groups", [])
    indices = [i for g in groups for i in g.get("params", [])]
    for prefixes in (_PHASE1_PREFIXES, _PHASE2_PREFIXES):
        keys = trainable_param_keys(state_dict, prefixes, base_prefix)
        if len(keys) == len(indices):
            break
    else:
        return None
    idx_to_key = dict(zip(indices, keys))
    exp_avg_sd: Dict[str, np.ndarray] = {}
    exp_avg_sq_sd: Dict[str, np.ndarray] = {}
    steps = [0]
    for idx, entry in optimizer_sd["state"].items():
        key = idx_to_key.get(_as_int(idx))
        if key is None or "exp_avg" not in entry:
            continue
        exp_avg_sd[key] = np.asarray(entry["exp_avg"], np.float32)
        exp_avg_sq_sd[key] = np.asarray(entry["exp_avg_sq"], np.float32)
        if "step" in entry:
            steps.append(_as_int(entry["step"]))
    if not exp_avg_sd:
        return None
    # classifier_variables_from_torch applies the exact same layout transposes
    # to the moment tensors that it applies to the parameters they track
    mu = classifier_variables_from_torch(exp_avg_sd, base_prefix)["params"]
    nu = classifier_variables_from_torch(exp_avg_sq_sd, base_prefix)["params"]
    return max(steps), mu, nu


def overlay_tree(full: Any, partial: Any) -> Any:
    """Return `full` with every leaf present in `partial` replaced (both are
    nested dicts; `partial` must be a sub-tree of `full`)."""
    if not isinstance(partial, dict):
        return partial
    out = {}
    for k, v in full.items():
        out[k] = overlay_tree(v, partial[k]) if k in partial else v
    return out


def torch_optimizer_state_dict(
    count: int,
    mu: Dict[str, Any],
    nu: Dict[str, Any],
    lr: float = 1e-3,
    weight_decay: float = 0.01,
) -> Dict[str, Any]:
    """Optax Adam moment trees → a torch AdamW ``optimizer.state_dict()`` the
    reference's resume can consume (submodel_trainer.py:669-682). Exports the
    PHASE-1 trainable set (layer4 + head) — the only set a reference-built
    optimizer ever holds — in model.parameters() order; moments of other
    leaves (e.g. layer3 after our unfreeze) are not representable there and
    stay in the native checkpoint."""
    mu_sd = torch_state_dict_from_variables({"params": mu}, base_prefix="")
    nu_sd = torch_state_dict_from_variables({"params": nu}, base_prefix="")
    keys = trainable_param_keys(mu_sd)
    state = {}
    for i, k in enumerate(keys):
        state[i] = {
            "step": np.asarray(float(count), np.float32),
            "exp_avg": np.asarray(mu_sd[k], np.float32),
            "exp_avg_sq": np.asarray(nu_sd[k], np.float32),
        }
    group = {
        "lr": float(lr),
        "betas": (0.9, 0.999),
        "eps": 1e-8,
        "weight_decay": float(weight_decay),
        "amsgrad": False,
        "maximize": False,
        "foreach": None,
        "capturable": False,
        "differentiable": False,
        "fused": None,
        "params": list(range(len(keys))),
    }
    return {"state": state, "param_groups": [group]}
