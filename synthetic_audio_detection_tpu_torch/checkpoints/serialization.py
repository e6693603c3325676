"""The reference package's checkpoint formats (its
``checkpoints/serialization.py``):

- **native**: the msgpack file flax writes (``checkpoints/msgpack_io.py``),
  ``{'tree': <the JAX package's variable tree>, 'metadata': {...}}``; the
  tree holds the JAX layout (conv ``[kh, kw, I, O]``, linear ``[in, out]``,
  BN ``scale``/``mean``/``var``), converted here through the
  ``torch_compat`` maps. Merged ensembles (``save_merged_native`` /
  ``load_merged_native``: the N sub-models stacked on a leading axis, with
  ``class_names``, ``backbone``, ``shared_backbone``,
  ``shared_trunk_stages``, ``generic_head`` and ``calibration`` in the
  metadata) and the trainer's state (``variables`` and the optax AdamW
  ``opt_state``);
- **torch**: the merged ``.pth`` ``{'state_dict': {'sub_models.<i>.base.*',
  'sub_models.<i>.head.<index>.*'}, 'metadata': {'class_names': [syn_1..
  syn_N, real], 'generic_head'?, 'calibration'?}}`` and the reference
  trainer's ``{epoch, state_dict, best_acc, optimizer, scheduler,
  total_steps}`` (``load_submodel_torch`` / ``save_submodel_torch``).

The joint trainer's resume file is native (``format: 'sad-tpu-joint-v1'``):
its variables and Adam moments are trees ``{'base': <the shared trunk>,
'heads': <every head's leaves stacked on a leading axis>}``, and with
per-head stages ``'heads'`` is ``{'tail': ..., 'mlp': ...}``
(``joint_tree`` / ``joint_named`` map them to the joint model's names).

Torch files load with ``torch.load(..., weights_only=True)``: the files
the reference package's own writer produces hold only tensors, dicts,
lists, tuples and scalars, which that loader accepts as they are.
"""

from __future__ import annotations

import os
import re
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from synthetic_audio_detection_tpu_torch.checkpoints import msgpack_io, torch_compat
from synthetic_audio_detection_tpu_torch.checkpoints.torch_compat import split_merged_state_dict
from synthetic_audio_detection_tpu_torch.ensemble.multihead import (
    MultiHeadEnsemble,
    build_ensemble,
)


def _numpy(tree: Any) -> Any:
    """Tensors → numpy arrays through dicts and lists."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


# ---------------------------------------------------------------------------
# Native format
# ---------------------------------------------------------------------------

def save_native(path: str, tree: Any, metadata: Optional[Dict[str, Any]] = None) -> None:
    """``{'tree': tree, 'metadata': metadata}`` as msgpack, written to a
    temporary file and renamed into place."""
    data = msgpack_io.packb({"tree": _numpy(tree), "metadata": metadata or {}})
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def load_native(path: str) -> Tuple[Any, Dict[str, Any]]:
    with open(path, "rb") as f:
        payload = msgpack_io.unpackb(f.read())
    return payload["tree"], payload.get("metadata", {})


def optax_adamw_state(count: int, mu: Dict[str, Any], nu: Dict[str, Any],
                      lr: float) -> Dict[str, Any]:
    """The state dict of the reference trainer's optimizer
    (``inject_hyperparams(chain(clip_by_global_norm, adamw))``) as flax's
    ``to_state_dict`` writes it, for moment trees in the JAX layout."""
    c = np.asarray(count, np.int32)
    return {"count": c, "hyperparams": {"lr": np.asarray(lr, np.float32)},
            "hyperparams_states": {},
            "inner_state": {"0": {}, "1": {"0": {"count": c, "mu": mu, "nu": nu},
                                           "1": {}, "2": {}}}}


def moments_by_name(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A (partial) moment tree in the JAX layout → {parameter name: array}
    in the port's key space and layout."""
    return torch_compat.torch_state_dict_from_variables({"params": tree})


def adam_from_optax_state(opt_state: Dict[str, Any]) -> Tuple[int, Dict[str, np.ndarray],
                                                              Dict[str, np.ndarray]]:
    """(count, mu, nu) by parameter name from ``optax_adamw_state``'s tree."""
    adam = opt_state["inner_state"]["1"]["0"]
    return int(np.asarray(adam["count"])), moments_by_name(adam["mu"]), moments_by_name(adam["nu"])


def _collections(variables: Dict[str, Any], scope: str) -> Dict[str, Any]:
    return {c: variables[c].get(scope, {}) for c in ("params", "batch_stats")}


def joint_tree(named: Dict[str, Any]) -> Dict[str, Any]:
    """The joint model's state (or moments) by name, as numpy — ``base.*``
    (the trunk), ``heads.<i>.<index>.*`` (head i's MLP) or, with per-head
    stages, ``heads.<i>.tail.*`` and ``heads.<i>.mlp.<index>.*`` — → the
    reference's trees ``{'params': {'base', 'heads'}, 'batch_stats':
    {'base', 'heads'}}`` (a collection with no entries is empty)."""
    to_vars = torch_compat.classifier_variables_from_torch
    out = _collections(to_vars({k: v for k, v in named.items() if k.startswith("base.")},
                               base_prefix="base."), "base")
    out = {c: {"base": t} for c, t in out.items()}
    per_head: Dict[int, Dict[str, Any]] = {}
    for k, v in named.items():
        m = re.match(r"heads\.(\d+)\.(.+)", k)
        if m:
            per_head.setdefault(int(m.group(1)), {})[m.group(2)] = v
    heads = []
    for i in sorted(per_head):
        sd = per_head[i]
        if any(k.startswith("tail.") for k in sd):
            tail = _collections(to_vars({"base." + k[5:]: v for k, v in sd.items()
                                         if k.startswith("tail.")}, base_prefix="base."), "base")
            mlp = _collections(to_vars({"head." + k[4:]: v for k, v in sd.items()
                                        if k.startswith("mlp.")}), "head")
            heads.append({c: {"tail": tail[c], "mlp": mlp[c]} for c in tail})
        else:
            heads.append(_collections(to_vars({"head." + k: v for k, v in sd.items()}), "head"))
    for c in out:
        out[c]["heads"] = _stack([h[c] for h in heads])
    return out


def joint_named(variables: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """``joint_tree``'s inverse: reference trees (either collection may be
    absent, as in a moment tree) → the joint model's names, as numpy."""
    p, s = variables.get("params", {}), variables.get("batch_stats", {})
    named = torch_compat.torch_state_dict_from_variables(
        {"params": {"base": p.get("base", {})}, "batch_stats": {"base": s.get("base", {})}})
    hp, hs = p.get("heads", {}), s.get("heads", {})
    leaves = torch_compat._flatten(hp)
    n = len(next(iter(leaves.values()))) if leaves else 0
    for i in range(n):
        hpi, hsi = _unstack(hp, i), _unstack(hs, i)
        if "tail" in hpi:
            tail = torch_compat.torch_state_dict_from_variables(
                {"params": {"base": hpi["tail"]}, "batch_stats": {"base": hsi.get("tail", {})}})
            named.update({f"heads.{i}.tail.{k[5:]}": v for k, v in tail.items()})
            mlp_p, mlp_s, prefix = hpi["mlp"], hsi.get("mlp", {}), f"heads.{i}.mlp."
        else:
            mlp_p, mlp_s, prefix = hpi, hsi, f"heads.{i}."
        mlp = torch_compat.torch_state_dict_from_variables(
            {"params": {"head": mlp_p}, "batch_stats": {"head": mlp_s}})
        named.update({prefix + k[5:]: v for k, v in mlp.items()})
    return named


# ---------------------------------------------------------------------------
# Merged-ensemble checkpoints (both formats)
# ---------------------------------------------------------------------------

def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack([np.asarray(t, np.float32) for t in trees])


def _unstack(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def save_merged_native(path: str, ensemble: MultiHeadEnsemble) -> None:
    variables = _stack([torch_compat.classifier_variables_from_torch(
        {k: v.detach().float().cpu().numpy() for k, v in sd.items()}, base_prefix="base.")
        for sd in ensemble.classifier_state_dicts()])
    metadata = {
        "class_names": list(ensemble.class_names),
        "backbone": ensemble.backbone_name,
        "shared_backbone": ensemble.shared_backbone,
        "shared_trunk_stages": ensemble.shared_trunk_stages,
        "format": "sad-tpu-merged-v1",
    }
    if ensemble.generic_head:
        metadata["generic_head"] = True
    if ensemble.calibration:
        metadata["calibration"] = dict(ensemble.calibration)
    save_native(path, variables, metadata=metadata)


def load_merged_native(path: str) -> MultiHeadEnsemble:
    """A native merged file → ensemble (float32, on the CPU). The layout is
    detected as the reference detects it; a recorded ``shared_trunk_stages``
    is taken as it is, without the scan."""
    tree, meta = load_native(path)
    generic = bool(meta.get("generic_head", False))
    num_heads = len(meta["class_names"]) - 1 + int(generic)
    sds = [{k: torch.from_numpy(np.array(v, np.float32)) for k, v in
            torch_compat.torch_state_dict_from_variables(_unstack(tree, i)).items()}
           for i in range(num_heads)]
    return build_ensemble(
        sds, meta["class_names"], meta.get("backbone", "resnet18"),
        detect_shared_backbone=bool(meta.get("shared_backbone", False)),
        generic_head=generic, shared_trunk_stages=int(meta.get("shared_trunk_stages", 0)),
        calibration=dict(meta["calibration"]) if meta.get("calibration") else None)


def save_merged_torch(path: str, ensemble: MultiHeadEnsemble) -> None:
    """Write the merged contract; a shared backbone or trunk is written once
    per sub-model, as the reference merger does."""
    sd: Dict[str, torch.Tensor] = {}
    for i, sub in enumerate(ensemble.classifier_state_dicts()):
        for k, v in sub.items():
            sd[f"sub_models.{i}.{k}"] = v.detach().cpu().clone()
    metadata: Dict[str, Any] = {"class_names": list(ensemble.class_names)}
    if ensemble.generic_head:
        metadata["generic_head"] = True
    if ensemble.calibration:
        metadata["calibration"] = dict(ensemble.calibration)
    torch.save({"state_dict": sd, "metadata": metadata}, path)


def load_merged_torch(path: str, backbone: str = "resnet18") -> MultiHeadEnsemble:
    """Read a merged ``.pth`` into an ensemble (float32, on the CPU). As in
    the reference, a class-name count that does not fit the sub-models
    drops the ``generic_head`` flag along with the names."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj["state_dict"] if isinstance(obj, dict) and "state_dict" in obj else obj
    meta = obj.get("metadata", {}) if isinstance(obj, dict) else {}
    subs = split_merged_state_dict(sd)
    if not subs:
        raise ValueError(f"{path}: no 'sub_models.<i>.*' keys found")
    subs = [{k[len("module."):] if k.startswith("module.") else k: v.float()
             if v.is_floating_point() else v for k, v in s.items()} for s in subs]
    class_names = list(meta.get("class_names", []))
    generic = bool(isinstance(meta, dict) and meta.get("generic_head", False))
    if len(class_names) != len(subs) + 1 - int(generic):
        generic = False
        class_names = [f"Synthetic_{i + 1}" for i in range(len(subs))] + ["Real"]
    calibration = dict(meta["calibration"]) if isinstance(meta, dict) and meta.get(
        "calibration") else None
    return build_ensemble(subs, class_names, backbone, generic_head=generic,
                          calibration=calibration)


def load_merged(path: str, backbone: str = "resnet18") -> MultiHeadEnsemble:
    """Merged checkpoint in either format: a zip is the torch ``.pth``;
    anything else is read as native, and as a (legacy, non-zip) torch
    pickle if that fails. A file that is neither raises ValueError."""
    if zipfile.is_zipfile(path):
        return load_merged_torch(path, backbone)
    try:
        return load_merged_native(path)
    except Exception as native_err:  # noqa: BLE001 - try the other format
        try:
            return load_merged_torch(path, backbone)
        except Exception as torch_err:  # noqa: BLE001 - reported with both causes
            raise ValueError(f"{path}: neither a native msgpack merged checkpoint "
                             f"({native_err!r}) nor a torch .pth ({torch_err!r})") from torch_err


# ---------------------------------------------------------------------------
# Sub-model (trainer) checkpoints
# ---------------------------------------------------------------------------

def load_submodel_torch(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """A trainer-style or BinaryClassifier-style ``.pth`` → (the
    BinaryClassifier state dict, ``base.*`` and ``head.<index>.*`` as
    numpy; extras: epoch, best_acc, total_steps, scheduler, optimizer,
    layer3_unfrozen where present, 'flavor', and 'raw_state_dict', whose
    key order indexes the optimizer's parameters)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    extras: Dict[str, Any] = {}
    if isinstance(obj, dict) and "state_dict" in obj:
        sd = obj["state_dict"]
        for k in ("epoch", "best_acc", "total_steps", "scheduler", "optimizer",
                  "layer3_unfrozen"):
            if k in obj:
                extras[k] = _numpy(obj[k])
    else:
        sd = obj
    sd = {k: v.float().numpy() if v.is_floating_point() else v.numpy() for k, v in sd.items()}
    flavor = torch_compat.detect_checkpoint_flavor(sd)
    prefix = "base." if flavor == "classifier" else ""
    variables = torch_compat.classifier_variables_from_torch(sd, base_prefix=prefix)
    extras["flavor"] = flavor
    extras["raw_state_dict"] = sd
    return torch_compat.torch_state_dict_from_variables(variables), extras


def _tensors(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _tensors(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_tensors(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(obj))
    return obj


def save_submodel_torch(
    path: str,
    state_dict: Dict[str, Any],
    epoch: int = 0,
    best_acc: float = 0.0,
    total_steps: int = 0,
    scheduler: Optional[Dict[str, Any]] = None,
    layer3_unfrozen: Optional[bool] = None,
    optimizer: Optional[Dict[str, Any]] = None,
) -> None:
    """Write the reference trainer's checkpoint contract for a
    BinaryClassifier state dict. ``scheduler`` carries the PlateauState
    dict; ``optimizer`` a torch AdamW state dict
    (``torch_compat.torch_optimizer_state_dict``)."""
    sd = {k: torch.as_tensor(np.ascontiguousarray(np.asarray(v, np.float32)))
          for k, v in state_dict.items()}
    payload = {
        "epoch": int(epoch),
        "state_dict": sd,
        "best_acc": float(best_acc),
        "optimizer": _tensors(dict(optimizer)) if optimizer else {},
        "scheduler": dict(scheduler) if scheduler else {},
        "total_steps": int(total_steps),
    }
    if layer3_unfrozen is not None:
        payload["layer3_unfrozen"] = bool(layer3_unfrozen)
    torch.save(payload, path)
