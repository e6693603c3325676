"""The reference's merged-ensemble ``.pth`` contract (the reference package's
``checkpoints/serialization.py``, torch format only).

``{'state_dict': {'sub_models.<i>.base.*', 'sub_models.<i>.head.<index>.*'},
'metadata': {'class_names': [syn_1..syn_N, real], 'generic_head'?,
'calibration'?}}``. Files load with ``torch.load(..., weights_only=True)``:
the files the reference package's own writer produces hold only tensors,
dicts, lists and scalars, which that loader accepts as they are. The
package's native msgpack format is not read here.
"""

from __future__ import annotations

import zipfile
from typing import Any, Dict

import torch

from synthetic_audio_detection_tpu_torch.checkpoints.torch_compat import split_merged_state_dict
from synthetic_audio_detection_tpu_torch.ensemble.multihead import (
    MultiHeadEnsemble,
    build_ensemble,
)


def save_merged_torch(path: str, ensemble: MultiHeadEnsemble) -> None:
    """Write the merged contract; a shared backbone is written once per
    sub-model, as the reference merger does."""
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
    """Read a merged ``.pth`` into an ensemble (float32, on the CPU)."""
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
    """Merged checkpoint loader of the CLI: the torch zip format only."""
    if not zipfile.is_zipfile(path):
        raise ValueError(f"{path}: not a torch .pth (zip) checkpoint; the native "
                         "msgpack format is not supported by the PyTorch port")
    return load_merged_torch(path, backbone)
