"""CSV-driven model merging (the reference package's ``ensemble/merger.py``).

Reads the recipe ``model_filename,synthetic_class,real_class``, loads each
sub-model checkpoint (``.pth``/``.pt`` of any flavor, or a native trainer
file), fills what a checkpoint lacks from a fresh init, resolves the shared
real-class name (unanimous, else the most common), runs a smoke forward on
a random [2, 3, 512, 512] batch on the caller's device, and gives the
ensemble with ``class_names = [syn_1..syn_N, real]``; ``save_merged``
writes it as the reference's ``.pth`` or as native msgpack.
"""

from __future__ import annotations

import csv
import logging
import os
from collections import Counter
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from synthetic_audio_detection_tpu_torch.checkpoints import serialization, torch_compat
from synthetic_audio_detection_tpu_torch.ensemble.multihead import (
    MultiHeadEnsemble,
    build_ensemble,
)
from synthetic_audio_detection_tpu_torch.models.classifier import BinaryClassifier
from synthetic_audio_detection_tpu_torch.models.init import flax_default_init_
from synthetic_audio_detection_tpu_torch.train.trainer import resolve_device

log = logging.getLogger(__name__)


def read_merge_recipe(csv_path: str) -> List[Dict[str, str]]:
    """Rows of {model_filename, synthetic_class, real_class}; rows without
    a file name are skipped, an empty recipe raises."""
    rows = []
    with open(csv_path, newline="") as f:
        for row in csv.DictReader(f):
            row = {k.strip(): (v or "").strip() for k, v in row.items()}
            if not row.get("model_filename"):
                continue
            rows.append({"model_filename": row["model_filename"],
                         "synthetic_class": row.get("synthetic_class", ""),
                         "real_class": row.get("real_class", "Real")})
    if not rows:
        raise ValueError(f"{csv_path}: empty merge recipe")
    return rows


def resolve_real_name(real_names: List[str]) -> str:
    """Unanimous, else the most common (with a warning)."""
    uniq = set(real_names)
    if len(uniq) == 1:
        return real_names[0]
    name, _ = Counter(real_names).most_common(1)[0]
    log.warning("real-class names disagree %s; majority: %s", sorted(uniq), name)
    return name


def _complete_variables(state_dict: Mapping[str, Any], backbone: str = "resnet18",
                        rng_seed: int = 0) -> Dict[str, torch.Tensor]:
    """A classifier state dict (``base.*``, ``head.<index>.*``) with every
    entry it lacks, or holds at another shape (with a warning), taken from
    a fresh classifier with flax's default init drawn from ``rng_seed``."""
    with torch.random.fork_rng(devices=[]):  # the constructor's own draws
        fresh = BinaryClassifier(backbone)
    flax_default_init_(fresh, torch.Generator().manual_seed(rng_seed))
    out = {}
    for k, ref in fresh.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        got = state_dict.get(k)
        if got is not None and tuple(np.shape(got)) == tuple(ref.shape):
            out[k] = torch.as_tensor(np.asarray(got, np.float32))
        else:
            if got is not None:
                log.warning("shape mismatch at %s: ckpt %s vs model %s; using fresh init", k,
                            tuple(np.shape(got)), tuple(ref.shape))
            out[k] = ref
    return out


def _load_submodel(path: str):
    """(classifier state dict, extras) from a ``.pth``/``.pt`` or a native
    trainer file (flavor 'trainer' for the latter)."""
    if path.endswith((".pth", ".pt")):
        return serialization.load_submodel_torch(path)
    tree, meta = serialization.load_native(path)
    variables = tree["variables"] if "variables" in tree else tree
    extras = dict(meta or {})
    extras.setdefault("flavor", "trainer")
    return torch_compat.torch_state_dict_from_variables(variables), extras


def _load_backbone_donor(path: str, backbone: str = "resnet18") -> Dict[str, torch.Tensor]:
    """The ``base.*`` entries of a donor checkpoint (``.pth``/``.pt`` of any
    flavor, or native), completed: the stand-in for the reference merger's
    ImageNet backbone (timm's download)."""
    sd, _ = _load_submodel(path)
    return {k: v for k, v in _complete_variables(sd, backbone).items() if k.startswith("base.")}


def merge_models(
    submodels_folder: str,
    csv_path: str,
    backbone: str = "resnet18",
    smoke_test: bool = True,
    reference_semantics: bool = False,
    backbone_weights: Optional[str] = None,
    device: str = "cuda",
) -> MultiHeadEnsemble:
    """The ensemble of a recipe's sub-models, on ``device``.

    ``reference_semantics`` reproduces the reference merger's
    ``load_state_dict(sd, strict=False)``: a reference-trainer checkpoint
    (unprefixed backbone keys) contributes only its head and the backbone
    comes from ``backbone_weights`` (required); checkpoints with ``base.*``
    keys load whole either way. The default imports trainer backbones too."""
    if reference_semantics and not backbone_weights:
        raise ValueError(
            "--reference-merge-semantics requires --backbone-weights: the reference merger "
            "takes backbone weights from timm's ImageNet download; supply an equivalent donor "
            "checkpoint (.pth or native) to stand in for it.")
    dev = resolve_device(device)
    rows = read_merge_recipe(csv_path)
    donor = _load_backbone_donor(backbone_weights, backbone) if reference_semantics else None
    state_dicts, synthetic_names, real_names = [], [], []
    for row in rows:
        path = os.path.join(submodels_folder, row["model_filename"])
        sd, extras = _load_submodel(path)
        if donor is not None and extras.get("flavor") == "trainer":
            # strict=False: a trainer backbone does not match 'base.*'; only the head loads
            sd = {**donor, **{k: v for k, v in sd.items() if k.startswith("head.")}}
        state_dicts.append(_complete_variables(sd, backbone))
        synthetic_names.append(row["synthetic_class"] or f"Synthetic_{len(synthetic_names) + 1}")
        real_names.append(row["real_class"] or "Real")
        log.info("loaded %s (epoch=%s best_acc=%s)", path, extras.get("epoch"),
                 extras.get("best_acc"))

    class_names = synthetic_names + [resolve_real_name(real_names)]
    ens = build_ensemble(state_dicts, class_names, backbone).to(dev)
    if smoke_test:
        # the reference's smoke test: a random [2, 3, 512, 512] forward
        g = torch.Generator(dev).manual_seed(0)
        out = ens(torch.randn((2, 3, 512, 512), generator=g, device=dev))
        if out.shape != (2, len(class_names)) or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"merged ensemble smoke test: output {tuple(out.shape)}")
        log.info("smoke test output shape: %s", tuple(out.shape))
    return ens


def save_merged(ensemble: MultiHeadEnsemble, output_path: str,
                torch_format: Optional[bool] = None) -> None:
    """A ``.pth``/``.pt`` path (or ``torch_format=True``): the reference's
    torch contract; otherwise native msgpack."""
    if torch_format is None:
        torch_format = output_path.endswith((".pth", ".pt"))
    if torch_format:
        serialization.save_merged_torch(output_path, ensemble)
    else:
        serialization.save_merged_native(output_path, ensemble)
