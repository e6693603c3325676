"""Carry weights from the JAX package into the port.

Input is the JAX package's variable tree as numpy (``{'params', 'batch_stats'}``
as ``jax.tree_util.tree_map(np.asarray, variables)`` gives it); output is the
port's state dict in the reference key space (``base.*``,
``head.<index>.*``), a whole ensemble, or a joint trainer's state. The
layout transposes are the reference package's ``torch_compat`` map, copied
into this package.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from synthetic_audio_detection_tpu_torch.checkpoints.torch_compat import (
    torch_state_dict_from_variables,
)
from synthetic_audio_detection_tpu_torch.ensemble.multihead import (
    MultiHeadEnsemble,
    build_ensemble,
)


def classifier_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """One classifier's JAX variables → the port's state dict."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in torch_state_dict_from_variables(variables).items()}


def _index(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def ensemble_from_variables(
    stacked: Dict[str, Any],
    class_names: Sequence[str],
    backbone: str = "resnet18",
    generic_head: bool = False,
    detect_shared_backbone: bool = True,
    calibration: Optional[Dict[str, Any]] = None,
) -> MultiHeadEnsemble:
    """A JAX ``MultiHeadEnsemble``'s stacked variables (leading head axis)
    → the port's ensemble."""
    n = len(class_names) - 1 + int(generic_head)
    sds = [classifier_state_dict(_index(stacked, i)) for i in range(n)]
    return build_ensemble(sds, class_names, backbone,
                          detect_shared_backbone=detect_shared_backbone,
                          generic_head=generic_head, calibration=calibration)


def joint_state_from_jax(state, variables: Dict[str, Any], adam: Any, step: int) -> None:
    """A JAX ``JointTrainState``'s variables (``{'params', 'batch_stats'}``
    of ``{'base', 'heads'}``, numpy) and its Adam ``(count, mu, nu)`` (as
    the JAX package's ``steps.extract_adam_state`` gives them, numpy) → the
    port's joint ``TrainState`` (``train/joint.py:init_joint_state``), in
    place, with the step counter."""
    from synthetic_audio_detection_tpu_torch.train.joint import load_joint_state_

    count, mu, nu = adam
    load_joint_state_(state, variables, int(count), mu, nu, step)
