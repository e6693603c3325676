"""Multi-head ensemble (the reference package's ``ensemble/multihead.py``).

N binary sub-models vote: output [B, N+1] = [syn_1..syn_N, mean(real_1..N)]
with index 0 = Real and 1 = Synthetic per sub-model. Three layouts:

- shared backbone: every sub-model's backbone is the same (what reference
  merged checkpoints hold), so it runs once and only the heads differ;
- shared trunk: the sub-models agree on the stem and every stage but the
  last K (the joint trainer's per-head-stages artifacts), so the trunk
  runs once and each head runs its own K-stage tail on the trunk's
  features (``trunk_shared_stages``, as the reference detects it);
- dense: N independent backbones, one pass each.

The N MLP heads always run batched: their weights are stacked with each
eval BatchNorm folded into the Linear before it, and each layer is one
``torch.baddbmm`` over the head axis.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Mapping, Optional, Sequence

import torch
import torch.nn as nn

from synthetic_audio_detection_tpu_torch.models.classifier import (
    REAL_INDEX,
    SYNTHETIC_INDEX,
)
from synthetic_audio_detection_tpu_torch.models.fast_resnet import FastResNet
from synthetic_audio_detection_tpu_torch.models.head import BinaryHead
from synthetic_audio_detection_tpu_torch.models.resnet import ResNet, create_resnet, fold_rgb_conv
from synthetic_audio_detection_tpu_torch.parallel.sharding import MODEL_AXIS


class MultiHeadEnsemble(nn.Module):
    """``backbones`` holds one module (shared layout) or one per head
    (dense, or with ``trunk`` given, each head's tail of stages
    ``first_stage``.. on the trunk's features).
    ``class_names`` = [syn_1, ..., syn_N, real]; a generic-head
    ensemble carries one extra head (the generic Real-vs-any-synthetic
    vote) after the specialists. ``dtype`` is the compute dtype; parameters
    stay float32 and compute-dtype copies are made once, at first use."""

    def __init__(self, backbones: Sequence[ResNet], heads: Sequence[BinaryHead],
                 class_names: Sequence[str], backbone: str = "resnet18",
                 calibration: Optional[Dict[str, Any]] = None,
                 generic_head: bool = False, dtype: torch.dtype = torch.float32,
                 trunk: Optional[ResNet] = None):
        super().__init__()
        self.trunk = trunk
        self.backbones = nn.ModuleList(backbones)
        self.heads = nn.ModuleList(heads)
        self.class_names = list(class_names)
        self.backbone_name = backbone
        self.calibration = calibration
        self.generic_head = generic_head
        self.dtype = dtype
        if len(self.heads) != self.num_heads:
            raise ValueError(f"{len(self.heads)} heads for {self.num_heads} columns "
                             f"({self.class_names}, generic_head={generic_head})")
        if len(self.backbones) not in (1, self.num_heads):
            raise ValueError(f"{len(self.backbones)} backbones for {self.num_heads} heads")
        if trunk is not None and len(self.backbones) != self.num_heads:
            raise ValueError(f"a shared trunk needs one tail per head, got {len(self.backbones)}")
        self._compiled: Dict[tuple, Any] = {}
        self.eval()

    @property
    def num_heads(self) -> int:
        return len(self.class_names) - 1 + int(self.generic_head)

    @property
    def shared_backbone(self) -> bool:
        return len(self.backbones) == 1 and self.trunk is None

    @property
    def shared_trunk_stages(self) -> int:
        """K, the per-head stages after the shared trunk (0: no trunk)."""
        if self.trunk is None:
            return 0
        return len(self.trunk.stage_sizes) - self.trunk.last_stage

    @property
    def in_channels(self) -> int:
        return (self.trunk or self.backbones[0]).in_channels

    @property
    def synthetic_names(self) -> List[str]:
        return self.class_names[:-1]

    @property
    def real_name(self) -> str:
        return self.class_names[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _aggregate(ensemble_per_head_logits(self, x))

    def classifier_state_dicts(self) -> List[Dict[str, torch.Tensor]]:
        """Per-sub-model state dicts in the reference key space
        (``base.*``, ``head.<index>.*``)."""
        out = []
        for i, head in enumerate(self.heads):
            base = self.backbones[0 if self.shared_backbone else i]
            sd = {} if self.trunk is None else {
                f"base.{k}": v for k, v in self.trunk.state_dict().items()}
            sd.update({f"base.{k}": v for k, v in base.state_dict().items()})
            sd.update({f"head.{k}": v for k, v in head.state_dict().items()})
            out.append(sd)
        return out

    def _cached(self, key: tuple, make):
        device = next(self.parameters()).device
        key = key + (self.dtype, device)
        if key not in self._compiled:
            self._compiled[key] = make()
        return self._compiled[key]

    def compute_backbone(self, i: int, fast: bool = False, conv3x3_max_channels: int = 0):
        """Backbone i in the compute dtype: the module itself in float32, a
        dtype copy otherwise, or the FastResNet (the reference's
        ``_conv_bn`` numerics; its convs with at most
        ``conv3x3_max_channels`` input channels run through the
        hand-written conv kernel)."""
        if fast:
            return self._cached(("fast", i, conv3x3_max_channels), lambda: FastResNet(
                self.backbones[i], self.dtype, conv3x3_max_channels))
        return self._compute_copy(("copy", i), self.backbones[i])

    def compute_trunk(self) -> ResNet:
        """The shared trunk in the compute dtype (the plain ResNet, as the
        reference runs it)."""
        return self._compute_copy(("trunk",), self.trunk)

    def _compute_copy(self, key: tuple, net: ResNet) -> ResNet:
        if next(net.parameters()).dtype == self.dtype:  # float32, or cast by in_compute_dtype
            return net
        return self._cached(key, lambda: copy.deepcopy(net).to(
            dtype=self.dtype, memory_format=torch.channels_last))

    def stacked_heads(self) -> List[tuple]:
        return self._cached(("heads",), lambda: stack_heads(self.heads, self.dtype))


@torch.no_grad()
def stack_heads(heads: Sequence[BinaryHead], dtype: torch.dtype) -> List[tuple]:
    """[(W [N, out, in], b [N, out], relu), ...] per Linear of the N heads,
    with each following eval BatchNorm folded in."""
    layers = []
    mods = list(heads[0])
    for j, mod in enumerate(mods):
        if not isinstance(mod, nn.Linear):
            continue
        ws, bs = [], []
        for h in heads:
            lin = h[j]
            w, b = lin.weight, lin.bias
            if j + 1 < len(mods) and isinstance(h[j + 1], nn.BatchNorm1d):
                bn = h[j + 1]
                alpha = bn.weight / torch.sqrt(bn.running_var + bn.eps)
                w = w * alpha[:, None]
                b = (b - bn.running_mean) * alpha + bn.bias
            ws.append(w)
            bs.append(b)
        relu = j + 1 < len(mods) and isinstance(mods[j + 1], nn.BatchNorm1d)
        layers.append((torch.stack(ws).to(dtype), torch.stack(bs).to(dtype), relu))
    return layers


def heads_forward(layers: List[tuple], pooled: torch.Tensor) -> torch.Tensor:
    """pooled [N, B, F] → logits [N, B, num_outputs] (dropout is identity in
    eval)."""
    x = pooled
    for w, b, relu in layers:
        x = torch.baddbmm(b[:, None, :], x, w.transpose(1, 2))
        if relu:
            x = torch.relu(x)
    return x


@torch.no_grad()
def ensemble_per_head_logits(ens: MultiHeadEnsemble, x: torch.Tensor,
                             fast_backbone: bool = False,
                             conv3x3_max_channels: int = 0,
                             s2d_stage1: bool = False) -> torch.Tensor:
    """x [B, C, H, W] → per-head logits [N, B, 2] (before aggregation).
    ``fast_backbone`` runs a shared backbone through the FastResNet, with
    ``conv3x3_max_channels`` as its kernel knob (no effect without
    ``fast_backbone`` or on a dense layout). ``s2d_stage1`` runs the plain
    backbones' stage 1 in space-to-depth form (``models/resnet.py``); the
    FastResNet does not read it, as the reference's fast path does not
    read the model's flag."""
    x = x.to(ens.dtype)
    fast = fast_backbone and ens.shared_backbone
    if ens.dtype != torch.float32 and not fast:  # FastResNet lays out its own input
        x = x.contiguous(memory_format=torch.channels_last)
    n = ens.num_heads
    if ens.shared_backbone:
        net = ens.compute_backbone(0, fast=fast, conv3x3_max_channels=conv3x3_max_channels)
        feats = net(x) if fast else net(x, s2d_stage1=s2d_stage1)
        pooled = feats.mean(dim=(2, 3)).expand(n, -1, -1)
    elif ens.trunk is not None:
        feats = ens.compute_trunk()(x, s2d_stage1=s2d_stage1)
        pooled = torch.stack([ens.compute_backbone(i)(feats).mean(dim=(2, 3))
                              for i in range(n)])
    else:
        pooled = torch.stack([ens.compute_backbone(i)(x, s2d_stage1=s2d_stage1).mean(dim=(2, 3))
                              for i in range(n)])
    return heads_forward(ens.stacked_heads(), pooled)


@torch.no_grad()
def head_parallel_logits(mesh, shard: MultiHeadEnsemble, x: torch.Tensor) -> torch.Tensor:
    """The head-parallel forward: x [B, C, H, W] → [B, N+1] logits of the
    whole ensemble from ``shard``, this rank's heads
    (``parallel.sharding.shard_ensemble_heads``): their per-head logits,
    one all-gather over ``model``, then ``_aggregate``."""
    return _aggregate(mesh.all_gather(ensemble_per_head_logits(shard, x), MODEL_AXIS))


def _aggregate(logits_nh: torch.Tensor) -> torch.Tensor:
    """[N, B, 2] per-head logits → [B, N+1] = [syn_1..syn_N, mean(real)].
    For a generic-head ensemble N counts the generic head: its synthetic
    logit is column N_spec and its real logit joins the mean."""
    syn = logits_nh[:, :, SYNTHETIC_INDEX].transpose(0, 1)
    real_mean = logits_nh[:, :, REAL_INDEX].mean(dim=0)[:, None]
    return torch.cat([syn, real_mean], dim=1)


def _base_state(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k[len("base."):]: v for k, v in sd.items()
            if k.startswith("base.") and not k.endswith("num_batches_tracked")}


def backbones_identical(state_dicts: Sequence[Mapping[str, torch.Tensor]],
                        atol: float = 0.0) -> bool:
    """True when every sub-model's ``base.*`` tensors agree (allclose at
    rtol 1e-5 and ``atol``, as the reference package compares)."""
    if len(state_dicts) <= 1:
        return True
    first = _base_state(state_dicts[0])
    for sd in state_dicts[1:]:
        other = _base_state(sd)
        if other.keys() != first.keys():
            return False
        for k, a in first.items():
            b = other[k]
            if a.shape != b.shape or not torch.allclose(
                    torch.as_tensor(a).double(), torch.as_tensor(b).double(), rtol=1e-5, atol=atol):
                return False
    return True


def _stage_of(key: str) -> int:
    """The stage of a backbone key (``layer3.1.conv1.weight`` → 3), 0 for
    the stem."""
    return int(key.split(".")[0][len("layer"):]) if key.startswith("layer") else 0


def trunk_shared_stages(state_dicts: Sequence[Mapping[str, torch.Tensor]],
                        atol: float = 0.0) -> int:
    """The smallest K (the largest trunk) such that every ``base.*`` tensor
    outside the last K stages agrees across the sub-models (allclose at
    rtol 1e-5 and ``atol``, as ``backbones_identical``), trying K = 1
    first as the reference does; 0 when even the stem or the first stages
    differ."""
    if len(state_dicts) <= 1:
        return 0
    bases = [_base_state(sd) for sd in state_dicts]
    n_stages = max((_stage_of(k) for k in bases[0]), default=0)
    if n_stages < 2:
        return 0
    for k in range(1, n_stages):
        trunk = [{key: v for key, v in b.items() if _stage_of(key) <= n_stages - k}
                 for b in bases]
        if backbones_identical([{f"base.{key}": v for key, v in t.items()} for t in trunk],
                               atol):
            return k
    return 0


def _load(module: nn.Module, sd: Mapping[str, torch.Tensor], what: str) -> None:
    """load_state_dict that tolerates only missing ``num_batches_tracked``
    (state dicts converted from the JAX package have none)."""
    missing, unexpected = module.load_state_dict(
        {k: torch.as_tensor(v) for k, v in sd.items()}, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(f"{what}: missing keys {missing[:5]}, unexpected keys {unexpected[:5]}")


def build_ensemble(state_dicts: Sequence[Mapping[str, torch.Tensor]],
                   class_names: Sequence[str], backbone: str = "resnet18",
                   detect_shared_backbone: bool = True, generic_head: bool = False,
                   calibration: Optional[Dict[str, Any]] = None,
                   shared_trunk_stages: Optional[int] = None) -> MultiHeadEnsemble:
    """Sub-model state dicts (``base.*`` + ``head.<index>.*``) → ensemble.
    The shared layout is chosen when every backbone agrees; otherwise the
    shared-trunk layout when ``trunk_shared_stages`` finds a trunk, or
    with ``shared_trunk_stages`` K > 0 given (a checkpoint's record), the
    first sub-model's trunk without the scan."""
    if generic_head and len(state_dicts) != len(class_names):
        raise ValueError(
            f"generic-head ensemble needs {len(class_names)} stacked heads "
            f"(specialists + generic), got {len(state_dicts)}")
    shared = detect_shared_backbone and backbones_identical(state_dicts)
    trunk_k = 0
    if not shared and shared_trunk_stages is not None:
        trunk_k = shared_trunk_stages
    elif not shared and detect_shared_backbone:
        trunk_k = trunk_shared_stages(state_dicts)
    in_channels = int(torch.as_tensor(state_dicts[0]["base.conv1.weight"]).shape[1])
    trunk, first = None, 1
    if trunk_k:
        t_last = len(create_resnet(backbone, in_channels).stage_sizes) - trunk_k
        trunk = create_resnet(backbone, in_channels, last_stage=t_last)
        _load(trunk, {k: v for k, v in _base_state(state_dicts[0]).items()
                      if _stage_of(k) <= t_last}, "shared trunk")
        first = t_last + 1
    backbones = []
    for i, sd in enumerate(state_dicts[:1] if shared else state_dicts):
        net = create_resnet(backbone, in_channels, first_stage=first)
        _load(net, {k: v for k, v in _base_state(sd).items() if _stage_of(k) >= first
                    or first == 1}, f"sub-model {i} backbone")
        backbones.append(net)
    heads = []
    for i, sd in enumerate(state_dicts):
        head = BinaryHead(backbones[0].num_features)
        _load(head, {k[len("head."):]: v for k, v in sd.items() if k.startswith("head.")},
              f"sub-model {i} head")
        heads.append(head)
    return MultiHeadEnsemble(backbones, heads, class_names, backbone,
                             calibration=calibration, generic_head=generic_head, trunk=trunk)


def _rebuild(ens: MultiHeadEnsemble, backbones=None, dtype=None,
             trunk=None) -> MultiHeadEnsemble:
    return MultiHeadEnsemble(
        list(ens.backbones) if backbones is None else backbones, list(ens.heads),
        ens.class_names, ens.backbone_name, calibration=ens.calibration,
        generic_head=ens.generic_head, dtype=ens.dtype if dtype is None else dtype,
        trunk=ens.trunk if trunk is None else trunk)


def with_dtype(ens: MultiHeadEnsemble, dtype: torch.dtype) -> MultiHeadEnsemble:
    """The same modules with ``dtype`` as the compute dtype (parameters
    stay float32)."""
    return _rebuild(ens, dtype=dtype)


def in_compute_dtype(ens: MultiHeadEnsemble) -> MultiHeadEnsemble:
    """A copy of the ensemble whose backbones (and trunk) are registered in
    the compute dtype, as ``compute_backbone`` and ``compute_trunk`` would
    copy them, so that a trace of its forward finds every weight among its
    parameters, once, and makes no copy of its own (infer/export.py). The
    heads stay float32: their stacking is part of the forward."""
    def cast(net: ResNet) -> ResNet:
        net = copy.deepcopy(net)
        if ens.dtype == torch.float32:
            return net
        return net.to(dtype=ens.dtype, memory_format=torch.channels_last)

    return MultiHeadEnsemble(
        [cast(net) for net in ens.backbones], [copy.deepcopy(h) for h in ens.heads],
        ens.class_names, ens.backbone_name, calibration=ens.calibration,
        generic_head=ens.generic_head, dtype=ens.dtype,
        trunk=None if ens.trunk is None else cast(ens.trunk))


@torch.no_grad()
def fold_to_mono(ens: MultiHeadEnsemble) -> MultiHeadEnsemble:
    """Exact stem transform: the serving input repeats one channel three
    times, so summing conv1's kernel over its input axis gives a 1-channel
    ensemble with the same logits. Feed it [B, 1, H, W]. The stem is the
    trunk's where the ensemble has one."""

    def mono(net: ResNet) -> ResNet:
        out = copy.deepcopy(net)
        conv = nn.Conv2d(1, net.conv1.out_channels, 7, 2, 3, bias=False).to(net.conv1.weight)
        conv.weight.copy_(fold_rgb_conv(net.conv1.weight))
        out.conv1 = conv
        out.in_channels = 1
        return out

    if ens.trunk is not None:
        return _rebuild(ens, trunk=mono(ens.trunk))
    return _rebuild(ens, backbones=[mono(net) for net in ens.backbones])


# ---------------------------------------------------------------------------
# Decision rule
# ---------------------------------------------------------------------------

def decide(logits: torch.Tensor, threshold: float = 0.5) -> Dict[str, torch.Tensor]:
    """[B, N+1] logits → probs (elementwise sigmoid), label_idx (N = Real)
    and is_real: Real iff sigmoid(real_mean) >= threshold and every
    synthetic sigmoid < threshold; otherwise the argmax synthetic head."""
    probs = torch.sigmoid(logits)
    syn, real = probs[:, :-1], probs[:, -1]
    is_real = (real >= threshold) & torch.all(syn < threshold, dim=1)
    n = logits.shape[1] - 1
    label_idx = torch.where(is_real, torch.full_like(real, n, dtype=torch.long),
                            torch.argmax(syn, dim=1))
    return {"probs": probs, "label_idx": label_idx, "is_real": is_real}


def labels_from_indices(label_idx, synthetic_names: List[str], real_name: str) -> List[str]:
    n = len(synthetic_names)
    out = []
    for i in label_idx:
        i = int(i)
        if i == n:
            out.append(real_name)
        elif i < n:
            out.append(synthetic_names[i])
        else:  # unreachable, mirrors the reference's fallback naming
            out.append(f"Synthetic_{i + 1}")
    return out
