"""Joint multi-head ensemble training: N heads on one backbone pass (the
reference package's ``train/joint.py``), on a GPU.

Every batch goes once through the shared trunk and then through each head
(with ``per_head_stages`` K > 0, each head's own trailing K ResNet stages
first, then its MLP). Head i's positive is corpus class i + 1; Real and the
other generators are its negatives (hard negatives), or, without hard
negatives, its loss and statistics see only Real and its own class. A
generic Real-vs-any-synthetic head, when asked for, is the last head. The
loss is the mean of the N per-head cross-entropies, and one optimizer step
(``train/steps.py:apply_update_``: one global-norm clip over the trunk and
every head together, optax's AdamW, the NaN-skip) updates them all.

The freeze schedule is the submodel trainer's for the trunk (layer4, then
layer3 at epochs // 3); every head, its tail included, is always
trainable. ``stop_grad_stage`` is an absolute stage and applies inside
whichever slice it falls in, so with K = 2 in phase 1 a tail's layer3 runs
without autograd: its gradient is zero and AdamW still decays it, as the
reference's masked step does.

The eval step takes the train step's mel (``dft_mode``), as the
reference's does: under ``--bf16`` on the card the log-mel kernel runs in
validation too, on float32 audio (the eval step dequantizes int16 first).
Its ensemble verdict aggregates the specialist heads only and, with a
generic head, its detector score is that head's synthetic probability: the
reference's rule, kept so that both packages pick the same best epoch
(serving's ``_aggregate`` includes the generic head).

The saved artifact is the resume file (native, ``sad-tpu-joint-v1``) and
the merged ensemble in both formats, whose heads share the trunk bit for
bit (or, with K > 0, the trunk-shared layout serving runs).
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from synthetic_audio_detection_tpu_torch.checkpoints import serialization
from synthetic_audio_detection_tpu_torch.data import dataset as ds
from synthetic_audio_detection_tpu_torch.ensemble import multihead
from synthetic_audio_detection_tpu_torch.models.head import (
    BinaryHead,
    set_dropout_generator,
    skip_dropout_draws,
)
from synthetic_audio_detection_tpu_torch.models.init import flax_default_init_
from synthetic_audio_detection_tpu_torch.models.resnet import (
    RESNET_SPECS,
    ResNet,
    create_resnet,
    sync_batch_stats,
)
from synthetic_audio_detection_tpu_torch.parallel import sharding as sh
from synthetic_audio_detection_tpu_torch.train import steps
from synthetic_audio_detection_tpu_torch.train.plateau import PlateauState
from synthetic_audio_detection_tpu_torch.train.trainer import StepTrainer
from synthetic_audio_detection_tpu_torch.utils import metrics as metrics_mod
from synthetic_audio_detection_tpu_torch.utils.config import (
    SpecAugmentConfig,
    SpectrogramConfig,
    TrainConfig,
)
from synthetic_audio_detection_tpu_torch.utils.profiling import span

log = logging.getLogger(__name__)

FORMAT = "sad-tpu-joint-v1"


def trunk_last_stage(model_name: str, per_head_stages: int) -> int:
    """1-based index of the last shared backbone stage."""
    n_stages = len(RESNET_SPECS[model_name][1])
    if not 0 <= per_head_stages < n_stages:
        raise ValueError(f"per_head_stages must be in [0, {n_stages - 1}], got {per_head_stages}")
    return n_stages - per_head_stages


class TailHead(nn.Module):
    """One head with its own trailing stages: ``tail`` (a stage slice of
    the ResNet, the full model's names) then ``mlp``."""

    def __init__(self, model_name: str, first_stage: int):
        super().__init__()
        self.tail = create_resnet(model_name, 3, first_stage=first_stage)
        self.mlp = BinaryHead(self.tail.num_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(self.tail(x))


class JointModel(nn.Module):
    """``base`` (the shared trunk, stages 1 … n − K) and ``heads`` (N
    ``BinaryHead``s, or N ``TailHead``s with K > 0); x → [N, B, 2] logits.
    Parameter names are ``base.*`` and ``heads.<i>.*``, so the submodel
    trainer's freeze masks hold every head trainable.

    ``head_range`` (h0, h1, N), set by ``shard_joint_state``: the model
    holds heads h0 … h1 − 1 of N (its ``heads.<j>`` is head h0 + j) and
    returns their logits; for each head it does not hold it draws and drops
    the head's random numbers, so the step's generator moves as with all N."""

    head_range: Optional[Tuple[int, int, int]] = None

    def __init__(self, model_name: str, num_heads: int, per_head_stages: int = 0):
        super().__init__()
        t_last = trunk_last_stage(model_name, per_head_stages)
        self.per_head_stages = per_head_stages
        self.base = create_resnet(model_name, 3, last_stage=t_last)
        self.heads = nn.ModuleList(
            TailHead(model_name, t_last + 1) if per_head_stages
            else BinaryHead(self.base.num_features) for _ in range(num_heads))

    def slices(self) -> List[ResNet]:
        """The trunk and every head's tail."""
        return [self.base] + [h.tail for h in self.heads if isinstance(h, TailHead)]

    def set_stop_grad_stage(self, stage: int) -> None:
        for net in self.slices():
            net.stop_grad_stage = stage

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.base(x)
        if self.head_range is None:
            return torch.stack([head(feats) for head in self.heads])
        h0, h1, n = self.head_range
        out = []
        for i in range(n):
            if h0 <= i < h1:
                out.append(self.heads[i - h0](feats))
            else:
                skip_dropout_draws(self.heads[0], feats.shape[0], feats.device)
        return torch.stack(out)


def _child(generator: torch.Generator) -> torch.Generator:
    return torch.Generator().manual_seed(int(torch.randint(2 ** 62, (1,), generator=generator)))


def init_joint_state(model_name: str, num_heads: int, generator: torch.Generator,
                     cfg: TrainConfig, per_head_stages: int = 0,
                     device: torch.device = torch.device("cpu")) -> steps.TrainState:
    """A fresh joint model with flax's default init: the trunk from
    ``generator`` (a CPU generator), each head from its own generator drawn
    from it (with K > 0, its tail and its MLP each from their own); zero
    moments, the phase-1 mask (heads always trainable), lr scale 1."""
    with torch.random.fork_rng(devices=[]):  # the constructors' own draws
        model = JointModel(model_name, num_heads, per_head_stages)
    head_gens = [_child(generator) for _ in range(num_heads)]
    flax_default_init_(model.base, generator)
    for head, g in zip(model.heads, head_gens):
        if isinstance(head, TailHead):
            tail_g, mlp_g = _child(g), _child(g)
            flax_default_init_(head.tail, tail_g)
            flax_default_init_(head.mlp, mlp_g)
        else:
            flax_default_init_(head, g)
    model = model.to(device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return steps.create_train_state(model, cfg)


def joint_freeze_mask(state: steps.TrainState, phase2: bool) -> None:
    """The trunk follows the freeze schedule (layer4, then layer3 too);
    every head is trainable."""
    state.set_phase(steps.PHASE2_PREFIXES if phase2 else steps.PHASE1_PREFIXES)


def shard_joint_state(state: steps.TrainState, mesh: sh.Mesh) -> steps.TrainState:
    """This rank's part of a joint state for a mesh with heads along
    ``model`` (the layout of the reference's head-parallel step): the
    trunk whole, heads [h0, h1) (``sharding.head_slice``), their moments
    and mask entries; the model changed in place. Raises ValueError when
    the heads do not split over the model axis."""
    model = state.model
    n = len(model.heads)
    h0, h1 = sh.head_slice(mesh, n)
    model.heads = nn.ModuleList(list(model.heads)[h0:h1])
    model.head_range = (h0, h1, n)
    full = {name: i for i, name in enumerate(state.names)}
    names = [name for name, _ in model.named_parameters()]
    src = [full[global_head_name(name, h0)] for name in names]
    return steps.TrainState(
        model=model, names=names, mu=[state.mu[i] for i in src], nu=[state.nu[i] for i in src],
        mask=[state.mask[i] for i in src], count=state.count, step=state.step,
        lr_scale=state.lr_scale, lr=state.lr)


def global_head_name(name: str, h0: int) -> str:
    """``heads.<j>.*`` of a sharded model → ``heads.<h0 + j>.*``."""
    if not name.startswith("heads."):
        return name
    _, j, rest = name.split(".", 2)
    return f"heads.{int(j) + h0}.{rest}"


def load_joint_state_(state: steps.TrainState, variables: Dict[str, Any], count: int,
                      mu: Dict[str, Any], nu: Dict[str, Any], step: int,
                      lr: Optional[float] = None) -> None:
    """Weights and BN statistics from reference-layout ``variables`` (numpy
    trees ``{'params', 'batch_stats'}`` of ``{'base', 'heads'}``), the Adam
    count and moments from reference-layout trees, the step counter and
    (when given) the last applied lr, into ``state`` in place."""
    named = serialization.joint_named(variables)
    missing, unexpected = state.model.load_state_dict(
        {k: torch.as_tensor(np.array(v, np.float32)) for k, v in named.items()}, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(f"joint state does not fit the model: missing {missing[:5]}, "
                         f"unexpected {unexpected[:5]}")
    by_name = lambda t: serialization.joint_named({"params": t})  # noqa: E731
    state.set_moments(count, by_name(mu), by_name(nu))
    device = state.count.device
    state.step = torch.tensor(int(step), device=device)
    if lr is not None:
        state.lr = torch.tensor(float(lr), dtype=torch.float32, device=device)


def per_head_own_mask(labels: torch.Tensor, num_heads: int, weights: Optional[torch.Tensor],
                      generic_head: bool = False) -> torch.Tensor:
    """[N, B] 0/1: head i sees only Real and its own class (the generic
    head, last, every row), times the pad mask when given."""
    n_spec = num_heads - int(generic_head)
    heads = torch.arange(1, n_spec + 1, device=labels.device)[:, None]
    w = ((labels[None, :] == 0) | (labels[None, :] == heads)).float()
    if generic_head:
        w = torch.cat([w, torch.ones((1, labels.shape[0]), device=labels.device)])
    if weights is not None:
        w = w * weights.float()[None, :]
    return w


def per_head_binary_labels(labels: torch.Tensor, num_heads: int,
                           generic_head: bool = False) -> torch.Tensor:
    """Corpus labels (0 Real, i + 1 synthetic class i) → [N, B] binary
    targets: head i's positive iff the label is i + 1; the generic head's
    (last) iff the label is not 0."""
    n_spec = num_heads - int(generic_head)
    heads = torch.arange(1, n_spec + 1, device=labels.device)[:, None]
    y = (labels[None, :] == heads).long()
    if generic_head:
        y = torch.cat([y, (labels[None, :] != 0).long()])
    return y


def joint_loss(logits_nb: torch.Tensor, y_nb: torch.Tensor, weights: Optional[torch.Tensor],
               w_nb: Optional[torch.Tensor], total_weights: Optional[torch.Tensor] = None,
               num_heads: Optional[int] = None) -> tuple:
    """(the mean of the N per-head cross-entropies, the per-head losses);
    each head's rows weighted by ``w_nb[i]``, or by ``weights`` when
    ``w_nb`` is None (hard negatives). Under a mesh: ``total_weights``, the
    global Σw of each head ([1]: of ``weights``), divide instead, and the
    sum over the heads given is divided by ``num_heads``, all N of them."""
    per_head = torch.stack([
        steps.cross_entropy(logits_nb[i], y_nb[i], weights if w_nb is None else w_nb[i],
                            None if total_weights is None else total_weights[
                                0 if w_nb is None else i])
        for i in range(logits_nb.shape[0])])
    return per_head.sum() / (num_heads or logits_nb.shape[0]), per_head


def make_joint_train_step(
    cfg: TrainConfig,
    spec_cfg: SpectrogramConfig,
    augment: Optional[SpecAugmentConfig],
    num_heads: int,
    sample_rate: int = 32_000,
    stop_grad_stage: int = 0,
    dft_mode: Optional[str] = None,
    compute_dtype: torch.dtype = torch.float32,
    hard_negatives: bool = True,
    generic_head: bool = False,
    mesh: Optional[sh.Mesh] = None,
):
    """→ ``joint_step(state, batch, generator) -> metrics``, updating
    ``state`` (a ``JointModel``'s) in place. batch: {'audio': [B, T]
    float32 or int16, 'label': [B] corpus labels 0..N, 'weight': [B]
    (optional)} on the state's device. metrics: 'loss', 'per_head_loss',
    'per_head_accuracy', 'accuracy', 'skipped', device tensors.

    With ``mesh``, the batch is this rank's rows along ``data`` and the
    step is the one-process step on the global batch, as the submodel
    step's (``steps.make_train_step``). With a ``model`` axis > 1 the
    state must hold this rank's heads (``shard_joint_state``): the trunk's
    and the heads' BatchNorm statistics reduce over ``data`` (the ranks
    along ``model`` see the same rows), the heads' gradients sum over
    ``data`` and the trunk's over every rank, the clip's norm adds the
    heads' squares over ``model``, and the metrics (each rank's heads on
    its rows) sum over every rank."""

    def joint_step(state: steps.TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        model = state.model
        device = state.count.device
        h0, h1, _ = model.head_range or (0, num_heads, num_heads)
        if mesh is not None and mesh.size(sh.MODEL_AXIS) > 1 and model.head_range is None:
            raise ValueError("a mesh with a model axis needs the state's heads sharded "
                             "(shard_joint_state)")
        model.train()
        model.set_stop_grad_stage(stop_grad_stage)
        rows = None if mesh is None else mesh.rows(batch["audio"].shape[0])
        set_dropout_generator(model, generator, rows)
        sync_batch_stats(model, mesh)
        with steps._precision(torch.float32, device), span("train_step.features"):
            x = steps.features_from_waveforms(batch["audio"], spec_cfg, augment, generator,
                                              sample_rate, dft_mode=dft_mode, rows=rows)
        labels = batch["label"]
        weights = batch.get("weight")
        y_nb = per_head_binary_labels(labels, num_heads, generic_head)[h0:h1]
        w_nb = None if hard_negatives else per_head_own_mask(labels, num_heads, weights,
                                                             generic_head)[h0:h1]
        dens = None
        if mesh is not None:
            if weights is None:
                weights = torch.ones(labels.shape, device=device)
            dens = mesh.all_reduce(weights.float().sum()[None] if w_nb is None
                                   else w_nb.sum(1))
        buffers, saved = steps.save_buffers(model)
        params = state.params
        with steps._precision(compute_dtype, device), span("train_step.forward"):
            logits_nb = model(x)
            loss, per_head = joint_loss(logits_nb, y_nb, weights, w_nb, dens, num_heads)
        with span("train_step.backward"):
            grads = steps.gradients(loss, params, compute_dtype)
        norm_fn = None
        if mesh is not None:
            live = [i for i, m in enumerate(state.mask) if m]
            if model.head_range is None:
                grads = steps.sync_gradients(grads, live, mesh)
            else:
                is_head = [n.startswith("heads.") for n in state.names]
                grads = steps.sync_gradients(grads, [i for i in live if not is_head[i]], mesh,
                                             axis=None)
                grads = steps.sync_gradients(grads, [i for i in live if is_head[i]], mesh)
                norm_fn = _head_parallel_norm(mesh, is_head)
        correct = (torch.argmax(logits_nb, -1) == y_nb).float()
        if w_nb is not None:
            acc = (correct * w_nb).sum(1) / torch.clamp(w_nb.sum(1) if dens is None else dens,
                                                        min=1.0)
        elif weights is not None:
            w = weights.float()
            acc = (correct * w[None, :]).sum(1) / torch.clamp(w.sum() if dens is None else dens,
                                                              min=1.0)
        else:
            acc = correct.mean(1)
        if mesh is not None:
            # each rank's heads on its rows, placed among all N and summed
            # over every rank: the global per-head loss and accuracy
            both = torch.zeros((2, num_heads), device=device)
            both[0, h0:h1] = per_head.detach()
            both[1, h0:h1] = acc
            per_head, acc = mesh.all_reduce(both.reshape(-1), axis=None).view(2, num_heads)
            loss = per_head.sum() / num_heads
        with span("train_step.optimizer"):
            ok = steps.apply_update_(state, grads, loss, cfg, buffers, saved, norm_fn=norm_fn)
        return {"loss": loss.detach(), "per_head_loss": per_head.detach(),
                "per_head_accuracy": acc, "accuracy": acc.mean(), "skipped": (~ok).float()}

    return joint_step


def _head_parallel_norm(mesh: sh.Mesh, is_head: List[bool]):
    """The clip's global norm when each rank holds its heads: the trunk's
    squares (the same on every rank) plus the heads' summed over
    ``model``."""

    def norm(live: List[int], g: List[torch.Tensor]) -> torch.Tensor:
        def squares(ts):
            if not ts:
                return torch.zeros((), dtype=torch.float64, device=g[0].device)
            return torch.stack(steps.tensor_norms(ts)).square().sum()

        trunk = squares([t for i, t in zip(live, g) if not is_head[i]])
        heads = squares([t for i, t in zip(live, g) if is_head[i]])
        return torch.sqrt(trunk + mesh.all_reduce(heads[None], sh.MODEL_AXIS)[0])

    return norm


def make_joint_eval_step(
    spec_cfg: SpectrogramConfig,
    num_heads: int,
    sample_rate: int = 32_000,
    dft_mode: Optional[str] = None,
    compute_dtype: torch.dtype = torch.float32,
    hard_negatives: bool = True,
    generic_head: bool = False,
):
    """→ ``eval_step(model, batch)`` → per-head sufficient statistics and
    the ensemble verdict: 'loss_sum' [N], 'confusion' [N, 2, 2] (rows
    true, columns predicted; each head over its own rows), 'count',
    'ens_correct' (the aggregated verdict's attribution, specialist heads
    only), 'det_score' [B] and 'probs' [N, B, 2], device tensors. int16
    audio is dequantized before the features, so the mel sees float32."""

    @torch.no_grad()
    def eval_step(model: JointModel, batch: Dict[str, torch.Tensor]):
        model.eval()
        audio = batch["audio"]
        if not audio.is_floating_point():
            audio = audio.float() / 32768.0
        with steps._precision(torch.float32, audio.device):
            x = steps.features_from_waveforms(audio, spec_cfg, None, None, sample_rate,
                                              dft_mode=dft_mode)
        labels = batch["label"].long()
        weights = batch.get("weight")
        w = (weights if weights is not None else torch.ones_like(labels)).float()
        with steps._precision(compute_dtype, x.device):
            logits_nb = model(x)
        y_nb = per_head_binary_labels(labels, num_heads, generic_head)
        w_nb = (w[None, :].expand(y_nb.shape) if hard_negatives
                else per_head_own_mask(labels, num_heads, weights, generic_head))
        logp = F.log_softmax(logits_nb.float(), -1)
        nll = -logp.gather(-1, y_nb[..., None])[..., 0]
        pred = torch.argmax(logits_nb, -1)
        conf = torch.zeros((num_heads, 2, 2), device=x.device)
        head_idx = torch.arange(num_heads, device=x.device)[:, None].expand(y_nb.shape)
        conf.index_put_((head_idx, y_nb, pred), w_nb, accumulate=True)
        # the reference's verdict: the specialist heads only (see the module note)
        n_spec = num_heads - int(generic_head)
        agg = multihead._aggregate(logits_nb[:n_spec])
        verdict = multihead.decide(agg)
        true_idx = torch.where(labels == 0, n_spec, labels - 1)
        if generic_head:
            det_score = torch.softmax(logits_nb[-1].float(), -1)[:, multihead.SYNTHETIC_INDEX]
        else:
            det_score = 1.0 - torch.sigmoid(agg[:, -1].float())
        return {"loss_sum": (nll * w_nb).sum(1), "confusion": conf, "count": w.sum(),
                "ens_correct": ((verdict["label_idx"] == true_idx).float() * w).sum(),
                "det_score": det_score, "probs": torch.exp(logp)}

    return eval_step


@dataclass
class JointEpochResult:
    train_loss: float = 0.0
    val_loss: float = 0.0
    per_head_acc: List[float] = field(default_factory=list)
    ensemble_acc: float = 0.0
    val_auc: Optional[float] = None
    val_eer: Optional[float] = None
    confusion: Optional[np.ndarray] = None  # [N, 2, 2]


class JointTrainer(StepTrainer):
    """Ensemble-in-one-pass trainer. Corpus label 0 is ``real_class``;
    ``synthetic_classes[i]`` is label i + 1 and head i's positive.

    Runs on ``cuda`` unless ``device="cpu"`` (the default raises without a
    GPU). As the submodel trainer, ``--bf16`` on the card selects the
    log-mel kernel (here in the train and the eval step) and the int16
    transport. ``use_mesh`` and ``mesh``: the submodel trainer's
    data-parallel training (train/trainer.py), heads on every rank, as the
    reference's trainer lays them out."""

    def __init__(
        self,
        cfg: TrainConfig,
        synthetic_classes: List[str],
        real_class: str = "Real",
        model_name: str = "resnet18",
        spec_cfg: Optional[SpectrogramConfig] = None,
        augment: Optional[SpecAugmentConfig] = None,
        log_dir: Optional[str] = None,
        use_mesh: bool = True,
        per_head_stages: int = 0,
        hard_negatives: bool = True,
        generic_head: bool = False,
        device: str = "cuda",
        mesh: Optional[sh.Mesh] = None,
    ):
        if not synthetic_classes:
            raise ValueError("need at least one synthetic class")
        self._init_mesh(device, use_mesh, mesh)
        self.per_head_stages = per_head_stages
        self.hard_negatives = hard_negatives
        self.generic_head = generic_head
        self.cfg = cfg
        self.spec_cfg = spec_cfg or SpectrogramConfig.train()
        self.augment = augment or SpecAugmentConfig()
        self.real_class = real_class
        self.synthetic_classes = list(synthetic_classes)
        self.corpus_classes = [real_class] + self.synthetic_classes
        # the merged metadata: [syn_1..syn_N, real]; a generic head is an
        # extra head beyond the named classes
        self.class_names = self.synthetic_classes + [real_class]
        self.num_heads = len(self.synthetic_classes) + int(generic_head)
        self.model_name = model_name
        self.compute_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        self.state = init_joint_state(model_name, self.num_heads,
                                      torch.Generator().manual_seed(cfg.seed), cfg,
                                      per_head_stages, self.device)
        if self.mesh is not None:
            sh.replicate(self.mesh, self.state.model)
        self.generator = torch.Generator(self.device).manual_seed(cfg.seed)
        self.plateau = PlateauState(cfg.plateau_factor, cfg.plateau_patience)
        self.best_acc = 0.0
        self.start_epoch = 0
        self.layer3_unfrozen = False
        self.train_steps_run = 0
        self.eval_steps_run = 0
        bf16_on_card = self.compute_dtype == torch.bfloat16 and self.device.type == "cuda"
        self._transport = cfg.transport_dtype or ("int16" if bf16_on_card else "float32")
        self._dft = cfg.mel_dft or ("pallas" if bf16_on_card else None)
        self._train_step = self._build_train_step()
        self._eval_step = make_joint_eval_step(
            self.spec_cfg, self.num_heads, dft_mode=self._dft, compute_dtype=self.compute_dtype,
            hard_negatives=hard_negatives, generic_head=generic_head)
        self.writer = self._make_writer(
            log_dir or os.path.join("runs", f"joint_{int(time.time())}"))
        if cfg.resume:
            self.resume(cfg.resume)

    @property
    def model(self) -> JointModel:
        return self.state.model

    def _build_train_step(self):
        stage = 0
        if self.cfg.stop_grad_boundary:
            stage = 3 if self.layer3_unfrozen else 4
        return make_joint_train_step(
            self.cfg, self.spec_cfg, self.augment, self.num_heads, stop_grad_stage=stage,
            dft_mode=self._dft, compute_dtype=self.compute_dtype,
            hard_negatives=self.hard_negatives, generic_head=self.generic_head, mesh=self.mesh)

    def _unfreeze(self) -> None:
        joint_freeze_mask(self.state, phase2=True)
        self.layer3_unfrozen = True
        self._train_step = self._build_train_step()

    # -- checkpointing -------------------------------------------------------

    def named_state(self) -> Dict[str, np.ndarray]:
        """The model's parameters and BN statistics by name, float32 numpy."""
        return {k: v.detach().float().cpu().numpy() for k, v in self.model.state_dict().items()
                if not k.endswith("num_batches_tracked")}

    def variables(self) -> Dict[str, Any]:
        """{'params', 'batch_stats'} in the reference's joint layout."""
        return serialization.joint_tree(self.named_state())

    def to_ensemble(self) -> multihead.MultiHeadEnsemble:
        """The serving ensemble of the current weights, on the CPU: with
        K = 0 every sub-model's ``base.*`` entries are the same tensors, so
        the shared backbone is detected exactly; with K > 0 the
        trunk-shared layout."""
        cpu = lambda sd: {k: v.detach().float().cpu() for k, v in sd.items()  # noqa: E731
                          if not k.endswith("num_batches_tracked")}
        base = {f"base.{k}": v for k, v in cpu(self.model.base.state_dict()).items()}
        sds = []
        for head in self.model.heads:
            sd = dict(base)
            if isinstance(head, TailHead):
                sd.update({f"base.{k}": v for k, v in cpu(head.tail.state_dict()).items()})
                sd.update({f"head.{k}": v for k, v in cpu(head.mlp.state_dict()).items()})
            else:
                sd.update({f"head.{k}": v for k, v in cpu(head.state_dict()).items()})
            sds.append(sd)
        return multihead.build_ensemble(
            sds, self.class_names, self.model_name, generic_head=self.generic_head,
            shared_trunk_stages=self.per_head_stages or None)

    def save_checkpoint(self, epoch: int, path: str) -> None:
        """``path``: the resume file; ``path.merged.ckpt`` and
        ``path.merged.pth``: the ensemble in the native and the reference's
        merged format."""
        mu, nu = self.state.moments()
        moments = [serialization.joint_tree({k: v.detach().cpu().numpy() for k, v in m.items()})
                   ["params"] for m in (mu, nu)]
        payload = {"variables": self.variables(),
                   "opt_state": serialization.optax_adamw_state(
                       int(self.state.count), *moments, float(self.state.lr))}
        meta = {
            "epoch": int(epoch),
            "best_acc": float(self.best_acc),
            "total_steps": int(self.state.step),
            "layer3_unfrozen": self.layer3_unfrozen,
            "scheduler": self.plateau.state_dict(),
            "model_name": self.model_name,
            "class_names": self.class_names,
            "num_heads": self.num_heads,
            "per_head_stages": self.per_head_stages,
            "generic_head": self.generic_head,
            "format": FORMAT,
        }
        serialization.save_native(path, payload, metadata=meta)
        ens = self.to_ensemble()
        serialization.save_merged_native(path + ".merged.ckpt", ens)
        serialization.save_merged_torch(path + ".merged.pth", ens)

    def resume(self, path: str) -> None:
        """Restore a joint checkpoint (either package's): weights, moments,
        step, scheduler, best accuracy, ``start_epoch`` = saved epoch + 1,
        and the phase-2 step when layer3 was unfrozen. A checkpoint of
        another ``per_head_stages`` or ``generic_head`` is refused."""
        tree, meta = serialization.load_native(path)
        if meta.get("format") != FORMAT:
            raise ValueError(f"{path}: not a joint-trainer checkpoint")
        ckpt_phs = int(meta.get("per_head_stages", 0))
        if ckpt_phs != self.per_head_stages:
            raise ValueError(f"{path}: checkpoint per_head_stages={ckpt_phs} but trainer "
                             f"was built with per_head_stages={self.per_head_stages}")
        ckpt_gen = bool(meta.get("generic_head", False))
        if ckpt_gen != self.generic_head:
            raise ValueError(f"{path}: checkpoint generic_head={ckpt_gen} but trainer "
                             f"was built with generic_head={self.generic_head}")
        opt = tree["opt_state"]
        adam = opt["inner_state"]["1"]["0"]
        load_joint_state_(self.state, tree["variables"], int(np.asarray(adam["count"])),
                          adam["mu"], adam["nu"], int(meta.get("total_steps", 0)),
                          lr=float(np.asarray(opt["hyperparams"]["lr"])))
        self._set_plateau(PlateauState.from_state_dict(meta["scheduler"]))
        self.best_acc = float(meta.get("best_acc", 0.0))
        self.start_epoch = int(meta.get("epoch", -1)) + 1
        if meta.get("layer3_unfrozen"):
            self._unfreeze()
        log.info("resumed joint trainer at epoch %d", self.start_epoch)

    # -- epochs ---------------------------------------------------------------

    def _log_step(self, metrics: Dict[str, torch.Tensor], step: int) -> None:
        per_head = metrics["per_head_loss"].cpu().numpy()
        for h, name in enumerate(self.synthetic_classes):
            self.writer.add_scalar(f"train/loss_{name}", float(per_head[h]), step)

    def validate(self, batcher, epoch: int) -> JointEpochResult:
        target_rows = 2 * batcher.batch_size
        loss_sum = np.zeros(self.num_heads)
        confusion = np.zeros((self.num_heads, 2, 2))
        count = ens_correct = 0.0
        scored = []
        for batch in self._batches(batcher, epoch, target_rows):
            stats = self._eval_step(self.model, batch)
            self.eval_steps_run += 1
            loss_sum += stats["loss_sum"].double().cpu().numpy()
            confusion += stats["confusion"].double().cpu().numpy()
            count += float(stats["count"])
            ens_correct += float(stats["ens_correct"])
            scored.append(np.stack([stats["det_score"].float().cpu().numpy(),
                                    batch["label"].cpu().numpy() != 0,
                                    batch["weight"].cpu().numpy()], axis=1))
        loss_sum, confusion, count, ens_correct = self._sum_over_ranks(
            loss_sum, confusion, count, ens_correct)
        rows = self._valid_rows(scored)
        res = JointEpochResult()
        # each head over its own rows (all of them with hard negatives)
        head_counts = confusion.sum(axis=(1, 2))
        res.val_loss = float((loss_sum / np.maximum(head_counts, 1.0)).mean())
        res.per_head_acc = [float(np.trace(confusion[h]) / max(head_counts[h], 1.0))
                            for h in range(self.num_heads)]
        res.ensemble_acc = ens_correct / max(count, 1.0)
        res.confusion = confusion
        if rows.size:
            s, y = rows[:, 0].astype(np.float32), rows[:, 1] > 0
            if 0 < y.sum() < y.size:
                res.val_auc = metrics_mod.roc_auc(s, y)
                res.val_eer = metrics_mod.equal_error_rate(s, y)[0]
        return res

    def fit(self, data_dir: Optional[str] = None) -> float:
        cfg = self.cfg
        data_dir = data_dir or cfg.data_dir
        train_samples = ds.list_samples(data_dir, "train", self.corpus_classes)
        val_samples = ds.list_samples(data_dir, "test", self.corpus_classes)
        train_batcher = ds.WaveformBatcher(train_samples, cfg.batch_size, shuffle=True,
                                           workers=cfg.workers, seed=cfg.seed)
        val_batcher = ds.WaveformBatcher(val_samples, cfg.batch_size, shuffle=False,
                                         workers=cfg.workers)
        os.makedirs(cfg.checkpoint_dir, exist_ok=True)
        unfreeze_epoch = int(cfg.epochs * cfg.unfreeze_layer3_at_fraction)

        for epoch in range(self.start_epoch, cfg.epochs):
            if (epoch >= unfreeze_epoch and not self.layer3_unfrozen
                    and not cfg.reference_quirk_frozen_layer3):
                self._unfreeze()
                log.info("epoch %d: unfroze layer3 (epochs//3 schedule)", epoch)

            tr = self.train_epoch(train_batcher, epoch)
            scale = self.plateau.update(tr["loss"])
            self._set_plateau(self.plateau)
            res = self.validate(val_batcher, epoch)
            self.writer.add_scalar("epoch/train_loss", tr["loss"], epoch)
            self.writer.add_scalar("epoch/val_loss", res.val_loss, epoch)
            self.writer.add_scalar("epoch/ensemble_acc", res.ensemble_acc, epoch)
            if res.val_auc is not None:
                self.writer.add_scalar("epoch/val_auc", res.val_auc, epoch)
                self.writer.add_scalar("epoch/val_eer", res.val_eer, epoch)
            log.info("epoch %d: train loss %.4f | val loss %.4f | ensemble acc %.4f"
                     " | per-head %s | lr scale %.4f", epoch, tr["loss"], res.val_loss,
                     res.ensemble_acc, ["%.3f" % a for a in res.per_head_acc], scale)
            if res.val_auc is not None:
                log.info("epoch %d: detector AUC %.4f EER %.4f", epoch, res.val_auc, res.val_eer)

            if res.ensemble_acc > self.best_acc:  # strict, as the reference
                self.best_acc = res.ensemble_acc
                path = os.path.join(cfg.checkpoint_dir, "joint_model.ckpt")
                self._saved(lambda: self.save_checkpoint(epoch, path))
                log.info("saved best joint checkpoint (ensemble acc %.4f) -> %s",
                         self.best_acc, path)
        return self.best_acc
