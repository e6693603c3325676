"""Host-side training of one binary head (the reference package's
``train/trainer.py``), on a GPU.

Seeded init (flax's defaults, ``models/init.py``, as the reference's
``model.init``), the frozen-backbone start, layer3 unfrozen at epochs // 3,
per epoch a train pass (ReduceLROnPlateau stepped on its loss) and a
validation pass with the classification report, best-validation-accuracy
checkpoints in both formats (the native msgpack file, or the step-indexed
checkpointer of ``checkpoint_backend="orbax"``, and the ``.pth`` twin),
resume from either with ``start_epoch = saved epoch + 1``, and the
``--evaluate`` pass with its confusion matrix.

Data-parallel training (``use_mesh``, as the reference's: a mesh over
``data`` when the process is in a group of more than one rank, or the
``mesh`` given): every rank walks the one-process batch order with the
same seed, decodes only its rows of each batch (padded to a multiple of
the data size; ``data/dataset.py``), and runs the data-parallel step
(``train/steps.py``), so all ranks keep the same state. Validation sums
the confusion counts over the ranks and gathers the scores for the AUC,
so every rank (and its plateau) sees the global result. Only rank 0
writes checkpoints, TensorBoard scalars and logs, with a barrier after
each save; a resume reads on every rank.

The trainer runs on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU the default raises. On the card, ``--bf16`` makes the
reference's choices for an accelerator: the log-mel kernel in the train
step (``dft_mode='pallas'``, ops/cuda_melspec.py in dB-only mode) and the
int16 waveform transport; ``TrainConfig.mel_dft`` and ``transport_dtype``
set either explicitly. The eval step (validation and ``--evaluate``)
always takes the float32 GEMM mel, as the reference's does. Batches are padded to 2 × batch_size rows with zero
audio weighted 0, as the reference pads them (BatchNorm sees those rows).
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed

from synthetic_audio_detection_tpu_torch.audio import wavio
from synthetic_audio_detection_tpu_torch.checkpoints import serialization, torch_compat
from synthetic_audio_detection_tpu_torch.checkpoints.orbax_io import OrbaxCheckpointer
from synthetic_audio_detection_tpu_torch.data import dataset as ds
from synthetic_audio_detection_tpu_torch.models.classifier import BinaryClassifier
from synthetic_audio_detection_tpu_torch.models.init import flax_default_init_
from synthetic_audio_detection_tpu_torch.parallel import sharding as sh
from synthetic_audio_detection_tpu_torch.train import steps
from synthetic_audio_detection_tpu_torch.train.plateau import PlateauState
from synthetic_audio_detection_tpu_torch.utils import metrics as metrics_mod
from synthetic_audio_detection_tpu_torch.utils.config import (
    SpecAugmentConfig,
    SpectrogramConfig,
    TrainConfig,
)
from synthetic_audio_detection_tpu_torch.utils.profiling import span
from synthetic_audio_detection_tpu_torch.utils.tb_writer import SummaryWriter

log = logging.getLogger(__name__)


class _NoWriter:
    """The TensorBoard writer of a rank other than 0."""

    def add_scalar(self, *args, **kwargs) -> None:
        pass

    def close(self) -> None:
        pass


class _GrainBatcher:
    """WaveformBatcher-shaped adapter over data.grain_pipeline (worker
    processes; fixed-shape batches with their weights)."""

    def __init__(self, samples, batch_size, shuffle=True, workers=8, seed=0):
        self.samples = list(samples)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.workers = workers
        self.seed = seed

    def __len__(self):
        return len(self.samples) // self.batch_size

    def epoch(self, epoch_idx: int = 0, rows: Optional[Tuple[int, int]] = None):
        from synthetic_audio_detection_tpu_torch.data.grain_pipeline import make_loader

        yield from make_loader(self.samples, self.batch_size, shuffle=self.shuffle,
                               seed=self.seed, epoch_idx=epoch_idx, workers=self.workers,
                               rows=rows)


@dataclass
class EpochResult:
    train_loss: float = 0.0
    train_acc: float = 0.0
    val_loss: float = 0.0
    val_acc: float = 0.0
    report: Dict[str, Dict[str, float]] = field(default_factory=dict)
    confusion: Optional[np.ndarray] = None
    # threshold-free detector metrics (Real = class 0 vs any-synthetic);
    # None when the eval split lacks one of the sides
    val_auc: Optional[float] = None
    val_eer: Optional[float] = None


def resolve_device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to train on the CPU")
    return dev


def device_batches(batcher, epoch: int, target_rows: int, transport: str,
                   device: torch.device, rows: Optional[Tuple[int, int]] = None
                   ) -> Iterator[Dict[str, torch.Tensor]]:
    """One epoch of ``batcher`` on ``device``: each batch padded to
    ``target_rows`` with zero audio weighted 0 (a grain batch, or a row
    window ``rows`` of each batch, comes padded, with its weights), its
    audio as int16 PCM under the int16 transport, through pinned memory on
    the card. Each batch's ``train_step.feed`` range covers the wait for the
    batcher, the padding, the pinning and the copy, and closes before the
    yield."""
    pin = device.type == "cuda"
    batches = iter(batcher.epoch(epoch, rows=rows))
    while True:
        with span("train_step.feed"):
            batch = next(batches, None)
            if batch is None:
                return
            if "weight" in batch:  # grain backend: fixed-shape batches with weights
                padded = batch
            else:
                padded, n = ds.pad_batch(batch, target_rows)
                padded["weight"] = (np.arange(target_rows) < n).astype(np.float32)
            audio = padded["audio"]
            if transport == "int16" and audio.dtype != np.int16:
                audio = wavio.pcm16_quantize(audio)
            out = {"audio": torch.from_numpy(np.ascontiguousarray(audio)),
                   "label": torch.from_numpy(np.asarray(padded["label"], np.int64)),
                   "weight": torch.from_numpy(np.asarray(padded["weight"], np.float32))}
            if pin:
                out = {k: v.pin_memory() for k, v in out.items()}
            out = {k: v.to(device, non_blocking=pin) for k, v in out.items()}
        yield out


class StepTrainer:
    """What the trainers share: the mesh, the batch feed, the plateau's lr
    scale on the device, the train pass and the sums over ranks. A
    subclass calls ``_init_mesh`` and sets ``cfg``, ``state``,
    ``generator``, ``writer`` (``_make_writer``), ``plateau``,
    ``_transport``, ``_train_step`` and ``train_steps_run``."""

    def _init_mesh(self, device: str, use_mesh: bool, mesh: Optional[sh.Mesh]) -> None:
        """``mesh``: the one given, else a data mesh over every rank when
        ``use_mesh`` and the group has more than one (the reference's
        rule); the trainer's device is the mesh's."""
        if mesh is None and use_mesh and sh.world_size() > 1:
            mesh = sh.create_mesh()
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else mesh.device
        self.is_writer = mesh is None or torch.distributed.get_rank() == 0

    def _make_writer(self, log_dir: str):
        return SummaryWriter(log_dir) if self.is_writer else _NoWriter()

    def _batches(self, batcher, epoch: int, target_rows: int) -> Iterator[Dict[str, torch.Tensor]]:
        rows = None
        if self.mesh is not None:  # this rank's rows of each batch, padded to a multiple
            local = sh.pad_batch_to_multiple(target_rows, self.mesh) // self.mesh.size(sh.DATA_AXIS)
            start, _ = self.mesh.rows(local)
            rows = (start, start + local)
        return device_batches(batcher, epoch, target_rows, self._transport, self.device, rows)

    def _saved(self, save) -> None:
        """``save()`` on rank 0, then every rank waits for it."""
        if self.is_writer:
            save()
        if self.mesh is not None:
            self.mesh.barrier()

    def _sum_over_ranks(self, *values):
        """Host numbers or arrays summed over the data ranks (as given
        without a mesh), by one all-reduce in float64."""
        if self.mesh is None:
            return values
        flat = [np.asarray(v, np.float64).ravel() for v in values]
        total = self.mesh.all_reduce(torch.from_numpy(np.concatenate(flat)).to(self.device))
        total = total.cpu().numpy()
        out, offset = [], 0
        for v, f in zip(values, flat):
            out.append(total[offset:offset + f.size].reshape(np.shape(v)))
            offset += f.size
        return [o if np.ndim(v) else float(o) for o, v in zip(out, values)]

    def _valid_rows(self, per_batch: List[np.ndarray]) -> np.ndarray:
        """Per batch [R, k] rows whose last column is the weight → the rows
        weighted above 0 of the global batches, in the one-process order
        (under a mesh: gathered over the data ranks by one all-gather)."""
        rows = np.concatenate(per_batch) if per_batch else np.zeros((0, 1))
        if self.mesh is not None and per_batch:
            d, nb, r = self.mesh.size(sh.DATA_AXIS), len(per_batch), per_batch[0].shape[0]
            got = self.mesh.all_gather(torch.from_numpy(rows).to(self.device)).cpu().numpy()
            rows = got.reshape(d, nb, r, -1).transpose(1, 0, 2, 3).reshape(nb * d * r, -1)
        return rows[rows[:, -1] > 0]

    def _set_plateau(self, plateau: PlateauState) -> None:
        self.plateau = plateau
        self.state.lr_scale = torch.tensor(plateau.scale, dtype=torch.float32,
                                           device=self.device)

    def _log_step(self, metrics: Dict[str, torch.Tensor], step: int) -> None:
        """Scalars of a logged step beyond its loss and accuracy (none)."""

    def train_epoch(self, batcher, epoch: int) -> Dict[str, float]:
        """One pass over the training batches; → the epoch's mean loss and
        accuracy over the steps that were not skipped (accumulated on the
        device, read once at the end)."""
        target_rows = 2 * batcher.batch_size
        loss_sum = torch.zeros((), device=self.device)
        acc_sum = torch.zeros((), device=self.device)
        n_good = torch.zeros((), device=self.device)
        t0 = time.time()
        for i, batch in enumerate(self._batches(batcher, epoch, target_rows)):
            m = self._train_step(self.state, batch, self.generator)
            self.train_steps_run += 1
            good = torch.isfinite(m["loss"]).float()
            loss_sum = loss_sum + torch.where(good > 0, m["loss"], torch.zeros_like(m["loss"]))
            acc_sum = acc_sum + good * m["accuracy"]
            n_good = n_good + good
            if (i + 1) % self.cfg.log_every_steps == 0:
                loss, acc = float(m["loss"]), float(m["accuracy"])
                step = int(self.state.step)
                self.writer.add_scalar("train/loss", loss, step)
                self.writer.add_scalar("train/accuracy", acc, step)
                self._log_step(m, step)
                log.info("epoch %d step %d loss %.4f acc %.4f (%.1f rows/s)", epoch, step, loss,
                         acc, (i + 1) * target_rows / (time.time() - t0))
        denom = max(float(n_good), 1.0)
        return {"loss": float(loss_sum) / denom, "accuracy": float(acc_sum) / denom}


class Trainer(StepTrainer):
    def __init__(
        self,
        cfg: TrainConfig,
        model_name: str = "resnet18",
        spec_cfg: Optional[SpectrogramConfig] = None,
        augment: Optional[SpecAugmentConfig] = None,
        log_dir: Optional[str] = None,
        class_names: Optional[List[str]] = None,
        reference_quirk_loss: bool = False,
        device: str = "cuda",
        use_mesh: bool = True,
        mesh: Optional[sh.Mesh] = None,
    ):
        if cfg.checkpoint_backend not in ("native", "orbax"):
            raise ValueError(f"unknown checkpoint backend {cfg.checkpoint_backend!r}")
        self.cfg = cfg
        self._init_mesh(device, use_mesh, mesh)
        self.spec_cfg = spec_cfg or SpectrogramConfig.train()
        self.augment = augment or SpecAugmentConfig()
        self.class_names = list(class_names) if class_names else [cfg.class0, cfg.class1]
        self.model_name = model_name
        self.compute_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        on_card = self.device.type == "cuda"
        with torch.random.fork_rng(devices=[]):  # the constructor's own draws
            model = BinaryClassifier(model_name, num_outputs=len(self.class_names),
                                     s2d_stage1=cfg.s2d_stage1)
        flax_default_init_(model, torch.Generator().manual_seed(cfg.seed))
        model = model.to(self.device)
        if on_card:
            model = model.to(memory_format=torch.channels_last)
        if self.mesh is not None:
            sh.replicate(self.mesh, model)
        self.state = steps.create_train_state(model, cfg)
        self.generator = torch.Generator(self.device).manual_seed(cfg.seed)
        self.plateau = PlateauState(cfg.plateau_factor, cfg.plateau_patience)
        self.best_acc = 0.0
        self.start_epoch = 0
        self.layer3_unfrozen = False
        self.train_steps_run = 0
        self.eval_steps_run = 0
        # the step-indexed checkpointer of checkpoint_backend="orbax", made at
        # the first save beside its path (a caller may set its own first)
        self.checkpointer = None
        bf16_on_card = self.compute_dtype == torch.bfloat16 and on_card
        self._transport = cfg.transport_dtype or ("int16" if bf16_on_card else "float32")
        self._dft = cfg.mel_dft or ("pallas" if bf16_on_card else None)
        self._reference_quirk_loss = reference_quirk_loss
        self._train_step = self._build_train_step()
        self._eval_step = steps.make_eval_step(self.spec_cfg, compute_dtype=self.compute_dtype)
        self.writer = self._make_writer(
            log_dir or os.path.join("runs", f"experiment_{int(time.time())}"))
        if cfg.resume:
            self.resume(cfg.resume)

    @property
    def model(self) -> BinaryClassifier:
        return self.state.model

    def _build_train_step(self):
        """The step for the current phase: the gradient stops at stage 4,
        then at stage 3 once layer3 unfreezes (stop_grad_boundary)."""
        stage = 0
        if self.cfg.stop_grad_boundary:
            stage = 3 if self.layer3_unfrozen else 4
        return steps.make_train_step(
            self.cfg, self.spec_cfg, self.augment,
            reference_quirk_loss=self._reference_quirk_loss, stop_grad_stage=stage,
            dft_mode=self._dft, compute_dtype=self.compute_dtype, mesh=self.mesh)

    def _unfreeze(self) -> None:
        steps.unfreeze_layer3(self.state)
        self.layer3_unfrozen = True
        self._train_step = self._build_train_step()

    # -- checkpointing -------------------------------------------------------

    def state_dict(self) -> Dict[str, np.ndarray]:
        """The model's state dict (``base.*``, ``head.<index>.*``) as
        float32 numpy, without ``num_batches_tracked``."""
        return {k: v.detach().float().cpu().numpy() for k, v in self.model.state_dict().items()
                if not k.endswith("num_batches_tracked")}

    def _moment_trees(self):
        mu, nu = self.state.moments()
        as_tree = lambda d: torch_compat.classifier_variables_from_torch(  # noqa: E731
            {k: v.detach().cpu().numpy() for k, v in d.items()}, base_prefix="base.")["params"]
        return as_tree(mu), as_tree(nu)

    def save_checkpoint(self, epoch: int, path: str) -> None:
        """The native file at ``path`` and its ``.pth`` twin at path +
        '.pth' (the reference trainer's contract; its optimizer entry holds
        the phase-1 set's moments in torch AdamW's format). Under
        ``checkpoint_backend="orbax"`` the native file's payload and
        metadata go instead to step ``total_steps`` of the step-indexed
        checkpointer in path + '.orbax' (written in the background), and the
        ``.pth`` twin as always."""
        count = int(self.state.count)
        mu, nu = self._moment_trees()
        sd = self.state_dict()
        extra = {
            "epoch": int(epoch),
            "best_acc": float(self.best_acc),
            "total_steps": int(self.state.step),
            "layer3_unfrozen": self.layer3_unfrozen,
            "scheduler": self.plateau.state_dict(),
            "model_name": self.model_name,
            "class_names": self.class_names,
        }
        payload = {
            "variables": torch_compat.classifier_variables_from_torch(sd, base_prefix="base."),
            "opt_state": serialization.optax_adamw_state(count, mu, nu,
                                                         float(self.state.lr)),
        }
        if self.cfg.checkpoint_backend == "orbax":
            if self.checkpointer is None:
                self.checkpointer = OrbaxCheckpointer(path + ".orbax")
            self.checkpointer.save(extra["total_steps"], payload, metadata=extra)
        else:
            serialization.save_native(path, payload, metadata=extra)
        torch_opt = torch_compat.torch_optimizer_state_dict(
            count, mu, nu, lr=self.cfg.lr * float(self.state.lr_scale),
            weight_decay=self.cfg.weight_decay)
        serialization.save_submodel_torch(
            path + ".pth", sd, epoch=extra["epoch"], best_acc=extra["best_acc"],
            total_steps=extra["total_steps"], scheduler=extra["scheduler"],
            layer3_unfrozen=extra["layer3_unfrozen"], optimizer=torch_opt)

    def _load_weights(self, sd: Dict[str, Any]) -> None:
        missing, unexpected = self.model.load_state_dict(
            {k: torch.as_tensor(np.array(v, np.float32)) for k, v in sd.items()}, strict=False)
        missing = [k for k in missing if not k.endswith("num_batches_tracked")]
        if missing or unexpected:
            raise ValueError(f"checkpoint does not fit the model: missing {missing[:5]}, "
                             f"unexpected {unexpected[:5]}")

    def resume(self, path: str) -> None:
        """Restore weights, moments, scheduler and step counter from a
        ``.pth``/``.pt`` (either package's twin, or a reference trainer
        checkpoint: its AdamW moments mapped as ``adam_moments_from_torch``
        maps them) or from a native file; ``start_epoch`` = saved epoch + 1."""
        if path.endswith((".pth", ".pt")):
            sd, extras = serialization.load_submodel_torch(path)
            self._load_weights(sd)
            self.start_epoch = int(extras.get("epoch", -1)) + 1
            self.best_acc = float(extras.get("best_acc", 0.0))
            if "total_steps" in extras:
                self.state.step = torch.tensor(int(extras["total_steps"]), device=self.device)
            sched = extras.get("scheduler")
            if isinstance(sched, dict) and sched:
                if "scale" in sched:  # the twins store the PlateauState itself
                    self._set_plateau(PlateauState.from_state_dict(sched))
                else:  # a torch ReduceLROnPlateau state dict
                    self._set_plateau(PlateauState.from_torch_state_dict(
                        sched, base_lr=self.cfg.lr))
            if extras.get("layer3_unfrozen"):
                self._unfreeze()
            adam = torch_compat.adam_moments_from_torch(extras.get("optimizer"),
                                                        extras.get("raw_state_dict", {}))
            if adam is not None:
                count, mu_p, nu_p = adam
                self.state.set_moments(count, serialization.moments_by_name(mu_p),
                                       serialization.moments_by_name(nu_p))
                log.info("restored AdamW moments from torch checkpoint (step %d)", count)
            elif extras.get("optimizer"):
                log.warning("torch-ckpt resume: optimizer dict present but unmappable; "
                            "moments restart fresh")
            log.info("resumed (torch ckpt) at epoch %d", self.start_epoch)
            return
        tree, meta = serialization.load_native(path)
        self._load_weights(torch_compat.torch_state_dict_from_variables(tree["variables"]))
        count, mu, nu = serialization.adam_from_optax_state(tree["opt_state"])
        self.state.set_moments(count, mu, nu)
        self.state.step = torch.tensor(int(meta.get("total_steps", 0)), device=self.device)
        self._set_plateau(PlateauState.from_state_dict(meta["scheduler"]))
        self.best_acc = float(meta.get("best_acc", 0.0))
        self.start_epoch = int(meta.get("epoch", -1)) + 1
        if meta.get("layer3_unfrozen"):
            self._unfreeze()
        log.info("resumed at epoch %d (best_acc %.4f)", self.start_epoch, self.best_acc)

    # -- epochs ---------------------------------------------------------------

    def _log_step(self, metrics: Dict[str, torch.Tensor], step: int) -> None:
        self.writer.add_scalar("train/lr", self.cfg.lr * float(self.state.lr_scale), step)

    def validate(self, batcher, epoch: int) -> EpochResult:
        target_rows = 2 * batcher.batch_size
        loss_sum = 0.0
        n_cls = len(self.class_names)
        confusion = np.zeros((n_cls, n_cls), np.float64)
        count = 0.0
        scored = []
        for batch in self._batches(batcher, epoch, target_rows):
            stats = self._eval_step(self.model, batch)
            self.eval_steps_run += 1
            loss_sum += float(stats["loss_sum"])
            confusion += stats["confusion"].double().cpu().numpy()
            count += float(stats["count"])
            # any-synthetic score = 1 - P(Real), is-synthetic, weight
            scored.append(np.stack([1.0 - stats["probs"][:, 0].float().cpu().numpy(),
                                    batch["label"].cpu().numpy() != 0,
                                    batch["weight"].cpu().numpy()], axis=1))
        loss_sum, confusion, count = self._sum_over_ranks(loss_sum, confusion, count)
        rows = self._valid_rows(scored)
        result = EpochResult()
        result.val_loss = loss_sum / max(count, 1.0)
        result.val_acc = float(np.trace(confusion) / max(count, 1.0))
        result.report = metrics_mod.report_from_confusion(confusion, self.class_names)
        result.confusion = confusion
        if rows.size:
            s, y = rows[:, 0].astype(np.float32), rows[:, 1] > 0
            if 0 < y.sum() < y.size:  # ROC needs both sides present
                result.val_auc = metrics_mod.roc_auc(s, y)
                result.val_eer = metrics_mod.equal_error_rate(s, y)[0]
        return result

    def fit(self, data_dir: Optional[str] = None) -> float:
        cfg = self.cfg
        data_dir = data_dir or cfg.data_dir
        extra_neg = tuple(cfg.hard_negative_classes)
        train_samples = ds.list_samples(data_dir, "train", self.class_names,
                                        extra_negative_classes=extra_neg)
        val_samples = ds.list_samples(data_dir, "test", self.class_names,
                                      extra_negative_classes=extra_neg)
        make = _GrainBatcher if cfg.data_backend == "grain" else ds.WaveformBatcher
        train_batcher = make(train_samples, cfg.batch_size, shuffle=True,
                             workers=cfg.workers, seed=cfg.seed)
        val_batcher = make(val_samples, cfg.batch_size, shuffle=False, workers=cfg.workers)
        os.makedirs(cfg.checkpoint_dir, exist_ok=True)
        unfreeze_epoch = int(cfg.epochs * cfg.unfreeze_layer3_at_fraction)

        for epoch in range(self.start_epoch, cfg.epochs):
            # >= (not ==): a resume that starts past the boundary must still
            # unfreeze; reference_quirk_frozen_layer3 skips the transition
            # (the reference's optimizer never holds layer3)
            if (epoch >= unfreeze_epoch and not self.layer3_unfrozen
                    and not cfg.reference_quirk_frozen_layer3):
                self._unfreeze()
                log.info("epoch %d: unfroze layer3 (epochs//3 schedule)", epoch)

            tr = self.train_epoch(train_batcher, epoch)
            # the reference steps ReduceLROnPlateau on the train epoch loss,
            # before validation
            scale = self.plateau.update(tr["loss"])
            self._set_plateau(self.plateau)
            result = self.validate(val_batcher, epoch)

            self.writer.add_scalar("epoch/train_loss", tr["loss"], epoch)
            self.writer.add_scalar("epoch/val_loss", result.val_loss, epoch)
            self.writer.add_scalar("epoch/val_accuracy", result.val_acc, epoch)
            if result.val_auc is not None:
                self.writer.add_scalar("epoch/val_auc", result.val_auc, epoch)
                self.writer.add_scalar("epoch/val_eer", result.val_eer, epoch)
                log.info("epoch %d: val AUC %.4f EER %.4f", epoch, result.val_auc,
                         result.val_eer)
            log.info("epoch %d: train loss %.4f | val loss %.4f acc %.4f | lr scale %.4f",
                     epoch, tr["loss"], result.val_loss, result.val_acc, scale)
            log.info("\n%s", metrics_mod.format_report(result.report))

            if result.val_acc > self.best_acc:
                self.best_acc = result.val_acc
                path = os.path.join(cfg.checkpoint_dir, "best_model.ckpt")
                self._saved(lambda: self.save_checkpoint(epoch, path))
                log.info("saved best checkpoint (acc %.4f) -> %s", self.best_acc, path)
        if self.checkpointer is not None:
            self.checkpointer.wait()
        return self.best_acc

    def evaluate(self, data_dir: Optional[str] = None) -> EpochResult:
        """--evaluate: confusion matrix and per-class report on test/."""
        data_dir = data_dir or self.cfg.data_dir
        samples = ds.list_samples(data_dir, "test", self.class_names)
        batcher = ds.WaveformBatcher(samples, self.cfg.batch_size, shuffle=False,
                                     workers=self.cfg.workers)
        result = self.validate(batcher, 0)
        log.info("\n%s", metrics_mod.format_confusion(result.confusion, self.class_names))
        log.info("\n%s", metrics_mod.format_report(result.report))
        if result.val_auc is not None:
            log.info("detector AUC %.4f  EER %.4f (Real vs any-synthetic)",
                     result.val_auc, result.val_eer)
        return result
