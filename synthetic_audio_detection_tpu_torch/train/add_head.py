"""Grow one new class head onto a merged artifact (the reference package's
``train/add_head.py``), on a GPU.

The artifact's shared backbone is frozen: it runs in eval mode with no
autograd, so its parameters and batch statistics stay as they were, and
one new binary head (flax's default init) trains on its features. The
optimizer is optax's ``chain(clip_by_global_norm, adamw(lr))`` over the
head: no plateau scale and no freeze mask (``train/steps.py:apply_update_``
with every entry trainable), with the NaN-skip. The eval step takes the
train step's mel, on float32 audio. The head of the best validated epoch
(``>=``: on a tie the later epoch) is spliced in before a generic head;
every existing head stays bit-identical, and a stored calibration is
dropped with a warning.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from synthetic_audio_detection_tpu_torch.data import dataset as ds
from synthetic_audio_detection_tpu_torch.ensemble import multihead
from synthetic_audio_detection_tpu_torch.models.head import BinaryHead, set_dropout_generator
from synthetic_audio_detection_tpu_torch.models.init import flax_default_init_
from synthetic_audio_detection_tpu_torch.models.resnet import ResNet, create_resnet
from synthetic_audio_detection_tpu_torch.train import steps
from synthetic_audio_detection_tpu_torch.train.trainer import device_batches, resolve_device
from synthetic_audio_detection_tpu_torch.utils.config import (
    SpecAugmentConfig,
    SpectrogramConfig,
    TrainConfig,
)

log = logging.getLogger(__name__)


def trunk_variables(ensemble: multihead.MultiHeadEnsemble) -> Dict[str, torch.Tensor]:
    """The shared backbone's state dict. Only shared-backbone artifacts are
    supported: a trunk-shared (per-head stages) artifact would need a new
    tail trained with the head, and is refused."""
    if not ensemble.shared_backbone:
        raise ValueError(
            "incremental head addition needs a shared-backbone artifact "
            "(joint-trainer merges, or reference strict=False merges); "
            f"this artifact has shared_backbone={ensemble.shared_backbone}, "
            f"shared_trunk_stages={ensemble.shared_trunk_stages}")
    return dict(ensemble.backbones[0].state_dict())


def make_add_head_step(
    cfg: TrainConfig,
    spec_cfg: SpectrogramConfig,
    augment: Optional[SpecAugmentConfig],
    sample_rate: int = 32_000,
    dft_mode: Optional[str] = None,
    compute_dtype: torch.dtype = torch.float32,
):
    """→ ``step(state, trunk, batch, generator) -> metrics``: the features,
    the frozen ``trunk`` forward (eval mode, no autograd), the head's
    forward and backward, the clip, AdamW at ``cfg.lr`` and the NaN-skip,
    ``state`` (the head's) updated in place."""

    def step(state: steps.TrainState, trunk: ResNet, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        head = state.model
        device = state.count.device
        head.train()
        set_dropout_generator(head, generator)
        with steps._precision(torch.float32, device):
            x = steps.features_from_waveforms(batch["audio"], spec_cfg, augment, generator,
                                              sample_rate, dft_mode=dft_mode)
        trunk.eval()
        with torch.no_grad(), steps._precision(compute_dtype, device):
            feats = trunk(x)
        labels = batch["label"]
        weights = batch.get("weight")
        buffers, saved = steps.save_buffers(head)
        params = state.params
        with steps._precision(compute_dtype, device):
            out = head(feats)
            loss = steps.cross_entropy(out, labels, weights)
        grads = steps.gradients(loss, params, compute_dtype)
        ok = steps.apply_update_(state, grads, loss, cfg, buffers, saved)
        return {"loss": loss.detach(), "accuracy": steps.accuracy(out, labels, weights),
                "skipped": (~ok).float()}

    return step


def make_add_head_eval(
    spec_cfg: SpectrogramConfig,
    sample_rate: int = 32_000,
    dft_mode: Optional[str] = None,
    compute_dtype: torch.dtype = torch.float32,
):
    """→ ``eval_step(head, trunk, batch)`` → {'correct', 'count'} (weighted
    rows), device scalars; int16 audio is dequantized first."""

    @torch.no_grad()
    def eval_step(head: BinaryHead, trunk: ResNet, batch: Dict[str, torch.Tensor]):
        head.eval()
        trunk.eval()
        audio = batch["audio"]
        if not audio.is_floating_point():
            audio = audio.float() / 32768.0
        with steps._precision(torch.float32, audio.device):
            x = steps.features_from_waveforms(audio, spec_cfg, None, None, sample_rate,
                                              dft_mode=dft_mode)
        with steps._precision(compute_dtype, x.device):
            out = head(trunk(x))
        w = batch.get("weight")
        w = (w if w is not None else torch.ones_like(batch["label"])).float()
        correct = (torch.argmax(out, -1) == batch["label"]).float()
        return {"correct": (correct * w).sum(), "count": w.sum()}

    return eval_step


def splice_head(ensemble: multihead.MultiHeadEnsemble, new_class: str,
                head_state: Mapping[str, torch.Tensor]) -> multihead.MultiHeadEnsemble:
    """A shared-backbone ensemble with one more head (``head_state``, a
    ``BinaryHead`` state dict): the new specialist after the named
    synthetic classes, before a generic head; the existing backbone and
    heads as they are. A stored calibration is dropped (its per-column
    vectors no longer fit) with a warning."""
    if new_class in ensemble.class_names:
        raise ValueError(f"class {new_class!r} already in the ensemble")
    per_head = ensemble.classifier_state_dicts()
    new = {k: v for k, v in per_head[0].items() if k.startswith("base.")}
    new.update({f"head.{k}": v for k, v in head_state.items()})
    per_head.insert(len(ensemble.synthetic_names), new)  # before the generic head
    class_names = ensemble.synthetic_names + [new_class, ensemble.real_name]
    if ensemble.calibration:
        log.warning("dropping stored calibration: its per-column vectors no longer "
                    "match the grown ensemble (re-run the ensemble calibration)")
    return multihead.build_ensemble(per_head, class_names, ensemble.backbone_name,
                                    generic_head=ensemble.generic_head)


class HeadAdder:
    """Train one new head against a merged artifact's frozen trunk.

    Data: ``new_class`` is the positive; Real and every other class folder
    of the tree are negatives (``hard_negatives=False``: Real only). Runs
    on ``cuda`` unless ``device="cpu"``; ``--bf16`` on the card selects the
    log-mel kernel for the train and the eval step. Batches are padded to
    2 × batch_size rows, float32 audio (no int16 transport, as in the
    reference)."""

    def __init__(
        self,
        ensemble: multihead.MultiHeadEnsemble,
        new_class: str,
        cfg: TrainConfig,
        spec_cfg: Optional[SpectrogramConfig] = None,
        augment: Optional[SpecAugmentConfig] = None,
        real_class: str = "Real",
        hard_negatives: bool = True,
        model_name: Optional[str] = None,
        device: str = "cuda",
    ):
        self.device = resolve_device(device)
        self.ensemble = ensemble
        self.new_class = new_class
        self.cfg = cfg
        self.real_class = real_class
        self.hard_negatives = hard_negatives
        self.model_name = model_name or ensemble.backbone_name
        self.spec_cfg = spec_cfg or SpectrogramConfig.train()
        self.augment = augment or SpecAugmentConfig()
        self.compute_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        on_card = self.device.type == "cuda"
        with torch.random.fork_rng(devices=[]):  # the constructors' own draws
            trunk = create_resnet(self.model_name, ensemble.in_channels)
            head = BinaryHead(trunk.num_features)
        trunk.load_state_dict(trunk_variables(ensemble))
        self.trunk = trunk.to(self.device).eval().requires_grad_(False)
        flax_default_init_(head, torch.Generator().manual_seed(cfg.seed))
        self.state = steps.create_train_state(head.to(self.device), cfg)
        self.state.mask = [1.0] * len(self.state.names)  # no freeze mask
        if on_card:
            self.trunk = self.trunk.to(memory_format=torch.channels_last)
        self.generator = torch.Generator(self.device).manual_seed(cfg.seed)
        bf16_on_card = self.compute_dtype == torch.bfloat16 and on_card
        dft = cfg.mel_dft or ("pallas" if bf16_on_card else None)
        self._step = make_add_head_step(cfg, self.spec_cfg, self.augment, dft_mode=dft,
                                        compute_dtype=self.compute_dtype)
        self._eval = make_add_head_eval(self.spec_cfg, dft_mode=dft,
                                        compute_dtype=self.compute_dtype)
        self._best_head: Optional[Dict[str, torch.Tensor]] = None
        self.train_steps_run = 0
        self.eval_steps_run = 0

    def _samples(self, data_dir: str, mode: str) -> List[Tuple[str, int]]:
        extra: Sequence[str] = ()
        if self.hard_negatives:
            extra = sorted(d for d in os.listdir(os.path.join(data_dir, mode))
                           if os.path.isdir(os.path.join(data_dir, mode, d))
                           and d not in (self.real_class, self.new_class))
        return ds.list_samples(data_dir, mode, [self.real_class, self.new_class],
                               extra_negative_classes=extra)

    def _head_state(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach().cpu().clone() for k, v in self.state.model.state_dict().items()}

    def fit(self, data_dir: str) -> float:
        """``cfg.epochs`` epochs, each a train pass and a validation pass;
        the best validated epoch's head is kept (``>=``); → its accuracy."""
        cfg = self.cfg
        rows = 2 * cfg.batch_size
        train_b = ds.WaveformBatcher(self._samples(data_dir, "train"), cfg.batch_size,
                                     shuffle=True, workers=cfg.workers, seed=cfg.seed)
        val_b = ds.WaveformBatcher(self._samples(data_dir, "test"), cfg.batch_size,
                                   shuffle=False, workers=cfg.workers)
        best = 0.0
        for epoch in range(cfg.epochs):
            n_batches = 0
            for batch in device_batches(train_b, epoch, rows, "float32", self.device):
                self._step(self.state, self.trunk, batch, self.generator)
                self.train_steps_run += 1
                n_batches += 1
            correct = torch.zeros((), device=self.device)
            count = torch.zeros((), device=self.device)
            for batch in device_batches(val_b, 0, rows, "float32", self.device):
                st = self._eval(self.state.model, self.trunk, batch)
                self.eval_steps_run += 1
                correct += st["correct"]
                count += st["count"]
            acc = float(correct) / max(float(count), 1.0)
            if acc >= best or self._best_head is None:
                # serve the best validated epoch; the added head can overfit
                # frozen features within a few epochs
                self._best_head = self._head_state()
            best = max(best, acc)
            log.info("add-head %s epoch %d: val acc %.4f (%d train batches)", self.new_class,
                     epoch, acc, n_batches)
        return best

    def spliced(self) -> multihead.MultiHeadEnsemble:
        """The grown ensemble with the best validated epoch's head (the
        current head when ``fit`` has not run)."""
        head = self._best_head if self._best_head is not None else self._head_state()
        return splice_head(self.ensemble, self.new_class, head)
