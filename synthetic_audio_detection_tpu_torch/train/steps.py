"""The train and eval steps of one binary head (the reference package's
``train/steps.py``), on a GPU.

One train step: the features from the waveforms (int16 dequantisation,
waveform augmentation, the dB-only log-mel, SpecAugment, standardize, crop
and finalize), the forward in train mode, cross-entropy over the weighted
rows, the gradients masked to the trainable phase, the global-norm clip at
0.5, AdamW at weight decay 0.01 with the plateau's lr scale, the update
masked again, and the NaN-skip. Semantics are optax's and flax's, not
``torch.optim``'s:

- AdamW (``adamw_update_``) keeps ONE count for every parameter; a frozen
  parameter's gradient is zero, so its moments stay zero and its update
  (weight decay included) is masked away. ``torch.optim.AdamW`` keeps a
  count per parameter and skips parameters without a gradient, which gives
  layer3 other bias corrections after it unfreezes. The clip and AdamW run
  in place as ``torch._foreach_*`` ops over the trainable parameters.
- The clip scales by ``max / ‖g‖`` only when ‖g‖ ≥ max (optax
  ``clip_by_global_norm``; ``clip_grad_norm_`` uses ``max / (‖g‖ + 1e-6)``).
- A non-finite loss keeps the whole old state: parameters, BN running
  statistics, moments and count; only the step counter advances. Decided
  on the device from an ``ok`` tensor, with no host sync: the gradients
  are zeroed and the update's decays, lr and count gated by it, and the
  BN statistics put back with ``torch.where``.
- BatchNorm in train mode is flax's (``models.resnet.FlaxBatchNorm2d``).

The step's random draws (waveform augmentation, masks, crop, dropout) come
from the ``torch.Generator`` it is given, so one seed gives one step. Its
parts are ``record_function`` ranges (``train_step.features``, ``.forward``,
``.optimizer``; the backward runs on autograd's device thread, outside
them) for ``tools/profile_train.py``.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from synthetic_audio_detection_tpu_torch.models.classifier import BinaryClassifier
from synthetic_audio_detection_tpu_torch.models.head import set_dropout_generator
from synthetic_audio_detection_tpu_torch.models.resnet import sync_batch_stats
from synthetic_audio_detection_tpu_torch.ops import image as image_ops
from synthetic_audio_detection_tpu_torch.ops import masking, melspec, waveform_augment
from synthetic_audio_detection_tpu_torch.ops.cuda_melspec import fused_log_mel_factored
from synthetic_audio_detection_tpu_torch.ops.precision import exact_float32
from synthetic_audio_detection_tpu_torch.parallel.sharding import DATA_AXIS
from synthetic_audio_detection_tpu_torch.utils.config import (
    SpecAugmentConfig,
    SpectrogramConfig,
    TrainConfig,
)

PHASE1_PREFIXES = ("head", "layer4")
PHASE2_PREFIXES = ("head", "layer4", "layer3")
B1, B2, EPS = 0.9, 0.999, 1e-8


def freeze_mask(names: List[str], trainable_prefixes: Tuple[str, ...]) -> Dict[str, float]:
    """1.0 for a parameter whose dotted name has a component starting with
    one of the prefixes, else 0.0 (phase 1: head and layer4; phase 2 adds
    layer3)."""
    return {n: 1.0 if any(part.startswith(pref) for part in n.split(".")
                          for pref in trainable_prefixes) else 0.0 for n in names}


@dataclass
class TrainState:
    """The model (parameters and BN buffers) and the optimizer's state, on
    one device, updated in place by the step. ``mu``/``nu`` hold one
    float32 tensor per parameter, in ``names`` order (the model's
    ``named_parameters()``); ``mask`` one 0/1 float per parameter, the
    freeze phase; ``count`` the Adam count (int32); ``step`` the steps run
    (skipped ones too); ``lr`` the last applied learning rate (the
    reference's injected hyperparameter)."""

    model: BinaryClassifier
    names: List[str]
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    mask: List[float]
    count: torch.Tensor
    step: torch.Tensor
    lr_scale: torch.Tensor
    lr: torch.Tensor

    @property
    def params(self) -> List[torch.Tensor]:
        named = dict(self.model.named_parameters())
        return [named[n] for n in self.names]

    def set_phase(self, prefixes: Tuple[str, ...]) -> None:
        m = freeze_mask(self.names, prefixes)
        self.mask = [m[n] for n in self.names]

    def moments(self) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(mu, nu) per parameter name."""
        return dict(zip(self.names, self.mu)), dict(zip(self.names, self.nu))

    def set_moments(self, count: int, mu: Dict[str, torch.Tensor],
                    nu: Dict[str, torch.Tensor]) -> None:
        """Moments per parameter name (a missing name: zeros), copied."""
        def one(t, p):
            if t is None:
                return torch.zeros_like(p, dtype=torch.float32)
            return torch.tensor(np.asarray(t, np.float32), device=p.device).reshape(p.shape)

        params = self.params
        self.mu = [one(mu.get(n), p) for n, p in zip(self.names, params)]
        self.nu = [one(nu.get(n), p) for n, p in zip(self.names, params)]
        self.count = torch.tensor(int(count), dtype=torch.int32, device=params[0].device)


def create_train_state(model: BinaryClassifier, cfg: TrainConfig) -> TrainState:
    """Zero moments, count 0, the phase-1 mask, lr scale 1."""
    names = [n for n, _ in model.named_parameters()]
    dev = next(model.parameters()).device
    zeros = lambda: [torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
                     for p in model.parameters()]
    state = TrainState(
        model=model, names=names, mu=zeros(), nu=zeros(), mask=[],
        count=torch.zeros((), dtype=torch.int32, device=dev),
        step=torch.zeros((), dtype=torch.int64, device=dev),
        lr_scale=torch.ones((), device=dev),
        lr=torch.tensor(cfg.lr, dtype=torch.float32, device=dev))
    state.set_phase(PHASE1_PREFIXES)
    return state


def unfreeze_layer3(state: TrainState) -> None:
    state.set_phase(PHASE2_PREFIXES)


def bn_buffers(model: torch.nn.Module) -> List[torch.Tensor]:
    return [b for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))]


# ---------------------------------------------------------------------------
# Loss and optimizer, as plain functions on tensors
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  weights: Optional[torch.Tensor] = None,
                  total_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean negative log-likelihood over the rows weighted 1 (the zero rows
    that pad a batch to its fixed size carry weight 0). ``total_weight``
    (the global batch's Σw, under a mesh) divides in place of these rows'
    Σw, so the ranks' losses sum to the global batch's."""
    dtype = torch.promote_types(logits.dtype, torch.float32)
    logp = F.log_softmax(logits.to(dtype), dim=-1)
    nll = -logp.gather(1, labels[:, None].long())[:, 0]
    if weights is None:
        return nll.mean()
    w = weights.to(dtype)
    den = w.sum() if total_weight is None else total_weight.to(dtype)
    return (nll * w).sum() / torch.clamp(den, min=1.0)


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The share of the rows weighted 1 whose argmax is their label."""
    correct = (torch.argmax(logits, -1) == labels).float()
    if weights is None:
        return correct.mean()
    w = weights.float()
    return (correct * w).sum() / torch.clamp(w.sum(), min=1.0)


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         norm: Optional[torch.Tensor] = None) -> None:
    """optax's rule over all the tensors, in place: unchanged when ‖g‖ <
    max, else (g / ‖g‖)·max, with ‖g‖ the norm of them all (``norm``, when
    the caller computes it: a head-parallel step's spans ranks)."""
    if norm is None:
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    clip = norm >= max_norm
    torch._foreach_div_(grads, torch.where(clip, norm, 1.0))
    torch._foreach_mul_(grads, torch.where(clip, max_norm, 1.0))


def adamw_update_(g: List[torch.Tensor], p: List[torch.Tensor], mu: List[torch.Tensor],
                  nu: List[torch.Tensor], count: torch.Tensor, lr: torch.Tensor,
                  weight_decay: float, ok: torch.Tensor) -> torch.Tensor:
    """optax ``adamw(b1=0.9, b2=0.999, eps=1e-8)`` over lists of tensors, in
    place (``g`` is consumed): → the new count. eps outside the square
    root; the decay ``wd·p`` added before the lr. Where ``ok`` is false
    nothing changes: ``g`` must then be zeros, the decays act as 1, the lr
    as 0 and the count stays (no host sync, no copy of the old state)."""
    b1, b2 = (torch.where(ok, b, 1.0) for b in (B1, B2))
    a1, a2 = (torch.where(ok, 1.0 - b, 0.0) for b in (B1, B2))
    g2 = torch._foreach_mul(g, g)
    torch._foreach_mul_(g2, a2)
    torch._foreach_mul_(nu, b2)
    torch._foreach_add_(nu, g2)
    torch._foreach_mul_(g, a1)
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, g)
    c = (count + 1).float()  # a taken step's bias correction; u is zeroed otherwise
    den = torch._foreach_div(nu, 1.0 - torch.pow(B2, c))
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, EPS)
    u = torch._foreach_div(mu, 1.0 - torch.pow(B1, c))
    torch._foreach_div_(u, den)
    torch._foreach_add_(u, p, alpha=weight_decay)
    torch._foreach_mul_(u, torch.where(ok, -lr, 0.0))
    torch._foreach_add_(p, u)
    return torch.where(ok, count + 1, count)


# ---------------------------------------------------------------------------
# Features
# ---------------------------------------------------------------------------

@torch.no_grad()
def features_from_waveforms(
    waveforms: torch.Tensor,
    spec_cfg: SpectrogramConfig,
    augment: Optional[SpecAugmentConfig],
    generator: Optional[torch.Generator],
    sample_rate: int,
    dft_mode: Optional[str] = None,
    rows: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """[B, T] float32 or int16 → [B, 3, H, W] model input. In order: int16
    dequantisation, the waveform augmentation (train, when enabled), the
    dB-only log-mel (``dft_mode='pallas'``: the log-mel kernel with
    ``standardize=False``, which takes the int16 codes as they are and
    dequantizes them exactly as the first step does; otherwise the plain
    mel by ``dft_mode``, 'gemm' by default), SpecAugment (train),
    standardize, and the crop (train) after the resize, or before the
    native zero-pad in native mode. Train mode, as in the reference: an
    enabled ``augment`` and a ``generator``. ``rows`` = (first row, global
    rows): ``waveforms`` are those rows of a global batch, and every random
    draw is the global batch's, cut to them."""
    train_mode = augment is not None and augment.enabled and generator is not None
    wave_aug = train_mode and augment.wave_enabled
    if waveforms.dtype == torch.int16 and (wave_aug or dft_mode != "pallas"):
        waveforms = waveforms.float() / 32768.0
    if wave_aug:
        waveforms = waveform_augment.augment_waveforms(generator, waveforms, augment,
                                                       sample_rate, rows)
    if dft_mode == "pallas":
        db = fused_log_mel_factored(waveforms, spec_cfg, sample_rate, standardize=False)
    else:
        mel = melspec.mel_spectrogram(waveforms, spec_cfg, sample_rate,
                                      dft_mode=dft_mode or "gemm")
        db = melspec.amplitude_to_db(mel, spec_cfg.top_db)
    if train_mode:
        db = masking.spec_augment(generator, db, augment.freq_mask_param,
                                  augment.time_mask_param, rows=rows)
    z = melspec.standardize(db, spec_cfg.eps)
    if spec_cfg.is_native:
        if train_mode:
            z = image_ops.random_resized_crop(generator, z, scale=(0.8, 1.0), rows=rows)
        z = melspec.finalize_features(z, spec_cfg)
    else:
        z = melspec.finalize_features(z, spec_cfg)
        if train_mode:
            z = image_ops.random_resized_crop(generator, z, scale=(0.8, 1.0), rows=rows)
    x = melspec.replicate_channels(z, spec_cfg.out_channels)
    if x.device.type == "cuda":
        x = x.contiguous(memory_format=torch.channels_last)
    return x


def _precision(compute_dtype: torch.dtype, device: torch.device):
    """bf16: autocast (bf16 convs and matmuls on float32 parameters);
    float32: TF32 off for the span."""
    if compute_dtype == torch.bfloat16:
        return torch.autocast(device.type, dtype=torch.bfloat16)
    return exact_float32() if device.type == "cuda" else contextlib.nullcontext()


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def gradients(loss: torch.Tensor, params: List[torch.Tensor],
              compute_dtype: torch.dtype) -> Tuple[Optional[torch.Tensor], ...]:
    """d loss / d params (None where a parameter is not in the graph), with
    TF32 off for a float32 backward on the card."""
    exact = compute_dtype == torch.float32 and params[0].device.type == "cuda"
    with exact_float32() if exact else contextlib.nullcontext():
        return torch.autograd.grad(loss, params, allow_unused=True)


def sync_gradients(grads, indices: List[int], mesh, axis: Optional[str] = DATA_AXIS) -> list:
    """The gradients at ``indices`` summed over the ranks along ``axis``
    (None: every rank) by one all-reduce of them flattened together; a
    None (a parameter out of the graph, on every rank alike) stays None."""
    grads = list(grads)
    idx = [i for i in indices if grads[i] is not None]
    if not idx:
        return grads
    flat = mesh.all_reduce(torch.cat([grads[i].reshape(-1) for i in idx]), axis)
    offset = 0
    for i in idx:
        n = grads[i].numel()
        grads[i] = flat[offset:offset + n].view_as(grads[i])
        offset += n
    return grads


@torch.no_grad()
def apply_update_(state: TrainState, grads, loss: torch.Tensor, cfg: TrainConfig,
                  buffers: List[torch.Tensor], saved: List[torch.Tensor],
                  mask: Optional[List[float]] = None,
                  norm_fn: Optional[Callable] = None) -> torch.Tensor:
    """The optimizer half of a step, in place: the gradients masked to the
    trainable parameters (``mask``, default ``state.mask``; a parameter that
    is trainable but not in the graph takes a zero gradient, so AdamW still
    decays it, as optax does), one global-norm clip over them all, AdamW at
    the plateau's lr, the frozen moments decayed, and the NaN-skip: where
    ``loss`` is not finite, parameters, moments, count and the BN
    ``buffers`` (put back from ``saved``) keep their values. The step
    counter always advances. Under a mesh ``grads`` are the summed ones
    and ``loss`` the global batch's, so every rank takes the same update;
    ``norm_fn(live indices, gradients)`` gives the clip's global norm when
    the ranks hold different parameters. → ``ok``, the device flag."""
    mask = state.mask if mask is None else mask
    params = state.params
    # a frozen parameter's masked gradient is zero: it keeps its value
    # and its moments only decay, so only the live ones are updated
    live = [i for i, m in enumerate(mask) if m]
    frozen = [i for i, m in enumerate(mask) if not m]
    ok = torch.isfinite(loss)
    g = [grads[i].float() if grads[i] is not None
         else torch.zeros_like(params[i], dtype=torch.float32) for i in live]
    for t in g:  # a skipped step's update is zero (a NaN cannot be scaled away)
        t.masked_fill_(~ok, 0.0)
    clip_by_global_norm_(g, cfg.grad_clip_norm, None if norm_fn is None else norm_fn(live, g))
    lr = state.lr_scale * cfg.lr  # float32, no host-to-device copy
    state.count = adamw_update_(g, [params[i] for i in live], [state.mu[i] for i in live],
                                [state.nu[i] for i in live], state.count, lr,
                                cfg.weight_decay, ok)
    if frozen:
        torch._foreach_mul_([state.mu[i] for i in frozen], torch.where(ok, B1, 1.0))
        torch._foreach_mul_([state.nu[i] for i in frozen], torch.where(ok, B2, 1.0))
    for b, old in zip(buffers, saved):  # BN statistics moved in the forward
        torch.where(ok, b, old, out=b)
    state.lr = torch.where(ok, lr, state.lr)
    state.step = state.step + 1
    return ok


def save_buffers(model: torch.nn.Module) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """(the BN running statistics, a copy of them) before a forward that
    moves them, for ``apply_update_``'s NaN-skip."""
    buffers = bn_buffers(model)
    saved = [torch.empty_like(b) for b in buffers]
    torch._foreach_copy_(saved, buffers)
    return buffers, saved


def make_train_step(
    cfg: TrainConfig,
    spec_cfg: SpectrogramConfig,
    augment: Optional[SpecAugmentConfig] = None,
    sample_rate: int = 32_000,
    reference_quirk_loss: bool = False,
    stop_grad_stage: int = 0,
    dft_mode: Optional[str] = None,
    compute_dtype: torch.dtype = torch.float32,
    mesh=None,
) -> Callable:
    """→ ``train_step(state, batch, generator) -> metrics``, which updates
    ``state`` in place. batch: {'audio': [B, T] float32 or int16, 'label':
    [B] int, 'weight': [B] float32 (optional)} on the state's device.
    metrics: {'loss', 'accuracy', 'skipped'} as device scalars.

    ``reference_quirk_loss`` reproduces the reference trainer's bug: the
    cross-entropy over the pooled backbone features taken as class scores,
    the head not in the loss and not updated. ``stop_grad_stage`` > 0 runs
    the backbone before that stage without autograd (4 in phase 1, 3 after
    layer3 unfreezes): the same updates as the masked step, with no
    backward pass through the frozen stages.

    With ``mesh`` (a ``parallel.sharding.Mesh``) the batch is this rank's
    rows along ``data`` of a global batch split evenly, and the step is the
    one-process step on the global batch: every random draw the global
    batch's, cut to these rows; BatchNorm statistics over the global batch
    (``models.resnet.sync_batch_stats``); the loss Σ w·nll over these rows
    divided by the global max(Σw, 1), so the ranks' losses sum to the
    global loss; the gradients summed over the ranks by one all-reduce; the
    metrics (loss, accuracy) by one more. Every rank then applies the same
    update and keeps the same parameters, moments and count."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        model = state.model
        device = state.count.device
        model.train()
        model.base.stop_grad_stage = stop_grad_stage
        rows = None if mesh is None else mesh.rows(batch["audio"].shape[0])
        set_dropout_generator(model, generator, rows)
        sync_batch_stats(model, mesh)
        with _precision(torch.float32, device), record_function("train_step.features"):
            x = features_from_waveforms(batch["audio"], spec_cfg, augment, generator,
                                        sample_rate, dft_mode=dft_mode, rows=rows)
        labels = batch["label"]
        weights = batch.get("weight")
        total_w = None
        if mesh is not None:
            if weights is None:
                weights = torch.ones(labels.shape, device=device)
            total_w = mesh.all_reduce(weights.float().sum()[None])[0]
        buffers, saved = save_buffers(model)
        params = state.params
        with _precision(compute_dtype, device), record_function("train_step.forward"):
            if reference_quirk_loss:
                out = model.base(x).mean(dim=(2, 3))  # pooled features AS the logits
            else:
                out = model(x)
            loss = cross_entropy(out, labels, weights, total_w)
        grads = gradients(loss, params, compute_dtype)
        mask = state.mask
        if reference_quirk_loss:
            # only the backbone is in the graph: the head gets no update
            quirk = freeze_mask(state.names, ("base",))
            mask = [m * quirk[n] for m, n in zip(mask, state.names)]
        if mesh is None:
            acc = accuracy(out, labels, weights)
        else:
            grads = sync_gradients(grads, [i for i, m in enumerate(mask) if m], mesh)
            correct = ((torch.argmax(out, -1) == labels).float() * weights.float()).sum()
            both = mesh.all_reduce(torch.stack([loss.detach(), correct]))
            loss, acc = both[0], both[1] / torch.clamp(total_w, min=1.0)
        with record_function("train_step.optimizer"):
            ok = apply_update_(state, grads, loss, cfg, buffers, saved, mask)
        return {"loss": loss.detach(), "accuracy": acc, "skipped": (~ok).float()}

    return train_step


def make_eval_step(spec_cfg: SpectrogramConfig, sample_rate: int = 32_000,
                   dft_mode: Optional[str] = None,
                   compute_dtype: torch.dtype = torch.float32) -> Callable:
    """→ ``eval_step(model, batch)`` → {'loss_sum', 'confusion' [n, n] (rows
    true, columns predicted, pad rows weighted out), 'count', 'probs'
    [B, n] softmax}, device tensors."""

    @torch.no_grad()
    def eval_step(model: BinaryClassifier, batch: Dict[str, torch.Tensor]):
        model.eval()
        with _precision(torch.float32, batch["audio"].device):  # the front end in float32
            x = features_from_waveforms(batch["audio"], spec_cfg, None, None, sample_rate,
                                        dft_mode=dft_mode)
        labels = batch["label"].long()
        weights = batch.get("weight")
        w = (weights if weights is not None else torch.ones_like(labels)).float()
        with _precision(compute_dtype, x.device):
            logits = model(x)
        logp = F.log_softmax(logits.float(), -1)
        loss_sum = (-logp.gather(1, labels[:, None])[:, 0] * w).sum()
        pred = torch.argmax(logits, -1)
        n_cls = logits.shape[-1]
        conf = torch.zeros((n_cls, n_cls), dtype=torch.float32, device=x.device)
        conf.index_put_((labels, pred), w, accumulate=True)
        return {"loss_sum": loss_sum, "confusion": conf, "count": w.sum(),
                "probs": torch.exp(logp)}

    return eval_step
