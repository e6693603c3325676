"""The submodel trainer's phase-2 step, plainly, in float32: the features
(the clamped dB log-mel with SpecAugment's masks, standardized, resized,
randomly cropped, on three channels), the forward with train-mode
BatchNorm and dropout, the mean cross-entropy, the gradients of the
trainable leaves (head, layer4, layer3; the stem and stages 1-2 run
without autograd), optax's global-norm clip, and optax's AdamW (b1 0.9,
b2 0.999, eps 1e-8 outside the root, decoupled decay added before the
learning rate, one count for every leaf). The step's random draws come
from a generator seeded as the trainer's, in the trainer's order: each
step's two masks, its crop boxes, then the head's two dropout masks.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import backbone, frontend, resnet

B1, B2, EPS = 0.9, 0.999, 1e-8
STATS = ("running_mean", "running_var")


def leaves(base: Dict[str, torch.Tensor], head: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The sub-model's parameters (BN running statistics left out), keyed
    as the classifier names them: ``base.*``, ``head.*``."""
    out = {f"base.{k}": v for k, v in base.items() if not k.endswith(STATS)}
    out.update({f"head.{k}": v for k, v in head.items() if not k.endswith(STATS)})
    return out


def trainable(name: str, prefixes: Sequence[str]) -> bool:
    return any(part.startswith(p) for part in name.split(".") for p in prefixes)


def steps(cfg: Dict, base: Dict[str, torch.Tensor], head: Dict[str, torch.Tensor],
          batches: List[Tuple[torch.Tensor, torch.Tensor]], g: torch.Generator,
          q=None) -> Dict:
    """Run one step per batch (int16 audio [R, T], labels [R]) from the
    given weights. → {'losses': [...], 'grad_norms': {leaf: ‖clipped
    gradient of the first step‖}, 'params': {leaf: value after the last
    step}} for the trainable leaves."""
    tr, sr = cfg["train"], cfg["audio"]["sample_rate"]
    spec = dict(cfg["spectrogram"], mel_norm=tr["mel_norm"])
    m = cfg["model"]
    params = {k: v.detach().clone().float() for k, v in leaves(base, head).items()}
    names = [k for k in params if trainable(k, tr["trainable"])]
    for k in names:
        params[k].requires_grad_(True)
    stats = {k: v for k, v in base.items() if k.endswith(STATS)}
    hstats = {k: v for k, v in head.items() if k.endswith(STATS)}
    mu = [torch.zeros_like(params[k]) for k in names]
    nu = [torch.zeros_like(params[k]) for k in names]
    losses, grad_norms = [], {}
    for step, (audio, labels) in enumerate(batches, start=1):
        with frontend.exact():
            z = frontend.training_features(audio.float() / 32768.0, spec, tr, sr, g, q)
            x = z[:, None].expand(-1, m["in_channels"], -1, -1)
            bsd = {k[5:]: v for k, v in params.items() if k.startswith("base.")} | stats
            hsd = {k[5:]: v for k, v in params.items() if k.startswith("head.")} | hstats
            pooled = backbone(m).forward(x, bsd, m, train=True, q=q,
                                         grad_from_stage=tr["stop_grad_stage"])
            logits = resnet.head(pooled, hsd, train=True, q=q, g=g, dropout=m["head_dropout"])
            loss = F.cross_entropy(logits, labels.long())
            grads = torch.autograd.grad(loss, [params[k] for k in names])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum((t.double() ** 2).sum() for t in grads)).float()
            scale = tr["grad_clip_norm"] / norm if norm >= tr["grad_clip_norm"] else 1.0
            grads = [t * scale for t in grads]
            if step == 1:
                grads1 = dict(zip(names, grads))
                grad_norms = {k: float(t.norm()) for k, t in grads1.items()}
            for i, k in enumerate(names):
                p = params[k]
                mu[i] = B1 * mu[i] + (1 - B1) * grads[i]
                nu[i] = B2 * nu[i] + (1 - B2) * grads[i] ** 2
                m_hat = mu[i] / (1 - B1 ** step)
                v_hat = nu[i] / (1 - B2 ** step)
                p -= tr["lr"] * (m_hat / (torch.sqrt(v_hat) + EPS) + tr["weight_decay"] * p)
    return {"losses": losses, "grad_norms": grad_norms, "grads": grads1,
            "params": {k: params[k].detach() for k in names}}
