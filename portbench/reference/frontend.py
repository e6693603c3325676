"""The log-mel front end in float32, the plain way: reflect-padded frames,
the periodic Hann window, the real FFT's power, the triangular mel
filterbank (torchaudio's ``melscale_fbanks``), dB with each spectrogram's
top-80 clamp, per-spectrogram standardization (unbiased std), and the
antialiased bilinear resize (align_corners False) to out_size². For
training: the clamped dB, SpecAugment's two masks, the standardization,
the resize, then the random resized crop, drawn as the trainer draws them.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from portbench.work.frontend import filterbank


def exact():
    """TF32 off for float32 matmuls and convolutions, restored after."""
    return _Flags()


class _Flags:
    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
        return False


def power_mel(waveforms: torch.Tensor, spec: Dict, sample_rate: int, q=None) -> torch.Tensor:
    """[B, T] float32 → mel power [B, n_mels, frames]. With ``q`` (the
    control) the DFT is two matmuls, cos and sin, and every matmul's
    operands are rounded by ``q``."""
    n_fft, hop = spec["n_fft"], spec["hop_length"]
    x = F.pad(waveforms.float()[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = x.unfold(1, n_fft, hop)
    n = torch.arange(n_fft, dtype=torch.float64, device=x.device)
    hann = (0.5 - 0.5 * torch.cos(2.0 * math.pi * n / n_fft)).float()
    fb = torch.as_tensor(filterbank(spec, sample_rate).astype(np.float32), device=x.device)
    if q is None:
        X = torch.fft.rfft(frames * hann, dim=-1)
        p = X.real ** 2 + X.imag ** 2
        return torch.matmul(p, fb).transpose(1, 2)
    ang = 2.0 * math.pi * n[:, None] * torch.arange(n_fft // 2 + 1, dtype=torch.float64,
                                                     device=x.device)[None] / n_fft
    xw = q(frames * hann)
    p = torch.matmul(xw, q(torch.cos(ang).float())) ** 2 + torch.matmul(xw, q(torch.sin(ang).float())) ** 2
    return torch.matmul(q(p), q(fb)).transpose(1, 2)


def to_db(mel: torch.Tensor, top_db: float) -> torch.Tensor:
    db = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
    return torch.maximum(db, db.amax(dim=(1, 2), keepdim=True) - top_db)


def standardize(z: torch.Tensor, eps: float) -> torch.Tensor:
    n = z.shape[1] * z.shape[2]
    mean = z.mean(dim=(1, 2), keepdim=True)
    std = torch.sqrt(((z - mean) ** 2).sum(dim=(1, 2), keepdim=True) / (n - 1))
    return (z - mean) / (std + eps)


def resize(z: torch.Tensor, size: int) -> torch.Tensor:
    return F.interpolate(z[:, None], size=(size, size), mode="bilinear", align_corners=False,
                         antialias=True)[:, 0]


def serving_features(waveforms: torch.Tensor, spec: Dict, sample_rate: int, q=None) -> torch.Tensor:
    """[B, T] → [B, out, out] standardized log-mel images, float32."""
    with exact():
        z = standardize(to_db(power_mel(waveforms, spec, sample_rate, q), spec["top_db"]), spec["eps"])
        return resize(z, spec["out_size"])


# ---------------------------------------------------------------------------
# Training: the trainer's draws, in its order, from the step's generator
# ---------------------------------------------------------------------------

def _mask_axis(g: torch.Generator, b: int, dim: int, param: int, device) -> torch.Tensor:
    """Keep [B, dim]: a span of width ~ U[0, param) at start ~ U[0, dim − width)."""
    width = torch.rand((b, 1), generator=g, device=device) * float(param)
    start = torch.rand((b, 1), generator=g, device=device) * (dim - width)
    pos = torch.arange(dim, dtype=torch.float32, device=device)[None]
    return ~((pos >= start) & (pos < start + width))


def _crop_weights(n: int, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """[B, n_in, n_out] linear resampling weights: output p samples input
    (p + ½)/scale − shift/scale − ½ with a unit triangle, normalized to sum
    1, zero where the sample falls outside [−½, n − ½]."""
    dev = scale.device
    src = ((torch.arange(n, dtype=torch.float32, device=dev) + 0.5)[None] / scale[:, None]
           - (shift / scale)[:, None] - 0.5)
    dist = (src[:, None, :] - torch.arange(n, dtype=torch.float32, device=dev)[None, :, None]).abs()
    w = torch.clamp(1.0 - dist, min=0.0)
    tot = w.sum(dim=1, keepdim=True)
    w = torch.where(tot.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(tot != 0, tot, torch.ones_like(tot)), torch.zeros_like(w))
    inside = (src >= -0.5) & (src <= n - 0.5)
    return torch.where(inside[:, None, :], w, torch.zeros_like(w))


def random_resized_crop(g: torch.Generator, img: torch.Tensor, scale=(0.8, 1.0),
                        ratio=(3.0 / 4.0, 4.0 / 3.0)) -> torch.Tensor:
    b, h, w = img.shape
    u = torch.rand((4, b), generator=g, device=img.device)
    area = h * w * (scale[0] + (scale[1] - scale[0]) * u[0])
    aspect = torch.exp(math.log(ratio[0]) + (math.log(ratio[1]) - math.log(ratio[0])) * u[1])
    cw = torch.clamp(torch.sqrt(area * aspect), 1.0, float(w))
    ch = torch.clamp(torch.sqrt(area / aspect), 1.0, float(h))
    top, left = u[2] * (h - ch), u[3] * (w - cw)
    sy, sx = h / ch, w / cw
    wy = _crop_weights(h, sy, -top * sy)
    wx = _crop_weights(w, sx, -left * sx)
    return torch.einsum("bhw,bhi,bwj->bij", img, wy, wx)


def training_features(waveforms: torch.Tensor, spec: Dict, train: Dict, sample_rate: int,
                      g: Optional[torch.Generator], q=None) -> torch.Tensor:
    """[B, T] float32 → [B, out, out] training images: dB, SpecAugment,
    standardize, resize, crop (without ``g``: the eval features)."""
    with exact():
        db = to_db(power_mel(waveforms, spec, sample_rate, q), spec["top_db"])
        if g is not None:
            b, m, t = db.shape
            keep = (_mask_axis(g, b, m, train["freq_mask_param"], db.device)[:, :, None]
                    & _mask_axis(g, b, t, train["time_mask_param"], db.device)[:, None, :])
            db = torch.where(keep, db, torch.zeros_like(db))
        z = resize(standardize(db, spec["eps"]), spec["out_size"])
        if g is not None:
            z = random_resized_crop(g, z, tuple(train["crop_scale"]))
        return z
