"""SpecAugment: one frequency mask, then one time mask, on the dB plane (the
reference package's ``ops/masking.py``; torchaudio's FrequencyMasking(15)
and TimeMasking(35), as the reference trainer applies them before
standardizing).

Split into a draw and an apply: ``spec_augment_draw`` takes its uniforms
from an explicit ``torch.Generator`` (value ~ U[0, param), start ~
U[0, dim − value), per example and axis, as the reference draws them from
its PRNG key); ``spec_augment_apply`` is a plain function of those draws,
so the same draws give the same planes in both packages.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from synthetic_audio_detection_tpu_torch.parallel.sharding import rows_of


def _axis_draw(generator: Optional[torch.Generator], batch: int, dim: int, param: int,
               device) -> Dict[str, torch.Tensor]:
    value = torch.rand((batch, 1), generator=generator, device=device) * float(param)
    start = torch.rand((batch, 1), generator=generator, device=device) * (dim - value)
    return {"value": value, "start": start}


def spec_augment_draw(generator: Optional[torch.Generator], batch: int, n_mels: int,
                      n_frames: int, freq_mask_param: int = 15, time_mask_param: int = 35,
                      device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """{'freq': {'value', 'start'} [B, 1], 'time': {...}} float32."""
    return {"freq": _axis_draw(generator, batch, n_mels, freq_mask_param, device),
            "time": _axis_draw(generator, batch, n_frames, time_mask_param, device)}


def _keep(draw: Dict[str, torch.Tensor], dim: int) -> torch.Tensor:
    pos = torch.arange(dim, dtype=torch.float32, device=draw["value"].device)[None, :]
    start, value = draw["start"], draw["value"]
    return ~((pos >= start) & (pos < start + value))


def spec_augment_apply(spec: torch.Tensor, draws: Dict[str, Dict[str, torch.Tensor]],
                       mask_value: float = 0.0) -> torch.Tensor:
    """spec [B, n_mels, T]: cells in [start, start + value) of either axis
    set to ``mask_value``."""
    _, m, t = spec.shape
    keep = _keep(draws["freq"], m)[:, :, None] & _keep(draws["time"], t)[:, None, :]
    return torch.where(keep, spec, torch.full_like(spec, mask_value))


def spec_augment(generator: Optional[torch.Generator], spec: torch.Tensor,
                 freq_mask_param: int = 15, time_mask_param: int = 35,
                 mask_value: float = 0.0, rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``rows``: as ``waveform_augment.augment_waveforms``'s."""
    b, m, t = spec.shape
    draws = spec_augment_draw(generator, rows[1] if rows else b, m, t, freq_mask_param,
                              time_mask_param, spec.device)
    return spec_augment_apply(spec, rows_of(draws, rows, b), mask_value)
