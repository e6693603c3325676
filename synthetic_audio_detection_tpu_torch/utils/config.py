"""The serving configuration: waveform, front end and decision settings.

The port's own copy of the reference package's ``utils/config.py``, cut to
the names serving uses (``AudioConfig``, ``SpectrogramConfig``,
``InferenceConfig``, ``parse_input_size``). The fields, their defaults and
the ``inference()``/``train()``/``legacy()`` presets are the reference's;
``tests/test_torch_host.py`` pins them to it. The port's functions read
these objects by attribute only, so a reference config object works in
their place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class AudioConfig:
    """Waveform-level parameters. The defaults are the reference inference
    runner's constructed values (overlap 0.0, silence 1e-3); ``legacy()``
    gives the legacy analyzer's (overlap 0.85, silence 1e-4)."""

    sample_rate: int = 32_000
    window_seconds: float = 4.0
    overlap: float = 0.0
    silence_threshold: float = 1e-3

    @property
    def window_samples(self) -> int:
        return int(self.window_seconds * self.sample_rate)

    @property
    def hop_samples(self) -> int:
        hop = int((1.0 - self.overlap) * self.window_samples)
        return max(hop, 1)

    @staticmethod
    def legacy() -> "AudioConfig":
        return AudioConfig(overlap=0.85, silence_threshold=1e-4)


@dataclass(frozen=True)
class SpectrogramConfig:
    """Mel-spectrogram front end: n_fft 2048, hop 512, 128 mels in
    [20, 12000] Hz, power-2 spectrogram, dB with top_db 80,
    per-spectrogram standardization, bilinear resize to ``out_size``² and
    channel triplication. ``mel_norm`` is None at training time and
    'slaney' at inference (the reference's train/infer mismatch, kept).
    ``out_size=0`` is the native mode: the standardized log-mel at its own
    [n_mels, n_frames] resolution, frames zero-padded to a multiple of 128."""

    n_fft: int = 2048
    hop_length: int = 512
    win_length: Optional[int] = None  # defaults to n_fft
    n_mels: int = 128
    f_min: float = 20.0
    f_max: float = 12_000.0
    power: float = 2.0
    top_db: float = 80.0
    mel_norm: Optional[str] = None  # None (training) or 'slaney' (inference)
    mel_scale: str = "htk"
    center: bool = True
    pad_mode: str = "reflect"
    eps: float = 1e-6  # std epsilon in per-spectrogram normalization
    out_size: int = 512  # square resize target; 0 = native mel resolution
    out_channels: int = 3

    @property
    def win(self) -> int:
        return self.win_length or self.n_fft

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def is_native(self) -> bool:
        return self.out_size == 0

    def num_frames(self, num_samples: int) -> int:
        if self.center:
            return 1 + num_samples // self.hop_length
        return 1 + (num_samples - self.win) // self.hop_length

    def model_input_hw(self, num_samples: int = 128_000) -> tuple:
        """(H, W) of the model's input: the square resize target, or in
        native mode [n_mels, frames padded up to a multiple of 128]."""
        if self.is_native:
            frames = self.num_frames(num_samples)
            return self.n_mels, -(-frames // 128) * 128
        return self.out_size, self.out_size

    @staticmethod
    def train() -> "SpectrogramConfig":
        return SpectrogramConfig(mel_norm=None)

    @staticmethod
    def inference(out_size: int = 512) -> "SpectrogramConfig":
        # 512 = reference fidelity, 256 = the fast mode, 0 = native
        return SpectrogramConfig(mel_norm="slaney", out_size=out_size)


def parse_input_size(value) -> int:
    """CLI ``--input-size``: a positive int (square resize target) or
    ``native``/``0`` for the native mode. Raises ValueError otherwise, which
    argparse renders as an invalid-argument error."""
    v = str(value).strip().lower()
    if v == "native":
        return 0
    n = int(v)
    if n < 0:
        raise ValueError(f"invalid input size {value!r}")
    return n


@dataclass(frozen=True)
class InferenceConfig:
    threshold: float = 0.5
    confidence_threshold: float = 0.45
    smooth: bool = False
    smooth_sigma: float = 2.0
    batch_size: int = 128
    max_windows: int = 4096  # static upper bound per bucket
    # unrounded timestamps and percentages by default (byte-faithful JSON);
    # rounding (3 dp times, 2 dp percentages) is opt-in
    round_floats: bool = False
    # apply a checkpoint's temperature calibration when it carries one
    apply_calibration: bool = True
    # synthetic columns that must clear their threshold to override a Real
    # verdict (1 = the reference's unanimity rule)
    syn_override_k: int = 1
    # the calibration's per-column operating points in place of the single
    # threshold (needs a calibrated checkpoint)
    per_column_thresholds: bool = False
    # decide Real/Synthetic from the generic head (needs a generic-head
    # ensemble); attribution stays with the specialist heads
    generic_verdict: bool = False
