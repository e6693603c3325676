"""The configuration: waveform, front end, training and decision settings.

The port's own copy of the reference package's ``utils/config.py``, cut to
the names serving and the submodel trainer use (``AudioConfig``,
``SpectrogramConfig``, ``SpecAugmentConfig``, ``TrainConfig``,
``InferenceConfig``, ``parse_input_size``, ``add_wave_augment_args``,
``spec_augment_from_args``). The fields, their defaults and
the ``inference()``/``train()``/``legacy()`` presets are the reference's;
``tests/test_torch_host.py`` pins them to it. The port's functions read
these objects by attribute only, so a reference config object works in
their place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


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
class SpecAugmentConfig:
    """Train-time augmentation: one frequency and one time mask on the dB
    plane (the reference's FrequencyMasking(15) and TimeMasking(35)), and
    the on-device waveform augmentation, off unless its probabilities are
    set (``--wave-augment``)."""

    freq_mask_param: int = 15
    time_mask_param: int = 35
    enabled: bool = True
    # waveform-domain augmentation (applied before the mel, train mode only)
    wave_noise_prob: float = 0.0       # P(add white noise) per example
    wave_snr_db: Tuple[float, float] = (5.0, 30.0)
    wave_lowpass_prob: float = 0.0     # P(random low-pass channel) per example
    wave_lowpass_hz: Tuple[float, float] = (4000.0, 15000.0)
    wave_taps: int = 63                # FIR length (odd)

    @property
    def wave_enabled(self) -> bool:
        return self.wave_noise_prob > 0.0 or self.wave_lowpass_prob > 0.0


def add_wave_augment_args(p) -> None:
    """The trainer CLI's flags for the on-device waveform augmentation
    (read by ``spec_augment_from_args``)."""
    g = p.add_argument_group("waveform augmentation (train-time, on device)")
    g.add_argument("--wave-augment", action="store_true",
                   help="Enable fresh per-step waveform augmentation inside "
                   "the train step: additive white noise at a random SNR and "
                   "a random low-pass channel")
    g.add_argument("--wave-noise-prob", type=float, default=0.5,
                   help="P(add noise) per example (with --wave-augment)")
    g.add_argument("--wave-snr-db", nargs=2, type=float, default=[5.0, 30.0],
                   metavar=("MIN", "MAX"), help="Noise SNR range in dB")
    g.add_argument("--wave-lowpass-prob", type=float, default=0.25,
                   help="P(low-pass channel) per example (with --wave-augment)")
    g.add_argument("--wave-lowpass-hz", nargs=2, type=float,
                   default=[4000.0, 15000.0], metavar=("MIN", "MAX"),
                   help="Low-pass cutoff range in Hz")


def spec_augment_from_args(args) -> SpecAugmentConfig:
    """SpecAugmentConfig from trainer-CLI args: the reference's masking,
    plus the waveform fields when --wave-augment is set."""
    if not getattr(args, "wave_augment", False):
        return SpecAugmentConfig()
    return SpecAugmentConfig(
        wave_noise_prob=args.wave_noise_prob,
        wave_snr_db=tuple(args.wave_snr_db),
        wave_lowpass_prob=args.wave_lowpass_prob,
        wave_lowpass_hz=tuple(args.wave_lowpass_hz),
    )


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (the reference trainer's flags and
    constants: AdamW at weight decay 0.01, clip 0.5, ReduceLROnPlateau
    0.5/2, layer3 unfrozen at epochs // 3)."""

    data_dir: str = "./dataset"
    batch_size: int = 32
    epochs: int = 100
    lr: float = 1e-3
    weight_decay: float = 0.01
    grad_clip_norm: float = 0.5
    seed: int = 42
    workers: int = 20
    checkpoint_dir: str = "./checkpoints"
    resume: str = ""
    class0: str = "Real"
    class1: str = "Class1"
    # other generators' class folders trained as class0 (hard negatives)
    hard_negative_classes: tuple = ()
    # ReduceLROnPlateau(mode='min', factor=0.5, patience=2)
    plateau_factor: float = 0.5
    plateau_patience: int = 2
    # layer3 unfreezes at epochs // 3
    unfreeze_layer3_at_fraction: float = 1.0 / 3.0
    log_every_steps: int = 100
    # True: the reference's optimizer never holds layer3, so its unfreeze
    # changes no weight; False trains layer3 after the unfreeze
    reference_quirk_frozen_layer3: bool = False
    # 'threads' (data/dataset.py) or 'grain' (worker processes,
    # data/grain_pipeline.py)
    data_backend: str = "threads"
    # 'native' (msgpack + the .pth twin) or 'orbax' (step-indexed, asynchronous,
    # with retention: checkpoints/orbax_io.py; + the .pth twin)
    checkpoint_backend: str = "native"
    # the space-to-depth stage 1 is not ported: must stay False
    s2d_stage1: bool = False
    # no backward pass through the frozen stages
    stop_grad_boundary: bool = True
    # compute dtype of the train step ('float32' | 'bfloat16'); parameters,
    # optimizer state, loss and BN statistics stay float32
    compute_dtype: str = "float32"
    # the step's mel DFT: '' = the default ('pallas', the log-mel kernel,
    # under bf16 on the card; 'gemm' otherwise), or 'fft' | 'gemm' |
    # 'factored' | 'pallas'
    mel_dft: str = ""
    # waveform transport: '' = auto (int16 under bf16 on the card, float32
    # otherwise), or 'float32' | 'int16'
    transport_dtype: str = ""


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
