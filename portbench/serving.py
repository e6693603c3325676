"""What the serving cells share: the port's serving objects built from a
configuration file and the benchmark's weights, the harness's wrappers
around the port's functions (spans, row and dispatch counts, the logits
the timed path produced), and the reference's side of the comparison.

The wrappers replace names on the pipeline instance and the module
globals that ``infer.pipeline`` looks up for the front end and the
ensemble; ``Probe.remove`` puts them back. No file of the port changes.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import correct
from portbench.reference import serve as ref_serve
from portbench.reference import weights as ref_weights
from portbench.trace import Tracer


def port_configs(cfg: Dict):
    from synthetic_audio_detection_tpu_torch.utils.config import (
        AudioConfig, InferenceConfig, SpectrogramConfig)

    a, s, v = cfg["audio"], cfg["spectrogram"], cfg["serve"]
    audio = AudioConfig(sample_rate=a["sample_rate"], window_seconds=a["window_seconds"],
                        overlap=a["overlap"], silence_threshold=a["silence_threshold"])
    spec = SpectrogramConfig(**{k: s[k] for k in (
        "n_fft", "hop_length", "n_mels", "f_min", "f_max", "power", "top_db", "mel_norm",
        "mel_scale", "center", "pad_mode", "eps", "out_size", "out_channels")})
    infer = InferenceConfig(threshold=v["threshold"], batch_size=v["batch_size"])
    return audio, spec, infer


def load_strict(module: torch.nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    missing, unexpected = module.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(f"weights do not fit: missing {missing[:4]}, unexpected {unexpected[:4]}")


def build_ensemble(cfg: Dict, weights, device):
    """The port's ``MultiHeadEnsemble`` in the configuration's layout, its
    modules made on ``device`` and loaded with ``weights``."""
    from synthetic_audio_detection_tpu_torch.ensemble.multihead import MultiHeadEnsemble
    from synthetic_audio_detection_tpu_torch.models.head import BinaryHead
    from synthetic_audio_detection_tpu_torch.models.resnet import create_resnet

    m = cfg["model"]
    with torch.device(device):
        bbs = [create_resnet(m["arch"], m["in_channels"]) for _ in weights["backbones"]]
        heads = [BinaryHead(m["widths"][-1], tuple(m["head_hidden"]), tuple(m["head_dropout"]),
                            m["outputs"]) for _ in weights["heads"]]
    for mod, sd in zip(bbs + heads, weights["backbones"] + weights["heads"]):
        load_strict(mod, sd)
    return MultiHeadEnsemble(bbs, heads, m["class_names"], m["arch"])


def build_pipeline(cfg: Dict, seed: int, device):
    from synthetic_audio_detection_tpu_torch.infer.pipeline import InferencePipeline

    audio, spec, infer = port_configs(cfg)
    weights = ref_weights.draw(cfg["model"], seed, device)
    ens = build_ensemble(cfg, weights, device)
    del weights
    v = cfg["serve"]
    return InferencePipeline(ens, audio=audio, spec=spec, infer=infer,
                             compute_dtype=getattr(torch, v["compute_dtype"]), device=device,
                             transport_dtype=v["transport_dtype"],
                             conv3x3_max_channels=v["conv3x3_max_channels"])


class Probe:
    """The harness's wrappers on one pipeline: spans (``dispatch``,
    ``forward``, ``frontend``, ``backbone``), the rows of every forward,
    and the served logits that ``analyze_windows`` decided from, by the
    caller's request id. ``fault`` plants one of ``FAULTS``."""

    def __init__(self, pipe, tracer: Tracer, fault: Optional[str] = None):
        import synthetic_audio_detection_tpu_torch.infer.pipeline as P
        from synthetic_audio_detection_tpu_torch.ops import melspec

        self.pipe, self.tracer = pipe, tracer
        self.rows: List[int] = []
        self.request: Optional[int] = None
        self.last: Optional[np.ndarray] = None
        self.served: Dict[int, np.ndarray] = {}
        self._globals = [(P, "serving_log_mel", "frontend"), (melspec, "finalize_features", "frontend"),
                         (P, "ensemble_per_head_logits", "backbone")]
        self._saved = [(mod, name, getattr(mod, name)) for mod, name, _ in self._globals]
        for mod, name, layer in self._globals:
            setattr(mod, name, self._spanned(getattr(mod, name), layer))
        if fault == "frontend":
            P.ensemble_per_head_logits = _shifted(
                P.ensemble_per_head_logits, max(1, pipe.spec.out_size // pipe.spec.n_mels))
        fwd, lfw, aw = pipe._forward, pipe.logits_for_windows, pipe.analyze_windows

        def forward(batch, *a, **k):
            self.rows.append(int(batch.shape[0]))
            with tracer.span("forward"):
                if fault in (None, "frontend"):
                    return fwd(batch, *a, **k)
                return broken(fwd, batch, fault)

        def logits_for_windows(windows):
            with tracer.span("dispatch"):
                self.last = lfw(windows)
            return self.last

        def analyze_windows(windows, stamps, smooth=None, logits=None):
            out = aw(windows, stamps, smooth=smooth, logits=logits)
            if self.request is not None:
                self.served[self.request] = logits if logits is not None else self.last
            return out

        pipe._forward, pipe.logits_for_windows, pipe.analyze_windows = (
            forward, logits_for_windows, analyze_windows)

    def _spanned(self, fn, layer):
        tracer = self.tracer

        def wrapped(*a, **k):
            with tracer.span(layer):
                return fn(*a, **k)
        return wrapped

    def reset(self) -> None:
        self.rows.clear()
        self.served.clear()

    def remove(self) -> None:
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        for name in ("_forward", "logits_for_windows", "analyze_windows"):
            self.pipe.__dict__.pop(name, None)


FAULTS = ("half", "altered", "permuted", "frontend")


def broken(fwd, batch: torch.Tensor, fault: str) -> torch.Tensor:
    """A forward with a planted fault, for the check's own tests: ``half``
    computes the first half of the rows and leaves the rest at zero;
    ``altered`` negates every sixteenth row's logits where they are
    produced; ``permuted`` hands each row the logits of the row before it
    in the batch. (``frontend``, features off by one mel band, planted
    between the front end and the backbone by ``_shifted``, is read by
    ``portbench.readings`` and not caught at the cells' sizes: PERF.md.)"""
    if fault == "half":
        h = max(1, batch.shape[0] // 2)
        out = fwd(batch[:h])
        return torch.cat([out, out.new_zeros((batch.shape[0] - h, out.shape[1]))])
    if fault == "altered":
        out = fwd(batch).clone()
        out[::16] = -out[::16]
        return out
    if fault == "permuted":
        return torch.roll(fwd(batch), 1, dims=0)
    raise ValueError(f"no fault {fault!r} for a serving cell; choose from {FAULTS}")


def _shifted(per_head_logits, rows: int):
    """The ensemble fed features moved up one mel band (``rows`` image rows;
    the lowest band takes the highest's values), as a filterbank off by
    one band would make them."""
    def shifted(ensemble, x, *a, **k):
        return per_head_logits(ensemble, torch.roll(x, rows, dims=2), *a, **k)
    return shifted


def reference_check(cfg: Dict, seed: int, device, served: np.ndarray, served_labels: List[str],
                    windows: np.ndarray, stamp_errors: int, failed: int,
                    limits: Dict[str, float], control=None) -> Dict[str, Dict[str, float]]:
    """Draw the weights again, compute the reference logits of ``windows``
    ([n, T] float32, the reference's own slicing) and compare them with
    the served logits and labels. With ``control`` (a quantizer) the
    reference computed at that precision stands in the port's place."""
    weights = ref_weights.draw(cfg["model"], seed, device)
    x = torch.from_numpy(windows).to(device)
    ref = ref_serve.logits(x, cfg, weights).cpu().numpy()
    names, thr = cfg["model"]["class_names"], cfg["serve"]["threshold"]
    if control is not None:
        served = ref_serve.logits(x, cfg, weights, control).cpu().numpy()
        served_labels = ref_serve.verdicts(served, names, thr)
    decided = ref_serve.verdicts(served, names, thr)
    return correct.serving(served, ref, served_labels, decided, stamp_errors, failed, limits)


def sample(n_total: int, n: int, seed: int, stream: int = 7) -> np.ndarray:
    """A seeded, sorted sample of ``n`` indices out of ``n_total``."""
    rng = np.random.default_rng(ref_weights.substream(seed, stream))
    return np.sort(rng.choice(n_total, size=min(n, n_total), replace=False))
