"""Self-contained serving artifacts (``torch.export``; the reference
package's ``infer/export.py``).

The artifact holds the whole serving program of a merged ensemble, from
int16 PCM (or float32) windows to the ``[B, N+1]`` logits: the
dequantization, the float32 GEMM log-mel front end, the resize, the plain
ResNet backbones in the compute dtype, the stacked heads and the
aggregation. It is what the reference exports (``forward_windows`` with
``use_kernel=False`` and ``use_fast_backbone=False``, no mono fold), so
it runs no hand-written kernel: the exported graph is PyTorch operators
only, as the reference's StableHLO runs no Pallas.

One ``torch.export`` program with a dynamic batch dimension serves every
batch entry, so the weights are stored once; ``meta["entries"]`` lists
the batch sizes the artifact serves (default 8 and 128, the live
pipeline's two buckets) and ``InferencePipeline.from_artifact`` snaps to
them. The front end's constants (the Hann window, the two DFT bases and
the mel filterbank) are built inside the forward and baked in on the
exporting device, so an artifact is exported on the device type that
will serve it (``meta["platforms"]``) and refused on any other.

File format: the ``SADPT1\\n`` magic, the JSON header's length as ``<I``,
the JSON header (the reference's keys: class names, generic head,
backbone, entries, window samples, sample rate, transport and compute
dtypes, platforms, spectrogram config, calibration), then the
``torch.export.save`` payload. The reference's ``SADX1\\n`` files hold
StableHLO and the two packages do not read each other's artifacts.

    python -m synthetic_audio_detection_tpu_torch.infer.export \\
        --merged-model merged.pth --output merged.sadpt --bf16
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import struct
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from synthetic_audio_detection_tpu_torch.ensemble.multihead import (
    MultiHeadEnsemble,
    in_compute_dtype,
    with_dtype,
)
from synthetic_audio_detection_tpu_torch.utils.config import AudioConfig, SpectrogramConfig

_MAGIC = b"SADPT1\n"
_JAX_MAGIC = b"SADX1\n"  # the reference package's StableHLO artifact


class ServingProgram(nn.Module):
    """[B, window] windows → [B, N+1] logits, as the reference exports it.
    Holds a copy of the ensemble with its backbones registered in the
    compute dtype, so the trace lifts every weight once, as a parameter."""

    def __init__(self, ensemble: MultiHeadEnsemble, spec: SpectrogramConfig, sample_rate: int):
        super().__init__()
        self.ensemble = in_compute_dtype(ensemble)
        self.spec = spec
        self.sample_rate = sample_rate

    def forward(self, windows: torch.Tensor) -> torch.Tensor:
        from synthetic_audio_detection_tpu_torch.infer.pipeline import forward_windows

        return forward_windows(self.ensemble, windows, self.spec, self.sample_rate,
                               use_kernel=False, use_fast_backbone=False)


@dataclasses.dataclass
class ArtifactEnsemble:
    """What the host side of a pipeline reads of its ensemble, from an
    artifact's header: there is no model, only the exported program."""

    class_names: List[str]
    calibration: Optional[Dict[str, Any]] = None
    generic_head: bool = False

    @property
    def num_heads(self) -> int:
        return len(self.class_names) - 1 + int(self.generic_head)

    @property
    def synthetic_names(self) -> List[str]:
        return self.class_names[:-1]

    @property
    def real_name(self) -> str:
        return self.class_names[-1]


def _device(device: Any) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but CUDA is not available")
    return device


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


def export_program(ensemble: MultiHeadEnsemble, audio: AudioConfig, spec: SpectrogramConfig,
                   batch_sizes: Sequence[int], transport_dtype: str, device: torch.device):
    """→ the ``torch.export`` program of ``ServingProgram`` on ``device``,
    traced at the smallest batch entry with the batch dimension dynamic."""
    from torch.export import Dim

    sizes = sorted(set(int(b) for b in batch_sizes))
    program = ServingProgram(ensemble, spec, audio.sample_rate).to(device).eval()
    in_dtype = torch.int16 if transport_dtype == "int16" else torch.float32
    example = torch.zeros((sizes[0], audio.window_samples), dtype=in_dtype, device=device)
    batch = Dim("batch", min=1, max=max(sizes[-1], 2))
    with torch.no_grad():
        ep = torch.export.export(program, (example,), dynamic_shapes={"windows": {0: batch}},
                                 strict=False)
    ep.example_inputs = None  # not stored: a 128-window example is 32 MB of zeros
    return ep


def export_serving(
    ensemble: MultiHeadEnsemble,
    *,
    audio: Optional[AudioConfig] = None,
    spec: Optional[SpectrogramConfig] = None,
    batch_sizes: Sequence[int] = (8, 128),
    transport_dtype: str = "int16",
    compute_dtype: torch.dtype = torch.bfloat16,
    device: Any = "cuda",
) -> bytes:
    """Serialize the serving program for ``[b, window]`` windows →
    ``[b, N+1]`` logits at each of ``batch_sizes``, the weights stored
    once. ``transport_dtype='int16'`` exports the PCM entry point (the
    program dequantizes); ``device`` is where the artifact will serve (the
    card unless the caller asks for ``cpu``)."""
    audio = audio or AudioConfig()
    spec = spec or SpectrogramConfig.inference()
    if transport_dtype not in ("float32", "int16"):
        raise ValueError(f"unsupported transport_dtype {transport_dtype!r}")
    if not batch_sizes:
        raise ValueError("need at least one batch size")
    device = _device(device)
    ep = export_program(with_dtype(ensemble, compute_dtype), audio, spec, batch_sizes,
                        transport_dtype, device)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    payload = buf.getvalue()
    meta = {
        "class_names": list(ensemble.class_names),
        "generic_head": bool(ensemble.generic_head),
        "backbone": ensemble.backbone_name,
        "entries": [{"batch_size": b} for b in sorted(set(int(b) for b in batch_sizes))],
        "window_samples": audio.window_samples,
        "sample_rate": audio.sample_rate,
        "transport_dtype": transport_dtype,
        "compute_dtype": str(compute_dtype).removeprefix("torch."),
        "platforms": [device.type],
        "spec": dataclasses.asdict(spec),
        "payload_nbytes": len(payload),
        # the parameters and buffers the program reads (once) and the
        # constants its trace lifted (the front end's window, DFT bases and
        # mel filterbank)
        "weights_nbytes": _nbytes(ep.state_dict.values()),
        "constants_nbytes": _nbytes(ep.constants.values()),
        "torch_version": torch.__version__,
    }
    if ensemble.calibration:
        # a host-side post-scale (infer/pipeline.py), so it rides the header
        meta["calibration"] = dict(ensemble.calibration)
    head = json.dumps(meta, sort_keys=True).encode()
    return _MAGIC + struct.pack("<I", len(head)) + head + payload


def write_artifact(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)


def read_header(data: bytes) -> Tuple[Dict[str, Any], int]:
    """→ (the header, the payload's offset); refuses a file that is not
    the port's artifact, or whose payload is not the length its header
    records."""
    if data[: len(_JAX_MAGIC)] == _JAX_MAGIC:
        raise ValueError("bad magic: a StableHLO serving artifact of the JAX package (SADX1); "
                         "this package reads only its own torch.export artifacts (SADPT1): "
                         "export the merged checkpoint with this package's infer.export")
    if data[: len(_MAGIC)] != _MAGIC:
        raise ValueError("not a serving artifact of this package (bad magic)")
    off = len(_MAGIC)
    (hlen,) = struct.unpack_from("<I", data, off)
    off += 4
    meta = json.loads(data[off : off + hlen].decode())
    off += hlen
    if len(data) - off != meta["payload_nbytes"]:
        raise ValueError(f"artifact payload length mismatch: the header records "
                         f"{meta['payload_nbytes']} bytes, the file holds {len(data) - off}")
    return meta, off


def load_artifact(path_or_bytes, device: Any = "cuda"
                  ) -> Tuple[Callable[[torch.Tensor], torch.Tensor], Dict[str, Any]]:
    """→ (``fn(windows) -> logits``, the header). One program serves every
    batch size in ``meta["entries"]``. Needs only torch: no model code and
    no checkpoint. The program runs on ``device`` (the card unless the
    caller asks for ``cpu``), which must be of the device type it was
    exported for: its constants were baked there."""
    if isinstance(path_or_bytes, (str, os.PathLike)):
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    else:
        data = bytes(path_or_bytes)
    meta, off = read_header(data)
    device = torch.device(device)
    recorded = meta["platforms"][0]
    if device.type != recorded:
        raise ValueError(f"artifact exported for {recorded}, refused on {device.type}: its "
                         f"front-end constants are baked on {recorded}; export it again on "
                         f"the device type that will serve it")
    _device(device)
    module = torch.export.load(io.BytesIO(data[off:])).module()

    def call(windows: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return module(windows)

    return call, meta


def main(argv=None) -> int:
    """CLI: export a merged checkpoint to a serving artifact."""
    import argparse

    from synthetic_audio_detection_tpu_torch.checkpoints import serialization
    from synthetic_audio_detection_tpu_torch.utils.config import parse_input_size

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--merged-model", required=True)
    p.add_argument("--output", required=True, help="artifact path (.sadpt)")
    p.add_argument("--backbone", default="resnet18")
    p.add_argument("--batch-sizes", default="8,128",
                   help="comma-separated batch entries; default 8,128 = the live pipeline's "
                   "two buckets")
    p.add_argument("--input-size", type=parse_input_size, default=512)
    p.add_argument("--transport-dtype", default="int16", choices=("float32", "int16"))
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute inside the artifact")
    p.add_argument("--device", default="cuda",
                   help="torch device the artifact will serve on (cuda or cpu); the export "
                   "runs there")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("export: CUDA is not available (pass --device cpu for a CPU artifact)",
              file=sys.stderr)
        return 1

    ensemble = serialization.load_merged(args.merged_model, backbone=args.backbone)
    data = export_serving(
        ensemble,
        spec=SpectrogramConfig.inference(out_size=args.input_size),
        batch_sizes=[int(b) for b in args.batch_sizes.split(",")],
        transport_dtype=args.transport_dtype,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        device=args.device,
    )
    write_artifact(args.output, data)
    print(f"Wrote serving artifact to {args.output} "
          f"({len(data)} bytes, heads={len(ensemble.class_names) - 1})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
