"""Serving-artifact drive: export → artifact serve → agreement with two live
pipelines (the reference's ``tools/stablehlo_drive.py`` for the port's
``torch.export`` artifact, infer/export.py).

Exports a merged checkpoint (or takes ``--artifact``), serves it through
``InferencePipeline.from_artifact`` and holds it, on every WAV under
``--audio-dir`` (a flat folder or a class tree), to:

- MATCHED numerics: ``forward_windows`` with the exported flags (the
  float32 GEMM mel, the plain ResNet, no mono fold, the artifact's
  transport and buckets) on the same batches. The same operators on the
  same operands on the same device: the logits must be equal bit for bit,
  so an artifact that baked in another front end or backbone route fails.
- PRODUCTION: the auto-gated live pipeline (on the card in bf16 the
  log-mel kernel and, on a shared backbone, the conv kernel). Its front
  end and backbone differ in reduced precision, so only the labels are
  held, on windows whose artifact sigmoids all lie more than MARGIN from
  their thresholds (and, for a synthetic verdict, whose leading
  synthetic sigmoid leads the runner-up by as much). A run in which no
  window is that clear compared nothing and fails: a temperature at the
  fit's bound puts every calibrated sigmoid near 0.5, and
  ``--no-calibration`` then holds both pipelines' labels on the raw
  logits (the calibration is the same host-side divide in both).

The hand-written kernels' launch counts are read around each pipeline's
calls: the artifact must launch none.

    python -m synthetic_audio_detection_tpu_torch.tools.artifact_drive \\
        --merged-model merged.pth --audio-dir dataset/test --bf16
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

from synthetic_audio_detection_tpu_torch.tools.pipeline_args import (
    add_pipeline_args,
    compute_dtype,
    cuda_missing,
    load_pipeline,
)

# production labels are held on windows clear of every decision boundary by
# this much in sigmoid (chip_smoke's bf16-against-float32 label check)
MARGIN = 0.05


def _kernels():
    from synthetic_audio_detection_tpu_torch.ops import (
        cuda_conv,
        cuda_melspec,
        cuda_melspec_strip,
        cuda_probes,
    )

    return [m.KERNEL for m in (cuda_melspec, cuda_melspec_strip, cuda_conv, cuda_probes)]


@contextlib.contextmanager
def counting(into: dict):
    """Adds to ``into`` the launches each hand-written kernel made inside."""
    kernels = _kernels()
    before = [k.launches for k in kernels]
    try:
        yield
    finally:
        for k, b in zip(kernels, before):
            into[k.name] = into.get(k.name, 0) + k.launches - b


def wav_files(root: str, limit: int):
    out = []
    for d, _, names in sorted(os.walk(root)):
        out += [os.path.join(d, n) for n in sorted(names) if n.lower().endswith(".wav")]
    return sorted(out)[:limit]


def clear_windows(probs: np.ndarray, col_thr: np.ndarray, n_syn: int, margin: float):
    """[n, C] calibrated sigmoids → which windows' labels are clear: every
    sigmoid more than ``margin`` from its threshold and the leading
    synthetic sigmoid ahead of the runner-up by more than ``margin``."""
    far = (np.abs(probs - col_thr[None, :]) > margin).all(axis=1)
    syn = np.sort(probs[:, :n_syn], axis=1)
    lead = syn[:, -1] - syn[:, -2] > margin if n_syn > 1 else np.ones(len(probs), bool)
    return far & lead


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_pipeline_args(p)
    p.add_argument("--audio-dir", required=True)
    p.add_argument("--max-files", type=int, default=12)
    p.add_argument("--artifact", help="serve this artifact instead of exporting one")
    p.add_argument("--no-calibration", action="store_true",
                   help="both pipelines decide on the raw logits")
    args = p.parse_args(argv)
    if cuda_missing("artifact_drive", args.device):
        return 1

    from synthetic_audio_detection_tpu_torch.ensemble.multihead import with_dtype
    from synthetic_audio_detection_tpu_torch.infer import export as export_mod
    from synthetic_audio_detection_tpu_torch.infer.pipeline import (
        InferencePipeline,
        forward_windows,
        preprocess_waveform,
        slice_waveform,
    )
    from synthetic_audio_detection_tpu_torch.ops.precision import exact_float32
    from synthetic_audio_detection_tpu_torch.utils.calibration import apply_calibration
    from synthetic_audio_detection_tpu_torch.utils.config import InferenceConfig

    dtype = compute_dtype(args)
    calibrate = not args.no_calibration
    ensemble, production = load_pipeline(args, apply_calibration=calibrate)
    report = {}
    source = args.artifact
    if not source:
        t0 = time.perf_counter()
        source = export_mod.export_serving(
            ensemble, audio=production.audio, spec=production.spec,
            batch_sizes=(8, args.batch_size), compute_dtype=dtype, device=args.device)
        report["export_s"] = time.perf_counter() - t0
        report["artifact_nbytes"] = len(source)
    artifact = InferencePipeline.from_artifact(
        source, infer=InferenceConfig(apply_calibration=calibrate), device=args.device)
    matched_ens = with_dtype(ensemble, dtype).to(args.device)

    def matched_logits(windows):
        out = []
        for batch, take in artifact._bucketed_batches(windows):
            with exact_float32() if dtype == torch.float32 else contextlib.nullcontext():
                agg = forward_windows(matched_ens, batch, artifact.spec,
                                      artifact.audio.sample_rate)
            out.append(agg[:take].float().cpu().numpy())
        return np.concatenate(out, axis=0)

    wavs = wav_files(args.audio_dir, args.max_files)
    if not wavs:
        print(f"artifact_drive: {args.audio_dir}: no wavs", file=sys.stderr)
        return 1
    launches = {"artifact": {}, "matched": {}, "production": {}}
    n_windows = n_clear = prod_mismatch = 0
    matched_max = prod_max = 0.0
    bit_equal = True
    n_syn = len(artifact.ensemble.class_names) - 1
    for path in wavs:
        windows, stamps = slice_waveform(preprocess_waveform(path, artifact.audio),
                                         artifact.audio)
        if windows.shape[0] == 0:
            continue
        with counting(launches["artifact"]):
            a = artifact.logits_for_windows(windows)
        with counting(launches["matched"]):
            m = matched_logits(windows)
        with counting(launches["production"]):
            pr = production.logits_for_windows(windows)
        n_windows += windows.shape[0]
        bit_equal &= bool(np.array_equal(a, m))
        matched_max = max(matched_max, float(np.abs(a - m).max()))
        prod_max = max(prod_max, float(np.abs(a - pr).max()))
        la = [s["label"] for s in artifact.analyze_windows(windows, stamps, logits=a)["segments"]]
        lp = [s["label"] for s in
              production.analyze_windows(windows, stamps, logits=pr)["segments"]]
        cal = apply_calibration(a, artifact._cal) if artifact._cal is not None else a
        probs = 1.0 / (1.0 + np.exp(-np.asarray(cal, np.float32)))
        clear = clear_windows(probs, artifact._col_thr, n_syn, MARGIN)
        n_clear += int(clear.sum())
        prod_mismatch += sum(1 for c, x, y in zip(clear, la, lp) if c and x != y)
    report.update({
        "artifact": args.artifact or "(exported in memory)",
        "compute_dtype": str(dtype).removeprefix("torch."),
        "n_files": len(wavs),
        "n_windows": n_windows,
        "matched_max_abs_logit_diff": matched_max,
        "matched_bit_equal": bit_equal,
        "calibration": artifact._cal is not None,
        "production_max_abs_logit_diff": prod_max,
        "production_clear_windows": n_clear,
        "production_label_mismatches_on_clear": prod_mismatch,
        "margin": MARGIN,
        "launches": launches,
    })
    report["ok"] = bool(n_windows and bit_equal and n_clear and prod_mismatch == 0
                        and not any(launches["artifact"].values()))
    print(json.dumps(report))
    if not n_clear:
        print(f"artifact_drive: no window's sigmoids lie more than {MARGIN} from the decision "
              f"boundaries, so the production label check compared nothing"
              + (" (try --no-calibration)" if artifact._cal is not None else ""),
              file=sys.stderr)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
