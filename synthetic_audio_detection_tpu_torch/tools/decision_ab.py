"""Decision-layer A/B: the reference unanimity rule against calibrated and
K-of-N variants (the reference's ``tools/decision_ab.py``, the same flags,
variants and JSON, plus ``--device``).

The unanimity rule (any strong synthetic head ⇒ not Real, one scalar
threshold) compounds per-head false positives on real windows as
1 - prod(1 - FPR_k). This tool measures the decision layer's levers at
matched operating points on one set of serving logits:

- one device pass per tree, collected per file, so the per-file majority
  matches infer/study.evaluate_tree;
- calibration (temperatures, the scalar EER threshold and per-column EER
  thresholds) fit on the fit tree only (utils/calibration.py);
- every variant evaluated on the host on the same window logits:
  reference (raw, 0.5, K = 1), calibrated unanimity, calibrated scalar
  EER, per-column EER thresholds, K-of-N overrides, the Šidák-corrected
  unanimity (per-head thresholds at per-head real-window FPR
  q = 1-(1-α)^(1/N) on the fit tree) and, on a generic-head artifact, the
  generic verdict's ladder;
- the collected logits are cached to an .npz beside ``--output``, so
  ``--from-logits`` evaluates further variants without the device.

Folders that name no ensemble class (a held-out generator) are kept and
scored as "unseen": detection succeeds when the verdict is not Real.

    python -m synthetic_audio_detection_tpu_torch.tools.decision_ab \\
        --merged-model merged.pth --fit-dir dataset/train --data-dir dataset/test \\
        --holdout SynthA --bf16 --k 1 2
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from synthetic_audio_detection_tpu_torch.tools.pipeline_args import (
    add_pipeline_args,
    cuda_missing,
    load_pipeline,
)


def collect_per_file(pipe, data_dir: str):
    """[(folder_class, per-window raw logits [w, N+1])] over every folder."""
    from synthetic_audio_detection_tpu_torch.infer.study import labeled_clips

    out: List[Tuple[str, np.ndarray]] = [
        (cls, np.asarray(pipe.logits_for_windows(windows), np.float32))
        for cls, _, windows, _ in labeled_clips(data_dir, pipe.audio)]
    if not out:
        raise ValueError(f"{data_dir}: no usable labeled segments")
    return out


def verdict_label(probs: np.ndarray, col_thr: np.ndarray, k: int, class_names: List[str],
                  generic_head: bool = False, generic_thr: float = None) -> str:
    """A file's majority label under the (generalized) unanimity rule, the
    aggregation of infer/study.evaluate_tree over the serving pipeline's
    ``decide_rows``. On a generic-head artifact the generic column (index
    n_spec) is split out as serving does; ``generic_thr`` engages the
    generic verdict (Real iff generic prob < thr) in place of the rule.
    Attribution always argmaxes the specialist columns."""
    from synthetic_audio_detection_tpu_torch.infer.pipeline import decide_rows

    n_spec = len(class_names) - 1
    if generic_head:
        generic = probs[:, n_spec]
        vis = np.delete(probs, n_spec, axis=1)
    else:
        generic = None
        vis = probs
    syn, real = vis[:, :-1], vis[:, -1]
    if generic_thr is not None:
        if generic is None:
            raise ValueError("generic verdict needs a generic-head artifact")
        is_real = generic < generic_thr
    else:
        # the threshold vector covers every logits column; drop the
        # generic slot to align with the visible columns (serving's split)
        ct = np.delete(col_thr, n_spec) if (
            generic_head and len(col_thr) == probs.shape[1]) else col_thr
        is_real = decide_rows(syn, real, ct, k)
    idx = np.where(is_real, vis.shape[1] - 1, syn.argmax(axis=1))
    labels = [class_names[j] for j in idx]
    return collections.Counter(labels).most_common(1)[0][0]


def evaluate_variant(files, class_names: List[str], real_name: str, holdout: Optional[str],
                     temps: Optional[np.ndarray], col_thr: np.ndarray, k: int,
                     generic_head: bool = False, generic_thr: float = None
                     ) -> Dict[str, object]:
    per_class = collections.defaultdict(lambda: [0, 0, 0])  # n, det, attr
    for cls, z in files:
        if temps is not None:
            z = z / temps
        probs = 1.0 / (1.0 + np.exp(-z.astype(np.float32)))
        label = verdict_label(probs, col_thr, k, class_names, generic_head, generic_thr)
        correct_det = (label == real_name) == (cls == real_name)
        stats = per_class[cls]
        stats[0] += 1
        stats[1] += int(correct_det)
        stats[2] += int(label == cls)
    seen = [c for c in per_class if c != real_name and c != holdout and c in class_names]
    out: Dict[str, object] = {
        "per_class": {
            c: {"n": n, "binary": round(d / n, 4), "attribution": round(a / n, 4)}
            for c, (n, d, a) in sorted(per_class.items())
        },
        "real_tnr": round(per_class[real_name][1] / per_class[real_name][0], 4)
        if real_name in per_class else None,
        "seen_tpr_mean": round(
            float(np.mean([per_class[c][1] / per_class[c][0] for c in seen])), 4)
        if seen else None,
        "seen_attr_mean": round(
            float(np.mean([per_class[c][2] / per_class[c][0] for c in seen])), 4)
        if seen else None,
    }
    if holdout and holdout in per_class:
        n, d, _ = per_class[holdout]
        out["unseen_tpr"] = round(d / n, 4)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_pipeline_args(p)
    p.add_argument("--fit-dir", required=True, help="TRAIN tree: calibration is fit here only")
    p.add_argument("--data-dir", required=True, help="held-out test tree")
    p.add_argument("--holdout", help="class held out of training (scored as 'unseen')")
    p.add_argument("--k", type=int, nargs="+", default=[1, 2],
                   help="syn-override K values to evaluate")
    p.add_argument("--sidak-alpha", type=float, nargs="+", default=[0.05, 0.10],
                   help="target ensemble real-FPR levels for the Šidák-corrected per-head "
                   "thresholds")
    p.add_argument("--output", help="also write the JSON report here")
    p.add_argument("--from-logits",
                   help="reuse a cached .npz from a previous run (no device passes; "
                   "--merged-model only names the report)")
    args = p.parse_args(argv)

    from synthetic_audio_detection_tpu_torch.utils import calibration as cal_mod

    if args.from_logits:
        cache = np.load(args.from_logits)
        fit_logits = cache["fit_logits"]
        fit_ci = cache["fit_class_idx"]
        class_names = [str(s) for s in cache["class_names"]]
        real_name = str(cache["real_name"])
        generic_head = bool(cache["generic_head"]) if "generic_head" in cache \
            else fit_logits.shape[1] == len(class_names) + 1
        files = []
        off = 0
        for cls, cnt in zip(cache["test_file_class"], cache["test_file_count"]):
            files.append((str(cls), cache["test_logits"][off:off + int(cnt)]))
            off += int(cnt)
    else:
        if cuda_missing("decision_ab", args.device):
            return 1
        from synthetic_audio_detection_tpu_torch.infer.study import collect_logits_tree

        ensemble, pipe = load_pipeline(args, apply_calibration=False)
        class_names = list(ensemble.class_names)
        real_name = ensemble.real_name
        generic_head = bool(ensemble.generic_head)

        fit = collect_logits_tree(pipe, args.fit_dir)
        fit_logits, fit_ci = fit["logits"], fit["class_idx"]
        files = collect_per_file(pipe, args.data_dir)
        if args.output:
            np.savez_compressed(
                args.output + ".logits.npz",
                fit_logits=fit_logits, fit_class_idx=fit_ci,
                test_logits=np.concatenate([z for _, z in files], axis=0),
                test_file_class=np.array([c for c, _ in files]),
                test_file_count=np.array([z.shape[0] for _, z in files], np.int64),
                class_names=np.array(class_names),
                real_name=np.array(real_name),
                generic_head=np.array(generic_head),
            )

    cal = cal_mod.fit_ensemble_calibration(
        fit_logits, fit_ci, class_names,
        store_eer_threshold=True, store_column_thresholds=True,
        fit_on=args.fit_dir, generic_head=generic_head,
    )
    temps = np.asarray(cal["temperatures"], np.float32)
    n_heads = len(class_names) - 1          # specialist heads
    n_cols = n_heads + 1 + int(generic_head)  # logits width
    uniform = np.full(n_cols, 0.5, np.float32)
    scalar_eer = np.full(n_cols, np.float32(cal.get("threshold", 0.5)), np.float32)
    col_eer = np.asarray(cal["column_thresholds"], np.float32)

    # Šidák-corrected per-head operating points: each head's real-FPR at
    # q = 1-(1-α)^(1/N) on the fit tree targets an ensemble real-FPR of α;
    # the real column stays at the calibrated 0.5
    real_fit = fit_logits[fit_ci == n_heads] / temps
    assert real_fit.shape[1] == n_cols
    p_real_fit = 1.0 / (1.0 + np.exp(-real_fit.astype(np.float64)))
    sidak = {}
    for alpha in args.sidak_alpha:
        q = 1.0 - (1.0 - alpha) ** (1.0 / n_heads)
        thr = np.full(n_cols, 0.5, np.float32)
        for j in range(n_heads):
            thr[j] = np.float32(np.quantile(p_real_fit[:, j], 1.0 - q))
        sidak[f"sidak_a{int(round(alpha * 100)):02d}_k1"] = thr

    variants = {}
    for k in args.k:
        variants[f"reference_unanimity_k{k}"] = (None, uniform, k, None)
        if k == 1:
            variants["calibrated_unanimity_k1"] = (temps, uniform, 1, None)
        variants[f"calibrated_scalar_eer_k{k}"] = (temps, scalar_eer, k, None)
        variants[f"per_column_eer_k{k}"] = (temps, col_eer, k, None)
    for name, thr in sidak.items():
        variants[name] = (temps, thr, 1, None)
    if generic_head:
        # the generic verdict's ladder: raw 0.5, calibrated 0.5, its own EER
        # point, and real-FPR quantile points of the one generic head
        gj = n_heads  # generic column index
        variants["generic_raw_t50"] = (None, uniform, 1, 0.5)
        variants["generic_cal_t50"] = (temps, uniform, 1, 0.5)
        variants["generic_cal_eer"] = (temps, uniform, 1, float(col_eer[gj]))
        gen_fit = 1.0 / (1.0 + np.exp(-(real_fit[:, gj]).astype(np.float64)))
        for alpha in args.sidak_alpha:
            thr_g = float(np.quantile(gen_fit, 1.0 - alpha))
            variants[f"generic_fpr_a{int(round(alpha * 100)):02d}"] = (temps, uniform, 1, thr_g)
    report = {
        "merged_model": args.merged_model,
        "holdout": args.holdout,
        "n_files": len(files),
        "sidak_thresholds": {k: np.round(v, 4).tolist() for k, v in sidak.items()},
        "calibration": cal,
        "generic_head": generic_head,
        "variants": {
            name: evaluate_variant(files, class_names, real_name, args.holdout, t, thr, k,
                                   generic_head, g_thr)
            for name, (t, thr, k, g_thr) in variants.items()
        },
    }
    text = json.dumps(report)
    print(text)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)

    # the summary table, on stderr
    print("| variant | Real TNR | unseen TPR | seen TPR | seen attr |", file=sys.stderr)
    print("|---|---|---|---|---|", file=sys.stderr)
    for name, v in report["variants"].items():
        print(f"| {name} | {v.get('real_tnr')} | {v.get('unseen_tpr', '-')} "
              f"| {v.get('seen_tpr_mean')} | {v.get('seen_attr_mean')} |", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
