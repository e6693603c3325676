"""Calibration follow-up to the LOGO study (the port of the repository's
``tools/logo_calibration_followup.sh``).

For each holdout's trained ensemble: fit per-column temperatures and the
EER operating threshold on the train tree (``tools.calibrate_ensemble
--store-eer-threshold``; the holdout names no class of the ensemble, so its
folder is skipped), re-run the full-tree accuracy study with the calibrated
checkpoint, and print a before/after table against the uncalibrated run.
The port's calibration tool keeps a generic head's column, so a
generic-head arm calibrates too.

Usage:
    python -m synthetic_audio_detection_tpu_torch.tools.logo_calibration_followup \
        <corpus-root> [TAG] [holdout ...]

``<corpus-root>/logo_<G><TAG>/joint_model.ckpt.merged.ckpt`` and
``logo_<G><TAG>_full.json`` must exist (a ``generalization_study`` run with
the same TAG). Default holdouts: SynthA SynthD SynthF. Env knobs: SIZE=native
BATCH=128, DEVICE=cuda. Writes ``logo_<G><TAG>_cal.ckpt``, ``_calfit.json``
and ``_cal_full.json``. The first failing step ends the run with its exit
code.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Sequence

from synthetic_audio_detection_tpu_torch.tools import campaign
from synthetic_audio_detection_tpu_torch.tools.campaign import command, say
from synthetic_audio_detection_tpu_torch.tools.generalization_study import HOLDOUTS


def summary_table(root: str, tag: str, holdouts: Sequence[str]) -> str:
    """The script's before -> after table: one row a holdout."""
    lines = ["| holdout | Real TNR | unseen TPR | seen TPR (mean) | threshold |",
             "|---|---|---|---|---|"]
    for g in holdouts:
        with open(f"{root}/logo_{g}{tag}_full.json") as f:
            before = json.load(f)["per_class"]
        with open(f"{root}/logo_{g}{tag}_cal_full.json") as f:
            after = json.load(f)["per_class"]
        with open(f"{root}/logo_{g}{tag}_calfit.json") as f:
            fit = json.load(f)["calibration"]

        def seen(pc):
            vals = [v["binary"] for c, v in pc.items() if c not in ("Real", g)]
            return sum(vals) / len(vals)

        lines.append(f"| {g} | {before['Real']['binary']:.3f} -> "
                     f"{after['Real']['binary']:.3f} | "
                     f"{before[g]['binary']:.3f} -> {after[g]['binary']:.3f} | "
                     f"{seen(before):.3f} -> {seen(after):.3f} | "
                     f"{fit.get('threshold', 0.5)} |")
    return "".join(line + "\n" for line in lines)


def run(root: str, tag: str = "", holdouts: Sequence[str] = HOLDOUTS, size="native",
        batch="128", device: str = "cuda") -> int:
    d = os.path.abspath(root)
    for g in holdouts:
        m = f"{d}/logo_{g}{tag}/joint_model.ckpt.merged.ckpt"
        cal = f"{d}/logo_{g}{tag}_cal.ckpt"
        say(f"=== holdout {g}{tag}: fit temperatures + EER threshold on train tree")
        rc = campaign.run_to(command("tools.calibrate_ensemble", "--merged-model", m,
                                     "--fit-dir", f"{d}/dataset/train", "--input-size", size,
                                     "--bf16", "--batch-size", batch, "--store-eer-threshold",
                                     "--output", cal, "--device", device),
                             f"{d}/logo_{g}{tag}_calfit.json")
        if rc:
            return rc
        say(f"=== holdout {g}{tag}: full-tree eval with calibration")
        rc = campaign.run_to(command("tools.accuracy_study", "--merged-model", cal,
                                     "--data-dir", f"{d}/dataset/test", "--input-size", size,
                                     "--bf16", "--batch-size", batch, "--device", device),
                             f"{d}/logo_{g}{tag}_cal_full.json")
        if rc:
            return rc
    say("=== summary (before -> after calibration)")
    sys.stdout.write(summary_table(d, tag, holdouts))
    sys.stdout.flush()
    return 0


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    if not args:
        return campaign.usage("logo_calibration_followup <corpus-root> [TAG] [holdout...]")
    # TAG=${2:-}; shift 2 || shift || true: with no TAG the holdouts are the defaults
    tag = args[1] if len(args) > 1 else ""
    k = campaign.knob
    return run(args[0], tag, args[2:] or HOLDOUTS, size=k("SIZE", "native"),
               batch=k("BATCH", "128"), device=campaign.device())


if __name__ == "__main__":
    sys.exit(main())
