"""Leave-one-generator-out (LOGO) generalization study (the port of the
repository's ``tools/generalization_study.sh``).

For each held-out generator G: train a joint ensemble on the other
generators (``cli.ensemble_trainer``, hard negatives built in), run the
accuracy study on the full test tree (unseen TPR of G, seen TPR and Real
TNR as controls) and on a Real-vs-G tree of symlinks (clean unseen AUC and
EER), then print the summary table.

Usage:
    python -m synthetic_audio_detection_tpu_torch.tools.generalization_study \
        <corpus-root> [holdout ...]

Default holdouts: SynthA SynthD SynthF. Env knobs (the script's): EPOCHS=6
BATCH=128 SIZE=native SEED=0, EXTRA (more ensemble_trainer flags, split on
whitespace, e.g. "--no-hard-negatives"), TAG (a suffix of the output
names, e.g. "_noHN"), and DEVICE=cuda. Writes ``logo_<G><TAG>/`` (the
checkpoints), ``logo_<G><TAG>_full.json``, ``logo_<G><TAG>_eval/`` and
``logo_<G><TAG>_unseen.json`` under ``<corpus-root>``. The first failing
step ends the run with its exit code.
"""

from __future__ import annotations

import json
import os
import sys
from typing import List, Sequence

from synthetic_audio_detection_tpu_torch.tools import campaign
from synthetic_audio_detection_tpu_torch.tools.campaign import command, say

HOLDOUTS = ("SynthA", "SynthD", "SynthF")


def summary_table(root: str, tag: str, holdouts: Sequence[str]) -> str:
    """The script's summary: one row a holdout from its two study JSONs."""
    lines = ["| holdout | unseen TPR | seen TPR (mean) | Real TNR | unseen AUC | unseen EER |",
             "|---|---|---|---|---|---|"]
    for g in holdouts:
        with open(f"{root}/logo_{g}{tag}_full.json") as f:
            full = json.load(f)
        with open(f"{root}/logo_{g}{tag}_unseen.json") as f:
            uns = json.load(f)
        pc = full["per_class"]
        seen = [v["binary"] for c, v in pc.items() if c not in ("Real", g)]
        lines.append(f"| {g} | {pc[g]['binary']:.3f} | "
                     f"{sum(seen)/len(seen):.3f} | {pc['Real']['binary']:.3f} | "
                     f"{uns.get('binary_auc', float('nan')):.3f} | "
                     f"{uns.get('binary_eer', float('nan')):.3f} |")
    return "".join(line + "\n" for line in lines)


def run(root: str, holdouts: Sequence[str] = HOLDOUTS, epochs="6", batch="128", size="native",
        seed="0", extra: Sequence[str] = (), tag: str = "", device: str = "cuda") -> int:
    d = os.path.abspath(root)
    every = campaign.classes(os.path.join(d, "dataset", "test"))
    for g in holdouts:
        syn: List[str] = [c for c in every if c != g]
        if not syn:  # grep -vx selected nothing: the script's set -e ends it
            print(f"generalization_study: no class left to train on without {g}",
                  file=sys.stderr)
            return 1
        ck = f"{d}/logo_{g}{tag}"
        say(f"=== holdout {g}{tag}: train joint ensemble on: " + "".join(c + " " for c in syn))
        rc = campaign.call(command(
            "cli.ensemble_trainer", "--data-dir", f"{d}/dataset", "--synthetic-classes", *syn,
            "--epochs", epochs, "--batch-size", batch, "--seed", seed, "--bf16",
            "--input-size", size, "--checkpoint-dir", ck, *extra, "--device", device))
        if rc:
            return rc
        m = f"{ck}/joint_model.ckpt.merged.ckpt"
        say(f"=== holdout {g}: full-tree eval (seen TPR + unseen TPR + Real TNR)")
        rc = campaign.run_to(command("tools.accuracy_study", "--merged-model", m,
                                     "--data-dir", f"{d}/dataset/test", "--input-size", size,
                                     "--bf16", "--device", device),
                             f"{d}/logo_{g}{tag}_full.json")
        if rc:
            return rc
        say(f"=== holdout {g}: Real-vs-{g} eval (clean unseen AUC/EER)")
        ev = f"{d}/logo_{g}{tag}_eval"
        if not campaign.unseen_tree(f"{d}/dataset/test", g, ev):
            return 1
        rc = campaign.run_to(command("tools.accuracy_study", "--merged-model", m,
                                     "--data-dir", ev, "--input-size", size, "--bf16",
                                     "--device", device),
                             f"{d}/logo_{g}{tag}_unseen.json")
        if rc:
            return rc
    say("=== summary")
    sys.stdout.write(summary_table(d, tag, holdouts))
    sys.stdout.flush()
    return 0


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    if not args:
        return campaign.usage("generalization_study <corpus-root> [holdout...]")
    k = campaign.knob
    return run(args[0], args[1:] or HOLDOUTS, epochs=k("EPOCHS", "6"), batch=k("BATCH", "128"),
               size=k("SIZE", "native"), seed=k("SEED", "0"),
               extra=os.environ.get("EXTRA", "").split(), tag=os.environ.get("TAG", ""),
               device=campaign.device())


if __name__ == "__main__":
    sys.exit(main())
