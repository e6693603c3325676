"""Train the full ensemble of a study corpus and run the held-out study:
one binary head per synthetic class, merged by a recipe CSV, or all heads
in one joint pass (the port of the repository's
``tools/train_study_ensemble.sh``).

Usage:
    python -m synthetic_audio_detection_tpu_torch.tools.train_study_ensemble <corpus-root>

``<corpus-root>`` holds ``dataset/{train,test}/<ClassName>/*.wav`` (e.g. from
``tools.gen_study_corpus`` and ``tools.study_pipeline``). Env knobs (the
script's, with its defaults): EPOCHS=6 INPUT_SIZE=native BATCH=128
HARD_NEG=0 SEED=42 BF16=1 WORKERS=8 JOINT=0 PER_HEAD_STAGES=0, OUT (default
``<corpus-root>/ensemble``), and DEVICE=cuda, passed to every step as
``--device``. HARD_NEG=1 folds every other generator's segments into each
head's Class0; JOINT=1 trains every head in one pass with
``cli.ensemble_trainer`` (PER_HEAD_STAGES=K: the trailing K ResNet stages
per head) and copies its merged ``.pth``. Writes ``heads/<cls>/``,
``recipe.csv`` (sequential), ``joint/`` (joint), ``merged.pth`` and
``study.json`` (the study's stdout, also printed) under the output folder.
The first failing step ends the run with its exit code.
"""

from __future__ import annotations

import os
import shutil
import sys
from typing import Optional

from synthetic_audio_detection_tpu_torch.tools import campaign
from synthetic_audio_detection_tpu_torch.tools.campaign import command, say


def run(root: str, epochs="6", input_size="native", batch="128", hard_neg=False, seed="42",
        bf16=True, workers="8", joint=False, per_head_stages="0", out: Optional[str] = None,
        device: str = "cuda") -> int:
    d = os.path.abspath(root)
    names = campaign.classes(os.path.join(d, "dataset", "train"))
    if not names:
        print(f"train_study_ensemble: no synthetic class in {d}/dataset/train", file=sys.stderr)
        return 1
    listing = "\n".join(names)  # "$classes" in a quoted string keeps its newlines
    e = os.path.abspath(out) if out else os.path.join(d, "ensemble")
    os.makedirs(os.path.join(e, "heads"), exist_ok=True)
    bf16_flag = ["--bf16"] if bf16 else []
    study = command("tools.accuracy_study", "--merged-model", f"{e}/merged.pth",
                    "--data-dir", f"{d}/dataset/test", "--input-size", input_size, *bf16_flag,
                    "--device", device)

    if joint:
        say(f"=== joint ensemble training: {listing} (epochs={epochs} input={input_size} "
            f"batch={batch})")
        rc = campaign.call(command(
            "cli.ensemble_trainer", "--data-dir", f"{d}/dataset", "--real-class", "Real",
            "--synthetic-classes", *names, "--epochs", epochs, "--batch-size", batch,
            "--input-size", input_size, *bf16_flag, "--workers", workers, "--seed", seed,
            "--per-head-stages", per_head_stages, "--checkpoint-dir", f"{e}/joint",
            "--log-dir", f"{e}/runs/joint", "--device", device))
        if rc:
            return rc
        try:
            shutil.copyfile(f"{e}/joint/joint_model.ckpt.merged.pth", f"{e}/merged.pth")
        except OSError as err:
            print(f"cp: {err}", file=sys.stderr)
            return 1
        say("=== held-out study")
        rc = campaign.run_tee(study, f"{e}/study.json")
        if rc:
            return rc
        say(f"=== done: {e}")
        return 0

    say(f"=== heads: {listing} (epochs={epochs} input={input_size} batch={batch} "
        f"hard_neg={int(hard_neg)})")
    recipe = os.path.join(e, "recipe.csv")
    with open(recipe, "w") as f:
        f.write("model_filename,synthetic_class,real_class\n")
    for cls in names:
        hn_flag = (["--hard-negative-classes", *(c for c in names if c != cls)]
                   if hard_neg else [])
        say(f"=== training head: Real vs {cls}")
        rc = campaign.call(command(
            "cli.submodel_trainer", "--data-dir", f"{d}/dataset", "--Class0", "Real",
            "--Class1", cls, "--epochs", epochs, "--batch-size", batch,
            "--input-size", input_size, *bf16_flag, *hn_flag, "--workers", workers,
            "--seed", seed, "--checkpoint-dir", f"{e}/heads/{cls}",
            "--log-dir", f"{e}/runs/{cls}", "--device", device))
        if rc:
            return rc
        with open(recipe, "a") as f:
            f.write(f"heads/{cls}/best_model.ckpt,{cls},Real\n")

    say(f"=== merging {len(names)} heads")
    rc = campaign.call(command("cli.model_merger", "--submodels-folder", e,
                               "--csv-file", recipe, "--output-path", f"{e}/merged.pth",
                               "--device", device))
    if rc:
        return rc
    say("=== held-out study")
    rc = campaign.run_tee(study, f"{e}/study.json")
    if rc:
        return rc
    say(f"=== done: {e}")
    return 0


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    if not args:
        return campaign.usage("train_study_ensemble <corpus-root>")
    k = campaign.knob
    return run(args[0], epochs=k("EPOCHS", "6"), input_size=k("INPUT_SIZE", "native"),
               batch=k("BATCH", "128"), hard_neg=k("HARD_NEG", "0") == "1",
               seed=k("SEED", "42"), bf16=k("BF16", "1") == "1", workers=k("WORKERS", "8"),
               joint=k("JOINT", "0") == "1", per_head_stages=k("PER_HEAD_STAGES", "0"),
               out=os.environ.get("OUT") or None, device=campaign.device())


if __name__ == "__main__":
    sys.exit(main())
