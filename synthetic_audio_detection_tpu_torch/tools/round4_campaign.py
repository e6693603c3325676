"""Round-4 study campaign (the port of the repository's
``tools/round4_campaign.sh``), sequenced so the most important results
land first. Every step is time-bounded; a failed step is logged and the
campaign goes on.

1. hard-negative LOGO arms SynthD and SynthF, each followed by its
   decision-layer A/B (``tools.decision_ab``) when its unseen eval succeeded;
2. wave-augment LOGO arms SynthD and SynthF;
3. the artifact drive (``tools.artifact_drive``, the port of
   ``tools/stablehlo_drive.py``) on the SynthD artifact, if it exists;
4. the serving profile at native input with the mono stem
   (``tools.profile_serving``, in place of ``benchmarks/stage_decomp.py``);
5. the hard-negative SynthA arm and its A/B.

Usage:
    python -m synthetic_audio_detection_tpu_torch.tools.round4_campaign <corpus-root> [logdir]

``logdir`` defaults to ``<corpus-root>/campaign_logs``; it holds
``campaign.log`` and one log per step. Env knob: DEVICE=cuda.
"""

from __future__ import annotations

import os
import sys

from synthetic_audio_detection_tpu_torch.tools import campaign
from synthetic_audio_detection_tpu_torch.tools.campaign import Campaign


def open_campaign(root: str, log_dir: str = "", device: str = "cuda") -> Campaign:
    return Campaign.open(root, log_dir or os.path.join(root, "campaign_logs"), "campaign.log",
                         device)


def train_arm(c: Campaign, g: str, tag: str, *extra: str) -> int:
    """A LOGO arm: the joint ensemble without ``g``, then its full-tree and
    unseen evals. → 1 when training failed, else the unseen eval's exit
    code (a shell function's status is its last command's)."""
    d = c.root
    syn = [n for n in campaign.classes(f"{d}/dataset/test") if n != g]
    ck = f"{d}/logo_{g}{tag}"
    if c.step(f"train_{g}{tag}", 4800, "cli.ensemble_trainer", "--data-dir", f"{d}/dataset",
              "--synthetic-classes", *syn, "--epochs", "6", "--batch-size", "128",
              "--seed", "0", "--bf16", "--input-size", "native", "--checkpoint-dir", ck, *extra):
        return 1
    m = f"{ck}/joint_model.ckpt.merged.ckpt"
    c.stepj(f"eval_{g}{tag}_full", 1800, f"{d}/logo_{g}{tag}_full.json", "tools.accuracy_study",
            "--merged-model", m, "--data-dir", f"{d}/dataset/test", "--input-size", "native",
            "--bf16")
    ev = f"{d}/logo_{g}{tag}_eval"
    campaign.unseen_tree(f"{d}/dataset/test", g, ev)
    return c.stepj(f"eval_{g}{tag}_unseen", 1800, f"{d}/logo_{g}{tag}_unseen.json",
                   "tools.accuracy_study", "--merged-model", m, "--data-dir", ev,
                   "--input-size", "native", "--bf16")


def ab_arm(c: Campaign, g: str) -> int:
    """The decision-layer A/B of ``logo_<g>``'s artifact (fitted on the train
    tree, scored on the test tree, ``g`` as the unseen class)."""
    d = c.root
    m = f"{d}/logo_{g}/joint_model.ckpt.merged.ckpt"
    if not os.path.isfile(m):
        campaign.mark(c.campaign_log, f"ab_{g}: no model")
        return 1
    return c.step(f"ab_{g}", 3600, "tools.decision_ab", "--merged-model", m,
                  "--fit-dir", f"{d}/dataset/train", "--data-dir", f"{d}/dataset/test",
                  "--holdout", g, "--input-size", "native", "--bf16", "--k", "1", "2",
                  "--output", f"{d}/logo_{g}_decision_ab.json")


def artifact_drive(c: Campaign) -> int:
    """The exported artifact against the live pipeline on the SynthD
    artifact, if it exists (the script's ``stablehlo_drive`` step)."""
    d = c.root
    m = f"{d}/logo_SynthD/joint_model.ckpt.merged.ckpt"
    if not os.path.isfile(m):
        return 0
    return c.stepj("stablehlo_drive", 2400, f"{d}/stablehlo_drive.json", "tools.artifact_drive",
                   "--merged-model", m, "--audio-dir", f"{d}/dataset/test/Real",
                   "--input-size", "native", "--bf16")


def stage_decomp_native(c: Campaign) -> int:
    """The serving profile at native input with the mono stem (the script's
    ``stage_decomp_native`` step)."""
    return c.step("stage_decomp_native", 2400, "tools.profile_serving", "--input-size", "native",
                  "--mono")


def run(root: str, log_dir: str = "", device: str = "cuda") -> int:
    c = open_campaign(root, log_dir, device)
    # phases 1 and 2: the hard-negative arms D and F, each with its A/B
    if train_arm(c, "SynthD", "") == 0:
        ab_arm(c, "SynthD")
    if train_arm(c, "SynthF", "") == 0:
        ab_arm(c, "SynthF")
    # phase 3: the wave-augment arms
    train_arm(c, "SynthD", "_waug", "--wave-augment")
    train_arm(c, "SynthF", "_waug", "--wave-augment")
    # phase 4: the artifact drive with a real model, and the native profile
    artifact_drive(c)
    stage_decomp_native(c)
    # phase 5 (optional tail): the SynthA arm
    if train_arm(c, "SynthA", "") == 0:
        ab_arm(c, "SynthA")
    campaign.mark(c.campaign_log, f"=== campaign done {campaign.date()}")
    return 0


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    if not args:
        return campaign.usage("round4_campaign <corpus-root> [logdir]")
    return run(args[0], args[1] if len(args) > 1 else "", device=campaign.device())


if __name__ == "__main__":
    sys.exit(main())
