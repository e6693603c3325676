"""Round-5 study campaign (the port of the repository's
``tools/round5_campaign.sh``), sequenced so the most important results
land first. Every step is time-bounded; a failed step is logged and the
campaign goes on.

1. generic-head LOGO arms SynthD and SynthF (the round-4 protocol plus
   ``--generic-head``), each evaluated on the full test tree and on the
   Real-vs-holdout tree in both decision modes (the reference unanimity and
   ``--generic-verdict``);
2. the calibration split, if the round-4 SynthD artifact exists:
   ``tools/carve_eval_split.py`` carves the test tree into group-disjoint
   CAL and EVAL halves, and ``tools.decision_ab`` fits on the train tree and
   on the CAL half, both scored on the EVAL half;
3. the generic SynthA arm.

Usage:
    python -m synthetic_audio_detection_tpu_torch.tools.round5_campaign <corpus-root> [logdir]

``logdir`` defaults to ``<corpus-root>/campaign_logs``; it holds
``campaign5.log`` and one log per step. Env knob: DEVICE=cuda.
"""

from __future__ import annotations

import os
import sys

from synthetic_audio_detection_tpu_torch.tools import campaign
from synthetic_audio_detection_tpu_torch.tools.campaign import CARVE_EVAL_SPLIT, Campaign


def open_campaign(root: str, log_dir: str = "", device: str = "cuda") -> Campaign:
    return Campaign.open(root, log_dir or os.path.join(root, "campaign_logs"), "campaign5.log",
                         device)


def gen_arm(c: Campaign, g: str) -> int:
    """A generic-head LOGO arm and its four evals. → 1 when training
    failed, else the last eval's exit code."""
    d = c.root
    syn = [n for n in campaign.classes(f"{d}/dataset/test") if n != g]
    ck = f"{d}/logo_{g}_gen"
    if c.step(f"train_{g}_gen", 4800, "cli.ensemble_trainer", "--data-dir", f"{d}/dataset",
              "--synthetic-classes", *syn, "--epochs", "6", "--batch-size", "128",
              "--seed", "0", "--bf16", "--input-size", "native", "--generic-head",
              "--checkpoint-dir", ck):
        return 1
    m = f"{ck}/joint_model.ckpt.merged.ckpt"
    ev = f"{d}/logo_{g}_gen_eval"
    campaign.unseen_tree(f"{d}/dataset/test", g, ev)
    rc = 0
    for tree, data_dir in (("full", f"{d}/dataset/test"), ("unseen", ev)):
        for mode, flags, suffix in (("ref", (), ""), ("gv", ("--generic-verdict",), "_gv")):
            rc = c.stepj(f"eval_{g}_gen_{tree}_{mode}", 1800,
                         f"{d}/logo_{g}_gen_{tree}{suffix}.json", "tools.accuracy_study",
                         "--merged-model", m, "--data-dir", data_dir, "--input-size", "native",
                         "--bf16", *flags)
    return rc


def calibration_split(c: Campaign) -> None:
    """Phase 2 on the round-4 SynthD artifact, if it exists."""
    d = c.root
    m4 = f"{d}/logo_SynthD/joint_model.ckpt.merged.ckpt"
    if not os.path.isfile(m4):
        return
    c.step("carve_split", 300, CARVE_EVAL_SPLIT, "--data-dir", f"{d}/dataset/test",
           "--out-cal", f"{d}/test_cal", "--out-eval", f"{d}/test_eval")
    for name, fit_dir, output in (("ab_trainfit", f"{d}/dataset/train", "calsplit_trainfit"),
                                  ("ab_calfit", f"{d}/test_cal", "calsplit_calfit")):
        c.step(name, 3600, "tools.decision_ab", "--merged-model", m4, "--fit-dir", fit_dir,
               "--data-dir", f"{d}/test_eval", "--holdout", "SynthD", "--input-size", "native",
               "--bf16", "--k", "1", "2", "--output", f"{d}/{output}.json")


def run(root: str, log_dir: str = "", device: str = "cuda") -> int:
    c = open_campaign(root, log_dir, device)
    gen_arm(c, "SynthD")
    gen_arm(c, "SynthF")
    calibration_split(c)
    gen_arm(c, "SynthA")
    campaign.mark(c.campaign_log, f"=== campaign5 done {campaign.date()}")
    return 0


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    if not args:
        return campaign.usage("round5_campaign <corpus-root> [logdir]")
    return run(args[0], args[1] if len(args) > 1 else "", device=campaign.device())


if __name__ == "__main__":
    sys.exit(main())
