"""Round-5 phase 2, the calibration split, spending device time once (the
port of the repository's ``tools/round5_phase2.sh``): the round-4 A/B's
cache already holds the train-tree fit logits of the SynthD artifact, so
only the CAL and EVAL halves of the test tree need device passes; the
train-fit arm is then synthesized offline from the cached fit logits and
the new EVAL-half logits (``tools.decision_ab --from-logits``).

Usage:
    python -m synthetic_audio_detection_tpu_torch.tools.round5_phase2 <corpus-root>

Reads ``logo_SynthD/joint_model.ckpt.merged.ckpt`` and
``logo_SynthD_decision_ab.json.logits.npz`` (exit 1 when either is missing);
writes ``test_cal/``, ``test_eval/``, ``calsplit_calfit.json`` (and its
logits), ``calsplit_trainfit.synth.npz`` and ``calsplit_trainfit.json``,
with the logs and ``campaign5.log`` under ``<corpus-root>/campaign_logs/``.
Each step is bounded; a failing step ends the run with exit code 1. Env
knob: DEVICE=cuda.
"""

from __future__ import annotations

import os
import sys
import traceback

import numpy as np

from synthetic_audio_detection_tpu_torch.tools import campaign
from synthetic_audio_detection_tpu_torch.tools.campaign import CARVE_EVAL_SPLIT, clock, command


def synthesize_trainfit_cache(root: str, cls: str = "SynthD") -> str:
    """The script's offline step: the round-4 cache's fit logits beside the
    CAL-fit run's EVAL-half test logits, as one ``decision_ab`` cache. →
    its path."""
    old = np.load(f"{root}/logo_{cls}_decision_ab.json.logits.npz")
    new = np.load(f"{root}/calsplit_calfit.json.logits.npz")
    assert [str(s) for s in old["class_names"]] == [str(s) for s in new["class_names"]]
    path = f"{root}/calsplit_trainfit.synth.npz"
    np.savez_compressed(
        path,
        fit_logits=old["fit_logits"], fit_class_idx=old["fit_class_idx"],
        test_logits=new["test_logits"], test_file_class=new["test_file_class"],
        test_file_count=new["test_file_count"], class_names=new["class_names"],
        real_name=new["real_name"],
        generic_head=np.array(False),
    )
    return path


def run(root: str, cls: str = "SynthD", device: str = "cuda") -> int:
    """``cls`` is the held-out class of the round-4 artifact (the script's
    SynthD)."""
    d = os.path.abspath(root)
    log = f"{d}/campaign_logs"
    os.makedirs(log, exist_ok=True)
    campaign_log = f"{log}/campaign5.log"
    m4 = f"{d}/logo_{cls}/joint_model.ckpt.merged.ckpt"
    old = f"{d}/logo_{cls}_decision_ab.json.logits.npz"
    if not os.path.isfile(m4):
        campaign.say(f"no artifact {m4}")
        return 1
    if not os.path.isfile(old):
        campaign.say(f"no round-4 cache {old}")
        return 1

    campaign.mark(campaign_log, f"=== carve {clock()}")
    if campaign.run_to(command(CARVE_EVAL_SPLIT, "--data-dir", f"{d}/dataset/test",
                               "--out-cal", f"{d}/test_cal", "--out-eval", f"{d}/test_eval"),
                       f"{log}/carve_split.log", timeout_s=300, stderr_too=True):
        return 1

    campaign.mark(campaign_log, f"=== ab_calfit {clock()}")
    if campaign.run_to(command("tools.decision_ab", "--merged-model", m4,
                               "--fit-dir", f"{d}/test_cal", "--data-dir", f"{d}/test_eval",
                               "--holdout", cls, "--input-size", "native", "--bf16",
                               "--k", "1", "2", "--output", f"{d}/calsplit_calfit.json",
                               "--device", device),
                       f"{log}/ab_calfit.log", timeout_s=3600, stderr_too=True):
        return 1

    campaign.mark(campaign_log, f"=== ab_trainfit_offline {clock()}")
    with open(f"{log}/ab_trainfit.log", "w") as f:
        try:
            synth = synthesize_trainfit_cache(d, cls)
        except Exception:
            f.write(traceback.format_exc())
            return 1
        f.write("synthesized train-fit/eval-half cache\n")
    if campaign.run_to(command("tools.decision_ab", "--merged-model", m4,
                               "--fit-dir", f"{d}/dataset/train", "--data-dir", f"{d}/test_eval",
                               "--holdout", cls, "--from-logits", synth, "--k", "1", "2",
                               "--output", f"{d}/calsplit_trainfit.json", "--device", device),
                       f"{log}/ab_trainfit.log", timeout_s=600, append=True, stderr_too=True):
        return 1

    campaign.mark(campaign_log, f"=== phase2 done {clock()}")
    return 0


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    if not args:
        return campaign.usage("round5_phase2 <corpus-root>")
    return run(args[0], device=campaign.device())


if __name__ == "__main__":
    sys.exit(main())
