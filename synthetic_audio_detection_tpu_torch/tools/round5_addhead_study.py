"""Incremental-head study row (the port of the repository's
``tools/round5_addhead_study.sh``): grow a SynthD head onto the LOGO
artifact that was trained without SynthD (``cli.add_head``, the trunk
frozen), then run the accuracy study of the grown artifact on the full
held-out tree.

Usage:
    python -m synthetic_audio_detection_tpu_torch.tools.round5_addhead_study <corpus-root>

Reads ``<corpus-root>/logo_SynthD/joint_model.ckpt.merged.ckpt``; writes
``logo_SynthD_plusD.ckpt`` (and its ``.pth``) and
``logo_SynthD_plusD_full.json``, with the steps' logs and
``campaign5.log`` under ``<corpus-root>/campaign_logs/``. Each step is
bounded (3600 s, 1800 s); a failing step ends the run with exit code 1.
Env knob: DEVICE=cuda.
"""

from __future__ import annotations

import os
import sys

from synthetic_audio_detection_tpu_torch.tools import campaign
from synthetic_audio_detection_tpu_torch.tools.campaign import clock, command


def run(root: str, cls: str = "SynthD", device: str = "cuda") -> int:
    """``cls`` is the class grown back onto ``logo_<cls>`` (the script's
    SynthD)."""
    d = os.path.abspath(root)
    log = f"{d}/campaign_logs"
    os.makedirs(log, exist_ok=True)
    campaign_log = f"{log}/campaign5.log"
    m = f"{d}/logo_{cls}/joint_model.ckpt.merged.ckpt"
    out = f"{d}/logo_{cls}_plus{cls.removeprefix('Synth')}.ckpt"
    campaign.mark(campaign_log, f"=== addhead_train {clock()}")
    if campaign.run_to(command("cli.add_head", "--merged-model", m, "--data-dir", f"{d}/dataset",
                               "--new-class", cls, "--epochs", "3", "--batch-size", "64",
                               "--bf16", "--input-size", "native", "--output", out,
                               "--device", device),
                       f"{log}/addhead_train.log", timeout_s=3600, stderr_too=True):
        return 1
    campaign.mark(campaign_log, f"=== addhead_eval {clock()}")
    with open(f"{log}/addhead_eval.log", "wb") as err:
        with open(f"{out[:-len('.ckpt')]}_full.json", "wb") as json_out:
            rc = campaign.call(command("tools.accuracy_study", "--merged-model", out,
                                       "--data-dir", f"{d}/dataset/test",
                                       "--input-size", "native", "--bf16", "--device", device),
                               1800, stdout=json_out, stderr=err)
    if rc:
        return 1
    campaign.mark(campaign_log, f"=== addhead done {clock()}")
    return 0


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    if not args:
        return campaign.usage("round5_addhead_study <corpus-root>")
    return run(args[0], device=campaign.device())


if __name__ == "__main__":
    sys.exit(main())
