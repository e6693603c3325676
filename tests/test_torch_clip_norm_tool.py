"""tools/time_clip_norm on the CPU: it runs, and its float64 form is the
exact global norm."""

import json

from synthetic_audio_detection_tpu_torch.tools import time_clip_norm


def test_time_clip_norm_runs_on_cpu(capsys):
    assert time_clip_norm.main(["--device", "cpu", "--iters", "1", "--rounds", "1"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["tensors"] == 70 and row["elements"] == 11_572_546
    assert row["norm_float64_rel_err"] < 1e-12
    assert {"norm_float32_ms", "norm_float64_ms", "clip_float32_ms", "clip_float64_ms"} <= set(row)
