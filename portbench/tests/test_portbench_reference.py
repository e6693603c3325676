"""The plain float32 reference against the port's plain CPU path at a small
size, and the control (the reference in fp8) outside the cells' limits."""

import numpy as np
import pytest
import torch

from portbench import correct, generate, serving
from portbench.drivers import train as train_driver
from portbench.reference import resnet as ref_resnet
from portbench.reference import serve as ref_serve
from portbench.reference import weights as ref_weights
from portbench.tests import small
from portbench.trace import Tracer

SEED = 2**31 + 5


def windows(cfg, n=6):
    a = cfg["audio"]
    T = int(a["window_seconds"] * a["sample_rate"])
    return generate.window_pool(n, T, a["sample_rate"], SEED, "cpu")


@pytest.mark.parametrize("name", ["r18-shared6.bulk", "r18-dense6.bulk"])
def test_serving_logits_match_the_ports_float32_path(name):
    from synthetic_audio_detection_tpu_torch.infer.pipeline import InferencePipeline

    cfg = small.cell(name)["config"]
    w = ref_weights.draw(cfg["model"], SEED, "cpu")
    audio, spec, infer = serving.port_configs(cfg)
    pipe = InferencePipeline(serving.build_ensemble(cfg, w, "cpu"), audio=audio, spec=spec,
                             infer=infer, compute_dtype=torch.float32, device="cpu")
    x = windows(cfg)
    port = pipe.logits_for_windows(x)
    ref = ref_serve.logits(torch.from_numpy(x), cfg, w).numpy()
    gap, spread = correct.logit_gap(port, ref)
    assert gap < 1e-2, gap
    assert spread > 1e-3  # the windows' logits differ


@pytest.mark.parametrize("name", ["r18-shared6.bulk", "r18-dense6.bulk"])
def test_fp8_control_falls_outside_the_limit(name):
    files = small.cell(name)
    cfg, limit = files["config"], files["workload"]["limits"]["logit_gap"]
    w = ref_weights.draw(cfg["model"], SEED, "cpu")
    x = torch.from_numpy(windows(cfg))
    ref = ref_serve.logits(x, cfg, w).numpy()
    low = ref_serve.logits(x, cfg, w, ref_resnet.quantizer(torch.float8_e4m3fn)).numpy()
    assert correct.logit_gap(low, ref)[0] > 2 * limit


def test_train_step_matches_the_ports_float32_step():
    files = small.cell("r18-dense6.train")
    files["config"]["train"].update(compute_dtype="float32", mel_dft="gemm")
    d = train_driver.Driver(files["config"], files["traffic"], SEED, "cpu", Tracer(False))
    d.setup()
    d.window(0.05)
    d.release()
    c = d.check({"grad_gap": 1.0, "change_gap": 1.0, "grad_diff": 1.0})
    assert c["grad_diff"]["value"] < 1e-3
    assert c["grad_gap"]["value"] < 1e-4
    assert c["change_gap"]["value"] < 1e-2  # three Adam steps: sign-like moves of tiny entries
    assert c["loss_gap"]["value"] < 1e-3


def test_train_control_falls_outside_the_limits():
    files = small.cell("r18-dense6.train")
    limits = files["workload"]["limits"]
    d = train_driver.Driver(files["config"], files["traffic"], SEED, "cpu", Tracer(False))
    d.setup()
    d.window(0.05)
    d.release()
    c = d.check(limits, control=ref_resnet.quantizer(torch.float8_e4m3fn))
    assert not correct.passed(c), c


def test_slicing_matches_the_port():
    from synthetic_audio_detection_tpu_torch.infer.pipeline import slice_waveform

    cfg = small.cell("r18-shared6.bulk")["config"]
    audio, _, _ = serving.port_configs(cfg)
    pool = windows(cfg, 6)
    for n in (1, 2, 3):
        wave = pool[:n].reshape(-1)
        port_w, port_s = slice_waveform(wave, audio)
        ref_w, ref_s = ref_serve.windows_of(wave, cfg["audio"])
        assert port_s == ref_s
        np.testing.assert_array_equal(port_w, ref_w)


def test_silent_windows_are_skipped_and_short_clips_padded():
    cfg = small.cell("r18-shared6.bulk")["config"]
    a = cfg["audio"]
    win = int(a["window_seconds"] * a["sample_rate"])
    wave = np.zeros(3 * win, np.float32)
    wave[win + 5] = 0.5
    w, stamps = ref_serve.windows_of(wave, a)
    assert len(w) == 1 and stamps == [(1.0, 2.0)]
    w, stamps = ref_serve.windows_of(np.full(win // 2, 0.1, np.float32), a)
    assert w.shape == (1, win) and stamps == [(0.0, 1.0)]
