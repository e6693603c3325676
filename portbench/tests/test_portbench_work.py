"""The frozen operation and byte counts, pinned to known figures."""

import json
from pathlib import Path

import numpy as np
import pytest

from portbench.work import frontend, model, peaks
from portbench.work import resnet_basic as resnet

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def cfg(name="r18-shared6"):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_k1_dft_count_at_the_serving_batch():
    c = cfg()
    counts = frontend.log_mel(c["spectrogram"], 32000, 128, 128000)
    assert counts["dft"] / 1e9 == pytest.approx(51.20, abs=0.005)
    assert counts["mel"] / 1e9 == pytest.approx(0.0973, abs=0.00005)  # 1,514 nonzeros a frame


def test_filterbank_is_the_ports_and_has_768_significant_bins():
    from synthetic_audio_detection_tpu_torch.ops import melspec
    from synthetic_audio_detection_tpu_torch.utils.config import SpectrogramConfig

    spec = cfg()["spectrogram"]
    mine = frontend.filterbank(spec, 32000)
    port = melspec.config_filterbank(SpectrogramConfig.inference(), 32000)
    np.testing.assert_allclose(mine, port, rtol=0, atol=1e-6)
    assert frontend.significant_bins(mine) == 768
    train = dict(spec, mel_norm=None)
    np.testing.assert_allclose(frontend.filterbank(train, 32000),
                               melspec.config_filterbank(SpectrogramConfig.train(), 32000),
                               rtol=0, atol=1e-6)


def test_conv_kernel_work_per_128_batch():
    convs = resnet.kernel_convs(512, 512)
    assert len(convs) == 19
    total = peaks.Work()
    for c in convs:
        total = total + c.work(128)
    assert total.ops_bf16 / 1e12 == pytest.approx(2.268, abs=0.0005)
    assert total.bytes / 1e9 == pytest.approx(4.636, abs=0.0005)


def test_resnet18_at_224_is_the_published_count():
    macs = sum(c.work(1).ops_bf16 for c in resnet.resnet_convs(224, 224, stem_cin=3)) / 2
    assert macs / 1e9 == pytest.approx(1.81, abs=0.01)  # He et al. 2016, Table 1: 1.8e9 FLOPs


def test_bound_takes_the_slower_of_operations_and_bytes():
    w = peaks.Work(ops_bf16=989e12, bytes=3.35e12 / 2)
    assert w.bound() == (1.0, "operations")
    assert peaks.Work(ops_f32=67e12 / 4, bytes=3.35e12).bound() == (1.0, "bytes")
    assert (w + w).ops == 2 * w.ops and (w * 3).bytes == 3 * w.bytes


def test_model_counts_scale_with_the_backbones_run():
    shared, dense = model.serve_ops_per_window(cfg()), model.serve_ops_per_window(cfg("r18-dense6"))
    one = resnet.backbone_work(1, 512, 512).ops
    assert dense - shared == pytest.approx(5 * one)
    assert 18e9 < shared < 19e9


def test_train_step_counts_forward_and_the_trainable_backward():
    c = cfg("r18-dense6")
    fwd = model.train_ops_per_row(c, trainable_from_stage=5)  # nothing but the head trains
    full = model.train_ops_per_row(c, trainable_from_stage=3)
    convs = {x.name: x.work(1).ops for x in resnet.resnet_convs(512, 512)}
    stage = lambda s: sum(v for k, v in convs.items() if k.startswith(f"layer{s}."))  # noqa: E731
    first_inputs = convs["layer3.0.conv1"] + convs["layer3.0.downsample"]
    assert full - fwd == pytest.approx(2 * stage(3) + 2 * stage(4) - first_inputs)


def test_a_block_without_a_module_is_refused():
    from portbench import reference, run
    from portbench.reference import weights

    cfg = run.cell_files("r18-shared6.bulk")["config"]
    assert model.block(cfg) is resnet and reference.backbone(cfg["model"]).shapes
    cfg["model"]["block"] = "bottleneck"
    for count in (lambda: model.serve_ops_per_window(cfg), lambda: model.train_ops_per_row(cfg),
                  lambda: weights.draw(cfg["model"], 1, "cpu"),
                  lambda: reference.backbone(cfg["model"])):
        with pytest.raises(ValueError, match="bottleneck"):
            count()
