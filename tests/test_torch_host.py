"""The port's own copies of the reference package's host modules
(utils/config, utils/calibration, audio/wavio, audio/decode,
checkpoints/torch_compat) against the originals, so a copy cannot drift
silently; and the port's device default."""

import dataclasses

import numpy as np
import pytest
import torch

from synthetic_audio_detection_tpu.audio import decode as JD
from synthetic_audio_detection_tpu.audio import wavio as JW
from synthetic_audio_detection_tpu.checkpoints import torch_compat as JT
from synthetic_audio_detection_tpu.utils import calibration as JCal
from synthetic_audio_detection_tpu.utils import config as JC
from synthetic_audio_detection_tpu_torch.audio import decode as TD
from synthetic_audio_detection_tpu_torch.audio import wavio as TW
from synthetic_audio_detection_tpu_torch.checkpoints import torch_compat as TT
from synthetic_audio_detection_tpu_torch.ensemble.multihead import build_ensemble
from synthetic_audio_detection_tpu_torch.infer import pipeline as TP
from synthetic_audio_detection_tpu_torch.models.classifier import BinaryClassifier
from synthetic_audio_detection_tpu_torch.utils import calibration as TCal
from synthetic_audio_detection_tpu_torch.utils import config as TC

CONFIGS = ["AudioConfig", "SpectrogramConfig", "InferenceConfig"]


@pytest.mark.parametrize("name", CONFIGS)
def test_config_fields_and_defaults_match_reference(name):
    port, ref = getattr(TC, name), getattr(JC, name)
    assert port is not ref
    pf = [(f.name, f.type, f.default) for f in dataclasses.fields(port)]
    rf = [(f.name, f.type, f.default) for f in dataclasses.fields(ref)]
    assert pf == rf
    assert port.__dataclass_params__.frozen and ref.__dataclass_params__.frozen


def _views(cfg):
    """Every field and derived value a config exposes."""
    out = dataclasses.asdict(cfg)
    for prop in ("window_samples", "hop_samples", "win", "n_freqs", "is_native"):
        if hasattr(cfg, prop):
            out[prop] = getattr(cfg, prop)
    if hasattr(cfg, "num_frames"):
        out["frames"] = [cfg.num_frames(n) for n in (32_000, 128_000, 130_001)]
        out["hw"] = [cfg.model_input_hw(n) for n in (128_000, 64_000)]
    return out


@pytest.mark.parametrize("preset", [
    ("AudioConfig", "legacy", ()),
    ("SpectrogramConfig", "train", ()),
    ("SpectrogramConfig", "inference", ()),
    ("SpectrogramConfig", "inference", (256,)),
    ("SpectrogramConfig", "inference", (0,)),
])
def test_config_presets_match_reference(preset):
    name, method, args = preset
    port = getattr(getattr(TC, name), method)(*args)
    ref = getattr(getattr(JC, name), method)(*args)
    assert _views(port) == _views(ref)


@pytest.mark.parametrize("name", CONFIGS)
def test_config_derived_values_match_reference(name):
    assert _views(getattr(TC, name)()) == _views(getattr(JC, name)())


@pytest.mark.parametrize("value", ["512", "256", "native", "NATIVE", " 0 ", 64, "-1", "x"])
def test_parse_input_size_matches_reference(value):
    def outcome(fn):
        try:
            return fn(value)
        except ValueError:
            return ValueError

    assert outcome(TC.parse_input_size) == outcome(JC.parse_input_size)


def test_apply_calibration_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((9, 4)).astype(np.float32) * 3
    cal = {"temperatures": [0.7, 1.3, 2.0, 0.9]}
    np.testing.assert_array_equal(TCal.apply_calibration(logits, cal),
                                  JCal.apply_calibration(logits, cal))
    with pytest.raises(ValueError):
        TCal.apply_calibration(logits, {"temperatures": [1.0, 2.0]})


@pytest.mark.parametrize("subtype", ["PCM_16", "FLOAT"])
def test_wav_io_matches_reference(tmp_path, subtype):
    rng = np.random.default_rng(1)
    wave = np.clip(rng.standard_normal((2, 3001)) * 0.3, -1, 1).astype(np.float32)
    TW.write_wav(tmp_path / "port.wav", wave, 22_050, subtype=subtype)
    JW.write_wav(tmp_path / "ref.wav", wave, 22_050, subtype=subtype)
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "ref.wav").read_bytes()
    for reader in (TW.read_wav, TD.load_audio):
        got, sr = reader(tmp_path / "ref.wav")
        ref, rsr = JD.load_audio(str(tmp_path / "ref.wav"))
        assert sr == rsr == 22_050
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(TW.pcm16_quantize(wave), JW.pcm16_quantize(wave))


def test_torch_compat_copies_match_reference():
    torch.manual_seed(0)
    sds = [BinaryClassifier("resnet18").state_dict() for _ in range(2)]
    merged = {f"sub_models.{i}.{k}": v.numpy() for i, sd in enumerate(sds) for k, v in sd.items()}
    port, ref = TT.split_merged_state_dict(merged), JT.split_merged_state_dict(merged)
    assert len(port) == len(ref) == 2
    for p, r in zip(port, ref):
        assert p.keys() == r.keys()
    variables = JT.classifier_variables_from_torch(port[0], base_prefix="base.")
    got = TT.torch_state_dict_from_variables(variables)
    want = JT.torch_state_dict_from_variables(variables)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_pipeline_defaults_to_cuda():
    """InferencePipeline runs on the card unless asked for the CPU: without
    CUDA a default-constructed pipeline raises instead of falling back."""
    import inspect

    assert inspect.signature(TP.InferencePipeline).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    torch.manual_seed(0)
    ens = build_ensemble([BinaryClassifier("resnet18").state_dict()], ["SynA", "Real"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TP.InferencePipeline(ens)
