"""The port's own copies of the reference package's host modules
(utils/config, utils/calibration (complete), utils/tb_writer, audio/wavio,
audio/decode, audio/dsp's resample_poly_np, checkpoints/torch_compat)
against the originals, so a copy cannot drift silently; and the port's
device default."""

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

CONFIGS = ["AudioConfig", "SpectrogramConfig", "InferenceConfig", "SpecAugmentConfig",
           "TrainConfig"]


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


def test_calibration_copy_matches_reference():
    """The port's utils/calibration.py holds every function of the
    original, with the same bounds and the same values (the fitting in
    full: tests/test_torch_calibration.py); it adds ``column_target``, the
    fit's column targets, for the held-out ECE of the calibration tool."""
    import inspect

    def public(mod):
        return {n for n, v in vars(mod).items()
                if inspect.isfunction(v) and not n.startswith("_") and v.__module__ == mod.__name__}

    assert public(TCal) - public(JCal) == {"column_target"}
    assert public(JCal) <= public(TCal)
    assert (TCal.T_MIN, TCal.T_MAX) == (JCal.T_MIN, JCal.T_MAX)
    rng = np.random.default_rng(4)
    z = rng.standard_normal((50, 3)) * 3
    ci = rng.integers(0, 3, 50)
    assert TCal.fit_ensemble_calibration(z, ci, ["A", "B", "Real"]) == \
        JCal.fit_ensemble_calibration(z, ci, ["A", "B", "Real"])


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


def test_wave_augment_flags_match_reference():
    import argparse

    parsers = []
    for mod in (TC, JC):
        p = argparse.ArgumentParser()
        mod.add_wave_augment_args(p)
        parsers.append(p)
    for argv in ([], ["--wave-augment"], ["--wave-augment", "--wave-noise-prob", "0.2",
                                          "--wave-snr-db", "1", "9", "--wave-lowpass-hz", "3e3",
                                          "8e3"]):
        port, ref = (p.parse_args(argv) for p in parsers)
        assert vars(port) == vars(ref)
        assert dataclasses.asdict(TC.spec_augment_from_args(port)) == dataclasses.asdict(
            JC.spec_augment_from_args(ref))
    assert TC.SpecAugmentConfig(wave_noise_prob=0.1).wave_enabled
    assert not TC.SpecAugmentConfig().wave_enabled


def test_tb_writer_matches_reference(tmp_path):
    from synthetic_audio_detection_tpu.utils import tb_writer as JTB
    from synthetic_audio_detection_tpu_torch.utils import tb_writer as TTB

    data = b"synthetic audio" * 7
    assert TTB.crc32c(data) == JTB.crc32c(data)
    files = []
    for mod, name in ((TTB, "port"), (JTB, "ref")):
        w = mod.SummaryWriter(str(tmp_path / name))
        for step in range(3):
            w.add_scalar("train/loss", 0.5 / (step + 1), step, wall_time=1000.0 + step)
        w.close()
        (f,) = list((tmp_path / name).iterdir())
        files.append(f.read_bytes())
    # the first record is the file-version event stamped with the wall clock
    skip = lambda b: b[8 + 4 + int.from_bytes(b[:8], "little") + 4:]  # noqa: E731
    assert skip(files[0]) == skip(files[1]) and len(files[0]) == len(files[1])


@pytest.mark.parametrize("rates", [(44_100, 32_000), (16_000, 32_000), (48_000, 32_000)])
def test_resample_poly_np_matches_reference(rates):
    from synthetic_audio_detection_tpu.audio.dsp import resample_poly_np as jax_resample
    from synthetic_audio_detection_tpu_torch.audio.resample import resample_poly_np

    y = np.random.default_rng(3).standard_normal(12_345).astype(np.float32)
    np.testing.assert_array_equal(resample_poly_np(y, *rates), jax_resample(y, *rates))


def test_torch_compat_training_copies_match_reference():
    """classifier_variables_from_torch, detect_checkpoint_flavor,
    trainable_param_keys, torch_optimizer_state_dict, adam_moments_from_torch
    and overlay_tree: the port's copies give the reference's outputs."""
    import jax

    torch.manual_seed(1)
    sd = {k: v.numpy() for k, v in BinaryClassifier("resnet18").state_dict().items()}
    for prefix in ("base.", ""):
        got = TT.classifier_variables_from_torch(sd, base_prefix=prefix)
        want = JT.classifier_variables_from_torch(sd, base_prefix=prefix)
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a, b)
    for obj in (sd, {"state_dict": sd, "epoch": 1}, {"state_dict": sd},
                {"sub_models.0.base.conv1.weight": 1}, {"layer1.0.conv1.weight": 1}, []):
        assert TT.detect_checkpoint_flavor(obj) == JT.detect_checkpoint_flavor(obj)
    for prefixes in (TT._PHASE1_PREFIXES, TT._PHASE2_PREFIXES):
        assert TT.trainable_param_keys(sd, prefixes, "base.") == JT.trainable_param_keys(
            sd, prefixes, "base.")
    params = JT.classifier_variables_from_torch(sd, base_prefix="base.")["params"]
    mu = jax.tree_util.tree_map(lambda a: a * 0.5, params)
    nu = jax.tree_util.tree_map(lambda a: a * a, params)
    opt_port = TT.torch_optimizer_state_dict(4, mu, nu, lr=5e-4)
    opt_ref = JT.torch_optimizer_state_dict(4, mu, nu, lr=5e-4)
    assert opt_port["param_groups"] == opt_ref["param_groups"]
    assert opt_port["state"].keys() == opt_ref["state"].keys()
    for i in opt_ref["state"]:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(opt_port["state"][i][k], opt_ref["state"][i][k])
    # a twin's state dict indexes its optimizer state in its own key order:
    # here tree_map's (sorted), the order the moment trees have
    raw = JT.torch_state_dict_from_variables(
        {"params": jax.tree_util.tree_map(lambda a: a, params)}, base_prefix="")
    got, want = (m.adam_moments_from_torch(opt_ref, raw) for m in (TT, JT))
    assert got[0] == want[0] == 4
    for a, b in zip(jax.tree_util.tree_leaves(got[1:]), jax.tree_util.tree_leaves(want[1:])):
        np.testing.assert_array_equal(a, b)
    assert TT.adam_moments_from_torch({}, raw) is None
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    for a, b in zip(jax.tree_util.tree_leaves(TT.overlay_tree(zeros, got[1])),
                    jax.tree_util.tree_leaves(JT.overlay_tree(zeros, want[1]))):
        np.testing.assert_array_equal(a, b)


def test_batching_copy_matches_reference():
    """The port's infer/batching.py: the original's public names, the same
    constructor defaults and public members (its behaviour:
    tests/test_torch_batching.py)."""
    import inspect

    from synthetic_audio_detection_tpu.infer import batching as JB
    from synthetic_audio_detection_tpu_torch.infer import batching as TB

    def public(mod):
        return sorted(n for n, v in vars(mod).items()
                      if not n.startswith("_") and getattr(v, "__module__", None) == mod.__name__)

    assert public(TB) == public(JB) == ["MicroBatcher"]
    assert inspect.signature(TB.MicroBatcher) == inspect.signature(JB.MicroBatcher)
    members = [sorted(n for n in vars(cls) if not n.startswith("_"))
               for cls in (TB.MicroBatcher, JB.MicroBatcher)]
    assert members[0] == members[1] == ["dispatch_count", "logits", "stop"]
