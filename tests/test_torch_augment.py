"""The port's ``data/augment.py`` against the JAX package's: each of the
eleven augmentations from one seed, the written files and provenance CSV
of ``augment_directory`` (inline and through the process pool), and the
routing of non-WAV inputs. NumPy and SciPy on both sides, on the same
draws: held bit for bit."""

import csv
import os

import numpy as np
import pytest

from synthetic_audio_detection_tpu.data import augment as jaug
from synthetic_audio_detection_tpu_torch.audio import wavio
from synthetic_audio_detection_tpu_torch.data import augment
from tests.test_torch_etl import snapshot, twin


def _clip(seconds=1.2, sr=44_100, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    return (0.4 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.standard_normal(t.size)).astype(
        np.float32)


def test_constants_match():
    assert augment.AUGMENTATIONS == jaug.AUGMENTATIONS and len(augment.AUGMENTATIONS) == 11
    assert augment.AUGMENT_SR == jaug.AUGMENT_SR == 44_100


@pytest.mark.parametrize("name", augment.AUGMENTATIONS)
def test_each_augmentation_matches_jax(name):
    y = _clip()
    got, param = augment.apply_augmentation(y, 44_100, name, np.random.default_rng(17))
    ref, ref_param = jaug.apply_augmentation(y, 44_100, name, np.random.default_rng(17))
    np.testing.assert_array_equal(got, ref)
    assert param == ref_param and augment._param_str(param) == jaug._param_str(ref_param)
    if name not in ("speed_up", "slow_down", "time_pitch_shift"):
        assert len(got) == len(y)


def test_unknown_augmentation_raises():
    with pytest.raises(ValueError, match="unknown augmentation"):
        augment.apply_augmentation(_clip(), 44_100, "reverse", np.random.default_rng(0))


def _sources(root, n=2):
    os.makedirs(root)
    for i in range(n):
        x = _clip(seconds=0.7 + 0.3 * i, sr=(32_000, 44_100)[i % 2], seed=i)
        wavio.write_wav(os.path.join(root, f"{i:016x}.wav"),
                        x if i % 2 else np.stack([x, 0.5 * x]), (32_000, 44_100)[i % 2])


def _read_csv(path, root):
    with open(path, newline="") as f:
        return [{**r, "input_file": r["input_file"].replace(root, "<root>")}
                for r in csv.DictReader(f)]


@pytest.mark.parametrize("pool_size,augmentations", [
    (1, augment.AUGMENTATIONS), (2, ("original", "tremolo", "time_shift"))])
def test_augment_directory_matches_jax(tmp_path, pool_size, augmentations):
    """Every file and CSV row of the JAX package's run, from one seed: the
    per-task seed ``seed * 1_000_003 + i * 101 + j``; pool_size=2 goes
    through the worker pool (forked from a fork server)."""
    a, b = twin(tmp_path, _sources)
    rec_j = jaug.augment_directory(a, a + "_out", csv_path=a + ".csv", pool_size=pool_size,
                                   augmentations=augmentations, seed=9)
    rec_p = augment.augment_directory(b, b + "_out", csv_path=b + ".csv", pool_size=pool_size,
                                      augmentations=augmentations, seed=9)
    assert len(rec_p) == len(rec_j) == 2 * len(augmentations)
    assert snapshot(a + "_out") == snapshot(b + "_out")
    assert _read_csv(b + ".csv", b) == _read_csv(a + ".csv", a)
    for name, data in snapshot(b + "_out").items():
        wf, sr = wavio.read_wav_bytes(data)
        assert sr == 44_100 and wf.shape[0] == 2 and np.array_equal(wf[0], wf[1])


def test_single_file_input_and_naming(tmp_path):
    _sources(str(tmp_path / "in"), n=1)
    src = str(tmp_path / "in" / f"{0:016x}.wav")
    rec = augment.process_augmentation(src, str(tmp_path / "out"), "speed_up", seed=3)
    ref = jaug.process_augmentation(src, str(tmp_path / "ref"), "speed_up", seed=3)
    assert rec == ref and rec["output_file"].startswith(f"{0:016x}_speed_up_")
    assert rec["output_file"].endswith(".wav")
    assert augment.augment_directory(src, str(tmp_path / "one"), pool_size=1,
                                     augmentations=["original"], seed=1)[0]["output_file"] \
        == f"{0:016x}_original.wav"


def test_mp3_routes_through_the_decode_shim(tmp_path, monkeypatch):
    """.mp3 inputs enter the listing (not .flac) and decode through
    audio/decode.load_audio, as in the JAX package."""
    _sources(str(tmp_path / "in"), n=1)
    (tmp_path / "in" / "b.mp3").write_bytes(b"\xff\xfb\x90\x00fake")
    (tmp_path / "in" / "c.flac").write_bytes(b"fLaC")
    calls = []

    def fake_load(path):
        calls.append(os.path.basename(path))
        return _clip(seconds=0.5)[None, :], 44_100

    monkeypatch.setattr(augment, "load_audio", fake_load)
    recs = augment.augment_directory(str(tmp_path / "in"), str(tmp_path / "out"), pool_size=1,
                                     augmentations=["time_shift"], seed=2)
    assert sorted(os.path.basename(r["input_file"]) for r in recs) == [f"{0:016x}.wav", "b.mp3"]
    assert calls == ["b.mp3"]


def test_mp3_without_ffmpeg_reports_a_clear_error(tmp_path, capsys):
    from synthetic_audio_detection_tpu_torch.audio import decode

    if decode.have_ffmpeg():
        pytest.skip("ffmpeg is installed: the error path is not reachable")
    src = tmp_path / "x.mp3"
    src.write_bytes(b"\xff\xfb\x90\x00fake")
    assert augment.process_augmentation(str(src), str(tmp_path / "out"), "tremolo", 0) is None
    assert "requires ffmpeg" in capsys.readouterr().out
