"""The port's ETL (``data/etl.py`` and the six ETL CLIs) against the JAX
package's. Each stage gets the same seeded input tree, one fresh copy per
package (``rename_files`` and ``split_dataset`` move files), and must
leave the same file names with the same bytes and report the same thing.
Both sides are the same NumPy arithmetic on the same inputs, so the
bytes are held exactly."""

import contextlib
import hashlib
import importlib
import io
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from synthetic_audio_detection_tpu.data import etl as jetl
from synthetic_audio_detection_tpu_torch.audio import wavio
from synthetic_audio_detection_tpu_torch.data import etl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ETL_CLIS = ["file_renamer", "audio_convert", "audio_augmenter", "audio_segmenter",
            "dataset_manager", "file_manager"]
# the JAX package's flag names (tests/test_cli_surfaces.py)
REQUIRED_FLAGS = {
    "file_renamer": ["--input_dir", "--recursive"],
    "audio_convert": ["--input", "--output"],
    "audio_augmenter": ["--input", "--output", "--csv", "--pool-size"],
    "audio_segmenter": ["--input", "--output"],
    "dataset_manager": ["--input_dir", "--output_dir", "--split", "--threads"],
    "file_manager": ["--input_dir", "--fix"],
}


def write_sources(folder, n=3, seed=0, seconds=(1.3, 9.5, 4.0), rates=(44_100, 32_000, 48_000)):
    """Seeded WAVs: alternating stereo and mono, several rates and lengths."""
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        sr = rates[i % len(rates)]
        x = rng.standard_normal(int(seconds[i % len(seconds)] * sr)) * 0.2
        x = np.clip(x, -1, 1).astype(np.float32)
        if i % 2:
            x = np.stack([x, np.roll(x, 5)])
        wavio.write_wav(os.path.join(folder, f"src{i:02d}.wav"), x, sr)


def write_segment_tree(root, classes=("Real", "SynA", "SynB"), sources=5, segs=3, seed=0):
    """<root>/<cls>/<16-hex>_Segment_NNN.wav, the segmenter's naming."""
    rng = np.random.default_rng(seed)
    for cls in classes:
        os.makedirs(os.path.join(root, cls))
        for i in range(sources):
            h = hashlib.sha256(f"{cls}{i}".encode()).hexdigest()[:16]
            for s in range(segs):
                wavio.write_wav(os.path.join(root, cls, f"{h}_Segment_{s:03d}.wav"),
                                (rng.standard_normal(800) * 0.1).astype(np.float32), 32_000)


def snapshot(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def twin(tmp_path, make):
    """Two fresh copies of one input tree: (jax copy, port copy)."""
    src = tmp_path / "src"
    make(str(src))
    a, b = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(src, a)
    shutil.copytree(src, b)
    return str(a), str(b)


def rel(value, root):
    """``value`` with ``root`` taken out of every path in it."""
    if isinstance(value, str):
        return value.replace(root, "<root>")
    if isinstance(value, (list, tuple)):
        return type(value)(rel(v, root) for v in value)
    if isinstance(value, dict):
        return {k: rel(v, root) for k, v in value.items()}
    return value


def test_constants_match():
    assert etl.AUDIO_EXTENSIONS == jetl.AUDIO_EXTENSIONS
    assert (etl.TARGET_SR, etl.SEGMENT_SECONDS) == (jetl.TARGET_SR, jetl.SEGMENT_SECONDS)


@pytest.mark.parametrize("recursive", [False, True])
def test_rename_files(tmp_path, recursive):
    def make(root):
        write_sources(root, n=3)
        write_sources(os.path.join(root, "sub"), n=2, seed=1)
        with open(os.path.join(root, "notes.txt"), "w") as f:
            f.write("not audio")
    a, b = twin(tmp_path, make)
    got_j, got_p = jetl.rename_files(a, recursive), etl.rename_files(b, recursive)
    assert sorted(rel(got_p, b)) == sorted(rel(got_j, a))
    assert len(got_p) == (5 if recursive else 3)
    assert snapshot(a) == snapshot(b)
    for _, new in got_p:
        assert os.path.basename(new) == etl.hash_file(new) + ".wav"
    assert etl.rename_files(b, recursive) == []  # same content, same name


@pytest.mark.parametrize("workers", [1, 3])
def test_convert_directory(tmp_path, workers):
    def make(root):
        write_sources(root, n=4)
        with open(os.path.join(root, "clip.mp3"), "wb") as f:
            f.write(b"\xff\xfb\x90\x00not really an mp3")
    a, b = twin(tmp_path, make)
    err_j = jetl.convert_directory(a, a + "_out", workers=workers)
    err_p = etl.convert_directory(b, b + "_out", workers=workers)
    assert snapshot(a + "_out") == snapshot(b + "_out")
    assert len(snapshot(b + "_out")) == 4
    for name, data in snapshot(b + "_out").items():
        wf, sr = wavio.read_wav_bytes(data)
        assert sr == 32_000 and wf.shape[0] == 1
    if not etl.have_ffmpeg():  # the mp3: the JAX package's error string, not a raise
        assert rel(err_p, b) == rel(err_j, a) == [
            "<root>/clip.mp3: non-WAV input requires ffmpeg (not installed)"]


@pytest.mark.parametrize("as_file", [False, True])
def test_segment_directory(tmp_path, as_file):
    a, b = twin(tmp_path, lambda root: write_sources(root, n=3))
    if as_file:
        a, b = os.path.join(a, "src01.wav"), os.path.join(b, "src01.wav")
    got_j = jetl.segment_directory(a, a + "_seg", workers=2)
    got_p = etl.segment_directory(b, b + "_seg", workers=2)
    assert got_p == got_j and got_p[0] == (1 if as_file else 3)
    assert snapshot(a + "_seg") == snapshot(b + "_seg")
    lengths = sorted(wavio.read_wav_bytes(d)[0].shape[1] for d in snapshot(b + "_seg").values())
    assert lengths[-1] == 4 * 32_000  # 4-s segments and trailing parts


def test_split_audio_names(tmp_path):
    a, b = twin(tmp_path, lambda root: write_sources(root, n=2))
    got_j = jetl.split_audio(os.path.join(a, "src01.wav"), a + "_seg")
    got_p = etl.split_audio(os.path.join(b, "src01.wav"), b + "_seg")
    assert [os.path.basename(p) for p in got_p] == [os.path.basename(p) for p in got_j] == [
        "src01_Segment_000.wav", "src01_Segment_001.wav", "src01_Segment_002.wav"]


@pytest.mark.parametrize("group_aware,threads,seed,ratio", [
    (True, 1, 7, 0.5), (True, 4, 7, 0.5), (False, 1, 3, 0.5), (False, 4, 3, 0.8),
    (True, 1, 11, 0.8)])
def test_split_dataset(tmp_path, group_aware, threads, seed, ratio):
    a, b = twin(tmp_path, write_segment_tree)
    rep_j = jetl.split_dataset(a, a + "_ds", ratio, threads, seed=seed, group_aware=group_aware)
    rep_p = etl.split_dataset(b, b + "_ds", ratio, threads, seed=seed, group_aware=group_aware)
    assert rep_p.per_class == rep_j.per_class and rep_p.errors == rep_j.errors == []
    assert snapshot(a + "_ds") == snapshot(b + "_ds")
    assert snapshot(b) == {}  # moved, not copied
    if group_aware:
        assert etl.check_overlap(b + "_ds").clean


def test_split_tiny_corpus_keeps_test_nonempty(tmp_path):
    a, b = twin(tmp_path, lambda root: write_segment_tree(root, ("Real",), sources=4))
    rep_j = jetl.split_dataset(a, a + "_ds", 0.8, seed=1)
    rep_p = etl.split_dataset(b, b + "_ds", 0.8, seed=1)
    assert rep_p.per_class == rep_j.per_class and rep_p.per_class["Real"][1] > 0


@pytest.mark.parametrize("fix", [False, True])
def test_check_overlap(tmp_path, fix):
    def make(root):
        write_segment_tree(root + "_classes", sources=6, segs=4)
        jetl.split_dataset(root + "_classes", root, 0.5, seed=3, group_aware=False)
        # a collision: one group's file on both sides under the same name
        side = os.path.join(root, "train", "Real")
        name = sorted(os.listdir(side))[0]
        shutil.copy(os.path.join(side, name), os.path.join(root, "test", "Real", name))
    a, b = twin(tmp_path, make)
    rep_j, rep_p = jetl.check_overlap(a, fix), etl.check_overlap(b, fix)
    assert rep_p.overlaps == rep_j.overlaps and not rep_p.clean
    assert (rep_p.moved, rep_p.deleted, rep_p.errors) == (rep_j.moved, rep_j.deleted, [])
    assert snapshot(a) == snapshot(b)
    if fix:
        assert rep_p.deleted >= 1 and etl.check_overlap(b).clean


def test_group_helpers(tmp_path):
    for name in ("abc123_Segment_001.wav", "abc123_speed_up_1.2_Segment_001.wav", "plain.wav"):
        assert etl.extract_group_key(name) == jetl.extract_group_key(name)
    write_segment_tree(str(tmp_path / "t"), ("Real",), sources=2)
    folder = str(tmp_path / "t" / "Real")
    assert ({k: sorted(v) for k, v in etl.files_by_group(folder).items()}
            == {k: sorted(v) for k, v in jetl.files_by_group(folder).items()})
    assert etl.files_by_group(str(tmp_path / "missing")) == {}


# -- the six CLIs ------------------------------------------------------------

@pytest.mark.parametrize("name", ETL_CLIS)
def test_cli_help_and_required_flags(name):
    """--help lists the JAX package's flags; no arguments exits 2 with
    argparse's 'required' message."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    mod = f"synthetic_audio_detection_tpu_torch.cli.{name}"
    res = subprocess.run([sys.executable, "-m", mod, "--help"], capture_output=True, text=True,
                         timeout=120, env=env)
    assert res.returncode == 0, res.stderr[-500:]
    for flag in REQUIRED_FLAGS[name]:
        assert flag in res.stdout, f"{name} lacks the reference flag {flag}"
    res = subprocess.run([sys.executable, "-m", mod], capture_output=True, text=True,
                         timeout=120, env=env)
    assert res.returncode == 2 and "required" in res.stderr


def _cli_inputs(name, root):
    """The input tree of one CLI run and its argv (paths under ``root``)."""
    if name in ("file_renamer", "audio_convert", "audio_segmenter"):
        write_sources(os.path.join(root, "in"), n=3)
        if name == "file_renamer":
            return ["-i", f"{root}/in", "-r"]
        with open(os.path.join(root, "in", "x.mp3"), "wb") as f:
            f.write(b"\xff\xfb\x90\x00fake")
        return ["-i", f"{root}/in", "-o", f"{root}/out", "--workers", "2"]
    if name == "audio_augmenter":
        write_sources(os.path.join(root, "in"), n=1, seconds=(0.6,))
        return ["-i", f"{root}/in", "-o", f"{root}/out", "-c", f"{root}/aug.csv", "-p", "1",
                "--seed", "5"]
    write_segment_tree(os.path.join(root, "seg"), sources=4, segs=2)
    if name == "dataset_manager":
        return ["-i", f"{root}/seg", "-o", f"{root}/ds", "-s", "0.5", "-t", "2", "--seed", "4",
                "--no-group-aware"]
    jetl.split_dataset(f"{root}/seg", f"{root}/ds", 0.5, seed=4, group_aware=False)
    return ["-i", f"{root}/ds"]


@pytest.mark.parametrize("name", ETL_CLIS + ["file_manager --fix"])
def test_cli_main_matches_jax(tmp_path, name):
    """Each CLI's main() on the same inputs: the JAX CLI's exit code, printed
    summary and error lines (paths aside), and the same files."""
    name, *extra = name.split()
    results = {}
    for pkg in ("synthetic_audio_detection_tpu", "synthetic_audio_detection_tpu_torch"):
        root = str(tmp_path / pkg)
        argv = _cli_inputs(name, root) + extra
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = importlib.import_module(f"{pkg}.cli.{name}").main(argv)
        results[pkg] = (rc, rel(sorted(out.getvalue().splitlines()), root),
                        rel(err.getvalue(), root), snapshot(root))
    j, p = results.values()
    assert p[:3] == j[:3]
    assert p[3].keys() == j[3].keys()
    for path in p[3]:
        if path.endswith(".csv"):  # input_file holds the absolute input path
            assert rel(p[3][path].decode(), str(tmp_path / "synthetic_audio_detection_tpu_torch")) \
                == rel(j[3][path].decode(), str(tmp_path / "synthetic_audio_detection_tpu"))
        else:
            assert p[3][path] == j[3][path], path
    if name == "audio_convert" and not etl.have_ffmpeg():
        assert p[0] == 1 and "x.mp3: non-WAV input requires ffmpeg" in p[2]
