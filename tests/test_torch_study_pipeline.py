"""The data-preparation path end to end on the CPU: one seeded raw corpus
(the port's ``tools/gen_study_corpus``, the repository tool's files)
through the port's ``tools/study_pipeline`` and through the JAX package's
``tools/run_study_pipeline.sh`` gives the same tree, file names and bytes;
``tools/carve_eval_split.py`` runs as it is on the port's tree; and that
tree trains one step of the port's trainer."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from synthetic_audio_detection_tpu_torch.data import dataset as ds
from synthetic_audio_detection_tpu_torch.data.etl import extract_group_key
from synthetic_audio_detection_tpu_torch.tools import gen_study_corpus
from synthetic_audio_detection_tpu_torch.train.trainer import Trainer
from synthetic_audio_detection_tpu_torch.utils.config import SpectrogramConfig, TrainConfig
from tests.test_torch_etl import snapshot

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _env():
    """The repository on the path, this interpreter first on PATH, and one
    BLAS thread: the augmenters' 8 workers would otherwise each start a
    thread per core beside the suite's other workers (both chains run with
    the same count, which fixes the sgemm's summation order)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["PATH"] = os.path.dirname(sys.executable) + os.pathsep + env.get("PATH", "")
    env["OPENBLAS_NUM_THREADS"] = env["OMP_NUM_THREADS"] = env["MKL_NUM_THREADS"] = "1"
    return env


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The corpus (Real and SynthA, 3 files each, 4.5 s at 44.1 kHz)
    prepared by both chains: (port root, JAX root)."""
    base = tmp_path_factory.mktemp("study")
    src = str(base / "src")
    assert gen_study_corpus.main(["--out", src, "--classes", "1", "--files-per-class", "3",
                                  "--seconds", "4.5"]) == 0
    port, ref = str(base / "port"), str(base / "jax")
    shutil.copytree(src, port)
    shutil.copytree(src, ref)
    # the two chains side by side (each is mostly its processes' start-up)
    procs = [subprocess.Popen(cmd, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for cmd in ([sys.executable, "-m",
                          "synthetic_audio_detection_tpu_torch.tools.study_pipeline", port],
                         ["bash", os.path.join(REPO, "tools", "run_study_pipeline.sh"), ref])]
    try:
        for proc in procs:
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-2000:]
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    yield port, ref
    shutil.rmtree(base, ignore_errors=True)


def test_corpus_matches_the_repository_tool(tmp_path):
    """The port's copy writes the repository tool's files, byte for byte."""
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    args = ["--classes", "2", "--files-per-class", "2", "--seconds", "1.5", "--seed", "3"]
    assert gen_study_corpus.main(["--out", ours] + args) == 0
    subprocess.run([sys.executable, os.path.join(REPO, "tools", "gen_study_corpus.py"),
                    "--out", theirs] + args, env=_env(), check=True, capture_output=True,
                   timeout=300)
    got = snapshot(ours)
    assert got == snapshot(theirs) and len(got) == 6
    channels = sorted(int.from_bytes(got[f"raw/SynthB/src00{i}.wav"][22:24], "little")
                      for i in range(2))
    assert channels == [1, 2]  # alternating mono and stereo


def test_port_chain_gives_the_jax_scripts_tree(trees):
    port, ref = trees
    got, want = snapshot(port), snapshot(ref)
    csvs = {p for p in want if p.endswith(".csv")}
    assert csvs == {"aug_Real.csv", "aug_SynthA.csv"}
    for p in csvs:  # input_file names the corpus root
        rows = got.pop(p).decode().replace(port, "<root>")
        assert rows == want.pop(p).decode().replace(ref, "<root>")
        assert len(rows.splitlines()) == 1 + 3 * 11  # 11 outputs of each of 3 sources
    assert got.keys() == want.keys()
    assert [p for p in got if got[p] != want[p]] == []
    tree = [p for p in got if p.startswith("dataset/")]
    assert {p.split("/")[1] for p in tree} == {"train", "test"}
    assert {p.split("/")[2] for p in tree} == {"Real", "SynthA"}
    assert len(tree) >= 2 * 3 * 11  # at least one segment of each output


def test_no_source_group_straddles_the_split(trees):
    port, _ = trees
    for cls in ("Real", "SynthA"):
        sides = [{extract_group_key(f) for f in os.listdir(os.path.join(port, "dataset", s, cls))}
                 for s in ("train", "test")]
        assert sides[0] and sides[1] and not sides[0] & sides[1]


def test_carve_eval_split_runs_as_it_is_on_the_ports_tree(trees, tmp_path):
    port, _ = trees
    env = _env()
    env["PYTHONPATH"] = ""  # the tool imports nothing of either package
    res = subprocess.run([sys.executable, os.path.join(REPO, "tools", "carve_eval_split.py"),
                          "--data-dir", os.path.join(port, "dataset", "test"),
                          "--out-cal", str(tmp_path / "cal"), "--out-eval", str(tmp_path / "eval")],
                         env=env, capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    stats = json.loads(res.stdout)
    for cls in ("Real", "SynthA"):
        n = len(os.listdir(os.path.join(port, "dataset", "test", cls)))
        assert stats[cls]["cal"] + stats[cls]["eval"] == n
        cal = {extract_group_key(f) for f in os.listdir(tmp_path / "cal" / cls)}
        ev = {extract_group_key(f) for f in os.listdir(tmp_path / "eval" / cls)}
        assert not cal & ev


def test_prepared_tree_trains_one_step(trees, tmp_path):
    port, _ = trees
    data = os.path.join(port, "dataset")
    tr = Trainer(TrainConfig(data_dir=data, batch_size=2, class1="SynthA", workers=1, seed=0),
                 spec_cfg=SpectrogramConfig(out_size=64), log_dir=str(tmp_path / "runs"),
                 device="cpu")
    samples = ds.list_samples(data, "train", tr.class_names)
    assert {s[1] for s in samples} == {0, 1}
    batcher = ds.WaveformBatcher(samples, 2, shuffle=True, workers=1, seed=0)
    batch = next(tr._batches(batcher, 0, 4))
    metrics = tr._train_step(tr.state, batch, tr.generator)
    assert np.isfinite(float(metrics["loss"])) and int(tr.state.step) == 1


def test_a_failing_cli_stops_the_chain_with_its_exit_code(tmp_path, capsys):
    """As the script's ``set -e``: audio_convert reports the broken file and
    exits 1, nothing after it runs, and main returns 1."""
    from synthetic_audio_detection_tpu_torch.tools import study_pipeline

    (tmp_path / "raw" / "Real").mkdir(parents=True)
    (tmp_path / "raw" / "Real" / "bad.wav").write_bytes(b"RIFF\x00\x00\x00\x00WAVEjunk")
    assert study_pipeline.main([str(tmp_path)]) == 1
    assert "audio_convert failed (exit 1)" in capsys.readouterr().err
    assert not (tmp_path / "aug").exists() and not (tmp_path / "dataset").exists()
