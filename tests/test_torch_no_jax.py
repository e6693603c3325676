"""The PyTorch port runs without JAX: the machine that serves it on a GPU has
none. Each check runs in a fresh interpreter whose path holds only the
repository, so nothing imported by the test process leaks in."""

import ast
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "synthetic_audio_detection_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax")
REFERENCE = "synthetic_audio_detection_tpu"  # the JAX package: nothing of it either


def _run(code, cwd, timeout=120):
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "PYTHONSTARTUP")}
    env["PYTHONPATH"] = REPO
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_cli_runs_without_importing_jax(tmp_path):
    from synthetic_audio_detection_tpu.audio import wavio

    wav = str(tmp_path / "tiny.wav")
    wavio.write_wav(wav, (np.random.default_rng(0).standard_normal(32_000 * 5) * 0.2)
                    .astype(np.float32), 32_000)
    code = f"""
        import sys, torch
        from synthetic_audio_detection_tpu_torch.checkpoints.serialization import save_merged_torch
        from synthetic_audio_detection_tpu_torch.ensemble.multihead import build_ensemble
        from synthetic_audio_detection_tpu_torch.models.classifier import BinaryClassifier
        from synthetic_audio_detection_tpu_torch.cli import inference_runner
        torch.manual_seed(0)
        sds = [BinaryClassifier().state_dict() for _ in range(2)]
        save_merged_torch("merged.pth", build_ensemble(sds, ["SynA", "SynB", "Real"]))
        rc = inference_runner.main(["--merged-model", "merged.pth", "--audio", {wav!r},
                                    "--input-size", "64", "--device", "cpu",
                                    "--output-json", "out.json"])
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in {FORBIDDEN + (REFERENCE,)!r})
        print("RC", rc, "LOADED", loaded)
    """
    res = _run(code, tmp_path)
    assert res.returncode == 0, res.stderr
    assert "RC 0 LOADED []" in res.stdout, res.stdout + res.stderr
    assert (tmp_path / "out.json").exists()


def test_trainer_cli_runs_without_importing_jax(tmp_path):
    """The submodel trainer's CLI trains one epoch on the CPU (64², a tiny
    split tree) and loads nothing of JAX or the JAX package."""
    from synthetic_audio_detection_tpu_torch.audio import wavio

    rng = np.random.default_rng(0)
    for split in ("train", "test"):
        for cls in ("Real", "SynA"):
            (tmp_path / "data" / split / cls).mkdir(parents=True)
            wavio.write_wav(str(tmp_path / "data" / split / cls / "a.wav"),
                            (rng.standard_normal(32_000 * 8) * 0.2).astype(np.float32), 32_000)
    code = f"""
        import sys
        from synthetic_audio_detection_tpu_torch.cli import submodel_trainer
        rc = submodel_trainer.main(["--data-dir", "data", "--Class1", "SynA", "--epochs", "1",
                                    "--batch-size", "2", "--input-size", "64", "--device", "cpu",
                                    "--workers", "1", "--checkpoint-dir", "ck",
                                    "--log-dir", "runs"])
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in {FORBIDDEN + (REFERENCE,)!r})
        print("RC", rc, "LOADED", loaded)
    """
    try:
        res = _run(code, tmp_path, timeout=300)
    finally:
        shutil.rmtree(tmp_path / "ck", ignore_errors=True)  # 250 MB of checkpoint
    assert res.returncode == 0, res.stderr[-2000:]
    assert "RC 0 LOADED []" in res.stdout, res.stdout + res.stderr[-2000:]


def test_ensemble_building_clis_run_without_importing_jax(tmp_path):
    """The ensemble trainer, add-head and merger CLIs answer --help, and
    their library modules import, in an interpreter whose path holds only
    the repository, loading nothing of JAX or the JAX package."""
    code = f"""
        import contextlib, io, sys
        from synthetic_audio_detection_tpu_torch.cli import add_head, ensemble_trainer, model_merger
        import synthetic_audio_detection_tpu_torch.ensemble.merger
        import synthetic_audio_detection_tpu_torch.train.add_head
        import synthetic_audio_detection_tpu_torch.train.joint
        codes = []
        for cli in (ensemble_trainer, add_head, model_merger):
            out = io.StringIO()
            try:
                with contextlib.redirect_stdout(out):
                    cli.main(["--help"])
            except SystemExit as e:
                codes.append((e.code, "--device" in out.getvalue()))
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in {FORBIDDEN + (REFERENCE,)!r})
        print("CODES", codes, "LOADED", loaded)
    """
    res = _run(code, tmp_path)
    assert res.returncode == 0, res.stderr
    assert "CODES [(0, True), (0, True), (0, True)] LOADED []" in res.stdout, res.stdout


def test_serving_and_legacy_clis_run_without_importing_jax(tmp_path):
    """The serving daemon's and the legacy path's CLIs answer --help, with
    --device among their flags, and their library modules import, in an
    interpreter whose path holds only the repository, loading nothing of
    JAX or the JAX package."""
    code = f"""
        import contextlib, io, sys
        from synthetic_audio_detection_tpu_torch.cli import legacy_inference, legacy_trainer, serve
        import synthetic_audio_detection_tpu_torch.infer.legacy_analyzer
        import synthetic_audio_detection_tpu_torch.infer.server
        import synthetic_audio_detection_tpu_torch.infer.streaming
        import synthetic_audio_detection_tpu_torch.ops.resample
        codes = []
        for cli in (serve, legacy_inference, legacy_trainer):
            out = io.StringIO()
            try:
                with contextlib.redirect_stdout(out):
                    cli.main(["--help"])
            except SystemExit as e:
                codes.append((e.code, "--device" in out.getvalue()))
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in {FORBIDDEN + (REFERENCE,)!r})
        print("CODES", codes, "LOADED", loaded)
    """
    res = _run(code, tmp_path)
    assert res.returncode == 0, res.stderr
    assert "CODES [(0, True), (0, True), (0, True)] LOADED []" in res.stdout, res.stdout


def test_release_path_runs_without_importing_jax(tmp_path):
    """infer.export's main (a CPU artifact at 64²), the artifact served by
    InferencePipeline.from_artifact, and the accuracy study's main on a
    one-file tree, in an interpreter whose path holds only the
    repository: nothing of JAX or the JAX package is loaded; the other
    release modules import alike."""
    code = f"""
        import contextlib, io, json, os, sys, torch
        import numpy as np
        from synthetic_audio_detection_tpu_torch.audio import wavio
        from synthetic_audio_detection_tpu_torch.checkpoints.serialization import save_merged_torch
        from synthetic_audio_detection_tpu_torch.ensemble.multihead import build_ensemble
        from synthetic_audio_detection_tpu_torch.infer import export
        from synthetic_audio_detection_tpu_torch.infer.pipeline import InferencePipeline
        from synthetic_audio_detection_tpu_torch.models.classifier import BinaryClassifier
        from synthetic_audio_detection_tpu_torch.tools import accuracy_study
        import synthetic_audio_detection_tpu_torch.infer.study
        import synthetic_audio_detection_tpu_torch.tools.artifact_drive
        import synthetic_audio_detection_tpu_torch.tools.calibrate_ensemble
        import synthetic_audio_detection_tpu_torch.tools.decision_ab
        import synthetic_audio_detection_tpu_torch.tools.robustness_study
        import synthetic_audio_detection_tpu_torch.utils.calibration
        torch.manual_seed(0)
        torch.set_num_threads(2)
        sds = [BinaryClassifier().state_dict() for _ in range(2)]
        save_merged_torch("merged.pth", build_ensemble(sds, ["SynA", "SynB", "Real"]))
        os.makedirs("tree/Real")
        wavio.write_wav("tree/Real/a.wav", (np.random.default_rng(0).standard_normal(
            32_000 * 4) * 0.2).astype(np.float32), 32_000)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc_export = export.main(["--merged-model", "merged.pth", "--output", "m.sadpt",
                                     "--input-size", "64", "--batch-sizes", "8",
                                     "--device", "cpu"])
            rc_study = accuracy_study.main(["--merged-model", "merged.pth", "--data-dir", "tree",
                                            "--input-size", "64", "--batch-size", "8",
                                            "--device", "cpu"])
        study = json.loads(out.getvalue().strip().splitlines()[-1])
        pipe = InferencePipeline.from_artifact("m.sadpt", device="cpu")
        res = pipe.analyze_file("tree/Real/a.wav")
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in {FORBIDDEN + (REFERENCE,)!r})
        print("RC", rc_export, rc_study, study["n_segments"], len(res["segments"]),
              "LOADED", loaded)
    """
    res = _run(code, tmp_path, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "RC 0 0 1 1 LOADED []" in res.stdout, res.stdout + res.stderr[-2000:]


def test_every_port_module_imports_without_jax(tmp_path):
    code = f"""
        import pkgutil, importlib, sys
        import synthetic_audio_detection_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in {FORBIDDEN + (REFERENCE,)!r})
        print("MODULES", len(names), "LOADED", loaded)
    """
    res = _run(code, tmp_path)
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout, res.stdout
    assert int(res.stdout.split()[1]) >= 15


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield from (f"{node.module}.{a.name}" for a in node.names)


def test_no_source_imports_jax_or_jax_package_modules():
    """Static check of every port source and chip_smoke.py: no JAX, and
    nothing of the JAX package, not even its jax-free host modules (the port
    keeps its own copies)."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            assert mod.split(".")[0] not in FORBIDDEN + (REFERENCE,), (path, mod)


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    """No result line and a non-zero exit where CUDA is missing, and when
    the script stands alone outside the repository."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = _run(f"import runpy; runpy.run_path({os.path.join(REPO, 'chip_smoke.py')!r}, "
               "run_name='__main__')", tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=alone, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def _shadow_jax(tmp_path):
    """A directory that, first on the path, makes jax, jaxlib, flax and
    optax raise ImportError when imported."""
    shadow = tmp_path / "shadow"
    for name in FORBIDDEN:
        (shadow / name).mkdir(parents=True)
        (shadow / name / "__init__.py").write_text(
            f"raise ImportError('{name} is not installed on this machine')\n")
    return str(shadow)


def test_data_preparation_runs_with_jax_unimportable(tmp_path):
    """tools/gen_study_corpus and tools/study_pipeline (the six ETL CLIs in
    subprocesses, which inherit the path) and audio/native, with jax,
    jaxlib, flax and optax unimportable: every stage runs, and nothing of
    JAX or the JAX package is loaded in the calling interpreter."""
    code = f"""
        import contextlib, io, os, sys
        from synthetic_audio_detection_tpu_torch.audio import native
        from synthetic_audio_detection_tpu_torch.tools import gen_study_corpus, study_pipeline
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc_gen = gen_study_corpus.main(["--out", "c", "--classes", "1",
                                            "--files-per-class", "1", "--seconds", "4.2"])
        rc = study_pipeline.main(["c"])
        seg = sorted(os.path.join(r, f) for r, _, fs in os.walk("c/dataset") for f in fs)
        decoded, lengths, rates = native.decode_batch(seg, 32_000 * 4, threads=2)
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in {FORBIDDEN + (REFERENCE,)!r})
        print("RC", rc_gen, rc, native.available(), len(seg) > 0, bool((lengths > 0).all()),
              set(rates.tolist()), "LOADED", loaded)
    """
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "PYTHONSTARTUP")}
    env["PYTHONPATH"] = os.pathsep.join([_shadow_jax(tmp_path), REPO])
    # one BLAS thread in the augmenter's 8 workers, beside the suite's others
    env["OPENBLAS_NUM_THREADS"] = env["OMP_NUM_THREADS"] = env["MKL_NUM_THREADS"] = "1"
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "RC 0 0 True True True {32000} LOADED []" in res.stdout, res.stdout + res.stderr[-2000:]
    assert "No overlaps found" in res.stdout
    res = subprocess.run([sys.executable, "-c", "import jax"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=60)
    assert res.returncode != 0 and "not installed on this machine" in res.stderr


def test_etl_modules_import_without_torch(tmp_path):
    """audio/dsp, data/etl and data/augment (and the ETL CLIs' modules)
    import without torch, so the augmenter's workers start without it."""
    code = """
        import sys
        import synthetic_audio_detection_tpu_torch.audio.dsp
        import synthetic_audio_detection_tpu_torch.data.augment
        import synthetic_audio_detection_tpu_torch.data.etl
        import synthetic_audio_detection_tpu_torch.tools.gen_study_corpus
        import synthetic_audio_detection_tpu_torch.tools.study_pipeline
        for name in ("file_renamer", "audio_convert", "audio_augmenter", "audio_segmenter",
                     "dataset_manager", "file_manager"):
            __import__(f"synthetic_audio_detection_tpu_torch.cli.{name}")
        print("TORCH", sorted(m for m in sys.modules if m.split(".")[0] == "torch"))
    """
    res = _run(code, tmp_path)
    assert res.returncode == 0, res.stderr
    assert "TORCH []" in res.stdout, res.stdout


def test_parallel_and_int8_paths_run_without_importing_jax(tmp_path):
    """The mesh helpers, the dryrun module and the int8 backbone import, and
    the int8 forward runs on the CPU, in an interpreter whose path holds
    only the repository, loading nothing of JAX or the JAX package."""
    code = f"""
        import sys, torch
        from synthetic_audio_detection_tpu_torch.ensemble.multihead import build_ensemble
        from synthetic_audio_detection_tpu_torch.models.classifier import BinaryClassifier
        from synthetic_audio_detection_tpu_torch.models import quantized
        from synthetic_audio_detection_tpu_torch.parallel import dryrun, sharding
        torch.manual_seed(0)
        torch.set_num_threads(2)
        sd = BinaryClassifier().state_dict()
        q = quantized.quantize_ensemble(build_ensemble([sd, sd], ["A", "B", "Real"]), device="cpu")
        out = quantized.quantized_ensemble_forward(q, torch.randn(2, 3, 64, 64))
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in {FORBIDDEN + (REFERENCE,)!r})
        print("SHAPE", tuple(out.shape), dryrun._mesh_layout(8), "LOADED", loaded)
    """
    res = _run(code, tmp_path)
    assert res.returncode == 0, res.stderr
    assert "SHAPE (2, 3) (4, 2) LOADED []" in res.stdout, res.stdout
