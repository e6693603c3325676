"""No JAX: nothing under portbench/ imports jax, jaxlib, flax, optax, orbax or
the JAX package, the reference imports nothing of the port, and the run's
own check over ``sys.modules`` compares whole top-level names."""

import subprocess
import sys
from pathlib import Path

import pytest

from portbench import guard

ROOT = Path(__file__).resolve().parents[2]


def test_portbench_imports_nothing_forbidden():
    assert guard.static_violations() == []


def test_nothing_reads_the_jax_benchmarks():
    for path in (ROOT / "portbench").rglob("*.py"):
        if path.name == Path(__file__).name:
            continue
        text = path.read_text()
        assert "benchmarks/" not in text and "bench.py" not in text, path


@pytest.mark.parametrize("source,bad", [
    ("import jax\n", "jax"),
    ("import jax.numpy as jnp\n", "jax"),
    ("from flax import linen\n", "flax"),
    ("import optax, numpy\n", "optax"),
    ("from orbax.checkpoint import x\n", "orbax"),
    ("from jaxlib import xla_client\n", "jaxlib"),
    ("import synthetic_audio_detection_tpu.ops\n", "synthetic_audio_detection_tpu"),
    ("from synthetic_audio_detection_tpu import cli\n", "synthetic_audio_detection_tpu"),
])
def test_static_check_catches_forbidden_imports(tmp_path, source, bad):
    (tmp_path / "mod.py").write_text(source)
    assert guard.static_violations(tmp_path) == [(f"{tmp_path.name}/mod.py", bad)]


def test_static_check_lets_the_port_pass_but_not_in_the_reference(tmp_path):
    (tmp_path / "harness.py").write_text("import synthetic_audio_detection_tpu_torch.infer\n"
                                         "import jaxtyping\nfrom . import sibling\n")
    (tmp_path / "reference").mkdir()
    (tmp_path / "reference" / "plain.py").write_text(
        "from synthetic_audio_detection_tpu_torch.ops import melspec\n")
    assert guard.static_violations(tmp_path) == [
        (f"{tmp_path.name}/reference/plain.py", "synthetic_audio_detection_tpu_torch")]


def test_runtime_check_compares_whole_top_level_names():
    assert guard.loaded(["synthetic_audio_detection_tpu_torch", "jaxtyping", "flaxen.x",
                         "numpy"]) == []
    assert guard.loaded(["jax._src.api", "synthetic_audio_detection_tpu.utils", "orbax",
                         "torch"]) == ["jax", "orbax", "synthetic_audio_detection_tpu"]


def test_a_run_loads_no_jax():
    code = ("import sys; from portbench.tests import small; "
            "r = small.run_cell('r18-shared6.bulk', seconds=0.2); "
            "from portbench import guard; print(r['correct'], guard.loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"


def test_the_reference_and_the_harness_load_without_the_port():
    code = ("import sys; sys.modules['synthetic_audio_detection_tpu_torch'] = None; "
            "import portbench.reference.train, portbench.reference.serve, portbench.correct; "
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]
