"""The check that the benchmark runs without JAX: no file under portbench/
imports a module whose top-level name (the part before the first dot) is
one of ``FORBIDDEN``, the reference imports nothing of the port, and at run
time ``sys.modules`` holds none of them. Names are compared whole, so the
port, ``synthetic_audio_detection_tpu_torch``, passes."""

from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import Iterable, List, Tuple

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "orbax", "synthetic_audio_detection_tpu"})
PORT = "synthetic_audio_detection_tpu_torch"
ROOT = Path(__file__).resolve().parent


def top(name: str) -> str:
    return name.split(".", 1)[0]


def imported(path: Path) -> List[str]:
    """Top-level names of the absolute imports in one source file."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [top(a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(top(node.module))
    return names


def static_violations(root: Path = ROOT) -> List[Tuple[str, str]]:
    """(file, module) for each forbidden import under ``root``, and each
    import of the port under its ``reference`` directory."""
    bad = []
    for path in sorted(root.rglob("*.py")):
        ref = "reference" in path.relative_to(root).parts
        for name in imported(path):
            if name in FORBIDDEN or (ref and name == PORT):
                bad.append((str(path.relative_to(root.parent)), name))
    return bad


def loaded(modules: Iterable[str] = None) -> List[str]:
    """Forbidden top-level names among the loaded modules."""
    names = sys.modules if modules is None else modules
    return sorted({top(n) for n in names} & FORBIDDEN)
