"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (bound with ``ctypes``; no PyTorch headers, so a
build takes seconds). Libraries go to ``synthetic_audio_detection_tpu_torch/
build/``, named by a hash of the sources and flags, and are built at first
use. Several sources build in parallel: one ``nvcc`` process each, all
started together. A missing ``nvcc`` or a failed build raises.

``build_host`` does the same for a C++ source of the host path (the audio
library ``native/sadio.cpp``) with ``g++`` and flags that do not depend on
the building host's CPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# no -march=native: the library must load on any x86-64 (or aarch64) host
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-Wall", "-Wextra")


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = os.path.join(home, "bin", "nvcc")
        if os.path.exists(candidate):
            nvcc = candidate
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                           "the port's CUDA kernels cannot be built")
    return nvcc


def _library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for src in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / f"{name}.cu"]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Sequence[str]) -> Dict[str, Path]:
    """Compile ``csrc/<name>.cu`` for each name not built yet, all in
    parallel, and return {name: library path}. Raises RuntimeError with the
    compiler's output if any build fails. The ptxas report (registers,
    shared memory, spills) of each build is kept beside its library as
    ``<library>.log``."""
    paths = {name: _library_path(name) for name in names}
    todo = [name for name, path in paths.items() if not path.exists()]
    if not todo:
        return paths
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    failures = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        Path(str(paths[name]) + ".log").write_text(log)
        os.replace(tmp, paths[name])
    if failures:
        raise RuntimeError("CUDA build failed\n" + "\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it."""
    return ctypes.CDLL(str(build([name])[name]))


def build_log(name: str) -> str:
    """The compiler's report from the build of ``csrc/<name>.cu``."""
    log = Path(str(_library_path(name)) + ".log")
    return log.read_text() if log.exists() else ""


def host_library_path(source: Path) -> Path:
    """Where ``build_host`` puts the library of ``source``: the build
    directory, named by a hash of the source and the flags."""
    source = Path(source)
    digest = hashlib.sha256(source.name.encode() + source.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:16]}.so"


def build_host(source: Path) -> Path:
    """Compile the C++ ``source`` with ``g++`` into a shared library in the
    build directory if it is not built yet, and return its path. Raises
    RuntimeError with the compiler's output if ``g++`` is missing or the
    build fails."""
    path = host_library_path(source)
    if path.exists():
        return path
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found on PATH: {Path(source).name} cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    res = subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, str(source)], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ {Path(source).name} (exit {res.returncode}):\n{res.stdout}")
    os.replace(tmp, path)
    return path
