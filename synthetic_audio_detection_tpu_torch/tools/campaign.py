"""What the study-campaign drivers share: the step runner with its time
bound and logs, the class listing, the held-out ("unseen") tree, and the one
place that names a step's interpreter.

The drivers (``train_study_ensemble``, ``generalization_study``,
``logo_calibration_followup``, ``round5_addhead_study``, ``round4_campaign``,
``round5_campaign``, ``round5_phase2``) are the port's copies of the shell
scripts of the same names under the repository's ``tools/``. Each step is a
fresh process of one of the port's CLIs or tools, started by ``command``:

    JAX step                                  port step (-m PACKAGE.<module>)
    -m synthetic_audio_detection_tpu.cli.X    cli.X
    tools/accuracy_study.py,                  tools.accuracy_study,
      calibrate_ensemble.py, decision_ab.py     tools.calibrate_ensemble, tools.decision_ab
    tools/stablehlo_drive.py                  tools.artifact_drive
    benchmarks/stage_decomp.py                tools.profile_serving
    tools/carve_eval_split.py                 the same file (it imports neither package)

where PACKAGE is ``synthetic_audio_detection_tpu_torch``,
and every port step gets ``--device $DEVICE`` (default ``cuda``). The
scripts change to the repository's root first; a driver resolves
``<corpus-root>`` against the caller's directory and runs its steps there,
with the repository on ``PYTHONPATH``.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import signal
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PACKAGE = "synthetic_audio_detection_tpu_torch"
CARVE_EVAL_SPLIT = os.path.join(REPO, "tools", "carve_eval_split.py")
# a step's interpreter: the only place the drivers name one (a test or a
# harness may swap it, e.g. for an interpreter that wraps each step)
INTERPRETER: List[str] = [sys.executable]
TIMED_OUT = 124  # the exit code of timeout(1) when the bound passed
KILL_GRACE_S = 10.0  # after SIGTERM, before SIGKILL


def command(target: str, *args) -> List[str]:
    """The argv of a step: ``target`` is a module of the port relative to
    the package (``"cli.ensemble_trainer"``, ``"tools.accuracy_study"``) or
    the path of a ``.py`` script."""
    head = [target] if target.endswith(".py") else ["-m", f"{PACKAGE}.{target}"]
    return [*INTERPRETER, *head, *(str(a) for a in args)]


def step_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    return env


def _kill_group(pgid: int, sig: int) -> None:
    try:
        os.killpg(pgid, sig)
    except (ProcessLookupError, PermissionError):
        pass


@contextlib.contextmanager
def _session(cmd: Sequence[str], **popen_kw):
    """``cmd`` started in a session (and process group) of its own; on
    leaving, in any way, what is left of the group is killed, so no worker
    of a trainer or of the augmenter outlives its step."""
    sys.stdout.flush()
    proc = subprocess.Popen(list(cmd), env=step_env(), start_new_session=True, **popen_kw)
    try:
        yield proc
    finally:
        _kill_group(proc.pid, signal.SIGKILL)
        proc.wait()


def _shell_status(rc: int) -> int:
    """A Popen return code as the shell reports it (128 + N for signal N)."""
    return 128 - rc if rc < 0 else rc


def call(cmd: Sequence[str], timeout_s: Optional[float] = None, stdout=None,
         stderr=None) -> int:
    """Run ``cmd`` in a session of its own → its exit code, as the shell
    reports it. Past ``timeout_s`` the whole process group gets SIGTERM, then
    SIGKILL after a grace, and the code is 124, as ``timeout`` gives."""
    with _session(cmd, stdout=stdout, stderr=stderr) as proc:
        try:
            return _shell_status(proc.wait(timeout=timeout_s))
        except subprocess.TimeoutExpired:
            _kill_group(proc.pid, signal.SIGTERM)
            try:
                proc.wait(timeout=KILL_GRACE_S)
            except subprocess.TimeoutExpired:
                pass
            return TIMED_OUT


def clock() -> str:
    """``date -u +%H:%M:%S``."""
    return time.strftime("%H:%M:%S", time.gmtime())


def date() -> str:
    """``date -u`` in the C locale."""
    return time.strftime("%a %b %e %H:%M:%S UTC %Y", time.gmtime())


def say(line: str) -> None:
    print(line, flush=True)


def mark(campaign_log: str, line: str) -> None:
    """``echo "$line" | tee -a "$campaign_log"``."""
    say(line)
    with open(campaign_log, "a") as f:
        f.write(line + "\n")


def step(name: str, timeout_s: float, cmd: Sequence[str], log_dir: str,
         campaign_log: str) -> int:
    """The scripts' ``step``: ``cmd`` bounded by ``timeout_s``, its stdout and
    stderr in ``<log_dir>/<name>.log``, its start and exit code in
    ``campaign_log``. → the exit code."""
    mark(campaign_log, f"=== {name} start {clock()}")
    with open(os.path.join(log_dir, f"{name}.log"), "wb") as log:
        rc = call(cmd, timeout_s, stdout=log, stderr=subprocess.STDOUT)
    mark(campaign_log, f"=== {name} rc={rc} {clock()}")
    return rc


def stepj(name: str, timeout_s: float, json_out: str, cmd: Sequence[str], log_dir: str,
          campaign_log: str) -> int:
    """The scripts' ``stepj``: as ``step``, but stdout (the tool's JSON) goes
    to ``json_out`` and only stderr to the step's log."""
    mark(campaign_log, f"=== {name} start {clock()}")
    with open(json_out, "wb") as out, open(os.path.join(log_dir, f"{name}.log"), "wb") as log:
        rc = call(cmd, timeout_s, stdout=out, stderr=log)
    mark(campaign_log, f"=== {name} rc={rc} {clock()}")
    return rc


def run_to(cmd: Sequence[str], path: str, timeout_s: Optional[float] = None,
           append: bool = False, stderr_too: bool = False) -> int:
    """``cmd > path`` (``>>`` with ``append``; ``2>&1`` with ``stderr_too``)."""
    with open(path, "ab" if append else "wb") as out:
        return call(cmd, timeout_s, stdout=out, stderr=subprocess.STDOUT if stderr_too else None)


def run_tee(cmd: Sequence[str], path: str) -> int:
    """``cmd | tee path`` under ``pipefail``: stdout to the terminal and to
    ``path``; → the command's exit code."""
    with open(path, "wb") as out, _session(cmd, stdout=subprocess.PIPE) as proc:
        for chunk in iter(lambda: proc.stdout.read1(65536), b""):
            out.write(chunk)
            sys.stdout.buffer.write(chunk)
            sys.stdout.flush()
        return _shell_status(proc.wait())


@dataclass(frozen=True)
class Campaign:
    """The corpus root, the log folder and its campaign log, the device."""
    root: str
    log: str
    campaign_log: str
    device: str = "cuda"

    @classmethod
    def open(cls, root: str, log_dir: str, log_name: str, device: str = "cuda") -> "Campaign":
        log = os.path.abspath(log_dir)
        os.makedirs(log, exist_ok=True)
        return cls(os.path.abspath(root), log, os.path.join(log, log_name), device)

    def step(self, name: str, timeout_s: float, target: str, *args) -> int:
        return step(name, timeout_s, command(target, *args, *self._device(target)),
                    self.log, self.campaign_log)

    def stepj(self, name: str, timeout_s: float, json_out: str, target: str, *args) -> int:
        return stepj(name, timeout_s, json_out,
                     command(target, *args, *self._device(target)),
                     self.log, self.campaign_log)

    def _device(self, target: str):
        return [] if target.endswith(".py") else ["--device", self.device]


def classes(folder: str) -> List[str]:
    """``ls "$folder" | grep -v '^Real$'`` under ``LC_ALL=C``: the names in
    byte order, names that start with ``.`` skipped, files kept."""
    return [n for n in sorted(os.listdir(folder)) if not n.startswith(".") and n != "Real"]


def unseen_tree(dataset_test: str, holdout: str, out: str) -> bool:
    """``rm -rf out; mkdir -p out; ln -s <abs Real> out/Real; ln -s <abs G>
    out/G``: the Real-vs-holdout tree of absolute symlinks. → False, with the
    shell's message, when a source folder is missing (its link is not made)."""
    if os.path.islink(out) or os.path.isfile(out):
        os.unlink(out)
    elif os.path.isdir(out):
        shutil.rmtree(out)
    os.makedirs(out, exist_ok=True)
    ok = True
    for name in ("Real", holdout):
        src = os.path.abspath(os.path.join(dataset_test, name))
        if not os.path.isdir(src):
            print(f"cd: {src}: No such file or directory", file=sys.stderr)
            ok = False
            continue
        os.symlink(src, os.path.join(out, name))
    return ok


def knob(name: str, default: str) -> str:
    """``${NAME:-default}``: unset or empty gives the default."""
    return os.environ.get(name) or default


def usage(text: str) -> int:
    """``${1:?usage: ...}``: the message on stderr, exit code 1."""
    print(f"usage: {text}", file=sys.stderr)
    return 1


def device() -> str:
    return knob("DEVICE", "cuda")
