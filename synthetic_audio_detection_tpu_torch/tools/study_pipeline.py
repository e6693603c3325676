"""End-to-end study ETL: raw corpus -> the reference's six-CLI chain -> split
tree (the port of the repository's ``tools/run_study_pipeline.sh``).

Per class folder, in the script's order: file_renamer, audio_convert,
audio_augmenter, audio_segmenter; then dataset_manager over all classes and
the file_manager leakage audit. Each CLI runs as ``python -m
synthetic_audio_detection_tpu_torch.cli.<name>`` in a subprocess, as the
script runs them: the augmenter's worker processes then start from a
process that holds no CUDA context, whoever calls this tool.

Usage:
    python -m synthetic_audio_detection_tpu_torch.tools.study_pipeline <corpus-root> [split-seed]

``<corpus-root>`` must contain ``raw/<ClassName>/*.wav`` (e.g. from
``tools/gen_study_corpus --out <corpus-root>``). Produces
``<corpus-root>/dataset/{train,test}/<ClassName>/*.wav``; exits with the
first failing CLI's code.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from typing import Dict, List

# the directory that holds the package, for the CLIs' interpreter
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _cli(name: str, args: List[str], seconds: Dict[str, float]) -> None:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", f"synthetic_audio_detection_tpu_torch.cli.{name}",
                    *args], env=env, check=True)
    seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0


def run(root: str, seed: int = 11) -> Dict[str, float]:
    """Run the chain over ``root``; → each CLI's seconds, summed over the
    classes. Raises subprocess.CalledProcessError on a failing CLI."""
    d = os.path.abspath(root)
    seconds: Dict[str, float] = {}
    for cls in sorted(os.listdir(os.path.join(d, "raw"))):
        print(f"=== {cls}: rename -> convert -> augment -> segment", flush=True)
        _cli("file_renamer", ["-i", f"{d}/raw/{cls}"], seconds)
        _cli("audio_convert", ["-i", f"{d}/raw/{cls}", "-o", f"{d}/conv/{cls}"], seconds)
        _cli("audio_augmenter", ["-i", f"{d}/conv/{cls}", "-o", f"{d}/aug/{cls}",
                                 "-c", f"{d}/aug_{cls}.csv", "--seed", str(seed)], seconds)
        _cli("audio_segmenter", ["-i", f"{d}/aug/{cls}", "-o", f"{d}/seg/{cls}"], seconds)
    print("=== split + leakage audit", flush=True)
    _cli("dataset_manager", ["-i", f"{d}/seg", "-o", f"{d}/dataset", "-s", "0.8",
                             "--seed", str(seed)], seconds)
    _cli("file_manager", ["-i", f"{d}/dataset"], seconds)
    print(f"=== done: {d}/dataset", flush=True)
    return seconds


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Raw corpus -> rename, convert, augment, segment per class -> "
        "train/test split -> leakage audit.")
    p.add_argument("root", help="corpus root holding raw/<ClassName>/*.wav")
    p.add_argument("seed", nargs="?", type=int, default=11,
                   help="augmentation and split seed (default 11)")
    args = p.parse_args(argv)
    try:
        run(args.root, args.seed)
    except subprocess.CalledProcessError as e:
        module = e.cmd[2]  # [python, "-m", module, ...]
        print(f"study_pipeline: {module} failed (exit {e.returncode})", file=sys.stderr)
        return e.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
