"""Step-indexed asynchronous checkpoints with retention (the port's
counterpart of the reference package's ``checkpoints/orbax_io.py``).

Not Orbax: the GPU machine has none. The class keeps the reference's name
and methods, and Orbax's semantics as the reference uses them:

- one directory per step, named by the step, holding ``tree.pt`` (the tree
  with every leaf a CPU tensor, readable with ``torch.load(...,
  weights_only=True)``) and ``metadata.json``;
- a step is written under a temporary name and renamed when complete, so
  ``latest_step()`` never names a half-written step;
- only the newest ``max_to_keep`` steps stay: the oldest goes after the
  new step lands;
- ``save`` returns before the write ends and ``wait`` blocks until it has
  landed. A save of a step not newer than the newest saved one writes
  nothing, as Orbax's manager skips it;
- ``restore`` gives every leaf back as a numpy array, as Orbax restores
  the reference's numpy trees.

``save`` copies every leaf to host memory before it returns: the port's
optimizer updates parameters and moments in place (``train/steps.py``), so
a write that read the live tensors later would store a later step's
values. An error of the writer thread is raised by the next ``save``,
``wait`` or ``close``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

TREE_FILE = "tree.pt"
METADATA_FILE = "metadata.json"


def _host_copy(tree: Any) -> Any:
    """The tree with every leaf a CPU tensor that shares no memory with the
    caller's (numpy leaves and Python scalars become tensors of their
    numpy dtype)."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host_copy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(tree, copy=True))


def _to_numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    return tree.numpy()


class OrbaxCheckpointer:
    """Async step-indexed checkpoints with retention.

    Usage:
        ckpt = OrbaxCheckpointer("ckpts/orbax")
        ckpt.save(step, {"variables": ..., "opt_state": ...}, metadata)
        tree, meta = ckpt.restore()        # latest
        ckpt.wait()                        # block until async writes land
    """

    def __init__(self, directory: str, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be at least 1, not {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._last_saved = self.latest_step()

    def _steps(self):
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isdir(os.path.join(self.directory, n)))

    def _write(self, step: int, tree: Any, meta_json: Optional[str]) -> None:
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f".{step}.tmp-{os.getpid()}")
        try:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(tree, os.path.join(tmp, TREE_FILE))
            if meta_json is not None:
                with open(os.path.join(tmp, METADATA_FILE), "w", encoding="utf-8") as f:
                    f.write(meta_json)
            os.rename(tmp, final)
            for old in self._steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
        except Exception as e:  # noqa: BLE001 - raised by the caller's next call
            shutil.rmtree(tmp, ignore_errors=True)
            self._error = e

    def save(self, step: int, tree: Any, metadata: Optional[Dict] = None) -> None:
        """Copy ``tree`` to host memory and write it as step ``step`` in the
        background; ``metadata`` is stored as JSON."""
        self.wait()
        step = int(step)
        if self._last_saved is not None and step <= self._last_saved:
            return
        host = _host_copy(tree)
        meta_json = None if metadata is None else json.dumps(metadata)
        self._last_saved = step
        self._writer = threading.Thread(target=self._write, args=(step, host, meta_json),
                                        name=f"checkpoint-{step}", daemon=False)
        self._writer.start()

    def restore(self, step: Optional[int] = None):
        """→ (tree with numpy leaves, metadata dict) of ``step``, or of the
        newest step when None."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no step checkpoints in {self.directory}")
        path = os.path.join(self.directory, str(int(step)))
        if not os.path.isdir(path):
            raise FileNotFoundError(f"checkpoint at {path} not found")
        tree = _to_numpy(torch.load(os.path.join(path, TREE_FILE), map_location="cpu",
                                    weights_only=True))
        meta_path = os.path.join(path, METADATA_FILE)
        meta = {}
        if os.path.exists(meta_path):
            with open(meta_path, encoding="utf-8") as f:
                meta = json.load(f)
        return tree, meta

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Block until the pending write has landed; raise its error."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            error, self._error = self._error, None
            self._last_saved = self.latest_step()
            raise RuntimeError(f"checkpoint write in {self.directory} failed") from error

    def close(self) -> None:
        self.wait()
