"""The multi-rank dryrun (the reference's ``__graft_entry__.dryrun_multichip``):
``n`` gloo CPU processes join one group on an (n/M) × M mesh
(``_mesh_layout``) and each runs, at the reference's sizes (1-s audio,
64² features, ResNet-18):

1. the data-parallel submodel train step on a global batch of 2n rows;
2. the head-parallel, data-parallel forward of a dense ensemble of
   max(2, M) heads (``shard_ensemble_heads``, ``head_parallel_logits``);
3. data-parallel serving through ``InferencePipeline(mesh=...)`` on an
   n × 1 mesh, 2n windows;
4. the head-parallel joint train step (heads along ``model``, rows along
   ``data``).

    python -m synthetic_audio_detection_tpu_torch.parallel.dryrun 4

``dryrun_multichip(n)`` starts the ranks, waits for them within its own
time limit, and raises with their stderr when one fails or the limit
passes (every rank is then killed).
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import tempfile
import time
from typing import Tuple

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MODULE = "synthetic_audio_detection_tpu_torch.parallel.dryrun"
OK_LINE = "MULTICHIP_DRYRUN_OK"


def _mesh_layout(n_devices: int) -> Tuple[int, int]:
    """(data_parallel, model_parallel): small counts get a 2-wide model axis
    (8 → 4×2); 16 ranks or more a 4-wide one (32 → 8×4), so both axes are
    live."""
    if n_devices >= 16 and n_devices % 4 == 0:
        return n_devices // 4, 4
    if n_devices >= 2 and n_devices % 2 == 0:
        return n_devices // 2, 2
    return n_devices, 1


def dryrun_multichip(n_devices: int, timeout: float = 900.0) -> None:
    """Run the dryrun on ``n_devices`` gloo CPU processes; raises
    RuntimeError with the failing ranks' stderr, or when ``timeout``
    seconds pass (every rank still running is then killed)."""
    with tempfile.TemporaryDirectory(prefix="sad_dryrun_") as tmp, \
            contextlib.ExitStack() as files:
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
        init = "file://" + os.path.join(tmp, "init")
        procs, outs, errs = [], [], []
        try:
            for rank in range(n_devices):
                outs.append(files.enter_context(open(os.path.join(tmp, f"{rank}.out"), "w+")))
                errs.append(files.enter_context(open(os.path.join(tmp, f"{rank}.err"), "w+")))
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", MODULE, "--rank", str(rank), str(n_devices), init],
                    cwd=tmp, env=env, stdout=outs[-1], stderr=errs[-1]))
            deadline = time.monotonic() + timeout
            while True:
                codes = [p.poll() for p in procs]
                if None not in codes or any(c not in (None, 0) for c in codes):
                    break
                if time.monotonic() > deadline:
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        timed_out = None in codes
        bad = [r for r, p in enumerate(procs)
               if p.returncode != 0 or not _read(outs[r]).rstrip().endswith(OK_LINE)]
        if bad:
            reason = f"timed out after {timeout:.0f} s" if timed_out else f"ranks {bad} failed"
            tails = "\n".join(f"--- rank {r} (rc {procs[r].returncode}) stderr:\n"
                              f"{_read(errs[r])[-3000:]}" for r in bad[:4])
            raise RuntimeError(f"multichip dryrun on {n_devices} ranks: {reason}\n{tails}")


def _read(f) -> str:
    f.flush()
    f.seek(0)
    return f.read()


def _run_rank(rank: int, n_devices: int, init_url: str) -> None:
    import numpy as np
    import torch

    from synthetic_audio_detection_tpu_torch.ensemble.multihead import (
        build_ensemble,
        head_parallel_logits,
    )
    from synthetic_audio_detection_tpu_torch.infer.pipeline import InferencePipeline
    from synthetic_audio_detection_tpu_torch.models.classifier import BinaryClassifier
    from synthetic_audio_detection_tpu_torch.models.init import flax_default_init_
    from synthetic_audio_detection_tpu_torch.parallel import sharding as sh
    from synthetic_audio_detection_tpu_torch.train import joint, steps
    from synthetic_audio_detection_tpu_torch.utils.config import (
        InferenceConfig,
        SpecAugmentConfig,
        SpectrogramConfig,
        TrainConfig,
    )

    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", init_method=init_url, world_size=n_devices,
                                         rank=rank)
    data_par, model_par = _mesh_layout(n_devices)
    mesh = sh.create_mesh(data_par, model_par)

    def tensors(batch):
        return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}

    # 1. the data-parallel train step (1-s audio, 64² features)
    spec = SpectrogramConfig(out_size=64)
    cfg = TrainConfig(batch_size=2 * n_devices)
    model = BinaryClassifier("resnet18")
    flax_default_init_(model, torch.Generator().manual_seed(0))
    state = steps.create_train_state(sh.replicate(mesh, model), cfg)
    step = steps.make_train_step(cfg, spec, SpecAugmentConfig(), stop_grad_stage=4, mesh=mesh)
    rows = 2 * n_devices
    batch = {"audio": (np.random.default_rng(0).standard_normal((rows, 32_000)) * 0.2
                       ).astype(np.float32),
             "label": np.tile(np.array([0, 1], np.int64), rows // 2)}
    metrics = step(state, tensors(sh.shard_batch(mesh, batch)), torch.Generator().manual_seed(1))
    if not bool(torch.isfinite(metrics["loss"])):
        raise RuntimeError("the data-parallel train step's loss is not finite")
    del model, state, step  # each part's memory is free before the next: 32 ranks share a host

    # 2. the head-parallel (and data-parallel) dense ensemble forward
    n_heads = max(2, model_par)
    sds = []
    for i in range(n_heads):
        clf = BinaryClassifier("resnet18")
        flax_default_init_(clf, torch.Generator().manual_seed(10 + i))
        sds.append(clf.state_dict())
    names = [f"Syn{i}" for i in range(n_heads)] + ["Real"]
    ens = build_ensemble(sds, names, detect_shared_backbone=False)
    del sds, clf
    x = np.random.default_rng(1).standard_normal((n_devices, 3, 64, 64)).astype(np.float32)
    logits = head_parallel_logits(mesh, sh.shard_ensemble_heads(mesh, ens),
                                  tensors(sh.shard_batch(mesh, {"x": x}))["x"])
    if tuple(logits.shape) != (n_devices // data_par, n_heads + 1):
        raise RuntimeError(f"head-parallel logits of shape {tuple(logits.shape)}")

    # 3. data-parallel serving
    dp_mesh = sh.create_mesh(n_devices, 1)
    pipe = InferencePipeline(ens, spec=SpectrogramConfig(mel_norm="slaney", out_size=64),
                             infer=InferenceConfig(batch_size=2 * n_devices), mesh=dp_mesh)
    windows = (np.random.default_rng(2).standard_normal((2 * n_devices, 32_000)) * 0.3
               ).astype(np.float32)
    served = pipe.logits_for_windows(windows)
    if served.shape != (2 * n_devices, n_heads + 1) or not np.isfinite(served).all():
        raise RuntimeError(f"data-parallel serving gave {served.shape}, finite "
                           f"{np.isfinite(served).all()}")
    del ens, pipe

    # 4. the head-parallel joint train step
    jcfg = TrainConfig(batch_size=2 * n_devices)
    jstate = joint.init_joint_state("resnet18", n_heads, torch.Generator().manual_seed(7), jcfg)
    jstate = joint.shard_joint_state(jstate, mesh)
    jstep = joint.make_joint_train_step(jcfg, spec, SpecAugmentConfig(enabled=False),
                                        num_heads=n_heads, stop_grad_stage=4, mesh=mesh)
    jbatch = {"audio": (np.random.default_rng(3).standard_normal((rows, 32_000)) * 0.2
                        ).astype(np.float32),
              "label": np.arange(rows, dtype=np.int64) % (n_heads + 1)}
    jm = jstep(jstate, tensors(sh.shard_batch(mesh, jbatch)), torch.Generator().manual_seed(8))
    if not bool(torch.isfinite(jm["loss"])):
        raise RuntimeError("the joint step's loss is not finite")
    torch.distributed.destroy_process_group()
    print(OK_LINE, flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--rank":
        _run_rank(int(argv[1]), int(argv[2]), argv[3])
        return 0
    dryrun_multichip(int(argv[0]) if argv else 4)
    print(OK_LINE)
    return 0


if __name__ == "__main__":
    sys.exit(main())
