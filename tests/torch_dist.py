"""Ranks of the port's CPU gloo tests (tests/test_torch_distributed.py):
``run_ranks`` starts one process per rank,

    python tests/torch_dist.py SCENARIO RANK WORLD DATA MODEL WORK

each joins one gloo group through a file store in WORK (never a fixed
port: the suite runs several workers at once), builds a DATA × MODEL mesh,
runs SCENARIO on the inputs the test wrote to WORK/inputs.pt and writes its
results to WORK/rank<RANK>.pt. One intra-op thread a rank; every wait has a
time limit, so a hang fails the test. Imports neither JAX nor pytest; the
step functions here also give the tests the one-process result (mesh
None)."""

import contextlib
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from synthetic_audio_detection_tpu_torch.parallel import sharding as sh  # noqa: E402
from synthetic_audio_detection_tpu_torch.train import joint, steps  # noqa: E402
from synthetic_audio_detection_tpu_torch.train.trainer import Trainer  # noqa: E402
from synthetic_audio_detection_tpu_torch.utils.config import (  # noqa: E402
    SpecAugmentConfig,
    SpectrogramConfig,
    TrainConfig,
)

INPUT = 64


def run_ranks(scenario, world, work, data=None, model=1, timeout=180):
    """Start ``world`` ranks of ``scenario`` on a ``data`` × ``model``
    mesh (data default: world // model) and wait; → each rank's results.
    Raises AssertionError with the stderr of a rank that failed, or when
    ``timeout`` seconds pass (every rank is then killed). The ranks' files
    and WORK/inputs.pt are removed once read."""
    data = data or world // model
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), scenario, str(r), str(world), str(data),
         str(model), str(work)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{scenario} on {world} ranks: no end within {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"rank {r}: rc {p.returncode}\n{out}\n{err[-3000:]}"
              for r, (p, (out, err)) in enumerate(zip(procs, outs)) if p.returncode != 0]
    assert not failed, f"{scenario} on {world} ranks:\n" + "\n".join(failed)
    results = []
    for r in range(world):  # read and removed: each holds a model's state (tens of MB)
        path = os.path.join(work, f"rank{r}.pt")
        results.append(dict(torch.load(path, weights_only=False), stdout=outs[r][0]))
        os.remove(path)
    if os.path.exists(os.path.join(work, "inputs.pt")):
        os.remove(os.path.join(work, "inputs.pt"))
    return results


def tensors(batch):
    return {k: torch.as_tensor(np.ascontiguousarray(v)) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Steps, with a mesh (a rank) or without (the one-process result)
# ---------------------------------------------------------------------------

def _train_cfg(inp):
    return TrainConfig(batch_size=2, lr=inp["lr"])


def _augment(inp):
    if not inp["augment"]:
        return SpecAugmentConfig(enabled=False)
    return SpecAugmentConfig(wave_noise_prob=0.5, wave_lowpass_prob=0.5)


def _state_out(state, names=None):
    """Parameters, BN statistics and moments by (global) name, Adam count."""
    rename = names or (lambda n: n)
    mu, nu = state.moments()
    return {"sd": {rename(k): v.detach().clone() for k, v in state.model.state_dict().items()
                   if not k.endswith("num_batches_tracked")},
            "mu": {rename(k): v.clone() for k, v in mu.items()},
            "nu": {rename(k): v.clone() for k, v in nu.items()},
            "count": int(state.count)}


@contextlib.contextmanager
def adam_eps(eps):
    """AdamW's eps for the span (the port's is a module constant), put
    back after: the one-process results run in the test's own process."""
    before = steps.EPS
    steps.EPS = eps
    try:
        yield
    finally:
        steps.EPS = before


def submodel_step(inp, mesh=None):
    """One submodel train step from ``inp`` (the initial state dict, the
    global batch, the options) on this rank's rows (``mesh``) or on all of
    them."""
    with adam_eps(inp["eps"]):
        return _submodel_step(inp, mesh)


def _submodel_step(inp, mesh):
    from synthetic_audio_detection_tpu_torch.models.classifier import BinaryClassifier

    model = BinaryClassifier("resnet18")
    model.load_state_dict(inp["state_dict"], strict=False)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = m.p if inp["dropout"] else 0.0
    state = steps.create_train_state(model, _train_cfg(inp))
    step = steps.make_train_step(_train_cfg(inp), SpectrogramConfig(out_size=INPUT),
                                 _augment(inp), stop_grad_stage=inp["stage"], mesh=mesh)
    batch = inp["batch"] if mesh is None else sh.shard_batch(mesh, inp["batch"])
    m = step(state, tensors(batch), torch.Generator().manual_seed(inp["seed"]))
    return dict(_state_out(state), loss=float(m["loss"]), accuracy=float(m["accuracy"]))


def joint_step(inp, mesh=None):
    """One joint train step (N heads) from ``inp``; with a model axis this
    rank's heads, named as in the whole model."""
    with adam_eps(inp["eps"]):
        return _joint_step(inp, mesh)


def _joint_step(inp, mesh):
    n = inp["num_heads"]
    cfg = _train_cfg(inp)
    state = joint.init_joint_state("resnet18", n, torch.Generator().manual_seed(0), cfg)
    state.model.load_state_dict(inp["state_dict"], strict=False)
    for m in state.model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = m.p if inp["dropout"] else 0.0
    names = None
    if mesh is not None and mesh.size(sh.MODEL_AXIS) > 1:
        state = joint.shard_joint_state(state, mesh)
        h0 = state.model.head_range[0]
        names = lambda k: joint.global_head_name(k, h0)  # noqa: E731
    step = joint.make_joint_train_step(cfg, SpectrogramConfig(out_size=INPUT), _augment(inp),
                                       num_heads=n, stop_grad_stage=inp["stage"], mesh=mesh)
    batch = inp["batch"] if mesh is None else sh.shard_batch(mesh, inp["batch"])
    m = step(state, tensors(batch), torch.Generator().manual_seed(inp["seed"]))
    return dict(_state_out(state, names), loss=float(m["loss"]),
                per_head_loss=m["per_head_loss"].clone(),
                per_head_accuracy=m["per_head_accuracy"].clone())


def serving(inp, mesh):
    """The pipeline's logits (and per-head logits) over a data mesh, with
    the collectives of each call."""
    from synthetic_audio_detection_tpu_torch.checkpoints.serialization import load_merged_torch
    from synthetic_audio_detection_tpu_torch.infer.pipeline import InferencePipeline
    from synthetic_audio_detection_tpu_torch.utils.config import InferenceConfig

    pipe = InferencePipeline(load_merged_torch(inp["merged"]),
                             spec=SpectrogramConfig(mel_norm="slaney", out_size=INPUT),
                             infer=InferenceConfig(batch_size=inp["batch_size"]), mesh=mesh)
    out = {}
    for name, n in inp["calls"]:
        mesh.counts.clear()
        windows = inp["windows"][:n]
        if name == "per_head":
            out[name] = pipe.logits_and_per_head(windows)
        else:
            out[name] = pipe.logits_for_windows(windows)
        out[name + "_counts"] = dict(mesh.counts)
    return out


def trainer_fit(inp, mesh=None, ck="ck"):
    """Trainer.fit on the tree of ``inp`` (64², 2 files a batch; with a
    group of several ranks the trainer makes its own data mesh), then its
    evaluate pass."""
    with adam_eps(inp["eps"]):
        return _trainer_fit(inp, ck)


def _trainer_fit(inp, ck):
    cfg = TrainConfig(data_dir=inp["data"], class1="SynthA", batch_size=2, epochs=inp.get("epochs", 2), lr=inp["lr"],
                      workers=inp["workers"], data_backend=inp["backend"],
                      checkpoint_dir=os.path.join(inp["work"], ck))
    tr = Trainer(cfg, spec_cfg=SpectrogramConfig(mel_norm=None, out_size=INPUT),
                 log_dir=os.path.join(inp["work"], "runs_" + ck), device="cpu")
    best = tr.fit()
    res = tr.evaluate()
    return dict(_state_out(tr.state), best=best, steps=tr.train_steps_run,
                confusion=res.confusion, val_loss=res.val_loss, auc=res.val_auc,
                mesh=tr.mesh is not None, written=sorted(os.listdir(cfg.checkpoint_dir)))


def scenario(name, rank, world, data, model, work):
    torch.set_num_threads(1)
    sh.initialize_distributed("file://" + os.path.join(work, "init"), world, rank,
                              backend="gloo")
    mesh = sh.create_mesh(data, model)
    if name == "sum":
        # each rank contributes a [1, 2] block of (rank + 1): 1·2 + 2·2 = 6
        total = mesh.all_reduce(torch.full((1, 2), rank + 1.0), axis=None).sum()
        print("DIST_SUM", float(total), flush=True)
        out = {"sum": float(total)}
    else:
        inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
        mesh.counts.clear()
        if name == "trainer":
            out = trainer_fit(inp, ck=f"ck{rank}")
        else:
            fn = {"submodel": submodel_step, "joint": joint_step, "serving": serving}[name]
            out = fn(inp, mesh)
        out.setdefault("counts", dict(mesh.counts))
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    scenario(sys.argv[1], *map(int, sys.argv[2:6]), sys.argv[6])
