"""The port's step-indexed checkpointer (``checkpoints/orbax_io.py``)
against the JAX package's Orbax one under the same sequences of saves, its
asynchronous and atomic writes, and the trainer under
``checkpoint_backend="orbax"`` against the native backend on the CPU
(float32, ResNet-18 at 64²): the same ``.pth`` twin and resumed training
bit for bit, and a saved tree equal to the state at its step while the
in-place optimizer runs on."""

import os
import shutil
import threading

import numpy as np
import pytest
import torch

from synthetic_audio_detection_tpu.checkpoints.orbax_io import OrbaxCheckpointer as JaxCkpt
from synthetic_audio_detection_tpu_torch.checkpoints import orbax_io, serialization, torch_compat
from synthetic_audio_detection_tpu_torch.checkpoints.orbax_io import OrbaxCheckpointer
from synthetic_audio_detection_tpu_torch.data import dataset as ds
from synthetic_audio_detection_tpu_torch.train.trainer import Trainer
from synthetic_audio_detection_tpu_torch.utils.config import SpectrogramConfig, TrainConfig
from tests.test_torch_trainer import make_tree

SPEC = SpectrogramConfig(out_size=64)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((4, 3)).astype(np.float32),
                       "b": rng.standard_normal(3)},
            "count": np.int32(seed), "mask": rng.integers(0, 2, 5).astype(bool),
            "layers": [rng.standard_normal(2).astype(np.float32), np.arange(3, dtype=np.int64)],
            "lr": 0.5 * seed}


def _steps(directory):
    return sorted(int(n) for n in os.listdir(directory) if n.isdigit())


def _assert_trees_equal(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys()
        for k in want:
            _assert_trees_equal(got[k], want[k])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_trees_equal(g, w)
    else:
        assert isinstance(got, np.ndarray) and got.dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_to_keep", [1, 2, 3])
def test_same_steps_trees_and_metadata_as_jax(tmp_path, max_to_keep):
    """Saves at steps 10, 20, 20 (not newer: skipped), 15 (skipped), 30, 40
    with and without metadata: after each, the same retained steps and
    latest step, and every retained step restores to the same tree and
    metadata in both packages."""
    port = OrbaxCheckpointer(str(tmp_path / "port"), max_to_keep=max_to_keep)
    ref = JaxCkpt(str(tmp_path / "jax"), max_to_keep=max_to_keep)
    for i, (step, meta) in enumerate([(10, {"epoch": 0, "best_acc": 0.5}), (20, None),
                                      (20, {"epoch": 9}), (15, {"epoch": 8}),
                                      (30, {"epoch": 2, "scheduler": {"scale": 0.5}}),
                                      (40, {"epoch": 3, "class_names": ["Real", "SynthA"]})]):
        tree = _tree(i)
        port.save(step, tree, meta)
        ref.save(step, tree, meta)
        port.wait()
        ref.wait()
        assert _steps(port.directory) == _steps(str(tmp_path / "jax"))
        assert port.latest_step() == ref.latest_step()
        for s in _steps(port.directory):
            if s == 20:  # saved without metadata: Orbax has no metadata item to restore
                got, meta_p = port.restore(s)
                assert meta_p == {}
                _assert_trees_equal(got, ref._mgr.restore(s)["tree"])
                continue
            (got, meta_p), (want, meta_j) = port.restore(s), ref.restore(s)
            _assert_trees_equal(got, want)
            assert meta_p == meta_j
    got, meta = port.restore()
    _assert_trees_equal(got, _tree(5))
    assert meta["epoch"] == 3 and len(_steps(port.directory)) == min(max_to_keep, 4)
    port.close()
    ref.close()


def test_step_layout_is_readable_without_the_class(tmp_path):
    ck = OrbaxCheckpointer(str(tmp_path / "ck"))
    ck.save(7, {"w": torch.arange(4.0), "n": np.int64(3)}, {"epoch": 1})
    ck.wait()
    assert os.listdir(ck.directory) == ["7"]
    step = os.path.join(ck.directory, "7")
    assert sorted(os.listdir(step)) == ["metadata.json", "tree.pt"]
    tree = torch.load(os.path.join(step, "tree.pt"), map_location="cpu", weights_only=True)
    assert torch.equal(tree["w"], torch.arange(4.0)) and int(tree["n"]) == 3
    assert OrbaxCheckpointer(ck.directory).latest_step() == 7  # found again from disk
    os.makedirs(os.path.join(ck.directory, ".9.tmp-1"))  # a write cut short
    assert ck.latest_step() == 7
    with pytest.raises(FileNotFoundError):
        ck.restore(8)
    with pytest.raises(FileNotFoundError):
        OrbaxCheckpointer(str(tmp_path / "empty")).restore()


@pytest.fixture
def gated_save(monkeypatch):
    """Holds every background write at its start until ``release`` is set."""
    started, release = threading.Event(), threading.Event()
    real = OrbaxCheckpointer._write

    def write(self, *args):
        started.set()
        assert release.wait(60)
        real(self, *args)

    monkeypatch.setattr(OrbaxCheckpointer, "_write", write)
    return started, release


def test_save_copies_to_host_before_returning(tmp_path, gated_save):
    """save() returns while the write is held; the caller's tensors and
    arrays are then changed in place; the step holds the values at save
    time, and latest_step() shows no step until the write lands."""
    started, release = gated_save
    ck = OrbaxCheckpointer(str(tmp_path / "ck"))
    t, a = torch.ones(3), np.zeros(2, np.float32)
    ck.save(1, {"t": t, "a": a, "v": t[1:]})
    assert started.wait(60)
    t.add_(5.0)
    a += 7.0
    assert ck.latest_step() is None and os.listdir(ck.directory) == []
    release.set()
    ck.wait()
    got, _ = ck.restore()
    np.testing.assert_array_equal(got["t"], np.ones(3, np.float32))
    np.testing.assert_array_equal(got["a"], np.zeros(2, np.float32))
    np.testing.assert_array_equal(got["v"], np.ones(2, np.float32))
    assert os.listdir(ck.directory) == ["1"]


@pytest.mark.parametrize("surfaces_at", ["wait", "save", "close", "restore"])
def test_writer_error_is_raised_by_the_next_call(tmp_path, monkeypatch, surfaces_at):
    real = torch.save

    def fail(obj, f):  # the writer thread's save fails, any other goes through
        if threading.current_thread().name.startswith("checkpoint-"):
            raise OSError("disk full")
        real(obj, f)

    ck = OrbaxCheckpointer(str(tmp_path / "ck"))
    monkeypatch.setattr(orbax_io.torch, "save", fail)
    ck.save(3, {"w": np.ones(2)})  # returns: the error is in the writer thread
    call = {"wait": ck.wait, "close": ck.close, "restore": ck.restore,
            "save": lambda: ck.save(4, {"w": np.ones(2)})}[surfaces_at]
    with pytest.raises(RuntimeError, match="failed") as err:
        call()
    assert isinstance(err.value.__cause__, OSError)
    assert os.listdir(ck.directory) == []  # neither the step nor its temporary
    monkeypatch.undo()
    ck.wait()  # raised once
    ck.save(3, {"w": np.ones(2)})  # the failed step can be written again
    ck.wait()
    assert ck.latest_step() == 3


# -- the trainer under checkpoint_backend="orbax" ----------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("orbax_tree"))
    make_tree(os.path.join(root, "data"))
    yield root
    shutil.rmtree(root, ignore_errors=True)


def _trainer(root, backend, tag, epochs=2, resume=""):
    cfg = TrainConfig(data_dir=os.path.join(root, "data"), batch_size=2, epochs=epochs,
                      workers=2, checkpoint_dir=os.path.join(root, tag), class1="SynthA",
                      seed=3, checkpoint_backend=backend, resume=resume)
    return Trainer(cfg, spec_cfg=SPEC, log_dir=os.path.join(root, "runs"), device="cpu")


def _pth(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _assert_same_obj(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same_obj(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_obj(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


def test_orbax_backend_matches_native_backend(tree):
    """Two seeded 2-epoch fits: the orbax run's .pth twin equals the native
    run's; its step directories are named by total_steps (3 a fit's best
    saves at most) and its latest restores to the native file's payload
    and metadata; both .pth twins resume to the same training."""
    native = _trainer(tree, "native", "ck_native")
    orbax = _trainer(tree, "orbax", "ck_orbax")
    saves = []
    real_save = OrbaxCheckpointer.save

    def save(self, step, t, metadata=None):
        saves.append(step)
        return real_save(self, step, t, metadata)

    OrbaxCheckpointer.save = save
    try:
        assert native.fit() == orbax.fit()
    finally:
        OrbaxCheckpointer.save = real_save
    path_n = os.path.join(tree, "ck_native", "best_model.ckpt")
    path_o = os.path.join(tree, "ck_orbax", "best_model.ckpt")
    assert not os.path.exists(path_o) and os.path.exists(path_o + ".orbax")
    _assert_same_obj(_pth(path_o + ".pth"), _pth(path_n + ".pth"))
    ck = orbax.checkpointer
    assert ck.directory == os.path.abspath(path_o + ".orbax") and ck.max_to_keep == 3
    assert saves and _steps(ck.directory) == saves[-3:]
    tree_o, meta_o = ck.restore()
    tree_n, meta_n = serialization.load_native(path_n)
    assert meta_o == meta_n and ck.latest_step() == meta_n["total_steps"] == saves[-1]
    _assert_trees_equal(tree_o, tree_n)

    resumed = [_trainer(tree, b, f"ck_{b}_2", epochs=3, resume=p + ".pth")
               for b, p in (("native", path_n), ("orbax", path_o))]
    assert resumed[0].start_epoch == resumed[1].start_epoch == meta_n["epoch"] + 1
    for tr in resumed:
        tr.fit()
    a, b = (tr.state_dict() for tr in resumed)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    (mu_a, nu_a), (mu_b, nu_b) = (tr.state.moments() for tr in resumed)
    for k in mu_a:
        assert torch.equal(mu_a[k], mu_b[k]) and torch.equal(nu_a[k], nu_b[k])


def test_saved_tree_is_the_state_at_its_step(tree, gated_save):
    """The write is held while the trainer takes another epoch of in-place
    optimizer steps (on the CPU the payload's arrays alias the live
    parameters); the step then holds the weights and moments of the .pth
    twin written at save time, bit for bit."""
    started, release = gated_save
    tr = _trainer(tree, "orbax", "ck_gated")
    samples = ds.list_samples(os.path.join(tree, "data"), "train", tr.class_names)
    batcher = ds.WaveformBatcher(samples, 2, shuffle=True, workers=2, seed=3)
    tr.train_epoch(batcher, 0)
    path = os.path.join(tree, "ck_gated", "best_model.ckpt")
    tr.save_checkpoint(0, path)
    assert started.wait(60)
    before = {k: v.copy() for k, v in tr.state_dict().items()}
    tr.train_epoch(batcher, 1)
    assert any(not np.array_equal(before[k], v) for k, v in tr.state_dict().items())
    release.set()
    tr.checkpointer.wait()
    saved, meta = tr.checkpointer.restore(meta_step := int(_pth(path + ".pth")["total_steps"]))
    assert meta["total_steps"] == meta_step == tr.checkpointer.latest_step() > 0
    twin = _pth(path + ".pth")
    got = torch_compat.torch_state_dict_from_variables(saved["variables"])
    for k, v in twin["state_dict"].items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
    count, mu, nu = serialization.adam_from_optax_state(saved["opt_state"])
    keys = torch_compat.trainable_param_keys(twin["state_dict"], base_prefix="base.")
    state = twin["optimizer"]["state"]
    assert count == int(state[0]["step"])
    for i, k in enumerate(keys):
        np.testing.assert_array_equal(mu[k], state[i]["exp_avg"].numpy(), err_msg=k)
        np.testing.assert_array_equal(nu[k], state[i]["exp_avg_sq"].numpy(), err_msg=k)
