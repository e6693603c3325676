"""The port's mesh helpers (``parallel/sharding.py``) on the CPU: the mesh's
shape rules in a one-rank gloo group (a file store under tmp_path), the
process-group plumbing (the twin of tests/test_distributed.py's), and the
rows and heads a rank holds, on meshes laid out by a stand-in device mesh."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from synthetic_audio_detection_tpu_torch.ensemble.multihead import build_ensemble
from synthetic_audio_detection_tpu_torch.models.classifier import BinaryClassifier
from synthetic_audio_detection_tpu_torch.parallel import sharding as sh


class _Layout:
    """A DeviceMesh's layout queries for a D × M mesh seen from (d, m)."""

    def __init__(self, data, model, d=0, m=0):
        self.dims, self.at = (data, model), {sh.DATA_AXIS: d, sh.MODEL_AXIS: m}

    def size(self, i):
        return self.dims[i]

    def get_local_rank(self, axis):
        return self.at[axis]


def _mesh(data, model, d=0, m=0):
    return sh.Mesh(_Layout(data, model, d, m), torch.device("cpu"))


@pytest.fixture
def one_rank_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'init'}", world_size=1,
                            rank=0)
    yield
    dist.destroy_process_group()


def test_create_mesh_shapes_and_errors(one_rank_group):
    mesh = sh.create_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.device == torch.device("cpu")
    assert mesh.rank(sh.DATA_AXIS) == mesh.rank(sh.MODEL_AXIS) == 0
    assert sh.create_mesh(1, 1).shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="2x1 != 1 ranks"):
        sh.create_mesh(2, 1)
    with pytest.raises(ValueError):
        sh.create_mesh(-1, 2)  # 1 // 2 data ranks
    # one rank's collectives are counted and leave the values as they are
    x = torch.arange(6.0).view(3, 2)
    assert torch.equal(mesh.all_reduce(x), x) and torch.equal(mesh.all_gather(x), x)
    assert mesh.counts == {"all_reduce": 1, "all_gather": 1}


def test_create_mesh_needs_a_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        sh.create_mesh()


def test_initialize_distributed_plumbing(monkeypatch):
    """One process (or none given) → no group; several → the arguments
    passed through; torchrun's variables fill what is not given."""
    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda backend, **kw: calls.append(
        dict(backend=backend, **kw)))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    sh.initialize_distributed(None, None, None)
    sh.initialize_distributed("host:1", 1, 0)
    assert calls == []
    sh.initialize_distributed("host:1234", 4, 2, backend="gloo")
    assert calls == [{"backend": "gloo", "init_method": "tcp://host:1234", "world_size": 4,
                      "rank": 2}]
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29500")
    sh.initialize_distributed(backend="gloo")
    sh.initialize_distributed("file:///tmp/x", 3, 0, backend="gloo")
    assert calls[1:] == [
        {"backend": "gloo", "init_method": "tcp://10.0.0.1:29500", "world_size": 2, "rank": 1},
        {"backend": "gloo", "init_method": "file:///tmp/x", "world_size": 3, "rank": 0}]


@pytest.mark.parametrize("batch,data,want", [(16, 8, 16), (7, 8, 8), (9, 4, 12), (1, 1, 1),
                                             (128, 3, 129)])
def test_pad_batch_to_multiple(batch, data, want):
    assert sh.pad_batch_to_multiple(batch, _mesh(data, 1)) == want


def test_shard_batch_takes_this_ranks_rows():
    batch = {"audio": np.arange(24.0).reshape(8, 3), "label": torch.arange(8)}
    for d in range(4):
        got = sh.shard_batch(_mesh(4, 2, d=d, m=1), batch)
        np.testing.assert_array_equal(got["audio"], batch["audio"][2 * d:2 * d + 2])
        assert torch.equal(got["label"], torch.arange(2 * d, 2 * d + 2))
    assert _mesh(4, 2, d=3).rows(2) == (6, 8)
    with pytest.raises(ValueError, match="not a multiple"):
        sh.shard_batch(_mesh(3, 1), batch)


def test_rows_of_cuts_a_global_draw():
    draws = {"a": torch.arange(6), "b": {"c": torch.arange(12).view(6, 2)}}
    got = sh.rows_of(draws, (2, 6), 3)
    assert torch.equal(got["a"], torch.tensor([2, 3, 4]))
    assert torch.equal(got["b"]["c"], torch.arange(4, 10).view(3, 2))
    assert sh.rows_of(draws, None, 6) is draws


def _ensemble(n_heads, shared):
    torch.manual_seed(0)
    sds = [BinaryClassifier().state_dict() for _ in range(n_heads)]
    if shared:
        sds = [{**{k: v for k, v in sds[0].items() if k.startswith("base.")},
                **{k: v for k, v in sd.items() if k.startswith("head.")}} for sd in sds]
    names = [f"S{i}" for i in range(n_heads)] + ["Real"]
    return build_ensemble(sds, names, detect_shared_backbone=shared)


def test_shard_ensemble_heads_gives_this_ranks_heads():
    dense = _ensemble(4, shared=False)
    for m in range(2):
        part = sh.shard_ensemble_heads(_mesh(1, 2, m=m), dense)
        assert part.class_names == [f"S{2 * m}", f"S{2 * m + 1}", "Real"]
        assert list(part.heads) == list(dense.heads)[2 * m:2 * m + 2]
        assert list(part.backbones) == list(dense.backbones)[2 * m:2 * m + 2]
    assert sh.head_slice(_mesh(2, 4, m=3), 8) == (6, 8)
    shared = _ensemble(4, shared=True)
    part = sh.shard_ensemble_heads(_mesh(2, 4, d=1, m=2), shared)
    assert part.shared_backbone and part.backbones[0] is shared.backbones[0]
    assert list(part.heads) == [shared.heads[2]]
    with pytest.raises(ValueError, match="do not split"):
        sh.shard_ensemble_heads(_mesh(1, 3), dense)
