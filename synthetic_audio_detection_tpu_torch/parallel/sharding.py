"""A ('data', 'model') mesh over ``torch.distributed`` (the reference
package's ``parallel/sharding.py``) and the collectives the train steps,
the trainers and the serving pipeline make over it.

The reference runs one controller over a JAX device mesh: it annotates
shardings and XLA inserts the collectives. Here each rank is one process
with one device (``cuda:LOCAL_RANK`` under NCCL, the CPU under gloo), and
every collective is explicit:

- ``data``: the batch axis. Of each global batch of D·R rows a rank holds
  rows [d·R, (d + 1)·R), d its index along ``data``; the ranks along
  ``model`` hold the same rows.
- ``model``: the ensemble-head axis. Of N = M·k heads a rank holds heads
  [m·k, (m + 1)·k), m its index along ``model``.

Every collective goes through a ``Mesh`` method, which counts it by kind
in ``mesh.counts`` (the backward pass of a differentiable all-reduce
included); the tests and chip_smoke read the counts. Nothing falls back: a
rank that cannot join its group raises, a failed collective raises, and a
mesh whose shape is not the world's is refused.
"""

from __future__ import annotations

import collections
import os
import warnings
from typing import Any, Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn

DATA_AXIS = "data"
MODEL_AXIS = "model"

# the differentiable all-reduce and all_gather_into_tensor are the calls
# this module is built on; newer torch releases mark both deprecated
warnings.filterwarnings("ignore", category=FutureWarning,
                        message=r".*(all_reduce|all_gather_into_tensor).* deprecated")


def local_rank() -> int:
    """This process's card on its host (torchrun's LOCAL_RANK, else 0)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the default process group: a no-op for one process (or none
    given) and when joined already. Arguments left None come from
    torchrun's environment: WORLD_SIZE, RANK, and MASTER_ADDR with
    MASTER_PORT. ``coordinator_address`` is 'host:port' (TCP) or an init
    URL ('tcp://…', 'file://…'). ``backend`` 'nccl' (the default: the port
    runs on the card, one per rank, ``cuda:LOCAL_RANK``) or 'gloo' (CPU
    processes)."""
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if num_processes is None or num_processes <= 1 or dist.is_initialized():
        return
    if process_id is None:
        process_id = int(env["RANK"])
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    backend = backend or "nccl"
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id)


def world_size() -> int:
    """The default group's size, 1 outside a group."""
    return dist.get_world_size() if dist.is_initialized() else 1


class Mesh:
    """A ('data', 'model') layout of the default group's ranks, row-major
    (rank = d·M + m, as the reference's device mesh), with this rank's
    device and its counted collectives."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.shape = {DATA_AXIS: device_mesh.size(0), MODEL_AXIS: device_mesh.size(1)}
        self.counts: collections.Counter = collections.Counter()

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def rank(self, axis: str) -> int:
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: Optional[str]):
        """The group along ``axis``; None: every rank of the mesh."""
        return dist.group.WORLD if axis is None else self.device_mesh.get_group(axis)

    def rows(self, n_local: int) -> Tuple[int, int]:
        """(first row, global rows) of this rank's ``n_local`` rows of a
        batch split evenly over ``data``."""
        return self.rank(DATA_AXIS) * n_local, n_local * self.size(DATA_AXIS)

    def all_reduce(self, t: torch.Tensor, axis: Optional[str] = DATA_AXIS) -> torch.Tensor:
        """The sum of ``t`` over the ranks along ``axis`` (None: every
        rank), as a new tensor. Differentiable: the backward pass sums the
        incoming gradients over the same ranks (a second, counted
        all-reduce)."""
        self.counts["all_reduce"] += 1
        out = dist_fn.all_reduce(t, group=self.group(axis))
        if out.requires_grad:
            out.register_hook(self._count_backward)
        return out

    def _count_backward(self, grad: torch.Tensor) -> None:
        self.counts["all_reduce"] += 1

    def all_gather(self, t: torch.Tensor, axis: str = DATA_AXIS) -> torch.Tensor:
        """The ranks' ``t`` along ``axis`` concatenated on dim 0 in their
        order along it (one ``all_gather_into_tensor``)."""
        t = t.contiguous()
        out = t.new_empty((t.shape[0] * self.size(axis),) + tuple(t.shape[1:]))
        self.counts["all_gather"] += 1
        dist.all_gather_into_tensor(out, t, group=self.group(axis))
        return out

    def broadcast_(self, tensors: Iterable[torch.Tensor]) -> None:
        """Rank 0's values into ``tensors`` on every rank, in place (one
        broadcast of the floating tensors flattened together in float64,
        which holds each of their values exactly)."""
        tensors = list(tensors)
        if not tensors:
            return
        flat = torch.cat([t.detach().reshape(-1).double() for t in tensors])
        self.counts["broadcast"] += 1
        dist.broadcast(flat, src=0)
        offset = 0
        with torch.no_grad():
            for t in tensors:
                n = t.numel()
                t.copy_(flat[offset:offset + n].view(t.shape))
                offset += n

    def barrier(self) -> None:
        self.counts["barrier"] += 1
        dist.barrier()


def create_mesh(data_parallel: int = -1, model_parallel: int = 1,
                device: Optional[torch.device] = None) -> Mesh:
    """Mesh('data', 'model') over the default group; ``data_parallel`` -1
    takes every remaining rank. Raises ValueError when data × model is not
    the world size, and RuntimeError outside a process group. The device is
    ``cuda:LOCAL_RANK`` under NCCL, the CPU under gloo, unless given."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs a process group: call initialize_distributed "
                           "(or torch.distributed.init_process_group) first")
    n = dist.get_world_size()
    model_parallel = max(model_parallel, 1)
    if data_parallel == -1:
        data_parallel = n // model_parallel
    if data_parallel * model_parallel != n:
        raise ValueError(f"mesh {data_parallel}x{model_parallel} != {n} ranks")
    if device is None:
        device = (torch.device("cuda", local_rank()) if dist.get_backend() == "nccl"
                  else torch.device("cpu"))
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)  # NCCL's communicators are made on the current device
    dm = init_device_mesh(device.type, (data_parallel, model_parallel),
                          mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return Mesh(dm, device)


def replicate(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank (one broadcast); the
    module, changed in place."""
    mesh.broadcast_([t for t in list(module.parameters()) + list(module.buffers())
                     if t.is_floating_point()])
    return module


def shard_batch(mesh: Mesh, batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's rows along ``data`` of every entry (tensors or arrays
    whose leading axis is the global batch, a multiple of the data size)."""
    d = mesh.size(DATA_AXIS)
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % d:
            raise ValueError(f"batch entry {k!r} has {n} rows, not a multiple of data={d}")
        start, _ = mesh.rows(n // d)
        out[k] = v[start:start + n // d]
    return out


def head_slice(mesh: Mesh, num_heads: int) -> Tuple[int, int]:
    """[h0, h1): this rank's heads along ``model``. Raises ValueError when
    ``num_heads`` is not a multiple of the model size."""
    m = mesh.size(MODEL_AXIS)
    if num_heads % m:
        raise ValueError(f"{num_heads} heads do not split over model={m}")
    k = num_heads // m
    h0 = mesh.rank(MODEL_AXIS) * k
    return h0, h0 + k


def shard_ensemble_heads(mesh: Mesh, ensemble):
    """This rank's heads along ``model`` of a ``MultiHeadEnsemble``: an
    ensemble of those heads and their backbones (a shared backbone or trunk
    is kept whole), on the mesh's device. Its columns are named by the
    heads' classes (a generic head: 'generic') and the real class; feed its
    per-head logits to ``ensemble.multihead.head_parallel_logits``."""
    from synthetic_audio_detection_tpu_torch.ensemble.multihead import MultiHeadEnsemble

    h0, h1 = head_slice(mesh, ensemble.num_heads)
    names = ensemble.synthetic_names + (["generic"] if ensemble.generic_head else [])
    backbones = list(ensemble.backbones)
    if len(backbones) > 1:
        backbones = backbones[h0:h1]
    return MultiHeadEnsemble(backbones, list(ensemble.heads)[h0:h1],
                             names[h0:h1] + [ensemble.real_name], ensemble.backbone_name,
                             dtype=ensemble.dtype, trunk=ensemble.trunk).to(mesh.device)


def pad_batch_to_multiple(batch_size: int, mesh: Mesh) -> int:
    """Round a global batch up so it divides evenly over the 'data' axis."""
    d = mesh.size(DATA_AXIS)
    return ((batch_size + d - 1) // d) * d


def rows_of(draws: Any, rows: Optional[Tuple[int, int]], n: int) -> Any:
    """The rows [start, start + n) of every tensor in ``draws`` (nested
    dicts of tensors whose leading axis is the global batch), ``rows`` =
    (start, global rows); ``draws`` itself when ``rows`` is None. A rank
    draws the global batch's random numbers, as one process would, and
    keeps its own rows."""
    if rows is None:
        return draws
    if isinstance(draws, dict):
        return {k: rows_of(v, rows, n) for k, v in draws.items()}
    return draws[rows[0]:rows[0] + n]
