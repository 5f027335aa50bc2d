"""Process group and data mesh: port of ``ic_gan_tpu/parallel/mesh.py`` on
``torch.distributed``.

The JAX package runs one process per host and shards a global batch over a
1-D ``data`` mesh of devices; XLA inserts the collectives.  Here each rank is
one process with one device, ``Mesh`` names the ranks that hold a share of
the batch, and the collectives are written out (``parallel.collectives``).
With no process group up, every helper answers for a single process and no
collective runs.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from ic_gan_tpu_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data-parallel ranks: ``group`` (None: the default group, or no
    group at all in a single process), ``world`` ranks holding a share,
    this process's ``rank`` among them (-1 when it holds none), and the
    device its share lives on."""

    group: Any
    world: int
    rank: int
    device: torch.device

    @property
    def holds_share(self) -> bool:
        return self.rank >= 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_device(device=None) -> torch.device:
    """``device`` (default CUDA) resolved for this rank: a CUDA device
    without an index becomes ``cuda:LOCAL_RANK`` (torchrun's variable), or
    ``cuda:0`` without it."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


def distributed_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    device=None,
    timeout_s: float = 600.0,
) -> bool:
    """Join the process group: the counterpart of the JAX CLI's
    ``jax.distributed.initialize`` (reference ``dist.init_process_group(
    "nccl", tcp://master:40000)``, ``BigGAN_PyTorch/trainer.py:84-101``).

    Arguments left out come from torchrun's environment:
    ``MASTER_ADDR``:``MASTER_PORT`` for ``coordinator_address`` ("host:port"),
    ``WORLD_SIZE`` and ``RANK``.  ``init_method`` (e.g. ``file://...``)
    replaces the TCP rendezvous.  The backend is NCCL for a CUDA ``device``
    (default CUDA, ``local_device``) and gloo for the CPU unless named.
    Returns True when more than one process runs.  A second call is a no-op.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if num_processes is None:
        num_processes = int(env["WORLD_SIZE"]) if "WORLD_SIZE" in env else None
    if process_id is None:
        process_id = int(env["RANK"]) if "RANK" in env else None
    if num_processes is None or process_id is None:
        raise ValueError("distributed_init needs num_processes and process_id "
                         "(or torchrun's WORLD_SIZE and RANK)")
    if init_method is None:
        if coordinator_address is None:
            if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
                raise ValueError("distributed_init needs coordinator_address "
                                 "(or torchrun's MASTER_ADDR and MASTER_PORT)")
            coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        init_method = f"tcp://{coordinator_address}"
    device = local_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=int(num_processes),
                            rank=int(process_id),
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_world_size() > 1


def is_main_process() -> bool:
    """True on the rank that writes checkpoints and logs (the reference's
    ``rank == 0`` guards, ``trainer.py:520-541``)."""
    return process_index() == 0


def local_batch_size(global_batch: int) -> int:
    """This rank's share of a global batch."""
    n = process_count()
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    return global_batch // n


def data_ranks(world: int, n_data: Optional[int] = None,
               batch_size: Optional[int] = None) -> int:
    """How many of ``world`` ranks hold a share: ``n_data``, or all of them
    clamped to the largest count that divides ``batch_size`` (a microbatch
    smaller than the world cannot split further; the other ranks stay
    idle, as the JAX mesh's spare devices do)."""
    if n_data is None:
        n_data = world
        if batch_size is not None:
            while n_data > 1 and batch_size % n_data != 0:
                n_data -= 1
    if not 1 <= n_data <= world:
        raise ValueError(f"n_data {n_data} needs 1 to {world} ranks")
    return n_data


def make_mesh(n_data: Optional[int] = None, batch_size: Optional[int] = None,
              device=None) -> Mesh:
    """The data mesh over the process group's first ``data_ranks(...)``
    ranks, on this rank's ``device`` (``local_device``).  Every rank calls
    it with the same arguments: a clamped mesh makes a sub-group."""
    device = local_device(device)
    world = process_count()
    n = data_ranks(world, n_data, batch_size)
    group = None
    if dist.is_initialized() and n < world:
        group = dist.new_group(list(range(n)))
    rank = process_index()
    return Mesh(group=group, world=n, rank=rank if rank < n else -1, device=device)


def shard_rows(t, mesh: Optional[Mesh], axis: int = 0, parts: int = 1):
    """This rank's share of ``t`` along ``axis`` (empty on a rank that
    holds none; ``t`` itself without a mesh).  ``t`` stacks ``parts``
    global batches along ``axis``; the share is this rank's rows of each,
    stacked in the same order."""
    if mesh is None:
        return t
    n = t.shape[axis]
    if n % (mesh.world * parts):
        raise ValueError(f"{n} rows along axis {axis} do not divide into {parts} "
                         f"part(s) over {mesh.world} ranks")
    k = n // (mesh.world * parts)
    pieces = []
    for p in range(parts):
        lo = (p * mesh.world + max(mesh.rank, 0)) * k
        hi = lo + (k if mesh.holds_share else 0)
        pieces.append(t[(slice(None),) * axis + (slice(lo, hi),)])
    return pieces[0] if parts == 1 else torch.cat(pieces, axis)


def shard_batch(mesh: Mesh, batch, axis: int = 0):
    """A pytree of global host arrays or tensors → this rank's rows along
    ``axis`` (1 for microbatch slabs) as tensors on ``mesh.device``."""
    def put(a):
        a = torch.as_tensor(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
        return shard_rows(a, mesh, axis).to(mesh.device)

    return torch.utils._pytree.tree_map(put, batch)


def broadcast_one_to_all(values, device=None) -> np.ndarray:
    """Rank 0's float64 ``values`` on every rank of the process group
    (``multihost_utils.broadcast_one_to_all`` in the JAX package), sent
    through ``device`` (``local_device``: NCCL sends only CUDA tensors).
    Without a process group, the values themselves."""
    values = np.asarray(values, np.float64)
    if not dist.is_initialized():
        return values
    t = torch.as_tensor(values, device=local_device(device))
    dist.broadcast(t, src=0)
    return t.cpu().numpy()


@torch.no_grad()
def replicated(mesh: Mesh, *objs) -> None:
    """Broadcast from the mesh's first rank, in place: tensors, and every
    parameter and buffer of a module.  A no-op without a process group."""
    if not dist.is_initialized() or not mesh.holds_share:
        return
    src = dist.get_global_rank(mesh.group, 0) if mesh.group is not None else 0
    for obj in objs:
        tensors = ([obj] if torch.is_tensor(obj)
                   else list(obj.parameters()) + list(obj.buffers()))
        for t in tensors:
            dist.broadcast(t.data, src=src, group=mesh.group)
