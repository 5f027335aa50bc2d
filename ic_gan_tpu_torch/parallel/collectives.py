"""The collectives of data parallelism, with autograd.

The JAX package shards a global batch and XLA inserts the psums; here each
rank holds its share and the train steps call these by hand.  Only two
primitives are needed, both over the ranks of a ``Mesh``:

- ``all_reduce``: a sum over ranks whose backward is again a sum over ranks
  (each rank backpropagates its own part of the global loss, and the
  cotangents of a value every rank read add up);
- ``all_gather``: the ranks' shares stacked in rank order, written as an
  ``all_reduce`` of a zero-padded buffer, so that it runs on every backend
  (gloo gathers no CUDA tensors) and its backward, this rank's slice of the
  summed cotangent, comes from ``all_reduce``'s.  Both differentiate twice,
  as R1 through the minibatch-std layer needs.

``data_parallel(mesh)`` scopes the mesh the layers read (``current``): batch
norm's moments, the minibatch-std groups, the w average, and every
per-sample random draw (``draw_rows``).  Outside it, or with no mesh, every
path is the single-process one and no collective runs.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ic_gan_tpu_torch.parallel.mesh import Mesh, shard_rows

_STATE = threading.local()


def current() -> Optional[Mesh]:
    """The mesh of the enclosing ``data_parallel`` block, else None."""
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def data_parallel(mesh: Optional[Mesh]):
    """Run the block with ``mesh`` as the layers' data mesh (None: none)."""
    prev = current()
    _STATE.mesh = mesh
    try:
        yield mesh
    finally:
        _STATE.mesh = prev


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return _AllReduce.apply(g.contiguous(), ctx.group), None


def all_reduce(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Σ over the mesh's ranks, differentiable; ``x`` itself is left as it
    is.  Without a process group (a one-rank mesh) it returns ``x``."""
    if not dist.is_initialized():
        return x
    return _AllReduce.apply(x.contiguous(), mesh.group)


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' ``x`` (equal shapes) concatenated along axis 0 in rank
    order, differentiable."""
    if not dist.is_initialized():
        return x
    n, rest = x.shape[0], x.shape[1:]
    before = x.new_zeros((mesh.rank * n,) + rest)
    after = x.new_zeros(((mesh.world - mesh.rank - 1) * n,) + rest)
    return all_reduce(torch.cat([before, x, after]), mesh)


def draw_rows(draw: Callable, n: int, parts: int = 1):
    """This rank's ``n`` rows of a per-sample random draw.  ``draw(k)``
    makes the draw for ``k`` samples (a tensor, or a list or tuple of them,
    with ``k`` leading rows; a draw made in advance for the global batch is
    ``lambda k: draws``); inside ``data_parallel`` every rank makes it for
    the global batch from its identically seeded generator and keeps its
    own rows, so that n ranks draw what one rank draws for the whole batch.
    Outside, it is ``draw(n)``.  ``parts``: the ``n`` rows stack that many
    batches, and the rank keeps its rows of each (``mesh.shard_rows``)."""
    mesh = current()
    if mesh is None:
        return draw(n)
    return torch.utils._pytree.tree_map(lambda t: shard_rows(t, mesh, parts=parts),
                                        draw(n * mesh.world))


@torch.no_grad()
def all_reduce_grads(params, mesh: Mesh) -> None:
    """Sum every parameter's ``.grad`` over the ranks, in one flat buffer
    per dtype (the JAX step's psum of the gradients)."""
    grads = [p.grad for p in params if p.grad is not None]
    by_dtype = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for group in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in group])
        flat = all_reduce(flat, mesh)
        for g, part in zip(group, flat.split([g.numel() for g in group])):
            g.copy_(part.view_as(g))
