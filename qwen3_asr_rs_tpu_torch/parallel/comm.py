"""The collectives of Megatron tensor parallelism, inserted by hand.

The JAX package annotates shardings and lets GSPMD insert the
collectives; PyTorch has no such partitioner, and DTensor does not
compose with the port's ctypes kernels. So the decoder and the encoder
call these operators themselves, over the mesh's 'tp' group, each a
``torch.autograd.Function`` with its Megatron conjugate as the backward:

  * ``copy_to_tp``: identity forward, all-reduce backward (before a
    column-parallel product: each rank's input gradient is a partial sum);
  * ``reduce_from_tp``: all-reduce forward, identity backward (after a
    row-parallel product);
  * ``gather_from_tp``: all-gather on the last dim forward, the rank's
    slice backward (the vocab-parallel lm_head's logits);
  * ``vocab_parallel_embed``: each rank looks up the ids inside its
    vocabulary rows, zeroes the others, and the pieces are all-reduced.

With no tensor parallelism (``tp`` None, or a group of one) each is the
identity and issues nothing. Every collective issued adds one to
``COUNTS[kind]`` (a per-process counter: tests and the card's smoke pin
the number per decode step). Outside autograd (inference) the
all-reduce runs in place on the fresh product it is given.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import mesh_dims

# collectives this process issued, by kind ("all_reduce", "all_gather",
# "broadcast", "barrier")
COUNTS: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its process group, its size
    and the rank's index along it."""

    group: object
    size: int
    rank: int


def mesh_axis(mesh, name: str) -> Optional[Axis]:
    """This rank's view of mesh axis ``name`` ('dp' or 'tp'), or None
    without a mesh or when the axis has size 1 (no collective needed)."""
    dims = dict(zip(("dp", "tp"), mesh_dims(mesh)))
    if dims[name] == 1:
        return None
    return Axis(group=mesh.get_group(name), size=dims[name],
                rank=mesh.get_local_rank(name))


def all_reduce(t: torch.Tensor, axis: Axis,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``t`` over the axis's ranks (a sum unless ``op`` says
    otherwise), in place; returns ``t``."""
    COUNTS["all_reduce"] += 1
    dist.all_reduce(t, op=op, group=axis.group)
    return t


def all_gather(t: torch.Tensor, axis: Axis) -> list:
    """Every rank's ``t`` (one shape on all ranks), in rank order."""
    COUNTS["all_gather"] += 1
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(parts, t.contiguous(), group=axis.group)
    return parts


def is_lead(mesh) -> bool:
    """Whether this rank is the mesh's first, (0, 0) (True without a
    mesh): the rank that owns a server's queue and its decisions."""
    return mesh is None or all(mesh.get_local_rank(n) == 0
                               for n in ("dp", "tp"))


def barrier(mesh) -> None:
    """Return once every rank of the mesh has reached this call: a
    barrier over tp, then over dp (a rank leaves the second only after
    every rank of its dp group has left the first, and the lead's tp
    group left that only once the lead had reached it)."""
    for name in ("tp", "dp"):
        axis = mesh_axis(mesh, name)
        if axis is not None:
            COUNTS["barrier"] += 1
            dist.barrier(group=axis.group)


def broadcast_from_lead(objs: list, mesh) -> list:
    """Python objects ``objs`` (a list, replaced in place) from the mesh's
    first rank to every rank of the mesh: over the dp axis among the
    ranks at tp index 0, then over every tp axis. Returns ``objs``."""
    for name in ("dp", "tp"):
        axis = mesh_axis(mesh, name)
        if axis is None or (name == "dp" and mesh.get_local_rank("tp")):
            continue
        COUNTS["broadcast"] += 1
        dist.broadcast_object_list(
            objs, src=dist.get_global_rank(axis.group, 0), group=axis.group)
    return objs


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.axis), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return torch.cat(all_gather(x, axis), -1)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.axis.size, -1)[ctx.axis.rank].contiguous(), None


def _autograd(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to_tp(x, tp: Optional[Axis]):
    """The input of a column-parallel product (see the module docstring)."""
    if tp is None or not _autograd(x):
        return x
    return _CopyToTP.apply(x, tp)


def reduce_from_tp(x, tp: Optional[Axis]):
    """The sum of a row-parallel product's partial outputs."""
    if tp is None:
        return x
    if not _autograd(x):
        return all_reduce(x, tp)
    return _ReduceFromTP.apply(x, tp)


def gather_from_tp(x, tp: Optional[Axis]):
    """The column shards of ``x`` (..., N / tp) joined into (..., N)."""
    if tp is None:
        return x
    if not _autograd(x):
        return torch.cat(all_gather(x, tp), -1)
    return _GatherFromTP.apply(x, tp)


def vocab_parallel_embed(weight, ids, tp: Optional[Axis]):
    """``weight[ids]`` for an embedding table whose rows are sharded over
    tp (rank r holds rows [r V / tp, (r + 1) V / tp)): each rank's lookup
    of the ids it holds, zero elsewhere, all-reduced. Exact: every output
    element is one row value plus zeros."""
    if tp is None:
        return weight[ids]
    rows = weight.shape[0]
    local = ids - tp.rank * rows
    mine = (local >= 0) & (local < rows)
    out = weight[torch.where(mine, local, 0)]
    out = torch.where(mine[..., None], out, 0)
    return reduce_from_tp(out, tp)
