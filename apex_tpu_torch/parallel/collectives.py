"""Collectives over the named axes of the rank grid (port of
:mod:`apex_tpu.parallel.collectives`).

Each function runs one ``torch.distributed`` collective over the process
group that ``axis`` names (``"tp"``, ``"dp"``, or a tuple such as
``("dcn", "dp")``; see :func:`apex_tpu_torch.parallel.mesh.get_group`),
with the reference's semantics: ``all_gather`` concatenates (``tiled``)
or stacks the shards in group-rank order, ``reduce_scatter`` keeps this
rank's slice of the sum, ``broadcast`` takes the group rank ``root``'s
value, ``ppermute`` moves values along ``(source, destination)`` pairs
of group ranks and leaves zeros where nothing arrives.  Every function
but ``all_reduce_`` returns a new tensor and leaves its input as it was;
none is differentiable (autograd sees a constant): the differentiable pairs
are :mod:`apex_tpu_torch.transformer.tensor_parallel.mappings`.

The reference's functions run inside ``shard_map``, where each device
holds its shard.  Here each rank simply holds its own shard, so the
reference's JAX-sharding helpers have no counterpart: ``shard_over``
(entering the per-shard world), ``named_sharding`` (placing a global
array), and ``hierarchical_reduce_scatter``/``hierarchical_all_gather``
(the two-tier ICI/DCN schedule of a sharded reduction); a rank reduces
over ``("dcn", "dp")`` with :func:`reduce_scatter` and
:func:`all_reduce` itself.

``CALLS`` counts, per kind, the collectives issued since the counts were
last set to 0 (:func:`zero_counts`): each function adds one where it
issues its call, including on a group of one rank, where the call
returns its input unchanged.  A ``ppermute`` whose pairs move nothing
off this rank (a group of one) copies locally and counts as well.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from apex_tpu_torch.parallel import mesh as mesh_lib
from apex_tpu_torch.parallel.mesh import AxisName

__all__ = [
    "CALLS",
    "zero_counts",
    "all_reduce",
    "all_reduce_",
    "all_gather",
    "reduce_scatter",
    "ppermute",
    "ppermute_many",
    "ppermute_start",
    "ring_chunks",
    "all_to_all",
    "broadcast",
    "axis_index",
    "axis_size",
    "bound_axis_size",
    "send_recv_next",
    "send_recv_prev",
]

CALLS = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0,
         "broadcast": 0, "ppermute": 0, "all_to_all": 0}

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def zero_counts() -> None:
    for kind in CALLS:
        CALLS[kind] = 0


def axis_index(axis: AxisName) -> int:
    """This rank's index along ``axis`` (row-major over a tuple)."""
    return mesh_lib.group_ranks(axis).index(dist.get_rank())


def axis_size(axis: AxisName) -> int:
    """The number of ranks along ``axis``."""
    return len(mesh_lib.group_ranks(axis))


def bound_axis_size(axis: Optional[AxisName]) -> int:
    """``axis``'s size when the grid is initialised, else 1; 1 for
    ``axis=None``.  Lets an axis-parameterised module run as its
    single-rank form when no grid is set up."""
    if axis is None or not mesh_lib.model_parallel_is_initialized():
        return 1
    return axis_size(axis)


def _group(axis):
    return mesh_lib.get_group(axis)


def all_reduce(x: torch.Tensor, axis: AxisName, op: str = "sum"):
    """All-reduce over ``axis``: ``"sum"``, ``"mean"`` (the sum divided by
    the axis size), ``"max"`` or ``"min"``."""
    return all_reduce_(x.detach().clone(), axis, op)


def all_reduce_(x: torch.Tensor, axis: AxisName, op: str = "sum"):
    """:func:`all_reduce` in place into ``x`` (a contiguous buffer the
    caller owns, not a tensor autograd tracks); returns ``x``."""
    if op not in ("sum", "mean", "max", "min"):
        raise ValueError(f"unsupported all_reduce op: {op!r}")
    dist.all_reduce(x, op=_OPS["sum" if op == "mean" else op],
                    group=_group(axis))
    CALLS["all_reduce"] += 1
    if op == "mean":
        x.div_(axis_size(axis))
    return x


def all_gather(x: torch.Tensor, axis: AxisName, *, concat_axis: int = 0,
               tiled: bool = True):
    """Every rank's ``x`` in group-rank order, concatenated along
    ``concat_axis`` (``tiled``) or stacked on a new axis there."""
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(axis_size(axis))]
    dist.all_gather(parts, x, group=_group(axis))
    CALLS["all_gather"] += 1
    return (torch.cat if tiled else torch.stack)(parts, dim=concat_axis)


def _chunks(x: torch.Tensor, n: int, dim: int):
    dim = dim % x.dim()
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of size {x.shape[dim]} not "
                         f"divisible by parallel size {n}")
    return [c.contiguous() for c in x.chunk(n, dim=dim)]


def reduce_scatter(x: torch.Tensor, axis: AxisName, *,
                   scatter_axis: int = 0):
    """Sum over ``axis`` and keep this rank's slice of ``scatter_axis``."""
    inputs = _chunks(x.detach(), axis_size(axis), scatter_axis)
    out = torch.empty_like(inputs[0])
    dist.reduce_scatter(out, inputs, group=_group(axis))
    CALLS["reduce_scatter"] += 1
    return out


def broadcast(x: torch.Tensor, axis: AxisName, root: int = 0):
    """Group rank ``root``'s ``x`` on every rank of ``axis``."""
    out = x.detach().clone().contiguous()
    dist.broadcast(out, src=mesh_lib.group_ranks(axis)[root],
                   group=_group(axis))
    CALLS["broadcast"] += 1
    return out


def ppermute(x: torch.Tensor, axis: AxisName,
             perm: Sequence[Tuple[int, int]]):
    """Send ``x`` along each ``(source, destination)`` pair of group
    ranks; a rank no pair sends to gets zeros.  ``perm`` must be a partial
    permutation (each rank at most once as a source and once as a
    destination); every rank of the group passes the same ``perm``."""
    return ppermute_many([x], axis, perm)[0]


def ppermute_many(xs: Sequence[torch.Tensor], axis: AxisName,
                  perm: Sequence[Tuple[int, int]]):
    """:func:`ppermute` of several tensors in one ``batch_isend_irecv``
    (one call counted): each tensor travels the same pairs, tagged by its
    place in ``xs``."""
    outs, wait = ppermute_start(xs, axis, perm)
    wait()
    return outs


def ppermute_start(xs: Sequence[torch.Tensor], axis: AxisName,
                   perm: Sequence[Tuple[int, int]]):
    """:func:`ppermute_many` issued without waiting: ``(outs, wait)``;
    ``outs`` hold what arrives only after ``wait()``, and ``xs`` must not
    change before it (work that does not read ``outs`` runs meanwhile)."""
    ranks = mesh_lib.group_ranks(axis)
    me = ranks.index(dist.get_rank())
    xs = [x.detach().contiguous() for x in xs]
    outs = [torch.zeros_like(x) for x in xs]
    sends = [d for s, d in perm if s == me]
    recvs = [s for s, d in perm if d == me]
    if len(sends) > 1 or len(recvs) > 1:
        raise ValueError(f"perm {perm} is not a partial permutation")
    ops = []
    if sends and sends[0] == me and recvs == [me]:
        for out, x in zip(outs, xs):
            out.copy_(x)
    else:
        for tag, (x, out) in enumerate(zip(xs, outs)):
            ops += [dist.P2POp(dist.isend, x, ranks[d], tag=tag)
                    for d in sends]
            ops += [dist.P2POp(dist.irecv, out, ranks[s], tag=tag)
                    for s in recvs]
    reqs = dist.batch_isend_irecv(ops) if ops else []
    CALLS["ppermute"] += 1

    def wait():
        for req in reqs:
            req.wait()

    return outs, wait


def ring_chunks(x: torch.Tensor, axis, dim: int = 0):
    """``x`` with ``dim`` split into the axis's per-rank chunks, the chunk
    index leading: ``[..., n*c, ...] -> [n, ..., c, ...]``; ``axis`` is
    an axis name or an explicit chunk count."""
    n = axis if isinstance(axis, int) else axis_size(axis)
    dim = dim % x.dim()
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of size {x.shape[dim]} not "
                         f"divisible into {n} ring chunks")
    split = x.reshape(x.shape[:dim] + (n, x.shape[dim] // n)
                      + x.shape[dim + 1:])
    return split.movedim(dim, 0)


def send_recv_next(x: torch.Tensor, axis: AxisName):
    """Send to rank + 1 and receive from rank - 1 along ``axis`` (a ring:
    the last rank sends to the first)."""
    n = axis_size(axis)
    return ppermute(x, axis, [(i, (i + 1) % n) for i in range(n)])


def send_recv_prev(x: torch.Tensor, axis: AxisName):
    """Send to rank - 1 and receive from rank + 1 along ``axis``."""
    n = axis_size(axis)
    return ppermute(x, axis, [(i, (i - 1) % n) for i in range(n)])


def all_to_all(x: torch.Tensor, axis: AxisName, *, split_axis: int,
               concat_axis: int):
    """Split ``split_axis`` into one chunk per rank, send chunk ``i`` to
    rank ``i``, and concatenate what arrives along ``concat_axis``."""
    n = axis_size(axis)
    inputs = _chunks(x.detach(), n, split_axis)
    outputs = [torch.empty_like(c) for c in inputs]
    dist.all_to_all(outputs, inputs, group=_group(axis))
    CALLS["all_to_all"] += 1
    return torch.cat(outputs, dim=concat_axis)
