"""Flat-bucket ZeRO machinery (port of
:mod:`apex_tpu.contrib.optimizers._flat_bucket`, the shape of apex's
``StateBucket``).

The parameters are packed into one chunked ``(rows, chunk)`` buffer per
**dtype-group** (the leaves that share a model dtype, so parameters
travel the all-gather in their own dtype), each leaf zero-padded to
whole rows and the rows padded to a multiple of ``world * n_buckets``
(:func:`apex_tpu_torch.utils.tree.flatten_to_chunked`).  Each buffer is
split into ``n_buckets`` equal row ranges, the buckets: every bucket is
one reduce-scatter of the gradients on the way in and one all-gather of
the parameters on the way out.  A rank holds rows
``[k * rows_per_bucket + r * local_rows, ... + local_rows)`` of bucket
``k``, ``r`` its index over the scatter axes (:func:`flat_rank`), which
is the tile the reduce-scatter gives it.

The reduction is optionally hierarchical: a reduce-scatter over the
inner data axis, then the shard all-reduced over the ``dcn`` axis
(:func:`apex_tpu_torch.parallel.collectives.hierarchical_reduce_scatter`).
Per-tensor quantities (LAMB's trust ratios) come back from a shard by
segmented row sums: no row spans two leaves, so a shard-local sum per
leaf plus one all-reduce is exact.

The layout is host-side arithmetic on the parameters' shapes and dtypes;
the collectives run over the live rank grid
(:func:`apex_tpu_torch.parallel.initialize_model_parallel`), and each
bucket's exchange runs in a profiler range
``apex/zero/reduce_scatter/bucket{k}`` / ``apex/zero/all_gather/bucket{k}``.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from apex_tpu_torch.observability.spans import named_span
from apex_tpu_torch.parallel import collectives as cc
from apex_tpu_torch.utils.tree import (
    chunked_meta,
    flatten_to_chunked,
    tree_flatten,
    unflatten_from_chunked,
)

__all__ = [
    "AxisSpec",
    "AxisConfig",
    "GroupLayout",
    "BucketLayout",
    "resolve_axes",
    "flat_rank",
    "build_layout",
    "host_groups",
    "flatten_group",
    "unflatten_groups",
    "bucket_slices",
    "local_slices",
    "local_leaf_ids",
    "bucket_reduce_scatter",
    "bucket_all_gather",
    "FlatBucketMixin",
    "init_flat_state",
    "flat_state_specs",
]

AxisSpec = Union[str, Sequence[str]]


class AxisConfig(NamedTuple):
    """The resolved reduction topology."""

    scatter_axes: Any          # axis name or tuple: where shards differ
    outer_axis: Optional[str]  # the dcn tier (hierarchical) or None
    world_scatter: int         # shard count, the scatter axes' product
    world_total: int           # replica count, the outer tier included


class GroupLayout(NamedTuple):
    """One dtype-group's packing."""

    dtype: torch.dtype         # model dtype (the all-gather's)
    indices: Tuple[int, ...]   # leaf positions in the flattened tree
    meta: Any                  # the group's chunked metadata
    rows: int                  # padded row count (a multiple of world * K)
    rows_per_bucket: int
    local_rows: int            # rows_per_bucket // world


class BucketLayout(NamedTuple):
    treedef: Any               # unflatten(list of leaves) -> tree
    n_leaves: int
    groups: Tuple[GroupLayout, ...]
    world: int
    n_buckets: int
    chunk: int


def _axes(axis: AxisSpec) -> Tuple[str, ...]:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def resolve_axes(axis: AxisSpec, outer_axis: Optional[str]) -> AxisConfig:
    """The (inner, outer) reduction axes on the live grid.  ``axis`` is
    one axis name or a tuple (one flat reduction group); ``outer_axis``
    enables the hierarchical split and is ignored when unbound or of size
    1, or when ``axis`` already names it (the explicit flat form).  A
    tuple ``axis`` cannot also have an outer tier."""
    axes = _axes(axis)
    if outer_axis is not None and len(axes) > 1 and outer_axis not in axes:
        raise ValueError(
            "outer_axis is only meaningful with a single inner axis "
            f"(got axis={axis!r}, outer_axis={outer_axis!r})")
    outer = (outer_axis
             if outer_axis is not None and outer_axis not in axes
             and cc.bound_axis_size(outer_axis) > 1 else None)
    world_scatter = 1
    for a in axes:
        world_scatter *= cc.axis_size(a)
    world_total = world_scatter * (
        cc.bound_axis_size(outer) if outer is not None else 1)
    return AxisConfig(scatter_axes=axes[0] if len(axes) == 1 else axes,
                      outer_axis=outer, world_scatter=world_scatter,
                      world_total=world_total)


def flat_rank(cfg: AxisConfig) -> int:
    """This rank's shard index: its index in the group over the scatter
    axes, which is the tile :func:`cc.reduce_scatter` over the same axes
    gives it (row-major over the grid's axis order), so slicing with no
    communication (:func:`local_slices`) and the reduce-scatter agree."""
    return cc.axis_index(cfg.scatter_axes)


def host_groups(params):
    """``(treedef, leaves, [(dtype, indices), ...])``: the leaves that
    share a dtype form one group, the groups in order of first
    appearance, so the layout depends on the tree alone."""
    leaves, treedef = tree_flatten(params)
    order: List[torch.dtype] = []
    by_dtype = {}
    for i, leaf in enumerate(leaves):
        dt = torch.as_tensor(leaf).dtype
        if dt not in by_dtype:
            by_dtype[dt] = []
            order.append(dt)
        by_dtype[dt].append(i)
    return treedef, leaves, [(dt, tuple(by_dtype[dt])) for dt in order]


def build_layout(params, *, world: int, n_buckets: int = 1,
                 chunk: int = 256) -> BucketLayout:
    """The bucket layout of ``params`` (host arithmetic).  Each
    dtype-group's rows are padded to a multiple of ``world * n_buckets``
    so that every bucket reduce-scatters evenly."""
    treedef, leaves, raw_groups = host_groups(params)
    groups = []
    for dt, idx in raw_groups:
        sub = [leaves[i] for i in idx]
        meta = chunked_meta(list, [tuple(x.shape) for x in sub],
                            [x.dtype for x in sub], chunk=chunk,
                            pad_rows_to=world * n_buckets)
        rpb = meta.n_rows // n_buckets
        groups.append(GroupLayout(dtype=dt, indices=idx, meta=meta,
                                  rows=meta.n_rows, rows_per_bucket=rpb,
                                  local_rows=rpb // world))
    return BucketLayout(treedef=treedef, n_leaves=len(leaves),
                        groups=tuple(groups), world=world,
                        n_buckets=n_buckets, chunk=chunk)


def flatten_group(layout: BucketLayout, group: GroupLayout, leaves,
                  dtype=torch.float32) -> torch.Tensor:
    """This group's leaves (of the full leaf list, in the layout's order)
    packed into one padded ``(rows, chunk)`` buffer of ``dtype``."""
    buf, meta = flatten_to_chunked(
        [leaves[i] for i in group.indices], chunk=layout.chunk, dtype=dtype,
        pad_rows_to=layout.world * layout.n_buckets)
    if meta.n_rows != group.rows:
        raise ValueError(f"group packs {meta.n_rows} rows, the layout "
                         f"{group.rows}")
    return buf


def unflatten_groups(layout: BucketLayout, group_bufs, like_leaves):
    """The inverse of :func:`flatten_group` over every group: each group's
    leaves back in tree order, the tree rebuilt (``like_leaves`` gives
    the leaves of no group)."""
    out = list(like_leaves)
    for group, buf in zip(layout.groups, group_bufs):
        for i, leaf in zip(group.indices,
                           unflatten_from_chunked(buf, group.meta)):
            out[i] = leaf
    return layout.treedef(out)


def group_leaf_views(layout: BucketLayout, group: GroupLayout,
                     buf: torch.Tensor) -> List[torch.Tensor]:
    """Each leaf of ``group`` as a view of its rows of the full buffer
    ``buf`` (in the buffer's dtype), padding dropped."""
    flat = buf.reshape(-1)
    out = []
    for shape, row in zip(group.meta.shapes, group.meta.row_offsets):
        n = int(np.prod(shape))
        start = row * layout.chunk
        out.append(flat[start:start + n].view(shape))
    return out


def bucket_slices(buf: torch.Tensor, group: GroupLayout,
                  n_buckets: int) -> List[torch.Tensor]:
    """A full group buffer's ``n_buckets`` row ranges (views)."""
    rpb = group.rows_per_bucket
    return [buf[k * rpb:(k + 1) * rpb] for k in range(n_buckets)]


def local_slices(buf: torch.Tensor, group: GroupLayout, n_buckets: int,
                 rank: int) -> List[torch.Tensor]:
    """This rank's rows of each bucket of a full group buffer (views),
    with no communication: the slicing dual of the reduce-scatter, which
    seeds the sharded state from the replicated parameters."""
    rpb, lr = group.rows_per_bucket, group.local_rows
    return [buf[k * rpb + rank * lr:k * rpb + (rank + 1) * lr]
            for k in range(n_buckets)]


def local_leaf_ids(group: GroupLayout, n_buckets: int,
                   rank: int) -> List[np.ndarray]:
    """The group-local leaf id of each of this rank's rows, per bucket
    (host ``np.int32``, non-decreasing within a bucket): the segments of
    the shard-local per-tensor reductions."""
    ids = np.asarray(group.meta.leaf_ids)
    rpb, lr = group.rows_per_bucket, group.local_rows
    return [ids[k * rpb + rank * lr:k * rpb + (rank + 1) * lr]
            for k in range(n_buckets)]


def bucket_reduce_scatter(buf: torch.Tensor, group: GroupLayout,
                          cfg: AxisConfig, n_buckets: int, *,
                          outer_reduce_dtype=None) -> List[torch.Tensor]:
    """One (hierarchical) reduce-scatter a bucket: the full group buffer
    in, this rank's summed rows of each bucket out."""
    out = []
    for k, b in enumerate(bucket_slices(buf, group, n_buckets)):
        with named_span(f"zero/reduce_scatter/bucket{k}"):
            out.append(cc.hierarchical_reduce_scatter(
                b, cfg.scatter_axes, cfg.outer_axis, scatter_axis=0,
                outer_reduce_dtype=outer_reduce_dtype))
    return out


def bucket_all_gather(local_bufs: Sequence[torch.Tensor],
                      group: GroupLayout, cfg: AxisConfig,
                      dtype=None) -> torch.Tensor:
    """One all-gather a bucket over the scatter axes (every rank of the
    outer tier holds the same shard), concatenated into the full group
    buffer; ``dtype`` casts before the gather, so half-precision
    parameters move half the bytes."""
    gathered = []
    for k, b in enumerate(local_bufs):
        with named_span(f"zero/all_gather/bucket{k}"):
            if dtype is not None:
                b = b.to(dtype)
            gathered.append(cc.hierarchical_all_gather(
                b, cfg.scatter_axes, concat_axis=0))
    return gathered[0] if len(gathered) == 1 else torch.cat(gathered)


class FlatBucketMixin:
    """What the flat-bucket ZeRO optimizers share: the reduction topology
    and the bucket layout from the constructor's ``axis``, ``outer_axis``,
    ``flat_bucket``, ``n_buckets`` and ``chunk``, and the state's
    ``PartitionSpec`` tree."""

    def _init_bucket_config(self, *, flat_bucket: bool, n_buckets: int,
                            chunk: int, outer_axis: Optional[str],
                            dcn_reduce_dtype) -> None:
        """Set the layout's knobs; the hierarchical ``outer_axis`` applies
        to the flat-bucket path only."""
        self.flat_bucket = flat_bucket
        self.n_buckets = n_buckets
        self.chunk = chunk
        self.outer_axis = outer_axis if flat_bucket else None
        self.dcn_reduce_dtype = dcn_reduce_dtype

    def _cfg(self) -> AxisConfig:
        return resolve_axes(self.axis, self.outer_axis)

    def _layout(self, params, world: int) -> BucketLayout:
        return build_layout(params, world=world, n_buckets=self.n_buckets,
                            chunk=self.chunk)

    def state_partition_specs(self, params):
        """The ``PartitionSpec`` tree of the state (:meth:`opt_state`):
        rows split over the scatter axes (replicated over a hierarchical
        outer tier, which the unnamed axis says)."""
        from apex_tpu_torch.optimizers._common import OptState
        from apex_tpu_torch.transformer.tensor_parallel.partition import (
            PartitionSpec as P,
        )

        if self.flat_bucket:
            return flat_state_specs(params, self.axis, self.n_buckets)
        leaves, treedef = tree_flatten(params)

        def chunks():
            return treedef([P(self.axis) for _ in leaves])

        return OptState(step=P(), slots={"exp_avg": chunks(),
                                         "exp_avg_sq": chunks()},
                        master=chunks())


def init_flat_state(params, cfg: AxisConfig, layout: BucketLayout, *,
                    remainder_split=None):
    """The sharded flat-bucket state: zero moments and this rank's rows
    of the fp32 parameters, sliced from the replicated parameters with
    no communication.  ``remainder_split`` (the optimizer's
    ``split_fp32``) keeps only the low 16 bits of the fp32 master."""
    from apex_tpu_torch.optimizers._common import OptState

    rank = flat_rank(cfg)
    leaves, _ = tree_flatten(params)
    device = leaves[0].device if leaves else None
    exp_avg, exp_avg_sq, master = [], [], []
    for group in layout.groups:
        def zeros():
            return [torch.zeros((group.local_rows, layout.chunk),
                                dtype=torch.float32, device=device)
                    for _ in range(layout.n_buckets)]
        exp_avg.append(zeros())
        exp_avg_sq.append(zeros())
        p32 = flatten_group(layout, group, [x.detach() for x in leaves])
        locs = local_slices(p32, group, layout.n_buckets, rank)
        if remainder_split is not None:
            master.append([remainder_split(b)[1] for b in locs])
        else:
            master.append([b.clone() for b in locs])
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    slots={"exp_avg": exp_avg, "exp_avg_sq": exp_avg_sq},
                    master=master)


def flat_state_specs(params, axis: AxisSpec, n_buckets: int):
    """The ``PartitionSpec`` tree of :func:`init_flat_state`'s state."""
    from apex_tpu_torch.optimizers._common import OptState
    from apex_tpu_torch.transformer.tensor_parallel.partition import (
        PartitionSpec as P,
    )

    spec = P(tuple(axis)) if isinstance(axis, (tuple, list)) else P(axis)
    _, _, groups = host_groups(params)

    def bufs():
        return [[spec for _ in range(n_buckets)] for _ in groups]

    return OptState(step=P(), slots={"exp_avg": bufs(), "exp_avg_sq": bufs()},
                    master=bufs())
