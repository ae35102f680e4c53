"""Chunked flat buffers and norms over trees of tensors (port of
:mod:`apex_tpu.utils.tree`'s chunked half, the ``multi_tensor_apply`` /
``multi_tensor_l2norm`` analog).

A tree is the JAX package's pytree in torch: nested dicts (keys taken in
sorted order), lists, tuples and NamedTuples of tensors.
:func:`flatten_to_chunked` packs every leaf into one ``(rows, chunk)``
buffer, each leaf padded with zeros to whole rows so that no row spans
two leaves; per-tensor reductions are then one row reduction and one
segmented sum over the rows, and a per-tensor scalar goes back to the
rows as a ``(rows, 1)`` column.  Padding holds zeros, so every sum of
squares and every ``max|x|`` is exact.  The metadata is host-side
(shapes, dtypes, row offsets and ``leaf_ids``, one ``np.int32`` per row),
so layout planners (the ZeRO buckets, checkpoint re-sharding) can size
buffers with :func:`chunked_meta` alone.

The segmented reductions are deterministic: a row's partial is summed
into its leaf in row order, never by atomics.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, List, NamedTuple, Tuple

import numpy as np
import torch

__all__ = [
    "tree_flatten",
    "flatten_to_buffer",
    "unflatten_from_buffer",
    "chunked_meta",
    "flatten_to_chunked",
    "unflatten_from_chunked",
    "chunked_per_leaf_sumsq",
    "chunked_per_leaf_max_abs",
    "chunked_rows",
    "per_leaf_l2_norms",
    "tree_l2_norm",
    "tree_size",
]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def tree_flatten(tree) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    """``(leaves, unflatten)`` in the JAX order (dict keys sorted), and the
    function that rebuilds ``tree``'s structure from a list of new leaves
    in that order.  ``None`` is an empty subtree, as in JAX."""
    if tree is None:
        return [], lambda leaves: None
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [tree_flatten(v) for v in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    sizes = [len(leaves) for leaves, _ in parts]
    leaves = [x for p, _ in parts for x in p]

    def unflatten(new):
        out, at = [], 0
        for (_, fn), n in zip(parts, sizes):
            out.append(fn(list(new[at:at + n])))
            at += n
        if keys is not None:
            return type(tree)(zip(keys, out))
        if _is_namedtuple(tree):
            return type(tree)(*out)
        return type(tree)(out)

    return leaves, unflatten


class _FlatMeta(NamedTuple):
    treedef: Any                   # unflatten(list of leaves) -> tree
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    offsets: Tuple[int, ...]       # element offsets into the flat buffer
    total: int
    pad_to: int


def flatten_to_buffer(tree, dtype=None,
                      pad_to: int = 1) -> Tuple[torch.Tensor, _FlatMeta]:
    """Every leaf raveled into one 1-D buffer, its length rounded up to a
    multiple of ``pad_to`` with zeros (``apex_C.flatten``).  A tree of
    mixed dtypes needs an explicit ``dtype``: an implicit cast would lose
    precision on the way back."""
    leaves, treedef = tree_flatten(tree)
    leaves = [torch.as_tensor(x) for x in leaves]
    dtypes = tuple(x.dtype for x in leaves)
    if dtype is None and len(set(dtypes)) > 1:
        raise ValueError(
            "flatten_to_buffer on a mixed-dtype tree requires an explicit "
            f"dtype= (got leaf dtypes {sorted({str(d) for d in dtypes})})")
    sizes = [x.numel() for x in leaves]
    offsets = tuple(int(x) for x in np.cumsum([0] + sizes[:-1]))
    total = int(sum(sizes))
    padded = -(-total // pad_to) * pad_to if total else pad_to
    out_dtype = dtype or (dtypes[0] if dtypes else torch.float32)
    if leaves:
        flat = torch.cat([x.reshape(-1).to(out_dtype) for x in leaves])
        flat = torch.nn.functional.pad(flat, (0, padded - total))
    else:
        flat = torch.zeros((padded,), dtype=out_dtype)
    return flat, _FlatMeta(treedef=treedef,
                           shapes=tuple(tuple(x.shape) for x in leaves),
                           dtypes=dtypes, offsets=offsets, total=total,
                           pad_to=padded)


def unflatten_from_buffer(buf: torch.Tensor, meta: _FlatMeta):
    """The inverse of :func:`flatten_to_buffer` (``apex_C.unflatten``):
    the leaves in their shapes and dtypes."""
    leaves = []
    for shape, dt, off in zip(meta.shapes, meta.dtypes, meta.offsets):
        size = int(np.prod(shape))
        leaves.append(buf[off:off + size].reshape(shape).to(dt))
    return meta.treedef(leaves)


class _ChunkMeta(NamedTuple):
    treedef: Any                   # unflatten(list of leaves) -> tree
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    row_offsets: Tuple[int, ...]   # first (rows, chunk)-row of each leaf
    n_rows: int
    chunk: int
    leaf_ids: Any                  # np.int32 (n_rows,): row -> leaf index


def chunked_meta(treedef, shapes, dtypes, chunk: int = 256,
                 pad_rows_to: int = 1) -> _ChunkMeta:
    """The metadata half of :func:`flatten_to_chunked`, from shapes and
    dtypes alone.  ``pad_rows_to`` rounds the row count up to a multiple;
    pad rows hold zeros and carry the last leaf's id."""
    sizes = [int(np.prod(s)) for s in shapes]
    rows_per_leaf = [(s + chunk - 1) // chunk for s in sizes]
    row_offsets = tuple(int(x) for x in np.cumsum([0] + rows_per_leaf[:-1]))
    n_rows = int(sum(rows_per_leaf))
    pad_rows = 0
    if pad_rows_to > 1 and shapes:
        pad_rows = -(-max(n_rows, 1) // pad_rows_to) * pad_rows_to - n_rows
    leaf_ids = np.repeat(np.arange(len(shapes), dtype=np.int32),
                         rows_per_leaf)
    if pad_rows:
        leaf_ids = np.concatenate(
            [leaf_ids, np.full(pad_rows, max(len(shapes) - 1, 0), np.int32)])
    return _ChunkMeta(treedef=treedef, shapes=tuple(tuple(s) for s in shapes),
                      dtypes=tuple(dtypes), row_offsets=row_offsets,
                      n_rows=n_rows + pad_rows, chunk=chunk,
                      leaf_ids=leaf_ids)


def flatten_to_chunked(tree, chunk: int = 256, dtype=torch.float32,
                       pad_rows_to: int = 1) -> Tuple[torch.Tensor,
                                                      _ChunkMeta]:
    """Every leaf of ``tree`` cast to ``dtype`` and packed into one
    ``(rows, chunk)`` buffer, each leaf zero-padded to whole rows, with
    the :func:`chunked_meta` that undoes it."""
    leaves, treedef = tree_flatten(tree)
    leaves = [torch.as_tensor(x) for x in leaves]
    meta = chunked_meta(treedef, [tuple(x.shape) for x in leaves],
                        [x.dtype for x in leaves], chunk=chunk,
                        pad_rows_to=pad_rows_to)
    if not leaves:
        return torch.zeros((0, chunk), dtype=dtype), meta
    # one zeroed buffer and one multi-tensor copy into each leaf's rows: a
    # handful of launches whatever the number of leaves
    buf = torch.zeros(meta.n_rows * chunk, dtype=dtype,
                      device=leaves[0].device)
    rows = [buf[off * chunk:off * chunk + x.numel()]
            for off, x in zip(meta.row_offsets, leaves)]
    torch._foreach_copy_(rows, [x.reshape(-1) for x in leaves])
    return buf.view(meta.n_rows, chunk), meta


def unflatten_from_chunked(buf: torch.Tensor, meta: _ChunkMeta):
    """The inverse of :func:`flatten_to_chunked`: each leaf's rows sliced
    back out, its padding dropped, its shape and dtype restored."""
    flat = buf.reshape(-1)
    leaves = []
    for shape, dt, row_off in zip(meta.shapes, meta.dtypes,
                                  meta.row_offsets):
        size = int(np.prod(shape))
        start = row_off * meta.chunk
        leaves.append(flat[start:start + size].reshape(shape).to(dt))
    return meta.treedef(leaves)


@functools.lru_cache(maxsize=16)
def _lengths_on(rows_per_leaf: Tuple[int, ...], device: torch.device
                ) -> torch.Tensor:
    """Each leaf's row count as a tensor on ``device``: made once per
    layout and device, so a step on the card copies nothing from the host
    (a copy from pageable memory would wait for the card).  Read only."""
    return torch.tensor(rows_per_leaf, dtype=torch.int64, device=device)


def _lengths(meta: _ChunkMeta, device) -> torch.Tensor:
    rows = np.bincount(meta.leaf_ids, minlength=len(meta.shapes))
    return _lengths_on(tuple(rows.tolist()), torch.device(device))


def _segment(row_values: torch.Tensor, meta: _ChunkMeta,
             reduce: str) -> torch.Tensor:
    return torch.segment_reduce(row_values, reduce,
                                lengths=_lengths(meta, row_values.device),
                                unsafe=True, initial=0.0)


def chunked_per_leaf_sumsq(buf: torch.Tensor,
                           meta: _ChunkMeta) -> torch.Tensor:
    """Each leaf's sum of squares, fp32 ``(n_leaves,)``: the rows' sums of
    squares, then their segmented sum by leaf (padding adds 0)."""
    row_sq = buf.float().square().sum(dim=1)
    return _segment(row_sq, meta, "sum")


def chunked_per_leaf_max_abs(buf: torch.Tensor,
                             meta: _ChunkMeta) -> torch.Tensor:
    """Each leaf's ``max|x|``, fp32 ``(n_leaves,)`` (0 for a zero-size
    leaf)."""
    row_max = buf.float().abs().amax(dim=1) if buf.shape[0] else \
        buf.new_zeros((0,), dtype=torch.float32)
    return _segment(row_max, meta, "max")


def chunked_rows(per_leaf: torch.Tensor, meta: _ChunkMeta) -> torch.Tensor:
    """A per-leaf vector broadcast to the buffer's rows as a ``(rows, 1)``
    column (``per_leaf[leaf_ids][:, None]``)."""
    return torch.repeat_interleave(
        per_leaf, _lengths(meta, per_leaf.device),
        output_size=meta.n_rows)[:, None]


def per_leaf_l2_norms(tree) -> List[torch.Tensor]:
    """Each leaf's L2 norm in fp32 (0-d tensors), in the JAX order."""
    leaves, _ = tree_flatten(tree)
    return [torch.linalg.vector_norm(torch.as_tensor(x).float())
            for x in leaves]


def tree_l2_norm(tree) -> torch.Tensor:
    """The global L2 norm of a tree in fp32 (0-d, detached): the square
    root of the sum of the leaves' sums of squares, in the JAX order (0
    for a tree without leaves)."""
    leaves, _ = tree_flatten(tree)
    if not leaves:
        return torch.tensor(0.0)
    sq = [torch.as_tensor(x).detach().float().square().sum()
          for x in leaves]
    return torch.sqrt(torch.stack(sq).sum())


def tree_size(tree) -> int:
    """The number of elements of all leaves (host-side)."""
    leaves, _ = tree_flatten(tree)
    return int(sum(int(np.prod(tuple(torch.as_tensor(x).shape)))
                   for x in leaves))
