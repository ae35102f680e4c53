"""Which dimension tensor parallelism splits, per parameter, and the
weight bridge that hands each rank its shard (port of
:mod:`apex_tpu.transformer.tensor_parallel.partition`).

:func:`infer_param_specs` gives, for every leaf of a parameter tree
(nested dicts, or a ``GPT3DParams``), a :class:`PartitionSpec`: the
reference's rules (``DEFAULT_RULES``: path patterns over the ``"/"``-
joined keys, first match wins, no match replicated), in a plain tuple of
axis names or ``None`` per dimension, where the reference has JAX's
``PartitionSpec``.

:func:`shard_params` takes a global tree and gives tensor-parallel rank
``tp_rank`` the shard the same coordinates hold in the reference: each
leaf cut into ``tp_size`` equal chunks along its split dimension.  A spec
names a leaf's *trailing* dimensions, so one per-layer spec also serves a
layer stack ``[L, ...]`` whose leading dimension it does not name.
:func:`gather_params` is the inverse, from every rank's shard.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch.parallel.mesh import TENSOR_AXIS

__all__ = ["DEFAULT_RULES", "PartitionSpec", "infer_param_specs",
           "shard_params", "gather_params"]

# (path regex, spec template): "tp" marks the tensor-parallel dim, "ep"
# the expert-parallel one; first match wins, no match = replicated
DEFAULT_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    # vocab-parallel embedding table: [vocab/tp, h]
    (r"word_embeddings/embedding$", ("tp", None)),
    # column-parallel linears: kernel [out/tp, in], bias [out/tp]
    (r"(query_key_value|query|key_value|dense_h_to_4h(_gate)?)/kernel$",
     ("tp", None)),
    (r"(query_key_value|query|key_value|dense_h_to_4h(_gate)?)/bias$",
     ("tp",)),
    # row-parallel linears: kernel [out, in/tp], bias replicated; the
    # attention projection is matched by its parent's name, since a bare
    # "dense" is also the replicated pooler's
    (r"(self_attention/dense|inter_attention/dense|dense_4h_to_h)/kernel$",
     (None, "tp")),
    # BERT's LM head bias is vocab-sharded like the embedding
    (r"lm_head/bias$", ("tp",)),
    # Switch-MoE expert stacks: dim 0 = local experts, over the
    # expert-parallel axis; the router is replicated
    (r"mlp/w1$", ("ep", None, None)),
    (r"mlp/b1$", ("ep", None)),
    (r"mlp/w2$", ("ep", None, None)),
    (r"mlp/b2$", ("ep", None)),
)


class PartitionSpec(tuple):
    """One axis name (or ``None``) per dimension: ``PartitionSpec("tp",
    None)``; ``PartitionSpec()`` is replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, Mapping):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    return fn(path, tree)


def _map2(fn, tree, other):
    """``fn(leaf, other_leaf)`` over two trees of the same shape."""
    if isinstance(tree, Mapping):
        return {k: _map2(fn, v, other[k]) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map2(fn, v, o) for v, o in zip(tree, other)))
    return fn(tree, other)


def infer_param_specs(params,
                      rules: Sequence[Tuple[str, Tuple[Optional[str], ...]]]
                      = DEFAULT_RULES,
                      axis: str = TENSOR_AXIS,
                      ep_axis: Optional[str] = None):
    """The :class:`PartitionSpec` tree of ``params`` from ``rules``:
    ``"tp"`` becomes ``axis``, ``"ep"`` becomes ``ep_axis`` (``None``:
    replicated); an unmatched leaf is replicated."""
    compiled = [(re.compile(pat), tpl) for pat, tpl in rules]
    sub = {"tp": axis, "ep": ep_axis}

    def spec_for(path, leaf):
        name = "/".join(path)
        for pat, tpl in compiled:
            if pat.search(name):
                resolved = tuple(sub.get(t, t) for t in tpl)
                if len(resolved) > len(leaf.shape):
                    raise ValueError(
                        f"rule {pat.pattern} spec {resolved} has more dims "
                        f"than param {name} with shape {tuple(leaf.shape)}")
                return PartitionSpec(*resolved)
        return PartitionSpec()

    return _map_with_path(spec_for, params)


def _split_dim(leaf, spec: PartitionSpec, axis: str) -> Optional[int]:
    if axis not in spec:
        return None
    return len(leaf.shape) - len(spec) + spec.index(axis)


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.array(x))


def shard_params(params, specs, tp_rank: int, tp_size: int,
                 axis: str = TENSOR_AXIS):
    """Tensor-parallel rank ``tp_rank``'s shard of every leaf (tensors;
    numpy leaves are converted), as contiguous copies; replicated leaves
    are kept whole."""
    def leaf(x, spec):
        x = _tensor(x)
        dim = _split_dim(x, spec, axis)
        if dim is None:
            return x
        if x.shape[dim] % tp_size:
            raise ValueError(f"dimension {dim} of size {x.shape[dim]} not "
                             f"divisible by tensor-parallel size {tp_size}")
        return x.chunk(tp_size, dim=dim)[tp_rank].contiguous()

    return _map2(leaf, params, specs)


def gather_params(shards: List, specs, axis: str = TENSOR_AXIS):
    """The global tree from every tensor-parallel rank's shard tree
    (``shards[r]`` is rank ``r``'s): split leaves concatenated along their
    split dimension, replicated leaves taken from rank 0."""
    def leaf(path, spec):
        parts = [_tensor(_at(s, path)) for s in shards]
        dim = _split_dim(parts[0], spec, axis)
        return parts[0] if dim is None else torch.cat(parts, dim=dim)

    paths = _map_with_path(lambda path, _: path, shards[0])
    return _map2(leaf, paths, specs)


def _at(tree, path):
    for key in path:
        tree = getattr(tree, key) if hasattr(tree, "_fields") else tree[key]
    return tree
