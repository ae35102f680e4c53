"""Transformer-layer norms and the sequence-parallel gradient sum (port
of :mod:`apex_tpu.transformer.layers.layer_norm`).

Under sequence parallelism the activations are split along the sequence
over the tensor-parallel ranks, but some parameters stay whole on every
rank: the LayerNorms, the row-parallel linears' biases and the learned
position table.  Each rank's gradient of such a parameter covers only its
sequence shard, so the gradients are summed over the tensor axis after
the backward (:func:`allreduce_sequence_parallel_gradients`).  JAX's
``shard_map`` transpose inserts that sum itself; NVIDIA Apex marks the
parameters ``sequence_parallel`` and sums them in a hook, and so does the
port: the modules that build such parameters under sequence parallelism
set ``param.sequence_parallel = True``.
"""

from __future__ import annotations

from collections.abc import Mapping

import torch
from torch import nn

from apex_tpu_torch.normalization.fused_layer_norm import (
    FusedLayerNorm,
    FusedRMSNorm,
    MixedFusedLayerNorm,
    MixedFusedRMSNorm,
)
from apex_tpu_torch.parallel.collectives import all_reduce
from apex_tpu_torch.parallel.mesh import TENSOR_AXIS

__all__ = [
    "FastLayerNorm",
    "FusedLayerNorm",
    "FusedRMSNorm",
    "MixedFusedLayerNorm",
    "MixedFusedRMSNorm",
    "allreduce_sequence_parallel_gradients",
    "mark_sequence_parallel_params",
]

# the persistent-kernel LayerNorm of the reference computes the same
# function, so it is the same module
FastLayerNorm = FusedLayerNorm

_SP_PARAM_PATH_MARKERS = ("layernorm", "layer_norm", "norm")


def mark_sequence_parallel_params(path: str) -> bool:
    """True if a parameter path belongs to a replicated norm's parameter
    (the set the reference marks ``sequence_parallel``)."""
    lowered = path.lower()
    return any(m in lowered for m in _SP_PARAM_PATH_MARKERS)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            yield from _flat(v, name + "/")
        else:
            yield name, v


def _unflat(tree, values, prefix=""):
    return {k: (_unflat(v, values, f"{prefix}{k}/")
                if isinstance(v, Mapping) else values.get(f"{prefix}{k}", v))
            for k, v in tree.items()}


@torch.no_grad()
def allreduce_sequence_parallel_gradients(module_or_grads,
                                          axis: str = TENSOR_AXIS,
                                          is_sequence_parallel_param=None):
    """Sum the gradients of the sequence-parallel-replicated parameters
    over ``axis``, in one all-reduce per dtype.

    Given a module: the ``.grad`` of every parameter marked
    ``sequence_parallel``, written in place (returns ``None``).  Given a
    gradient tree (nested dicts): the leaves whose ``"/"``-joined path
    ``is_sequence_parallel_param`` accepts (default
    :func:`mark_sequence_parallel_params`, the norms), in a new tree."""
    if isinstance(module_or_grads, nn.Module):
        grads = [p.grad for p in module_or_grads.parameters()
                 if getattr(p, "sequence_parallel", False)
                 and p.grad is not None]
        for g, s in zip(grads, _summed(grads, axis)):
            g.copy_(s)
        return None
    pred = is_sequence_parallel_param or mark_sequence_parallel_params
    picked = [(n, g) for n, g in _flat(module_or_grads) if pred(n)]
    summed = _summed([g for _, g in picked], axis)
    return _unflat(module_or_grads,
                   {n: s for (n, _), s in zip(picked, summed)})


def _summed(grads, axis):
    """Each tensor of ``grads`` summed over ``axis``; one all-reduce per
    dtype."""
    out = [None] * len(grads)
    by_dtype = {}
    for i, g in enumerate(grads):
        by_dtype.setdefault(g.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = all_reduce(torch.cat([grads[i].reshape(-1) for i in idx]),
                          axis)
        start = 0
        for i in idx:
            n = grads[i].numel()
            out[i] = flat[start:start + n].view_as(grads[i])
            start += n
    return out
