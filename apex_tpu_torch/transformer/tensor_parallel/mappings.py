"""The differentiable collectives of tensor and sequence parallelism
(port of :mod:`apex_tpu.transformer.tensor_parallel.mappings`).

Under ``shard_map`` JAX derives each backward collective from the
forward one.  Torch's autograd knows nothing of process groups, so each
region here is a :class:`torch.autograd.Function` with the pair NVIDIA
Apex writes by hand:

=============================================  ===================  ====================
region                                         forward              backward
=============================================  ===================  ====================
``copy_to_tensor_model_parallel_region``       identity             all-reduce
``reduce_from_tensor_model_parallel_region``   all-reduce           identity
``scatter_to_tensor_model_parallel_region``    split, last dim      all-gather, last dim
``gather_from_tensor_model_parallel_region``   all-gather, last     split, last dim
``scatter_to_sequence_parallel_region``        split, first dim     all-gather, first
``gather_from_sequence_parallel_region``       all-gather, first    reduce-scatter, or
                                                                    split (see below)
``reduce_scatter_to_sequence_parallel_region`` reduce-scatter       all-gather, first
=============================================  ===================  ====================

``all_to_all_region`` (context and expert parallelism: Ulysses'
head/sequence swap, the expert dispatch) splits one dim over the ranks
and concatenates what arrives along another; its backward is the
reverse all-to-all.

``gather_from_sequence_parallel_region``'s backward reduce-scatters when
``tensor_parallel_output_grad`` (the gradient arriving is a partial sum,
as behind a column-parallel GEMM) and splits otherwise (it is already
the same on every rank).  JAX reads that from the cotangent's
replication and ignores the flag; here the flag decides.

Every region issues its collective whatever the axis's size; a layer
that runs at one rank skips the region instead, as the reference's
layers do.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.parallel import collectives as cc
from apex_tpu_torch.parallel.mesh import TENSOR_AXIS

__all__ = [
    "copy_to_tensor_model_parallel_region",
    "reduce_from_tensor_model_parallel_region",
    "scatter_to_tensor_model_parallel_region",
    "gather_from_tensor_model_parallel_region",
    "scatter_to_sequence_parallel_region",
    "gather_from_sequence_parallel_region",
    "reduce_scatter_to_sequence_parallel_region",
    "all_to_all_region",
]


def _split(x, axis, dim):
    """This rank's chunk of ``x`` along ``dim`` (contiguous)."""
    n = cc.axis_size(axis)
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"dimension {dim % x.dim()} of size {size} not "
                         f"divisible by parallel size {n}")
    return x.chunk(n, dim=dim)[cc.axis_index(axis)].contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return cc.all_reduce(g, ctx.axis), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return cc.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _split(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return cc.all_gather(g, ctx.axis, concat_axis=ctx.dim), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, partial_grad):
        ctx.axis, ctx.dim, ctx.partial_grad = axis, dim, partial_grad
        return cc.all_gather(x, axis, concat_axis=dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial_grad:
            g = cc.reduce_scatter(g, ctx.axis, scatter_axis=ctx.dim)
        else:
            g = _split(g, ctx.axis, ctx.dim)
        return g, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return cc.reduce_scatter(x, axis, scatter_axis=0)

    @staticmethod
    def backward(ctx, g):
        return cc.all_gather(g, ctx.axis, concat_axis=0), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_axis, concat_axis):
        ctx.axis, ctx.split, ctx.concat = axis, split_axis, concat_axis
        return cc.all_to_all(x, axis, split_axis=split_axis,
                             concat_axis=concat_axis)

    @staticmethod
    def backward(ctx, g):
        return cc.all_to_all(g, ctx.axis, split_axis=ctx.concat,
                             concat_axis=ctx.split), None, None, None


def copy_to_tensor_model_parallel_region(x, axis=TENSOR_AXIS):
    """Enter the tensor-parallel region: identity; the gradient is summed
    over ``axis``."""
    return _Copy.apply(x, axis)


def reduce_from_tensor_model_parallel_region(x, axis=TENSOR_AXIS):
    """Leave it: the partial outputs summed over ``axis``; the gradient
    passes as it is."""
    return _Reduce.apply(x, axis)


def scatter_to_tensor_model_parallel_region(x, axis=TENSOR_AXIS):
    """This rank's chunk of the last dim; the gradient is all-gathered."""
    return _Scatter.apply(x, axis, -1)


def gather_from_tensor_model_parallel_region(x, axis=TENSOR_AXIS):
    """The last dim all-gathered; the gradient is split back."""
    return _Gather.apply(x, axis, -1, False)


def scatter_to_sequence_parallel_region(x, axis=TENSOR_AXIS):
    """This rank's chunk of the sequence (first) dim; the gradient is
    all-gathered."""
    return _Scatter.apply(x, axis, 0)


def gather_from_sequence_parallel_region(x, axis=TENSOR_AXIS,
                                         tensor_parallel_output_grad=True):
    """The sequence dim all-gathered; the gradient is reduce-scattered
    when ``tensor_parallel_output_grad``, else split."""
    return _Gather.apply(x, axis, 0, tensor_parallel_output_grad)


def reduce_scatter_to_sequence_parallel_region(x, axis=TENSOR_AXIS):
    """The partial outputs summed over ``axis``, this rank keeping its
    chunk of the sequence dim; the gradient is all-gathered."""
    return _ReduceScatter.apply(x, axis)


def all_to_all_region(x, axis, split_axis: int, concat_axis: int):
    """``split_axis`` cut into one chunk per rank of ``axis``, chunk ``i``
    sent to rank ``i``, and what arrives concatenated along
    ``concat_axis`` in rank order (JAX's tiled ``all_to_all``); the
    gradient takes the reverse all-to-all.  One ``CALLS["all_to_all"]``
    each way."""
    return _AllToAll.apply(x, axis, split_axis, concat_axis)
