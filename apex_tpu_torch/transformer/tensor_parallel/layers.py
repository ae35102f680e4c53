"""Vocab-, column- and row-parallel layers (port of
:mod:`apex_tpu.transformer.tensor_parallel.layers`).

Each layer holds this rank's shard of its weights, as the reference's
do inside ``shard_map``: ``embedding [vocab/tp, hidden]``; a column
linear's ``kernel [out/tp, in]`` and ``bias [out/tp]``; a row linear's
``kernel [out, in/tp]`` and its whole ``bias [out]``, added after the
reduction (``y = x @ kernel.T``, the JAX package's layout).  The tensor
axis ``axis`` (default ``"tp"``) is read when the layer is built: its
size is that of the grid set up by
:func:`apex_tpu_torch.parallel.initialize_model_parallel`, and 1 when
there is none or ``axis=None``, where the layers are a plain embedding
and two plain linears and call no collective.

At tp > 1 the layers enter and leave the tensor-parallel region through
:mod:`~apex_tpu_torch.transformer.tensor_parallel.mappings`:

- ``VocabParallelEmbedding`` looks up the ids of its vocabulary range
  (the others give zero rows) and sums the partial rows over the axis;
  with ``reduce_scatter_embeddings`` it takes ``[b, s]`` ids to the
  ``[s/tp, b, h]`` sequence shard through one reduce-scatter instead;
- ``ColumnParallelLinear`` copies its input into the region (the
  gradient summed over the axis), or under ``sequence_parallel``
  all-gathers the sequence shards (the gradient reduce-scattered), and
  keeps its output sharded unless ``gather_output``;
- ``RowParallelLinear`` sums its partial outputs over the axis, or under
  ``sequence_parallel`` reduce-scatters them onto the sequence shards.

Under ``sequence_parallel`` a row linear's bias meets only this rank's
sequence shard, so its gradient is a partial sum: the layer marks it
``sequence_parallel = True``, and
:func:`apex_tpu_torch.transformer.layers.allreduce_sequence_parallel_gradients`
sums such gradients over the axis after the backward.

Parameters are held in ``param_dtype`` and cast to the compute ``dtype``
on every call, as Flax does.  With ``fp8=True`` a linear's GEMM runs
through :func:`apex_tpu_torch.amp.fp8.fp8_matmul_t` and its ``{"x",
"w"}`` metas (the buffers of :attr:`fp8_meta`) roll after the GEMM in
``training`` mode with the amaxes of this rank's ``x`` (before the
sequence all-gather) and weight shard, their MAX taken over the axis so
every rank keeps the same scales.

``overlap_comm`` replaces, under ``sequence_parallel`` at tp > 1, the
column linear's all-gather + GEMM by
:func:`~apex_tpu_torch.transformer.tensor_parallel.overlap.gather_matmul`
and the row linear's GEMM + reduce-scatter by
:func:`~apex_tpu_torch.transformer.tensor_parallel.overlap.matmul_scatter`,
the rings whose hops travel under partial GEMMs; it changes nothing
elsewhere, as in the reference.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.amp.fp8 import Fp8MetaState, fp8_matmul_t
from apex_tpu_torch.parallel.collectives import axis_index, bound_axis_size
from apex_tpu_torch.parallel.mesh import TENSOR_AXIS
from apex_tpu_torch.transformer.tensor_parallel import mappings
from apex_tpu_torch.transformer.tensor_parallel.overlap import (
    gather_matmul,
    matmul_scatter,
)
from apex_tpu_torch.transformer.tensor_parallel.random import (
    get_rng_states_tracker,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import (
    VocabUtility,
    divide,
)

__all__ = ["Initializer", "parallel_init", "linear_with_grad_accumulation",
           "VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear"]

# init_fn(tensor, generator) fills ``tensor`` in place
Initializer = Callable[..., None]


def parallel_init(init_fn: Initializer, axis: Optional[str]) -> Initializer:
    """``init_fn`` drawing from the tracker's ``"model-parallel-rng"``
    stream, which differs per tensor-parallel rank, so each rank's shard
    takes values of its own; with ``axis=None`` (or one rank) it draws
    from the generator it is given."""
    if axis is None or bound_axis_size(axis) == 1:
        return init_fn

    def init(tensor, generator=None):
        del generator
        return init_fn(tensor, get_rng_states_tracker().fork())

    return init


def _param(shape, dtype, device):
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device))


def linear_with_grad_accumulation(x, weight, bias=None, *,
                                  sequence_parallel: bool = False,
                                  axis: Optional[str] = TENSOR_AXIS,
                                  fp8_metas=None, overlap_comm: bool = False):
    """``y = x @ weight.T + bias``; under ``sequence_parallel`` ``x`` is
    first all-gathered along the sequence (first) dim over ``axis`` and
    its gradient reduce-scattered.  ``fp8_metas`` (``{"x": Fp8Meta, "w":
    Fp8Meta}``) routes the GEMM through
    :func:`~apex_tpu_torch.amp.fp8.fp8_matmul_t`; the caller rolls the
    metas.  ``overlap_comm`` (with ``sequence_parallel``) runs the gather
    and the GEMM as the :func:`~apex_tpu_torch.transformer.
    tensor_parallel.overlap.gather_matmul` ring."""
    if sequence_parallel:
        if axis is None:
            raise ValueError("sequence_parallel requires a tensor axis")
        if overlap_comm:
            y = gather_matmul(x, weight, axis, fp8_metas=fp8_metas)
            return y if bias is None else y + bias
        x = mappings.gather_from_sequence_parallel_region(x, axis, True)
    if fp8_metas is None:
        return F.linear(x, weight, bias)
    y = fp8_matmul_t(x, weight, fp8_metas["x"], fp8_metas["w"])
    return y if bias is None else y + bias


class VocabParallelEmbedding(nn.Module):
    """Embedding table sharded along the vocabulary: this rank holds rows
    ``[rank * V/tp, (rank + 1) * V/tp)``; :meth:`attend` is the tied LM
    head's GEMM against the shard."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 axis: Optional[str] = TENSOR_AXIS,
                 reduce_scatter_embeddings: bool = False,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        self.dtype = dtype
        self.axis = axis
        self.world = bound_axis_size(axis)
        self.reduce_scatter_embeddings = reduce_scatter_embeddings
        self.vocab_local = divide(num_embeddings, self.world)
        self.embedding = _param((self.vocab_local, embedding_dim),
                                param_dtype or dtype, device)

    def forward(self, token_ids):
        """``[b, s]`` ids -> ``[b, s, h]``, or with
        ``reduce_scatter_embeddings`` at tp > 1 the sequence shard
        ``[s/tp, b, h]``."""
        weight = self.embedding.to(self.dtype)
        if self.world == 1:
            return F.embedding(token_ids, weight)
        start, _ = VocabUtility.vocab_range_from_per_partition_vocab_size(
            self.vocab_local, axis_index(self.axis))
        local = token_ids - start
        outside = (local < 0) | (local >= self.vocab_local)
        out = F.embedding(local.masked_fill(outside, 0), weight)
        out = out.masked_fill(outside[..., None], 0.0)
        if self.reduce_scatter_embeddings:
            return mappings.reduce_scatter_to_sequence_parallel_region(
                out.transpose(0, 1), self.axis)
        return mappings.reduce_from_tensor_model_parallel_region(
            out, self.axis)

    def attend(self, query):
        return torch.matmul(query, self.embedding.to(self.dtype).t())


class _Linear(nn.Module):
    def __init__(self, world, kernel_shape, bias_shape, *, use_bias,
                 skip_bias_add, sequence_parallel, axis, dtype, param_dtype,
                 fp8, overlap_comm, device):
        super().__init__()
        self.world = world
        self.overlap_comm = overlap_comm
        self.skip_bias_add = skip_bias_add
        self.dtype = dtype
        self.axis = axis
        self.sequence_parallel = sequence_parallel and world > 1
        param_dtype = param_dtype or dtype
        self.kernel = _param(kernel_shape, param_dtype, device)
        self.bias = (_param(bias_shape, param_dtype, device)
                     if use_bias else None)
        self.fp8_meta = Fp8MetaState(device=device) if fp8 else None

    def _gemm(self, x, sequence_parallel, scatter=False):
        """The GEMM (after the sequence gather, or as its ring), or with
        ``scatter`` the GEMM + reduce-scatter ring; the fp8 metas roll
        after it.  Returns ``(y, bias)``."""
        weight = self.kernel.to(self.dtype)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        fp8 = self.fp8_meta
        metas = None if fp8 is None else fp8.metas()
        if scatter:
            y = matmul_scatter(x, weight, self.axis, fp8_metas=metas)
        else:
            y = linear_with_grad_accumulation(
                x, weight, bias if self._bias_in_gemm else None,
                sequence_parallel=sequence_parallel,
                axis=self.axis if self.world > 1 else None,
                fp8_metas=metas, overlap_comm=self.overlap_comm)
        if fp8 is not None and self.training:
            fp8.roll(x, weight, axis=self.axis if self.world > 1 else None)
        return y, bias


class ColumnParallelLinear(_Linear):
    """Output-sharded linear: ``kernel [out/tp, in]``, ``bias [out/tp]``."""

    def __init__(self, input_size: int, output_size: int, *,
                 use_bias: bool = True, gather_output: bool = False,
                 sequence_parallel: bool = False, skip_bias_add: bool = False,
                 axis: Optional[str] = TENSOR_AXIS, dtype=torch.float32,
                 param_dtype=None, fp8: bool = False,
                 overlap_comm: bool = False, device=None):
        world = bound_axis_size(axis)
        out_local = divide(output_size, world)
        if gather_output and sequence_parallel:
            raise ValueError(
                "gather_output is incompatible with sequence_parallel")
        super().__init__(world, (out_local, input_size), (out_local,),
                         use_bias=use_bias, skip_bias_add=skip_bias_add,
                         sequence_parallel=sequence_parallel, axis=axis,
                         dtype=dtype, param_dtype=param_dtype, fp8=fp8,
                         overlap_comm=overlap_comm, device=device)
        self.gather_output = gather_output
        self._bias_in_gemm = not skip_bias_add

    def forward(self, x):
        if self.world > 1 and not self.sequence_parallel:
            x = mappings.copy_to_tensor_model_parallel_region(x, self.axis)
        y, bias = self._gemm(x, self.sequence_parallel)
        if self.gather_output and self.world > 1:
            y = mappings.gather_from_tensor_model_parallel_region(y, self.axis)
        if self.skip_bias_add:
            return y, bias
        return y


class RowParallelLinear(_Linear):
    """Input-sharded linear: ``kernel [out, in/tp]``; ``bias [out]`` is
    whole on every rank and added after the reduction."""

    def __init__(self, input_size: int, output_size: int, *,
                 use_bias: bool = True, input_is_parallel: bool = True,
                 sequence_parallel: bool = False, skip_bias_add: bool = False,
                 axis: Optional[str] = TENSOR_AXIS, dtype=torch.float32,
                 param_dtype=None, fp8: bool = False,
                 overlap_comm: bool = False, device=None):
        world = bound_axis_size(axis)
        in_local = divide(input_size, world)
        if sequence_parallel and not input_is_parallel and world > 1:
            raise ValueError("sequence_parallel requires input_is_parallel")
        super().__init__(world, (output_size, in_local), (output_size,),
                         use_bias=use_bias, skip_bias_add=skip_bias_add,
                         sequence_parallel=sequence_parallel, axis=axis,
                         dtype=dtype, param_dtype=param_dtype, fp8=fp8,
                         overlap_comm=overlap_comm, device=device)
        self.input_is_parallel = input_is_parallel
        # at tp = 1 the bias rides in the GEMM, as a plain linear's does
        self._bias_in_gemm = self.world == 1 and not skip_bias_add
        if self.sequence_parallel and self.bias is not None:
            self.bias.sequence_parallel = True

    def forward(self, x):
        if self.world > 1 and not self.input_is_parallel:
            x = mappings.scatter_to_tensor_model_parallel_region(x, self.axis)
        ring = self.sequence_parallel and self.overlap_comm
        y, bias = self._gemm(x, False, scatter=ring)
        if self.world > 1:
            if self.sequence_parallel and not ring:
                y = mappings.reduce_scatter_to_sequence_parallel_region(
                    y, self.axis)
            elif not self.sequence_parallel:
                y = mappings.reduce_from_tensor_model_parallel_region(
                    y, self.axis)
            if bias is not None and not self.skip_bias_add:
                y = y + bias
        if self.skip_bias_add:
            return y, bias
        return y
