"""Vocab-, column- and row-parallel layers at tensor-parallel size 1.

Port of :mod:`apex_tpu.transformer.tensor_parallel.layers` for one card:
with one rank the three layers are an embedding table and two linears.
They keep the JAX package's parameter names and layouts (``embedding``
``[vocab, hidden]``; ``kernel`` ``[out, in]``, ``y = x @ kernel.T``;
``bias`` ``[out]``) and its ``skip_bias_add`` convention (return
``(out, bias)`` so the caller fuses the add).

Parameters are held in ``param_dtype`` and cast to the compute ``dtype``
on every call, as Flax does, so training keeps fp32 parameters and its
gradients land in fp32.  ``param_dtype`` defaults to ``dtype``: the
serving model holds its weights in the compute dtype, where the per-call
cast is a no-op.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear"]


def _param(shape, dtype, device):
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device))


class VocabParallelEmbedding(nn.Module):
    """Embedding table ``[num_embeddings, embedding_dim]``; :meth:`attend`
    is the tied LM head's GEMM."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        self.dtype = dtype
        self.embedding = _param((num_embeddings, embedding_dim),
                                param_dtype or dtype, device)

    def forward(self, token_ids):
        return F.embedding(token_ids, self.embedding.to(self.dtype))

    def attend(self, query):
        return torch.matmul(query, self.embedding.to(self.dtype).t())


class _Linear(nn.Module):
    def __init__(self, input_size: int, output_size: int, *,
                 use_bias: bool = True, skip_bias_add: bool = False,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        self.skip_bias_add = skip_bias_add
        self.dtype = dtype
        param_dtype = param_dtype or dtype
        self.kernel = _param((output_size, input_size), param_dtype, device)
        self.bias = (_param((output_size,), param_dtype, device)
                     if use_bias else None)

    def forward(self, x):
        weight = self.kernel.to(self.dtype)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        if self.skip_bias_add:
            return F.linear(x, weight), bias
        return F.linear(x, weight, bias)


class ColumnParallelLinear(_Linear):
    """Output-sharded linear; at tp=1 a plain linear."""


class RowParallelLinear(_Linear):
    """Input-sharded linear; at tp=1 a plain linear."""
