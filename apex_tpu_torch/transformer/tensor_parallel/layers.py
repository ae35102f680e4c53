"""Vocab-, column- and row-parallel layers at tensor-parallel size 1.

Port of :mod:`apex_tpu.transformer.tensor_parallel.layers` for one card:
with one rank the three layers are an embedding table and two linears.
They keep the JAX package's parameter names and layouts (``embedding``
``[vocab, hidden]``; ``kernel`` ``[out, in]``, ``y = x @ kernel.T``;
``bias`` ``[out]``) and its ``skip_bias_add`` convention (return
``(out, bias)`` so the caller fuses the add).  Weights are held in the
compute dtype: Flax casts them to it on every call, the port once.
Serving only: the parameters carry no gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear"]


def _param(shape, dtype, device):
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


class VocabParallelEmbedding(nn.Module):
    """Embedding table ``[num_embeddings, embedding_dim]``; :meth:`attend`
    is the tied LM head's GEMM."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.embedding = _param((num_embeddings, embedding_dim), dtype,
                                device)

    def forward(self, token_ids):
        return F.embedding(token_ids, self.embedding)

    def attend(self, query):
        return torch.matmul(query, self.embedding.t())


class _Linear(nn.Module):
    def __init__(self, input_size: int, output_size: int, *,
                 use_bias: bool = True, skip_bias_add: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.skip_bias_add = skip_bias_add
        self.kernel = _param((output_size, input_size), dtype, device)
        self.bias = (_param((output_size,), dtype, device)
                     if use_bias else None)

    def forward(self, x):
        if self.skip_bias_add:
            return F.linear(x, self.kernel), self.bias
        return F.linear(x, self.kernel, self.bias)


class ColumnParallelLinear(_Linear):
    """Output-sharded linear; at tp=1 a plain linear."""


class RowParallelLinear(_Linear):
    """Input-sharded linear; at tp=1 a plain linear."""
