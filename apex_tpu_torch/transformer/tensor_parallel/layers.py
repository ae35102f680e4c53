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

With ``fp8=True`` a linear's GEMM runs through
:func:`apex_tpu_torch.amp.fp8.fp8_matmul_t` (e4m3 operands with delayed
scaling, an e5m2 just-in-time cotangent), and its ``{"x", "w"}`` metas
are the buffers of :attr:`fp8_meta`, rolled after the GEMM in
``training`` mode with the amaxes of ``x`` and of the weight after its
cast to the compute dtype (the JAX layers' ``_Fp8MetaMixin``).
Sequence parallelism, the ring-overlapped collective matmul and a tensor
axis wait for the port's tensor parallelism (ROADMAP.md, section A.2)
and raise.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.amp.fp8 import Fp8MetaState, fp8_matmul_t

__all__ = ["linear_with_grad_accumulation", "VocabParallelEmbedding",
           "ColumnParallelLinear", "RowParallelLinear"]


def _param(shape, dtype, device):
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device))


def linear_with_grad_accumulation(x, weight, bias=None, *,
                                  sequence_parallel: bool = False,
                                  axis: Optional[str] = None,
                                  fp8_metas=None, overlap_comm: bool = False):
    """``y = x @ weight.T + bias`` at tensor-parallel size 1.

    ``fp8_metas``: ``{"x": Fp8Meta, "w": Fp8Meta}`` routes the GEMM
    through :func:`~apex_tpu_torch.amp.fp8.fp8_matmul_t`; the caller rolls
    the metas.  ``sequence_parallel``, ``overlap_comm`` and ``axis`` need
    a tensor-parallel group and raise."""
    if sequence_parallel or overlap_comm or axis is not None:
        raise NotImplementedError(
            "sequence parallelism, overlap_comm and a tensor axis wait for "
            "the port's tensor parallelism (ROADMAP.md, section A.2)")
    if fp8_metas is None:
        return F.linear(x, weight, bias)
    y = fp8_matmul_t(x, weight, fp8_metas["x"], fp8_metas["w"])
    return y if bias is None else y + bias


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
                 dtype=torch.float32, param_dtype=None, fp8: bool = False,
                 device=None):
        super().__init__()
        self.skip_bias_add = skip_bias_add
        self.dtype = dtype
        param_dtype = param_dtype or dtype
        self.kernel = _param((output_size, input_size), param_dtype, device)
        self.bias = (_param((output_size,), param_dtype, device)
                     if use_bias else None)
        self.fp8_meta = Fp8MetaState(device=device) if fp8 else None

    def forward(self, x):
        weight = self.kernel.to(self.dtype)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        fp8 = self.fp8_meta
        y = linear_with_grad_accumulation(
            x, weight, None if self.skip_bias_add else bias,
            fp8_metas=None if fp8 is None else fp8.metas())
        if fp8 is not None and self.training:
            fp8.roll(x, weight)
        if self.skip_bias_add:
            return y, bias
        return y


class ColumnParallelLinear(_Linear):
    """Output-sharded linear; at tp=1 a plain linear."""


class RowParallelLinear(_Linear):
    """Input-sharded linear; at tp=1 a plain linear."""
