"""Fused dense: GEMM + bias, and GEMM + bias + GeLU + GEMM + bias (port of
:mod:`apex_tpu.ops.dense`).

The JAX package computes these as the plain expression and lets XLA fuse
the epilogue; here they are ``F.linear`` calls (cuBLAS on the card).
What the reference fixes is kept:

- the weight layout of the torch modules it mirrors, ``weight [out, in]``
  and ``y = x @ weight.T + bias``, so checkpoints map one to one;
- the exact (erf) GeLU of cuBLASLt's ``GELU_AUX_BIAS`` epilogue, not the
  tanh approximation;
- the modules' parameter names (``weight``, ``bias``; ``weight1``,
  ``bias1``, ``weight2``, ``bias2``), held in ``param_dtype`` and cast to
  the input's dtype at every call, as Flax does.

The modules are built on ``device``, the card unless the caller names
another (``"cpu"``), with LeCun-normal weights and zero biases drawn from
``seed``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._device import resolve_device

__all__ = ["fused_dense", "fused_dense_gelu_dense", "FusedDense",
           "FusedDenseGeluDense"]


def fused_dense(x, weight, bias: Optional[torch.Tensor] = None):
    """GEMM + bias: ``x @ weight.T + bias``, ``weight [out, in]``."""
    return F.linear(x, weight, bias)


def fused_dense_gelu_dense(x, weight1, bias1, weight2, bias2):
    """GEMM + bias + erf GeLU + GEMM + bias."""
    h = F.gelu(fused_dense(x, weight1, bias1), approximate="none")
    return fused_dense(h, weight2, bias2)


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """Flax's ``lecun_normal`` for a torch-layout ``[out, in]`` weight: a
    normal truncated at two deviations, of variance ``1 / in`` after the
    truncation, drawn on the CPU from ``generator``."""
    std = math.sqrt(1.0 / weight.shape[1]) / .87962566103423978
    cpu = torch.empty(weight.shape, dtype=torch.float32)
    nn.init.trunc_normal_(cpu, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    weight.copy_(cpu)


def _param(shape, dtype, device):
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device))


class FusedDense(nn.Module):
    """``apex.fused_dense.FusedDense``: ``weight [out, in]`` and, with
    ``use_bias``, ``bias [out]``."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, param_dtype=torch.float32, *,
                 device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.in_features, self.out_features = in_features, out_features
        self.weight = _param((out_features, in_features), param_dtype,
                             device)
        self.bias = (_param((out_features,), param_dtype, device)
                     if use_bias else None)
        lecun_normal_(self.weight, torch.Generator().manual_seed(seed))

    def forward(self, x):
        return fused_dense(x, self.weight.to(x.dtype),
                           None if self.bias is None else self.bias.to(x.dtype))


class FusedDenseGeluDense(nn.Module):
    """``apex.fused_dense.FusedDenseGeluDense``: ``weight1 [inter, in]``,
    ``bias1``, ``weight2 [out, inter]``, ``bias2``."""

    def __init__(self, in_features: int, intermediate_features: int,
                 out_features: int, param_dtype=torch.float32, *,
                 device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.weight1 = _param((intermediate_features, in_features),
                              param_dtype, device)
        self.bias1 = _param((intermediate_features,), param_dtype, device)
        self.weight2 = _param((out_features, intermediate_features),
                              param_dtype, device)
        self.bias2 = _param((out_features,), param_dtype, device)
        gen = torch.Generator().manual_seed(seed)
        lecun_normal_(self.weight1, gen)
        lecun_normal_(self.weight2, gen)

    def forward(self, x):
        return fused_dense_gelu_dense(
            x, *(p.to(x.dtype) for p in (self.weight1, self.bias1,
                                         self.weight2, self.bias2)))
