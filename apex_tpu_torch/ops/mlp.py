"""Whole-MLP forward (port of :mod:`apex_tpu.ops.mlp`, the ``mlp_cuda``
analog): an N-layer perceptron whose activation follows every layer,
the last included, as the reference's per-GEMM epilogue applies it.
Each layer is one ``F.linear`` (cuBLAS on the card) and the activation
one elementwise op; autograd gives the backward.  Weights keep the torch
layout ``[out, in]``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.ops.dense import lecun_normal_

__all__ = ["mlp_forward", "MLP"]

_ACTIVATIONS = {
    "none": lambda x: x,
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
}


def mlp_forward(x, weights: Sequence, biases: Sequence,
                activation: str = "relu"):
    """``act(... act(x @ w0.T + b0) ... @ wn.T + bn)``; ``biases`` empty
    for none.  ``activation`` is one of ``none``, ``relu``, ``sigmoid``."""
    if activation not in _ACTIVATIONS:
        raise ValueError(
            f"activation must be one of {sorted(_ACTIVATIONS)} "
            "(parity with apex/mlp/mlp.py:43)")
    act = _ACTIVATIONS[activation]
    h = x
    for i, w in enumerate(weights):
        h = act(F.linear(h, w, biases[i] if biases else None))
    return h


class MLP(nn.Module):
    """``apex.mlp.MLP``: ``mlp_sizes`` is ``[in, hidden..., out]``; layer
    ``i`` holds ``weight_<i> [out, in]`` (LeCun-normal from ``seed``) and,
    with ``use_bias``, ``bias_<i>`` (zeros), in ``param_dtype``, cast to
    the input's dtype at the call.  Built on ``device``, the card unless
    the caller names another."""

    def __init__(self, mlp_sizes: Sequence[int], use_bias: bool = True,
                 activation: str = "relu", param_dtype=torch.float32, *,
                 device=None, seed: int = 0):
        super().__init__()
        if activation not in _ACTIVATIONS:
            raise ValueError(
                f"activation must be one of {sorted(_ACTIVATIONS)} "
                "(parity with apex/mlp/mlp.py:43)")
        device = resolve_device(device)
        self.mlp_sizes = list(mlp_sizes)
        self.use_bias = use_bias
        self.activation = activation
        gen = torch.Generator().manual_seed(seed)
        for i, (n_in, n_out) in enumerate(zip(self.mlp_sizes,
                                              self.mlp_sizes[1:])):
            w = nn.Parameter(torch.zeros((n_out, n_in), dtype=param_dtype,
                                         device=device))
            lecun_normal_(w, gen)
            self.register_parameter(f"weight_{i}", w)
            if use_bias:
                self.register_parameter(f"bias_{i}", nn.Parameter(
                    torch.zeros((n_out,), dtype=param_dtype, device=device)))

    def forward(self, x):
        n = len(self.mlp_sizes) - 1
        weights = [getattr(self, f"weight_{i}").to(x.dtype) for i in range(n)]
        biases = ([getattr(self, f"bias_{i}").to(x.dtype) for i in range(n)]
                  if self.use_bias else [])
        return mlp_forward(x, weights, biases, self.activation)
