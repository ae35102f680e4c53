"""LayerNorm with fp32 statistics (port of the forward of
:mod:`apex_tpu.normalization.fused_layer_norm`; the serving path needs no
backward)."""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["FusedLayerNorm", "fused_layer_norm_affine"]


def fused_layer_norm_affine(x, weight, bias, eps: float = 1e-5):
    """LayerNorm over the last dim: statistics and affine in fp32, the
    result in ``x``'s dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(x.dtype)


class FusedLayerNorm(nn.Module):
    """Module form, with the JAX package's parameter names ``scale`` and
    ``bias`` (kept in ``param_dtype``, fp32 by default)."""

    def __init__(self, normalized_shape: int, eps: float = 1e-5, *,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(
            torch.ones(normalized_shape, dtype=param_dtype, device=device),
            requires_grad=False)
        self.bias = nn.Parameter(
            torch.zeros(normalized_shape, dtype=param_dtype, device=device),
            requires_grad=False)

    def forward(self, x):
        return fused_layer_norm_affine(x, self.scale, self.bias, self.eps)
