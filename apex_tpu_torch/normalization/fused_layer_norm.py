"""LayerNorm with fp32 statistics and the memory-efficient custom backward
(port of the LayerNorm half of :mod:`apex_tpu.normalization.fused_layer_norm`).

- statistics and the affine are computed in fp32, the output cast back to
  the input dtype;
- the backward is an autograd Function mirroring the JAX ``_ln_fwd`` /
  ``_ln_bwd``: ``memory_efficient=False`` saves ``x_hat``;
  ``memory_efficient=True`` saves the output and recomputes
  ``x_hat = (y - beta) / gamma`` with gamma clamped away from zero by
  magnitude, trading a few operations for activation memory;
- weight and bias gradients are reduced in fp32.

Plain torch ops: the JAX module is plain XLA too (its Pallas LayerNorm
kernel, N1, lives in ``ops/pallas_norm.py`` and is not ported yet).
RMSNorm is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["FusedLayerNorm", "fused_layer_norm_affine"]


def _clamp_by_magnitude(w, eps):
    """|w| >= eps keeping the sign (the reference's ``clamp_by_magnitude``)."""
    mag = torch.clamp(w.abs(), min=eps)
    return torch.where(w >= 0, mag, -mag)


def _ln_fwd_math(x, weight, bias, eps):
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    invvar = torch.rsqrt(var + eps)
    xhat = (x32 - mean) * invvar
    y = xhat * weight.float() + bias.float()
    return y.to(x.dtype), xhat, invvar


class LayerNormFunction(torch.autograd.Function):
    """Affine LayerNorm over the last dim with the JAX package's backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, memory_efficient):
        y, xhat, invvar = _ln_fwd_math(x, weight, bias, eps)
        ctx.save_for_backward(y if memory_efficient else xhat, weight, bias,
                              invvar)
        ctx.eps = eps
        ctx.memory_efficient = memory_efficient
        return y

    @staticmethod
    def backward(ctx, dy):
        saved, weight, bias, invvar = ctx.saved_tensors
        dy32 = dy.float()
        if ctx.memory_efficient:
            xhat = (saved.float() - bias.float()) / _clamp_by_magnitude(
                weight.float(), ctx.eps)
        else:
            xhat = saved
        dxhat = dy32 * weight.float()
        m1 = dxhat.mean(dim=-1, keepdim=True)
        m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
        dx = invvar * (dxhat - m1 - xhat * m2)
        batch = tuple(range(dy.dim() - 1))
        dw = (dy32 * xhat).sum(dim=batch).to(weight.dtype)
        db = dy32.sum(dim=batch).to(bias.dtype)
        return dx.to(dy.dtype), dw, db, None, None


def fused_layer_norm_affine(x, weight, bias, eps: float = 1e-5,
                            memory_efficient: bool = False):
    """LayerNorm over the last dim: statistics and affine in fp32, the
    result in ``x``'s dtype; differentiable in x, weight and bias.

    Only a call that autograd records goes through the Function; any
    other (the serving path, under ``no_grad``) is the plain forward and
    saves nothing for a backward."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, weight, bias)):
        return LayerNormFunction.apply(x, weight, bias, eps, memory_efficient)
    return _ln_fwd_math(x, weight, bias, eps)[0]


class FusedLayerNorm(nn.Module):
    """Module form, with the JAX package's parameter names ``scale`` and
    ``bias`` (kept in ``param_dtype``, fp32 by default)."""

    def __init__(self, normalized_shape: int, eps: float = 1e-5, *,
                 memory_efficient: bool = False, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.eps = eps
        self.memory_efficient = memory_efficient
        self.scale = nn.Parameter(
            torch.ones(normalized_shape, dtype=param_dtype, device=device))
        self.bias = nn.Parameter(
            torch.zeros(normalized_shape, dtype=param_dtype, device=device))

    def forward(self, x):
        return fused_layer_norm_affine(x, self.scale, self.bias, self.eps,
                                       self.memory_efficient)
