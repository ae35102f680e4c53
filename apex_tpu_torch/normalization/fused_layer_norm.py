"""Fused LayerNorm / RMSNorm with the memory-efficient custom backward
(port of :mod:`apex_tpu.normalization.fused_layer_norm`, all of it).

- statistics and the affine are computed in fp32, the output cast back to
  the input dtype; ``normalized_shape`` (an int or a tuple) names the
  trailing dims that are normalised together;
- the backward is an autograd Function mirroring the JAX ``_ln_fwd`` /
  ``_ln_bwd`` and ``_rms_fwd`` / ``_rms_bwd``: ``memory_efficient=False``
  saves ``x_hat``; ``memory_efficient=True`` saves the output and
  recomputes ``x_hat = (y - beta) / gamma`` (RMSNorm: ``y / gamma``) with
  gamma clamped away from zero by magnitude, trading a few operations for
  activation memory;
- weight and bias gradients are reduced in fp32 and returned in the
  parameters' dtypes; ``dx`` in the cotangent's.

Plain torch ops: the JAX module is plain XLA too.  Its Pallas row kernels
(N1, N2) live in :mod:`apex_tpu_torch.ops.pallas_norm`, whose backward is
the one here.
"""

from __future__ import annotations

import numbers
from typing import Tuple, Union

import torch
from torch import nn

from apex_tpu_torch._device import resolve_device

__all__ = [
    "fused_layer_norm",
    "fused_layer_norm_affine",
    "fused_rms_norm",
    "fused_rms_norm_affine",
    "manual_rms_norm",
    "FusedLayerNorm",
    "FusedRMSNorm",
    "MixedFusedLayerNorm",
    "MixedFusedRMSNorm",
]

Shape = Union[int, Tuple[int, ...]]


def _clamp_by_magnitude(w, eps):
    """|w| >= eps keeping the sign (the reference's ``clamp_by_magnitude``)."""
    mag = torch.clamp(w.abs(), min=eps)
    return torch.where(w >= 0, mag, -mag)


def _as_shape(normalized_shape: Shape) -> Tuple[int, ...]:
    if isinstance(normalized_shape, numbers.Integral):
        return (int(normalized_shape),)
    return tuple(int(s) for s in normalized_shape)


def _norm_axes(x, normalized_shape: Shape) -> Tuple[int, ...]:
    shape = _as_shape(normalized_shape)
    if len(shape) > x.dim() or tuple(x.shape[x.dim() - len(shape):]) != shape:
        raise ValueError(
            f"normalized_shape {shape} does not match trailing input dims "
            f"{tuple(x.shape)}")
    return tuple(range(x.dim() - len(shape), x.dim()))


def _batch_sum(t, n_axes):
    """Sum over every dim but the last ``n_axes`` (none: ``t`` itself;
    ``sum(dim=())`` would reduce them all)."""
    batch = tuple(range(t.dim() - n_axes))
    return t.sum(dim=batch) if batch else t


# ---------------------------------------------------------------------------
# LayerNorm
# ---------------------------------------------------------------------------


def _ln_fwd_math(x, weight, bias, axes, eps):
    x32 = x.float()
    mean = x32.mean(dim=axes, keepdim=True)
    var = (x32 - mean).square().mean(dim=axes, keepdim=True)
    invvar = torch.rsqrt(var + eps)
    xhat = (x32 - mean) * invvar
    y = xhat
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype), xhat, invvar


def _ln_bwd_math(saved, weight, bias, invvar, dy, n_axes, eps,
                 memory_efficient):
    """``(dx, dw, db)`` from what the forward saved (``x_hat``, or the
    output when ``memory_efficient``)."""
    dy32 = dy.float()
    axes = tuple(range(dy.dim() - n_axes, dy.dim()))
    if memory_efficient:
        y32 = saved.float()
        if bias is not None:
            y32 = y32 - bias.float()
        xhat = (y32 / _clamp_by_magnitude(weight.float(), eps)
                if weight is not None else y32)
    else:
        xhat = saved
    dxhat = dy32 * weight.float() if weight is not None else dy32
    # dx = invvar * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))
    m1 = dxhat.mean(dim=axes, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=axes, keepdim=True)
    dx = invvar * (dxhat - m1 - xhat * m2)
    dw = (None if weight is None
          else _batch_sum(dy32 * xhat, n_axes).to(weight.dtype))
    db = None if bias is None else _batch_sum(dy32, n_axes).to(bias.dtype)
    return dx.to(dy.dtype), dw, db


class LayerNormFunction(torch.autograd.Function):
    """LayerNorm over ``normalized_shape`` with the JAX package's backward;
    ``weight`` and ``bias`` may be ``None``."""

    @staticmethod
    def forward(ctx, x, weight, bias, normalized_shape, eps, memory_efficient):
        axes = _norm_axes(x, normalized_shape)
        y, xhat, invvar = _ln_fwd_math(x, weight, bias, axes, eps)
        ctx.save_for_backward(y if memory_efficient else xhat, weight, bias,
                              invvar)
        ctx.n_axes = len(axes)
        ctx.eps = eps
        ctx.memory_efficient = memory_efficient
        return y

    @staticmethod
    def backward(ctx, dy):
        saved, weight, bias, invvar = ctx.saved_tensors
        dx, dw, db = _ln_bwd_math(saved, weight, bias, invvar, dy, ctx.n_axes,
                                  ctx.eps, ctx.memory_efficient)
        return dx, dw, db, None, None, None


def _records(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def fused_layer_norm_affine(x, weight, bias, normalized_shape: Shape,
                            eps: float = 1e-5, memory_efficient: bool = False):
    """LayerNorm over the trailing ``normalized_shape`` dims: statistics
    and affine in fp32, the result in ``x``'s dtype; differentiable in x,
    weight and bias (either may be ``None``).

    Only a call that autograd records goes through the Function; any
    other (the serving path, under ``no_grad``) is the plain forward and
    saves nothing for a backward."""
    if _records(x, weight, bias):
        return LayerNormFunction.apply(x, weight, bias, normalized_shape, eps,
                                       memory_efficient)
    return _ln_fwd_math(x, weight, bias, _norm_axes(x, normalized_shape),
                        eps)[0]


def fused_layer_norm(x, normalized_shape: Shape, eps: float = 1e-5,
                     memory_efficient: bool = False):
    """Non-affine LayerNorm."""
    return fused_layer_norm_affine(x, None, None, normalized_shape, eps,
                                   memory_efficient)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def _rms_fwd_math(x, weight, axes, eps):
    x32 = x.float()
    ms = x32.square().mean(dim=axes, keepdim=True)
    invvar = torch.rsqrt(ms + eps)
    xhat = x32 * invvar
    y = xhat * weight.float() if weight is not None else xhat
    return y.to(x.dtype), xhat, invvar


def _rms_bwd_math(saved, weight, invvar, dy, n_axes, eps, memory_efficient):
    """``(dx, dw)`` from what the forward saved (``x_hat``, or the output
    when ``memory_efficient``)."""
    dy32 = dy.float()
    axes = tuple(range(dy.dim() - n_axes, dy.dim()))
    if memory_efficient:
        y32 = saved.float()
        xhat = (y32 / _clamp_by_magnitude(weight.float(), eps)
                if weight is not None else y32)
    else:
        xhat = saved
    dxhat = dy32 * weight.float() if weight is not None else dy32
    # dx = invvar * (dxhat - xhat * mean(dxhat * xhat))
    m = (dxhat * xhat).mean(dim=axes, keepdim=True)
    dx = invvar * (dxhat - xhat * m)
    dw = (None if weight is None
          else _batch_sum(dy32 * xhat, n_axes).to(weight.dtype))
    return dx.to(dy.dtype), dw


class RMSNormFunction(torch.autograd.Function):
    """RMSNorm over ``normalized_shape`` with the JAX package's backward;
    ``weight`` may be ``None``."""

    @staticmethod
    def forward(ctx, x, weight, normalized_shape, eps, memory_efficient):
        axes = _norm_axes(x, normalized_shape)
        y, xhat, invvar = _rms_fwd_math(x, weight, axes, eps)
        ctx.save_for_backward(y if memory_efficient else xhat, weight, invvar)
        ctx.n_axes = len(axes)
        ctx.eps = eps
        ctx.memory_efficient = memory_efficient
        return y

    @staticmethod
    def backward(ctx, dy):
        saved, weight, invvar = ctx.saved_tensors
        dx, dw = _rms_bwd_math(saved, weight, invvar, dy, ctx.n_axes, ctx.eps,
                               ctx.memory_efficient)
        return dx, dw, None, None, None


def fused_rms_norm_affine(x, weight, normalized_shape: Shape,
                          eps: float = 1e-5, memory_efficient: bool = False):
    """RMSNorm over the trailing ``normalized_shape`` dims, fp32
    statistics, the result in ``x``'s dtype; differentiable in x and
    weight (which may be ``None``)."""
    if _records(x, weight):
        return RMSNormFunction.apply(x, weight, normalized_shape, eps,
                                     memory_efficient)
    return _rms_fwd_math(x, weight, _norm_axes(x, normalized_shape), eps)[0]


def fused_rms_norm(x, normalized_shape: Shape, eps: float = 1e-5,
                   memory_efficient: bool = False):
    """Non-affine RMSNorm."""
    return fused_rms_norm_affine(x, None, normalized_shape, eps,
                                 memory_efficient)


def manual_rms_norm(x, normalized_shape: Shape, weight, eps):
    """The reference's plain fallback: the normalised row is cast to
    ``x``'s dtype *before* the weight multiply, so a bf16 ``x`` with an
    fp32 weight returns fp32."""
    axes = _norm_axes(x, normalized_shape)
    x32 = x.float()
    norm = x32.square().mean(dim=axes, keepdim=True)
    out = (x32 * torch.rsqrt(norm + eps)).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class _Norm(nn.Module):
    """The fields of the JAX modules (``normalized_shape``, ``eps``,
    ``elementwise_affine``, ``memory_efficient``, ``param_dtype``) and
    their parameter names, ``scale`` (ones) and ``bias`` (zeros), kept in
    ``param_dtype``; ``device`` defaults to the CUDA device."""

    has_bias = True

    def __init__(self, normalized_shape: Shape, eps: float = 1e-5,
                 elementwise_affine: bool = True,
                 memory_efficient: bool = False, param_dtype=torch.float32,
                 *, device=None):
        super().__init__()
        self.normalized_shape = _as_shape(normalized_shape)
        self.eps = eps
        self.elementwise_affine = elementwise_affine
        self.memory_efficient = memory_efficient
        self.param_dtype = param_dtype
        kw = dict(dtype=param_dtype, device=resolve_device(device))
        if elementwise_affine:
            self.scale = nn.Parameter(torch.ones(self.normalized_shape, **kw))
        else:
            self.register_parameter("scale", None)
        if elementwise_affine and self.has_bias:
            self.bias = nn.Parameter(torch.zeros(self.normalized_shape, **kw))
        else:
            self.register_parameter("bias", None)


class FusedLayerNorm(_Norm):
    """Module form of :func:`fused_layer_norm_affine` (non-affine when
    ``elementwise_affine`` is False)."""

    def forward(self, x):
        return fused_layer_norm_affine(x, self.scale, self.bias,
                                       self.normalized_shape, self.eps,
                                       self.memory_efficient)


class FusedRMSNorm(_Norm):
    """Module form of :func:`fused_rms_norm_affine` (``scale`` only)."""

    has_bias = False

    def forward(self, x):
        return fused_rms_norm_affine(x, self.scale, self.normalized_shape,
                                     self.eps, self.memory_efficient)


class MixedFusedLayerNorm(FusedLayerNorm):
    """Mixed-dtype LayerNorm: fp32 parameters on half inputs.  The
    functional core already computes in fp32 and returns the input dtype,
    so this is :class:`FusedLayerNorm` with fp32 parameters pinned."""

    def __init__(self, normalized_shape: Shape, eps: float = 1e-5,
                 elementwise_affine: bool = True,
                 memory_efficient: bool = False, *, device=None):
        super().__init__(normalized_shape, eps, elementwise_affine,
                         memory_efficient, torch.float32, device=device)


class MixedFusedRMSNorm(FusedRMSNorm):
    """Mixed-dtype RMSNorm: :class:`FusedRMSNorm` with fp32 parameters
    pinned."""

    def __init__(self, normalized_shape: Shape, eps: float = 1e-5,
                 elementwise_affine: bool = True,
                 memory_efficient: bool = False, *, device=None):
        super().__init__(normalized_shape, eps, elementwise_affine,
                         memory_efficient, torch.float32, device=device)
