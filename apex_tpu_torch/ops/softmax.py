"""The scale/mask softmax family (port of :mod:`apex_tpu.ops.softmax`).

Megatron's fused softmax analog: ``softmax(scale * x + mask)`` with the
mask applied after scaling, in fp32 whatever the input dtype, the result
cast back to the input dtype.  Each of the three differentiable variants
is a ``torch.autograd.Function`` that saves only its output ``y`` (in
the output dtype), as the JAX package's ``custom_vjp`` rules do, with
the backward ``dx = scale * y * (dy - sum(dy * y))`` in fp32 cast to
``y``'s dtype.

- masks are bool, True meaning "mask out", filled with the finite
  ``-10000.0`` after scaling (never ``-inf``): a fully masked row comes
  out uniform, ``1 / sk``, not NaN;
- the causal variant builds the lower-triangular mask itself and zeroes
  the strict upper triangle of the result;
- :class:`FusedScaleMaskSoftmax` keeps the dispatcher surface.

Plain torch ops: the JAX package computes the family outside Pallas.
"""

from __future__ import annotations

import enum
from typing import Callable, Optional

import torch

__all__ = [
    "AttnMaskType",
    "scaled_softmax",
    "scaled_masked_softmax",
    "scaled_upper_triang_masked_softmax",
    "generic_scaled_masked_softmax",
    "FusedScaleMaskSoftmax",
]


class AttnMaskType(enum.Enum):
    """``apex/transformer/enums.py`` AttnMaskType."""

    padding = 1
    causal = 2


_MASK_FILL = -10000.0  # the reference's attention_mask_func fill


def _softmax_fwd_f32(x32):
    e = torch.exp(x32 - x32.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _softmax_bwd_from_y(y, dy, scale):
    y32, dy32 = y.float(), dy.float()
    inner = dy32 - (dy32 * y32).sum(dim=-1, keepdim=True)
    return (scale * y32 * inner).to(y.dtype)


class _FromOutput(torch.autograd.Function):
    """Shared backward of the three Functions: only ``y`` is saved."""

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        return (_softmax_bwd_from_y(y, dy, ctx.scale),) + (None,) * ctx.n_rest


class _ScaledSoftmax(_FromOutput):
    @staticmethod
    def forward(ctx, x, scale):
        y = _softmax_fwd_f32(x.float() * scale).to(x.dtype)
        ctx.scale, ctx.n_rest = scale, 1
        ctx.save_for_backward(y)
        return y


class _ScaledMaskedSoftmax(_FromOutput):
    @staticmethod
    def forward(ctx, x, mask, scale):
        x32 = x.float() * scale
        if mask is not None:
            x32 = x32.masked_fill(mask, _MASK_FILL)
        y = _softmax_fwd_f32(x32).to(x.dtype)
        ctx.scale, ctx.n_rest = scale, 2
        ctx.save_for_backward(y)
        return y


class _ScaledUpperTriangMaskedSoftmax(_FromOutput):
    @staticmethod
    def forward(ctx, x, scale):
        sq, sk = x.shape[-2], x.shape[-1]
        causal = torch.ones((sq, sk), dtype=torch.bool,
                            device=x.device).tril()
        x32 = (x.float() * scale).masked_fill(~causal, _MASK_FILL)
        # the kernel zeroes the strict upper triangle exactly
        y = _softmax_fwd_f32(x32).masked_fill(~causal, 0.0).to(x.dtype)
        ctx.scale, ctx.n_rest = scale, 1
        ctx.save_for_backward(y)
        return y


def scaled_softmax(x, scale: float = 1.0):
    """``softmax(scale * x)`` over the last dim."""
    return _ScaledSoftmax.apply(x, scale)


def scaled_masked_softmax(x, mask, scale: float = 1.0):
    """``softmax(mask_fill(scale * x))``; ``mask`` is bool (True = masked
    out) and broadcasts against x (``[b, 1, sq, sk]`` against
    ``[b, np, sq, sk]``), or None."""
    return _ScaledMaskedSoftmax.apply(x, mask, scale)


def scaled_upper_triang_masked_softmax(x, scale: float = 1.0):
    """Causal softmax over ``[..., sq, sk]``: the mask is built here, and
    the strict upper triangle of the result is exactly 0."""
    return _ScaledUpperTriangMaskedSoftmax.apply(x, scale)


def generic_scaled_masked_softmax(x, mask, scale: float = 1.0):
    """The no-shape-limit variant: :func:`scaled_masked_softmax`."""
    return scaled_masked_softmax(x, mask, scale)


class FusedScaleMaskSoftmax:
    """The dispatcher with the reference's constructor surface.

    With ``scaled_masked_softmax_fusion`` (the default) a causal mask type
    takes :func:`scaled_upper_triang_masked_softmax` over ``[b * np, sq,
    sk]`` (``sq == sk``; ``mask`` is ignored) and a padding mask type
    :func:`scaled_masked_softmax`.  Without it, the unfused fallback
    follows the reference's behaviour as it is:

    - it upcasts to fp32 only when ``input_in_float16`` (either half
      flag) and ``softmax_in_fp32`` are set, else the softmax runs in
      x's own dtype (the JAX ``jax.nn.softmax`` ops, each rounding);
    - it applies no causal mask when ``mask`` is None, whatever
      ``attn_mask_type`` says;
    - after an upcast it casts back to the *declared* half dtype (fp16
      or bf16 by the flag), not to x's dtype.

    No shape gate: :meth:`is_kernel_available` returns
    ``scaled_masked_softmax_fusion``."""

    def __init__(self, input_in_fp16: bool = False,
                 input_in_bf16: bool = True,
                 attn_mask_type: AttnMaskType = AttnMaskType.padding,
                 scaled_masked_softmax_fusion: bool = True,
                 mask_func: Optional[Callable] = None,
                 softmax_in_fp32: bool = True,
                 scale: Optional[float] = None):
        if input_in_fp16 and input_in_bf16:
            raise RuntimeError(
                "both fp16 and bf16 flags cannot be active at the same time.")
        self.input_in_fp16 = input_in_fp16
        self.input_in_bf16 = input_in_bf16
        self.input_in_float16 = input_in_fp16 or input_in_bf16
        self.attn_mask_type = attn_mask_type
        self.scaled_masked_softmax_fusion = scaled_masked_softmax_fusion
        self.mask_func = mask_func
        self.softmax_in_fp32 = softmax_in_fp32
        self.scale = scale
        if not (scale is None or softmax_in_fp32):
            raise RuntimeError("softmax should be in fp32 when scaled")

    def is_kernel_available(self, mask, b, np_, sq, sk) -> bool:
        return self.scaled_masked_softmax_fusion

    def __call__(self, x, mask):
        if x.dim() != 4:
            raise ValueError(f"expected [b, np, sq, sk], got {tuple(x.shape)}")
        scale = self.scale if self.scale is not None else 1.0
        if self.scaled_masked_softmax_fusion:
            if self.attn_mask_type == AttnMaskType.causal:
                b, np_, sq, sk = x.shape
                if sq != sk:
                    raise ValueError(
                        f"causal mask requires sq == sk, got {sq} and {sk}")
                y = scaled_upper_triang_masked_softmax(
                    x.reshape(b * np_, sq, sk), scale)
                return y.reshape(b, np_, sq, sk)
            return scaled_masked_softmax(x, mask, scale)
        upcast = self.input_in_float16 and self.softmax_in_fp32
        if upcast:
            x = x.float()
        if self.scale is not None:
            x = x * self.scale
        if mask is not None and self.mask_func is not None:
            x = self.mask_func(x, mask)
        elif mask is not None:
            x = x.masked_fill(mask, _MASK_FILL)
        e = torch.exp(x - x.amax(dim=-1, keepdim=True))
        probs = e / e.sum(dim=-1, keepdim=True)
        if upcast:
            probs = probs.to(torch.float16 if self.input_in_fp16
                             else torch.bfloat16)
        return probs
