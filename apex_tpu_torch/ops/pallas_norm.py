"""Row LayerNorm and RMSNorm with a hand-written forward kernel and the
analytic backward: the CUDA kernels and their plain PyTorch versions.

Port of :mod:`apex_tpu.ops.pallas_norm`.  Two kernels carry it, N1 and
N2 of the port (``csrc/row_norm.cu``; the source's note says how they
are built):

- N1, :func:`pallas_layer_norm`: per row, fp32 mean, the two-pass
  centred variance, ``rsqrt(var + eps)``, ``* w + b`` in fp32, one cast
  to ``x``'s dtype;
- N2, :func:`pallas_rms_norm`: per row, fp32 ``mean(x^2)``,
  ``x * rsqrt(ms + eps) * w`` in fp32, one cast to ``x``'s dtype.

``x`` is ``[..., hidden]`` of fp32, bf16 or fp16: leading dims are
flattened to rows, a 1-D ``x`` is one row, a non-contiguous ``x`` is made
contiguous, and the output has ``x``'s shape and dtype.  The parameters
are ``[hidden]`` of any float dtype and enter the arithmetic as fp32; the
kernel reads them as fp32 or in ``x``'s dtype, and the wrapper casts any
other pair to fp32 first, as the arithmetic would.  On CUDA tensors each
wrapper launches its kernel (hidden 1 to :data:`MAX_HIDDEN`; anything
else raises); on CPU tensors it runs the plain version beside it
(:func:`layer_norm_plain`, :func:`rms_norm_plain`), which repeats the
kernels' arithmetic.  A CPU tensor is the port's counterpart of the JAX
module's interpret mode, and the TPU's row tiling (``block_rows``) means
nothing to the kernels, which choose their own rows per CTA (a row per
warp up to 4096 bf16, a CTA per row above), so neither knob is ported.
:func:`is_available` keeps the reference's answers for callers that
gate on it; the wrappers never consult it.

Each entry is a :class:`torch.autograd.Function` that saves its inputs
``(x, weight, bias)``, as the JAX ``custom_vjp`` does, and whose backward
is the vector-Jacobian product of
:func:`~apex_tpu_torch.normalization.fused_layer_norm_affine` /
:func:`~apex_tpu_torch.normalization.fused_rms_norm_affine` at ``x``
(``memory_efficient=False``): plain torch ops that recompute the
statistics, launch no kernel, and so give the same gradients whichever
forward ran.  ``dx`` has the cotangent's dtype, ``dw`` and ``db`` the
parameters'.
"""

from __future__ import annotations

import torch

from apex_tpu_torch import _build
from apex_tpu_torch.normalization.fused_layer_norm import (
    fused_layer_norm_affine,
    fused_rms_norm_affine,
)

__all__ = [
    "is_available",
    "pallas_layer_norm",
    "pallas_rms_norm",
    "layer_norm_plain",
    "rms_norm_plain",
    "LayerNormKernelFunction",
    "RMSNormKernelFunction",
    "MAX_HIDDEN",
]

# launches of each kernel since its count was last set to 0
LAYER_NORM_LAUNCHES = 0
RMS_NORM_LAUNCHES = 0

# the widest row the kernels take (a CTA of 1024 threads, eight 16-byte
# chunks or 32 single values a thread)
MAX_HIDDEN = 32768

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def is_available(hidden: int) -> bool:
    """The reference's shape gate (a multiple of the TPU's 128 lanes)."""
    return hidden % 128 == 0


# ------------------------------------------------------------ plain


def layer_norm_plain(x, weight, bias, eps: float = 1e-5):
    """Plain PyTorch version of N1, with the kernel's arithmetic."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    xc = x32 - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(x.dtype)


def rms_norm_plain(x, weight, eps: float = 1e-5):
    """Plain PyTorch version of N2, with the kernel's arithmetic."""
    x32 = x.float()
    ms = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(ms + eps)
    y = y * weight.float()
    return y.to(x.dtype)


# ----------------------------------------------------------- kernels


def _row_norm(x, params, eps):
    """Launch N1 (``params`` = (weight, bias)) or N2 (``(weight,)``) on a
    CUDA ``x``; returns ``y``."""
    global LAYER_NORM_LAUNCHES, RMS_NORM_LAUNCHES
    rms = len(params) == 1
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dim() == 0:
        raise ValueError("x must have at least one dim")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32, bfloat16 or float16, got {x.dtype}")
    hidden = x.shape[-1]
    if not 1 <= hidden <= MAX_HIDDEN:
        raise ValueError(f"hidden {hidden} outside the kernel's 1..{MAX_HIDDEN}")
    for name, t in zip(("weight", "bias"), params):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_floating_point() or tuple(t.shape) != (hidden,):
            raise TypeError(f"{name} must be a float [{hidden}], got "
                            f"{t.dtype} {tuple(t.shape)}")
    p_dtype = (x.dtype if all(t.dtype == x.dtype for t in params)
               else torch.float32)
    params = [t.to(p_dtype).contiguous() for t in params]
    x = x.contiguous()
    y = torch.empty_like(x)
    rows = x.numel() // hidden
    if rows == 0:
        return y
    w = params[0]
    b = None if rms else params[1]
    fn = _build.library().apex_row_norm
    with torch.cuda.device(x.device):
        rc = fn(int(rms), _DTYPE_CODES[x.dtype], _DTYPE_CODES[p_dtype],
                x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
                y.data_ptr(), rows, hidden, float(eps),
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise RuntimeError(
            f"row {'RMS' if rms else 'layer'} norm kernel launch failed: "
            f"CUDA error {rc}")
    if rms:
        RMS_NORM_LAUNCHES += 1
    else:
        LAYER_NORM_LAUNCHES += 1
    return y


def _layer_norm_forward(x, weight, bias, eps):
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps)
    return _row_norm(x, (weight, bias), eps)


def _rms_norm_forward(x, weight, eps):
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, eps)
    return _row_norm(x, (weight,), eps)


def _vjp(fn, primals, dy):
    """Gradients of ``fn(*primals)`` with cotangent ``dy``."""
    leaves = [t.detach().requires_grad_() for t in primals]
    with torch.enable_grad():
        y = fn(*leaves)
    return torch.autograd.grad(y, leaves, dy)


class LayerNormKernelFunction(torch.autograd.Function):
    """N1's forward (``forward_fn(x, weight, bias, eps)``; the entry point
    passes the kernel launcher) and the analytic LayerNorm backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, forward_fn):
        ctx.save_for_backward(x, weight, bias)
        ctx.eps = eps
        return forward_fn(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias = ctx.saved_tensors
        hidden = (x.shape[-1],)
        grads = _vjp(lambda x_, w_, b_: fused_layer_norm_affine(
            x_, w_, b_, hidden, ctx.eps), (x, weight, bias), dy)
        return (*grads, None, None)


class RMSNormKernelFunction(torch.autograd.Function):
    """N2's forward (``forward_fn(x, weight, eps)``) and the analytic
    RMSNorm backward."""

    @staticmethod
    def forward(ctx, x, weight, eps, forward_fn):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return forward_fn(x, weight, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        hidden = (x.shape[-1],)
        grads = _vjp(lambda x_, w_: fused_rms_norm_affine(
            x_, w_, hidden, ctx.eps), (x, weight), dy)
        return (*grads, None, None)


def pallas_layer_norm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm over the last dim through N1, differentiable in x,
    weight and bias."""
    return LayerNormKernelFunction.apply(x, weight, bias, eps,
                                         _layer_norm_forward)


def pallas_rms_norm(x, weight, eps: float = 1e-5):
    """RMSNorm over the last dim through N2, differentiable in x and
    weight."""
    return RMSNormKernelFunction.apply(x, weight, eps, _rms_norm_forward)
