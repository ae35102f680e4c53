"""Fused bias/residual/LayerNorm epilogue of the serving layers: the CUDA
kernel and its plain PyTorch version.

Port of :mod:`apex_tpu.serving.fused_ops`.  Between the attention
projection and the MLP sit four row operations: the skip-bias add, the
residual add, the upcast and a LayerNorm.  :func:`fused_residual_norm`
does them in one pass (K3 of the port, ``csrc/fused_residual_norm.cu``)
on CUDA tensors and runs :func:`residual_norm_plain` on CPU tensors.
Forward only: nothing differentiates the serving path.
"""

from __future__ import annotations

from typing import Tuple

import torch

from apex_tpu_torch import _build

__all__ = ["fused_residual_norm", "residual_norm_plain"]

# launches of the kernel since the count was last set to 0
RESIDUAL_NORM_LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def fused_residual_norm(x, residual, weight, bias_ln, *, bias=None,
                        eps: float = 1e-5
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``normed, new_residual = LN(x [+ bias] + residual), x [+ bias] + residual``.

    ``x``/``residual``: ``[..., hidden]``; ``weight``/``bias_ln``: the
    LayerNorm affine parameters (fp32); ``bias``: optional skip bias of
    the preceding row-parallel linear, in ``x``'s dtype.  ``normed`` keeps
    ``x``'s dtype and the new residual ``residual``'s dtype; statistics
    are fp32."""
    global RESIDUAL_NORM_LAUNCHES
    if x.shape != residual.shape:
        raise ValueError(
            f"x {tuple(x.shape)} and residual {tuple(residual.shape)} differ")
    if x.device.type == "cpu":
        return residual_norm_plain(x, residual, weight, bias_ln, bias=bias,
                                   eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    hidden = x.shape[-1]
    named = dict(x=x, residual=residual, weight=weight, bias_ln=bias_ln,
                 bias=bias)
    for name, t in named.items():
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in _DTYPE_CODES or residual.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"x and residual must be float32 or bfloat16, got "
            f"{x.dtype}/{residual.dtype}")
    for name in ("weight", "bias_ln"):
        t = named[name]
        if t.dtype != torch.float32 or tuple(t.shape) != (hidden,):
            raise TypeError(f"{name} must be float32 [{hidden}]")
    if bias is not None and (bias.dtype != x.dtype
                             or tuple(bias.shape) != (hidden,)):
        raise TypeError(f"bias must be {x.dtype} [{hidden}]")
    normed = torch.empty_like(x)
    new_residual = torch.empty_like(residual)
    fn = _build.library().apex_fused_residual_norm
    with torch.cuda.device(x.device):
        rc = fn(_DTYPE_CODES[x.dtype], _DTYPE_CODES[residual.dtype],
                x.data_ptr(), residual.data_ptr(),
                None if bias is None else bias.data_ptr(),
                weight.data_ptr(), bias_ln.data_ptr(), normed.data_ptr(),
                new_residual.data_ptr(), x.numel() // hidden, hidden,
                float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise RuntimeError(
            f"fused residual norm kernel launch failed: CUDA error {rc}")
    RESIDUAL_NORM_LAUNCHES += 1
    return normed, new_residual


def residual_norm_plain(x, residual, weight, bias_ln, *, bias=None,
                        eps: float = 1e-5):
    """Plain PyTorch version of :func:`fused_residual_norm`, with the
    kernel's arithmetic: every add in fp32 after the upcast."""
    r = x.float()
    if bias is not None:
        r = r + bias.float()
    r = r + residual.float()
    mean = r.mean(dim=-1, keepdim=True)
    rc = r - mean
    var = (rc * rc).mean(dim=-1, keepdim=True)
    y = rc * torch.rsqrt(var + eps)
    y = y * weight.float() + bias_ln.float()
    return y.to(x.dtype), r.to(residual.dtype)
