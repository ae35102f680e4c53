"""Fused bias/residual/LayerNorm epilogue of the serving layers: the CUDA
kernel, its plain PyTorch version, and the unfused twin.

Port of :mod:`apex_tpu.serving.fused_ops`.  Between the attention
projection and the MLP sit four row operations: the skip-bias add, the
residual add, the upcast and a LayerNorm.  :func:`fused_residual_norm`
does them in one pass (K3 of the port, ``csrc/fused_residual_norm.cu``)
on CUDA tensors and runs :func:`residual_norm_plain`, which repeats the
kernel's arithmetic, on CPU tensors.  :func:`residual_norm_unfused` is
the reference's separate-ops lowering (``fuse_epilogue=False`` of the
decode model and the engine): it adds the skip bias in ``x``'s dtype,
before the upcast, so with a bf16 bias it rounds where the kernel does
not.  Forward only: nothing differentiates the serving path.
"""

from __future__ import annotations

from typing import Tuple

import torch

from apex_tpu_torch import _build

__all__ = ["fused_residual_norm", "residual_norm_plain",
           "residual_norm_unfused"]

# launches of the kernel since the count was last set to 0
RESIDUAL_NORM_LAUNCHES = 0

# the widest row the kernel takes (a CTA of 1024 threads, 32 values each)
MAX_HIDDEN = 32768

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check(x, residual, weight, bias_ln, bias, block_rows):
    """The reference's operand rules; returns ``hidden``."""
    if type(block_rows) is not int or block_rows < 1:
        raise ValueError(f"block_rows must be a positive int, got "
                         f"{block_rows!r}")
    if x.shape != residual.shape:
        raise ValueError(
            f"x {tuple(x.shape)} and residual {tuple(residual.shape)} differ")
    if x.dim() == 0:
        raise ValueError("x must have at least one dim")
    if x.dtype not in _DTYPE_CODES or residual.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"x and residual must be float32, bfloat16 or float16, got "
            f"{x.dtype}/{residual.dtype}")
    hidden = x.shape[-1]
    for name, t in (("weight", weight), ("bias_ln", bias_ln)):
        if (t.dtype is not torch.float32 and t.dtype is not x.dtype) \
                or t.shape != (hidden,):
            raise TypeError(f"{name} must be float32 or {x.dtype} "
                            f"[{hidden}], got {t.dtype} {tuple(t.shape)}")
    if bias is not None and (bias.dtype is not x.dtype
                             or bias.shape != (hidden,)):
        raise TypeError(f"bias must be {x.dtype} [{hidden}], got "
                        f"{bias.dtype} {tuple(bias.shape)}")
    return hidden


def fused_residual_norm(x, residual, weight, bias_ln, *, bias=None,
                        eps: float = 1e-5, block_rows: int = 256
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``normed, new_residual = LN(x [+ bias] + residual), x [+ bias] + residual``.

    ``x``/``residual``: ``[..., hidden]``, each fp32, bf16 or fp16;
    ``weight``/``bias_ln``: the LayerNorm affine parameters, fp32 or in
    ``x``'s dtype; ``bias``: optional skip bias of the preceding
    row-parallel linear, in ``x``'s dtype.  Every operand enters the
    arithmetic as fp32 (the adds, the fp32 statistics, ``* w + b``);
    ``normed`` keeps ``x``'s dtype and the new residual ``residual``'s.

    ``block_rows`` is the reference's row tile on the TPU.  It must be a
    positive int, as there, and is otherwise unused: the kernel chooses
    its own rows per CTA (a row per warp up to 1024 values, a CTA per row
    above) and the plain version takes every row at once."""
    global RESIDUAL_NORM_LAUNCHES
    hidden = _check(x, residual, weight, bias_ln, bias, block_rows)
    device = x.device
    if device.type == "cpu":
        return residual_norm_plain(x, residual, weight, bias_ln, bias=bias,
                                   eps=eps)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    if hidden > MAX_HIDDEN or hidden < 1:
        raise ValueError(
            f"hidden {hidden} outside the kernel's 1..{MAX_HIDDEN}")
    for name, t in (("x", x), ("residual", residual), ("weight", weight),
                    ("bias_ln", bias_ln), ("bias", bias)):
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, x on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if weight.dtype is not bias_ln.dtype:  # one parameter type for the kernel
        weight, bias_ln = weight.float(), bias_ln.float()
    normed = torch.empty_like(x)
    new_residual = torch.empty_like(residual)
    rows = x.numel() // hidden
    if rows == 0:
        return normed, new_residual
    with torch.cuda.device(device):
        rc = _build.library().apex_fused_residual_norm(
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[residual.dtype],
            _DTYPE_CODES[weight.dtype], x.data_ptr(), residual.data_ptr(),
            None if bias is None else bias.data_ptr(), weight.data_ptr(),
            bias_ln.data_ptr(), normed.data_ptr(), new_residual.data_ptr(),
            rows, hidden, float(eps),
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(
            f"fused residual norm kernel launch failed: CUDA error {rc}")
    RESIDUAL_NORM_LAUNCHES += 1
    return normed, new_residual


def _layer_norm_rows(r, weight, bias_ln, eps):
    """LayerNorm of the fp32 rows ``r`` with the two-pass variance."""
    mean = r.mean(dim=-1, keepdim=True)
    rc = r - mean
    var = (rc * rc).mean(dim=-1, keepdim=True)
    y = rc * torch.rsqrt(var + eps)
    return y * weight.float() + bias_ln.float()


def residual_norm_plain(x, residual, weight, bias_ln, *, bias=None,
                        eps: float = 1e-5):
    """Plain PyTorch version of :func:`fused_residual_norm`, with the
    kernel's arithmetic: every add in fp32 after the upcast."""
    r = x.float()
    if bias is not None:
        r = r + bias.float()
    r = r + residual.float()
    y = _layer_norm_rows(r, weight, bias_ln, eps)
    return y.to(x.dtype), r.to(residual.dtype)


def residual_norm_unfused(x, residual, weight, bias_ln, *, bias=None,
                          eps: float = 1e-5):
    """The reference's separate-ops lowering (its A/B baseline): the skip
    bias added in ``x``'s dtype, the residual with torch's type promotion
    (which matches jnp's for these pairs: bf16 + fp32 gives fp32), then
    the upcast and the fp32 LayerNorm.  Plain ops on any device; no
    kernel of the port."""
    r = x if bias is None else x + bias
    r = (r + residual).float()
    y = _layer_norm_rows(r, weight, bias_ln, eps)
    return y.to(x.dtype), r.to(residual.dtype)
