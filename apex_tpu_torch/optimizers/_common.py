"""Shared update math of the fused optimizers (port of
:mod:`apex_tpu.optimizers._common`).

The reference's optimizers are one CUDA ``multi_tensor_apply`` launch per
op over lists of tensors; the JAX package keeps the semantics (fp32 math
whatever the storage dtype) and lets XLA fuse the leaves.  Here the same
math runs over lists of fp32 tensors with ``torch._foreach_*`` ops, in
place: one launch per op for the whole list.
"""

from __future__ import annotations

from typing import List

import torch

__all__ = ["adam_apply"]


def adam_apply(p: List[torch.Tensor], g: List[torch.Tensor],
               m: List[torch.Tensor], v: List[torch.Tensor], *, lr: float,
               b1: float, b2: float, eps: float, wd: float, bc1: float,
               bc2: float, adam_w_mode: bool) -> None:
    """One Adam/AdamW update of the fp32 lists ``p``, ``m``, ``v`` in
    place, from the fp32 gradients ``g`` (``csrc/multi_tensor_adam.cu``
    ``ADAM_MODE_0`` folds ``wd * p`` into the gradient, ``ADAM_MODE_1``
    decouples the decay into the update)::

        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        p = p - lr * ((m / bc1) / (sqrt(v / bc2) + eps) [+ wd * p])
    """
    if not adam_w_mode and wd != 0.0:
        g = torch._foreach_add(g, p, alpha=wd)
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, g, alpha=1.0 - b1)
    torch._foreach_mul_(v, b2)
    torch._foreach_addcmul_(v, g, g, value=1.0 - b2)
    denom = torch._foreach_div(v, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    update = torch._foreach_div(m, bc1)
    torch._foreach_div_(update, denom)
    if adam_w_mode and wd != 0.0:
        torch._foreach_add_(update, p, alpha=wd)
    torch._foreach_add_(p, update, alpha=-lr)
