"""Gradient clipping by the global norm (port of
:mod:`apex_tpu.optimizers.clip_grad`, the ``apex.contrib.clip_grad``
analog).

:func:`global_grad_norm` is the fp32 norm of a gradient tree (2, inf or
any p); :func:`clip_grad_norm` scales every gradient by
``min(max_norm / (total + 1e-6), 1)`` and casts it back to its dtype,
returning the new tree and the norm, as the reference does (functionally:
the gradients given are not changed).
"""

from __future__ import annotations

from typing import Tuple

import torch

from apex_tpu_torch.amp._tree import tree_map
from apex_tpu_torch.utils.tree import tree_flatten, tree_l2_norm

__all__ = ["clip_grad_norm", "global_grad_norm"]


def global_grad_norm(grads, norm_type: float = 2.0) -> torch.Tensor:
    """The global ``norm_type`` norm of ``grads``' leaves in fp32 (0-d;
    0 for a tree without leaves)."""
    leaves = [torch.as_tensor(x).float() for x in tree_flatten(grads)[0]]
    if not leaves:
        return torch.tensor(0.0)
    if norm_type == float("inf"):
        return torch.stack([x.abs().max() for x in leaves]).max()
    if norm_type == 2.0:
        return tree_l2_norm(leaves)
    acc = torch.stack([(x.abs() ** norm_type).sum() for x in leaves]).sum()
    return acc ** (1.0 / norm_type)


def clip_grad_norm(grads, max_norm: float,
                   norm_type: float = 2.0) -> Tuple[object, torch.Tensor]:
    """``(clipped, total_norm)``: every gradient times
    ``min(max_norm / (total + 1e-6), 1)`` in fp32, cast back to its own
    dtype (a branchless select, no host sync)."""
    total = global_grad_norm(grads, norm_type)
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    clipped = tree_map(lambda g: (g.float() * coef).to(g.dtype), grads)
    return clipped, total
