"""Shared update math of the fused optimizers (port of
:mod:`apex_tpu.optimizers._common`).

The reference's optimizers are one CUDA ``multi_tensor_apply`` launch per
op over lists of tensors; the JAX package keeps the semantics and lets
XLA fuse the leaves.  Here the same semantics run over lists of tensors
(the JAX pytrees' leaves) with ``torch._foreach_*`` ops, in place, one
launch per op for the whole list:

- the update math in fp32 whatever the storage dtype;
- optional fp32 master parameters kept in the optimizer state;
- the loss-scale division folded into the gradients;
- the overflow skip as a select on the device (``torch.where`` on a 0-d
  bool tensor), never a host branch, and a step counter that advances
  only on applied updates.

A scalar here (``lr``, a bias correction, a scale) is a Python number or
a 0-d tensor on the lists' device.
"""

from __future__ import annotations

from typing import Callable, List

import torch

__all__ = ["adam_apply", "scale_grads", "resolve_master", "finalize_params",
           "cast_like", "apply_skip", "advance_step", "tree_map_flat"]

Tensors = List[torch.Tensor]


def adam_apply(p: Tensors, g: Tensors, m: Tensors, v: Tensors, *, lr, b1: float,
               b2: float, eps: float, wd: float, bc1, bc2,
               adam_w_mode: bool) -> None:
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
    if isinstance(lr, torch.Tensor):
        torch._foreach_mul_(update, lr)
        torch._foreach_sub_(p, update)
    else:
        torch._foreach_add_(p, update, alpha=-lr)


def scale_grads(grads: Tensors, grad_scale=None) -> Tensors:
    """The gradients in fp32, multiplied by ``1 / grad_scale`` (taken in
    fp32) when a scale is given: the loss-scale division folded into the
    update (``div_scale`` of ``multi_tensor_adam``).  An fp32 gradient
    with no scale is returned as it is, not copied."""
    if grad_scale is None:
        return [g.float() for g in grads]
    inv = 1.0 / torch.as_tensor(grad_scale, dtype=torch.float32,
                                device=grads[0].device)
    return [g.float() * inv for g in grads]


def resolve_master(params: Tensors, master, use_master: bool) -> Tensors:
    """The fp32 list the update runs on: the masters, or the parameters
    themselves where they are fp32 and fp32 copies where they are not."""
    if use_master:
        return master
    return [p.float() for p in params]


def finalize_params(p32: Tensors, params: Tensors) -> None:
    """Write the stepped fp32 values into every parameter that is not
    itself one of them, cast to its own dtype
    (``_master_params_to_model_params``)."""
    for p, new in zip(params, p32):
        if new is not p:
            p.copy_(new)


def cast_like(new: Tensors, ref: Tensors) -> Tensors:
    """``new`` cast to the dtypes of ``ref``."""
    return [n.to(r.dtype) for n, r in zip(new, ref)]


def apply_skip(skip_update, new: Tensors, old: Tensors) -> None:
    """Where ``skip_update`` (a 0-d bool tensor on the lists' device) is
    True, put the old values back into ``new`` in place (the kernels'
    ``noop_flag`` early-out; the amp skip step)."""
    for n, o in zip(new, old):
        n.copy_(torch.where(skip_update, o, n))


def advance_step(step, skip_update):
    """The step counter after an update: ``step + 1``, or, with a
    ``skip_update`` tensor, ``step`` where it is True, so that the bias
    corrections count applied updates only."""
    if skip_update is None:
        return step + 1
    return step + torch.where(skip_update, 0, 1)


def tree_map_flat(fn: Callable, *lists: Tensors) -> None:
    """Run the in-place list update ``fn`` once over one flat fp32 buffer
    per list (each a one-element list), then write every buffer back into
    its list's tensors in their dtypes: the ``multi_tensor_apply`` shape,
    one wide launch per op instead of one per tensor, at the cost of a
    pack and an unpack.  Only for purely elementwise ``fn``."""
    sizes = [t.numel() for t in lists[0]]
    bufs = [torch.cat([t.reshape(-1).float() for t in ts]) for ts in lists]
    fn(*([b] for b in bufs))
    for ts, buf in zip(lists, bufs):
        for t, piece in zip(ts, buf.split(sizes)):
            t.copy_(piece.view_as(t))
