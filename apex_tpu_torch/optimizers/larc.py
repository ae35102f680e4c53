"""LARC, layer-wise adaptive rate control (port of
:mod:`apex_tpu.optimizers.larc`; also ``apex_tpu_torch.parallel.LARC``).

Per tensor, with ``wd`` the weight decay LARC took over::

    adaptive = trust_coefficient * ||p|| / (||g|| + wd * ||p|| + eps)
    if clip: adaptive = min(adaptive / lr, 1)
    g = (g + wd * p) * adaptive

and the gradient passes untouched (no decay either) where ``||p||`` or
``||g||`` is 0.  :meth:`LARC.transform_grads` is that transform on a tree
of gradients (fp32 out, whatever the dtype in); ``flat=True`` (the
default) takes every tensor's two norms from one chunked buffer per tree,
``flat=False`` tensor by tensor.

As a wrapper, ``LARC(optimizer)`` takes over each parameter group's
weight decay (the group's is set to 0; a group without one uses
``weight_decay``) and its ``step(lr=, grad_scale=, **kw)`` divides the
gradients by ``grad_scale`` first (LARC's norms are of the true
gradients), transforms them and hands them, fp32, to the inner
optimizer's ``step(lr=lr, grads=..., **kw)``.  Every other attribute
(``param_groups``, ``zero_grad``, ``opt_state``, ...) is the inner
optimizer's.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.optimizers._common import scale_grads, tree_map_multi
from apex_tpu_torch.utils.tree import (
    chunked_per_leaf_sumsq,
    chunked_rows,
    flatten_to_chunked,
    unflatten_from_chunked,
)

__all__ = ["LARC"]


class LARC:
    """The LARC gradient transform, and a wrapper around an optimizer."""

    def __init__(self, optimizer=None, trust_coefficient: float = 0.02,
                 clip: bool = True, eps: float = 1e-8,
                 weight_decay: float = 0.0, flat: bool = True):
        self.optim = optimizer
        self.trust_coefficient = trust_coefficient
        self.clip = clip
        self.eps = eps
        self.weight_decay = weight_decay
        self.flat = flat
        self._group_wd = []
        if optimizer is not None:
            for group in optimizer.param_groups:
                self._group_wd.append(group.get("weight_decay", 0.0)
                                      or weight_decay)
                group["weight_decay"] = 0.0

    def __getattr__(self, name):
        if name == "optim":
            raise AttributeError(name)
        return getattr(self.optim, name)

    def _adaptive(self, p_norm, g_norm, lr, wd):
        adaptive = self.trust_coefficient * p_norm / (
            g_norm + p_norm * wd + self.eps)
        if self.clip:
            adaptive = torch.clamp(adaptive / lr, max=1.0)
        return adaptive, (p_norm != 0) & (g_norm != 0)

    def transform_grads(self, grads, params, *, lr, weight_decay=None):
        """Each gradient of the tree ``grads`` scaled by its adaptive rate
        (``params`` the tree of the parameters, ``lr`` this step's rate);
        fp32 leaves.  ``weight_decay`` defaults to LARC's own."""
        wd = self.weight_decay if weight_decay is None else weight_decay
        if self.flat:
            pb, meta = flatten_to_chunked(params)
            gb, _ = flatten_to_chunked(grads)
            adaptive, keep = self._adaptive(
                torch.sqrt(chunked_per_leaf_sumsq(pb, meta)),
                torch.sqrt(chunked_per_leaf_sumsq(gb, meta)), lr, wd)
            out = torch.where(chunked_rows(keep, meta),
                              (gb + wd * pb) * chunked_rows(adaptive, meta),
                              gb)
            return unflatten_from_chunked(out, meta._replace(
                dtypes=(torch.float32,) * len(meta.shapes)))

        def leaf(g, p):
            g, p = g.float(), p.float()
            adaptive, keep = self._adaptive(torch.sqrt(p.square().sum()),
                                            torch.sqrt(g.square().sum()),
                                            lr, wd)
            return (torch.where(keep, (g + wd * p) * adaptive, g),)

        return tree_map_multi(leaf, 1, grads, params)[0]

    @torch.no_grad()
    def step(self, closure=None, *, lr=None, grad_scale=None, **kw):
        """Transform every group's gradients (unscaled first by
        ``grad_scale``) and step the inner optimizer on them."""
        if self.optim is None:
            raise ValueError("LARC used as a wrapper needs an optimizer")
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        grads = {}
        for group, wd in zip(self.optim.param_groups, self._group_wd):
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            g32 = [p.grad for p in params]
            if grad_scale is not None:
                g32 = scale_grads(g32, grad_scale)
            new = self.transform_grads(
                g32, [p.detach() for p in params],
                lr=group["lr"] if lr is None else lr, weight_decay=wd)
            grads.update(zip(params, new))
        self.optim.step(lr=lr, grads=grads, **kw)
        return loss
