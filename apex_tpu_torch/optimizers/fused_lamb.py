"""FusedLAMB / FusedMixedPrecisionLamb (port of
:mod:`apex_tpu.optimizers.fused_lamb`).

LAMB in two stages, in fp32 whatever the parameters' dtype:

- the global gradient norm over every gradient of the group; with
  ``max_grad_norm > 0`` each gradient is divided by
  ``max(norm / max_grad_norm, 1)``;
- stage 1, Adam-style moments on the clipped gradient
  (``beta3 = 1 - beta1`` with ``grad_averaging``, else 1): ``adam_w_mode``
  (MODE_1) adds ``wd * p`` to the update, MODE_0 folds it into the
  gradient before the moments;
- stage 2, per tensor, the trust ratio ``||p|| / ||update||`` when both
  norms are nonzero (else 1), applied where ``weight_decay != 0`` or with
  ``use_nvlamb``.

``flat=True`` (the default) runs both stages over one chunked
``(rows, 256)`` buffer per list (:func:`lamb_flat_update`: the norms as
row reductions and segmented sums), ``flat=False`` per tensor.
:func:`lamb_flat_update` keeps the reference's ``reduce=`` hook for the
ZeRO-sharded LAMB, which applies it to the global-norm partial and to the
one stacked vector of per-tensor partials.  ``FusedMixedPrecisionLamb`` is
``FusedLAMB(master_weights=True)``.  ``step(lr=, grad_scale=,
skip_update=)`` and ``opt_state``/``load_opt_state``
(``slots={"exp_avg", "exp_avg_sq"}``) as :class:`FusedAdam`'s.  Plain
torch ops: the reference is plain XLA.
"""

from __future__ import annotations

from typing import Tuple

import torch

from apex_tpu_torch.optimizers._common import (
    FusedOptimizer,
    bias_correction,
)
from apex_tpu_torch.utils.tree import (
    chunked_per_leaf_sumsq,
    chunked_rows,
    flatten_to_chunked,
    tree_l2_norm,
    unflatten_from_chunked,
)

__all__ = ["FusedLAMB", "FusedMixedPrecisionLamb", "lamb_flat_update"]


def _trust_ratio(w_sq, u_sq):
    """``sqrt(w_sq) / sqrt(u_sq)`` where both are nonzero, else 1."""
    both = (w_sq > 0) & (u_sq > 0)
    return torch.where(both, torch.sqrt(w_sq) / torch.sqrt(
        torch.where(u_sq > 0, u_sq, torch.ones_like(u_sq))),
        torch.ones_like(w_sq))


def lamb_flat_update(p32, g, m, v, *, lr, b1, b2, eps, wd, beta3, bc1, bc2,
                     adam_w_mode, use_nvlamb, clip_ratio, reduce=None):
    """Both LAMB stages over one chunked buffer per tree; returns the new
    ``(p32, m, v)`` trees (fp32, the trees' structure).  ``clip_ratio``
    maps the global gradient norm to the clip divisor; ``reduce``, when
    given, sums a partial over the data-parallel ranks (applied to the
    global sum of squares and to the stacked per-tensor sums of squares).
    Padding rows hold zeros, so every norm is exact."""
    pb, meta = flatten_to_chunked(p32)
    gb, _ = flatten_to_chunked(g)
    mb, _ = flatten_to_chunked(m)
    vb, _ = flatten_to_chunked(v)

    g_sq = gb.square().sum()
    if reduce is not None:
        g_sq = reduce(g_sq)
    # the buffers are this call's own copies: update them in place
    gb.div_(clip_ratio(torch.sqrt(g_sq)))
    if wd != 0.0 and not adam_w_mode:
        gb.add_(pb, alpha=wd)                  # MODE_0: L2 into the gradient
    mb.mul_(b1).add_(gb, alpha=beta3)
    vb.mul_(b2).addcmul_(gb, gb, value=1.0 - b2)
    ub = torch.div(mb, bc1).div_(torch.div(vb, bc2).sqrt_().add_(eps))
    if wd != 0.0 and adam_w_mode:
        ub.add_(pb, alpha=wd)                  # MODE_1: decoupled decay
    if wd != 0.0 or use_nvlamb:
        partial = torch.cat([chunked_per_leaf_sumsq(pb, meta),
                             chunked_per_leaf_sumsq(ub, meta)])
        if reduce is not None:
            partial = reduce(partial)
        n = len(meta.shapes)
        ub.mul_(lr * chunked_rows(_trust_ratio(partial[:n], partial[n:]),
                                  meta))
    else:
        ub.mul_(lr)
    pb.sub_(ub)
    f32 = meta._replace(dtypes=(torch.float32,) * len(meta.shapes))
    return tuple(unflatten_from_chunked(b, f32) for b in (pb, mb, vb))


class FusedLAMB(FusedOptimizer):
    """LAMB with the Apex constructor surface."""

    slots = ("exp_avg", "exp_avg_sq")

    def __init__(self, params, lr: float = 1e-3, bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.01, amsgrad: bool = False,
                 adam_w_mode: bool = True, grad_averaging: bool = True,
                 max_grad_norm: float = 1.0, use_nvlamb: bool = False,
                 master_weights: bool = False, flat: bool = True):
        if amsgrad:
            raise RuntimeError(
                "FusedLAMB does not support the AMSGrad variant (as in "
                "apex/optimizers/fused_lamb.py)")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, weight_decay=weight_decay,
                        adam_w_mode=adam_w_mode,
                        grad_averaging=grad_averaging,
                        max_grad_norm=max_grad_norm, use_nvlamb=use_nvlamb)
        super().__init__(params, defaults, master_weights)
        self.flat = flat

    @staticmethod
    def _clip_ratio(max_grad_norm):
        def ratio(global_norm):
            if max_grad_norm and max_grad_norm > 0:
                return torch.clamp(global_norm / max_grad_norm, min=1.0)
            return torch.ones((), device=global_norm.device)
        return ratio

    def _update(self, group, p32, g32, slots, step, lr):
        b1, b2 = group["betas"]
        t = step + 1
        if group["bias_correction"]:
            bc1, bc2 = bias_correction(b1, t), bias_correction(b2, t)
        else:
            bc1 = bc2 = 1.0
        kw = dict(lr=lr, b1=b1, b2=b2, eps=group["eps"],
                  wd=group["weight_decay"],
                  beta3=1.0 - b1 if group["grad_averaging"] else 1.0,
                  bc1=bc1, bc2=bc2, adam_w_mode=group["adam_w_mode"],
                  use_nvlamb=group["use_nvlamb"],
                  clip_ratio=self._clip_ratio(group["max_grad_norm"]))
        m, v = slots["exp_avg"], slots["exp_avg_sq"]
        if self.flat:
            new = lamb_flat_update(p32, g32, m, v, **kw)
        else:
            new = _per_leaf_update(p32, g32, m, v, **kw)
        for olds, news in zip((p32, m, v), new):
            torch._foreach_copy_(olds, list(news))


def _per_leaf_update(p32, g, m, v, *, lr, b1, b2, eps, wd, beta3, bc1, bc2,
                     adam_w_mode, use_nvlamb, clip_ratio):
    """The same two stages tensor by tensor; returns new lists."""
    clip = clip_ratio(tree_l2_norm(g).to(g[0].device))
    out = ([], [], [])
    for p, gi, mi, vi in zip(p32, g, m, v):
        gi = gi / clip
        if wd != 0.0 and not adam_w_mode:
            gi = gi + wd * p
        mi = b1 * mi + beta3 * gi
        vi = b2 * vi + (1.0 - b2) * gi * gi
        u = (mi / bc1) / (torch.sqrt(vi / bc2) + eps)
        if wd != 0.0 and adam_w_mode:
            u = u + wd * p
        if wd != 0.0 or use_nvlamb:
            p = p - lr * _trust_ratio(p.square().sum(), u.square().sum()) * u
        else:
            p = p - lr * u
        for lst, x in zip(out, (p, mi, vi)):
            lst.append(x)
    return out


class FusedMixedPrecisionLamb(FusedLAMB):
    """LAMB with fp32 state for half-precision models: exactly
    ``FusedLAMB(master_weights=True)``; ``lr`` may be a 0-d device tensor
    per step."""

    def __init__(self, *args, **kwargs):
        kwargs["master_weights"] = True
        super().__init__(*args, **kwargs)
