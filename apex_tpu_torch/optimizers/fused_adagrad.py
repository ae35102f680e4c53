"""FusedAdagrad (port of :mod:`apex_tpu.optimizers.fused_adagrad`).

In fp32 whatever the parameters' dtype: ``adagrad_w_mode=False`` (the
default, L2) ``g += wd * p; h += g * g; p -= lr * g / (sqrt(h) + eps)``;
``adagrad_w_mode=True`` adds ``wd * p`` to the update instead.
``step(lr=, grad_scale=, skip_update=)`` and
``opt_state``/``load_opt_state`` (``slots={"sum"}``) as
:class:`FusedAdam`'s.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.optimizers._common import FusedOptimizer

__all__ = ["FusedAdagrad"]


class FusedAdagrad(FusedOptimizer):
    """Adagrad with the Apex constructor surface."""

    slots = ("sum",)

    def __init__(self, params, lr: float = 1e-2, eps: float = 1e-10,
                 weight_decay: float = 0.0, adagrad_w_mode: bool = False,
                 master_weights: bool = False):
        defaults = dict(lr=lr, eps=eps, weight_decay=weight_decay,
                        adagrad_w_mode=adagrad_w_mode)
        super().__init__(params, defaults, master_weights)

    def _update(self, group, p32, g32, slots, step, lr):
        wd, eps, w_mode = (group["weight_decay"], group["eps"],
                           group["adagrad_w_mode"])
        for p, g, h in zip(p32, g32, slots["sum"]):
            if wd != 0.0 and not w_mode:
                g = g + wd * p
            h.add_(g * g)
            u = g / (torch.sqrt(h) + eps)
            if wd != 0.0 and w_mode:
                u = u + wd * p
            p.sub_(lr * u)
