"""FusedLion (port of :mod:`apex_tpu.optimizers.fused_lion`).

The update, in fp32 whatever the parameters' dtype, with the kernel's
sign (``u <= 0`` gives -1, so a zero gradient still moves):

- ``lion_w_mode=True`` (the default, decoupled):
  ``p -= lr * (sign(beta1 * m + (1 - beta1) * g) + wd * p)``;
- ``lion_w_mode=False`` (L2): ``g += wd * p`` first, no decay term;
- then ``m = beta2 * m + (1 - beta2) * g``.

``bias_correction`` and ``eps`` are taken for the constructor's sake and
ignored, as the reference kernel ignores them.  ``step(lr=, grad_scale=,
skip_update=)`` and ``opt_state``/``load_opt_state``
(``slots={"exp_avg"}``) as :class:`FusedAdam`'s.
"""

from __future__ import annotations

from typing import Tuple

import torch

from apex_tpu_torch.optimizers._common import FusedOptimizer

__all__ = ["FusedLion"]


class FusedLion(FusedOptimizer):
    """Lion with the Apex constructor surface."""

    slots = ("exp_avg",)

    def __init__(self, params, lr: float = 1e-3, bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 lion_w_mode: bool = True, weight_decay: float = 0.0,
                 master_weights: bool = False):
        del bias_correction, eps
        defaults = dict(lr=lr, betas=betas, lion_w_mode=lion_w_mode,
                        weight_decay=weight_decay)
        super().__init__(params, defaults, master_weights)

    def _update(self, group, p32, g32, slots, step, lr):
        b1, b2 = group["betas"]
        wd, w_mode = group["weight_decay"], group["lion_w_mode"]
        for p, g, m in zip(p32, g32, slots["exp_avg"]):
            if wd != 0.0 and not w_mode:
                g = g + wd * p
            blend = b1 * m + (1.0 - b1) * g
            u = torch.where(blend <= 0, -1.0, 1.0)
            if wd != 0.0 and w_mode:
                u = u + wd * p
            p.sub_(lr * u)
            m.copy_(b2 * m + (1.0 - b2) * g)
