"""FusedSGD (port of :mod:`apex_tpu.optimizers.fused_sgd`).

A ``torch.optim.Optimizer`` with Apex's constructor.  The update, in fp32
whatever the parameters' dtype:

- weight decay into the gradient, ``g + wd * p`` (or, with
  ``wd_after_momentum``, onto the momentum's output);
- momentum with dampening, ``buf = momentum * buf + (1 - dampening) * g``,
  and ``buf = g`` on the first momentum step (the kernel's ``first_run``):
  the group's step count is 0, and a skipped step does not advance it;
- ``nesterov``: the step direction ``g + momentum * buf``.

``step(lr=, grad_scale=, skip_update=)`` as :class:`FusedAdam`'s; the
state (``slots={"momentum_buffer"}`` with momentum, none without) comes
and goes as the reference's ``OptState`` through ``opt_state`` and
``load_opt_state``.  Plain ``torch._foreach_*`` ops: the reference is
plain XLA.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.optimizers._common import FusedOptimizer

__all__ = ["FusedSGD"]


def _mul_lr(d, lr):
    if isinstance(lr, torch.Tensor):
        return torch._foreach_mul(d, lr)
    return torch._foreach_mul(d, float(lr))


class FusedSGD(FusedOptimizer):
    """SGD with momentum, dampening, Nesterov and the Apex weight-decay
    placement."""

    def __init__(self, params, lr: float = 1e-3, momentum: float = 0.0,
                 dampening: float = 0.0, weight_decay: float = 0.0,
                 nesterov: bool = False, wd_after_momentum: bool = False,
                 master_weights: bool = False):
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError(
                "Nesterov momentum requires a momentum and zero dampening "
                "(as torch and apex SGD)")
        defaults = dict(lr=lr, momentum=momentum, dampening=dampening,
                        weight_decay=weight_decay, nesterov=nesterov,
                        wd_after_momentum=wd_after_momentum)
        super().__init__(params, defaults, master_weights)
        self.slots = ("momentum_buffer",) if momentum != 0.0 else ()

    def _update(self, group, p32, g32, slots, step, lr):
        mom, damp = group["momentum"], group["dampening"]
        wd, after = group["weight_decay"], group["wd_after_momentum"]
        if wd != 0.0 and not after:
            g32 = torch._foreach_add(g32, p32, alpha=wd)
        if mom != 0.0:
            buf = slots["momentum_buffer"]
            blended = torch._foreach_mul(buf, mom)
            torch._foreach_add_(blended, g32, alpha=1.0 - damp)
            if isinstance(step, torch.Tensor):
                first = step == 0
                for b, g, n in zip(buf, g32, blended):
                    b.copy_(torch.where(first, g, n))
            else:
                for b, g, n in zip(buf, g32, blended):
                    b.copy_(g if step == 0 else n)
            d = (torch._foreach_add(g32, buf, alpha=mom)
                 if group["nesterov"] else buf)
        else:
            d = g32
        if wd != 0.0 and after:
            d = torch._foreach_add(d, p32, alpha=wd)
        torch._foreach_sub_(p32, _mul_lr(d, lr))
