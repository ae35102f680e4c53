"""FusedAdam / FusedAdamW (port of :mod:`apex_tpu.optimizers.fused_adam`).

A ``torch.optim.Optimizer`` with Apex's constructor: ``adam_w_mode=True``
(the default) is AdamW, ``p -= lr * (update + wd * p)``; ``False`` folds
``wd * p`` into the gradient before the moments.  Bias correction
``1 - beta ** t`` is taken in fp32 as in the JAX package.  The math is
fp32 for any parameter dtype (moments are fp32).  Without
``master_weights`` a non-fp32 parameter is updated through an fp32 copy
and written back each step; with it, fp32 masters live in the optimizer
state (``state["master"]``) and every parameter is rewritten from its
master in its own dtype.  ``flat=True`` runs the elementwise update once
over one packed buffer per list instead of per tensor.

:meth:`FusedAdam.step` takes the JAX ``step``'s keywords: ``lr`` (this
step's rate), ``grad_scale`` (the gradients are multiplied by its fp32
inverse) and ``skip_update`` (a bool, or a 0-d bool tensor on the
parameters' device: where it is True the parameters, masters and both
moments keep their old values and the step counter does not advance).
The skip is a select on the device, with no host sync; once one has been
given, the step counter is a device tensor and the bias corrections are
taken on the device too.  The step counter is one per parameter group
(``group["step"]``, as in Apex), so a parameter whose first gradient
comes late joins the group's count, and ``state_dict`` carries it with
the group.  AMSGrad is rejected like the reference.

:meth:`FusedAdam.opt_state` gives the state as the reference's
:class:`~apex_tpu_torch.optimizers._common.OptState` tree (``step``,
``slots={"exp_avg", "exp_avg_sq"}``, ``master``) in the structure of a
tree of the parameters, the form a checkpoint holds, and
:meth:`FusedAdam.load_opt_state` loads it back.

Plain torch ops (``torch._foreach_*``, one launch per op for all
parameters): the JAX FusedAdam is plain XLA, not a Pallas kernel.
"""

from __future__ import annotations

from typing import Tuple

from apex_tpu_torch.optimizers._common import (
    FusedOptimizer,
    adam_apply,
    bias_correction,
    tree_map_flat,
)

__all__ = ["FusedAdam"]


class FusedAdam(FusedOptimizer):
    """Adam/AdamW with the Apex constructor surface."""

    slots = ("exp_avg", "exp_avg_sq")

    def __init__(self, params, lr: float = 1e-3, bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 adam_w_mode: bool = True, weight_decay: float = 0.0,
                 amsgrad: bool = False, master_weights: bool = False,
                 flat: bool = False):
        if amsgrad:
            raise RuntimeError(
                "FusedAdam does not support the AMSGrad variant (as in "
                "apex/optimizers/fused_adam.py)")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, adam_w_mode=adam_w_mode,
                        weight_decay=weight_decay)
        super().__init__(params, defaults, master_weights)
        self.flat = flat

    def _update(self, group, p32, g32, slots, step, lr):
        t = step + 1                     # the update being applied
        b1, b2 = group["betas"]
        if group["bias_correction"]:
            bc1, bc2 = bias_correction(b1, t), bias_correction(b2, t)
        else:
            bc1 = bc2 = 1.0

        def update(p32, g32, m, v):
            adam_apply(p32, g32, m, v, lr=lr, b1=b1, b2=b2, eps=group["eps"],
                       wd=group["weight_decay"], bc1=bc1, bc2=bc2,
                       adam_w_mode=group["adam_w_mode"])

        if self.flat:
            tree_map_flat(update, p32, g32, slots["exp_avg"],
                          slots["exp_avg_sq"])
        else:
            update(p32, g32, slots["exp_avg"], slots["exp_avg_sq"])
