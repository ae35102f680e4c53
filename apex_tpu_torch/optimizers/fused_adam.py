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

Plain torch ops (``torch._foreach_*``, one launch per op for all
parameters): the JAX FusedAdam is plain XLA, not a Pallas kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from apex_tpu_torch.optimizers._common import (
    adam_apply,
    advance_step,
    apply_skip,
    finalize_params,
    resolve_master,
    scale_grads,
    tree_map_flat,
)

__all__ = ["FusedAdam"]


def _bias_correction(beta: float, t):
    """``1 - beta ** t`` in fp32: a float from a host count, a 0-d tensor
    from a device one."""
    if isinstance(t, torch.Tensor):
        return 1.0 - torch.pow(beta, t.float())
    return float(1.0 - torch.tensor(beta) ** torch.tensor(float(t)))


class FusedAdam(torch.optim.Optimizer):
    """Adam/AdamW with the Apex constructor surface."""

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
        super().__init__(params, defaults)
        self.master_weights = master_weights
        self.flat = flat

    def _state(self, p):
        state = self.state[p]
        if not state:
            state["exp_avg"] = torch.zeros_like(
                p, dtype=torch.float32, memory_format=torch.preserve_format)
            state["exp_avg_sq"] = torch.zeros_like(
                p, dtype=torch.float32, memory_format=torch.preserve_format)
            if self.master_weights:
                state["master"] = p.detach().to(torch.float32, copy=True)
        return state

    @torch.no_grad()
    def step(self, closure=None, *, lr=None, grad_scale=None,
             skip_update=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            states = [self._state(p) for p in params]
            skip = (None if skip_update is None else torch.as_tensor(
                skip_update, dtype=torch.bool, device=params[0].device))
            step = group.setdefault("step", 0)
            t = step + 1                     # the update being applied
            b1, b2 = group["betas"]
            if group["bias_correction"]:
                bc1, bc2 = _bias_correction(b1, t), _bias_correction(b2, t)
            else:
                bc1 = bc2 = 1.0
            m = [s["exp_avg"] for s in states]
            v = [s["exp_avg_sq"] for s in states]
            p32 = resolve_master(params, [s.get("master") for s in states],
                                 self.master_weights)
            g32 = scale_grads([p.grad for p in params], grad_scale)
            old = None if skip is None else [x.clone() for x in p32 + m + v]

            def update(p32, g32, m, v):
                adam_apply(p32, g32, m, v,
                           lr=group["lr"] if lr is None else lr, b1=b1, b2=b2,
                           eps=group["eps"], wd=group["weight_decay"],
                           bc1=bc1, bc2=bc2, adam_w_mode=group["adam_w_mode"])

            if self.flat:
                tree_map_flat(update, p32, g32, m, v)
            else:
                update(p32, g32, m, v)
            if skip is not None:
                apply_skip(skip, p32 + m + v, old)
            finalize_params(p32, params)
            group["step"] = advance_step(step, skip)
        return loss
