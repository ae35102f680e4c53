"""FusedAdam / FusedAdamW (port of :mod:`apex_tpu.optimizers.fused_adam`).

A ``torch.optim.Optimizer`` with Apex's constructor: ``adam_w_mode=True``
(the default) is AdamW, ``p -= lr * (update + wd * p)``; ``False`` folds
``wd * p`` into the gradient before the moments.  Bias correction
``1 - beta ** t`` is taken in fp32 as in the JAX package.  The math is
fp32 for any parameter dtype (moments are fp32; a non-fp32 parameter is
updated through an fp32 copy and written back).  AMSGrad is rejected like
the reference.  Plain torch ops (``torch._foreach_*``, one launch per op
for all parameters): the JAX FusedAdam is plain XLA, not a Pallas kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from apex_tpu_torch.optimizers._common import adam_apply

__all__ = ["FusedAdam"]


class FusedAdam(torch.optim.Optimizer):
    """Adam/AdamW with the Apex constructor surface."""

    def __init__(self, params, lr: float = 1e-3, bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 adam_w_mode: bool = True, weight_decay: float = 0.0,
                 amsgrad: bool = False):
        if amsgrad:
            raise RuntimeError(
                "FusedAdam does not support the AMSGrad variant (as in "
                "apex/optimizers/fused_adam.py)")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, adam_w_mode=adam_w_mode,
                        weight_decay=weight_decay)
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            p32, g32, m, v, write_back = [], [], [], [], []
            for p in params:
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(
                        p, dtype=torch.float32, memory_format=torch.preserve_format)
                    state["exp_avg_sq"] = torch.zeros_like(
                        p, dtype=torch.float32, memory_format=torch.preserve_format)
                state["step"] += 1
                m.append(state["exp_avg"])
                v.append(state["exp_avg_sq"])
                g32.append(p.grad.float())
                if p.dtype == torch.float32:
                    p32.append(p)
                else:
                    p32.append(p.float())
                    write_back.append((p, p32[-1]))
            t = torch.tensor(float(self.state[params[0]]["step"]))
            if group["bias_correction"]:
                bc1 = float(1.0 - torch.tensor(b1) ** t)
                bc2 = float(1.0 - torch.tensor(b2) ** t)
            else:
                bc1 = bc2 = 1.0
            adam_apply(p32, g32, m, v, lr=group["lr"], b1=b1, b2=b2,
                       eps=group["eps"], wd=group["weight_decay"], bc1=bc1,
                       bc2=bc2, adam_w_mode=group["adam_w_mode"])
            for p, new in write_back:
                p.copy_(new)
        return loss
