"""FusedNovoGrad (port of :mod:`apex_tpu.optimizers.fused_novograd`).

NovoGrad keeps, per tensor, a second moment of the gradient's norm
(``slots["exp_avg_sq"]``, a 0-d fp32 tensor per parameter), blended each
step: ``gn = sqrt(beta2 * gn**2 + (1 - beta2) * n**2)`` for the L2 norm
(``norm_type=2``), ``gn = beta2 * gn + (1 - beta2) * n`` for the max norm
(``norm_type=0``).  It starts at the first step's norm (a -1 marks it
unset) unless ``init_zero``.  With ``bc1 = 1 - beta1**t``,
``bc2 = sqrt(1 - beta2**t)`` and ``beta3 = 1 - beta1`` under
``grad_averaging``:

- ``reg_inside_moment=False`` (the default): ``m = beta1 * m + beta3 * g``,
  ``p -= lr * ((m / bc1) / (gn / bc2 + eps) + wd * p)``;
- ``reg_inside_moment=True``: ``g' = g / (gn / bc2 + eps) + wd * p``,
  ``m = beta1 * m + beta3 * g'``, ``p -= lr * m / bc1``.

``flat=True`` (the default) takes the per-tensor norms from one chunked
buffer (a row reduction and a segmented reduction) and runs the update
over it; ``flat=False`` tensor by tensor.  ``step(lr=, grad_scale=,
skip_update=)`` and ``opt_state``/``load_opt_state``
(``slots={"exp_avg", "exp_avg_sq"}``) as :class:`FusedAdam`'s.
"""

from __future__ import annotations

from typing import Tuple

import torch

from apex_tpu_torch.optimizers._common import FusedOptimizer, bias_correction
from apex_tpu_torch.utils.tree import (
    chunked_per_leaf_max_abs,
    chunked_per_leaf_sumsq,
    chunked_rows,
    flatten_to_chunked,
    unflatten_from_chunked,
)

__all__ = ["FusedNovoGrad"]


class FusedNovoGrad(FusedOptimizer):
    """NovoGrad with the Apex constructor surface."""

    slots = ("exp_avg", "exp_avg_sq")

    def __init__(self, params, lr: float = 1e-3, bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, amsgrad: bool = False,
                 reg_inside_moment: bool = False, grad_averaging: bool = True,
                 norm_type: int = 2, init_zero: bool = False,
                 master_weights: bool = False, flat: bool = True):
        if amsgrad:
            raise RuntimeError(
                "FusedNovoGrad does not support the AMSGrad variant (as in "
                "apex/optimizers/fused_novograd.py)")
        if norm_type not in (0, 2):
            raise RuntimeError(
                "FusedNovoGrad only supports the l2 (2) and inf (0) norms "
                "(as apex/optimizers/fused_novograd.py)")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, weight_decay=weight_decay,
                        reg_inside_moment=reg_inside_moment,
                        grad_averaging=grad_averaging)
        super().__init__(params, defaults, master_weights)
        self.norm_type = norm_type
        self.init_zero = init_zero
        self.flat = flat

    def _init_slot(self, name, p):
        if name == "exp_avg_sq":
            return torch.full((), 0.0 if self.init_zero else -1.0,
                              dtype=torch.float32, device=p.device)
        return super()._init_slot(name, p)

    def _blend(self, gn, n, b2):
        """The norm state after this step's per-tensor norms ``n``."""
        gn = torch.where(gn < 0, n, gn)
        if self.norm_type == 0:
            return b2 * gn + (1.0 - b2) * n
        return torch.sqrt(b2 * gn * gn + (1.0 - b2) * n * n)

    def _update(self, group, p32, g32, slots, step, lr):
        b1, b2 = group["betas"]
        eps, wd = group["eps"], group["weight_decay"]
        inside = group["reg_inside_moment"]
        beta3 = 1.0 - b1 if group["grad_averaging"] else 1.0
        t = step + 1
        if group["bias_correction"]:
            bc1 = bias_correction(b1, t)
            bc2 = torch.sqrt(torch.as_tensor(bias_correction(b2, t),
                                             dtype=torch.float32))
        else:
            bc1 = bc2 = 1.0
        m_list, gn_list = slots["exp_avg"], slots["exp_avg_sq"]

        def moments(p, g, m, denom):
            if inside:
                g2 = g / denom
                if wd != 0.0:
                    g2 = g2 + wd * p
                m = b1 * m + beta3 * g2
                u = m / bc1
            else:
                m = b1 * m + beta3 * g
                u = (m / bc1) / denom
                if wd != 0.0:
                    u = u + wd * p
            return p - lr * u, m

        if self.flat:
            pb, meta = flatten_to_chunked(p32)
            gb, _ = flatten_to_chunked(g32)
            mb, _ = flatten_to_chunked(m_list)
            if self.norm_type == 0:
                n = chunked_per_leaf_max_abs(gb, meta)
            else:
                n = torch.sqrt(chunked_per_leaf_sumsq(gb, meta))
            gn_new = self._blend(torch.stack(gn_list), n, b2)
            pb, mb = moments(pb, gb, mb,
                             chunked_rows(gn_new / bc2 + eps, meta))
            f32 = meta._replace(dtypes=(torch.float32,) * len(meta.shapes))
            new_p = unflatten_from_chunked(pb, f32)
            new_m = unflatten_from_chunked(mb, f32)
            new_gn = list(gn_new.unbind())
        else:
            new_p, new_m, new_gn = [], [], []
            for p, g, m, gn in zip(p32, g32, m_list, gn_list):
                n = (g.abs().max() if self.norm_type == 0
                     else torch.sqrt(g.square().sum()))
                gn = self._blend(gn, n, b2)
                p, m = moments(p, g, m, gn / bc2 + eps)
                new_p.append(p)
                new_m.append(m)
                new_gn.append(gn)
        for olds, news in ((p32, new_p), (m_list, new_m), (gn_list, new_gn)):
            torch._foreach_copy_(olds, list(news))
