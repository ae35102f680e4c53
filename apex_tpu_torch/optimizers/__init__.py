"""The fused optimizer family (counterpart of :mod:`apex_tpu.optimizers`).

Each optimizer is a ``torch.optim.Optimizer`` with Apex's constructor; its
``step`` takes the JAX ``step``'s keywords: ``lr`` (this step's rate),
``grad_scale`` (the loss-scale division folded into the update) and
``skip_update`` (the overflow skip as a select on the device).  The
update is fp32 whatever the parameters' dtype, with fp32 masters under
``master_weights``, and runs in place over the lists of tensors
(``torch._foreach_*``, or one chunked buffer per list with ``flat``).
Plus LARC (a gradient transform and a wrapper) and clipping by the
global norm.
"""

from apex_tpu_torch.optimizers.clip_grad import (  # noqa: F401
    clip_grad_norm,
    global_grad_norm,
)
from apex_tpu_torch.optimizers.fused_adagrad import FusedAdagrad  # noqa: F401
from apex_tpu_torch.optimizers.fused_adam import FusedAdam  # noqa: F401
from apex_tpu_torch.optimizers.fused_lamb import (  # noqa: F401
    FusedLAMB,
    FusedMixedPrecisionLamb,
)
from apex_tpu_torch.optimizers.fused_lion import FusedLion  # noqa: F401
from apex_tpu_torch.optimizers.fused_novograd import (  # noqa: F401
    FusedNovoGrad,
)
from apex_tpu_torch.optimizers.fused_sgd import FusedSGD  # noqa: F401
from apex_tpu_torch.optimizers.larc import LARC  # noqa: F401

__all__ = [
    "FusedAdam",
    "FusedSGD",
    "FusedLAMB",
    "FusedMixedPrecisionLamb",
    "FusedLion",
    "FusedAdagrad",
    "FusedNovoGrad",
    "LARC",
    "clip_grad_norm",
    "global_grad_norm",
    "fused_step",
]


def fused_step(optimizer):
    """``optimizer.step`` as a callable with the JAX ``fused_step``'s
    keywords, ``step(closure=None, *, lr=None, grad_scale=None,
    skip_update=None)``.  The JAX package jits the step with the state
    and parameters donated, so that XLA updates them in place; in eager
    PyTorch the update already runs in place on the optimizer's own
    tensors, so this only forwards the call."""

    def step(closure=None, *, lr=None, grad_scale=None, skip_update=None):
        return optimizer.step(closure, lr=lr, grad_scale=grad_scale,
                              skip_update=skip_update)

    return step
