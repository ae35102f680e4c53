"""The model-parallel gradient scaler (port of
:mod:`apex_tpu.transformer.amp.grad_scaler`).

:class:`GradScaler` is :class:`~apex_tpu_torch.amp.DynamicLossScale`
with ``hysteresis=2`` and an :meth:`GradScaler.all_finite` that the
reference reduces (MAX of the overflow flag) over the model-parallel
ranks, so that an overflow on any shard skips the step on all of them.
The port runs at world size 1, where that agreement is the local flag;
the cross-rank reduction arrives with the 3D-parallel slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from apex_tpu_torch.amp.scaler import DynamicLossScale, all_finite

__all__ = ["GradScaler"]


@dataclasses.dataclass(frozen=True)
class GradScaler(DynamicLossScale):
    """``DynamicLossScale`` with ``hysteresis=2`` and model-parallel
    overflow agreement over ``model_parallel_axes`` (the reference's
    tensor and pipeline axes)."""

    hysteresis: int = 2
    model_parallel_axes: Tuple[str, ...] = ("tp", "pp")

    def all_finite(self, grads, *, axes: Optional[Sequence[str]] = None):
        """The local overflow check; at world size 1 it is also the
        agreement over every model-parallel rank."""
        if (torch.distributed.is_available()
                and torch.distributed.is_initialized()
                and torch.distributed.get_world_size() > 1):
            raise NotImplementedError(
                "the cross-rank overflow agreement is not ported yet "
                "(ROADMAP.md, section A.3)")
        return all_finite(grads)
