"""The model-parallel gradient scaler (port of
:mod:`apex_tpu.transformer.amp.grad_scaler`).

:class:`GradScaler` is :class:`~apex_tpu_torch.amp.DynamicLossScale`
with ``hysteresis=2`` and an :meth:`GradScaler.all_finite` that agrees
over the model-parallel ranks: with tensor or pipeline parallelism each
rank checks only its shard's gradients, and an overflow on any shard
must skip the step on all of them, or the replicas part.  The flag's MIN
over the model-parallel axes of the grid
(:func:`apex_tpu_torch.parallel.initialize_model_parallel`) is that
agreement, as the reference's ``pmin`` is; an axis of one rank, or no
grid at all, needs none.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from apex_tpu_torch.amp.scaler import DynamicLossScale, all_finite
from apex_tpu_torch.parallel.collectives import all_reduce, bound_axis_size
from apex_tpu_torch.parallel.mesh import PIPELINE_AXIS, TENSOR_AXIS

__all__ = ["GradScaler"]


@dataclasses.dataclass(frozen=True)
class GradScaler(DynamicLossScale):
    """``DynamicLossScale`` with ``hysteresis=2`` and model-parallel
    overflow agreement over ``model_parallel_axes`` (the reference's
    tensor and pipeline axes)."""

    hysteresis: int = 2
    model_parallel_axes: Tuple[str, ...] = (TENSOR_AXIS, PIPELINE_AXIS)

    def all_finite(self, grads, *, axes: Optional[Sequence[str]] = None):
        """The local overflow check (a 0-d bool tensor), then its MIN over
        ``axes`` (default ``model_parallel_axes``), those of them with
        more than one rank."""
        finite = all_finite(grads)
        use = self.model_parallel_axes if axes is None else tuple(axes)
        bound = tuple(ax for ax in use if bound_axis_size(ax) > 1)
        if bound:
            flag = all_reduce(finite.to(torch.int32), bound, "min")
            finite = flag > 0
        return finite
