"""The unified non-finite sentinel: one overflow guard for every trainer
(port of :mod:`apex_tpu.resilience.sentinel`).

:class:`SentinelState` carries the amp scaler's state and a count of the
updates skipped; :func:`sentinel_update` checks the gradients with
:func:`apex_tpu_torch.amp.scaler.all_finite` and steps the scaler;
:func:`guarded_optimizer_step` runs the optimizer with the update skipped
where the gradients were not finite.  The JAX package skips through one
``lax.cond``; here the skip is the optimizer's device-side select
(``FusedAdam.step(skip_update=...)``): the parameters, masters and moments
keep their bits and the step count does not advance, with no host sync.

Every rank whose optimizer step belongs to one update must take the same
decision: pass ``axes`` (the grid's axes over which the ranks hold
different gradients, such as the tensor and pipeline axes), and the flag
is the MIN over them.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence, Tuple

import torch

from apex_tpu_torch.amp.scaler import LossScaleState, all_finite
from apex_tpu_torch.parallel.collectives import all_reduce, bound_axis_size

__all__ = [
    "SentinelState",
    "sentinel_init",
    "sentinel_update",
    "sentinel_guarded_apply",
    "guarded_optimizer_step",
]


class SentinelState(NamedTuple):
    """``scaler``: the amp :class:`LossScaleState`; ``skipped_steps``: an
    int32 0-d tensor, the updates skipped so far."""

    scaler: LossScaleState
    skipped_steps: torch.Tensor

    @property
    def scale(self):
        return self.scaler.scale


def sentinel_init(scaler_algo, device=None) -> SentinelState:
    """A fresh state for a scaler algorithm (``DynamicLossScale()``,
    ``StaticLossScale(...)``, ...) on ``device`` (default: the card)."""
    scaler = scaler_algo.init(device)
    return SentinelState(
        scaler=scaler,
        skipped_steps=torch.zeros((), dtype=torch.int32,
                                  device=scaler.scale.device))


def sentinel_update(scaler_algo, grads: Any, state: SentinelState, *,
                    axes: Optional[Sequence[str]] = None
                    ) -> Tuple[torch.Tensor, SentinelState]:
    """Check ``grads``, then step the scaler and the skip count.  Returns
    ``(finite, new_state)``, ``finite`` a 0-d bool tensor, agreed over the
    ``axes`` of more than one rank; no host sync."""
    finite = all_finite(grads).to(state.scaler.scale.device)
    bound = tuple(a for a in (axes or ()) if bound_axis_size(a) > 1)
    if bound:
        finite = all_reduce(finite.to(torch.int32), bound, "min") > 0
    new_scaler = scaler_algo.update(state.scaler, finite)
    skipped = state.skipped_steps + (~finite).to(torch.int32)
    return finite, SentinelState(scaler=new_scaler, skipped_steps=skipped)


def sentinel_guarded_apply(scaler_algo, optimizer, grads: Any,
                           state: SentinelState, *,
                           axes: Optional[Sequence[str]] = None, lr=None,
                           grad_scale=None) -> SentinelState:
    """The sentinel tick and the guarded step in one call: returns the new
    state.  ``grads`` are the gradients the optimizer will read (its
    parameters' ``.grad``); ``grad_scale`` is the scale the loss was
    multiplied by, taken before this call (the update may back it off)."""
    finite, state = sentinel_update(scaler_algo, grads, state, axes=axes)
    guarded_optimizer_step(optimizer, finite, lr=lr, grad_scale=grad_scale)
    return state


def guarded_optimizer_step(optimizer, finite, *, lr=None, grad_scale=None):
    """``optimizer.step`` with the update skipped where ``finite`` is
    False (``skip_update``, FusedAdam's keyword); ``grad_scale`` divides
    the gradients inside the update.  ``finite`` must agree on every rank
    of one update (:func:`sentinel_update` with ``axes``)."""
    optimizer.step(lr=lr, grad_scale=grad_scale,
                   skip_update=~torch.as_tensor(finite))
