"""Loss scaling (port of :mod:`apex_tpu.amp.scaler`).

The scaler state is a :class:`LossScaleState` of 0-d tensors on the
device, and :meth:`DynamicLossScale.update` is branchless
(``torch.where``), so a training step never waits on the host for the
overflow flag: the skip itself is the optimizer's select
(``FusedAdam.step(skip_update=...)``).  Reference semantics
(``apex/amp/scaler.py``, ``csrc/update_scale_hysteresis.cu``): the
scale starts at ``2**16``, doubles after ``growth_interval`` clean steps
(at most ``max_scale``), and halves (at least ``min_scale``) once
``hysteresis`` overflows have come in a row.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.amp._tree import tree_leaves, tree_map

__all__ = [
    "LossScaleState",
    "DynamicLossScale",
    "StaticLossScale",
    "NoOpLossScale",
    "all_finite",
    "scale_loss",
]


class LossScaleState(NamedTuple):
    """``scale`` (fp32), ``growth_tracker`` (int32: clean steps in a
    row), ``hysteresis_tracker`` (int32: overflows still tolerated) and
    ``found_inf`` (bool: the last step overflowed), all 0-d tensors."""

    scale: torch.Tensor
    growth_tracker: torch.Tensor
    hysteresis_tracker: torch.Tensor
    found_inf: torch.Tensor


def _state(scale, growth, hysteresis, found_inf, device) -> LossScaleState:
    return LossScaleState(
        scale=torch.as_tensor(scale, dtype=torch.float32, device=device),
        growth_tracker=torch.as_tensor(growth, dtype=torch.int32,
                                       device=device),
        hysteresis_tracker=torch.as_tensor(hysteresis, dtype=torch.int32,
                                           device=device),
        found_inf=torch.as_tensor(found_inf, dtype=torch.bool, device=device))


def all_finite(tree) -> torch.Tensor:
    """A 0-d bool tensor: every floating-point leaf of ``tree`` is finite
    (the ``noop_flag`` of the multi-tensor kernels), computed on the
    device with no host sync; True for a tree with no such leaf."""
    leaves = [x for x in tree_leaves(tree)
              if isinstance(x, torch.Tensor) and x.is_floating_point()]
    if not leaves:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(x).all() for x in leaves]).all()


def _scale(loss, state: LossScaleState):
    return loss.float() * state.scale


def _unscale(grads, state: LossScaleState):
    inv = 1.0 / state.scale
    return tree_map(lambda g: g.float() * inv, grads)


def _keep_old(found_inf, params_new, params_old):
    return tree_map(lambda n, o: torch.where(found_inf, o, n), params_new,
                    params_old)


@dataclasses.dataclass(frozen=True)
class DynamicLossScale:
    """Dynamic loss scaling with a growth interval and hysteresis
    (``hysteresis=1``: the plain scaler)."""

    init_scale: float = 2.0 ** 16
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000
    hysteresis: int = 1
    min_scale: float = 1.0
    max_scale: float = 2.0 ** 24

    def init(self, device=None) -> LossScaleState:
        """The first state, on ``device`` (default: the CUDA device)."""
        return _state(self.init_scale, 0, self.hysteresis, False,
                      resolve_device(device))

    def scale(self, loss, state: LossScaleState):
        """``loss * scale`` in fp32: the loss to differentiate."""
        return _scale(loss, state)

    def unscale(self, grads, state: LossScaleState):
        """The gradients times ``1 / scale``, in fp32."""
        return _unscale(grads, state)

    def update(self, state: LossScaleState, grads_finite) -> LossScaleState:
        """The next state, branchless on the device:

        - an overflow uses one hysteresis count; with none left the scale
          is multiplied by ``backoff_factor`` (at least ``min_scale``) and
          the hysteresis count is reset; the growth count goes to 0;
        - a clean step counts; at ``growth_interval`` clean steps the
          scale is multiplied by ``growth_factor`` (at most
          ``max_scale``) and the count goes to 0.
        """
        finite = torch.as_tensor(grads_finite, dtype=torch.bool,
                                 device=state.scale.device)
        zero = torch.zeros_like(state.growth_tracker)
        hyst = torch.full_like(state.hysteresis_tracker, self.hysteresis)
        hyst_after = torch.clamp(state.hysteresis_tracker - 1, min=0)
        do_backoff = ~finite & (hyst_after == 0)
        grew = state.growth_tracker + 1
        do_grow = finite & (grew >= self.growth_interval)
        new_scale = torch.where(
            do_backoff,
            torch.clamp(state.scale * self.backoff_factor,
                        min=self.min_scale),
            torch.where(do_grow,
                        torch.clamp(state.scale * self.growth_factor,
                                    max=self.max_scale),
                        state.scale))
        return LossScaleState(
            scale=new_scale,
            growth_tracker=torch.where(
                finite, torch.where(do_grow, zero, grew), zero),
            hysteresis_tracker=torch.where(
                finite | do_backoff, hyst, hyst_after),
            found_inf=~finite)

    def adjust(self, params_new, params_old, state: LossScaleState):
        """The old leaves where the last step overflowed, else the new
        (a select, not a branch)."""
        return _keep_old(state.found_inf, params_new, params_old)


@dataclasses.dataclass(frozen=True)
class StaticLossScale:
    """A fixed loss scale (``loss_scale=<float>``)."""

    loss_scale: float = 1.0

    def init(self, device=None) -> LossScaleState:
        return _state(self.loss_scale, 0, 1, False, resolve_device(device))

    def scale(self, loss, state: LossScaleState):
        return _scale(loss, state)

    def unscale(self, grads, state: LossScaleState):
        return _unscale(grads, state)

    def update(self, state: LossScaleState, grads_finite) -> LossScaleState:
        finite = torch.as_tensor(grads_finite, dtype=torch.bool,
                                 device=state.scale.device)
        return state._replace(found_inf=~finite)

    def adjust(self, params_new, params_old, state: LossScaleState):
        return _keep_old(state.found_inf, params_new, params_old)


class NoOpLossScale(StaticLossScale):
    """The identity scaler (scale 1, never skips)."""

    def __init__(self):
        super().__init__(loss_scale=1.0)

    def update(self, state: LossScaleState, grads_finite) -> LossScaleState:
        return state

    def adjust(self, params_new, params_old, state: LossScaleState):
        return params_new


def scale_loss(loss, state: LossScaleState):
    """``loss * scale`` in fp32 (the ``with amp.scale_loss(...)`` context
    as a function); unscale and update explicitly on the gradients."""
    return _scale(loss, state)
