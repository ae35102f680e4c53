"""The ``amp.initialize`` analog, functional (port of
:mod:`apex_tpu.amp.frontend`).

:func:`initialize` returns an :class:`AmpConfig` (the policy and the
scaler algorithm) and an :class:`AmpState` (the scaler state and, when
the policy keeps them and parameters are given, fp32 masters).  With a
torch module, cast its parameters by the policy
(``dict(module.named_parameters())``) and let
``FusedAdam(master_weights=True)`` keep the masters;
:func:`apex_tpu_torch.testing.l1.amp_train_step` composes one step.
:func:`state_dict` and :func:`load_state_dict` checkpoint the scaler
state.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, NamedTuple, Optional, Union

import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.amp._tree import tree_leaves
from apex_tpu_torch.amp.master import MasterWeights, make_master
from apex_tpu_torch.amp.policy import Policy, policy as make_policy
from apex_tpu_torch.amp.scaler import (
    DynamicLossScale,
    LossScaleState,
    NoOpLossScale,
    StaticLossScale,
    _state,
)

__all__ = ["AmpConfig", "AmpState", "initialize", "state_dict",
           "load_state_dict"]


@dataclasses.dataclass(frozen=True)
class AmpConfig:
    """The static side of amp: the policy and the scaler algorithm."""

    policy: Policy
    loss_scaler: Union[DynamicLossScale, StaticLossScale, NoOpLossScale]


class AmpState(NamedTuple):
    """The dynamic side: the scaler state (a tuple of states with
    ``num_losses > 1``) and the optional master weights."""

    scaler: Any
    master: Optional[MasterWeights]


def initialize(params=None, opt_level: str = "O1",
               half_dtype: torch.dtype = torch.bfloat16, *,
               loss_scale: Union[str, float, None] = None,
               num_losses: int = 1, device=None, **policy_overrides):
    """``(AmpConfig, AmpState)`` of an opt level.

    ``loss_scale`` overrides the preset ("dynamic" or a float); other
    :class:`Policy` fields are overridden by keyword; ``num_losses > 1``
    gives each loss its own scaler state.  When ``params`` are given and
    the policy keeps master weights, ``AmpState.master`` holds fp32
    masters of the policy-cast parameters.  The scaler state lives on
    ``device``: by default the device of the first tensor of ``params``,
    else the CUDA device."""
    if num_losses < 1:
        raise ValueError(f"num_losses must be >= 1, got {num_losses}")
    pol = make_policy(opt_level, half_dtype)
    if loss_scale is not None:
        pol = pol.with_options(loss_scale=loss_scale)
    if policy_overrides:
        pol = pol.with_options(**policy_overrides)
    if pol.loss_scale == "dynamic":
        scaler_algo: Any = DynamicLossScale()
    elif pol.loss_scale is None:
        scaler_algo = NoOpLossScale()
    else:
        scaler_algo = StaticLossScale(float(pol.loss_scale))
    if device is None:
        tensors = [x for x in tree_leaves(params)
                   if isinstance(x, torch.Tensor)]
        device = tensors[0].device if tensors else None
    device = resolve_device(device)
    master = None
    if params is not None and pol.master_weights:
        master = make_master(pol.cast_to_param(params))
    scaler_state = (scaler_algo.init(device) if num_losses == 1
                    else tuple(scaler_algo.init(device)
                               for _ in range(num_losses)))
    return (AmpConfig(policy=pol, loss_scaler=scaler_algo),
            AmpState(scaler=scaler_state, master=master))


def _one_state_dict(s: LossScaleState) -> dict:
    return {"loss_scale": s.scale, "growth_tracker": s.growth_tracker,
            "hysteresis_tracker": s.hysteresis_tracker,
            "found_inf": s.found_inf}


def _one_load(sd: dict, device) -> LossScaleState:
    return _state(sd["loss_scale"], sd["growth_tracker"],
                  sd["hysteresis_tracker"], sd["found_inf"], device)


def state_dict(state: AmpState):
    """The scaler state as a dict, or a list of dicts with
    ``num_losses > 1``."""
    if not isinstance(state.scaler, LossScaleState):
        return [_one_state_dict(s) for s in state.scaler]
    return _one_state_dict(state.scaler)


def load_state_dict(state: AmpState, sd) -> AmpState:
    """``state`` with its scaler state restored from ``sd``, on the
    device it had.  A checkpoint saved with another ``num_losses`` is
    loaded as the reference resumes it: the overlapping prefix, with a
    warning (extra saved states dropped, missing ones left fresh)."""
    saved = list(sd) if isinstance(sd, (list, tuple)) else [sd]
    single = isinstance(state.scaler, LossScaleState)
    current = [state.scaler] if single else list(state.scaler)
    if len(saved) != len(current):
        warnings.warn(
            f"amp.load_state_dict: checkpoint has {len(saved)} loss "
            f"scaler(s) but state expects {len(current)} (saved with a "
            "different num_losses); loading the overlapping prefix "
            "(reference behavior, apex/amp/frontend.py:394)")
    loaded = [_one_load(d, s.scale.device) for d, s in zip(saved, current)]
    loaded += current[len(loaded):]
    return state._replace(scaler=loaded[0] if single else tuple(loaded))
