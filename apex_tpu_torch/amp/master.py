"""fp32 master weights for half-precision training, the O2 mechanism
(port of :mod:`apex_tpu.amp.master`).

Masters are another tree: the step computes gradients with respect to
the half model parameters, unscales them to fp32, steps the optimizer on
the fp32 masters and derives the model parameters again by a cast.
``FusedAdam(master_weights=True)`` keeps the same masters inside the
optimizer state for a torch module.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from apex_tpu_torch.amp._tree import tree_leaves, tree_map

__all__ = ["MasterWeights", "make_master", "master_to_model"]


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


class MasterWeights(NamedTuple):
    """fp32 master parameters and the dtype the model parameters are
    derived in."""

    params: Any
    model_dtype: torch.dtype


def make_master(model_params) -> MasterWeights:
    """An fp32 copy of every floating leaf (a copy even of an fp32 leaf,
    so a master never shares storage with the model).  The model dtype is
    that of the first floating leaf in the JAX leaf order (dict keys
    sorted), as in the reference: with a norm parameter first, an fp32
    one under O2, every leaf is derived back in fp32."""
    floats = [x for x in tree_leaves(model_params) if _is_float(x)]
    model_dtype = floats[0].dtype if floats else torch.float32
    masters = tree_map(
        lambda x: x.detach().to(torch.float32, copy=True) if _is_float(x)
        else x, model_params)
    return MasterWeights(params=masters, model_dtype=model_dtype)


def master_to_model(master: MasterWeights):
    """The model parameters: every floating master cast to
    ``model_dtype``."""
    return tree_map(lambda x: x.to(master.model_dtype) if _is_float(x)
                    else x, master.params)
