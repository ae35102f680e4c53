"""The input batch broadcast over the tensor-parallel group (port of
:mod:`apex_tpu.transformer.tensor_parallel.data`): every rank of a
tensor-parallel group sees tensor-parallel rank 0's batch, bit for bit,
even where the ranks' input pipelines drifted."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from apex_tpu_torch.parallel import collectives
from apex_tpu_torch.parallel.mesh import TENSOR_AXIS

__all__ = ["broadcast_data"]


def broadcast_data(keys, data: Dict[str, torch.Tensor],
                   datatype=torch.int32,
                   axis: Optional[str] = TENSOR_AXIS) -> Dict[str, torch.Tensor]:
    """``data[k]`` for each ``k`` of ``keys``, cast to ``datatype`` and
    taken from group rank 0 of ``axis`` (as it is for ``axis=None``)."""
    out = {}
    for k in keys:
        v = torch.as_tensor(data[k]).to(datatype)
        if axis is not None:
            v = collectives.broadcast(v, axis, root=0)
        out[k] = v
    return out
