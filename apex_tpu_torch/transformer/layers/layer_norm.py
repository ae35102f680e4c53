"""Transformer-layer norms (port of
:mod:`apex_tpu.transformer.layers.layer_norm`).

The reference subclasses the fused norms only to mark their parameters
as sequence-parallel, so that their gradients are summed over the
tensor-parallel group.  At tensor-parallel size 1 there is nothing to
sum: these are the fused norms themselves, and
:func:`mark_sequence_parallel_params` names the parameters the summing
would cover.  ``allreduce_sequence_parallel_gradients`` needs a
tensor-parallel group and comes with 3D parallelism.
"""

from apex_tpu_torch.normalization.fused_layer_norm import (
    FusedLayerNorm,
    FusedRMSNorm,
    MixedFusedLayerNorm,
    MixedFusedRMSNorm,
)

__all__ = [
    "FastLayerNorm",
    "FusedLayerNorm",
    "FusedRMSNorm",
    "MixedFusedLayerNorm",
    "MixedFusedRMSNorm",
    "mark_sequence_parallel_params",
]

# the persistent-kernel LayerNorm of the reference computes the same
# function, so it is the same module
FastLayerNorm = FusedLayerNorm

_SP_PARAM_PATH_MARKERS = ("layernorm", "layer_norm", "norm")


def mark_sequence_parallel_params(path: str) -> bool:
    """True if a parameter path belongs to a replicated norm's parameter
    (the set the reference marks ``sequence_parallel``)."""
    lowered = path.lower()
    return any(m in lowered for m in _SP_PARAM_PATH_MARKERS)
