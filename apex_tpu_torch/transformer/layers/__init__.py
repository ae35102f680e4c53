"""Transformer-layer norms (counterpart of
:mod:`apex_tpu.transformer.layers`)."""

from apex_tpu_torch.transformer.layers.layer_norm import (
    FastLayerNorm,
    FusedLayerNorm,
    FusedRMSNorm,
    MixedFusedLayerNorm,
    MixedFusedRMSNorm,
    allreduce_sequence_parallel_gradients,
    mark_sequence_parallel_params,
)

__all__ = [
    "FastLayerNorm",
    "FusedLayerNorm",
    "FusedRMSNorm",
    "MixedFusedLayerNorm",
    "MixedFusedRMSNorm",
    "allreduce_sequence_parallel_gradients",
    "mark_sequence_parallel_params",
]
