"""Normalization of the port (counterpart of
:mod:`apex_tpu.normalization`): fused LayerNorm and RMSNorm, affine and
not, with fp32 statistics, the mixed-dtype modules and the
memory-efficient backward."""

from apex_tpu_torch.normalization.fused_layer_norm import (
    FusedLayerNorm,
    FusedRMSNorm,
    MixedFusedLayerNorm,
    MixedFusedRMSNorm,
    fused_layer_norm,
    fused_layer_norm_affine,
    fused_rms_norm,
    fused_rms_norm_affine,
    manual_rms_norm,
)

__all__ = [
    "fused_layer_norm",
    "fused_layer_norm_affine",
    "fused_rms_norm",
    "fused_rms_norm_affine",
    "FusedLayerNorm",
    "FusedRMSNorm",
    "MixedFusedLayerNorm",
    "MixedFusedRMSNorm",
    "manual_rms_norm",
]
