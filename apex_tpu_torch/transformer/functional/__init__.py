"""The fused softmax family at the reference's import path (port of
:mod:`apex_tpu.transformer.functional`): re-exported from
:mod:`apex_tpu_torch.ops.softmax`."""

from apex_tpu_torch.ops.softmax import (
    AttnMaskType,
    FusedScaleMaskSoftmax,
    generic_scaled_masked_softmax,
    scaled_masked_softmax,
    scaled_softmax,
    scaled_upper_triang_masked_softmax,
)

__all__ = [
    "AttnMaskType",
    "FusedScaleMaskSoftmax",
    "scaled_softmax",
    "scaled_masked_softmax",
    "scaled_upper_triang_masked_softmax",
    "generic_scaled_masked_softmax",
]
