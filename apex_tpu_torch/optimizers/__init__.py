"""Fused optimizers of the port (counterpart of :mod:`apex_tpu.optimizers`);
this slice carries FusedAdam."""

from apex_tpu_torch.optimizers.fused_adam import FusedAdam

__all__ = ["FusedAdam"]
