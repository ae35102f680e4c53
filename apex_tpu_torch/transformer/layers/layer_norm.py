"""Transformer-layer LayerNorm (port of
:mod:`apex_tpu.transformer.layers.layer_norm`).  At tensor-parallel size 1
there is no sequence-parallel gradient to mark, so this is the fused
LayerNorm itself."""

from apex_tpu_torch.normalization.fused_layer_norm import FusedLayerNorm

__all__ = ["FusedLayerNorm"]
