"""Transformer-layer norms (counterpart of
:mod:`apex_tpu.transformer.layers`)."""
