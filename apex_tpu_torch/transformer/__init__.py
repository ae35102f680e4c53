"""Transformer building blocks of the port (counterpart of
:mod:`apex_tpu.transformer`); what serving and single-device
training need."""
