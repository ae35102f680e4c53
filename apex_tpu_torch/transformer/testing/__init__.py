"""Model definitions of the port (counterpart of
:mod:`apex_tpu.transformer.testing`)."""
