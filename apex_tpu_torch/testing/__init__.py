"""Testing harnesses of the port (counterpart of :mod:`apex_tpu.testing`)."""
