"""Testing harnesses of the port (counterpart of :mod:`apex_tpu.testing`):
the fleet's fault injection (:mod:`.faults`), the L1 traces (:mod:`.l1`)
and the card A/B timers (:mod:`.kernel_ab`, :mod:`.step_ab`)."""
