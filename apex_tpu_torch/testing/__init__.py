"""Testing harnesses of the port (counterpart of :mod:`apex_tpu.testing`):
fault injection for checkpoints and the fleet (:mod:`.faults`), the
crash/resume trainer (:mod:`.crash_resume`), the L1 traces (:mod:`.l1`)
and the card A/B timers (:mod:`.kernel_ab`, :mod:`.step_ab`)."""
