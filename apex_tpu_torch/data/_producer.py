"""Child-process teardown (port of :mod:`apex_tpu.data._producer`).

:func:`reap_process` is the one reaping ladder the fleet's replicas use.
The producer loader and ``make_dp_samplers`` of the reference module
come with the data loaders (ROADMAP.md §A.4).
"""

from __future__ import annotations

import logging

__all__ = ["reap_process"]


def reap_process(proc, timeout: float, what: str = "worker") -> None:
    """Bounded process teardown — join, then escalate terminate -> kill,
    so a wedged child can never hang its parent's shutdown."""
    proc.join(timeout=max(0.0, timeout))
    if not proc.is_alive():
        return
    logging.getLogger(__name__).warning(
        "%s %s did not exit in %.1fs; terminating",
        what, getattr(proc, "pid", "?"), timeout)
    proc.terminate()
    proc.join(timeout=2.0)
    if proc.is_alive():
        proc.kill()
        proc.join(timeout=2.0)
