"""Resilience (counterpart of :mod:`apex_tpu.resilience`): the unified
non-finite sentinel and the SIGTERM preemption guard.  The rest of the
package (the checkpoint manager and resharding) is not ported yet
(ROADMAP.md, section A.2)."""

from apex_tpu_torch.resilience.preemption import PreemptionGuard
from apex_tpu_torch.resilience.sentinel import (  # noqa: F401
    SentinelState,
    guarded_optimizer_step,
    sentinel_guarded_apply,
    sentinel_init,
    sentinel_update,
)

__all__ = ["PreemptionGuard", "SentinelState", "sentinel_init",
           "sentinel_update", "sentinel_guarded_apply",
           "guarded_optimizer_step"]
