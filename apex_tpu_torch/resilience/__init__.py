"""Resilience (counterpart of :mod:`apex_tpu.resilience`): the survival
layer over the fast paths.

- :mod:`.manager` — :class:`CheckpointManager`: crash-safe checkpoint
  lifecycle (atomic verified saves, keep-last-k retention, retry with
  backoff on transient I/O, ``restore_latest`` falling back past corrupt
  checkpoints) over the flat and sharded layouts of
  :mod:`apex_tpu_torch.checkpoint`.
- :mod:`.sentinel` — the unified non-finite sentinel:
  :class:`SentinelState` and the guarded optimizer apply, threaded
  through the 3D GPT trainer so an overflow step skips the update on
  every rank with no host sync.
- :mod:`.preemption` — :class:`PreemptionGuard`: SIGTERM-driven clean
  shutdown (drain in-flight async saves, final checkpoint, exit 0).
- :mod:`.reshard` — restore-anywhere: :class:`ShardingSpec` (the
  logical-state description embedded in every spec-carrying manifest)
  and :func:`restore_resharded`, mapping a committed checkpoint onto
  another grid (pipeline layer stacks re-factored) bit for bit.

The matching fault injection is in :mod:`apex_tpu_torch.testing.faults`.
"""

from apex_tpu_torch.resilience.manager import CheckpointManager
from apex_tpu_torch.resilience.preemption import PreemptionGuard
from apex_tpu_torch.resilience.reshard import (
    ShardingSpec,
    build_spec,
    load_logical,
    restore_resharded,
)
from apex_tpu_torch.resilience.sentinel import (  # noqa: F401
    SentinelState,
    guarded_optimizer_step,
    sentinel_guarded_apply,
    sentinel_init,
    sentinel_update,
)

__all__ = [
    "CheckpointManager",
    "PreemptionGuard",
    "SentinelState",
    "ShardingSpec",
    "build_spec",
    "guarded_optimizer_step",
    "load_logical",
    "restore_resharded",
    "sentinel_guarded_apply",
    "sentinel_init",
    "sentinel_update",
]
