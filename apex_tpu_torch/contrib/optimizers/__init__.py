"""Distributed (ZeRO-sharded) optimizers (port of
:mod:`apex_tpu.contrib.optimizers`, the reference's
``apex/contrib/optimizers``)."""

from apex_tpu_torch.contrib.optimizers.distributed_fused_adam import (
    DistributedFusedAdam,
)
from apex_tpu_torch.contrib.optimizers.distributed_fused_lamb import (
    DistributedFusedLAMB,
)

__all__ = ["DistributedFusedAdam", "DistributedFusedLAMB"]
