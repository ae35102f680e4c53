"""Optional extensions (counterpart of :mod:`apex_tpu.contrib`, the
reference's ``apex/contrib``).

Ported: :mod:`~apex_tpu_torch.contrib.multihead_attn`
(``SelfMultiheadAttn``, ``EncdecMultiheadAttn``) and
:mod:`~apex_tpu_torch.contrib.optimizers` (the ZeRO-sharded
``DistributedFusedAdam`` and ``DistributedFusedLAMB``).  Still queued in
ROADMAP.md: ``focal_loss``, ``group_norm``, ``index_mul_2d``,
``spatial``, ``transducer`` and ``sparsity`` (section A.6).
"""

from apex_tpu_torch.contrib import multihead_attn, optimizers  # noqa: F401
from apex_tpu_torch.contrib.multihead_attn import (  # noqa: F401
    EncdecMultiheadAttn,
    SelfMultiheadAttn,
)
