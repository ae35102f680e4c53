"""Optional extensions (counterpart of :mod:`apex_tpu.contrib`, the
reference's ``apex/contrib``).

Ported: :mod:`~apex_tpu_torch.contrib.multihead_attn`
(``SelfMultiheadAttn``, ``EncdecMultiheadAttn``).  Still queued in
ROADMAP.md: the ZeRO optimizers of ``contrib/optimizers`` (section A.5),
and ``focal_loss``, ``group_norm``, ``index_mul_2d``, ``spatial``,
``transducer`` and ``sparsity`` (section A.6).
"""

from apex_tpu_torch.contrib import multihead_attn  # noqa: F401
from apex_tpu_torch.contrib.multihead_attn import (  # noqa: F401
    EncdecMultiheadAttn,
    SelfMultiheadAttn,
)
