"""Tree helpers (counterpart of :mod:`apex_tpu.utils`): the flat and
chunked buffers and the norms of :mod:`apex_tpu_torch.utils.tree`.  The
RNG policy and the timers are not ported yet (ROADMAP.md, section A.6)."""

from apex_tpu_torch.utils import tree  # noqa: F401
from apex_tpu_torch.utils.tree import (  # noqa: F401
    chunked_per_leaf_max_abs,
    chunked_per_leaf_sumsq,
    flatten_to_buffer,
    flatten_to_chunked,
    per_leaf_l2_norms,
    tree_l2_norm,
    tree_size,
    unflatten_from_buffer,
    unflatten_from_chunked,
)
