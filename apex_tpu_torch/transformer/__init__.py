"""Transformer building blocks of the port (counterpart of
:mod:`apex_tpu.transformer`): tensor and sequence parallelism
(:mod:`~apex_tpu_torch.transformer.tensor_parallel`), rotary embeddings,
and ``parallel_state``, the reference's name for the rank grid
(:mod:`apex_tpu_torch.parallel.mesh`).

Not ported yet (ROADMAP.md, section A.2): ``pipeline_parallel`` with
``get_forward_backward_func``, and ``context_parallel``.
"""

from apex_tpu_torch.parallel import mesh as parallel_state
from apex_tpu_torch.transformer import rope, tensor_parallel

__all__ = ["parallel_state", "tensor_parallel", "rope"]
