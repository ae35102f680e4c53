"""Transformer building blocks of the port (counterpart of
:mod:`apex_tpu.transformer`): tensor and sequence parallelism
(:mod:`~apex_tpu_torch.transformer.tensor_parallel`), the pipeline
schedules (:mod:`~apex_tpu_torch.transformer.pipeline_parallel`), rotary
embeddings, and ``parallel_state``, the reference's name for the rank grid
(:mod:`apex_tpu_torch.parallel.mesh`).

Not ported yet (ROADMAP.md, section A.2): ``context_parallel``.
"""

from apex_tpu_torch.parallel import mesh as parallel_state
from apex_tpu_torch.transformer import pipeline_parallel, rope, tensor_parallel
from apex_tpu_torch.transformer.pipeline_parallel import (
    get_forward_backward_func,
)

__all__ = ["parallel_state", "tensor_parallel", "pipeline_parallel", "rope",
           "get_forward_backward_func"]
