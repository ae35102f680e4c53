"""Transformer building blocks of the port (counterpart of
:mod:`apex_tpu.transformer`): tensor and sequence parallelism
(:mod:`~apex_tpu_torch.transformer.tensor_parallel`), the pipeline
schedules (:mod:`~apex_tpu_torch.transformer.pipeline_parallel`), rotary
embeddings, context parallelism (ring and Ulysses attention,
:mod:`~apex_tpu_torch.transformer.context_parallel`), the Switch
mixture of experts (:mod:`~apex_tpu_torch.transformer.moe`), and
``parallel_state``, the reference's name for the rank grid
(:mod:`apex_tpu_torch.parallel.mesh`).
"""

from apex_tpu_torch.parallel import mesh as parallel_state
from apex_tpu_torch.transformer import (
    context_parallel,
    moe,
    pipeline_parallel,
    rope,
    tensor_parallel,
)
from apex_tpu_torch.transformer.pipeline_parallel import (
    get_forward_backward_func,
)

__all__ = ["parallel_state", "tensor_parallel", "pipeline_parallel",
           "context_parallel", "moe", "rope", "get_forward_backward_func"]
