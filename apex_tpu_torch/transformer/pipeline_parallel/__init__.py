"""Pipeline parallelism: the rotation schedules, the stage-to-stage
transfers and the microbatch utilities (counterpart of
:mod:`apex_tpu.transformer.pipeline_parallel`)."""

from apex_tpu_torch.transformer.pipeline_parallel import (  # noqa: F401
    p2p_communication,
    utils,
)
from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
    forward_backward_no_pipelining,
    forward_backward_pipelining_with_interleaving,
    forward_backward_pipelining_without_interleaving,
    get_forward_backward_func,
    pipeline_apply,
    split_into_microbatches,
    stack_stage_params,
)

__all__ = [
    "get_forward_backward_func",
    "forward_backward_no_pipelining",
    "forward_backward_pipelining_without_interleaving",
    "forward_backward_pipelining_with_interleaving",
    "pipeline_apply",
    "split_into_microbatches",
    "stack_stage_params",
    "utils",
]
