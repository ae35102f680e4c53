"""Tensor-parallel layers at tensor-parallel size 1 (counterpart of
:mod:`apex_tpu.transformer.tensor_parallel`)."""

from apex_tpu_torch.transformer.tensor_parallel.layers import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    linear_with_grad_accumulation,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import divide

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "divide",
           "linear_with_grad_accumulation"]
