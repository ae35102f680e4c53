"""Tensor and sequence parallelism (counterpart of
:mod:`apex_tpu.transformer.tensor_parallel`), with the ring-overlapped
collective matmul (``gather_matmul``, ``matmul_scatter``)."""

from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.data import broadcast_data
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    linear_with_grad_accumulation,
    parallel_init,
)
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    copy_to_tensor_model_parallel_region,
    gather_from_sequence_parallel_region,
    gather_from_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
    reduce_scatter_to_sequence_parallel_region,
    scatter_to_sequence_parallel_region,
    scatter_to_tensor_model_parallel_region,
)
from apex_tpu_torch.transformer.tensor_parallel.overlap import (
    gather_matmul,
    matmul_scatter,
)
from apex_tpu_torch.transformer.tensor_parallel.partition import (
    DEFAULT_RULES,
    PartitionSpec,
    gather_params,
    infer_param_specs,
    shard_params,
)
from apex_tpu_torch.transformer.tensor_parallel.random import (
    RngStatesTracker,
    checkpoint,
    data_parallel_rng_key,
    get_rng_states_tracker,
    model_parallel_rng_key,
    model_parallel_seed,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import (
    VocabUtility,
    divide,
    ensure_divisibility,
    split_tensor_along_last_dim,
)

__all__ = [
    "vocab_parallel_cross_entropy",
    "gather_matmul",
    "matmul_scatter",
    "DEFAULT_RULES",
    "PartitionSpec",
    "infer_param_specs",
    "shard_params",
    "gather_params",
    "broadcast_data",
    "ColumnParallelLinear",
    "RowParallelLinear",
    "VocabParallelEmbedding",
    "linear_with_grad_accumulation",
    "parallel_init",
    "copy_to_tensor_model_parallel_region",
    "gather_from_sequence_parallel_region",
    "gather_from_tensor_model_parallel_region",
    "reduce_from_tensor_model_parallel_region",
    "reduce_scatter_to_sequence_parallel_region",
    "scatter_to_sequence_parallel_region",
    "scatter_to_tensor_model_parallel_region",
    "RngStatesTracker",
    "checkpoint",
    "data_parallel_rng_key",
    "get_rng_states_tracker",
    "model_parallel_rng_key",
    "model_parallel_seed",
    "VocabUtility",
    "divide",
    "ensure_divisibility",
    "split_tensor_along_last_dim",
]
