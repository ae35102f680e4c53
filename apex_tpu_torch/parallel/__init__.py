"""Process groups, collectives and data parallelism (counterpart of
:mod:`apex_tpu.parallel`).

The JAX package declares its parallelism as shardings over one named
device mesh.  Here each process is one rank of ``torch.distributed``:
:func:`initialize_distributed` joins the job (NCCL on the card, gloo on
the CPU), :func:`initialize_model_parallel` lays the ranks on the
reference's ``(dcn, dp, pp, cp, tp)`` grid with a process group per set
of axes, :mod:`~apex_tpu_torch.parallel.collectives` runs the
collectives over those axes by name,
:class:`DistributedDataParallel` reduces the gradients over the data
axes after the backward, and :class:`SyncBatchNorm` sums its statistics
(and their gradients) over them; ``LARC`` is
:class:`apex_tpu_torch.optimizers.LARC`, as in the reference.

Not ported yet (ROADMAP.md, section A.5): ``zero_init`` and
``zero_data_parallel_train_step``.
"""

from apex_tpu_torch.optimizers.larc import LARC  # noqa: F401
from apex_tpu_torch.parallel import collectives, launch  # noqa: F401
from apex_tpu_torch.parallel import sync_batchnorm  # noqa: F401
from apex_tpu_torch.parallel.distributed import (  # noqa: F401
    DistributedDataParallel,
    all_reduce_gradients,
    data_parallel_train_step,
    dp_shard_batch,
    grad_accumulation,
    host_dp_ranks,
    replicate,
)
from apex_tpu_torch.parallel.launch import initialize_distributed  # noqa: F401
from apex_tpu_torch.parallel.mesh import (  # noqa: F401
    CONTEXT_AXIS,
    DATA_AXIS,
    PIPELINE_AXIS,
    TENSOR_AXIS,
    MeshSpec,
    destroy_model_parallel,
    get_context_parallel_world_size,
    get_data_parallel_world_size,
    get_mesh,
    get_pipeline_model_parallel_split_rank,
    get_pipeline_model_parallel_world_size,
    get_tensor_model_parallel_world_size,
    get_virtual_pipeline_model_parallel_rank,
    get_virtual_pipeline_model_parallel_world_size,
    initialize_model_parallel,
    model_parallel_is_initialized,
    set_virtual_pipeline_model_parallel_rank,
)
from apex_tpu_torch.parallel.sync_batchnorm import (  # noqa: F401
    SyncBatchNorm,
    sync_batch_norm_stats,
)
