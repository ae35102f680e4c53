"""Serving runtime of the port (counterpart of :mod:`apex_tpu.serving`):
paged KV cache, the paged-attention and fused-epilogue kernels, sampling,
the decode model, the continuous-batching scheduler and the engine."""

from apex_tpu_torch.serving.engine import ServingConfig, ServingEngine
from apex_tpu_torch.serving.kv_cache import (
    BlockAllocator,
    KVCacheConfig,
    OutOfBlocksError,
    PrefixCache,
    init_kv_arena,
)
from apex_tpu_torch.serving.model import DecodeModel
from apex_tpu_torch.serving.sampling import SamplingParams, sample_tokens
from apex_tpu_torch.serving.scheduler import Request, RequestState, Scheduler

__all__ = [
    "BlockAllocator",
    "DecodeModel",
    "KVCacheConfig",
    "OutOfBlocksError",
    "PrefixCache",
    "Request",
    "RequestState",
    "SamplingParams",
    "Scheduler",
    "ServingConfig",
    "ServingEngine",
    "init_kv_arena",
    "sample_tokens",
]
