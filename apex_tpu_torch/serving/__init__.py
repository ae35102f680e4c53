"""Serving runtime of the port (counterpart of :mod:`apex_tpu.serving`):
paged KV cache with its export ledger, the paged-attention (and its
unfused A/B lowering), fused-epilogue and LoRA-delta kernels, sampling,
the decode model, the continuous-batching scheduler, n-gram speculative
drafting, the multi-LoRA adapter arena and the engine, at any
tensor-parallel size.  Not ported yet: the checkpoint restores and the
fleet (ROADMAP.md, section A.3)."""

from apex_tpu_torch.serving.engine import ServingConfig, ServingEngine
from apex_tpu_torch.serving.kv_cache import (
    BlockAllocator,
    KVCacheConfig,
    OutOfBlocksError,
    PrefixCache,
    init_kv_arena,
)
from apex_tpu_torch.serving.lora import (
    AdapterArena,
    LoRAConfig,
    OutOfAdapterSlotsError,
    init_adapter_weights,
)
from apex_tpu_torch.serving.paged_attention import (
    paged_attention_decode,
    paged_attention_decode_unfused,
    paged_prefill_attention,
    paged_prefill_attention_unfused,
)
from apex_tpu_torch.serving.model import DecodeModel
from apex_tpu_torch.serving.sampling import SamplingParams, sample_tokens
from apex_tpu_torch.serving.scheduler import Request, RequestState, Scheduler
from apex_tpu_torch.serving.speculative import (
    NGramProposer,
    SpeculativeConfig,
    ngram_propose,
)

__all__ = [
    "AdapterArena",
    "BlockAllocator",
    "DecodeModel",
    "KVCacheConfig",
    "LoRAConfig",
    "NGramProposer",
    "OutOfAdapterSlotsError",
    "OutOfBlocksError",
    "PrefixCache",
    "Request",
    "RequestState",
    "SamplingParams",
    "Scheduler",
    "ServingConfig",
    "ServingEngine",
    "SpeculativeConfig",
    "init_adapter_weights",
    "init_kv_arena",
    "ngram_propose",
    "paged_attention_decode",
    "paged_attention_decode_unfused",
    "paged_prefill_attention",
    "paged_prefill_attention_unfused",
    "sample_tokens",
]
