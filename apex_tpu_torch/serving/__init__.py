"""Serving runtime of the port (counterpart of :mod:`apex_tpu.serving`):
paged KV cache with its export ledger, the paged-attention (and its
unfused A/B lowering), fused-epilogue and LoRA-delta kernels, sampling,
the decode model, the continuous-batching scheduler, n-gram speculative
drafting, the multi-LoRA adapter arena and the engine, at any
tensor-parallel size; and the fleet over it: replicas as spawned
processes (:mod:`.replica`), the mp-queue and framed-TCP transports
(:mod:`.transport`), the router with failover, rollout, shedding, tenant
fairness and prefill/decode disaggregation with KV migration
(:mod:`.fleet`), and the SLO autopilot (:mod:`.autopilot`); and the
checkpoint restores that put a trained GPT and its adapters on the
engine (:mod:`.loader`'s ``restore_gpt_for_serving``,
``restore_adapter_for_serving``)."""

from apex_tpu_torch.serving.engine import ServingConfig, ServingEngine
from apex_tpu_torch.serving.replica import ReplicaProcess, ReplicaSpec
from apex_tpu_torch.serving.fleet import FleetRequest, FleetRouter
from apex_tpu_torch.serving.autopilot import (
    AutopilotConfig,
    FleetAutopilot,
    trace_attribution,
)
from apex_tpu_torch.serving.transport import (
    SocketTransport,
    TransportError,
    TransportServer,
    replica_serve,
    start_replica_server,
)
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
    restore_adapter_for_serving,
)
from apex_tpu_torch.serving.loader import restore_gpt_for_serving
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
    "AutopilotConfig",
    "FleetAutopilot",
    "FleetRequest",
    "FleetRouter",
    "ReplicaProcess",
    "ReplicaSpec",
    "SocketTransport",
    "TransportError",
    "TransportServer",
    "replica_serve",
    "start_replica_server",
    "trace_attribution",
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
    "restore_adapter_for_serving",
    "restore_gpt_for_serving",
    "sample_tokens",
]
