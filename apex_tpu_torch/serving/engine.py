"""The serving engine: continuous batching over the paged-cache decode.

Port of :mod:`apex_tpu.serving.engine`.  One object owns the runtime: the
decode model, the KV arenas (updated in place by every step), the host
scheduler, the metrics and the drain.

Step anatomy (:meth:`ServingEngine.step`)::

    [drain?] -> admit waiting requests      (slot + first-chunk blocks;
                                             prefix-cache hits shared,
                                             not recomputed)
             -> one chunked-prefill call    (each prefilling slot advances
                                             <= prefill_len tokens)
             -> grow decode blocks          (evict cached LRU, then
                                             preempt newest)
             -> one batched decode step     (paged attention + sampling)
             -> append/finish bookkeeping on the host

Every call has the fixed ``[max_batch, prefill_len]`` or ``[max_batch,
spec_width]`` shape; request churn, chunking, prefix hits, preemption,
draft counts, live knobs and the adapter mix only change values.

- **Speculative decoding** (``ServingConfig.speculative``): the decode
  step becomes the ``[max_batch, k + 1]`` verify.  The proposer drafts
  from each request's own stream; drafted rows take blocks from the free
  list or the prefix cache only, never by preempting a neighbour (a short
  grow truncates the draft); one host transfer per tick brings back the
  tokens and the accepted counts together.
- **Multi-LoRA** (``ServingConfig.lora``): :meth:`ServingEngine.
  register_adapter` loads or hot-swaps an adapter into the arena;
  ``SamplingParams.adapter_id`` picks it per request (pinned from submit
  to finish; unknown ids are ``REJECTED``), and each call gathers the
  per-slot adapter rows as data.
- **Admission** (``ServingConfig.admission``): ``"occupancy"`` (blocks
  on demand, eviction, preemption, prefix caching unless
  ``prefix_caching=False``) or the worst-case ``"reserve"`` baseline.
- **Live knobs** (:meth:`ServingEngine.set_knobs`): caps on the prefill
  chunk and the draft count that change how much of each fixed-shape
  call is used, never its shape.
- **KV migration** (:meth:`ServingEngine.export_request`,
  :meth:`ServingEngine.import_request`): a running request's block run
  leaves one engine as per-block host payloads, pinned until
  :meth:`ServingEngine.release_export`, and continues on another engine
  bit for bit as it would have run uninterrupted.
- **Drain** (:meth:`ServingEngine.drain`, or a tripped
  :class:`~apex_tpu_torch.resilience.PreemptionGuard`, which a
  :class:`~apex_tpu_torch.observability.metrics.HeartbeatMonitor` can
  trip): no more admissions, the running requests deliver, the queue is
  cancelled.
- **Tensor parallelism** (``mesh=``): one engine per rank of the tp
  group, each holding its shard; see :class:`ServingEngine`.

Metric catalog (recorded into the engine's :class:`~apex_tpu_torch.
observability.metrics.MetricRegistry`, as the reference records it):

- ``serving/ttft_ms`` histogram (samples kept: p50/p99), submit to first
  token, per request; ``serving/tpot_ms`` histogram, the interval
  between a request's tokens;
- ``serving/tokens_generated``, ``serving/requests_finished``,
  ``serving/requests_cancelled``, ``serving/requests_rejected`` counters
  (rejected: refused at submit, during a drain or naming an unknown
  adapter; cancelled: accepted, then drained out of the queue);
- ``serving/active_slots``, ``serving/free_blocks`` and
  ``serving/kv_occupancy`` gauges (the pool's fraction holding live or
  cached KV);
- ``serving/prefix_cache_hits``, ``serving/preemptions``,
  ``serving/evictions`` and ``serving/preemption_drains`` counters;
- ``serving/spec_proposed`` / ``serving/spec_accepted`` counters and the
  ``serving/spec_acceptance`` gauge;
- ``serving/adapter_loads`` / ``serving/adapter_evictions`` counters and
  the ``serving/adapter_active`` gauge;
- ``serving/kv_export_blocks``, ``serving/kv_import_blocks`` and
  ``serving/kv_export_aborts`` counters;
- ``serving/mfu`` gauge, the decode call's MFU where the card's peak is
  known (``introspect()["mfu_reason"]`` says why otherwise).

The engine also keeps its own attribute counters: ``tokens_generated``,
``requests_finished``, ``requests_cancelled``, ``requests_rejected``,
``prefill_calls``, ``decode_calls``, ``spec_proposed``, ``spec_accepted``,
``spec_by_adapter`` and the ``ttft_ms`` / ``tpot_ms`` sample lists.

With a flight recorder armed (:mod:`apex_tpu_torch.observability.
timeline`) the engine logs each request's lifecycle keyed by request id
(the event kinds are listed there).

Not ported: ``restore_gpt_for_serving`` and
``restore_adapter_for_serving``, the checkpoint restores (with
``serving/loader.py``, ``checkpoint.py`` and the resilience manager;
ROADMAP.md, section A.3), and the fleet that drives engines across
processes (``replica``, ``transport``, ``fleet``, ``autopilot``; section
A.3).
"""

from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.observability import timeline
from apex_tpu_torch.observability.metrics import (
    default_registry,
    mfu_or_reason,
)
from apex_tpu_torch.parallel import collectives as cc
from apex_tpu_torch.parallel import mesh as mesh_lib
from apex_tpu_torch.parallel.mesh import TENSOR_AXIS
from apex_tpu_torch.serving.kv_cache import (
    ExportLedger,
    KVCacheConfig,
    init_kv_arena,
    tp_world,
)
from apex_tpu_torch.serving.lora import (
    AdapterArena,
    LoRAConfig,
    init_adapter_arena,
    init_adapter_weights,
    pack_adapter_values,
    shard_adapter_values,
)
from apex_tpu_torch.serving.model import DecodeModel
from apex_tpu_torch.serving.sampling import SamplingParams
from apex_tpu_torch.serving.scheduler import (
    ADMISSIONS,
    Request,
    RequestState,
    Scheduler,
    trace_fields,
)
from apex_tpu_torch.serving.speculative import NGramProposer, SpeculativeConfig
from apex_tpu_torch.transformer.testing.gpt_parallel_train import GPT3DParams
from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
    TransformerConfig,
)

__all__ = ["ServingConfig", "ServingEngine"]


def _torch_dtype(x) -> Optional[torch.dtype]:
    """The torch dtype of a tensor or numpy array (``None`` for anything
    else, or a numpy dtype torch lacks)."""
    if isinstance(x, torch.Tensor):
        return x.dtype
    if isinstance(x, np.ndarray):
        try:
            return torch.from_numpy(np.empty(0, x.dtype)).dtype
        except TypeError:
            return None
    return None


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Static shape of the runtime.

    ``prefill_len`` is the per-slot chunk width of the batched chunked
    prefill (default ``max_seq``).  ``cache_dtype=torch.int8`` stores the
    KV arenas quantized with per-row fp32 scales; the default is the
    model's param dtype.  ``fused_attention=False`` attends through the
    reference's separate-ops paged attention instead of K1 and K2, and
    ``fuse_epilogue=False`` runs the layers' bias/residual/LayerNorm
    epilogue as separate ops instead of K3 (the reference's A/B
    switches).  ``admission`` is ``"occupancy"`` (blocks on demand,
    eviction, preemption) or the worst-case ``"reserve"`` baseline;
    ``prefix_caching`` shares prompt-prefix blocks (occupancy only).
    ``speculative`` turns the decode step into the ``[max_batch, k + 1]``
    self-speculative verify; ``lora`` enables the multi-LoRA adapter
    arena.  ``None`` keeps either off.
    """

    max_batch: int = 8           # concurrent decode slots
    block_size: int = 16         # tokens per KV block
    max_seq: int = 256           # per-request context cap (prompt+output)
    n_blocks: Optional[int] = None   # arena size; default = worst case
    prefill_len: Optional[int] = None  # chunk width; default max_seq
    cache_dtype: Optional[torch.dtype] = None
    fused_attention: bool = True   # K1/K2 vs the separate-ops lowering
    fuse_epilogue: bool = True     # the K3 kernel vs separate ops
    admission: str = "occupancy"   # or "reserve" (the worst-case A/B)
    prefix_caching: bool = True    # share prompt-prefix blocks
    speculative: Optional[SpeculativeConfig] = None
    lora: Optional[LoRAConfig] = None

    def __post_init__(self):
        if self.admission not in ADMISSIONS:
            raise ValueError(
                f"admission must be 'occupancy' or 'reserve', got "
                f"{self.admission!r}")

    def resolve_n_blocks(self, max_blocks_per_request: int) -> int:
        if self.n_blocks is not None:
            return self.n_blocks
        return self.max_batch * max_blocks_per_request


class ServingEngine:
    """Continuous-batching runtime over a GPT checkpoint.

    ``params``: a :class:`~apex_tpu_torch.transformer.testing.
    gpt_parallel_train.GPT3DParams` (layer stack ``[L, ...]`` or
    ``[vpp, pp, ...]``, merged row-major to ``[L, ...]``), for instance
    from :func:`~apex_tpu_torch.serving.bridge.from_jax_params` or
    :func:`~apex_tpu_torch.transformer.testing.gpt_parallel_train.
    init_gpt_params`.  ``device`` defaults to the CUDA device.

    ``mesh``: the :class:`~apex_tpu_torch.parallel.mesh.RankMesh` of
    :func:`~apex_tpu_torch.parallel.initialize_model_parallel`; the
    engine then serves over its ``tp_axis`` group, one engine per rank.
    It takes the **full** ``params`` and keeps this rank's shard, and
    holds this rank's heads of the KV arenas and its shard of the
    adapter arena.  Every rank must get the same calls in the same order
    (``submit``, ``set_knobs``, ``register_adapter``, ``export_request``,
    ``import_request``, ``step``); the schedulers then decide the same,
    the gathered logits are the same bytes on every rank, and so are the
    sampled tokens.  The wall clock feeds only TTFT and TPOT, no
    decision.  ``mesh=None`` serves on one rank with no collective.

    ``guard``: an optional :class:`~apex_tpu_torch.resilience.
    PreemptionGuard`; once it trips, the engine drains (no admissions,
    running requests deliver, waiting ones are cancelled).  At tp > 1 a
    guard's flag is agreed on by one MAX all-reduce over tp at the top of
    every :meth:`step` (a signal or a missed heartbeat reaches one rank
    only), so every rank must be given a guard, or none.

    ``heartbeat``: an optional :class:`~apex_tpu_torch.observability.
    metrics.HeartbeatMonitor`, beaten at the end of every :meth:`step`
    (after its results reached the host); wire its ``on_hang`` to the
    guard, and a wedged step turns into a drain.

    ``registry``: the :class:`~apex_tpu_torch.observability.metrics.
    MetricRegistry` the catalog records into (default: the process's).

    ``timeline_tick_every``: with a flight recorder armed, decode ticks
    are logged every N generated tokens of a request.

    **MFU.**  The reference reads its decode program's FLOPs from XLA's
    cost analysis; eager PyTorch compiles no program, so the engine
    counts each decode call's FLOPs from its shapes: the GEMMs over the
    call's fixed ``[max_batch, spec_width]`` rows (QKV, attention
    projection, MLP, LM head), the paged attention over each live row's
    context (two products of ``heads x head_dim`` per cached position,
    the work K1 and K2 do, so the kernels never count as zero), and with
    LoRA the gathered deltas' two products per projection.  The count is
    the whole model's over all tp ranks, and MFU divides by the call's
    host time (ending in the transfer of its tokens) times the card's
    peak times tp (:func:`~apex_tpu_torch.observability.metrics.
    mfu_or_reason`).
    """

    def __init__(self, config: TransformerConfig, serving: ServingConfig,
                 params: GPT3DParams, *, mesh=None,
                 tp_axis: str = TENSOR_AXIS, registry=None, guard=None,
                 heartbeat=None, timeline_tick_every: int = 8,
                 device=None):
        device = resolve_device(device)
        self.device = device
        self.serving = serving
        if mesh is not None and not (mesh_lib.model_parallel_is_initialized()
                                     and mesh is mesh_lib.get_mesh()):
            raise ValueError(
                "mesh must be the grid of "
                "apex_tpu_torch.parallel.initialize_model_parallel")
        self.mesh = mesh
        self.tp_axis = tp_axis
        self.tp = tp_world(mesh, tp_axis)
        self.tp_rank = mesh.coords[tp_axis] if mesh is not None else 0
        if (config.position_embedding_type == "learned"
                and config.max_position_embeddings < serving.max_seq):
            raise ValueError(
                f"max_seq ({serving.max_seq}) exceeds the learned position "
                f"table ({config.max_position_embeddings})")
        if timeline_tick_every < 1:
            raise ValueError(
                f"timeline_tick_every must be >= 1, got "
                f"{timeline_tick_every}")
        # the decode step's query width: k + 1 with speculation, else 1
        self.spec = serving.speculative
        self.spec_width = 1 + (self.spec.k if self.spec is not None else 0)
        if serving.max_seq < self.spec_width:
            raise ValueError(
                f"max_seq ({serving.max_seq}) below the speculative "
                f"width ({self.spec_width})")
        self.proposer = (NGramProposer(self.spec)
                         if self.spec is not None else None)
        cache_dtype = (serving.cache_dtype if serving.cache_dtype is not None
                       else config.param_dtype)
        probe = KVCacheConfig(
            n_layers=config.num_layers, n_blocks=1,
            block_size=serving.block_size, kv_heads=config.query_groups,
            head_dim=config.head_dim, max_seq=serving.max_seq,
            dtype=cache_dtype)
        self.cache = dataclasses.replace(
            probe,
            n_blocks=serving.resolve_n_blocks(probe.max_blocks_per_request))
        self.lora = serving.lora
        # the layers split over the mesh's tensor axis, or over none
        config = dataclasses.replace(
            config, tensor_axis=tp_axis if mesh is not None else None)
        self.model = DecodeModel(config, self.cache,
                                 fused_attention=serving.fused_attention,
                                 fuse_epilogue=serving.fuse_epilogue,
                                 lora=self.lora, device=device)
        self.model.load_params(params)
        self.prefill_len = serving.prefill_len or serving.max_seq
        # live knobs: caps on how much of each fixed-shape call is used
        # (None: the engine's default)
        self.live_prefill_chunk: Optional[int] = None
        self.live_spec_k: Optional[int] = None
        self.arenas: Tuple[torch.Tensor, ...] = init_kv_arena(
            self.cache, device, mesh=mesh, tp_axis=tp_axis)
        # multi-LoRA: the eight adapter tensors, updated in place by
        # register_adapter; each request's slot is per-call data
        self.adapter_arena: Optional[AdapterArena] = None
        self.adapters: Optional[Tuple[torch.Tensor, ...]] = None
        if self.lora is not None:
            self.adapter_arena = AdapterArena(self.lora.n_slots)
            self.adapters = init_adapter_arena(config, self.lora, device,
                                               mesh=mesh, tp_axis=tp_axis)
        self.scheduler = Scheduler(
            self.cache, serving.max_batch, chunk_tokens=self.prefill_len,
            admission=serving.admission,
            prefix_caching=serving.prefix_caching)
        # exported runs stay pinned until the receiver acknowledges them
        self.exports = ExportLedger(self.scheduler.allocator,
                                    self.scheduler.prefix_cache)
        self.registry = (registry if registry is not None
                         else default_registry())
        self.guard = guard
        self.heartbeat = heartbeat
        self.timeline_tick_every = timeline_tick_every
        self._tables = np.zeros(
            (serving.max_batch, self.cache.max_blocks_per_request), np.int32)
        self.steps = 0
        self.prefill_calls = 0
        self.decode_calls = 0
        self.tokens_generated = 0
        self.requests_finished = 0
        self.requests_cancelled = 0
        self.requests_rejected = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        # adapter_id -> [proposed, accepted], at most 256 ids
        self.spec_by_adapter: Dict[str, List[int]] = {}
        self.ttft_ms: List[float] = []
        self.tpot_ms: List[float] = []
        # the scheduler's lifetime counts already flushed to the registry
        self._counted_preempts = 0
        self._counted_hits = 0
        self._counted_evictions = 0
        # MFU of the last decode call (or why there is none)
        self._last_decode_s: Optional[float] = None
        self._last_decode_flops: Optional[float] = None
        self.mfu: Optional[float] = None
        self.mfu_reason: Optional[str] = "decode step has not run yet"

    # -------------------------------------------------------------- knobs

    def knobs(self) -> Dict[str, Any]:
        """The live knobs and the engine's fixed bounds on them."""
        return {"prefill_chunk": self.live_prefill_chunk,
                "spec_k": self.live_spec_k,
                "prefill_len": int(self.prefill_len),
                "spec_k_max": int(self.spec_width - 1)}

    def set_knobs(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """Apply live knobs; each key optional, ``None`` resets it.

        - ``prefill_chunk``: the most tokens a slot prefills per tick,
          clamped to ``[1, prefill_len]``;
        - ``spec_k``: the most tokens drafted per tick, clamped to
          ``[0, spec_width - 1]`` (0 stops drafting).

        Neither changes a call's shape.  An unknown key raises
        ``ValueError``.  Returns :meth:`knobs`, the state applied."""
        unknown = set(payload) - {"prefill_chunk", "spec_k"}
        if unknown:
            raise ValueError(f"unknown knobs: {sorted(unknown)}")
        if "prefill_chunk" in payload:
            v = payload["prefill_chunk"]
            if v is not None:
                v = int(v)
                if v < 1:
                    raise ValueError(
                        f"prefill_chunk must be >= 1, got {v}")
                v = min(v, int(self.prefill_len))
            self.live_prefill_chunk = v
            # admission sizes a request's first chunk by the same cap
            self.scheduler.chunk_tokens = (
                v if v is not None else int(self.prefill_len))
        if "spec_k" in payload:
            v = payload["spec_k"]
            if v is not None:
                v = int(v)
                if v < 0:
                    raise ValueError(f"spec_k must be >= 0, got {v}")
                v = min(v, int(self.spec_width - 1))
            self.live_spec_k = v
        return self.knobs()

    @property
    def draining(self) -> bool:
        return self.scheduler.draining

    # -------------------------------------------------------------- submit

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               eos_id: Optional[int] = None,
               sampling: Optional[SamplingParams] = None,
               trace: Optional[dict] = None) -> Request:
        """Queue a request.  One submitted into a drain window, or naming
        an adapter that is not resident, comes back ``REJECTED`` (never
        queued); a known adapter is pinned until the request ends.
        ``trace`` (``{"trace_id": ..., "attempt": ...}``) tags the
        request's timeline events."""
        if len(np.shape(prompt)) != 1:
            raise ValueError(
                f"prompt must be 1-D, got shape {np.shape(prompt)}")
        req = self.scheduler.submit(prompt, max_new_tokens, eos_id,
                                    sampling)
        self._set_trace(req, trace)
        aid = sampling.adapter_id if sampling is not None else None
        if (aid is not None and req.state is not RequestState.REJECTED
                and (self.adapter_arena is None
                     or not self.adapter_arena.resident(aid))):
            self.scheduler.waiting.remove(req)
            req.state = RequestState.REJECTED
        timeline.emit("request_submit", rid=req.rid,
                      prompt_tokens=len(req.prompt),
                      max_new_tokens=max_new_tokens, **trace_fields(req))
        if req.state is RequestState.REJECTED:
            self._reject(req)
        elif aid is not None:
            # pinned for the request's whole life, queue wait included:
            # its adapter cannot be evicted from under it
            self._pin_adapter(aid, req)
        return req

    @staticmethod
    def _set_trace(req: Request, trace: Optional[dict]) -> None:
        if trace is not None:
            req.trace_id = trace.get("trace_id")
            req.trace_attempt = int(trace.get("attempt", 0))

    def _reject(self, req: Request) -> None:
        self.requests_rejected += 1
        self.registry.counter("serving/requests_rejected").inc()
        timeline.emit("request_reject", rid=req.rid, **trace_fields(req))

    def drain(self) -> List[Request]:
        """Cancel the queue; running requests keep decoding until their
        responses are delivered."""
        timeline.emit("preemption", wall_ts=time.time())
        cancelled = self.scheduler.drain()
        self.requests_cancelled += len(cancelled)
        if cancelled:
            self.registry.counter("serving/requests_cancelled").inc(
                len(cancelled))
        for req in cancelled:
            self._unpin_adapter(req)
            timeline.emit("request_cancel", rid=req.rid, **trace_fields(req))
        self.registry.counter("serving/preemption_drains").inc()
        return cancelled

    def _drain_requested(self) -> bool:
        """The guard's flag; at tp > 1 the MAX over the tp group, so a
        signal or a missed heartbeat seen on one rank drains them all."""
        if self.guard is None:
            return False
        flag = bool(self.guard.triggered)
        if self.tp > 1:
            t = torch.tensor([int(flag)], dtype=torch.int32,
                             device=self.device)
            flag = bool(cc.all_reduce_(t, self.tp_axis, "max").item())
        return flag

    # ------------------------------------------------------- KV migration

    def export_request(self, req: Request) -> Tuple[dict, List[tuple]]:
        """Take a RUNNING request's KV-block run out for migration to
        another engine.

        One gather per arena brings the run (``blocks_for(cache_len)``
        blocks) to the host, at tp > 1 with every rank's heads gathered,
        so the payload holds all ``kv_heads``; each block becomes one
        payload tuple of CPU tensors, ``(k, v)`` or ``(k, v, k_scale,
        v_scale)``, each ``[n_layers, block_size, kv_heads(, head_dim)]``.
        The run is then pinned in :attr:`exports` and the request leaves
        the scheduler with no finish event (its stream continues on the
        receiver); its own block refs free, and the run lives on at
        refcount 1 until :meth:`release_export`.

        Returns ``(meta, payloads)``.  Raises ``ValueError`` for a
        request not in an exportable state (still prefilling, no token
        emitted yet)."""
        if req.state is not RequestState.RUNNING or req.slot is None:
            raise ValueError(
                f"request {req.rid} is {req.state}, not exportable")
        if req.prefilling or not req.output_tokens:
            raise ValueError(
                f"request {req.rid} has not completed prefill + first "
                "token; nothing to migrate yet")
        seq = req.sequence_tokens()
        if req.cache_len != len(seq) - 1:
            raise ValueError(
                f"request {req.rid} cache_len {req.cache_len} out of "
                f"phase with its {len(seq)}-token stream")
        n_blocks = self.cache.blocks_for(req.cache_len)
        run = list(req.blocks[:n_blocks])
        idx = torch.tensor(run, dtype=torch.long, device=self.device)
        slabs = [a[:, idx] for a in self.arenas]
        if self.tp > 1:
            # the heads (dim 3) of every rank, in rank order
            slabs = [cc.all_gather(s, self.tp_axis, concat_axis=3)
                     for s in slabs]
        slabs = [s.cpu() for s in slabs]
        payloads = [tuple(s[:, j] for s in slabs) for j in range(n_blocks)]
        n_bytes = int(sum(s.numel() * s.element_size() for s in slabs))
        self.exports.pin(req.rid, run, seq[:req.cache_len], req.cache_len)
        self._tables[req.slot][:] = 0
        self.scheduler.finish(req)
        self._unpin_adapter(req)
        self.registry.counter("serving/kv_export_blocks").inc(n_blocks)
        timeline.emit("request_export", rid=req.rid,
                      tokens=len(req.output_tokens), blocks=n_blocks,
                      **trace_fields(req))
        meta = {
            "cache_len": req.cache_len,
            "n_blocks": n_blocks,
            "n_out": len(req.output_tokens),
            "block_size": self.cache.block_size,
            "n_layers": self.cache.n_layers,
            "kv_heads": self.cache.kv_heads,
            "head_dim": self.cache.head_dim,
            "dtype": str(self.cache.dtype).replace("torch.", ""),
            "bytes": n_bytes,
        }
        return meta, payloads

    def release_export(self, rid, *, ok: bool) -> None:
        """Drop the pin on an exported run (the receiver's
        acknowledgement, or an abort).  Either way the run's full blocks
        index into the local prefix cache (the KV is valid, and a failed
        migration's re-prefill sent back here then hits it).  A
        duplicate or stale call is a no-op."""
        self.exports.release(rid, to_cache=True)
        if not ok:
            self.registry.counter("serving/kv_export_aborts").inc()

    def _check_import_payloads(self, payloads: List[tuple]) -> None:
        """Refuse a malformed payload before anything is written: each
        block one slab per arena, of the block's full shape (all
        ``kv_heads``) and the arena's dtype (torch tensors or numpy
        arrays)."""
        want_shapes = [(a.shape[0], a.shape[2], self.cache.kv_heads)
                       + tuple(a.shape[4:]) for a in self.arenas]
        want_dtypes = [a.dtype for a in self.arenas]
        for j, p in enumerate(payloads):
            if len(p) != len(self.arenas):
                raise ValueError(
                    f"imported block {j} carries {len(p)} slabs, arena "
                    f"set has {len(self.arenas)}")
            for s, shape, dtype in zip(p, want_shapes, want_dtypes):
                got = _torch_dtype(s)
                if tuple(np.shape(s)) != shape or got != dtype:
                    raise ValueError(
                        f"imported block {j} slab shape/dtype "
                        f"{tuple(np.shape(s))}/{got} != arena "
                        f"{shape}/{dtype}")

    def import_request(self, prompt: Sequence[int], max_new_tokens: int,
                       eos_id: Optional[int] = None,
                       sampling: Optional[SamplingParams] = None,
                       trace: Optional[dict] = None, *,
                       cache_len: int,
                       payloads: List[tuple]) -> Request:
        """Admit a migrated request with its KV run written into the
        local arenas (the receiving side of :meth:`export_request`).

        ``prompt`` is the request's whole wire sequence so far (its
        prompt and every token already streamed), ``cache_len`` the
        tokens the run covers (``len(prompt) - 1``: the last wire token
        is recomputed here, which makes the continued stream the
        uninterrupted one), ``payloads`` the per-block slabs of all
        ``kv_heads``, from an engine of any tp (this rank keeps its
        heads).  The run lands in one indexed write per arena.  Raises on
        missing capacity or a malformed payload, before any write."""
        self._check_import_payloads(payloads)
        aid = sampling.adapter_id if sampling is not None else None
        if aid is not None and (self.adapter_arena is None
                                or not self.adapter_arena.resident(aid)):
            raise ValueError(
                f"adapter {aid!r} is not resident on this engine")
        req = self.scheduler.admit_imported(
            prompt, max_new_tokens, eos_id, sampling,
            cache_len=cache_len, n_blocks=len(payloads))
        self._set_trace(req, trace)
        timeline.emit("request_submit", rid=req.rid,
                      prompt_tokens=len(req.prompt),
                      max_new_tokens=max_new_tokens, imported=True,
                      **trace_fields(req))
        if req.state is RequestState.REJECTED:
            self._reject(req)
            return req
        if aid is not None:
            self._pin_adapter(aid, req)
        idx = torch.tensor(req.blocks[:len(payloads)], dtype=torch.long,
                           device=self.device)
        g_local = self.cache.kv_heads // self.tp
        for i, arena in enumerate(self.arenas):
            vals = torch.stack([torch.as_tensor(np.asarray(p[i]).copy())
                                if isinstance(p[i], np.ndarray) else p[i]
                                for p in payloads], dim=1)  # [L, n, bs, g(, d)]
            vals = vals.narrow(3, self.tp_rank * g_local, g_local)
            arena[:, idx] = vals.to(self.device)
        self.scheduler.note_imported(req)
        self.registry.counter("serving/kv_import_blocks").inc(len(payloads))
        timeline.emit("request_admit", rid=req.rid, slot=req.slot,
                      blocks=len(req.blocks), hit_blocks=0, imported=True,
                      **trace_fields(req))
        return req

    # ------------------------------------------------------------ adapters

    def register_adapter(self, adapter_id: str, weights=None, *,
                         seed: Optional[int] = None) -> int:
        """Load, or hot-swap, a LoRA adapter into the arena; returns its
        slot.

        ``weights`` is the ``{proj: (A [L, in, r], B [L, r, out])}`` dict
        of numpy arrays (for instance from :func:`~apex_tpu_torch.serving.
        lora.init_adapter_weights`); ``None`` builds the fixture seeded by
        ``seed``, by default ``zlib.crc32`` of the id, so the same id
        loads the same adapter everywhere.  At tp > 1 the weights are the
        full adapter and this rank keeps its slices.  A resident id is
        overwritten in place (the hot swap: in-flight requests see the
        new rows from the next call); a new id LRU-evicts the coldest
        unpinned adapter when the arena is full, and raises
        :class:`~apex_tpu_torch.serving.lora.OutOfAdapterSlotsError` when
        every resident adapter is pinned."""
        if self.adapter_arena is None:
            raise RuntimeError(
                "ServingConfig.lora is None; this engine serves the bare "
                "checkpoint only")
        cfg = self.model.cfg
        if weights is None:
            if seed is None:
                seed = zlib.crc32(str(adapter_id).encode())
            weights = init_adapter_weights(cfg, self.lora, seed=int(seed))
        vals = pack_adapter_values(cfg, self.lora, weights,
                                   self.adapters[0].dtype)
        vals = shard_adapter_values(vals, self.tp_rank, self.tp,
                                    self.tp_axis)
        slot, evicted = self.adapter_arena.register(adapter_id)
        for arena, val in zip(self.adapters, vals):
            arena[:, slot].copy_(val)
        self.registry.counter("serving/adapter_loads").inc()
        if evicted is not None:
            self.registry.counter("serving/adapter_evictions").inc()
        self.registry.gauge("serving/adapter_active").set(
            self.adapter_arena.active)
        timeline.emit(
            "adapter_load", adapter_id=str(adapter_id), slot=int(slot),
            evicted=(str(evicted) if evicted is not None else None))
        return int(slot)

    def unregister_adapter(self, adapter_id: str) -> None:
        """Drop an adapter from the registry: new submits naming it are
        ``REJECTED``; requests pinning it keep its slot until they end."""
        if self.adapter_arena is None:
            raise RuntimeError(
                "ServingConfig.lora is None; this engine serves the bare "
                "checkpoint only")
        slot = self.adapter_arena.unregister(adapter_id)
        timeline.emit("adapter_unload", adapter_id=str(adapter_id),
                      slot=int(slot))

    def _pin_adapter(self, adapter_id, req: Request) -> None:
        self.adapter_arena.pin(adapter_id, req.rid)
        self.registry.gauge("serving/adapter_active").set(
            self.adapter_arena.active)

    def _adapter_slot_array(self) -> torch.Tensor:
        """Each slot's arena row for this call, ``[max_batch]`` int32 on
        the device (idle and ``adapter_id=None`` slots gather the zero
        adapter)."""
        slots = np.zeros((self.serving.max_batch,), np.int32)
        for req in self.scheduler.running():
            slots[req.slot] = self.adapter_arena.pinned_slot(req.rid)
        return self._to_device(slots)

    def _adapter_kwargs(self) -> dict:
        if self.adapter_arena is None:
            return {}
        return dict(adapters=self.adapters,
                    adapter_slots=self._adapter_slot_array())

    # ---------------------------------------------------------------- step

    def step(self) -> None:
        """One engine tick: the drain check, admit, advance prefill
        chunks, one decode step, then the gauges and the heartbeat."""
        if self._drain_requested() and not self.draining:
            self.drain()
        for req in self.scheduler.admit():
            timeline.emit("request_admit", rid=req.rid, slot=req.slot,
                          blocks=len(req.blocks), hit_blocks=req.hit_blocks,
                          **trace_fields(req))
        self._prefill_tick()
        self._decode_once()
        self.steps += 1
        sched = self.scheduler
        self.registry.gauge("serving/active_slots").set(len(sched.running()))
        self.registry.gauge("serving/free_blocks").set(sched.allocator.n_free)
        self.registry.gauge("serving/kv_occupancy").set(sched.kv_occupancy())
        self._flush_occupancy_counters()
        # the beat lands after this tick's results reached the host: a
        # wedged step stops the beats, and the monitor trips the guard
        if self.heartbeat is not None:
            self.heartbeat.beat(self.steps)

    def _flush_occupancy_counters(self) -> None:
        sched = self.scheduler
        if sched.preemptions > self._counted_preempts:
            self.registry.counter("serving/preemptions").inc(
                sched.preemptions - self._counted_preempts)
            self._counted_preempts = sched.preemptions
        pc = sched.prefix_cache
        if pc is not None:
            if pc.hits > self._counted_hits:
                self.registry.counter("serving/prefix_cache_hits").inc(
                    pc.hits - self._counted_hits)
                self._counted_hits = pc.hits
            if pc.evictions > self._counted_evictions:
                self.registry.counter("serving/evictions").inc(
                    pc.evictions - self._counted_evictions)
                self._counted_evictions = pc.evictions

    def run_until_drained(self, max_steps: int = 100_000) -> None:
        """Drive :meth:`step` until no request is waiting or running."""
        for _ in range(max_steps):
            if self.scheduler.idle:
                return
            self.step()
        raise RuntimeError(f"not drained after {max_steps} steps")

    # ------------------------------------------------------------- helpers

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _refresh_tables(self) -> torch.Tensor:
        """Rebuild the slot -> physical-block rows from the live requests
        and return them on the device."""
        self._tables[:] = 0
        for req in self.scheduler.running():
            self._tables[req.slot, :len(req.blocks)] = req.blocks
        return self._to_device(self._tables)

    def _sampling_tensors(self):
        """Per-slot sampling policy, ``[max_batch]`` each."""
        B = self.serving.max_batch
        temp = np.zeros((B,), np.float32)
        top_k = np.zeros((B,), np.int64)
        top_p = np.ones((B,), np.float32)
        seeds = np.zeros((B,), np.int64)
        steps = np.zeros((B,), np.int64)
        for req in self.scheduler.running():
            s = req.sampling
            temp[req.slot] = s.temperature
            top_k[req.slot] = s.top_k
            top_p[req.slot] = s.top_p
            seeds[req.slot] = s.seed & 0xFFFFFFFF
            steps[req.slot] = s.step_offset + len(req.output_tokens)
        return tuple(self._to_device(a) for a in (temp, top_k, top_p, seeds,
                                                  steps))

    # ------------------------------------------------------------- prefill

    def _prefill_tick(self) -> None:
        """Advance every prefilling slot by at most one chunk in one call;
        slots whose prompt completes sample their first token."""
        B, T = self.serving.max_batch, self.prefill_len
        bs = self.cache.block_size
        cands = sorted(
            (r for r in self.scheduler.running() if r.prefilling),
            key=lambda r: r.admit_seq)
        plan: List[Tuple[Request, int]] = []
        for req in cands:
            if req.slot is None or not req.prefilling:
                continue    # preempted by an older request's growth
            chunk = min(req.prefill_target - req.cache_len, T)
            if self.live_prefill_chunk is not None:
                chunk = min(chunk, self.live_prefill_chunk)
            covered = self.scheduler.try_grow_to(req, req.cache_len + chunk)
            chunk = min(chunk, covered - req.cache_len)
            if chunk > 0:
                plan.append((req, chunk))
        if not plan:
            return

        tokens = np.zeros((B, T), np.int64)
        pos_ids = np.zeros((B, T), np.int64)
        limits = np.zeros((B, T), np.int32)
        lengths = np.zeros((B,), np.int32)
        dest_b = np.full((B, T), self.cache.n_blocks, np.int64)  # = dropped
        dest_o = np.zeros((B, T), np.int64)
        sample_index = np.full((B,), T, np.int64)                # = no sample
        for req, chunk in plan:
            s = req.slot
            wire = req.sequence_tokens()
            lo = req.cache_len
            tokens[s, :chunk] = wire[lo:lo + chunk]
            pos_ids[s, :chunk] = np.arange(lo, lo + chunk)
            limits[s, :chunk] = np.arange(lo + 1, lo + chunk + 1)
            lengths[s] = lo + chunk
            dest_b[s, :chunk] = [req.blocks[(lo + t) // bs]
                                 for t in range(chunk)]
            dest_o[s, :chunk] = [(lo + t) % bs for t in range(chunk)]
            if lo + chunk == req.prefill_target:
                sample_index[s] = chunk - 1
        tables = self._refresh_tables()
        samp = self._sampling_tensors()
        dev = self._to_device
        with timeline.scope("prefill", rids=[r.rid for r, _ in plan],
                            tokens=int(sum(c for _, c in plan))):
            next_tokens, _ = self.model.prefill(
                self.arenas, dev(tokens), dev(pos_ids), tables, dev(lengths),
                dev(limits), dev(dest_b), dev(dest_o), dev(sample_index),
                *samp, **self._adapter_kwargs())
            next_np = next_tokens.cpu().numpy()
        self.prefill_calls += 1

        now = time.monotonic()
        for req, chunk in plan:
            self.scheduler.note_prefilled(req, chunk)
            if not req.prefilling:
                # prompt complete: the sample at its last prompt position
                # is the request's next output token
                timeline.emit("request_prefilled", rid=req.rid,
                              tokens=req.prefill_target, **trace_fields(req))
                self._emit(req, int(next_np[req.slot]), now)

    # -------------------------------------------------------------- decode

    def _propose_drafts(self, req: Request) -> List[int]:
        """This tick's drafts for ``req``, clamped to the verify width,
        the live cap, the context cap and the remaining budget (the
        verify's own output covers the last token, so a request one token
        from its budget drafts nothing)."""
        if self.proposer is None:
            return []
        max_k = min(self.spec_width - 1,
                    self.cache.max_seq - (req.cache_len + 1),
                    req.max_new_tokens - len(req.output_tokens) - 1)
        if self.live_spec_k is not None:
            max_k = min(max_k, self.live_spec_k)
        if max_k <= 0:
            return []
        return list(self.proposer.propose(req, max_k))[:max_k]

    def _decode_once(self) -> None:
        B, S = self.serving.max_batch, self.spec_width
        # a request at the context cap cannot write another token:
        # deliver what it has
        for req in list(self.scheduler.running()):
            if not req.prefilling and req.cache_len >= self.cache.max_seq:
                self._finish(req)
        # grow this tick's write blocks oldest-first (evict cached LRU,
        # then preempt strictly newer requests); a request that cannot
        # grow sits this tick out and keeps its cache
        decoding = sorted(
            (r for r in self.scheduler.running() if not r.prefilling),
            key=lambda r: r.admit_seq)
        reqs: List[Request] = []
        drafts: Dict[int, List[int]] = {}
        for req in decoding:
            if req.slot is None or req.state is not RequestState.RUNNING:
                continue    # preempted by an older request's growth
            covered = self.scheduler.try_grow_to(req, req.cache_len + 1)
            if covered < req.cache_len + 1:
                continue
            draft = self._propose_drafts(req)
            if draft:
                # drafted rows take blocks from the free list or the
                # cache LRU only, never by preemption; a short grow just
                # truncates the draft
                covered = self.scheduler.try_grow_to(
                    req, req.cache_len + 1 + len(draft), preempt=False)
                draft = draft[:max(0, covered - (req.cache_len + 1))]
            drafts[req.rid] = draft
            reqs.append(req)
        if not reqs:
            return
        tokens = np.zeros((B, S), np.int64)
        positions = np.zeros((B,), np.int64)
        active = np.zeros((B,), bool)
        n_draft = np.zeros((B,), np.int64)
        for req in reqs:
            d = drafts[req.rid]
            tokens[req.slot, 0] = req.last_token
            tokens[req.slot, 1:1 + len(d)] = d
            positions[req.slot] = req.cache_len
            active[req.slot] = True
            n_draft[req.slot] = len(d)
        tables = self._refresh_tables()
        samp = self._sampling_tensors()
        dev = self._to_device
        t0 = time.perf_counter()
        out_tokens, accepted, _ = self.model.decode_step(
            self.arenas, dev(tokens), dev(positions), tables, dev(active),
            *samp, n_draft=dev(n_draft), **self._adapter_kwargs())
        # one transfer brings back the tokens and the accepted counts
        host = torch.cat([out_tokens, accepted[:, None]], dim=1).cpu().numpy()
        self._last_decode_s = time.perf_counter() - t0
        self._last_decode_flops = self._decode_flops(positions, n_draft,
                                                     active)
        out_np, acc_np = host[:, :S], host[:, S]
        self.decode_calls += 1
        self._refresh_mfu()

        now = time.monotonic()
        proposed_total = accepted_total = 0
        for req in reqs:
            d = drafts[req.rid]
            acc = int(acc_np[req.slot])
            if d:
                proposed_total += len(d)
                accepted_total += acc
                self.proposer.observe(req, len(d), acc)
                aid = req.sampling.adapter_id
                if aid is not None and (aid in self.spec_by_adapter
                                        or len(self.spec_by_adapter) < 256):
                    row = self.spec_by_adapter.setdefault(aid, [0, 0])
                    row[0] += len(d)
                    row[1] += acc
            # rejected drafts roll back for free: cache_len does not
            # advance over their rows, and the next tick overwrites them
            for j in range(acc + 1):
                req.cache_len += 1        # column j's row is real
                self._emit(req, int(out_np[req.slot, j]), now)
                if req.state is not RequestState.RUNNING:
                    break                 # eos or budget: drop the rest
        if proposed_total:
            self.spec_proposed += proposed_total
            self.registry.counter("serving/spec_proposed").inc(
                proposed_total)
        if accepted_total:
            self.spec_accepted += accepted_total
            self.registry.counter("serving/spec_accepted").inc(
                accepted_total)
        if self.spec_proposed:
            self.registry.gauge("serving/spec_acceptance").set(
                self.spec_accepted / self.spec_proposed)

    # ------------------------------------------------------------------ mfu

    def _decode_flops(self, positions: np.ndarray, n_draft: np.ndarray,
                      active: np.ndarray) -> float:
        """The decode call's FLOPs over all tp ranks (see the class
        docstring): GEMMs over every row of the fixed shape, attention
        over each live row's context, LoRA deltas when enabled."""
        cfg = self.model.cfg
        h, f, d = cfg.hidden_size, cfg.ffn_size, cfg.head_dim
        n, g = cfg.num_attention_heads, cfg.query_groups
        rows = self.serving.max_batch * self.spec_width
        per_row = (h * (n + 2 * g) * d + n * d * h
                   + h * f * (2 if cfg.swiglu else 1) + f * h)
        gemm = 2 * rows * (cfg.num_layers * per_row
                           + h * cfg.padded_vocab_size)
        # row t of a live slot attends positions < pos + t + 1
        ctx = sum(int(p) * (k + 1) + (k + 1) * (k + 2) // 2
                  for p, k, a in zip(positions, n_draft, active) if a)
        attn = 4 * n * d * ctx * cfg.num_layers
        lora = 0
        if self.lora is not None:
            ins_outs = (h + (n + 2 * g) * d) + (n * d + h) + (h + f) + (f + h)
            lora = 2 * self.lora.rank * ins_outs * rows * cfg.num_layers
        return float(gemm + attn + lora)

    def _refresh_mfu(self) -> None:
        """MFU of the last decode call; the gauge where it is defined,
        else the reason for ``introspect``."""
        value, reason = mfu_or_reason(
            self._last_decode_flops, self._last_decode_s,
            device=self.device, n_devices=self.tp)
        self.mfu, self.mfu_reason = value, reason
        if value is not None:
            self.registry.gauge("serving/mfu").set(value)

    # ---------------------------------------------------------- introspection

    def introspect(self) -> dict:
        """A read-only snapshot of the engine's state, with the
        reference's keys.  ``decode_compiles`` is ``None``: eager PyTorch
        compiles no decode program to count."""
        sched = self.scheduler
        pc = sched.prefix_cache
        arena = self.adapter_arena
        return {
            "steps": self.steps,
            "active_slots": len(sched.running()),
            "free_slots": len(sched.free_slots()),
            "free_blocks": sched.allocator.n_free,
            "total_blocks": sched.allocator.n_blocks,
            "queue_depth": len(sched.waiting),
            "draining": self.draining,
            "decode_compiles": None,
            "admission": sched.admission,
            "kv_occupancy": round(sched.kv_occupancy(), 4),
            "prefix_cached_blocks": (pc.n_blocks if pc is not None
                                     else None),
            "prefix_cache_hits": (pc.hits if pc is not None else None),
            "evictions": (pc.evictions if pc is not None else None),
            "preemptions": sched.preemptions,
            "kv_exports_pinned": len(self.exports),
            "spec_width": self.spec_width,
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "spec_acceptance": (
                round(self.spec_accepted / self.spec_proposed, 4)
                if self.spec_proposed else None),
            "spec_by_adapter": {
                aid: {"proposed": int(p), "accepted": int(a),
                      "acceptance": round(a / p, 4) if p else None}
                for aid, (p, a) in sorted(self.spec_by_adapter.items())},
            "knobs": self.knobs(),
            "decode_calls": self.decode_calls,
            "adapters_resident": (arena.residents() if arena is not None
                                  else None),
            "adapter_active": arena.active if arena is not None else None,
            "adapter_loads": arena.loads if arena is not None else None,
            "adapter_evictions": (arena.evictions if arena is not None
                                  else None),
            "cache_dtype": str(self.cache.dtype).replace("torch.", ""),
            "last_decode_ms": (round(self._last_decode_s * 1e3, 3)
                               if self._last_decode_s is not None else None),
            "mfu": self.mfu,
            "mfu_reason": self.mfu_reason,
        }

    # ---------------------------------------------------------- bookkeeping

    def _emit(self, req: Request, token: int, now: float) -> None:
        """Record one generated token; finish on eos/budget."""
        if req.t_first_token is None:
            req.t_first_token = now
            ms = (now - req.t_submit) * 1e3
            self.ttft_ms.append(ms)
            self.registry.histogram(
                "serving/ttft_ms", keep_samples=4096).observe(ms)
        elif req.t_last_token is not None:
            ms = (now - req.t_last_token) * 1e3
            self.tpot_ms.append(ms)
            self.registry.histogram(
                "serving/tpot_ms", keep_samples=65536).observe(ms)
        req.t_last_token = now
        req.output_tokens.append(token)
        self.tokens_generated += 1
        self.registry.counter("serving/tokens_generated").inc()
        n = len(req.output_tokens)
        if n % self.timeline_tick_every == 0:
            timeline.emit("decode_tick", rid=req.rid, tokens=n,
                          **trace_fields(req))
        if (n >= req.max_new_tokens
                or (req.eos_id is not None and token == req.eos_id)):
            self._finish(req)

    def _finish(self, req: Request) -> None:
        self._tables[req.slot][:] = 0
        self.scheduler.finish(req)
        self._unpin_adapter(req)
        self.requests_finished += 1
        self.registry.counter("serving/requests_finished").inc()
        timeline.emit("request_finish", rid=req.rid,
                      tokens=len(req.output_tokens), **trace_fields(req))

    def _unpin_adapter(self, req: Request) -> None:
        """Release a terminal request's adapter pin (a no-op without one)."""
        if self.adapter_arena is not None:
            self.adapter_arena.unpin(req.rid)
            self.registry.gauge("serving/adapter_active").set(
                self.adapter_arena.active)
