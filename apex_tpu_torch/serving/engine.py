"""The serving engine: continuous batching over the paged-cache decode.

Port of :mod:`apex_tpu.serving.engine` for one card.  One object owns the
runtime: the decode model, the KV arenas (updated in place by every
step), the host scheduler and plain counters.

Step anatomy (:meth:`ServingEngine.step`)::

    admit waiting requests      (slot + first-chunk blocks; prefix-cache
                                 hits shared, not recomputed)
    -> one chunked-prefill call (each prefilling slot advances
                                 <= prefill_len tokens)
    -> grow decode blocks       (evict cached LRU, then preempt newest)
    -> one batched decode step  (paged attention + sampling)
    -> append/finish bookkeeping on the host

Every call has the fixed ``[max_batch, prefill_len]`` or ``[max_batch,
spec_width]`` shape; request churn, chunking, prefix hits, preemption,
draft counts and the adapter mix only change values.

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

Counters: ``tokens_generated``, ``requests_finished``,
``requests_cancelled``, ``requests_rejected``, ``prefill_calls``,
``decode_calls``, ``spec_proposed``, ``spec_accepted``,
``spec_by_adapter`` and the ``ttft_ms`` / ``tpot_ms`` sample lists.

Not ported yet: KV export/import, live knobs (``set_knobs``, with the
live draft cap), the metrics registry and timeline, the unfused A/B flags
and the worst-case admission baseline.
"""

from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.serving.kv_cache import KVCacheConfig, init_kv_arena
from apex_tpu_torch.serving.lora import (
    AdapterArena,
    LoRAConfig,
    init_adapter_arena,
    init_adapter_weights,
    pack_adapter_values,
)
from apex_tpu_torch.serving.model import DecodeModel
from apex_tpu_torch.serving.sampling import SamplingParams
from apex_tpu_torch.serving.scheduler import Request, RequestState, Scheduler
from apex_tpu_torch.serving.speculative import NGramProposer, SpeculativeConfig
from apex_tpu_torch.transformer.testing.gpt_parallel_train import GPT3DParams
from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
    TransformerConfig,
)

__all__ = ["ServingConfig", "ServingEngine"]


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Static shape of the runtime.

    ``prefill_len`` is the per-slot chunk width of the batched chunked
    prefill (default ``max_seq``).  ``cache_dtype=torch.int8``
    stores the KV arenas quantized with per-row fp32 scales; the default
    is the model's param dtype.  ``speculative`` turns the decode step
    into the ``[max_batch, k + 1]`` self-speculative verify; ``lora``
    enables the multi-LoRA adapter arena.  ``None`` keeps either off.
    ``fuse_epilogue=False`` runs the layers' bias/residual/LayerNorm
    epilogue as separate ops instead of the K3 kernel (the reference's
    A/B switch).
    """

    max_batch: int = 8           # concurrent decode slots
    block_size: int = 16         # tokens per KV block
    max_seq: int = 256           # per-request context cap (prompt+output)
    n_blocks: Optional[int] = None   # arena size; default = worst case
    prefill_len: Optional[int] = None  # chunk width; default max_seq
    cache_dtype: Optional[torch.dtype] = None
    fuse_epilogue: bool = True     # the K3 kernel vs separate ops
    speculative: Optional[SpeculativeConfig] = None
    lora: Optional[LoRAConfig] = None

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
    """

    def __init__(self, config: TransformerConfig, serving: ServingConfig,
                 params: GPT3DParams, *, device=None):
        device = resolve_device(device)
        self.device = device
        self.serving = serving
        if (config.position_embedding_type == "learned"
                and config.max_position_embeddings < serving.max_seq):
            raise ValueError(
                f"max_seq ({serving.max_seq}) exceeds the learned position "
                f"table ({config.max_position_embeddings})")
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
        self.model = DecodeModel(config, self.cache,
                                 fuse_epilogue=serving.fuse_epilogue,
                                 lora=self.lora, device=device)
        self.model.load_params(params)
        self.prefill_len = serving.prefill_len or serving.max_seq
        self.arenas: Tuple[torch.Tensor, ...] = init_kv_arena(self.cache,
                                                              device)
        # multi-LoRA: the eight adapter tensors, updated in place by
        # register_adapter; each request's slot is per-call data
        self.adapter_arena: Optional[AdapterArena] = None
        self.adapters: Optional[Tuple[torch.Tensor, ...]] = None
        if self.lora is not None:
            self.adapter_arena = AdapterArena(self.lora.n_slots)
            self.adapters = init_adapter_arena(config, self.lora, device)
        self.scheduler = Scheduler(
            self.cache, serving.max_batch, chunk_tokens=self.prefill_len)
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

    # -------------------------------------------------------------- submit

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               eos_id: Optional[int] = None,
               sampling: Optional[SamplingParams] = None) -> Request:
        """Queue a request.  One submitted into a drain window, or naming
        an adapter that is not resident, comes back ``REJECTED`` (never
        queued); a known adapter is pinned until the request ends."""
        if len(np.shape(prompt)) != 1:
            raise ValueError(
                f"prompt must be 1-D, got shape {np.shape(prompt)}")
        req = self.scheduler.submit(prompt, max_new_tokens, eos_id,
                                    sampling)
        aid = sampling.adapter_id if sampling is not None else None
        if (aid is not None and req.state is not RequestState.REJECTED
                and (self.adapter_arena is None
                     or not self.adapter_arena.resident(aid))):
            self.scheduler.waiting.remove(req)
            req.state = RequestState.REJECTED
        if req.state is RequestState.REJECTED:
            self.requests_rejected += 1
        elif aid is not None:
            # pinned for the request's whole life, queue wait included:
            # its adapter cannot be evicted from under it
            self.adapter_arena.pin(aid, req.rid)
        return req

    def drain(self) -> List[Request]:
        """Cancel the queue; running requests keep decoding until their
        responses are delivered."""
        cancelled = self.scheduler.drain()
        self.requests_cancelled += len(cancelled)
        for req in cancelled:
            self._unpin_adapter(req)
        return cancelled

    # ------------------------------------------------------------ adapters

    def register_adapter(self, adapter_id: str, weights=None, *,
                         seed: Optional[int] = None) -> int:
        """Load, or hot-swap, a LoRA adapter into the arena; returns its
        slot.

        ``weights`` is the ``{proj: (A [L, in, r], B [L, r, out])}`` dict
        of numpy arrays (for instance from :func:`~apex_tpu_torch.serving.
        lora.init_adapter_weights`); ``None`` builds the fixture seeded by
        ``seed``, by default ``zlib.crc32`` of the id, so the same id
        loads the same adapter everywhere.  A resident id is overwritten
        in place (the hot swap: in-flight requests see the new rows from
        the next call); a new id LRU-evicts the coldest unpinned adapter
        when the arena is full, and raises
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
        slot, _ = self.adapter_arena.register(adapter_id)
        for arena, val in zip(self.adapters, vals):
            arena[:, slot].copy_(val)
        return int(slot)

    def unregister_adapter(self, adapter_id: str) -> None:
        """Drop an adapter from the registry: new submits naming it are
        ``REJECTED``; requests pinning it keep its slot until they end."""
        if self.adapter_arena is None:
            raise RuntimeError(
                "ServingConfig.lora is None; this engine serves the bare "
                "checkpoint only")
        self.adapter_arena.unregister(adapter_id)

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
        """One engine tick: admit, advance prefill chunks, one decode
        step."""
        self.scheduler.admit()
        self._prefill_tick()
        self._decode_once()
        self.steps += 1

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
        next_tokens, _ = self.model.prefill(
            self.arenas, dev(tokens), dev(pos_ids), tables, dev(lengths),
            dev(limits), dev(dest_b), dev(dest_o), dev(sample_index), *samp,
            **self._adapter_kwargs())
        next_np = next_tokens.cpu().numpy()
        self.prefill_calls += 1

        now = time.monotonic()
        for req, chunk in plan:
            self.scheduler.note_prefilled(req, chunk)
            if not req.prefilling:
                # prompt complete: the sample at its last prompt position
                # is the request's next output token
                self._emit(req, int(next_np[req.slot]), now)

    # -------------------------------------------------------------- decode

    def _propose_drafts(self, req: Request) -> List[int]:
        """This tick's drafts for ``req``, clamped to the verify width,
        the context cap and the remaining budget (the verify's own output
        covers the last token, so a request one token from its budget
        drafts nothing)."""
        if self.proposer is None:
            return []
        max_k = min(self.spec_width - 1,
                    self.cache.max_seq - (req.cache_len + 1),
                    req.max_new_tokens - len(req.output_tokens) - 1)
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
        out_tokens, accepted, _ = self.model.decode_step(
            self.arenas, dev(tokens), dev(positions), tables, dev(active),
            *samp, n_draft=dev(n_draft), **self._adapter_kwargs())
        # one transfer brings back the tokens and the accepted counts
        host = torch.cat([out_tokens, accepted[:, None]], dim=1).cpu().numpy()
        out_np, acc_np = host[:, :S], host[:, S]
        self.decode_calls += 1

        now = time.monotonic()
        for req in reqs:
            d = drafts[req.rid]
            acc = int(acc_np[req.slot])
            if d:
                self.spec_proposed += len(d)
                self.spec_accepted += acc
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

    # ---------------------------------------------------------- bookkeeping

    def _emit(self, req: Request, token: int, now: float) -> None:
        """Record one generated token; finish on eos/budget."""
        if req.t_first_token is None:
            req.t_first_token = now
            self.ttft_ms.append((now - req.t_submit) * 1e3)
        elif req.t_last_token is not None:
            self.tpot_ms.append((now - req.t_last_token) * 1e3)
        req.t_last_token = now
        req.output_tokens.append(token)
        self.tokens_generated += 1
        n = len(req.output_tokens)
        if (n >= req.max_new_tokens
                or (req.eos_id is not None and token == req.eos_id)):
            self._finish(req)

    def _finish(self, req: Request) -> None:
        self._tables[req.slot][:] = 0
        self.scheduler.finish(req)
        self._unpin_adapter(req)
        self.requests_finished += 1

    def _unpin_adapter(self, req: Request) -> None:
        """Release a terminal request's adapter pin (a no-op without one)."""
        if self.adapter_arena is not None:
            self.adapter_arena.unpin(req.rid)
