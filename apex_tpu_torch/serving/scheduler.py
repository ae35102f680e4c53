"""Host-side continuous-batching scheduler, admission by occupancy (or by
worst-case reservation).

Port of :mod:`apex_tpu.serving.scheduler`.  The state machine the engine
drives once per step::

    WAITING --admit (slot + first-chunk blocks)--> RUNNING
        RUNNING (prefilling: cache_len < prefill_target)
        RUNNING (decoding) --eos / budget / max_seq--> FINISHED
    RUNNING --pool pressure--> WAITING   (preempted: blocks freed,
                                          recompute on readmission)
    WAITING --drain--> CANCELLED
    submit() while draining --> REJECTED

- **Admission** needs a free slot and blocks for the request's first
  prefill chunk only, after the prefix cache shared what it could.
- **Growth is on demand**; when the pool is empty the scheduler first
  evicts LRU prefix-cache blocks, then **preempts** the newest admitted
  request (its full blocks are indexed into the prefix cache first, so
  its readmission usually hits them).  Victims are always newer than
  the request growing, so the oldest request always finishes.
- A request whose worst case exceeds the whole pool is refused at
  submit.
- ``admission="reserve"`` is the worst-case baseline the reference
  keeps for its A/B: a request is admitted with blocks for its whole
  horizon (prompt + ``max_new_tokens``) or not at all; nothing is shared
  or grown, nobody is preempted.  ``prefix_caching=False`` keeps the
  occupancy policy without the prefix cache; reserve admission never has
  one (a reservation is exclusive).
- :meth:`Scheduler.admit_imported` admits a request whose KV arrives by
  import from another engine (KV migration) straight into a slot, and
  :meth:`Scheduler.note_imported` indexes its run once the payload
  landed.

No decision reads the wall clock: ``t_submit`` and ``t_last_token`` feed
only the latency metrics, so engines that see the same calls in the same
order (the ranks of a tensor-parallel engine) decide the same.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import itertools
import time
from typing import Deque, List, Optional, Sequence

import numpy as np

from apex_tpu_torch.observability import timeline
from apex_tpu_torch.serving.kv_cache import (
    BlockAllocator,
    KVCacheConfig,
    OutOfBlocksError,
    PrefixCache,
)
from apex_tpu_torch.serving.sampling import SamplingParams

__all__ = ["Request", "RequestState", "Scheduler", "trace_fields"]

ADMISSIONS = ("occupancy", "reserve")


def trace_fields(req) -> dict:
    """Trace-context fields of a request's timeline events: ``{trace_id,
    attempt}`` when the request carries a trace id, else none (the
    events then have exactly the untraced schema)."""
    if req.trace_id is None:
        return {}
    return {"trace_id": req.trace_id, "attempt": req.trace_attempt}


class RequestState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"
    CANCELLED = "cancelled"
    # refused at the door (submitted into a drain window), as distinct
    # from CANCELLED: accepted, then drained out of the queue
    REJECTED = "rejected"


@dataclasses.dataclass
class Request:
    """One generation request and its live serving state."""

    rid: int
    prompt: np.ndarray                  # int32 [prompt_len]
    max_new_tokens: int
    eos_id: Optional[int] = None
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)

    state: RequestState = RequestState.WAITING
    output_tokens: List[int] = dataclasses.field(default_factory=list)
    blocks: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    cache_len: int = 0                  # tokens currently in the paged cache
    prefill_target: int = 0             # tokens the prefill must cover
    hit_blocks: int = 0                 # prefix-cache blocks shared (last admit)
    pc_blocks: int = 0                  # full blocks chain-hashed so far
    pc_hash: int = 0                    # chain hash after block pc_blocks-1
    preemptions: int = 0                # times evicted back to the queue
    admit_seq: int = -1                 # admission order (victim selection)
    spec_fails: int = 0                 # consecutive all-rejected proposals
    #                                     (speculative back-off)
    spec_quiet: int = 0                 # backed-off ticks since the last
    #                                     probe (re-arm cadence)
    # the trace id its timeline events carry and which dispatch attempt
    # this is (None / 0 outside a traced caller)
    trace_id: Optional[str] = None
    trace_attempt: int = 0

    # wall-clock marks for the latency metrics (engine-stamped)
    t_submit: float = 0.0
    t_first_token: Optional[float] = None
    t_last_token: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.state in (RequestState.FINISHED, RequestState.CANCELLED,
                              RequestState.REJECTED)

    @property
    def prefilling(self) -> bool:
        """RUNNING but with prompt tokens still to land in the cache."""
        return (self.state is RequestState.RUNNING
                and self.cache_len < self.prefill_target)

    @property
    def last_token(self) -> int:
        if self.output_tokens:
            return self.output_tokens[-1]
        return int(self.prompt[-1])

    def sequence_tokens(self) -> List[int]:
        """Prompt + emitted stream (the readmission wire, and the content
        key of the request's cache blocks)."""
        return list(map(int, self.prompt)) + self.output_tokens


class Scheduler:
    """Slot + block bookkeeping for the continuous batch."""

    def __init__(self, cache: KVCacheConfig, max_batch: int, *,
                 chunk_tokens: Optional[int] = None,
                 admission: str = "occupancy",
                 prefix_caching: bool = True):
        if admission not in ADMISSIONS:
            raise ValueError(
                f"admission must be 'occupancy' or 'reserve', got "
                f"{admission!r}")
        self.cache = cache
        self.max_batch = max_batch
        self.admission = admission
        self.chunk_tokens = chunk_tokens or cache.max_seq
        self.allocator = BlockAllocator(cache.n_blocks)
        # a reservation is exclusive: the cache exists only under
        # occupancy admission
        self.prefix_cache: Optional[PrefixCache] = (
            PrefixCache(self.allocator, cache.block_size)
            if prefix_caching and admission == "occupancy" else None)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.waiting: Deque[Request] = collections.deque()
        self._ids = itertools.count()
        self._admit_seq = itertools.count()
        self.draining = False
        self.preemptions = 0            # lifetime count

    # ------------------------------------------------------------- submit

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               eos_id: Optional[int] = None,
               sampling: Optional[SamplingParams] = None) -> Request:
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError("prompt must be a non-empty 1-D token list")
        if prompt.size >= self.cache.max_seq:
            raise ValueError(
                f"prompt of {prompt.size} tokens does not fit max_seq="
                f"{self.cache.max_seq} with room to generate")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        req = Request(rid=next(self._ids), prompt=prompt,
                      max_new_tokens=max_new_tokens, eos_id=eos_id,
                      sampling=sampling or SamplingParams(),
                      t_submit=time.monotonic())
        need = self._worst_case_blocks(req)
        if need > self.allocator.n_blocks:
            raise ValueError(
                f"request needs {need} blocks worst-case "
                f"(prompt {prompt.size} + max_new_tokens "
                f"{max_new_tokens}) but the arena has only "
                f"{self.allocator.n_blocks}; raise n_blocks or lower "
                "max_new_tokens")
        if self.draining:
            req.state = RequestState.REJECTED
            return req
        self.waiting.append(req)
        return req

    # -------------------------------------------------------------- admit

    def _worst_case_blocks(self, req: Request) -> int:
        horizon = min(len(req.prompt) + req.max_new_tokens,
                      self.cache.max_seq)
        return self.cache.blocks_for(horizon)

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    def _ensure_free(self, n: int) -> bool:
        """Raise ``n_free`` to ``n`` by evicting prefix-cache LRU blocks;
        False when the cache runs out first."""
        deficit = n - self.allocator.n_free
        if deficit > 0 and self.prefix_cache is not None:
            self.prefix_cache.evict_many(deficit)
        return self.allocator.n_free >= n

    def admit(self) -> List[Request]:
        """Move WAITING requests into free slots while capacity lasts
        (FIFO).  Occupancy: share the cached prefix, then take blocks for
        the first prefill chunk only (evicting cached blocks, never
        preempting).  Reserve: the whole worst-case horizon or nothing."""
        admitted: List[Request] = []
        if self.draining:
            return admitted
        free = self.free_slots()
        while self.waiting and free:
            req = self.waiting[0]
            wire = req.sequence_tokens()
            shared: List[int] = []
            if self.admission == "reserve":
                need = self._worst_case_blocks(req)
                if not self.allocator.can_alloc(need):
                    break
            else:
                if self.prefix_cache is not None:
                    # always leave >= 1 token to recompute: it yields the
                    # next sampled token and keeps writes off shared blocks
                    shared = self.prefix_cache.lookup(
                        wire, req.rid,
                        max_blocks=(len(wire) - 1) // self.cache.block_size)
                hit_len = len(shared) * self.cache.block_size
                chunk = min(len(wire) - hit_len, self.chunk_tokens)
                need = self.cache.blocks_for(hit_len + chunk) - len(shared)
                if not self._ensure_free(need):
                    # the FIFO head does not fit: hand the shared refs back
                    # and roll the hit count back (nothing was served)
                    if shared:
                        self.allocator.free(shared, owner=req.rid)
                        self.prefix_cache.hits -= len(shared)
                    break
            self.waiting.popleft()
            req.blocks = shared + self.allocator.alloc(need, owner=req.rid)
            req.hit_blocks = len(shared)
            req.pc_blocks = 0
            req.pc_hash = 0
            req.cache_len = len(shared) * self.cache.block_size
            req.prefill_target = len(wire)
            req.slot = free.pop(0)
            req.state = RequestState.RUNNING
            req.admit_seq = next(self._admit_seq)
            self.slots[req.slot] = req
            admitted.append(req)
        return admitted

    def admit_imported(self, prompt: Sequence[int], max_new_tokens: int,
                       eos_id: Optional[int] = None,
                       sampling: Optional[SamplingParams] = None, *,
                       cache_len: int, n_blocks: int) -> Request:
        """Admit a request whose KV for ``prompt[:cache_len]`` is about to
        be imported from another engine instead of computed here.

        Takes blocks for the whole prefill target (the imported run and
        the tail the chunked prefill still covers) and a slot at once,
        ahead of the queue (the payload has arrived; parking it would
        strand it), and returns the RUNNING request with ``cache_len``
        set.  The engine writes the payload into ``req.blocks[:n_blocks]``
        and the ordinary prefill covers ``prompt[cache_len:]`` (for a
        migration the last wire token, as a prefix-cache hit recomputes
        one), which makes the continued stream the uninterrupted one.
        Raises ``ValueError`` or :class:`~apex_tpu_torch.serving.kv_cache.
        OutOfBlocksError` when a slot or blocks are missing; in a drain
        window the request comes back REJECTED, as from :meth:`submit`."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError("prompt must be a non-empty 1-D token list")
        if prompt.size >= self.cache.max_seq:
            raise ValueError(
                f"imported prompt of {prompt.size} tokens does not fit "
                f"max_seq={self.cache.max_seq} with room to generate")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if not 0 < cache_len < prompt.size:
            raise ValueError(
                f"imported cache_len {cache_len} must cover part of the "
                f"{prompt.size}-token prompt (>= 1 token recomputed)")
        if n_blocks != self.cache.blocks_for(cache_len):
            raise ValueError(
                f"imported run of {n_blocks} blocks does not cover "
                f"cache_len {cache_len} (block_size "
                f"{self.cache.block_size})")
        req = Request(rid=next(self._ids), prompt=prompt,
                      max_new_tokens=max_new_tokens, eos_id=eos_id,
                      sampling=sampling or SamplingParams(),
                      t_submit=time.monotonic())
        if self._worst_case_blocks(req) > self.allocator.n_blocks:
            raise ValueError(
                "imported request exceeds the whole pool worst-case")
        if self.draining:
            req.state = RequestState.REJECTED
            return req
        free = self.free_slots()
        if not free:
            raise ValueError("no free decode slot for the imported "
                             "request")
        if self.admission == "reserve":
            need = self._worst_case_blocks(req)
        else:
            need = self.cache.blocks_for(prompt.size)
        if not self._ensure_free(need):
            raise OutOfBlocksError(
                f"imported request needs {need} blocks, only "
                f"{self.allocator.n_free} free after eviction")
        req.blocks = self.allocator.alloc(need, owner=req.rid)
        req.hit_blocks = 0
        req.pc_blocks = 0
        req.pc_hash = 0
        req.cache_len = int(cache_len)
        req.prefill_target = prompt.size
        req.slot = free[0]
        req.state = RequestState.RUNNING
        req.admit_seq = next(self._admit_seq)
        self.slots[req.slot] = req
        # the run is indexed by note_imported once its content landed:
        # indexing it now would let a same-tick hit share garbage
        return req

    def note_imported(self, req: Request) -> None:
        """Index an imported request's landed run into the prefix cache
        (after the engine wrote the payload)."""
        self._index_into_cache(req)

    # ------------------------------------------------------------- growth

    def try_grow_to(self, req: Request, n_tokens: int, *,
                    preempt: bool = True) -> int:
        """Grow ``req.blocks`` toward covering ``n_tokens``: free list,
        then prefix-cache eviction, then (``preempt=True``) preemption of
        strictly newer requests.  Returns the token count the blocks now
        cover.

        ``preempt=False`` stops the ladder at eviction: the engine's
        speculative growth (blocks for drafted rows) uses it, so drafting
        never throws away a neighbour's computed KV."""
        target = self.cache.blocks_for(n_tokens)
        while len(req.blocks) < target:
            want = target - len(req.blocks)
            if self._ensure_free(1):
                got = self.allocator.alloc(
                    min(want, self.allocator.n_free), owner=req.rid)
                req.blocks.extend(got)
                continue
            if not preempt:
                break
            victim = self._pick_victim(exclude=req)
            if victim is None:
                break
            self.preempt(victim)
        return len(req.blocks) * self.cache.block_size

    def _pick_victim(self, exclude: Request) -> Optional[Request]:
        """Newest-admitted running request newer than ``exclude``."""
        candidates = [r for r in self.slots
                      if r is not None and r is not exclude
                      and r.admit_seq > exclude.admit_seq]
        if not candidates:
            return None
        return max(candidates, key=lambda r: r.admit_seq)

    def preempt(self, req: Request) -> None:
        """Evict a RUNNING request to the front of the queue: its full
        blocks are indexed into the prefix cache, every block ref is
        released, and it recomputes prompt + emitted tokens on
        readmission."""
        if req.state is not RequestState.RUNNING:
            raise ValueError(f"preempt() on {req.state} request {req.rid}")
        self._index_into_cache(req)
        self.allocator.free(req.blocks, owner=req.rid)
        req.blocks = []
        self.slots[req.slot] = None
        req.slot = None
        req.cache_len = 0
        req.prefill_target = 0
        req.state = RequestState.WAITING
        req.preemptions += 1
        self.preemptions += 1
        self.waiting.appendleft(req)
        timeline.emit("request_preempt", rid=req.rid,
                      tokens=len(req.output_tokens), **trace_fields(req))

    def _index_into_cache(self, req: Request) -> None:
        if self.prefix_cache is None:
            return
        # content in the arena: the first cache_len tokens of the stream
        # (the last sampled token is emitted before it is written)
        n_full = min(req.cache_len // self.cache.block_size,
                     len(req.blocks))
        if n_full <= req.pc_blocks:
            return
        req.pc_hash = self.prefix_cache.insert(
            req.sequence_tokens()[:req.cache_len], req.blocks,
            req.cache_len, start_block=req.pc_blocks,
            prev_hash=req.pc_hash)
        req.pc_blocks = n_full

    def note_prefilled(self, req: Request, n_tokens: int) -> None:
        """Account a prefill chunk landing in the arena; newly full blocks
        become shareable prefix-cache entries."""
        req.cache_len += n_tokens
        self._index_into_cache(req)

    # ------------------------------------------------------------- finish

    def finish(self, req: Request) -> None:
        """Release a RUNNING request's slot and blocks; its full blocks
        stay behind as prefix-cache entries."""
        if req.state is not RequestState.RUNNING:
            raise ValueError(f"finish() on {req.state} request {req.rid}")
        self._index_into_cache(req)
        self.allocator.free(req.blocks, owner=req.rid)
        req.blocks = []
        self.slots[req.slot] = None
        req.slot = None
        req.state = RequestState.FINISHED
        req.t_last_token = time.monotonic()

    def running(self) -> List[Request]:
        return [r for r in self.slots if r is not None]

    def drain(self) -> List[Request]:
        """Stop admissions and cancel the queue; running requests keep
        their slots and decode to completion.  Returns the cancelled."""
        self.draining = True
        cancelled = list(self.waiting)
        self.waiting.clear()
        for req in cancelled:
            req.state = RequestState.CANCELLED
        return cancelled

    @property
    def idle(self) -> bool:
        return not self.waiting and all(r is None for r in self.slots)

    def kv_occupancy(self) -> float:
        """Fraction of the pool holding live or cached KV."""
        return 1.0 - self.allocator.n_free / self.allocator.n_blocks
