"""Paged KV cache: the pooled block arenas and the host-side allocator.

Port of :mod:`apex_tpu.serving.kv_cache`.

- **Device side**: one arena per K and per V, ``[n_layers, n_blocks,
  block_size, kv_heads, head_dim]``.  The serving step writes new rows
  into them in place (the JAX package donates them through ``jit`` for
  the same effect).  An **int8** cache adds two fp32 scale arenas
  ``[n_layers, n_blocks, block_size, kv_heads]``, one symmetric scale per
  cached row, initialised to ones.  Under tensor parallelism each rank
  holds its ``kv_heads / tp`` heads of every arena (dim 3,
  :func:`arena_partition_spec`), the heads its attention computes.
- **Host side**: :class:`BlockAllocator`, a LIFO free list of physical
  block ids with refcounted ownership (a block is free XOR held by one or
  more owners); :class:`PrefixCache`, the chain-hash index that lets
  requests share full prompt-prefix blocks copy-on-write; and
  :class:`ExportLedger`, which pins a migrating request's block run
  (KV export to another engine) until the receiver acknowledges it.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.parallel.mesh import TENSOR_AXIS
from apex_tpu_torch.transformer.tensor_parallel.partition import (
    PartitionSpec,
)

__all__ = [
    "KVCacheConfig",
    "BlockAllocator",
    "OutOfBlocksError",
    "PrefixCache",
    "CACHE_OWNER",
    "EXPORT_OWNER",
    "KVExport",
    "ExportLedger",
    "init_kv_arena",
    "arena_partition_spec",
    "scale_partition_spec",
    "local_shape",
    "tp_world",
]

# the PrefixCache's own hold on a shared block (distinct from any request
# id, so freeing a cached block with a request's id raises)
CACHE_OWNER = "<prefix-cache>"

# prefix of the owner ``(EXPORT_OWNER, rid)`` a migrating run is pinned
# under: distinct from the request id and from CACHE_OWNER, so the source
# request can finish (its own refs free) while the run stays pinned until
# the receiver acknowledges it
EXPORT_OWNER = "<kv-export>"


class OutOfBlocksError(RuntimeError):
    """The arena cannot serve the requested number of blocks."""


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    """Static shape of the paged cache.  ``kv_heads`` is the *global*
    K/V head count (the model's ``query_groups``); under tensor
    parallelism each rank holds ``kv_heads / tp`` of them.  ``max_seq``
    rounds up to whole blocks; ``max_blocks_per_request`` is the
    block-table width.  ``dtype`` is the arena storage dtype;
    ``torch.int8`` also allocates the scale arenas (:attr:`quantized`)."""

    n_layers: int
    n_blocks: int
    block_size: int
    kv_heads: int
    head_dim: int
    max_seq: int
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.block_size < 1 or self.n_blocks < 1:
            raise ValueError(
                f"block_size ({self.block_size}) and n_blocks "
                f"({self.n_blocks}) must be positive")
        if self.max_seq < 1:
            raise ValueError(f"max_seq must be positive, got {self.max_seq}")

    @property
    def quantized(self) -> bool:
        return self.dtype == torch.int8

    @property
    def max_blocks_per_request(self) -> int:
        return -(-self.max_seq // self.block_size)

    def blocks_for(self, n_tokens: int) -> int:
        """Number of blocks a sequence of ``n_tokens`` occupies."""
        return -(-n_tokens // self.block_size)


def arena_partition_spec(tp_axis: Optional[str]) -> PartitionSpec:
    """Split of one arena: the heads (dim 3) over ``tp_axis``."""
    return PartitionSpec(None, None, None, tp_axis, None)


def scale_partition_spec(tp_axis: Optional[str]) -> PartitionSpec:
    """Split of one int8 scale arena ``[n_layers, n_blocks, block_size,
    kv_heads]``: the heads of the arena it scales."""
    if tp_axis is None:
        return PartitionSpec()
    return PartitionSpec(None, None, None, tp_axis)


def tp_world(mesh, tp_axis: Optional[str]) -> int:
    """The size of ``tp_axis`` on ``mesh`` (a
    :class:`~apex_tpu_torch.parallel.mesh.RankMesh`); 1 without either."""
    if mesh is None or tp_axis is None:
        return 1
    return mesh.shape[tp_axis]


def local_shape(shape, spec: PartitionSpec, tp_axis: Optional[str],
                tp: int) -> Tuple[int, ...]:
    """A rank's shard of ``shape`` under ``spec``: the dim ``spec`` gives
    ``tp_axis`` cut ``tp`` ways (raising ``ValueError`` when ``tp`` does
    not divide it)."""
    shape = list(shape)
    if tp_axis is not None and tp_axis in spec:
        dim = spec.index(tp_axis)
        if shape[dim] % tp:
            raise ValueError(
                f"dimension {dim} of size {shape[dim]} not divisible by tp "
                f"({tp})")
        shape[dim] //= tp
    return tuple(shape)


def init_kv_arena(cfg: KVCacheConfig, device=None, *, mesh=None,
                  tp_axis: Optional[str] = TENSOR_AXIS
                  ) -> Tuple[torch.Tensor, ...]:
    """Zeroed ``(k, v)`` arenas, or ``(k, v, k_scales, v_scales)`` for an
    int8 cache (scales start at one), on ``device`` (default: the CUDA
    device).  With a ``mesh``, this rank's shard of each
    (:func:`arena_partition_spec`, :func:`scale_partition_spec`); a head
    count that ``tp`` does not divide raises ``ValueError``."""
    device = resolve_device(device)
    tp = tp_world(mesh, tp_axis)
    if cfg.kv_heads % tp:
        raise ValueError(
            f"kv_heads ({cfg.kv_heads}) not divisible by tp ({tp})")
    shape = local_shape((cfg.n_layers, cfg.n_blocks, cfg.block_size,
                         cfg.kv_heads, cfg.head_dim),
                        arena_partition_spec(tp_axis), tp_axis, tp)
    arenas = [torch.zeros(shape, dtype=cfg.dtype, device=device),
              torch.zeros(shape, dtype=cfg.dtype, device=device)]
    if cfg.quantized:
        sshape = local_shape((cfg.n_layers, cfg.n_blocks, cfg.block_size,
                              cfg.kv_heads), scale_partition_spec(tp_axis),
                             tp_axis, tp)
        arenas += [torch.ones(sshape, dtype=torch.float32, device=device),
                   torch.ones(sshape, dtype=torch.float32, device=device)]
    return tuple(arenas)


class BlockAllocator:
    """Refcounted free-list allocator over the physical block pool.

    LIFO free list (recently freed blocks are reused first) plus a
    per-block holder set: :meth:`share` adds a holder to a live block
    (a prefix hit), :meth:`free` removes one and returns the block to the
    pool when the last holder lets go.  Double and foreign frees raise.
    Not thread-safe: the scheduler owns it from one thread.
    """

    def __init__(self, n_blocks: int):
        if n_blocks < 1:
            raise ValueError(f"n_blocks must be positive, got {n_blocks}")
        self.n_blocks = n_blocks
        self._free: List[int] = list(range(n_blocks - 1, -1, -1))
        self._holders: Dict[int, Set[Any]] = {}

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_owned(self) -> int:
        """Blocks with at least one holder (shared blocks count once)."""
        return len(self._holders)

    def refcount(self, block: int) -> int:
        """Holder count of ``block`` (0 = free)."""
        return len(self._holders.get(block, ()))

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int, owner: Any = None) -> List[int]:
        """Take ``n`` fresh blocks for ``owner``; raises
        :class:`OutOfBlocksError` (allocating nothing) when fewer are
        free."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        if n > len(self._free):
            raise OutOfBlocksError(
                f"requested {n} blocks, only {len(self._free)} of "
                f"{self.n_blocks} free")
        blocks = [self._free.pop() for _ in range(n)]
        for b in blocks:
            self._holders[b] = {owner}
        return blocks

    def share(self, block: int, owner: Any) -> None:
        """Add ``owner`` as a holder of a live block."""
        holders = self._holders.get(block)
        if holders is None:
            raise ValueError(f"cannot share free block {block}")
        if owner in holders:
            raise ValueError(f"owner {owner!r} already holds block {block}")
        holders.add(owner)

    def free(self, blocks: Sequence[int], owner: Any = None) -> None:
        """Release ``owner``'s hold on each block (checked for all blocks
        before any is released)."""
        for b in blocks:
            holders = self._holders.get(b)
            if holders is None:
                raise ValueError(f"double free of block {b}")
            if owner not in holders:
                raise ValueError(
                    f"block {b} owned by {sorted(map(repr, holders))}, "
                    f"freed by {owner!r}")
        for b in blocks:
            holders = self._holders[b]
            holders.discard(owner)
            if not holders:
                del self._holders[b]
                self._free.append(b)

    def check(self) -> None:
        """Assert that free and held partition the pool."""
        free = set(self._free)
        held = set(self._holders)
        if len(free) != len(self._free):
            raise AssertionError("duplicate ids on the free list")
        if free & held:
            raise AssertionError(
                f"blocks both free and held: {sorted(free & held)}")
        if free | held != set(range(self.n_blocks)):
            raise AssertionError(
                f"pool leak: {self.n_blocks - len(free) - len(held)} "
                "blocks neither free nor held")
        empties = [b for b, h in self._holders.items() if not h]
        if empties:
            raise AssertionError(f"held blocks with no holders: {empties}")


@dataclasses.dataclass
class KVExport:
    """One migrating block run, pinned on the source until acknowledged.

    ``blocks`` is the physical run, in prefix order, covering
    ``cache_len`` tokens of ``tokens`` (the request's wire sequence at
    export, kept so an acknowledged run can be indexed into the prefix
    cache under its chain hash).  The pin holds every block under the
    owner ``(EXPORT_OWNER, rid)``."""

    rid: Any
    blocks: List[int]
    tokens: List[int]
    cache_len: int

    @property
    def owner(self) -> Tuple[str, Any]:
        return (EXPORT_OWNER, self.rid)


class ExportLedger:
    """Pin-until-acknowledged bookkeeping of KV-block migration.

    On the source engine:

    1. :meth:`pin`: every block of the run gains the export owner
       (refcount + 1).  The exporting request then leaves the scheduler
       and its own refs free; the run lives on at refcount 1.
    2. The blocks travel to the receiver; the pin is a holder like any
       other, so nothing recycles them and ``BlockAllocator.check()``
       holds throughout.
    3. :meth:`release` on the receiver's acknowledgement: the run's full
       blocks are indexed into the prefix cache (the cache takes its ref
       before the pin lets go, so no block passes through the free
       list), and the partial tail block, or every block of a failed
       migration, returns to the pool.

    ``release`` is idempotent: a duplicate or stale acknowledgement is a
    no-op, never a double free."""

    def __init__(self, allocator: BlockAllocator,
                 prefix_cache: Optional["PrefixCache"] = None):
        self.allocator = allocator
        self.prefix_cache = prefix_cache
        self._pins: Dict[Any, KVExport] = {}

    def __len__(self) -> int:
        return len(self._pins)

    def pin(self, rid: Any, blocks: Sequence[int],
            tokens: Sequence[int], cache_len: int) -> KVExport:
        """Pin ``blocks`` (the run covering ``cache_len`` tokens) under
        the export owner; one export in flight per request id."""
        if rid in self._pins:
            raise ValueError(f"request {rid!r} already has an export "
                             "in flight")
        exp = KVExport(rid=rid, blocks=list(blocks),
                       tokens=[int(t) for t in tokens],
                       cache_len=int(cache_len))
        pinned = []
        try:
            for b in exp.blocks:
                self.allocator.share(b, exp.owner)
                pinned.append(b)
        except ValueError:
            # never leave a half-pinned run behind
            for b in pinned:
                self.allocator.free([b], owner=exp.owner)
            raise
        self._pins[rid] = exp
        return exp

    def release(self, rid: Any, *, to_cache: bool = True) -> int:
        """Drop the pin on ``rid``'s run.  ``to_cache=True`` (the
        acknowledgement) first indexes the run's full blocks into the
        prefix cache, so the shipped prefill stays a local hit;
        ``to_cache=False`` frees the run straight back to the pool.
        Returns the number of blocks the cache took; an unknown or
        released id is a no-op (0)."""
        exp = self._pins.pop(rid, None)
        if exp is None:
            return 0
        cached = 0
        if to_cache and self.prefix_cache is not None:
            before = self.prefix_cache.n_blocks
            self.prefix_cache.insert(exp.tokens, exp.blocks, exp.cache_len)
            cached = self.prefix_cache.n_blocks - before
        self.allocator.free(exp.blocks, owner=exp.owner)
        return cached

    def release_all(self, *, to_cache: bool = False) -> None:
        """Drop every outstanding pin (drain or shutdown)."""
        for rid in list(self._pins):
            self.release(rid, to_cache=to_cache)

    def check(self) -> None:
        """Every pinned block is live and held by its export owner."""
        for exp in self._pins.values():
            for b in exp.blocks:
                holders = self.allocator._holders.get(b)
                if not holders or exp.owner not in holders:
                    raise AssertionError(
                        f"export pin of {exp.rid!r} lost block {b}")


class PrefixCache:
    """Token-hash index of shareable full blocks.

    Full block ``i`` of a sequence is keyed by the chain hash of its first
    ``(i + 1) * block_size`` tokens, so a lookup walks the new prompt block
    by block and stops at the first miss.  The cache holds its own
    refcount (:data:`CACHE_OWNER`) on every indexed block, so blocks
    outlive the request that wrote them until an LRU eviction frees them.
    """

    def __init__(self, allocator: BlockAllocator, block_size: int):
        self.allocator = allocator
        self.block_size = block_size
        # insertion/touch order == LRU order (move_to_end on every hit)
        self._entries: "collections.OrderedDict[int, int]" = \
            collections.OrderedDict()
        self.hits = 0            # blocks served from cache (lifetime)
        self.evictions = 0       # entries evicted for capacity (lifetime)

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def n_blocks(self) -> int:
        return len(self._entries)

    def _block_hash(self, prev_hash: int, tokens: Sequence[int],
                    i: int) -> int:
        chunk = tuple(int(t) for t in
                      tokens[i * self.block_size:(i + 1) * self.block_size])
        return hash((prev_hash, chunk))

    def lookup(self, tokens: Sequence[int], owner: Any,
               *, max_blocks: Optional[int] = None) -> List[int]:
        """Share the longest cached prefix of ``tokens`` with ``owner``;
        at most ``(len(tokens) - 1) // block_size`` blocks, so at least
        one token is always recomputed and every write lands on a private
        block."""
        shared: List[int] = []
        cap = (len(tokens) - 1) // self.block_size
        if max_blocks is not None:
            cap = min(cap, max_blocks)
        h = 0
        for i in range(cap):
            h = self._block_hash(h, tokens, i)
            block = self._entries.get(h)
            if block is None:
                break
            self.allocator.share(block, owner)
            self._entries.move_to_end(h)
            shared.append(block)
        self.hits += len(shared)
        return shared

    def insert(self, tokens: Sequence[int], blocks: Sequence[int],
               upto_tokens: int, *, start_block: int = 0,
               prev_hash: int = 0) -> int:
        """Index the full blocks of ``tokens[:upto_tokens]`` (content
        already written to the arena), resuming the chain at
        ``start_block``/``prev_hash``; returns the last chain hash."""
        n_full = min(upto_tokens // self.block_size, len(blocks))
        h = prev_hash
        for i in range(start_block, n_full):
            h = self._block_hash(h, tokens, i)
            if h in self._entries:
                continue
            self.allocator.share(blocks[i], CACHE_OWNER)
            self._entries[h] = blocks[i]
        return h

    def evict_many(self, n: int) -> int:
        """Free up to ``n`` LRU entries the cache alone holds, in one
        sweep; returns how many blocks went back to the pool."""
        freed = 0
        for key in list(self._entries):
            if freed >= n:
                break
            block = self._entries[key]
            if self.allocator.refcount(block) == 1:
                del self._entries[key]
                self.allocator.free([block], owner=CACHE_OWNER)
                self.evictions += 1
                freed += 1
        return freed

    def evictable(self) -> int:
        """Blocks an eviction sweep could return to the pool now (the
        cache their only holder)."""
        return sum(1 for b in self._entries.values()
                   if self.allocator.refcount(b) == 1)

    def evict_one(self) -> Optional[int]:
        """Free the LRU entry the cache alone holds; its block id, or
        ``None`` when nothing is evictable."""
        for key, block in self._entries.items():
            if self.allocator.refcount(block) == 1:
                del self._entries[key]
                self.allocator.free([block], owner=CACHE_OWNER)
                self.evictions += 1
                return block
        return None

    def check(self) -> None:
        """Every indexed block is live and held by the cache."""
        for key, block in self._entries.items():
            if self.allocator.refcount(block) < 1:
                raise AssertionError(
                    f"cache entry {key} indexes free block {block}")
