"""Paged KV cache: the pooled block arenas and the host-side allocator.

Port of :mod:`apex_tpu.serving.kv_cache` for one card.

- **Device side**: one arena per K and per V, ``[n_layers, n_blocks,
  block_size, kv_heads, head_dim]``.  The serving step writes new rows
  into them in place (the JAX package donates them through ``jit`` for
  the same effect).  An **int8** cache adds two fp32 scale arenas
  ``[n_layers, n_blocks, block_size, kv_heads]``, one symmetric scale per
  cached row, initialised to ones.
- **Host side**: :class:`BlockAllocator`, a LIFO free list of physical
  block ids with refcounted ownership (a block is free XOR held by one or
  more owners), and :class:`PrefixCache`, the chain-hash index that lets
  requests share full prompt-prefix blocks copy-on-write.

The migration ledger of the JAX module (KV export/import between
replicas) is not ported yet.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import torch

from apex_tpu_torch._device import resolve_device

__all__ = [
    "KVCacheConfig",
    "BlockAllocator",
    "OutOfBlocksError",
    "PrefixCache",
    "CACHE_OWNER",
    "init_kv_arena",
]

# the PrefixCache's own hold on a shared block (distinct from any request
# id, so freeing a cached block with a request's id raises)
CACHE_OWNER = "<prefix-cache>"


class OutOfBlocksError(RuntimeError):
    """The arena cannot serve the requested number of blocks."""


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    """Static shape of the paged cache.  ``max_seq`` rounds up to whole
    blocks; ``max_blocks_per_request`` is the block-table width.
    ``dtype`` is the arena storage dtype; ``torch.int8`` also allocates
    the scale arenas (:attr:`quantized`)."""

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


def init_kv_arena(cfg: KVCacheConfig, device=None) -> Tuple[torch.Tensor, ...]:
    """Zeroed ``(k, v)`` arenas, or ``(k, v, k_scales, v_scales)`` for an
    int8 cache (scales start at one), on ``device`` (default: the CUDA
    device)."""
    device = resolve_device(device)
    shape = (cfg.n_layers, cfg.n_blocks, cfg.block_size, cfg.kv_heads,
             cfg.head_dim)
    arenas = [torch.zeros(shape, dtype=cfg.dtype, device=device),
              torch.zeros(shape, dtype=cfg.dtype, device=device)]
    if cfg.quantized:
        arenas += [torch.ones(shape[:-1], dtype=torch.float32, device=device),
                   torch.ones(shape[:-1], dtype=torch.float32, device=device)]
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

    def refcount(self, block: int) -> int:
        return len(self._holders.get(block, ()))

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
