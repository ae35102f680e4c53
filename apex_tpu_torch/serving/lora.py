"""Batched multi-LoRA serving: the adapter arena and the gathered delta.

Port of :mod:`apex_tpu.serving.lora`.  One base checkpoint,
many tenants: each tenant's fine-tune is a low-rank update
``W + B @ A * alpha / rank`` on the four projections of every layer
(fused QKV, attention dense, MLP fc1, MLP fc2).

- **Adapter arena**: the A/B pairs of every resident adapter live in
  eight stacked device tensors ``[L, n_slots, ...]``, one *slot* per
  adapter, managed on the host by :class:`AdapterArena` over the KV
  cache's :class:`~apex_tpu_torch.serving.kv_cache.BlockAllocator` (one
  "block" = one adapter slot).  Slot 0 is the permanent **zero
  adapter**: all-zero rows that every ``adapter_id=None`` request
  gathers, so its delta is an exact zero and its stream bitwise the bare
  engine's.  Registered adapters are LRU-evicted when cold; a pin per
  active request keeps an adapter resident while any request names it.
- **Gathered delta** (:func:`lora_delta`, L1): the decode and prefill
  calls receive a ``[max_batch]`` adapter-slot vector as data and add
  ``delta = (x @ A[slot]) @ B_scaled[slot]`` per batch slot to the base
  projection.  ``B`` is stored pre-scaled by ``alpha / rank``.

CUDA tensors launch a hand-written kernel of ``csrc/lora_delta.cu``, the
one :func:`lora_route` names: ``"cluster"`` (the first product computed
once per row tile by a thread-block cluster) for ranks 4, 8 and 16 over
16-byte-aligned adapter tensors, ``"simt"`` (the first kernel) for the
rest.  CPU tensors run :func:`lora_delta_plain`, the ``index_select``
twin of the JAX package's ``lora_delta_unfused``.

Under tensor parallelism (:func:`adapter_partition_specs`) each rank
holds its shard of the arena: the column-parallel projections' B (qkv,
fc1) split on their output dim, so the delta lands split like the base
output; the row-parallel projections' A (dense, fc2) split on their input
dim, so each rank's delta is a partial sum that the model all-reduces.
:func:`init_adapter_arena` allocates the rank's shard and
:func:`shard_adapter_values` cuts a full adapter to it.

Not ported yet: ``restore_adapter_for_serving`` (the adapter checkpoint
restore, with the checkpoint module; ROADMAP.md, section A.3).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch import _build
from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.parallel.mesh import TENSOR_AXIS
from apex_tpu_torch.serving.kv_cache import (
    BlockAllocator,
    OutOfBlocksError,
    local_shape,
    tp_world,
)
from apex_tpu_torch.transformer.tensor_parallel.partition import (
    PartitionSpec,
)

__all__ = [
    "ADAPTER_REGISTRY",
    "PROJECTIONS",
    "AdapterArena",
    "LoRAConfig",
    "OutOfAdapterSlotsError",
    "adapter_partition_specs",
    "adapter_shapes",
    "init_adapter_arena",
    "init_adapter_weights",
    "lora_delta",
    "lora_delta_plain",
    "lora_route",
    "pack_adapter_values",
    "shard_adapter_values",
]

#: Owner under which the arena itself holds every resident adapter's slot
#: (the prefix cache's ``CACHE_OWNER`` pattern): a slot is evictable
#: exactly when the registry is its only holder.
ADAPTER_REGISTRY = "<adapter-registry>"

#: Arena tensor order: (A, B) per projection, projections in this order.
PROJECTIONS = ("qkv", "dense", "fc1", "fc2")

# launches of L1 since the count was last set to 0, in all and per route
LAUNCHES = 0
CLUSTER_LAUNCHES = 0
SIMT_LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the ranks the cluster route is compiled for
_CLUSTER_RANKS = (4, 8, 16)


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    """Adapter-arena shape: ``max_adapters`` resident slots (the zero
    adapter at slot 0 comes on top), the shared ``rank`` of every
    registered adapter, and ``alpha``, the LoRA scale (B is stored
    multiplied by ``alpha / rank``)."""

    rank: int = 8
    max_adapters: int = 8
    alpha: float = 16.0

    def __post_init__(self):
        if self.rank < 1:
            raise ValueError(f"lora rank must be >= 1 (got {self.rank})")
        if self.max_adapters < 1:
            raise ValueError(
                f"max_adapters must be >= 1 (got {self.max_adapters})")

    @property
    def n_slots(self) -> int:
        """Resident slots + the permanent zero adapter at slot 0."""
        return self.max_adapters + 1


def adapter_shapes(config, lora: LoRAConfig
                   ) -> Dict[str, Tuple[Tuple[int, int], Tuple[int, int]]]:
    """Per-projection ``(A, B)`` shapes (without the ``[L, n_slots]``
    stack dims), matching the serving model's fused projections."""
    d = config.head_dim
    n, g = config.num_attention_heads, config.query_groups
    h, f, r = config.hidden_size, config.ffn_size, lora.rank
    return {
        "qkv": ((h, r), (r, (n + 2 * g) * d)),
        "dense": ((n * d, r), (r, h)),
        "fc1": ((h, r), (r, f)),
        "fc2": ((f, r), (r, h)),
    }


def adapter_partition_specs(tp_axis: Optional[str]
                            ) -> Tuple[PartitionSpec, ...]:
    """Splits of the eight arena tensors ``[L, n_slots, *shape]`` in
    arena order ``(qkv_a, qkv_b, dense_a, dense_b, fc1_a, fc1_b, fc2_a,
    fc2_b)``: the column-parallel projections (qkv, fc1) split B on its
    output dim (dim 3), the row-parallel ones (dense, fc2) A on its input
    dim (dim 2); the rest whole on every rank."""
    rep = PartitionSpec(None, None, None, None)
    col_b = PartitionSpec(None, None, None, tp_axis)
    row_a = PartitionSpec(None, None, tp_axis, None)
    return (rep, col_b, row_a, rep, rep, col_b, row_a, rep)


def init_adapter_arena(config, lora: LoRAConfig, device=None, *, mesh=None,
                       tp_axis: Optional[str] = TENSOR_AXIS
                       ) -> Tuple[torch.Tensor, ...]:
    """Eight zero tensors ``[L, n_slots, *shape]`` in arena order, in
    ``config.param_dtype`` on ``device`` (default: the CUDA device); with
    a ``mesh``, this rank's shards (:func:`adapter_partition_specs`).  A
    fresh arena is inert: every slot is the zero adapter."""
    device = resolve_device(device)
    tp = tp_world(mesh, tp_axis)
    shapes = adapter_shapes(config, lora)
    lead = (config.num_layers, lora.n_slots)
    full = [lead + shape for proj in PROJECTIONS for shape in shapes[proj]]
    return tuple(torch.zeros(local_shape(shape, spec, tp_axis, tp),
                             dtype=config.param_dtype, device=device)
                 for shape, spec in zip(full,
                                        adapter_partition_specs(tp_axis)))


def shard_adapter_values(vals, tp_rank: int, tp: int,
                         tp_axis: Optional[str] = TENSOR_AXIS):
    """This rank's slices of one adapter's eight per-slot values ``[L,
    *shape]`` (from :func:`pack_adapter_values`), the arena's split
    without its slot dim; the values themselves at ``tp == 1``."""
    if tp == 1:
        return tuple(vals)
    out = []
    for val, spec in zip(vals, adapter_partition_specs(tp_axis)):
        # the per-slot value lacks the arena's slot dim (dim 1)
        out.append(val if tp_axis not in spec else
                   val.chunk(tp, dim=spec.index(tp_axis) - 1)[tp_rank]
                   .contiguous())
    return tuple(out)


def init_adapter_weights(config, lora: LoRAConfig, *, seed: int = 0
                         ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Deterministic random host weights ``{proj: (A [L, in, r],
    B [L, r, out])}`` for one adapter, drawn as the JAX package draws
    them: both nonzero, 0.25-std entries, so adapters seeded differently
    give visibly different streams (a test and bench fixture)."""
    rng = np.random.default_rng(int(seed))
    shapes = adapter_shapes(config, lora)
    L = config.num_layers
    out = {}
    for proj in PROJECTIONS:
        (ai, ar), (br, bo) = shapes[proj]
        a = rng.standard_normal((L, ai, ar)).astype(np.float32) * 0.25
        b = rng.standard_normal((L, br, bo)).astype(np.float32) * 0.25
        out[proj] = (a, b)
    return out


def pack_adapter_values(config, lora: LoRAConfig, weights,
                        dtype=torch.float32) -> Tuple[torch.Tensor, ...]:
    """Validate one adapter's host weights and pack them into the eight
    arena-ordered per-slot values ``[L, *shape]`` (CPU tensors in
    ``dtype``), B scaled by ``alpha / rank`` before the one cast."""
    shapes = adapter_shapes(config, lora)
    L = config.num_layers
    scale = lora.alpha / lora.rank
    vals = []
    for proj in PROJECTIONS:
        try:
            a, b = weights[proj]
        except (KeyError, TypeError, ValueError):
            raise ValueError(
                f"adapter weights missing projection {proj!r} "
                f"(need {{proj: (A, B)}} for {PROJECTIONS})") from None
        a = np.asarray(a)
        b = np.asarray(b)
        want_a, want_b = ((L,) + shapes[proj][0], (L,) + shapes[proj][1])
        if a.shape != want_a or b.shape != want_b:
            raise ValueError(
                f"adapter {proj!r} shapes {a.shape}/{b.shape} do not "
                f"match arena {want_a}/{want_b} (rank={lora.rank})")
        vals.append(torch.from_numpy(np.array(a)).to(dtype))
        vals.append(torch.from_numpy(np.array(b * scale)).to(dtype))
    return tuple(vals)


# ---------------------------------------------------------------------------
# The refcounted slot registry
# ---------------------------------------------------------------------------


class OutOfAdapterSlotsError(OutOfBlocksError):
    """Registration needs a slot and every resident adapter is pinned by
    an active request (nothing is LRU-evictable)."""


class AdapterArena:
    """Host-side slot registry for the device adapter tensors.

    ``BlockAllocator(n_slots)`` does the refcounting: the registry holds
    every resident adapter's slot under :data:`ADAPTER_REGISTRY`, and
    every active request that names the adapter shares the slot under
    its rid.  A slot is LRU-evictable exactly when its refcount is 1.
    Slot 0 (the zero adapter) is allocated at construction and never
    enters the LRU.
    """

    def __init__(self, n_slots: int):
        if n_slots < 2:
            raise ValueError(
                f"adapter arena needs >= 2 slots (zero adapter + one "
                f"resident), got {n_slots}")
        self.n_slots = n_slots
        self.allocator = BlockAllocator(n_slots)
        (self.zero_slot,) = self.allocator.alloc(1, ADAPTER_REGISTRY)
        if self.zero_slot != 0:
            raise AssertionError("zero adapter must land in slot 0")
        # adapter_id -> slot, LRU order (oldest first; register and pin
        # move to the end, eviction walks from the front)
        self._slots: "OrderedDict[str, int]" = OrderedDict()
        self._pins: Dict[Any, int] = {}      # rid -> pinned slot
        self.loads = 0                       # lifetime registrations
        self.evictions = 0                   # lifetime LRU evictions

    def __len__(self) -> int:
        return len(self._slots)

    def resident(self, adapter_id) -> bool:
        return adapter_id in self._slots

    def slot_of(self, adapter_id) -> Optional[int]:
        return self._slots.get(adapter_id)

    def residents(self):
        """Resident adapter ids, LRU-oldest first."""
        return list(self._slots)

    @property
    def active(self) -> int:
        """Live request pins across all adapters."""
        return len(self._pins)

    def register(self, adapter_id) -> Tuple[int, Optional[str]]:
        """Claim a slot for ``adapter_id``; returns ``(slot, evicted)``.

        A resident id re-registers in place (same slot, moved to the LRU
        end): the hot-swap path, where the caller overwrites the slot's
        rows between steps.  A new id takes a free slot, LRU-evicting the
        coldest unpinned adapter when the arena is full; if every
        resident adapter is pinned, :class:`OutOfAdapterSlotsError`."""
        self.loads += 1
        if adapter_id in self._slots:
            self._slots.move_to_end(adapter_id)
            return self._slots[adapter_id], None
        evicted = None
        if self.allocator.n_free < 1:
            evicted = self._evict_one()
            if evicted is None:
                self.loads -= 1
                raise OutOfAdapterSlotsError(
                    f"no adapter slot free: all {len(self._slots)} "
                    f"resident adapters are pinned by active requests")
        (slot,) = self.allocator.alloc(1, ADAPTER_REGISTRY)
        self._slots[adapter_id] = slot
        return slot, evicted

    def _evict_one(self) -> Optional[str]:
        for aid, slot in self._slots.items():
            if self.allocator.refcount(slot) == 1:   # registry only
                del self._slots[aid]
                self.allocator.free([slot], ADAPTER_REGISTRY)
                self.evictions += 1
                return aid
        return None

    def unregister(self, adapter_id) -> int:
        """Drop the registry's hold on ``adapter_id``.  The slot stays
        allocated (its rows live) until the last pinning request
        finishes; new requests can no longer name the adapter."""
        slot = self._slots.pop(adapter_id, None)
        if slot is None:
            raise KeyError(f"adapter {adapter_id!r} is not resident")
        self.allocator.free([slot], ADAPTER_REGISTRY)
        return slot

    def pin(self, adapter_id, rid) -> int:
        """Pin ``adapter_id`` for request ``rid``; returns the slot the
        request's batch entry gathers."""
        slot = self._slots.get(adapter_id)
        if slot is None:
            raise KeyError(f"adapter {adapter_id!r} is not resident")
        if rid in self._pins:
            raise ValueError(f"request {rid!r} already pins a slot")
        self.allocator.share(slot, rid)
        self._slots.move_to_end(adapter_id)
        self._pins[rid] = slot
        return slot

    def unpin(self, rid) -> None:
        """Release ``rid``'s pin; a no-op for a request that holds none,
        so every terminal path can call it."""
        slot = self._pins.pop(rid, None)
        if slot is not None:
            self.allocator.free([slot], rid)

    def pinned_slot(self, rid) -> int:
        """The arena slot ``rid`` gathers (the zero slot when unpinned)."""
        return self._pins.get(rid, self.zero_slot)

    def check(self) -> None:
        """Arena invariants: the allocator's free-XOR-held, every
        resident slot held, every pin a share on a held slot, the zero
        slot held."""
        self.allocator.check()
        seen = set()
        for aid, slot in self._slots.items():
            if slot in seen:
                raise AssertionError(f"slot {slot} mapped twice")
            seen.add(slot)
            if self.allocator.refcount(slot) < 1:
                raise AssertionError(
                    f"resident adapter {aid!r} slot {slot} has no holders")
        for rid, slot in self._pins.items():
            if self.allocator.refcount(slot) < 1:
                raise AssertionError(
                    f"pin {rid!r} on slot {slot} with no holders")
        if self.allocator.refcount(self.zero_slot) < 1:
            raise AssertionError("zero adapter slot was freed")


# ---------------------------------------------------------------------------
# The gathered delta: L1 and its plain version
# ---------------------------------------------------------------------------


def _check_delta(x, a, b, slots):
    if x.dim() != 3 or a.dim() != 3 or b.dim() != 3:
        raise ValueError(
            f"need x [S, B, in], a [n_slots, in, r], b [n_slots, r, out]; "
            f"got {tuple(x.shape)}, {tuple(a.shape)}, {tuple(b.shape)}")
    S, B, n_in = x.shape
    if (a.shape[1] != n_in or b.shape[1] != a.shape[2]
            or b.shape[0] != a.shape[0]):
        raise ValueError(
            f"shapes do not chain: x {tuple(x.shape)}, a {tuple(a.shape)}, "
            f"b {tuple(b.shape)}")
    if tuple(slots.shape) != (B,):
        raise ValueError(f"slots {tuple(slots.shape)} != [{B}]")


def _check_cuda_operands(x, a, b, slots):
    """What the CUDA kernel takes; raise on anything else."""
    for name, t in (("a", a), ("b", b), ("slots", slots)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.stride(2) != 1:
        raise ValueError("x must be contiguous along its last dim")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if a.dtype not in _DTYPE_CODES or b.dtype != a.dtype:
        raise TypeError(
            f"a and b must share float32 or bfloat16, got {a.dtype}/"
            f"{b.dtype}")
    if slots.dtype != torch.int32:
        raise TypeError(f"slots must be int32, got {slots.dtype}")


def lora_delta(x, a, b, slots):
    """``delta[s, i] = (x[s, i] @ a[slots[i]]) @ b[slots[i]]`` (L1).

    ``x [S, B, in]`` sequence-major activations (any strides over the
    first two dims); ``a [n_slots, in, r]``; ``b [n_slots, r, out]``
    (pre-scaled); ``slots [B]`` int32, each in ``[0, n_slots)``.  Both
    products in fp32, cast once to ``x.dtype``; returns ``[S, B, out]``.
    CUDA tensors launch the kernel :func:`lora_route` names; CPU tensors
    run :func:`lora_delta_plain`."""
    _check_delta(x, a, b, slots)
    if x.device.type == "cpu":
        return lora_delta_plain(x, a, b, slots)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_cuda_operands(x, a, b, slots)
    return _launch(lora_route(x, a, b), x, a, b, slots)


def lora_route(x, a, b) -> str:
    """The L1 kernel that operands of these shapes take: ``"cluster"``
    for a rank of 4, 8 or 16 with ``a`` and ``b`` 16-byte aligned (``x``
    may be any view the kernel takes); ``"simt"`` for anything else."""
    del x   # every x the kernel takes suits both routes
    if (a.shape[2] in _CLUSTER_RANKS and a.data_ptr() % 16 == 0
            and b.data_ptr() % 16 == 0):
        return "cluster"
    return "simt"


def _launch(route, x, a, b, slots):
    """L1 on checked CUDA operands through the kernel ``route`` names."""
    global LAUNCHES, CLUSTER_LAUNCHES, SIMT_LAUNCHES
    S, B, n_in = x.shape
    n_slots, _, r = a.shape
    n_out = b.shape[2]
    y = torch.empty((S, B, n_out), dtype=x.dtype, device=x.device)
    lib = _build.library()
    fn = (lib.apex_lora_delta_cluster if route == "cluster"
          else lib.apex_lora_delta)
    with torch.cuda.device(x.device):
        rc = fn(_DTYPE_CODES[x.dtype], _DTYPE_CODES[a.dtype], x.data_ptr(),
                a.data_ptr(), b.data_ptr(), slots.data_ptr(), y.data_ptr(),
                S, B, n_in, r, n_out, n_slots, x.stride(0), x.stride(1),
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise RuntimeError(
            f"LoRA delta kernel ({route}) launch failed: CUDA error {rc}")
    LAUNCHES += 1
    if route == "cluster":
        CLUSTER_LAUNCHES += 1
    else:
        SIMT_LAUNCHES += 1
    return y


def lora_delta_plain(x, a, b, slots):
    """Plain PyTorch version of :func:`lora_delta`: gather each batch
    slot's A and B with ``index_select``, contract in fp32, cast."""
    _check_delta(x, a, b, slots)
    idx = slots.long()
    ag = a.index_select(0, idx).float()                 # [B, in, r]
    bg = b.index_select(0, idx).float()                 # [B, r, out]
    t = torch.einsum("sbi,bir->sbr", x.float(), ag)
    return torch.einsum("sbr,bro->sbo", t, bg).to(x.dtype)
