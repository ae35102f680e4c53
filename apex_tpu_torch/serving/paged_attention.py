"""Paged attention over the block-table KV cache: the CUDA kernels and
their plain PyTorch versions.

Port of :mod:`apex_tpu.serving.paged_attention`, with the same layouts::

    decode   q:   [batch, n_heads, head_dim]      (one token per slot)
    prefill  q:   [batch, chunk, n_heads, head_dim]
    k/v arena:    [n_blocks, block_size, kv_heads, head_dim]
    k/v scales:   [n_blocks, block_size, kv_heads]  fp32 (int8 cache)
    block_tables: [batch, max_blocks]  int32  (entries past the live
                  range may hold anything in range; they are never read)
    lengths:      [batch] int32  (tokens in cache; 0 = inactive slot)
    limits:       [batch, chunk] int32 (prefill: token t attends cache
                  positions < limits[:, t]; 0 = padding token)
    out:          q's shape and dtype (zeros for a length/limit of 0)

:func:`paged_attention_decode` and :func:`paged_prefill_attention` launch
the hand-written kernels of ``csrc/paged_attention.cu`` on CUDA tensors
(K1 and K2 of the port; the source's note says how they are built) and
run :func:`paged_attention_decode_plain` / :func:`paged_prefill_attention_plain`
on CPU tensors.  K1 has two routes, chosen by :func:`decode_route` from
the operands' dtypes and shapes: ``"split"``, the split-context kernel
(bf16 q over a bf16 or int8 cache: 128 cache positions per CTA, K/V read
straight into registers, the spans combined in the same launch by the
last CTA of each (slot, kv group)), and ``"simt"``, the first kernel,
for fp32 and the shapes the first does not take; both keep P in fp32.
K2 has two routes, chosen by :func:`prefill_route`: ``"tc"``, the Hopper
tensor-core kernel (wgmma, TMA page loads, an mbarrier ring; bf16 q over
a bf16 or int8 cache), which rounds P to bf16 before P.V as F1 and SDPA
do, and ``"simt"``, the CUDA-core kernel with fp32 P, for fp32 (exact
fp32) and the shapes the first does not take.  A failed build or launch
on any route raises; no route falls back to another.  The plain versions
gather each slot's whole table and lower the masked softmax as separate
ops, like the JAX package's ``*_unfused`` twins; they are the CPU path
and the kernels' reference.

:func:`paged_attention_decode_unfused` and
:func:`paged_prefill_attention_unfused` are those twins under the
reference's names and signatures: plain PyTorch on any device, CUDA
tensors included, launching neither kernel.  The engine runs them when
``ServingConfig(fused_attention=False)`` asks for the reference's A/B
baseline.

The speculative k+1 verify is a 4-D ``q [batch, k+1, n_heads, head_dim]``
with per-position ``limits [batch, k+1]`` through
:func:`paged_attention_decode`: it takes K2's multi-query sweep (a verify
step is a self-proposed chunk), as the JAX package routes it to
``_multi_query_attention``, and its launches count in
``PREFILL_LAUNCHES``.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch import _build

__all__ = [
    "decode_route",
    "paged_attention_decode",
    "paged_attention_decode_plain",
    "paged_attention_decode_unfused",
    "paged_prefill_attention",
    "paged_prefill_attention_plain",
    "paged_prefill_attention_unfused",
    "prefill_route",
]

NEG_INF = -1e30

# launches of each kernel since the count was last set to 0; each total
# is also counted per route
DECODE_LAUNCHES = 0
DECODE_SPLIT_LAUNCHES = 0
DECODE_SIMT_LAUNCHES = 0
PREFILL_LAUNCHES = 0
PREFILL_TC_LAUNCHES = 0
PREFILL_SIMT_LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# query rows ((token, head of one KV group) pairs) of one K2 CTA: the tc
# route's tile (one wgmma warpgroup, compiled), and the simt route's
_PREFILL_ROWS = 64
_SIMT_PREFILL_ROWS = 16
# the largest heads per KV group and head dim of K1's split route (compiled)
_SPLIT_MAX_HPG = 8
_SPLIT_MAX_D = 128
# K1's split route: per device, the (slot, kv group) tickets its CTAs take
# (zeroed once; each launch leaves them zeroed)
_TICKETS = {}


def _resolve(scale: Optional[float], d: int) -> float:
    return (1.0 / (d ** 0.5)) if scale is None else scale


def _check_arena(q_d, k_arena, n, g, k_scales, v_scales):
    if k_arena.shape[-1] != q_d:
        raise ValueError(
            f"head_dim mismatch: q {q_d}, arena {k_arena.shape[-1]}")
    if n % g:
        raise ValueError(f"n_heads ({n}) not a multiple of kv_heads ({g})")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("pass both k_scales and v_scales or neither")
    if k_scales is not None and k_scales.shape != k_arena.shape[:-1]:
        raise ValueError(
            f"scale arena shape {tuple(k_scales.shape)} != arena rows "
            f"{tuple(k_arena.shape[:-1])}")


def _check_cuda_operands(q, k_arena, v_arena, block_tables, lengths, limits,
                         k_scales, v_scales):
    """What the CUDA kernel takes; raise on anything else."""
    named = dict(q=q, k_arena=k_arena, v_arena=v_arena,
                 block_tables=block_tables, lengths=lengths, limits=limits,
                 k_scales=k_scales, v_scales=v_scales)
    named = {k: t for k, t in named.items() if t is not None}
    for name, t in named.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k_arena.dtype not in _DTYPE_CODES or v_arena.dtype != k_arena.dtype:
        raise TypeError(
            f"arenas must share one of float32/bfloat16/int8, got "
            f"{k_arena.dtype}/{v_arena.dtype}")
    for name in ("k_scales", "v_scales"):
        if name in named and named[name].dtype != torch.float32:
            raise TypeError(f"{name} must be float32")
    for name in ("block_tables", "lengths", "limits"):
        if name in named and named[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32")
    b = q.shape[0]
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError(
            f"block_tables {tuple(block_tables.shape)} != [{b}, max_blocks]")
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths {tuple(lengths.shape)} != [{b}]")
    if limits is not None and tuple(limits.shape) != tuple(q.shape[:2]):
        raise ValueError(
            f"limits {tuple(limits.shape)} != {tuple(q.shape[:2])}")
    row_bytes = k_arena.shape[-1] * k_arena.element_size()
    if row_bytes % 16 or k_arena.data_ptr() % 16 or v_arena.data_ptr() % 16:
        raise ValueError(
            "the kernel loads cache rows 16 bytes at a time: head_dim * "
            "itemsize must be a multiple of 16 and the arenas 16-byte "
            "aligned")


def _ptr(t):
    return None if t is None else t.data_ptr()


def paged_attention_decode(q, k_arena, v_arena, block_tables, lengths, *,
                           limits=None, k_scales=None, v_scales=None,
                           block_size: Optional[int] = None,
                           scale: Optional[float] = None):
    """One query token per slot attends over its paged context (K1).

    CUDA tensors launch the kernel; CPU tensors run
    :func:`paged_attention_decode_plain`.  ``k_scales``/``v_scales`` are
    the per-row fp32 scale arenas of an int8 cache.

    **Speculative k+1 verify**: with ``q [batch, k+1, n, d]`` and
    per-position ``limits [batch, k+1]`` (token t attends cache positions
    ``< limits[:, t]``; 0 = padding), all k+1 positions of every slot
    attend in one block sweep of K2 (:func:`paged_prefill_attention`),
    ``lengths`` being the slot's cache length including the just-written
    draft rows."""
    global DECODE_LAUNCHES
    n_blocks, bs, g, _ = k_arena.shape
    if block_size is not None and block_size != bs:
        raise ValueError(
            f"block_size ({block_size}) != arena block dim ({bs})")
    if q.dim() == 4:
        if limits is None:
            raise ValueError(
                "4-D q (the k+1 verify step) needs per-position limits")
        return paged_prefill_attention(
            q, k_arena, v_arena, block_tables, lengths, limits,
            k_scales=k_scales, v_scales=v_scales, scale=scale)
    if limits is not None:
        raise ValueError("limits only apply to a 4-D (multi-query) q")
    if q.dim() != 3:
        raise ValueError(
            f"decode q must be [batch, n_heads, head_dim] or [batch, k+1, "
            f"n_heads, head_dim], got {tuple(q.shape)}")
    b, n, d = q.shape
    _check_arena(d, k_arena, n, g, k_scales, v_scales)
    if q.device.type == "cpu":
        return paged_attention_decode_plain(
            q, k_arena, v_arena, block_tables, lengths, k_scales=k_scales,
            v_scales=v_scales, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_cuda_operands(q, k_arena, v_arena, block_tables, lengths, None,
                         k_scales, v_scales)
    return _launch_decode(decode_route(q, k_arena, v_arena), q, k_arena,
                          v_arena, block_tables, lengths, k_scales, v_scales,
                          scale)


def decode_route(q, k_arena, v_arena) -> str:
    """The K1 kernel that operands of these dtypes and shapes take:
    ``"split"`` (the split-context kernel) for bf16 q ``[batch, n_heads,
    head_dim]`` over a bf16 or int8 cache, a head dim that is a multiple
    of 8 up to 128, at most 8 query heads per KV head, and 16-byte-aligned
    q and arenas; ``"simt"`` for anything else."""
    d = q.shape[-1]
    n, g = q.shape[-2], k_arena.shape[2]
    if (q.dtype == torch.bfloat16
            and k_arena.dtype in (torch.bfloat16, torch.int8)
            and v_arena.dtype == k_arena.dtype
            and d % 8 == 0 and 0 < d <= _SPLIT_MAX_D
            and g > 0 and n % g == 0 and 0 < n // g <= _SPLIT_MAX_HPG
            and all(t.data_ptr() % 16 == 0 for t in (q, k_arena, v_arena))):
        return "split"
    return "simt"


def _tickets(device, count):
    """At least ``count`` zeroed int32 tickets on ``device`` (cached)."""
    tickets = _TICKETS.get(device)
    if tickets is None or tickets.numel() < count:
        tickets = torch.zeros(count, dtype=torch.int32, device=device)
        _TICKETS[device] = tickets
    return tickets


def _launch_decode(route, q, k_arena, v_arena, block_tables, lengths,
                   k_scales, v_scales, scale):
    """K1 on checked CUDA operands through the kernel ``route`` names."""
    global DECODE_LAUNCHES, DECODE_SPLIT_LAUNCHES, DECODE_SIMT_LAUNCHES
    b, n, d = q.shape
    _, bs, g, _ = k_arena.shape
    max_blocks = block_tables.shape[1]
    out = torch.empty_like(q)
    lib = _build.library()
    operands = (q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(),
                _ptr(k_scales), _ptr(v_scales), block_tables.data_ptr(),
                lengths.data_ptr())
    tail = (_resolve(scale, d), torch.cuda.current_stream(q.device).cuda_stream)
    with torch.cuda.device(q.device):
        if route == "split":
            splits = lib.apex_paged_decode_splits(max_blocks * bs)
            part = (torch.empty(b * n * splits * (d + 2), dtype=torch.float32,
                                device=q.device) if splits > 1 else None)
            rc = lib.apex_paged_decode_split(
                _DTYPE_CODES[k_arena.dtype], *operands, _ptr(part),
                _tickets(q.device, b * g).data_ptr(), out.data_ptr(), b, n, g,
                d, bs, max_blocks, splits, *tail)
        elif route == "simt":
            rc = lib.apex_paged_attention_decode(
                _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_arena.dtype], *operands,
                out.data_ptr(), b, n, g, d, bs, max_blocks, *tail)
        else:
            raise ValueError(f"unknown paged decode route {route!r}")
    if rc:
        raise RuntimeError(
            f"paged decode kernel ({route}) launch failed: CUDA error {rc}")
    DECODE_LAUNCHES += 1
    if route == "split":
        DECODE_SPLIT_LAUNCHES += 1
    else:
        DECODE_SIMT_LAUNCHES += 1
    return out


def paged_prefill_attention(q, k_arena, v_arena, block_tables, lengths,
                            limits, *, k_scales=None, v_scales=None,
                            scale: Optional[float] = None):
    """Each slot's ``[chunk]`` query tokens attend over the slot's paged
    context in one block sweep (K2).

    ``lengths`` is each slot's live cache length INCLUDING the chunk's
    own just-scattered rows; ``limits`` the per-token causal horizon.
    CUDA tensors launch the kernel; CPU tensors run
    :func:`paged_prefill_attention_plain`."""
    if q.dim() != 4:
        raise ValueError(
            f"prefill q must be [batch, chunk, n_heads, head_dim], got "
            f"{tuple(q.shape)}")
    b, T, n, d = q.shape
    n_blocks, bs, g, _ = k_arena.shape
    _check_arena(d, k_arena, n, g, k_scales, v_scales)
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(
            q, k_arena, v_arena, block_tables, lengths, limits,
            k_scales=k_scales, v_scales=v_scales, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_cuda_operands(q, k_arena, v_arena, block_tables, lengths, limits,
                         k_scales, v_scales)
    return _launch_prefill(prefill_route(q, k_arena, v_arena), q, k_arena,
                           v_arena, block_tables, lengths, limits, k_scales,
                           v_scales, scale)


def prefill_route(q, k_arena, v_arena) -> str:
    """The K2 kernel that operands of these dtypes and shapes take:
    ``"tc"`` (the tensor-core kernel) for bf16 q over a bf16 or int8
    cache, a head dim that is a multiple of 8 (bf16 cache) or 16 (int8:
    TMA's 16-byte row rule) up to 128, a block size that is a multiple of
    8 dividing 64, and 16-byte-aligned q and arenas; ``"simt"`` for
    anything else."""
    d = q.shape[-1]
    bs = k_arena.shape[1]
    row = 16 if k_arena.dtype == torch.int8 else 8
    if (q.dtype == torch.bfloat16
            and k_arena.dtype in (torch.bfloat16, torch.int8)
            and v_arena.dtype == k_arena.dtype
            and d % row == 0 and 0 < d <= 128
            and bs % 8 == 0 and 64 % bs == 0
            and all(t.data_ptr() % 16 == 0 for t in (q, k_arena, v_arena))):
        return "tc"
    return "simt"


def _launch_prefill(route, q, k_arena, v_arena, block_tables, lengths,
                    limits, k_scales, v_scales, scale):
    """K2 on checked CUDA operands through the kernel ``route`` names."""
    global PREFILL_LAUNCHES, PREFILL_TC_LAUNCHES, PREFILL_SIMT_LAUNCHES
    b, T, n, d = q.shape
    n_blocks, bs, g, _ = k_arena.shape
    out = torch.empty_like(q)
    lib = _build.library()
    operands = (q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(),
                _ptr(k_scales), _ptr(v_scales), block_tables.data_ptr(),
                lengths.data_ptr(), limits.data_ptr(), out.data_ptr(),
                b, T, n, g, d, bs, block_tables.shape[1])
    if route == "tc":
        fn, lead = lib.apex_paged_prefill_tc, (_DTYPE_CODES[k_arena.dtype],)
        tail = (n_blocks,)
    elif route == "simt":
        fn = lib.apex_paged_attention_prefill
        lead = (_DTYPE_CODES[q.dtype], _DTYPE_CODES[k_arena.dtype])
        tail = (max(1, _SIMT_PREFILL_ROWS // (n // g)),)
    else:
        raise ValueError(f"unknown paged prefill route {route!r}")
    with torch.cuda.device(q.device):
        rc = fn(*lead, *operands, *tail, _resolve(scale, d),
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(
            f"paged prefill kernel ({route}) launch failed: CUDA error {rc}")
    PREFILL_LAUNCHES += 1
    if route == "tc":
        PREFILL_TC_LAUNCHES += 1
    else:
        PREFILL_SIMT_LAUNCHES += 1
    return out


# ------------------------------------------------------- plain versions


def _gathered_kv(k_arena, v_arena, block_tables, k_scales, v_scales, hpg):
    """Materialise each slot's whole table of K/V as fp32 (int8 rows times
    their scales), GQA groups repeated over their query heads."""
    b, max_blocks = block_tables.shape
    _, bs, g, d = k_arena.shape
    idx = block_tables.long()
    k = k_arena[idx].float()                   # [b, max_blocks, bs, g, d]
    v = v_arena[idx].float()
    if k_scales is not None:
        k = k * k_scales[idx][..., None]
        v = v * v_scales[idx][..., None]
    t = max_blocks * bs
    k = k.reshape(b, t, g, d)
    v = v.reshape(b, t, g, d)
    if hpg > 1:
        k = k.repeat_interleave(hpg, dim=2)
        v = v.repeat_interleave(hpg, dim=2)
    return k, v, t


def _masked_softmax_av(s, mask, v_einsum, v):
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m <= NEG_INF * 0.5, 0.0, m)
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    return torch.einsum(v_einsum, p, v) / torch.where(l == 0.0, 1.0, l)


def paged_attention_decode_plain(q, k_arena, v_arena, block_tables, lengths,
                                 *, k_scales=None, v_scales=None,
                                 scale: Optional[float] = None):
    """Plain PyTorch version of :func:`paged_attention_decode`."""
    b, n, d = q.shape
    g = k_arena.shape[2]
    _check_arena(d, k_arena, n, g, k_scales, v_scales)
    k, v, t = _gathered_kv(k_arena, v_arena, block_tables, k_scales,
                           v_scales, n // g)
    s = torch.einsum("bnd,btnd->bnt", q.float(), k) * _resolve(scale, d)
    cols = torch.arange(t, device=q.device)
    mask = cols[None, None, :] < lengths.long()[:, None, None]
    out = _masked_softmax_av(s, mask, "bnt,btnd->bnd", v)
    return out.to(q.dtype)


def paged_prefill_attention_plain(q, k_arena, v_arena, block_tables,
                                  lengths, limits, *, k_scales=None,
                                  v_scales=None,
                                  scale: Optional[float] = None):
    """Plain PyTorch version of :func:`paged_prefill_attention`: gather
    each slot's whole table, mask per token."""
    b, T, n, d = q.shape
    g = k_arena.shape[2]
    _check_arena(d, k_arena, n, g, k_scales, v_scales)
    k, v, t = _gathered_kv(k_arena, v_arena, block_tables, k_scales,
                           v_scales, n // g)
    s = torch.einsum("btnd,bsnd->btns", q.float(), k) * _resolve(scale, d)
    cols = torch.arange(t, device=q.device)
    mask = cols[None, None, None, :] < limits.long()[:, :, None, None]
    out = _masked_softmax_av(s, mask, "btns,bsnd->btnd", v)
    return out.to(q.dtype)


def paged_attention_decode_unfused(q, k_arena, v_arena, block_tables,
                                   lengths, *, limits=None, k_scales=None,
                                   v_scales=None,
                                   scale: Optional[float] = None):
    """The separate-ops lowering of :func:`paged_attention_decode` on any
    device, the A/B baseline of K1: each slot's whole table gathered into
    fp32 copies, then the masked softmax as separate ops.  A 4-D ``q``
    with ``limits`` is the unfused k + 1 verify
    (:func:`paged_prefill_attention_unfused`).  Launches no kernel."""
    if q.dim() == 4:
        if limits is None:
            raise ValueError(
                "4-D q (the k+1 verify step) needs per-position limits")
        return paged_prefill_attention_unfused(
            q, k_arena, v_arena, block_tables, lengths, limits,
            k_scales=k_scales, v_scales=v_scales, scale=scale)
    if limits is not None:
        raise ValueError("limits only apply to a 4-D (multi-query) q")
    return paged_attention_decode_plain(
        q, k_arena, v_arena, block_tables, lengths, k_scales=k_scales,
        v_scales=v_scales, scale=scale)


def paged_prefill_attention_unfused(q, k_arena, v_arena, block_tables,
                                    lengths, limits, *, k_scales=None,
                                    v_scales=None,
                                    scale: Optional[float] = None):
    """The separate-ops lowering of :func:`paged_prefill_attention` on any
    device, the A/B baseline of K2: gather each slot's whole table, mask
    per token.  Launches no kernel."""
    return paged_prefill_attention_plain(
        q, k_arena, v_arena, block_tables, lengths, limits,
        k_scales=k_scales, v_scales=v_scales, scale=scale)
