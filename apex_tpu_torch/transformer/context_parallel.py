"""Context parallelism: ring attention and Ulysses (all-to-all) attention
(port of :mod:`apex_tpu.transformer.context_parallel`).

Every rank of the ``cp`` axis holds a sequence shard ``[b, h, s_local,
d]`` of q, k and v; rank ``r`` owns positions ``[r * s_local, (r + 1) *
s_local)``.  K/V may carry fewer heads than q (grouped-query attention):
only the compact ``g``-head K/V travels between ranks, and the broadcast
to the query heads happens locally right before each kernel call.

**Ring attention** (:func:`ring_attention`): ``cp`` steps; at step ``t``
the visiting K/V chunk is the one of rank ``(r - t) % cp``, and this rank
folds it into its running ``(out, lse)`` (:func:`_merge`), then passes it
on to rank ``r + 1`` in one batched permute.  Causal masking is decided
per chunk (:func:`_causal_case`): an earlier chunk is fully visible (F1
with ``causal=False``), the home chunk is causal with offset 0 (F1 with
``causal=True``), a later chunk is masked and launches nothing.  The case
depends on the rank, so it decides only which kernel runs, never whether
a rotation happens: every rank issues the same permutes in the same
order, forward and backward.  The backward is a
:class:`torch.autograd.Function` at the ring level: a chunk's gradient
depends on the others only through the global ``lse`` and ``delta =
rowsum(do * out)``, so each reverse step re-drives F2 and F3
(:func:`~apex_tpu_torch.ops.flash_attention.dq_chunk`,
:func:`~apex_tpu_torch.ops.flash_attention.dkv_chunk`) with the merged
statistics; ``dq`` accumulates locally in fp32, and the fp32 ``dk``/``dv``
accumulators (reduced over each GQA group) travel with their chunk and
arrive home after ``cp`` rotations.

**Ulysses attention** (:func:`ulysses_attention`): an all-to-all swaps
the sharded dim from sequence to heads, each rank runs full-sequence
flash attention (F1-F3) on ``h / cp`` heads, with the dropout seed
offset by its rank, and a second all-to-all swaps back.  The all-to-all
is :func:`~apex_tpu_torch.transformer.tensor_parallel.mappings.
all_to_all_region`, whose backward is the reverse all-to-all.

At ``cp = 1`` both are single-rank attention and call no collective (a
rotation or an all-to-all of one rank is the identity).
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops.flash_attention import (
    dkv_chunk,
    dq_chunk,
    flash_attention_with_lse,
)
from apex_tpu_torch.parallel import collectives as cc
from apex_tpu_torch.parallel.mesh import CONTEXT_AXIS
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    all_to_all_region,
)

__all__ = ["ring_attention", "ulysses_attention"]


def _merge(o, lse, o_new, lse_new):
    """Fold a partial ``(o_new, lse_new)`` into the running ``(o, lse)``
    (fp32 ``o``).  ``o is None`` (nothing seen yet) takes the partial as
    it is: what the fold gives from zeros and ``-inf``, bit for bit."""
    if o is None:
        return o_new.float(), lse_new
    lse_tot = torch.logaddexp(lse, lse_new)
    # guard -inf - -inf when a row has seen nothing anywhere yet
    w_old = torch.exp(torch.where(lse == lse_tot, 0.0, lse - lse_tot))
    w_old = torch.where(torch.isfinite(lse), w_old, 0.0)
    w_new = torch.exp(torch.where(lse_new == lse_tot, 0.0,
                                  lse_new - lse_tot))
    w_new = torch.where(torch.isfinite(lse_new), w_new, 0.0)
    o_tot = o * w_old[..., None] + o_new.to(o.dtype) * w_new[..., None]
    return o_tot, lse_tot


def _rotate(tensors, axis, cp: int):
    """Each tensor to rank ``r + 1`` of ``axis`` in one batched permute;
    the identity, with no call, at ``cp = 1``."""
    if cp == 1:
        return list(tensors)
    return cc.ppermute_many(tensors, axis,
                            [(i, (i + 1) % cp) for i in range(cp)])


def _gqa_rep(q, k) -> int:
    """Query heads per K/V head (1 = MHA)."""
    h, g = q.shape[1], k.shape[1]
    if h % g:
        raise ValueError(f"q heads ({h}) must be a multiple of kv heads "
                         f"({g})")
    return h // g


def _expand_kv(x, rep: int):
    return x if rep == 1 else x.repeat_interleave(rep, dim=1)


def _reduce_kv_grad(dx, rep: int):
    """Adjoint of :func:`_expand_kv`: sum each group's query-head grads."""
    if rep == 1:
        return dx
    b, h, s, d = dx.shape
    return dx.reshape(b, h // rep, rep, s, d).sum(dim=2)


def _causal_case(chunk: int, r: int) -> int:
    """0 = fully visible (chunk < r), 1 = diagonal (==), 2 = masked (>)."""
    return 0 if chunk < r else (1 if chunk == r else 2)


def _axis(axis):
    """``(cp, rank)``: the axis's size and this rank's index (1 and 0
    without a grid)."""
    cp = cc.bound_axis_size(axis)
    return cp, cc.axis_index(axis) if cp > 1 else 0


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, axis, causal, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        cp, r = _axis(axis)
        rep = _gqa_rep(q, k)
        # the running fp32 (out, lse), None until a chunk is folded in (the
        # home chunk, at step 0, is never masked)
        o = lse = None
        k_cur, v_cur = k, v
        for t in range(cp):
            case = _causal_case((r - t) % cp, r) if causal else 0
            if case != 2:
                o_t, lse_t = flash_attention_with_lse(
                    q, _expand_kv(k_cur, rep), _expand_kv(v_cur, rep),
                    case == 1, scale)
                o, lse = _merge(o, lse, o_t, lse_t)
            if t < cp - 1:      # the last rotation would only bring it home
                k_cur, v_cur = _rotate((k_cur, v_cur), axis, cp)
        out = o.to(q.dtype)
        lse = lse.contiguous()
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.axis, ctx.causal, ctx.scale = axis, causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        axis, causal, scale = ctx.axis, ctx.causal, ctx.scale
        cp, r = _axis(axis)
        rep = _gqa_rep(q, k)
        do = do.contiguous()
        delta = (do.float() * out.float()).sum(dim=-1)
        # the fp32 accumulators start at the home chunk's own gradients (step
        # 0 is never masked); dk/dv travel with their chunk in the compact
        # g-head form and are home again after cp rotations
        dq = dk = dv = None
        k_cur, v_cur = k, v
        for t in range(cp):
            case = _causal_case((r - t) % cp, r) if causal else 0
            if case != 2:
                k_exp, v_exp = _expand_kv(k_cur, rep), _expand_kv(v_cur, rep)
                kw = dict(causal=case == 1, scale=scale)
                dq_t = dq_chunk(q, k_exp, v_exp, do, lse, delta, **kw)
                dk_t, dv_t = dkv_chunk(q, k_exp, v_exp, do, lse, delta, **kw)
                dk_t = _reduce_kv_grad(dk_t.float(), rep)
                dv_t = _reduce_kv_grad(dv_t.float(), rep)
                if dq is None:
                    dq, dk, dv = dq_t.float(), dk_t, dv_t
                else:
                    dq, dk, dv = dq + dq_t.float(), dk + dk_t, dv + dv_t
            if t < cp - 1:
                k_cur, v_cur, dk, dv = _rotate((k_cur, v_cur, dk, dv), axis,
                                               cp)
            else:               # K/V are not needed any more
                dk, dv = _rotate((dk, dv), axis, cp)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def ring_attention(q, k, v, axis: str = CONTEXT_AXIS, causal: bool = True,
                   scale: Optional[float] = None):
    """Flash attention over a ring-sharded sequence.

    ``q``: this rank's shard ``[b, h, s_local, d]`` of a sequence of
    global length ``s_local * cp``; ``k, v``: ``[b, g, s_local, d]`` where
    ``g`` divides ``h``.  Returns the local output shard in q's dtype;
    differentiable in q, k and v.  Every rank of ``axis`` calls it."""
    return _RingAttention.apply(q, k, v, axis, causal, scale)


def ulysses_attention(q, k, v, axis: str = CONTEXT_AXIS,
                      causal: bool = True, scale: Optional[float] = None,
                      dropout_rate: float = 0.0, dropout_seed=None):
    """All-to-all (DeepSpeed-Ulysses) sequence-parallel attention.

    Local shards ``[b, h, s_local, d]`` with ``h % cp == 0``: all-to-all
    to ``[b, h/cp, s_global, d]``, full-sequence flash attention, and
    all-to-all back.  Grouped K/V whose ``g`` heads split over cp travel
    compact and are broadcast after the exchange; otherwise they are
    broadcast first (the exchange needs a head dim divisible by cp).
    Attention dropout runs in the kernels, the rank added to
    ``dropout_seed`` so the head groups draw different masks."""
    cp, r = _axis(axis)
    if q.shape[1] % cp != 0:
        raise ValueError(
            f"heads ({q.shape[1]}) must be divisible by cp ({cp})")
    rep = _gqa_rep(q, k)
    if rep > 1 and k.shape[1] % cp == 0:
        post_rep = rep
    else:
        k, v = _expand_kv(k, rep), _expand_kv(v, rep)
        post_rep = 1

    def scatter_heads(x):           # [b, h, s_local, d] -> [b, h/cp, s, d]
        return x if cp == 1 else all_to_all_region(x, axis, 1, 2)

    def gather_heads(x):
        return x if cp == 1 else all_to_all_region(x, axis, 2, 1)

    drop = {}
    if dropout_rate > 0.0:
        if dropout_seed is None:
            raise ValueError(
                "dropout_rate > 0 requires an explicit integer dropout_seed")
        seed = torch.as_tensor(dropout_seed, dtype=torch.int32,
                               device=q.device).reshape(1)
        drop = dict(dropout_rate=dropout_rate, dropout_seed=seed + r)
    qg, kg, vg = scatter_heads(q), scatter_heads(k), scatter_heads(v)
    kg, vg = _expand_kv(kg, post_rep), _expand_kv(vg, post_rep)
    out, _ = flash_attention_with_lse(qg, kg, vg, causal, scale, **drop)
    return gather_heads(out)
