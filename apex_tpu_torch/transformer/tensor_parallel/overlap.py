"""The ring-decomposed collective matmul: the tensor- and
sequence-parallel collectives overlapped with their GEMMs (port of
:mod:`apex_tpu.transformer.tensor_parallel.overlap`).

The sequence-parallel linears all-gather the sequence shards and then
multiply (:class:`ColumnParallelLinear`), or multiply and then
reduce-scatter (:class:`RowParallelLinear`), so the link idles during the
GEMM and the GEMM waits on the link.  Here each becomes a ``tp``-step
ring: every step sends one chunk to a neighbour while it multiplies the
chunk it already holds.

- :func:`gather_matmul` is ``all_gather(x, dim=0) @ w.T``: rank ``r``
  starts with chunk ``r``, and after ``t`` hops toward rank - 1 it holds
  chunk ``(r + t) % n``.
- :func:`matmul_scatter` is ``reduce_scatter(x @ w.T, dim=0)``: an
  accumulator travels toward rank + 1, and each step adds this rank's
  partial GEMM for the chunk the accumulator is bound for.

Each is a :class:`torch.autograd.Function` whose backward is the
transposed ring, as the JAX package's custom VJPs are: ``gather_matmul``'s
input gradient is a ``matmul_scatter``-shaped ring and its weight gradient
re-rotates the saved activation, and ``matmul_scatter``'s backward rotates
the cotangent once for both.  Each chunk's pair of products is the
pullback of the GEMM core itself (:func:`torch.autograd.grad` of
``x @ w.T``, or of :func:`apex_tpu_torch.amp.fp8.fp8_matmul_t` with
``fp8_metas``: e4m3 operands, an e5m2 cotangent scaled per chunk, as the
JAX package pulls back each chunk).

A hop is issued (:func:`apex_tpu_torch.parallel.collectives.ppermute_start`)
before the GEMM that does not need it and waited on after it.  The rings
are unrolled in Python (``tp`` is small).  At one rank, or with
``axis=None``, both are the one local GEMM.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.parallel import collectives as cc
from apex_tpu_torch.parallel.mesh import TENSOR_AXIS

__all__ = ["gather_matmul", "matmul_scatter"]


def _mm(x, w, metas):
    """The local GEMM core: ``x @ w.T`` (``w`` is ``[out, in]``), through
    the fp8 GEMM when metas are given."""
    if metas is None:
        return torch.matmul(x, w.t())
    from apex_tpu_torch.amp.fp8 import fp8_matmul_t

    return fp8_matmul_t(x, w, metas["x"], metas["w"])


def _pullback(x, w, metas, g, need_x: bool, need_w: bool):
    """``(dx, dw)`` of one chunk's ``_mm`` at cotangent ``g`` (``None``
    where not asked for)."""
    with torch.enable_grad():
        xx = x.detach().requires_grad_(need_x)
        ww = w.detach().requires_grad_(need_w)
        wrt = [t for t, need in ((xx, need_x), (ww, need_w)) if need]
        grads = iter(torch.autograd.grad(_mm(xx, ww, metas), wrt, g))
    return (next(grads) if need_x else None,
            next(grads) if need_w else None)


def _hop(x, axis, forward: bool):
    """Start one ring hop of ``x``: toward rank + 1 (``forward``) or rank
    - 1; returns ``(received, wait)``."""
    n = cc.axis_size(axis)
    step = 1 if forward else -1
    outs, wait = cc.ppermute_start([x], axis,
                                   [(i, (i + step) % n) for i in range(n)])
    return outs[0], wait


def _gather_ring(x, w, metas, axis):
    """Step ``t``: this rank holds chunk ``(r + t) % n`` and multiplies it
    while the next chunk travels."""
    n, r = cc.axis_size(axis), cc.axis_index(axis)
    parts = [None] * n
    cur = x
    for t in range(n):
        nxt, wait = _hop(cur, axis, False) if t < n - 1 else (None, None)
        parts[(r + t) % n] = _mm(cur, w, metas)
        if wait is not None:
            wait()
        cur = nxt
    return torch.cat(parts, dim=0)


def _scatter_ring(chunks, mm, axis):
    """The traveling accumulator: at step ``t`` this rank adds
    ``mm(chunks[d])`` for ``d = (r + n - 1 - t) % n``, the chunk whose
    home is ``n - 1 - t`` hops ahead; after the last step the sum over
    every rank's part of chunk ``r`` is here."""
    n, r = cc.axis_size(axis), cc.axis_index(axis)
    acc = None
    for t in range(n):
        d = (r + n - 1 - t) % n
        if acc is None:
            acc = mm(chunks[d])
            continue
        arrived, wait = _hop(acc, axis, True)
        part = mm(chunks[d])
        wait()
        acc = arrived + part
    return acc


class _GatherMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, axis, metas):
        ctx.save_for_backward(x, w)
        ctx.axis, ctx.metas = axis, metas
        return _gather_ring(x, w, metas, axis)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        axis, metas = ctx.axis, ctx.metas
        n, r = cc.axis_size(axis), cc.axis_index(axis)
        dyc = cc.ring_chunks(dy, n, 0)
        need_x, need_w = ctx.needs_input_grad[:2]
        dx = dw = None
        if need_x:
            # every sequence chunk's dx has a part from each rank's
            # weight shard: the matmul_scatter ring over dy's chunks
            dx = _scatter_ring(
                dyc, lambda g: _pullback(x, w, metas, g, True, False)[0],
                axis)
        if need_w:
            # re-rotate the saved activation: this rank's cotangent is
            # local, so its weight gradient needs no reduction
            cur = x
            for t in range(n):
                nxt, wait = _hop(cur, axis, False) if t < n - 1 \
                    else (None, None)
                part = _pullback(cur, w, metas, dyc[(r + t) % n], False,
                                 True)[1]
                dw = part if dw is None else dw + part
                if wait is not None:
                    wait()
                cur = nxt
        return dx, dw, None, None


class _MatmulScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, axis, metas):
        ctx.save_for_backward(x, w)
        ctx.axis, ctx.metas = axis, metas
        n = cc.axis_size(axis)
        return _scatter_ring(cc.ring_chunks(x, n, 0),
                             lambda xc: _mm(xc, w, metas), axis)

    @staticmethod
    def backward(ctx, dy):
        """One ring for both gradients: the cotangent shard rotates (the
        transposed all-gather) and each visiting chunk gives that sequence
        chunk's dx and this rank's part of dw."""
        x, w = ctx.saved_tensors
        axis, metas = ctx.axis, ctx.metas
        n, r = cc.axis_size(axis), cc.axis_index(axis)
        xc = cc.ring_chunks(x, n, 0)
        need_x, need_w = ctx.needs_input_grad[:2]
        dx_parts, dw = [None] * n, None
        cur = dy
        for t in range(n):
            c = (r + t) % n
            nxt, wait = _hop(cur, axis, False) if t < n - 1 else (None, None)
            dx_c, dw_c = _pullback(xc[c], w, metas, cur, need_x, need_w)
            dx_parts[c] = dx_c
            if need_w:
                dw = dw_c if dw is None else dw + dw_c
            if wait is not None:
                wait()
            cur = nxt
        dx = torch.cat(dx_parts, dim=0).reshape(x.shape) if need_x else None
        return dx, dw, None, None


def gather_matmul(x, w, axis: Optional[str] = TENSOR_AXIS, *,
                  fp8_metas=None):
    """``all_gather(x, dim=0) @ w.T`` with the gather pipelined under the
    partial GEMMs, and the transposed ring as its backward.

    ``x``: this rank's sequence shard ``[s_local, ..., in]``; ``w``: its
    weight shard ``[out_local, in]``.  Returns ``[s_local * tp, ...,
    out_local]``, the sequence-parallel column linear's forward.
    ``fp8_metas`` (``{"x", "w"}`` Fp8Meta) routes each partial GEMM through
    the fp8 one; per-tensor scales commute with the chunking.  One local
    GEMM when ``axis`` is ``None`` or of one rank."""
    if axis is None or cc.bound_axis_size(axis) == 1:
        return _mm(x, w, fp8_metas)
    return _GatherMatmul.apply(x, w, axis, fp8_metas)


def matmul_scatter(x, w, axis: Optional[str] = TENSOR_AXIS, *,
                   fp8_metas=None):
    """``reduce_scatter(x @ w.T, dim=0)`` with the scatter pipelined as
    traveling partial sums, and the transposed ring as its backward.

    ``x``: the whole sequence of this rank's input slice ``[s_local * tp,
    ..., in_local]``; ``w``: ``[out, in_local]``.  Returns this rank's
    sequence shard ``[s_local, ..., out]`` of the sum, the
    sequence-parallel row linear's forward before its bias.  One local GEMM
    when ``axis`` is ``None`` or of one rank."""
    if axis is None or cc.bound_axis_size(axis) == 1:
        return _mm(x, w, fp8_metas)
    return _MatmulScatter.apply(x, w, axis, fp8_metas)
