"""Pipeline-parallel forward/backward schedules: the rotation schedule
(port of :mod:`apex_tpu.transformer.pipeline_parallel.schedules`).

The JAX package expresses the Megatron schedules as one program that
every pipeline rank runs: a loop over *ticks* in which each stage applies
its chunk's layers to the activation in its slot and the results rotate
one stage down the ``pp`` axis.  The port runs the same loop eagerly on
each rank of the ``pp`` group:

- stage parameters are stacked virtual-stage major, ``[pp * vpp, ...]``;
  chunk ``c`` of stage ``s`` is virtual stage ``c * pp + s``;
- microbatch ``j`` enters stage 0 at tick ``e_j = (j // pp) * pp * vpp +
  j % pp`` and leaves the last stage ``pp * vpp`` ticks later; stage ``s``
  applies chunk ``((t - s) // pp) % vpp`` at tick ``t``, and the rotation's
  wrap-around edge carries a microbatch from one chunk to the next (the
  interleaved schedule, whose bubble is ``1 / vpp`` of the plain one);
- the backward is autograd over the tick loop, the JAX package's
  transposed scan: each rotation is one :func:`~apex_tpu_torch.transformer.
  pipeline_parallel.p2p_communication.permute` of the tick's whole pytree,
  whose backward sends the gradients along the inverse pairs, and the
  ticks' backward runs in reverse tick order.

Every rank issues its collectives in the same order in the backward only
if every rank's autograd graph has the same shape.  So the schedule never
branches on the rank: a rank-dependent choice (stage 0's entries, the
last stage's exits, a shard's owner) is a ``torch.where`` on a 0-d flag,
and bubble slots compute on the carried state, as in the JAX package,
and are never read.

Where the gradients are summed over ``pp``: the inputs are the same on
every rank and only stage 0 reads them, so the entry is the identity with
the gradient summed over ``pp``; the outputs are the last stage's exits
summed over ``pp`` so that every rank holds them, and every rank computes
the same loss from them, so that sum's gradient passes unchanged (each
rank already holds the whole cotangent; summing it would count the loss
``pp`` times).  Callers must use the outputs the same way on every rank.

``remat`` recomputes each tick's stage call in the backward
(:func:`apex_tpu_torch.transformer.tensor_parallel.random.checkpoint`,
non-reentrant, putting the model-parallel generators back so dropout draws
its masks again); ``remat_ticks=G`` checkpoints groups of ``G`` ticks
whose only saved value is the rotation state entering the group, the
1F1B-class activation bound.  A recomputation re-issues the collectives
of what it recomputes; it is never cut short (checkpoint early stop is
off), so every rank recomputes the same calls.

The JAX package memoises the jitted program of the grouped path and warns
when a fresh ``stage_fn`` per call defeats that cache.  Eager PyTorch
compiles nothing, so that cache and its warning have no counterpart here.
"""

from __future__ import annotations

import functools
import operator
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import set_checkpoint_early_stop

from apex_tpu_torch.amp._tree import tree_flatten, tree_map
from apex_tpu_torch.parallel import collectives as cc
from apex_tpu_torch.parallel.mesh import PIPELINE_AXIS
from apex_tpu_torch.transformer.pipeline_parallel.p2p_communication import (
    permute,
)
from apex_tpu_torch.transformer.tensor_parallel import mappings
from apex_tpu_torch.transformer.tensor_parallel.random import checkpoint

__all__ = [
    "get_forward_backward_func",
    "forward_backward_no_pipelining",
    "forward_backward_pipelining_without_interleaving",
    "forward_backward_pipelining_with_interleaving",
    "pipeline_apply",
    "pipeline_bubble_fraction",
    "pipeline_total_ticks",
    "split_into_microbatches",
    "stack_stage_params",
]

StageFn = Callable[[Any, Any], Any]   # (stage_params, activation) -> activation
LossFn = Callable[[Any, Any], torch.Tensor]  # (output, target) -> scalar

# the regions over pp, by their forward and backward:
# identity forward, gradient summed (the entry)
_enter = mappings.copy_to_tensor_model_parallel_region
# summed forward, gradient as it is (the exit broadcast)
_leave = mappings.reduce_from_tensor_model_parallel_region


def _broadcast(x, axis):
    """Summed forward and summed gradient: a value that every rank then
    uses differently (the owner-masked one-row broadcasts)."""
    return _enter(_leave(x, axis), axis)


def split_into_microbatches(batch, num_microbatches: int):
    """Every leaf ``[m * b, ...] -> [m, b, ...]`` (a view)."""
    def split(leaf):
        if leaf.shape[0] % num_microbatches != 0:
            raise ValueError(
                f"batch dim {leaf.shape[0]} not divisible by "
                f"num_microbatches={num_microbatches}")
        return leaf.reshape((num_microbatches,
                             leaf.shape[0] // num_microbatches)
                            + tuple(leaf.shape[1:]))
    return tree_map(split, batch)


def stack_stage_params(per_stage_params: Sequence[Any]):
    """Stack per-virtual-stage parameter trees along a new leading dim:
    virtual stage ``v`` (chunk ``v // pp`` of stage ``v % pp``) is row
    ``v``, plain layer order."""
    return tree_map(lambda *ls: torch.stack(ls), per_stage_params[0],
                    *per_stage_params[1:])


def _entry_ticks(m: int, pp: int, vpp: int) -> np.ndarray:
    period = pp * vpp
    j = np.arange(m)
    return (j // pp) * period + (j % pp)


def _exit_schedule(total_ticks: int, period: int, pp: int, m: int):
    """Per tick ``(j_out, valid)``: tick ``t`` is microbatch ``j_out``'s
    exit from the last virtual stage iff ``u = t - (period - 1)`` is an
    entry tick; invalid ticks have ``j_out`` 0."""
    t = np.arange(total_ticks)
    u = t - (period - 1)
    ug, ur = u // period, u % period
    j_out = ug * pp + ur
    valid = (u >= 0) & (ur < pp) & (j_out < m)
    return np.where(valid, j_out, 0), valid


def pipeline_total_ticks(m: int, pp: int, vpp: int = 1) -> int:
    """Ticks per step on every rank: the last entry tick + ``pp * vpp``."""
    return int(_entry_ticks(m, pp, vpp)[-1]) + pp * vpp


def pipeline_bubble_fraction(m: int, pp: int, vpp: int = 1) -> float:
    """The share of ticks that are bubbles: ``1 - m * vpp / ticks``, which
    is 1F1B's ``(pp - 1) / (m + pp - 1)`` at ``vpp = 1``."""
    return 1.0 - (m * vpp) / pipeline_total_ticks(m, pp, vpp)


def _group_size(remat_ticks, period: int) -> Optional[int]:
    """``None``/``False`` off, ``True`` one period, else a positive int."""
    if remat_ticks is None or remat_ticks is False:
        return None
    if remat_ticks is True:
        return period
    size = operator.index(remat_ticks)
    if size < 1:
        raise ValueError(
            f"remat_ticks must be True or a positive group size, got "
            f"{remat_ticks!r} (use None/False to disable)")
    return size


def pipeline_apply(
    stage_fn: StageFn,
    stage_params,
    inputs,
    *,
    num_chunks: int = 1,
    axis: str = PIPELINE_AXIS,
    mesh=None,
    remat: bool = True,
    remat_ticks=None,
    params_already_local: bool = False,
    shard_microbatches: bool = False,
):
    """Run microbatched ``inputs`` through the rotation pipeline; every
    rank of the ``axis`` group calls it.

    ``stage_params``: a tree of tensors with leading dim ``pp *
    num_chunks`` (virtual-stage major), the same on every rank; or, with
    ``params_already_local``, this rank's ``[num_chunks, 1, ...]`` slice
    (rows ``c * pp + s``).  ``inputs``: a tree with leading microbatch dim
    ``m``, the same on every rank; each microbatch's structure and shapes
    must be ``stage_fn``'s output's.  Returns the last virtual stage's
    outputs ``[m, ...]`` on every rank.  Differentiable: the backward
    pipeline is autograd over the ticks (module docstring).

    ``mesh``: the grid (default: the one initialised; without one the
    pipeline is one stage); only its size along ``axis`` is read.

    ``remat_ticks``: checkpoint groups of this many ticks (``True``: one
    period, ``pp * num_chunks``); the backward then keeps one rotation
    state per group, for one more forward of recompute.

    ``shard_microbatches``: each rank holds ``m / pp`` microbatches (rows
    ``[s * m/pp, (s + 1) * m/pp)``) instead of all of them; each entry row
    comes from its owner by an owner-masked all-reduce at its tick, and
    each exit row goes to its owner the same way; the outputs are
    gathered once at the end.  Requires ``m % pp == 0``.  With
    ``params_already_local`` the inputs are then this rank's rows; else
    the full ``[m, ...]``, of which the rank takes its own.
    """
    pp = mesh.shape[axis] if mesh is not None else cc.bound_axis_size(axis)
    s = cc.axis_index(axis) if pp > 1 else 0
    vpp = num_chunks
    period = pp * vpp
    group_size = _group_size(remat_ticks, period)

    leaves, _ = tree_flatten(inputs)
    if not leaves:
        raise ValueError("inputs pytree is empty")
    m = leaves[0].shape[0]
    if shard_microbatches and params_already_local:
        m = m * pp                      # inputs are this rank's rows
    if shard_microbatches and m % pp != 0:
        raise ValueError(
            f"shard_microbatches requires num_microbatches ({m}) divisible "
            f"by pp ({pp})")
    total_ticks = pipeline_total_ticks(m, pp, vpp)
    j_out, valid = _exit_schedule(total_ticks, period, pp, m)
    shard_microbatches = shard_microbatches and pp > 1  # one rank owns all
    mpp = m // pp if shard_microbatches else m
    device = leaves[0].device
    flags = (torch.zeros((), dtype=torch.bool, device=device),
             torch.ones((), dtype=torch.bool, device=device))

    if params_already_local:
        local = tree_map(lambda l: l[:, 0], stage_params)
    else:
        local = tree_map(
            lambda l: l.reshape((vpp, pp) + tuple(l.shape[1:]))[:, s],
            stage_params)
    # each chunk's parameters cut from the stack once: the gradients of a
    # chunk's ticks add up in its view, and go back into the stack in one
    # copy (indexing the stack per tick would fill and add a gradient of
    # the whole stack at every tick)
    p_leaves, p_unflatten = tree_flatten(local)
    per_leaf = [l.unbind(0) for l in p_leaves]
    chunks = [p_unflatten([u[c] for u in per_leaf]) for c in range(vpp)]
    if shard_microbatches:
        x_mb = inputs if params_already_local else tree_map(
            lambda l: l[s * mpp:(s + 1) * mpp], inputs)
    else:
        x_mb = tree_map(lambda l: _enter(l, axis), inputs) if pp > 1 \
            else inputs
    fn = functools.partial(checkpoint, stage_fn) if remat else stage_fn
    ring = [(i, (i + 1) % pp) for i in range(pp)]

    def fetch_entry(j):
        if not shard_microbatches:
            return tree_map(lambda l: l[j], x_mb)
        owner = flags[s == j // mpp]
        row = min(max(j - s * mpp, 0), mpp - 1)
        return tree_map(
            lambda l: _broadcast(torch.where(owner, l[row],
                                             torch.zeros_like(l[row])),
                                 axis), x_mb)

    def rotate(state, t):
        """One tick: inject stage 0's entry, apply the chunk, shift.
        Returns ``(shifted state, y)``, ``y`` the stage's output before
        the shift (on the last stage, a microbatch's exit)."""
        grp, r = divmod(t, period)
        j = min(max(grp * pp + r, 0), m - 1)
        is_entry = flags[s == 0 and r < pp]
        x_in = tree_map(lambda e, c_: torch.where(is_entry, e, c_),
                        fetch_entry(j), state)
        c = ((t - s) // pp) % vpp
        y = fn(chunks[c], x_in)
        return (permute(y, axis, ring) if pp > 1 else y), y

    def run_ticks(ticks, state):
        """The ticks in order; the new state and the outputs of the ticks
        that are exits (the same ticks on every rank)."""
        exits = []
        for t in ticks:
            state, y = rotate(state, t)
            if valid[t]:
                exits.append(y)
        return state, exits

    state = tree_map(lambda l: torch.zeros_like(l[0]), x_mb)
    with set_checkpoint_early_stop(False):
        if group_size is None:
            state, exits = run_ticks(range(total_ticks), state)
        else:
            exits = []
            for start in range(0, total_ticks, group_size):
                ticks = range(start, min(start + group_size, total_ticks))
                state, ys = checkpoint(
                    functools.partial(run_ticks, ticks), state)
                exits += ys
    exit_ticks = [t for t in range(total_ticks) if valid[t]]
    last = flags[s == pp - 1]

    if not shard_microbatches:
        # each microbatch exits once: the last stage's row, zeros elsewhere
        rows = [None] * m
        for t, y in zip(exit_ticks, exits):
            rows[j_out[t]] = tree_map(
                lambda yl: torch.where(last, yl, torch.zeros_like(yl)), y)
        outs = tree_map(lambda *rs: torch.stack(rs), rows[0], *rows[1:])
        return tree_map(lambda l: _leave(l, axis), outs) if pp > 1 else outs

    # owner-masked writes into this rank's rows: one chain per leaf, the
    # same shape on every rank
    outbuf = tree_map(lambda l: torch.zeros_like(l), x_mb)
    for t, y in zip(exit_ticks, exits):
        jo = int(j_out[t])
        own = flags[jo // mpp == s]
        row = min(max(jo - s * mpp, 0), mpp - 1)
        y_all = tree_map(
            lambda yl: torch.where(last, yl, torch.zeros_like(yl)), y)
        y_all = tree_map(lambda yl: _broadcast(yl, axis), y_all)
        outbuf = tree_map(
            lambda buf, yl: torch.where(
                own, buf.index_copy(0, torch.tensor([row], device=device),
                                    yl[None]), buf),
            outbuf, y_all)
    return tree_map(
        lambda l: mappings.gather_from_sequence_parallel_region(l, axis,
                                                                False),
        outbuf)


def forward_backward_no_pipelining(
    stage_fn: StageFn,
    loss_fn: LossFn,
    stage_params,
    inputs,
    targets,
    *,
    loss_scale=None,
    remat: bool = False,
    **_unused,
):
    """Microbatched gradient accumulation without pipelining: each
    microbatch's forward and backward in turn, the gradients summed.

    ``stage_fn(params, input) -> output``, ``loss_fn(output, target) ->
    scalar``; ``inputs``/``targets`` have the leading microbatch dim ``m``.
    Returns ``(losses [m], summed gradients)`` (the gradients of ``loss *
    loss_scale`` with ``loss_scale``); fold any ``1/m`` into ``loss_fn``.
    """
    leaves, unflatten = tree_flatten(stage_params)
    ps = [l.detach().requires_grad_(True) for l in leaves]
    params = unflatten(ps)
    fn = functools.partial(checkpoint, stage_fn) if remat else stage_fn
    m = tree_flatten(inputs)[0][0].shape[0]
    acc = [torch.zeros_like(p) for p in ps]
    losses = []
    for i in range(m):
        pick = lambda l: l[i]   # noqa: E731
        loss = loss_fn(fn(params, tree_map(pick, inputs)),
                       tree_map(pick, targets))
        scaled = loss if loss_scale is None else loss * loss_scale
        grads = torch.autograd.grad(scaled, ps, allow_unused=True)
        acc = [a if g is None else a + g for a, g in zip(acc, grads)]
        losses.append(loss.detach())
    return torch.stack(losses), unflatten(acc)


def _pipelined_fwd_bwd(stage_fn, loss_fn, stage_params, inputs, targets, *,
                       num_chunks, axis, mesh, loss_scale, remat,
                       remat_ticks=None):
    """The losses and the gradient of the whole ``[pp * vpp, ...]`` stack
    on every rank: each rank's rows, summed over ``pp``."""
    leaves, unflatten = tree_flatten(stage_params)
    ps = [l.detach().requires_grad_(True) for l in leaves]
    outs = pipeline_apply(stage_fn, unflatten(ps), inputs,
                          num_chunks=num_chunks, axis=axis, mesh=mesh,
                          remat=remat, remat_ticks=remat_ticks)
    m = tree_flatten(inputs)[0][0].shape[0]
    losses = torch.stack([
        loss_fn(tree_map(lambda l: l[i], outs),
                tree_map(lambda l: l[i], targets)) for i in range(m)])
    total = losses.sum()
    if loss_scale is not None:
        total = total * loss_scale
    grads = torch.autograd.grad(total, ps, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(ps, grads)]
    pp = mesh.shape[axis] if mesh is not None else cc.bound_axis_size(axis)
    if pp > 1:
        grads = [cc.all_reduce(g, axis) for g in grads]
    return losses.detach(), unflatten(grads)


def forward_backward_pipelining_without_interleaving(
    stage_fn: StageFn,
    loss_fn: LossFn,
    stage_params,
    inputs,
    targets,
    *,
    axis: str = PIPELINE_AXIS,
    mesh=None,
    loss_scale=None,
    remat: bool = True,
    remat_ticks=None,
    **_unused,
):
    """The 1F1B-equivalent schedule (the rotation at one chunk).  Returns
    ``(losses [m], gradients)``, the gradients summed over microbatches,
    of the whole stack, on every rank."""
    return _pipelined_fwd_bwd(
        stage_fn, loss_fn, stage_params, inputs, targets,
        num_chunks=1, axis=axis, mesh=mesh, loss_scale=loss_scale,
        remat=remat, remat_ticks=remat_ticks)


def forward_backward_pipelining_with_interleaving(
    stage_fn: StageFn,
    loss_fn: LossFn,
    stage_params,
    inputs,
    targets,
    *,
    num_chunks: int,
    axis: str = PIPELINE_AXIS,
    mesh=None,
    loss_scale=None,
    remat: bool = True,
    remat_ticks=None,
    **_unused,
):
    """The interleaved virtual-pipeline schedule: ``stage_params``' leading
    dim is ``pp * num_chunks`` in layer order, chunk ``c`` of stage ``s``
    at row ``c * pp + s``."""
    if num_chunks < 2:
        raise ValueError(
            "interleaved schedule requires num_chunks >= 2 (use "
            "forward_backward_pipelining_without_interleaving)")
    return _pipelined_fwd_bwd(
        stage_fn, loss_fn, stage_params, inputs, targets,
        num_chunks=num_chunks, axis=axis, mesh=mesh, loss_scale=loss_scale,
        remat=remat, remat_ticks=remat_ticks)


def get_forward_backward_func(
    virtual_pipeline_model_parallel_size: Optional[int] = None,
    pipeline_model_parallel_size: int = 1,
):
    """The schedule for the grid: interleaved with a virtual size at pp >
    1, 1F1B at pp > 1, else no pipelining."""
    if pipeline_model_parallel_size > 1:
        if virtual_pipeline_model_parallel_size is not None:
            return functools.partial(
                forward_backward_pipelining_with_interleaving,
                num_chunks=virtual_pipeline_model_parallel_size)
        return forward_backward_pipelining_without_interleaving
    return forward_backward_no_pipelining
