"""Stage-to-stage transfers (port of
:mod:`apex_tpu.transformer.pipeline_parallel.p2p_communication`).

The JAX package's wrappers are collective permutes that every pipeline
rank calls: "send" means this rank's payload moves to its neighbour,
"recv" is what arrives here.  The port keeps that meaning over
``torch.distributed``: every rank of the ``axis`` group calls the same
wrapper with a payload of the same structure, an edge rank receives zeros,
and ``ring=True`` wraps the last rank round to the first (the rotation
schedule's circular transfer).  Payloads are pytrees (dicts, lists,
tuples, NamedTuples) of tensors, moved in one ``batch_isend_irecv``.

:func:`permute` is differentiable, as ``lax.ppermute`` is under
``jax.grad``: one :class:`torch.autograd.Function` moves every leaf, and
its backward moves the floating-point leaves' gradients along the inverse
pairs, in one call again.  Integer leaves (segment ids riding beside
activations) travel too and take no gradient.  Every rank of the group
issues the backward call at the same point of its backward pass only if
the ranks' graphs match: callers keep them the same (the rotation
schedule computes its bubble slots rather than skipping them).
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple

import torch

from apex_tpu_torch.amp._tree import tree_flatten
from apex_tpu_torch.parallel import collectives as cc
from apex_tpu_torch.parallel.mesh import PIPELINE_AXIS

__all__ = [
    "permute",
    "recv_forward",
    "recv_backward",
    "send_forward",
    "send_backward",
    "send_forward_recv_backward",
    "send_backward_recv_forward",
    "send_forward_recv_forward",
    "send_backward_recv_backward",
    "send_forward_backward_recv_forward_backward",
]


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, perm, *xs):
        ctx.axis = axis
        ctx.inverse = [(d, s) for s, d in perm]
        ctx.float_leaves = [i for i, x in enumerate(xs)
                            if x.is_floating_point()]
        outs = cc.ppermute_many(xs, axis, perm)
        ctx.mark_non_differentiable(*(o for o in outs
                                      if not o.is_floating_point()))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        idx = ctx.float_leaves
        moved = cc.ppermute_many([grads[i] for i in idx], ctx.axis,
                                 ctx.inverse) if idx else []
        out = [None] * len(grads)
        for i, g in zip(idx, moved):
            out[i] = g
        return (None, None, *out)


def permute(tree: Any, axis: str, perm: Sequence[Tuple[int, int]]):
    """Every leaf of ``tree`` moved along the ``(source, destination)``
    pairs of group ranks of ``axis`` (zeros where nothing arrives), in one
    batched call; differentiable, the gradients moving back along the
    inverse pairs."""
    leaves, unflatten = tree_flatten(tree)
    if not leaves:
        return tree
    return unflatten(list(_Permute.apply(axis, list(perm), *leaves)))


def _perm_next(n: int, ring: bool):
    pairs = [(i, i + 1) for i in range(n - 1)]
    if ring:
        pairs.append((n - 1, 0))
    return pairs


def _perm_prev(n: int, ring: bool):
    pairs = [(i + 1, i) for i in range(n - 1)]
    if ring:
        pairs.append((0, n - 1))
    return pairs


def _shift(tree: Any, axis: str, forward: bool, ring: bool):
    n = cc.axis_size(axis)
    return permute(tree, axis,
                   _perm_next(n, ring) if forward else _perm_prev(n, ring))


def send_forward_recv_forward(output_tensor, axis: str = PIPELINE_AXIS,
                              *, ring: bool = False):
    """Ship activations one stage down; return what arrived from upstream.
    The first stage receives zeros unless ``ring``."""
    return _shift(output_tensor, axis, forward=True, ring=ring)


def send_backward_recv_backward(input_tensor_grad, axis: str = PIPELINE_AXIS,
                                *, ring: bool = False):
    """Ship gradients one stage up; return what arrived from downstream.
    The last stage receives zeros unless ``ring``."""
    return _shift(input_tensor_grad, axis, forward=False, ring=ring)


# The remaining wrappers are the same two shifts; they keep the
# reference's names so ported schedule code reads one to one.

def recv_forward(output_tensor, axis: str = PIPELINE_AXIS, *,
                 ring: bool = False):
    """Receive the upstream stage's activations; every rank contributes
    its payload, as in :func:`send_forward_recv_forward`."""
    return send_forward_recv_forward(output_tensor, axis, ring=ring)


def recv_backward(input_tensor_grad, axis: str = PIPELINE_AXIS, *,
                  ring: bool = False):
    """Receive the downstream stage's gradient."""
    return send_backward_recv_backward(input_tensor_grad, axis, ring=ring)


def send_forward(output_tensor, axis: str = PIPELINE_AXIS, *,
                 ring: bool = False):
    """Returns the activation received (the first stage discards it; the
    reference has None there)."""
    return send_forward_recv_forward(output_tensor, axis, ring=ring)


def send_backward(input_tensor_grad, axis: str = PIPELINE_AXIS, *,
                  ring: bool = False):
    return send_backward_recv_backward(input_tensor_grad, axis, ring=ring)


def send_forward_recv_backward(output_tensor, input_tensor_grad,
                               axis: str = PIPELINE_AXIS, *,
                               ring: bool = False):
    """The steady-state 1F1B pair: activations go down while gradients
    come up.  Returns ``(received activations, received gradients)``."""
    recv_grad = _shift(input_tensor_grad, axis, forward=False, ring=ring)
    shift_out = _shift(output_tensor, axis, forward=True, ring=ring)
    return shift_out, recv_grad


def send_backward_recv_forward(input_tensor_grad, output_tensor,
                               axis: str = PIPELINE_AXIS, *,
                               ring: bool = False):
    """Returns ``(received gradients, received activations)``."""
    recv_act = _shift(output_tensor, axis, forward=True, ring=ring)
    shift_grad = _shift(input_tensor_grad, axis, forward=False, ring=ring)
    return shift_grad, recv_act


def send_forward_backward_recv_forward_backward(
        output_tensor, input_tensor_grad, axis: str = PIPELINE_AXIS, *,
        ring: bool = False):
    """Both directions at once."""
    return (_shift(output_tensor, axis, forward=True, ring=ring),
            _shift(input_tensor_grad, axis, forward=False, ring=ring))
