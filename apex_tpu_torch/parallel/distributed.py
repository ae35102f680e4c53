"""Data parallelism over the ``(dcn, dp)`` axes (port of
:mod:`apex_tpu.parallel.distributed`).

Each rank runs its own slice of the global batch (:func:`dp_shard_batch`)
through the same weights; after the backward the gradients are summed
over the data-parallel ranks and, by default, averaged.  The reference
gets that sum from the sharding of the batch; here it is an explicit
call, :func:`all_reduce_gradients`, with the reference's arithmetic
(an fp32 upcast for the reduction, a pre-division before the sum and a
post-division after it).  :class:`DistributedDataParallel` wraps a
module with those knobs and reduces its ``.grad`` after the backward in
one flat all-reduce per gradient dtype; it issues them at every group
size, one rank included.

Not ported yet: the ZeRO pair ``zero_init`` /
``zero_data_parallel_train_step`` (ROADMAP.md, section A.4).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from apex_tpu_torch.parallel import collectives as cc
from apex_tpu_torch.parallel import mesh as mesh_lib

__all__ = [
    "all_reduce_gradients",
    "DistributedDataParallel",
    "data_parallel_train_step",
    "grad_accumulation",
    "dp_shard_batch",
    "host_dp_ranks",
    "replicate",
]

DP_AXES = (mesh_lib.DCN_AXIS, mesh_lib.DATA_AXIS)


def _map(tree, fn):
    if isinstance(tree, Mapping):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_map(v, fn) for v in tree)
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map(v, fn) for v in tree))
    return fn(tree)


def _leaves(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _map(tree, out.append)
    return out


def _reduce_flat(tensors: List[torch.Tensor], axis, gradient_average: bool,
                 gradient_predivide_factor: float,
                 allreduce_always_fp32: bool) -> List[torch.Tensor]:
    """The reduced gradients, as views of one flat buffer per dtype (fp32
    with ``allreduce_always_fp32``), each reduced by one in-place
    all-reduce.  A division by exactly 1 is left out: it changes no
    bit."""
    world = cc.axis_size(axis)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    buckets: Dict[Tuple[torch.dtype, torch.device], List[int]] = {}
    for i, g in enumerate(tensors):
        dt = torch.float32 if allreduce_always_fp32 else g.dtype
        buckets.setdefault((dt, g.device), []).append(i)
    for (dt, _), idx in buckets.items():
        flat = torch.cat([tensors[i].detach().reshape(-1).to(dt) for i in idx])
        if gradient_predivide_factor != 1.0:
            flat.div_(gradient_predivide_factor)
        cc.all_reduce_(flat, axis, "sum")
        # gradient_average=False leaves the sum divided by the predivide
        # factor, as the reference's allreduce_bucket does
        post = world / gradient_predivide_factor
        if gradient_average and post != 1.0:
            flat.div_(post)
        start = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[start:start + n].view_as(tensors[i])
            start += n
    return out


def _copy_back(grads: List[torch.Tensor], reduced: List[torch.Tensor]):
    """Write each reduced gradient into its ``.grad``: one multi-tensor
    copy where the dtypes agree."""
    same = [i for i, (g, r) in enumerate(zip(grads, reduced))
            if g.dtype == r.dtype]
    if same:
        torch._foreach_copy_([grads[i] for i in same],
                             [reduced[i] for i in same])
    for i in set(range(len(grads))) - set(same):
        grads[i].copy_(reduced[i])


def all_reduce_gradients(grads, axis=mesh_lib.DATA_AXIS, *,
                         gradient_average: bool = True,
                         gradient_predivide_factor: float = 1.0,
                         allreduce_always_fp32: bool = False):
    """The gradient tree (nested dicts, lists or named tuples of tensors)
    summed over ``axis``: each leaf divided by
    ``gradient_predivide_factor`` before the sum and, with
    ``gradient_average``, by ``world / gradient_predivide_factor`` after
    it; with ``allreduce_always_fp32`` the reduction runs in fp32 and the
    result is cast back.  Returns a new tree."""
    leaves = _leaves(grads)
    reduced = iter(_reduce_flat(leaves, axis, gradient_average,
                                gradient_predivide_factor,
                                allreduce_always_fp32))
    return _map(grads, lambda g: next(reduced).to(g.dtype))


def dp_shard_batch(batch, mesh=None, *, axis=DP_AXES):
    """This rank's contiguous slice of the global batch's leading dim,
    laid out over ``(dcn, dp)`` dcn-major as the reference's
    ``P(("dcn", "dp"))`` shards it; 0-d leaves (a mixup lambda) are
    every rank's.  ``mesh`` is accepted for the reference's signature."""
    del mesh
    n, i = cc.axis_size(axis), cc.axis_index(axis)

    def leaf(x):
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(x)
        if x.dim() == 0:
            return x
        if x.shape[0] % n:
            raise ValueError(f"batch dim {x.shape[0]} not divisible by the "
                             f"{n} data-parallel ranks")
        per = x.shape[0] // n
        return x[i * per:(i + 1) * per]

    return _map(batch, leaf)


def host_dp_ranks(mesh=None) -> List[int]:
    """The data-parallel shard indices this process holds: its own, one
    rank a process."""
    del mesh
    return [cc.axis_index(DP_AXES)]


@torch.no_grad()
def replicate(tree, mesh=None, *, axis=DP_AXES, root: int = 0):
    """Make ``tree`` the same on every data-parallel rank: each tensor (or
    each parameter and buffer of a module) takes the value of the group
    rank ``root``, in place.  Returns ``tree``."""
    del mesh
    tensors = (list(tree.parameters()) + list(tree.buffers())
               if isinstance(tree, nn.Module) else _leaves(tree))
    for t in tensors:
        t.copy_(cc.broadcast(t, axis, root))
    return tree


class DistributedDataParallel(nn.Module):
    """A module whose gradients are reduced over the data-parallel ranks.

    ``forward`` is the wrapped module's.  At construction every parameter
    and buffer takes data-parallel rank 0's value (:func:`replicate`).
    After the backward, :meth:`reduce_gradients` all-reduces the
    module's ``.grad`` in place, or a gradient tree it is given, with the
    reference's knobs over ``axis`` (by default ``("dcn", "dp")``)."""

    def __init__(self, module: nn.Module, *, gradient_average: bool = True,
                 gradient_predivide_factor: float = 1.0,
                 allreduce_always_fp32: bool = False, axis=DP_AXES):
        super().__init__()
        self.module = module
        self.gradient_average = gradient_average
        self.gradient_predivide_factor = gradient_predivide_factor
        self.allreduce_always_fp32 = allreduce_always_fp32
        self.axis = axis
        replicate(module, axis=axis)

    def forward(self, *args, **kwargs):
        return self.module(*args, **kwargs)

    def _knobs(self) -> dict:
        return dict(gradient_average=self.gradient_average,
                    gradient_predivide_factor=self.gradient_predivide_factor,
                    allreduce_always_fp32=self.allreduce_always_fp32)

    @torch.no_grad()
    def reduce_gradients(self, grads=None):
        """Reduce ``grads`` (returned as a new tree), or with ``None`` the
        ``.grad`` of every parameter that has one (written in place)."""
        if grads is not None:
            return all_reduce_gradients(grads, self.axis, **self._knobs())
        grads = [p.grad for p in self.module.parameters()
                 if p.grad is not None]
        _copy_back(grads, _reduce_flat(grads, self.axis,
                                       self.gradient_average,
                                       self.gradient_predivide_factor,
                                       self.allreduce_always_fp32))
        return None


def _microbatch(batch, i: int, n: int):
    """Slice ``i`` of ``n`` equal slices of every leaf's leading dim."""
    def leaf(x):
        if x.shape[0] % n:
            raise ValueError(f"batch dim {x.shape[0]} not divisible by "
                             f"microbatches={n}")
        per = x.shape[0] // n
        return x[i * per:(i + 1) * per]

    return batch if n == 1 else _map(batch, leaf)


def grad_accumulation(grad_fn: Callable, microbatches: int) -> Callable:
    """``grad_fn(params, batch) -> (loss, grads)`` over ``microbatches``
    equal slices of the batch's leading dim in turn: the losses and
    gradients summed in fp32 and divided by ``microbatches`` once at the
    end, with no collective per microbatch."""
    if microbatches == 1:
        return grad_fn

    def accum(params, batch):
        loss_sum, g_sum = None, None
        for i in range(microbatches):
            loss, grads = grad_fn(params, _microbatch(batch, i, microbatches))
            loss = loss.detach().float()
            grads = _map(grads, lambda g: g.detach().float())
            if g_sum is None:
                loss_sum, g_sum = loss, grads
            else:
                loss_sum = loss_sum + loss
                acc = iter(_leaves(grads))
                g_sum = _map(g_sum, lambda a: a + next(acc))
        inv = 1.0 / microbatches
        return loss_sum * inv, _map(g_sum, lambda g: g * inv)

    return accum


def data_parallel_train_step(loss_fn: Callable, optimizer, *, mesh=None,
                             microbatches: int = 1,
                             axis=DP_AXES) -> Callable:
    """A data-parallel training step: ``step(batch, lr=None) -> loss``.

    ``loss_fn(batch)`` is this rank's scalar loss on its batch slice (a
    closure over the model); ``optimizer`` steps the model's parameters.
    The step clears the gradients, runs the backward of each of
    ``microbatches`` equal slices (scaled by ``1 / microbatches``),
    averages the ``.grad`` of the optimizer's parameters over ``axis``,
    steps the optimizer (with ``lr=`` where given) and returns the loss
    averaged over ``axis``."""
    del mesh

    def step(batch, lr: Optional[float] = None):
        optimizer.zero_grad(set_to_none=True)
        n = microbatches
        total = None
        for i in range(n):
            loss = loss_fn(_microbatch(batch, i, n)) / n
            loss.backward()
            total = loss.detach() if total is None else total + loss.detach()
        grads = [p.grad for group in optimizer.param_groups
                 for p in group["params"] if p.grad is not None]
        _copy_back(grads, _reduce_flat(grads, axis, True, 1.0, False))
        if lr is None:
            optimizer.step()
        else:
            optimizer.step(lr=lr)
        return cc.all_reduce(total, axis, "mean")

    return step
