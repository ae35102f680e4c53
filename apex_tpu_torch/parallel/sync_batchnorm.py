"""SyncBatchNorm: batch normalization with its statistics summed over the
data-parallel ranks (port of :mod:`apex_tpu.parallel.sync_batchnorm`).

The statistics are the reference's: per channel, fp32 ``sum(x)``,
``sum(x**2)`` and the count, summed over the ranks of ``axis_name`` (one
all-reduce of the three together), then ``mean = sum / count`` and the
biased ``var = sum_sq / count - mean**2``.  Normalization uses the biased
variance; the running statistics take the unbiased one,
``var * count / max(count - 1, 1)``, with Apex's momentum, which weights
the new value: ``running = running * (1 - momentum) + momentum * new``.

``torch.distributed.all_reduce`` is not differentiable.  The reference
gets the backward's all-reduce of the statistics' gradients (Apex's
``sum_dy`` / ``sum_dy_xmu``) from autodiff through ``psum``, whose
transpose is ``psum``; here the sum is a ``torch.autograd.Function``
whose backward all-reduces the incoming gradient over the same group, so
each rank's parameter gradients carry every rank's share and a
data-parallel average of them is the gradient of the mean loss.

Layout: the channel is dim 1 (``N, C, ...``); a 4-D activation in
``torch.channels_last`` memory is the reference's NHWC.  ``z`` is a
residual added after the affine transform and before the optional fused
ReLU (``fuse_relu``); the output has ``x``'s dtype.  ``axis_name=None``,
or no rank grid set up, is local batch normalization;
``axis_index_groups`` sums within sub-groups of the axis, as JAX's
collectives take them.  ``track_running_stats=False`` always normalizes
with the batch's statistics.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.parallel import collectives as cc
from apex_tpu_torch.parallel import mesh as mesh_lib

__all__ = ["SyncBatchNorm", "sync_batch_norm_stats"]


class _AllReduceSum(torch.autograd.Function):
    """The sum over a process group, forward and backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        cc.CALLS["all_reduce"] += 1
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        cc.CALLS["all_reduce"] += 1
        return grad, None


def sync_batch_norm_stats(x: torch.Tensor, reduce_axes: Tuple[int, ...],
                          axis_name=None, axis_index_groups=None):
    """``(mean, biased_var, count)`` in fp32 over ``reduce_axes`` of ``x``
    and, when ``axis_name`` names an axis of the rank grid, over its ranks
    (differentiably: the backward sums the gradients over them too)."""
    x32 = x.float()
    local = 1
    for a in reduce_axes:
        local *= x.shape[a]
    s = x32.sum(dim=reduce_axes)
    sq = x32.square().sum(dim=reduce_axes)
    count = torch.full((1,), float(local), device=x.device)
    if axis_name is not None and mesh_lib.model_parallel_is_initialized():
        group = mesh_lib.get_subgroup(axis_name, axis_index_groups)
        n = s.numel()
        summed = _AllReduceSum.apply(torch.cat([s, sq, count]), group)
        s, sq, count = summed[:n], summed[n:2 * n], summed[2 * n:]
    count = count.reshape(())
    mean = s / count
    var_biased = sq / count - mean.square()
    return mean, var_biased, count


class SyncBatchNorm(nn.Module):
    """Batch normalization over the batch and spatial dims, synchronized
    over ``axis_name``'s ranks (Apex's ``SyncBatchNorm`` surface).
    Parameters ``scale`` and ``bias`` (``param_dtype``), buffers
    ``running_mean`` and ``running_var`` (fp32), as the Flax module's,
    on ``device``: the card unless the caller names another (``"cpu"``).

    ``forward(x, z=None, use_running_average=None)``: with
    ``use_running_average`` (default: ``not self.training``) and
    ``track_running_stats`` the running statistics normalize; otherwise
    the batch's do and update the running ones."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 track_running_stats: bool = True,
                 axis_name: Optional[str | Sequence[str]] = None,
                 axis_index_groups=None, fuse_relu: bool = False,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        self.track_running_stats = track_running_stats
        self.axis_name = axis_name
        self.axis_index_groups = axis_index_groups
        self.fuse_relu = fuse_relu
        if affine:
            self.scale = nn.Parameter(torch.ones(
                num_features, dtype=param_dtype, device=device))
            self.bias = nn.Parameter(torch.zeros(
                num_features, dtype=param_dtype, device=device))
        self.register_buffer("running_mean", torch.zeros(
            num_features, dtype=torch.float32, device=device))
        self.register_buffer("running_var", torch.ones(
            num_features, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor, z: Optional[torch.Tensor] = None,
                use_running_average: Optional[bool] = None) -> torch.Tensor:
        C = self.num_features
        if x.dim() < 2 or x.shape[1] != C:
            raise ValueError(f"SyncBatchNorm takes the channel as dim 1; "
                             f"got shape {tuple(x.shape)} for "
                             f"num_features {C}")
        if use_running_average is None:
            use_running_average = not self.training
        view = (1, C) + (1,) * (x.dim() - 2)
        if use_running_average and self.track_running_stats:
            mean, var_biased = self.running_mean, self.running_var
        else:
            reduce_axes = (0,) + tuple(range(2, x.dim()))
            mean, var_biased, count = sync_batch_norm_stats(
                x, reduce_axes, self.axis_name, self.axis_index_groups)
            if self.track_running_stats:
                with torch.no_grad():
                    unbiased = var_biased * count / torch.clamp(
                        count - 1.0, min=1.0)
                    m = self.momentum
                    self.running_mean.copy_(
                        self.running_mean * (1.0 - m) + m * mean)
                    self.running_var.copy_(
                        self.running_var * (1.0 - m) + m * unbiased)
        inv_std = torch.rsqrt(var_biased + self.eps)
        y = (x.float() - mean.reshape(view)) * inv_std.reshape(view)
        if self.affine:
            y = y * self.scale.reshape(view) + self.bias.reshape(view)
        if z is not None:
            y = y + z.float()
        if self.fuse_relu:
            y = torch.relu(y)
        return y.to(x.dtype)
