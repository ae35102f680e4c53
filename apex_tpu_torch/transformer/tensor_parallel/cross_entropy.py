"""Cross entropy over vocabulary-sharded logits (port of
:mod:`apex_tpu.transformer.tensor_parallel.cross_entropy`).

Each rank holds ``logits [..., V/tp]``, its contiguous range of the
vocabulary, and the full-vocabulary softmax is never formed.  Two
all-reduces over ``axis`` assemble its statistics: the MAX of the row
maxima, then one SUM of three per-row values packed together (the sum of
``exp(logit - max)``, the target's logit, picked on the rank whose range
holds it and 0 elsewhere, and the sum of the logits for smoothing).  All
arithmetic is fp32 whatever the logits' dtype.

With ``label_smoothing = s`` the loss is that of the reference,
``(1 - s') * nll + s' * (lse - mean(logits))`` with
``s' = s * V / (V - 1)`` over the global vocabulary ``V``, which is
:func:`apex_tpu_torch.ops.xentropy.softmax_cross_entropy_loss` at
smoothing ``s'``; the sums run in the same order as there, so at one
rank the two agree bit for bit.

The backward is written out, as NVIDIA Apex's is (``softmax - (1 - s')
onehot - s' / V`` on the rank's vocabulary slice, times the loss's
gradient): the forward keeps only the logits, one fp32 log-sum-exp per
row and the target's place, and recomputes the softmax.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.parallel import collectives as cc
from apex_tpu_torch.parallel.mesh import TENSOR_AXIS
from apex_tpu_torch.transformer.tensor_parallel.utils import VocabUtility

__all__ = ["vocab_parallel_cross_entropy"]


class _VocabParallelCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, target, axis, label_smoothing):
        x32 = logits.float()
        v_local = x32.shape[-1]
        world, rank = ((1, 0) if axis is None
                       else (cc.axis_size(axis), cc.axis_index(axis)))
        v_global = v_local * world
        m = x32.amax(dim=-1)
        if axis is not None:
            m = cc.all_reduce(m, axis, "max")
        start, _ = VocabUtility.vocab_range_from_per_partition_vocab_size(
            v_local, rank)
        local_t = target.long() - start
        in_range = (local_t >= 0) & (local_t < v_local)
        safe_t = torch.where(in_range, local_t, 0)
        picked = torch.where(in_range, x32.gather(-1, safe_t[..., None])[..., 0],
                             0.0)
        sums = torch.stack([torch.exp(x32 - m[..., None]).sum(dim=-1),
                            picked, x32.sum(dim=-1)])
        if axis is not None:
            sums = cc.all_reduce(sums, axis)
        sum_exp, target_logit, sum_logits = sums
        lse = m + torch.log(sum_exp)
        s = 0.0
        if label_smoothing > 0:
            s = label_smoothing * v_global / (v_global - 1)
        loss = -(target_logit - lse) * (1.0 - s)
        if s:
            loss = loss + (lse - sum_logits / v_global) * s
        ctx.save_for_backward(logits, lse, safe_t, in_range)
        ctx.smoothing, ctx.v_global = s, v_global
        return loss

    @staticmethod
    def backward(ctx, dloss):
        logits, lse, safe_t, in_range = ctx.saved_tensors
        s = ctx.smoothing
        g = torch.exp(logits.float() - lse[..., None])
        hot = torch.where(in_range, -(1.0 - s), 0.0)[..., None]
        g.scatter_add_(-1, safe_t[..., None], hot.to(g.dtype))
        if s:
            g = g - s / ctx.v_global
        return g.mul_(dloss.float()[..., None]).to(logits.dtype), None, None, \
            None


def vocab_parallel_cross_entropy(logits, target,
                                 axis: Optional[str] = TENSOR_AXIS,
                                 label_smoothing: float = 0.0):
    """Per-token losses (fp32, ``logits.shape[:-1]``) from this rank's
    vocabulary shard ``logits [..., V/tp]`` and the global token ids
    ``target``; ``axis=None`` is the unsharded case."""
    return _VocabParallelCrossEntropy.apply(logits, target, axis,
                                            label_smoothing)
