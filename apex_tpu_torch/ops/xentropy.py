"""Fused softmax cross entropy with label smoothing (port of
:mod:`apex_tpu.ops.xentropy`).

Per row: ``loss = (lse - sum(logits) / C) * smoothing - log_prob[label] *
(1 - smoothing)``, zero where ``label == padding_idx``.  Labels outside
``[0, C)`` follow the JAX package: a padding row gives loss and gradient 0
whatever its label; otherwise a label in ``[-C, -1]`` counts from the end
in the loss, one outside ``[-C, C)`` gives a NaN loss, and neither adds the
one-hot term to the gradient.  The autograd
Function saves only the logits, one lse per row and the labels, and
recomputes ``exp(logit - lse)`` in the backward, so activation memory is
O(rows) beyond the logits themselves.  All math is fp32 whatever the
logits' dtype; ``half_to_float=True`` returns fp32 losses from half
logits, and the logits' gradient comes back in their own dtype.  Plain
torch ops: the JAX package has no Pallas kernel here.
"""

from __future__ import annotations

import torch

__all__ = ["softmax_cross_entropy_loss", "SoftmaxCrossEntropyLoss"]


def _gather_labels(x32, labels):
    """``x32[..., label]`` with the JAX package's ``take_along_axis``
    rules: a label in ``[-C, -1]`` counts from the end, one outside
    ``[-C, C)`` gives NaN (a padding row's NaN is zeroed afterwards)."""
    C = x32.shape[-1]
    idx = labels.long()
    idx = torch.where(idx < 0, idx + C, idx)
    inside = (idx >= 0) & (idx < C)
    got = x32.gather(-1, idx.clamp(0, C - 1)[..., None])[..., 0]
    return torch.where(inside, got, float("nan"))


def _fwd_math(logits, labels, smoothing, padding_idx):
    x32 = logits.float()
    m = x32.amax(dim=-1)
    lse = m + torch.log(torch.exp(x32 - m[..., None]).sum(dim=-1))
    label_logit = _gather_labels(x32, labels)
    log_prob = label_logit - lse
    loss = -log_prob * (1.0 - smoothing)
    if smoothing:
        loss = loss + (lse - x32.sum(dim=-1) / x32.shape[-1]) * smoothing
    return torch.where(labels == padding_idx, 0.0, loss), lse


class SoftmaxCrossEntropyLoss(torch.autograd.Function):
    """``apex.contrib.xentropy.SoftmaxCrossEntropyLoss`` semantics."""

    @staticmethod
    def forward(ctx, logits, labels, smoothing=0.0, padding_idx=0,
                half_to_float=False):
        loss, lse = _fwd_math(logits, labels, smoothing, padding_idx)
        ctx.save_for_backward(logits, lse, labels)
        ctx.smoothing = smoothing
        ctx.padding_idx = padding_idx
        if half_to_float or logits.dtype == torch.float32:
            return loss
        return loss.to(logits.dtype)

    @staticmethod
    def backward(ctx, dloss):
        logits, lse, labels = ctx.saved_tensors
        smoothing = ctx.smoothing
        C = logits.shape[-1]
        g = torch.exp(logits.float() - lse[..., None])
        # the one-hot term only for a label in [0, C), as jax.nn.one_hot
        idx = labels.long()[..., None]
        hot = torch.where((idx >= 0) & (idx < C), -(1.0 - smoothing), 0.0)
        g.scatter_add_(-1, idx.clamp(0, C - 1), hot.to(g.dtype))
        if smoothing:
            g = g - smoothing / C
        d32 = torch.where(labels == ctx.padding_idx, 0.0, dloss.float())
        return (g.mul_(d32[..., None])).to(logits.dtype), None, None, None, None


def softmax_cross_entropy_loss(logits, labels, smoothing: float = 0.0,
                               padding_idx: int = 0,
                               half_to_float: bool = False):
    """Per-row smoothed CE losses of shape ``labels.shape`` from
    ``logits [..., C]`` (any float dtype; math in fp32)."""
    return SoftmaxCrossEntropyLoss.apply(logits, labels, smoothing,
                                         padding_idx, half_to_float)
