"""ZeRO-sharded LAMB (port of
:mod:`apex_tpu.contrib.optimizers.distributed_fused_lamb`, the
reference's ``apex/contrib/optimizers/distributed_fused_lamb.py``).

LAMB with the gradients reduce-scattered over the data-parallel ranks,
the state sharded, the global gradient norm clipped
(``max_grad_norm``), per-tensor trust ratios, and the stepped shards
all-gathered into the parameters, in the shapes of
:class:`~apex_tpu_torch.contrib.optimizers.DistributedFusedAdam`
(``flat_bucket``, ``n_buckets``, ``chunk``, ``outer_axis``,
``dcn_reduce_dtype``; ``step(lr=, grad_scale=, skip_update=)``,
:meth:`opt_state` / :meth:`load_opt_state`).

The two norm reductions of the reference's ``multi_tensor_l2norm`` plus
all-reduce are each a shard-local sum of squares and one all-reduce over
the scatter axes: the global norm from the gradient shards, and the
per-tensor norms of the fp32 parameters and of the updates as one
stacked vector of shard-local segmented sums (a bucket's rows of one
leaf are a contiguous run, so each sum is exact).  Per leaf, the shard
update is :func:`apex_tpu_torch.optimizers.fused_lamb.lamb_flat_update`
with that all-reduce as its ``reduce`` (``flat=True``), or the same two
stages tensor by tensor (``flat=False``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch.contrib.optimizers import _flat_bucket as fb
from apex_tpu_torch.contrib.optimizers.distributed_fused_adam import (
    ZeroOptimizer,
    reduce_scatter_leaf,
    unshard_leaf,
)
from apex_tpu_torch.optimizers._common import (
    advance_step,
    apply_skip,
    bias_correction,
)
from apex_tpu_torch.optimizers.fused_lamb import _trust_ratio, lamb_flat_update
from apex_tpu_torch.parallel import collectives as cc
from apex_tpu_torch.parallel.mesh import DATA_AXIS, DCN_AXIS
from apex_tpu_torch.utils.tree import _lengths_on

__all__ = ["DistributedFusedLAMB"]


def _lamb_stage1(p, g, m, v, *, clip, b1, b2, beta3, bc1, bc2, eps, wd,
                 adam_w_mode):
    """LAMB stage 1 (``multi_tensor_lamb.cu:41``) on fp32 tensors: the
    clipped gradient, the moments and the bias-corrected raw update.
    Returns new ``(update, m, v)``."""
    g = g / clip
    if wd != 0.0 and not adam_w_mode:
        g = g + wd * p                       # MODE_0: L2 into the gradient
    m = b1 * m + beta3 * g
    v = b2 * v + (1.0 - b2) * g * g
    update = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    if wd != 0.0 and adam_w_mode:
        update = update + wd * p             # MODE_1: decoupled decay
    return update, m, v


def _lengths(ids: np.ndarray, n: int, device) -> torch.Tensor:
    """Each leaf's row count in a shard's (sorted) leaf ids."""
    return _lengths_on(tuple(np.bincount(ids, minlength=n).tolist()),
                       torch.device(device))


class DistributedFusedLAMB(ZeroOptimizer):
    """ZeRO LAMB over the data-parallel axis; one parameter group."""

    def __init__(self, params, lr: float = 1e-3, bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.01, adam_w_mode: bool = True,
                 grad_averaging: bool = True, max_grad_norm: float = 1.0,
                 use_nvlamb: bool = False, axis=DATA_AXIS, flat: bool = True,
                 flat_bucket: bool = True, n_buckets: int = 1,
                 chunk: int = 256, outer_axis: Optional[str] = DCN_AXIS,
                 dcn_reduce_dtype=None):
        super().__init__(
            params, dict(lr=lr, bias_correction=bias_correction, betas=betas,
                         eps=eps, weight_decay=weight_decay,
                         adam_w_mode=adam_w_mode,
                         grad_averaging=grad_averaging,
                         max_grad_norm=max_grad_norm, use_nvlamb=use_nvlamb),
            axis=axis, flat_bucket=flat_bucket, n_buckets=n_buckets,
            chunk=chunk, outer_axis=outer_axis,
            dcn_reduce_dtype=dcn_reduce_dtype)
        # flat=True: the per-leaf shape's shard-local work over one
        # chunked buffer (FusedLAMB's flat form); flat_bucket=True ignores it
        self.flat = flat

    @torch.no_grad()
    def step(self, closure=None, *, lr=None, grad_scale=None,
             skip_update=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        if self._zero is None:
            self.init_state()
        group = self.param_groups[0]
        dev = self._params()[0].device
        skip = (None if skip_update is None else torch.as_tensor(
            skip_update, dtype=torch.bool, device=dev))
        t = self._zero["step"] + 1
        b1, b2 = group["betas"]
        if group["bias_correction"]:
            bc1, bc2 = bias_correction(b1, t), bias_correction(b2, t)
        else:
            bc1 = bc2 = 1.0
        max_norm = group["max_grad_norm"]

        def clip_ratio(global_norm):
            if max_norm and max_norm > 0:
                return torch.clamp(global_norm / max_norm, min=1.0)
            return torch.ones((), device=global_norm.device)

        kw = dict(lr=group["lr"] if lr is None else lr, b1=b1, b2=b2,
                  eps=group["eps"], wd=group["weight_decay"],
                  beta3=1.0 - b1 if group["grad_averaging"] else 1.0,
                  bc1=bc1, bc2=bc2, adam_w_mode=group["adam_w_mode"],
                  use_nvlamb=group["use_nvlamb"], clip_ratio=clip_ratio)
        if self.flat_bucket:
            self._lamb_flat_bucket(kw, grad_scale, skip, dev)
        else:
            self._lamb_per_leaf(kw, grad_scale, skip, dev)
        self._zero["step"] = advance_step(self._zero["step"], skip)
        return loss

    def _inv_scale(self, world_total: int, grad_scale, device):
        inv = 1.0 / float(world_total)
        if grad_scale is not None:
            inv = inv / torch.as_tensor(grad_scale, dtype=torch.float32,
                                        device=device)
        return inv

    def _lamb_per_leaf(self, kw, grad_scale, skip, dev):
        axis = self.axis
        params, z = self._params(), self._zero
        inv = self._inv_scale(cc.axis_size(axis), grad_scale, dev)
        g = [reduce_scatter_leaf(x.float(), axis) * inv
             for x in self._grads()]
        p32, m, v = z["master"], z["slots"]["exp_avg"], \
            z["slots"]["exp_avg_sq"]

        def reduce(x):
            return cc.all_reduce(x, axis)

        if self.flat:
            new = lamb_flat_update(p32, g, m, v, reduce=reduce, **kw)
        else:
            new = self._per_leaf_update(p32, g, m, v, reduce=reduce, **kw)
        new = [list(x) for x in new]
        if skip is not None:
            for n, o in zip(new, (p32, m, v)):
                apply_skip(skip, n, o)
        for olds, news in zip((p32, m, v), new):
            torch._foreach_copy_(olds, news)
        for p, chunk in zip(params, p32):
            p.copy_(unshard_leaf(chunk, p.shape, p.dtype, axis))

    @staticmethod
    def _per_leaf_update(p32, g, m, v, *, lr, b1, b2, eps, wd, beta3, bc1,
                         bc2, adam_w_mode, use_nvlamb, clip_ratio, reduce):
        """Both stages tensor by tensor on the shards: the global norm and
        the stacked per-tensor norms each one ``reduce``."""
        sq = torch.stack([x.square().sum() for x in g]).sum()
        clip = clip_ratio(torch.sqrt(reduce(sq)))
        ups, ms, vs = [], [], []
        for p, gi, mi, vi in zip(p32, g, m, v):
            u, mi, vi = _lamb_stage1(p, gi, mi, vi, clip=clip, b1=b1, b2=b2,
                                     beta3=beta3, bc1=bc1, bc2=bc2, eps=eps,
                                     wd=wd, adam_w_mode=adam_w_mode)
            ups.append(u)
            ms.append(mi)
            vs.append(vi)
        if wd != 0.0 or use_nvlamb:
            partial = torch.stack([x.square().sum() for x in p32]
                                  + [u.square().sum() for u in ups])
            norms = reduce(partial)
            n = len(p32)
            ratio = _trust_ratio(norms[:n], norms[n:])
            ps = [p - lr * ratio[i] * u
                  for i, (p, u) in enumerate(zip(p32, ups))]
        else:
            ps = [p - lr * u for p, u in zip(p32, ups)]
        return ps, ms, vs

    def _lamb_flat_bucket(self, kw, grad_scale, skip, dev):
        cfg, lay, z = self._cfg_now, self._lay, self._zero
        params, grads = self._params(), self._grads()
        rank = fb.flat_rank(cfg)
        inv = self._inv_scale(cfg.world_total, grad_scale, dev)

        g_loc, ids = [], []
        for group in lay.groups:
            buf = fb.flatten_group(lay, group, grads)
            g_loc.append([g * inv for g in fb.bucket_reduce_scatter(
                buf, group, cfg, lay.n_buckets,
                outer_reduce_dtype=self.dcn_reduce_dtype)])
            ids.append(fb.local_leaf_ids(group, lay.n_buckets, rank))
        # the global norm from the shards: they differ over the scatter
        # axes only (an outer tier holds copies), so one all-reduce there
        local_sq = torch.stack([g.square().sum() for bufs in g_loc
                                for g in bufs]).sum()
        clip = kw["clip_ratio"](torch.sqrt(
            cc.all_reduce(local_sq, cfg.scatter_axes)))

        m_all, v_all = z["slots"]["exp_avg"], z["slots"]["exp_avg_sq"]
        updates, new_m, new_v = [], [], []
        for gi in range(len(lay.groups)):
            us, ms, vs = [], [], []
            for g, m, v, p in zip(g_loc[gi], m_all[gi], v_all[gi],
                                  z["master"][gi]):
                u, m, v = _lamb_stage1(
                    p, g, m, v, clip=clip, b1=kw["b1"], b2=kw["b2"],
                    beta3=kw["beta3"], bc1=kw["bc1"], bc2=kw["bc2"],
                    eps=kw["eps"], wd=kw["wd"],
                    adam_w_mode=kw["adam_w_mode"])
                us.append(u)
                ms.append(m)
                vs.append(v)
            updates.append(us)
            new_m.append(ms)
            new_v.append(vs)

        # stage 2: per-tensor trust ratios from shard-local segmented sums
        # of the params and the updates, stacked into one all-reduce
        lr = kw["lr"]
        if kw["wd"] != 0.0 or kw["use_nvlamb"]:
            def partials(bufs_of):
                out = []
                for gi, group in enumerate(lay.groups):
                    n = len(group.indices)
                    acc = torch.zeros((n,), dtype=torch.float32, device=dev)
                    for buf, seg in zip(bufs_of[gi], ids[gi]):
                        acc = acc + torch.segment_reduce(
                            buf.square().sum(dim=1), "sum",
                            lengths=_lengths(seg, n, dev), unsafe=True,
                            initial=0.0)
                    out.append(acc)
                return out

            partial = torch.cat(partials(z["master"]) + partials(updates))
            norms_sq = cc.all_reduce(partial, cfg.scatter_axes)
            half = partial.shape[0] // 2
            ratio_all = _trust_ratio(norms_sq[:half], norms_sq[half:])

            def rows_ratio(gi, offset, k):
                n = len(lay.groups[gi].indices)
                seg = ids[gi][k]
                return torch.repeat_interleave(
                    ratio_all[offset:offset + n], _lengths(seg, n, dev),
                    output_size=len(seg))[:, None]
        else:
            def rows_ratio(gi, offset, k):
                return 1.0

        new_p, offset = [], 0
        for gi, group in enumerate(lay.groups):
            new_p.append([p - lr * rows_ratio(gi, offset, k) * u
                          for k, (p, u) in enumerate(
                              zip(z["master"][gi], updates[gi]))])
            offset += len(group.indices)

        for gi, group in enumerate(lay.groups):
            for news, olds in ((new_p[gi], z["master"][gi]),
                               (new_m[gi], m_all[gi]),
                               (new_v[gi], v_all[gi])):
                if skip is not None:
                    apply_skip(skip, news, olds)
                torch._foreach_copy_(olds, news)
            full = fb.bucket_all_gather(z["master"][gi], group, cfg,
                                        dtype=group.dtype)
            mine = [params[i] for i in group.indices]
            torch._foreach_copy_(mine, fb.group_leaf_views(lay, group, full))
