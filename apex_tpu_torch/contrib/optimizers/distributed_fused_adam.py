"""ZeRO-sharded Adam (port of
:mod:`apex_tpu.contrib.optimizers.distributed_fused_adam`, the
reference's ``apex/contrib/optimizers/distributed_fused_adam.py``).

ZeRO-2: the optimizer state and the reduced gradients are split over the
data-parallel ranks, the parameters replicated.  :meth:`step` reads each
parameter's local, unreduced ``.grad``, reduce-scatters the gradients
(not an all-reduce), steps this rank's shard with the shared Adam math
(:func:`apex_tpu_torch.optimizers._common.adam_apply`) and all-gathers
the stepped shards into the parameters, in place.  The moments and the
fp32 master exist for the shard only: the 1/dp state memory that is
ZeRO's point.

Two shapes, as in the reference:

- ``flat_bucket=True`` (the default): the gradients are packed into one
  padded ``(rows, chunk)`` buffer per dtype-group and exchanged in
  ``n_buckets`` reduce-scatters and ``n_buckets`` all-gathers
  (:mod:`._flat_bucket`), hierarchically over ``outer_axis`` (``dcn``)
  when that axis has more than one rank, the outer hop optionally in
  ``dcn_reduce_dtype``;
- ``flat_bucket=False``: one reduce-scatter and one all-gather a
  parameter, each raveled and zero-padded to a multiple of the world.

``store_param_remainders`` keeps the fp32 master as the bf16 parameters
(its high 16 bits, truncated) plus a ``uint16`` remainder (its low 16
bits, :func:`split_fp32` / :func:`join_fp32`), bit-exact at half the
master's memory.  ``grad_predivide_factor`` divides the gradients by
``f`` before the sum and by ``world / f`` after it.

``step(lr=, grad_scale=, skip_update=)`` takes the fused optimizers'
keywords: ``grad_scale`` divides the gradients, and where
``skip_update`` (a 0-d bool tensor) is True the parameters, the shards
and the step count keep their values, by a select on the device with no
host sync (the collectives still run).  :meth:`opt_state` /
:meth:`load_opt_state` give and take the reference's ``OptState``:
``slots={"exp_avg", "exp_avg_sq"}`` and ``master`` as per-group lists
of per-bucket ``(local_rows, chunk)`` buffers, or, per leaf, trees of
the parameters' structure holding each leaf's 1-D chunk.  The state is
made from the parameters at the first step, or by
:func:`apex_tpu_torch.parallel.zero_init`.  Every rank of the grid must
step with the same parameters' gradients present.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from apex_tpu_torch.contrib.optimizers import _flat_bucket as fb
from apex_tpu_torch.optimizers._common import (
    OptState,
    adam_apply,
    advance_step,
    apply_skip,
    bias_correction,
)
from apex_tpu_torch.parallel import collectives as cc
from apex_tpu_torch.parallel.mesh import DATA_AXIS, DCN_AXIS
from apex_tpu_torch.utils.tree import tree_flatten

__all__ = ["DistributedFusedAdam", "ZeroOptimizer", "shard_leaf", "reduce_scatter_leaf",
           "unshard_leaf", "split_fp32", "join_fp32"]


def _chunk_size(n: int, world: int) -> int:
    return -(-n // world)


def _padded_ravel(x: torch.Tensor, world: int) -> torch.Tensor:
    flat = x.reshape(-1)
    c = _chunk_size(flat.numel(), world)
    return torch.nn.functional.pad(flat, (0, c * world - flat.numel()))


def shard_leaf(x: torch.Tensor, axis) -> torch.Tensor:
    """This rank's chunk of ``x`` raveled and zero-padded to a multiple of
    the axis's size (no communication)."""
    world, rank = cc.axis_size(axis), cc.axis_index(axis)
    flat = _padded_ravel(x, world)
    c = flat.numel() // world
    return flat[rank * c:(rank + 1) * c].clone()


def reduce_scatter_leaf(g: torch.Tensor, axis) -> torch.Tensor:
    """``g`` raveled, padded and reduce-scattered: this rank's summed
    chunk."""
    return cc.reduce_scatter(_padded_ravel(g, cc.axis_size(axis)), axis,
                             scatter_axis=0)


def unshard_leaf(chunk: torch.Tensor, shape, dtype, axis) -> torch.Tensor:
    """Every rank's chunk gathered, cast to ``dtype`` first (a
    half-precision model moves half the bytes), cut to ``shape``."""
    full = cc.all_gather(chunk.to(dtype), axis, concat_axis=0)
    n = 1
    for s in shape:
        n *= int(s)
    return full[:n].reshape(tuple(shape))


def split_fp32(x32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 -> (bf16 of its high 16 bits, ``uint16`` of its low 16 bits):
    the reference's ``_fp32_to_bf16_rem``, on ``int32`` views; the
    remainder's bytes are the JAX package's ``uint16`` leaf."""
    bits = x32.float().contiguous().view(torch.int32)
    hi = (bits >> 16).to(torch.int16).view(torch.bfloat16)
    lo = (bits & 0xFFFF).to(torch.int16).view(torch.uint16)
    return hi, lo


def join_fp32(hi_bf16: torch.Tensor, lo_u16: torch.Tensor) -> torch.Tensor:
    """(bf16, remainder) -> the exact fp32 (``_bf16_rem_to_fp32``)."""
    hi = hi_bf16.contiguous().view(torch.int16).to(torch.int32)
    lo = lo_u16.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
    return ((hi << 16) | lo).view(torch.float32)


class ZeroOptimizer(fb.FlatBucketMixin, torch.optim.Optimizer):
    """The sharded state both ZeRO optimizers keep (one parameter group):
    the moments ``slots`` and the fp32 ``master`` of this rank's shard,
    per dtype-group and bucket (``flat_bucket``) or per parameter, and
    the step count; subclasses implement ``step``."""

    slots = ("exp_avg", "exp_avg_sq")
    store_param_remainders = False

    def __init__(self, params, defaults, *, axis, flat_bucket: bool,
                 n_buckets: int, chunk: int, outer_axis: Optional[str],
                 dcn_reduce_dtype):
        torch.optim.Optimizer.__init__(self, params, defaults)
        if len(self.param_groups) != 1:
            raise ValueError("a ZeRO optimizer takes one parameter group")
        self.axis = axis
        self._init_bucket_config(
            flat_bucket=flat_bucket, n_buckets=n_buckets, chunk=chunk,
            outer_axis=outer_axis, dcn_reduce_dtype=dcn_reduce_dtype)
        self._zero = None

    # --------------------------------------------------------------- state

    @property
    def lr(self):
        return self.param_groups[0]["lr"]

    def _params(self) -> List[torch.Tensor]:
        return self.param_groups[0]["params"]

    @torch.no_grad()
    def init_state(self) -> None:
        """Seed the shards from the current (replicated) parameters, with
        no communication: zero moments, this rank's fp32 rows."""
        params = self._params()
        self._cfg_now = self._cfg()
        if self.flat_bucket:
            self._lay = self._layout(params, self._cfg_now.world_scatter)
            st = fb.init_flat_state(
                params, self._cfg_now, self._lay,
                remainder_split=(split_fp32 if self.store_param_remainders
                                 else None))
            self._zero = {"step": 0, "slots": dict(st.slots),
                          "master": st.master}
            return
        axis = self.axis
        shards = [shard_leaf(p.detach().float(), axis) for p in params]
        self._zero = {
            "step": 0,
            "slots": {n: [torch.zeros_like(s) for s in shards]
                      for n in self.slots},
            "master": ([split_fp32(s)[1] for s in shards]
                       if self.store_param_remainders else shards)}

    def _leaf_index(self, params) -> List[int]:
        """Positions in this optimizer's parameter list of the leaves of
        ``params`` (a tree of them, in the tree's order)."""
        leaves, _ = tree_flatten(params)
        where = {id(p): i for i, p in enumerate(self._params())}
        if len(leaves) != len(where) or any(id(p) not in where
                                            for p in leaves):
            raise ValueError("opt_state/load_opt_state take a tree of "
                             "exactly this optimizer's parameters")
        return [where[id(p)] for p in leaves]

    def _as_tree(self, params, values):
        if params is None:
            return list(values)
        _, treedef = tree_flatten(params)
        return treedef([values[i] for i in self._leaf_index(params)])

    @torch.no_grad()
    def opt_state(self, params=None) -> OptState:
        """The state as the reference's ``OptState`` (the optimizer's own
        tensors, not copies): per-group lists of per-bucket buffers, or,
        per leaf, trees of ``params``' structure (a tree of this
        optimizer's parameters; ``None`` gives lists in parameter
        order)."""
        if self._zero is None:
            self.init_state()
        z = self._zero
        dev = self._params()[0].device
        step = torch.as_tensor(z["step"], device=dev).to(torch.int32)
        if self.flat_bucket:
            return OptState(step=step,
                            slots={n: [list(g) for g in z["slots"][n]]
                                   for n in self.slots},
                            master=[list(g) for g in z["master"]])
        return OptState(step=step,
                        slots={n: self._as_tree(params, z["slots"][n])
                               for n in self.slots},
                        master=self._as_tree(params, z["master"]))

    @torch.no_grad()
    def load_opt_state(self, params, state: OptState, *,
                       step_on_device: bool = True) -> None:
        """Copy an ``OptState`` of this rank (:meth:`opt_state`'s form, from
        a checkpoint or :func:`~apex_tpu_torch.checkpoint.
        scatter_zero_state`) into the optimizer's own tensors.  The step
        count becomes a device tensor (``step_on_device``) or a host
        int."""
        if self._zero is None:
            self.init_state()
        mine = self.opt_state(params)
        if state.master is None:
            raise ValueError("the state has no master shards")
        dsts, srcs = [], []
        for a, b in [(mine.slots[n], state.slots[n]) for n in self.slots] \
                + [(mine.master, state.master)]:
            dsts += tree_flatten(a)[0]
            srcs += tree_flatten(b)[0]
        if len(dsts) != len(srcs):
            raise ValueError(f"the state has {len(srcs)} shards where this "
                             f"optimizer holds {len(dsts)}")
        for dst, src in zip(dsts, srcs):
            src = torch.as_tensor(src)
            if tuple(dst.shape) != tuple(src.shape):
                raise ValueError(
                    f"state shard of shape {tuple(src.shape)} where this "
                    f"rank holds {tuple(dst.shape)} (another world size "
                    "or layout: go through scatter_zero_state)")
            dst.copy_(src)
        step = torch.as_tensor(state.step)
        dev = self._params()[0].device
        self._zero["step"] = (step.to(device=dev, dtype=torch.int64)
                              if step_on_device else int(step))

    def _grads(self) -> List[torch.Tensor]:
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in self._params()]


class DistributedFusedAdam(ZeroOptimizer):
    """ZeRO-2 Adam over the data-parallel axis (see the module
    docstring); one parameter group."""

    def __init__(self, params, lr: float = 1e-3, bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 adam_w_mode: bool = True, weight_decay: float = 0.0,
                 axis=DATA_AXIS, grad_predivide_factor: Optional[float] = None,
                 store_param_remainders: bool = False,
                 flat_bucket: bool = True, n_buckets: int = 1,
                 chunk: int = 256, outer_axis: Optional[str] = DCN_AXIS,
                 dcn_reduce_dtype=None):
        super().__init__(
            params, dict(lr=lr, bias_correction=bias_correction, betas=betas,
                         eps=eps, adam_w_mode=adam_w_mode,
                         weight_decay=weight_decay),
            axis=axis, flat_bucket=flat_bucket, n_buckets=n_buckets,
            chunk=chunk, outer_axis=outer_axis,
            dcn_reduce_dtype=dcn_reduce_dtype)
        # the reference's predivide split (apex DDP's
        # gradient_predivide_factor); None divides by the world after
        self.grad_predivide_factor = grad_predivide_factor
        self.store_param_remainders = store_param_remainders

    # ---------------------------------------------------------------- step

    def _scales(self, world_total: int, grad_scale, device):
        """The pre- and post-reduction gradient factors: ``1 / f`` (over
        the loss scale) before the sum, ``f / world`` after it."""
        f = float(world_total if self.grad_predivide_factor is None
                  else self.grad_predivide_factor)
        pre = 1.0 / f
        post = f / float(world_total)
        if grad_scale is not None:
            # a device scale stays on the device: no copy, no sync
            pre = pre / torch.as_tensor(grad_scale, dtype=torch.float32,
                                        device=device)
        return pre, post

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
        kw = dict(lr=group["lr"] if lr is None else lr, b1=b1, b2=b2,
                  eps=group["eps"], wd=group["weight_decay"], bc1=bc1,
                  bc2=bc2, adam_w_mode=group["adam_w_mode"])
        if self.flat_bucket:
            self._step_flat_bucket(kw, grad_scale, skip, dev)
        else:
            self._step_per_leaf(kw, grad_scale, skip, dev)
        self._zero["step"] = advance_step(self._zero["step"], skip)
        return loss

    def _adam(self, p32, g, m, v, kw, skip):
        old = None if skip is None else [x.clone() for x in p32 + m + v]
        adam_apply(p32, g, m, v, **kw)
        if skip is not None:
            apply_skip(skip, p32 + m + v, old)

    def _step_per_leaf(self, kw, grad_scale, skip, dev):
        axis = self.axis
        params, z = self._params(), self._zero
        pre, post = self._scales(cc.axis_size(axis), grad_scale, dev)
        g = [reduce_scatter_leaf(x.float() * pre, axis) for x in self._grads()]
        if post != 1.0:
            torch._foreach_mul_(g, post)
        if self.store_param_remainders:
            p32 = [join_fp32(shard_leaf(p.detach(), axis).to(torch.bfloat16),
                             lo) for p, lo in zip(params, z["master"])]
        else:
            p32 = z["master"]
        m, v = z["slots"]["exp_avg"], z["slots"]["exp_avg_sq"]
        self._adam(p32, g, m, v, kw, skip)
        if self.store_param_remainders:
            src = []
            for p, lo in zip(p32, z["master"]):
                hi, new_lo = split_fp32(p)
                lo.copy_(new_lo)
                src.append(hi)
        else:
            src = p32
        for p, chunk in zip(params, src):
            p.copy_(unshard_leaf(chunk, p.shape, p.dtype, axis))

    def _step_flat_bucket(self, kw, grad_scale, skip, dev):
        cfg, lay, z = self._cfg_now, self._lay, self._zero
        params = self._params()
        pre, post = self._scales(cfg.world_total, grad_scale, dev)
        grads = self._grads()
        rank = fb.flat_rank(cfg)
        p32s = []
        for gi, group in enumerate(lay.groups):
            g32 = fb.flatten_group(lay, group, grads)
            if not (isinstance(pre, float) and pre == 1.0):
                g32.mul_(pre)
            g_loc = fb.bucket_reduce_scatter(
                g32, group, cfg, lay.n_buckets,
                outer_reduce_dtype=self.dcn_reduce_dtype)
            if post != 1.0:
                torch._foreach_mul_(g_loc, post)
            if self.store_param_remainders:
                hi = fb.flatten_group(lay, group, params,
                                      dtype=torch.bfloat16)
                p32 = [join_fp32(h, lo) for h, lo in zip(
                    fb.local_slices(hi, group, lay.n_buckets, rank),
                    z["master"][gi])]
            else:
                p32 = z["master"][gi]
            self._adam(p32, g_loc, z["slots"]["exp_avg"][gi],
                       z["slots"]["exp_avg_sq"][gi], kw, skip)
            p32s.append(p32)
        for gi, group in enumerate(lay.groups):
            if self.store_param_remainders:
                src = []
                for p, lo in zip(p32s[gi], z["master"][gi]):
                    hi, new_lo = split_fp32(p)
                    lo.copy_(new_lo)
                    src.append(hi)
            else:
                src = p32s[gi]
            full = fb.bucket_all_gather(src, group, cfg, dtype=group.dtype)
            mine = [params[i] for i in group.indices]
            torch._foreach_copy_(mine, fb.group_leaf_views(lay, group, full))
