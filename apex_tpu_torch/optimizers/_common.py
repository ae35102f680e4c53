"""Shared update math of the fused optimizers (port of
:mod:`apex_tpu.optimizers._common`).

The reference's optimizers are one CUDA ``multi_tensor_apply`` launch per
op over lists of tensors; the JAX package keeps the semantics and lets
XLA fuse the leaves.  Here the same semantics run over lists of tensors
(the JAX pytrees' leaves) with ``torch._foreach_*`` ops, in place, one
launch per op for the whole list:

- the update math in fp32 whatever the storage dtype;
- optional fp32 master parameters kept in the optimizer state;
- the loss-scale division folded into the gradients;
- the overflow skip as a select on the device (``torch.where`` on a 0-d
  bool tensor), never a host branch, and a step counter that advances
  only on applied updates.

A scalar here (``lr``, a bias correction, a scale) is a Python number or
a 0-d tensor on the lists' device.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.amp._tree import tree_leaves, tree_map
from apex_tpu_torch.utils.tree import tree_flatten

__all__ = ["OptState", "FusedOptimizer", "adam_apply", "scale_grads",
           "resolve_master", "finalize_params", "cast_like", "apply_skip",
           "advance_step", "bias_correction", "tree_map_flat", "tree_f32",
           "tree_zeros_f32", "tree_map_multi"]

Tensors = List[torch.Tensor]


class OptState(NamedTuple):
    """The reference's optimizer state tree, the checkpointed form of an
    optimizer's state: a step counter (int32, 0-d), named slot trees of
    the parameters' structure, and the optional fp32 master params."""

    step: torch.Tensor
    slots: Any  # dict name -> tree (same structure as params)
    master: Optional[Any]  # fp32 params tree or None


def adam_apply(p: Tensors, g: Tensors, m: Tensors, v: Tensors, *, lr, b1: float,
               b2: float, eps: float, wd: float, bc1, bc2,
               adam_w_mode: bool) -> None:
    """One Adam/AdamW update of the fp32 lists ``p``, ``m``, ``v`` in
    place, from the fp32 gradients ``g`` (``csrc/multi_tensor_adam.cu``
    ``ADAM_MODE_0`` folds ``wd * p`` into the gradient, ``ADAM_MODE_1``
    decouples the decay into the update)::

        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        p = p - lr * ((m / bc1) / (sqrt(v / bc2) + eps) [+ wd * p])
    """
    if not adam_w_mode and wd != 0.0:
        g = torch._foreach_add(g, p, alpha=wd)
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, g, alpha=1.0 - b1)
    torch._foreach_mul_(v, b2)
    torch._foreach_addcmul_(v, g, g, value=1.0 - b2)
    denom = torch._foreach_div(v, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    update = torch._foreach_div(m, bc1)
    torch._foreach_div_(update, denom)
    if adam_w_mode and wd != 0.0:
        torch._foreach_add_(update, p, alpha=wd)
    if isinstance(lr, torch.Tensor):
        torch._foreach_mul_(update, lr)
        torch._foreach_sub_(p, update)
    else:
        torch._foreach_add_(p, update, alpha=-lr)


def scale_grads(grads: Tensors, grad_scale=None) -> Tensors:
    """The gradients in fp32, multiplied by ``1 / grad_scale`` (taken in
    fp32) when a scale is given: the loss-scale division folded into the
    update (``div_scale`` of ``multi_tensor_adam``).  An fp32 gradient
    with no scale is returned as it is, not copied."""
    if grad_scale is None:
        return [g.float() for g in grads]
    inv = 1.0 / torch.as_tensor(grad_scale, dtype=torch.float32,
                                device=grads[0].device)
    return [g.float() * inv for g in grads]


def resolve_master(params: Tensors, master, use_master: bool) -> Tensors:
    """The fp32 list the update runs on: the masters, or the parameters
    themselves where they are fp32 and fp32 copies where they are not."""
    if use_master:
        return master
    return [p.float() for p in params]


def finalize_params(p32: Tensors, params: Tensors) -> None:
    """Write the stepped fp32 values into every parameter that is not
    itself one of them, cast to its own dtype
    (``_master_params_to_model_params``)."""
    for p, new in zip(params, p32):
        if new is not p:
            p.copy_(new)


def cast_like(new: Tensors, ref: Tensors) -> Tensors:
    """``new`` cast to the dtypes of ``ref``."""
    return [n.to(r.dtype) for n, r in zip(new, ref)]


def apply_skip(skip_update, new: Tensors, old: Tensors) -> None:
    """Where ``skip_update`` (a 0-d bool tensor on the lists' device) is
    True, put the old values back into ``new`` in place (the kernels'
    ``noop_flag`` early-out; the amp skip step)."""
    for n, o in zip(new, old):
        n.copy_(torch.where(skip_update, o, n))


def advance_step(step, skip_update):
    """The step counter after an update: ``step + 1``, or, with a
    ``skip_update`` tensor, ``step`` where it is True, so that the bias
    corrections count applied updates only."""
    if skip_update is None:
        return step + 1
    return step + torch.where(skip_update, 0, 1)


def bias_correction(beta: float, t):
    """``1 - beta ** t`` in fp32: a float from a host count, a 0-d tensor
    from a device one."""
    if isinstance(t, torch.Tensor):
        return 1.0 - torch.pow(beta, t.float())
    return float(1.0 - torch.tensor(beta) ** torch.tensor(float(t)))


def tree_f32(tree):
    """An fp32 copy of every leaf (a copy even of fp32 leaves, so a master
    tree never aliases the parameters)."""
    return tree_map(lambda x: torch.as_tensor(x).detach().to(
        torch.float32, copy=True), tree)


def tree_zeros_f32(tree):
    """fp32 zeros shaped like every leaf (an optimizer slot's start)."""
    return tree_map(lambda x: torch.zeros(
        tuple(x.shape), dtype=torch.float32, device=x.device), tree)


def tree_map_multi(fn: Callable, n_out: int, *trees) -> Tuple[Any, ...]:
    """``fn`` (returning an ``n_out``-tuple) over the leaves of ``trees``
    (all of the first tree's structure), as ``n_out`` trees."""
    leaves0, unflatten = tree_flatten(trees[0])
    rest = [tree_flatten(t)[0] for t in trees[1:]]
    results = [fn(*args) for args in zip(leaves0, *rest)]
    return tuple(unflatten([r[i] for r in results]) for i in range(n_out))


def tree_map_flat(fn: Callable, *lists: Tensors) -> None:
    """Run the in-place list update ``fn`` once over one flat fp32 buffer
    per list (each a one-element list), then write every buffer back into
    its list's tensors in their dtypes: the ``multi_tensor_apply`` shape,
    one wide launch per op instead of one per tensor, at the cost of a
    pack and an unpack.  Only for purely elementwise ``fn``."""
    sizes = [t.numel() for t in lists[0]]
    bufs = [torch.cat([t.reshape(-1).float() for t in ts]) for ts in lists]
    fn(*([b] for b in bufs))
    for ts, buf in zip(lists, bufs):
        for t, piece in zip(ts, buf.split(sizes)):
            t.copy_(piece.view_as(t))


class FusedOptimizer(torch.optim.Optimizer):
    """The step every fused optimizer shares: per parameter group, the
    fp32 working list (the masters with ``master_weights``, else the
    parameters, through fp32 copies where they are not fp32), the fp32
    gradients divided by ``grad_scale``, the slots, the subclass's
    in-place ``_update``, the skip as a select on the device, the write
    back into the parameters, and the group's step count (``group["step"]``,
    advanced only by an applied update).

    ``step(closure=None, *, lr=None, grad_scale=None, skip_update=None,
    grads=None)``: ``lr`` is this step's rate, ``skip_update`` a bool or a
    0-d bool tensor (the step count is then a device tensor), ``grads`` a
    mapping from parameter to the gradient to use instead of its
    ``.grad`` (LARC hands its fp32 gradients over so).

    Subclasses set ``self.slots`` (the names of the fp32 slot tensors
    kept per parameter) and implement ``_update(group, p32, g32, slots,
    step, lr)``, where ``slots`` maps each name to the group's list and
    ``step`` is the count before this update.  :meth:`opt_state` and
    :meth:`load_opt_state` give and take the state as the reference's
    :class:`OptState` in the structure of a tree of the parameters."""

    slots: Tuple[str, ...] = ()

    def __init__(self, params, defaults: Dict[str, Any],
                 master_weights: bool = False):
        super().__init__(params, defaults)
        self.master_weights = master_weights

    def _init_slot(self, name: str, p: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(p, dtype=torch.float32,
                                memory_format=torch.preserve_format)

    def _state(self, p):
        state = self.state[p]
        if not state:
            for name in self.slots:
                state[name] = self._init_slot(name, p)
            if self.master_weights:
                state["master"] = p.detach().to(torch.float32, copy=True)
        return state

    def _update(self, group, p32: Tensors, g32: Tensors,
                slots: Dict[str, Tensors], step, lr) -> None:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None, *, lr=None, grad_scale=None,
             skip_update=None, grads=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"]
                      if (p.grad if grads is None else grads.get(p))
                      is not None]
            if not params:
                continue
            states = [self._state(p) for p in params]
            skip = (None if skip_update is None else torch.as_tensor(
                skip_update, dtype=torch.bool, device=params[0].device))
            step = group.setdefault("step", 0)
            p32 = resolve_master(params, [s.get("master") for s in states],
                                 self.master_weights)
            g32 = scale_grads([p.grad if grads is None else grads[p]
                               for p in params], grad_scale)
            slots = {n: [s[n] for s in states] for n in self.slots}
            kept = p32 + [x for n in self.slots for x in slots[n]]
            old = None if skip is None else [x.clone() for x in kept]
            self._update(group, p32, g32, slots, step,
                         group["lr"] if lr is None else lr)
            if skip is not None:
                apply_skip(skip, kept, old)
            finalize_params(p32, params)
            group["step"] = advance_step(step, skip)
        return loss

    def _group_of(self, params):
        """The one parameter group holding every leaf of ``params``."""
        leaves = tree_leaves(params)
        ids = {id(p) for p in leaves}
        groups = [g for g in self.param_groups
                  if any(id(p) in ids for p in g["params"])]
        held = {id(p) for g in groups for p in g["params"]}
        if len(groups) != 1 or not ids <= held:
            raise ValueError(
                "opt_state/load_opt_state take the parameters of one "
                f"parameter group (found {len(groups)} groups holding "
                f"{len(ids & held)} of {len(ids)} leaves)")
        return groups[0]

    @torch.no_grad()
    def opt_state(self, params) -> OptState:
        """The state as the reference's ``OptState`` in the structure of
        ``params`` (a tree of this optimizer's parameters): the step
        count as an int32 0-d tensor, each slot (its initial value for a
        parameter not stepped yet), and the fp32 masters with
        ``master_weights`` (else ``None``).  The tensors are the
        optimizer's own, not copies."""
        group = self._group_of(params)
        first = tree_leaves(params)[0]
        step = torch.as_tensor(group.get("step", 0), device=first.device)
        slots = {name: tree_map(lambda p, n=name: self._state(p)[n], params)
                 for name in self.slots}
        master = (tree_map(lambda p: self._state(p)["master"], params)
                  if self.master_weights else None)
        return OptState(step=step.to(torch.int32), slots=slots,
                        master=master)

    @torch.no_grad()
    def load_opt_state(self, params, state: OptState, *,
                       step_on_device: bool = True) -> None:
        """Load an ``OptState`` (from :meth:`opt_state` or a checkpoint)
        for ``params``, copying into the optimizer's own tensors.  The
        step count becomes the group's: a device tensor (``step_on_device``,
        as a run with a skip holds it after its first step, so what
        depends on it is taken on the device as before), or a host int,
        as a run without a skip holds it."""
        group = self._group_of(params)
        for name in self.slots:
            tree_map(lambda p, x, n=name: self._state(p)[n].copy_(x),
                     params, state.slots[name])
        if self.master_weights:
            if state.master is None:
                raise ValueError("master_weights=True but the state has "
                                 "no master params")
            tree_map(lambda p, w: self._state(p)["master"].copy_(w),
                     params, state.master)
        first = tree_leaves(params)[0]
        step = torch.as_tensor(state.step)
        group["step"] = (step.to(device=first.device, dtype=torch.int64)
                         if step_on_device else int(step))
