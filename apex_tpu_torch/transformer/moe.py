"""Mixture-of-Experts (Switch) MLP with expert parallelism (port of
:mod:`apex_tpu.transformer.moe`).

Routing is Switch-Transformer top-1 with capacity (:func:`switch_route`):

- the router in fp32 (``x.float() @ router``), the top-1 expert (the
  first maximum on ties) and its probability, the gate, per token;
- capacity ``C = ceil(T * capacity_factor / E)`` per expert: a token's
  place in its expert's queue is its 1-based running count in token
  order, and a token past ``C`` is dropped (its MoE output is zero; the
  layer's residual carries it);
- the load-balancing loss ``E * sum_e f_e * P_e`` (the fraction routed to
  ``e`` times its mean router probability).

:class:`SwitchMLP` dispatches with the one-hot einsums in the compute
dtype (``[T, E, C]`` by ``[T, h]`` into ``[E, C, h]``, as GEMMs over the
flattened ``[T, E*C]`` mask: :func:`dispatch_tokens`,
:func:`combine_tokens`), runs each expert's
h -> ffn -> h MLP (tanh-approximate GELU, ``jax.nn.gelu``'s default) as
batched GEMMs, and combines with the same one-hot weights times the gate.
Under ``expert_axis`` (``E % ep == 0``) the expert stacks are held at
their **local** shape ``[E/ep, ...]`` and one all-to-all regroups the
dispatched tokens ``[E, C, h] -> [E/ep, ep*C, h]`` so each rank runs only
its experts over every rank's tokens; the reverse brings the outputs
home.  The expert gradients are then whole on their owner: they are not
summed over the expert axis.  The router is replicated.

The reference ``sow``s each layer's aux loss into Flax's ``"losses"``
collection; here each :class:`SwitchMLP` keeps the aux of its last
forward in ``last_aux``, and :func:`collect_moe_aux` sums those of a
module's MoE layers.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.parallel import collectives as cc
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    all_to_all_region,
)
from apex_tpu_torch.transformer.tensor_parallel.random import (
    data_parallel_rng_key,
)

__all__ = ["SwitchMLP", "collect_moe_aux", "switch_route"]


def collect_moe_aux(module) -> torch.Tensor:
    """The sum of the load-balancing losses that every :class:`SwitchMLP`
    in ``module`` (itself included) recorded in its last forward: add
    ``coeff * collect_moe_aux(model)`` to the training loss after the
    forward.  Returns 0.0 when no MoE layer ran.  This takes the place of
    the reference's ``module.apply(..., mutable=["losses"])`` and the sum
    over its ``moe_aux`` entries."""
    if not isinstance(module, nn.Module):
        raise TypeError(
            f"expected the torch.nn.Module whose forward just ran (its "
            f"SwitchMLP layers keep their aux losses), got "
            f"{type(module).__name__}")
    total = None
    for m in module.modules():
        aux = getattr(m, "last_aux", None) if isinstance(m, SwitchMLP) \
            else None
        if aux is not None:
            total = aux if total is None else total + aux
    if total is None:
        return torch.tensor(0.0)
    return total


def dispatch_tokens(dd, flat):
    """``einsum("tec,th->ech")`` on the one-hot ``dd [T, E*C]`` as one GEMM
    over its transpose: ``[E*C, h]``.  Each slot holds at most one token,
    so every sum has one term and any order gives the einsum's bits."""
    return dd.t() @ flat


def combine_tokens(dd, expert_out):
    """``einsum("tec,ech->th")``: ``[T, E*C] @ [E*C, h]``, one term a
    token."""
    return dd @ expert_out


def switch_route(logits32, capacity: int):
    """Top-1 Switch routing from fp32 router logits ``[T, E]``.

    Returns ``(dispatch [T, E, C] bool, gate [T] fp32, aux fp32)``."""
    T, E = logits32.shape
    # jax.nn.softmax's form: exp(x - max) / sum, the max a constant
    ex = torch.exp(logits32 - logits32.amax(dim=-1, keepdim=True).detach())
    probs = ex / ex.sum(dim=-1, keepdim=True)
    expert_idx = torch.argmax(probs, dim=-1)
    gate = torch.gather(probs, 1, expert_idx[:, None])[:, 0]

    onehot = F.one_hot(expert_idx, E).to(torch.float32)          # [T, E]
    # position of each token within its expert's queue (1-based): a running
    # count, exact in fp32 in any order, so taken along the inner dim of
    # the [E, T] transpose (a scan over the outer dim of [T, E] runs one
    # thread per expert)
    pos = torch.cumsum(onehot.t().contiguous(), dim=1).t() * onehot
    # the reference's keep & (clip(pos - 1) == slot), built by one scatter:
    # each token marks its own (expert, queue position) if it is within
    # the capacity (a dropped token writes False where a zero is already)
    queue = pos.sum(dim=-1).to(torch.int64) - 1                     # [T]
    slot = expert_idx * capacity + torch.clamp(queue, max=capacity - 1)
    dispatch = torch.zeros((T, E * capacity), dtype=torch.bool,
                           device=logits32.device).scatter_(
        1, slot[:, None], (queue < capacity)[:, None]).view(T, E, capacity)

    fraction = onehot.mean(dim=0)
    mean_prob = probs.mean(dim=0)
    aux = E * torch.sum(fraction * mean_prob)
    return dispatch, gate, aux


class SwitchMLP(nn.Module):
    """Switch-style MoE FFN block, in the dense MLP's position.

    ``forward(x [s, b, h]) -> (y [s, b, h], aux)``; ``aux`` is also kept
    in ``last_aux`` for :func:`collect_moe_aux`.  Parameters, under the
    reference's names and layouts: ``router [h, E]`` (fp32), ``w1 [E_l, h,
    ffn]``, ``b1 [E_l, ffn]``, ``w2 [E_l, ffn, h]``, ``b2 [E_l, h]`` with
    ``E_l = E / ep`` the experts of this rank of ``expert_axis`` (its size
    on the grid when built; 1 without one).  They are drawn from ``seed``
    with the reference's distributions (normal 0.02 for the router and
    ``w1``, ``0.02 / sqrt(2E)`` for ``w2``, zero biases); the expert stacks
    from a ``torch.Generator`` whose seed is folded with the rank of
    ``expert_axis`` (:func:`~apex_tpu_torch.transformer.tensor_parallel.
    random.data_parallel_rng_key`), so expert groups differ.  The experts
    run in ``dtype``, their parameters held in ``param_dtype``."""

    def __init__(self, hidden_size: int, ffn_size: int, num_experts: int,
                 capacity_factor: float = 1.25,
                 expert_axis: Optional[str] = None,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, *,
                 seed: int = 0, device=None):
        super().__init__()
        E = num_experts
        ep = cc.bound_axis_size(expert_axis)
        if E % ep:
            raise ValueError(
                f"num_experts ({E}) not divisible by expert-parallel "
                f"world ({ep})")
        self.hidden_size, self.ffn_size = hidden_size, ffn_size
        self.num_experts, self.capacity_factor = E, capacity_factor
        self.expert_axis, self.ep = expert_axis, ep
        self.dtype = dtype
        self.last_aux = None
        device = resolve_device(device)
        e_local, h, f = E // ep, hidden_size, ffn_size
        gen = torch.Generator(device=device).manual_seed(seed)
        expert_gen = torch.Generator(device=device).manual_seed(
            data_parallel_rng_key(seed, expert_axis) if ep > 1 else seed)

        def normal(shape, std, g, dt):
            return nn.Parameter(torch.randn(
                shape, generator=g, device=device,
                dtype=torch.float32).mul_(std).to(dt))

        def zeros(shape):
            return nn.Parameter(torch.zeros(shape, device=device,
                                            dtype=param_dtype))

        self.router = normal((h, E), 0.02, gen, torch.float32)
        self.w1 = normal((e_local, h, f), 0.02, expert_gen, param_dtype)
        self.b1 = zeros((e_local, f))
        self.w2 = normal((e_local, f, h), 0.02 / math.sqrt(2 * E),
                         expert_gen, param_dtype)
        self.b2 = zeros((e_local, h))

    def capacity(self, tokens: int) -> int:
        """Each expert's queue length for ``tokens`` routed tokens."""
        return max(1, int(-(-tokens * self.capacity_factor
                            // self.num_experts)))

    def forward(self, x):
        s, b, h = x.shape
        T = s * b
        dt = self.dtype
        flat = x.reshape(T, h)
        logits = flat.float() @ self.router.float()
        dispatch, gate, aux = switch_route(logits, self.capacity(T))
        dd = dispatch.view(T, -1).to(dt)                     # [T, E*C]
        expert_in = dispatch_tokens(dd, flat.to(dt)).view(self.num_experts,
                                                          -1, h)
        if self.ep > 1:
            # tokens to their experts' owners: [E, C, h] -> [E/ep, ep*C, h]
            expert_in = all_to_all_region(expert_in, self.expert_axis, 0, 1)
        # each expert's MLP over its queue, the bias added after the GEMM
        hmid = F.gelu(torch.bmm(expert_in, self.w1.to(dt))
                      + self.b1.to(dt)[:, None, :], approximate="tanh")
        expert_out = torch.bmm(hmid, self.w2.to(dt)) \
            + self.b2.to(dt)[:, None, :]
        if self.ep > 1:
            # outputs home: [E/ep, ep*C, h] -> [E, C, h]
            expert_out = all_to_all_region(expert_out, self.expert_axis, 1, 0)
        y = combine_tokens(dd, expert_out.reshape(-1, h))
        y = y * gate.to(dt)[:, None]
        self.last_aux = aux
        return y.reshape(s, b, h), aux
