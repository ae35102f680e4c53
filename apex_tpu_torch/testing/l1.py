"""L1-style training traces (port of the GPT half of
:mod:`apex_tpu.testing.l1`).

:func:`trace_gpt` runs the JAX ``_trace_gpt`` loop: a tiny GPT (hidden 64,
2 layers, 4 heads, vocabulary 128, 32 positions, no dropout) trained for
``ITERS`` steps of FusedAdam (lr 1e-3) on one fixed ``[4, 32]`` batch,
recording the mean next-token loss and the global gradient norm of every
step.  Each config runs the attention core its JAX config runs: the
default fused-softmax core, or flash for ``gpt_flash``.  ``gpt_fp8`` runs
the transformer layers' GEMMs in fp8 with delayed scaling; the metas
carry from step to step in the linears' buffers, as the JAX loop carries
its mutable ``"fp8_meta"`` collection.  With the JAX
run's initial parameters (carried over by
:func:`apex_tpu_torch.serving.bridge.from_flax_gpt`) and tokens, the two
traces agree to :func:`compare_traces`' tolerances.

:func:`amp_train_step` is one mixed-precision step (loss scaling, the
overflow check, FusedAdam's skip and the scaler's update), as the JAX
``_trace_rn50`` composes it; :func:`apply_policy` casts a module's
parameters by an amp policy.

:func:`trace_gpt_3d` is the JAX ``_trace_gpt_3d``: the 3D-parallel GPT
(dp2 x pp2(vpp2) x tp2 with sequence parallelism, hidden 32, 4 layers, 4
heads, vocabulary 64, 16 positions) trained ten FusedAdam steps through
:func:`~apex_tpu_torch.transformer.testing.gpt_parallel_train.
build_gpt_3d`'s train step, on each of eight ranks of a
``torch.distributed`` job; ``run_trace("gpt_3d")`` runs it.  Its weights
can be the JAX run's (the global ``GPT3DParams``, which ``init_fn``
carries to each rank's shard through
:func:`apex_tpu_torch.serving.bridge.from_jax_params` and
:func:`~apex_tpu_torch.transformer.tensor_parallel.shard_params`).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.amp.policy import Policy
from apex_tpu_torch.amp.scaler import LossScaleState, all_finite
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.transformer.testing.gpt_parallel_train import (
    GPT3DParams,
    init_gpt_params,
)
from apex_tpu_torch.transformer.testing.standalone_gpt import GPTModel
from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
    TransformerConfig,
)

__all__ = ["ITERS", "CONFIGS", "GPT_3D", "GPT_3D_GRID", "trace_config",
           "trace_gpt", "trace_gpt_3d", "run_trace", "train_step",
           "parallel_train_step", "amp_train_step", "apply_policy",
           "global_grad_norm", "compare_traces"]

ITERS = 10
# the JAX package's GPT trace configs (testing/l1.py CONFIGS), by name
CONFIGS = {
    "gpt_smoke": {},
    "gpt_bf16": {"dtype": torch.bfloat16},
    "gpt_flash": {"dtype": torch.bfloat16, "use_flash_attention": True},
    "gpt_modern": {"position_embedding_type": "rope", "num_query_groups": 2,
                   "swiglu": True},
    "gpt_fp8": {"fp8": True},
}

# the JAX package's _trace_gpt_3d: its model, grid, chunks and microbatches
GPT_3D = dict(hidden_size=32, num_layers=4, num_attention_heads=4,
              padded_vocab_size=64, max_position_embeddings=16,
              hidden_dropout=0.0, attention_dropout=0.0, tensor_axis="tp",
              sequence_parallel=True)
GPT_3D_GRID = dict(tensor_model_parallel_size=2,
                   pipeline_model_parallel_size=2,
                   virtual_pipeline_model_parallel_size=2)
GPT_3D_CHUNKS, GPT_3D_MICROBATCHES, GPT_3D_BATCH = 2, 2, (8, 16)


def trace_config(name: str) -> TransformerConfig:
    """The model of trace ``name`` (the JAX ``_trace_gpt`` shape)."""
    return TransformerConfig(
        hidden_size=64, num_layers=2, num_attention_heads=4,
        padded_vocab_size=128, max_position_embeddings=32,
        hidden_dropout=0.0, attention_dropout=0.0, **CONFIGS[name])


def _norm(tensors) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def global_grad_norm(params) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in fp32."""
    return _norm([p.grad.float() for p in params if p.grad is not None])


@torch.no_grad()
def apply_policy(model: torch.nn.Module, policy: Policy) -> None:
    """Cast ``model``'s parameters in place by ``policy.cast_to_param``
    over ``named_parameters()``: under O2 every parameter goes to the half
    dtype but those of norm modules (``...input_layernorm.scale``,
    ``...final_layernorm.bias``), which stay fp32."""
    cast = policy.cast_to_param(dict(model.named_parameters()))
    for name, p in model.named_parameters():
        p.data = cast[name].detach()


def train_step(model: GPTModel, opt: torch.optim.Optimizer, tokens,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One step of the JAX bench/trace step: forward, mean next-token
    loss, backward, optimizer step.  Returns the loss (on the device); the
    gradients stay in ``.grad`` until the next step clears them."""
    opt.zero_grad(set_to_none=True)
    loss = model(tokens, labels=tokens, generator=generator).mean()
    loss.backward()
    opt.step()
    return loss.detach()


def parallel_train_step(ddp, opt: torch.optim.Optimizer, tokens,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
    """:func:`train_step` on a rank of a data-, tensor- and
    sequence-parallel grid: ``ddp`` (a
    :class:`~apex_tpu_torch.parallel.DistributedDataParallel` around a
    :class:`GPTModel` built on the grid) runs this rank's batch slice
    ``tokens``; after the backward the sequence-parallel parameters'
    gradients are summed over the tensor axis and every gradient is
    averaged over the data axes; ``opt`` steps this rank's shards.
    Returns this rank's loss (on the device)."""
    from apex_tpu_torch.transformer.layers import (
        allreduce_sequence_parallel_gradients,
    )

    opt.zero_grad(set_to_none=True)
    loss = ddp(tokens, labels=tokens, generator=generator).mean()
    loss.backward()
    model = ddp.module
    allreduce_sequence_parallel_gradients(model, model.config.tensor_axis)
    ddp.reduce_gradients()
    opt.step()
    return loss.detach()


def amp_train_step(model: GPTModel, opt: FusedAdam, tokens, scaler,
                   state: LossScaleState,
                   generator: Optional[torch.Generator] = None):
    """One loss-scaled step: the scaled loss's backward, the overflow
    check over every gradient (``all_finite``), ``FusedAdam.step`` with
    the gradients divided by the scale and the update skipped on
    overflow, and the scaler's update; all on the device, with no host
    sync.  Returns ``(loss, grad_norm, new_state)``: the unscaled loss,
    the global norm of the unscaled gradients (not finite on an overflow
    step) and the next scaler state."""
    opt.zero_grad(set_to_none=True)
    loss = model(tokens, labels=tokens, generator=generator).mean()
    scaler.scale(loss, state).backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    finite = all_finite(grads)
    opt.step(grad_scale=state.scale, skip_update=~finite)
    grad_norm = _norm(scaler.unscale(grads, state))
    return loss.detach(), grad_norm, scaler.update(state, finite)


def trace_gpt(name: str, *, params: Optional[GPT3DParams] = None,
              tokens: Optional[torch.Tensor] = None, seed: int = 0,
              device=None, with_fp8_meta: bool = False):
    """``{"loss": [...], "grad_norm": [...]}`` over ``ITERS`` steps.

    ``params`` default to :func:`init_gpt_params` from ``seed``, ``tokens``
    to a ``[4, 32]`` batch drawn from ``seed + 1``; ``device`` defaults to
    the CUDA device.  With ``with_fp8_meta`` the result is ``(trace,
    metas)``, ``metas`` the final fp8 buffers by name
    (:meth:`GPTModel.fp8_meta_state`)."""
    device = resolve_device(device)
    cfg = trace_config(name)
    model = GPTModel(cfg, device=device)
    model.load_params(params if params is not None
                      else init_gpt_params(cfg, seed, device=device))
    if tokens is None:
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        tokens = torch.randint(0, cfg.padded_vocab_size, (4, 32),
                               generator=gen, device=device)
    tokens = tokens.to(device)
    opt = FusedAdam(model.parameters(), lr=1e-3)
    out: Dict[str, List[float]] = {"loss": [], "grad_norm": []}
    for _ in range(ITERS):
        loss = train_step(model, opt, tokens)
        out["loss"].append(float(loss))
        out["grad_norm"].append(float(global_grad_norm(model.parameters())))
    if with_fp8_meta:
        return out, model.fp8_meta_state()
    return out


def trace_gpt_3d(params=None, tokens=None, *, seed: int = 0, device=None,
                 with_grads: bool = False):
    """``{"loss": [...], "grad_norm": []}`` over ``ITERS`` steps of the 3D
    GPT (``GPT_3D`` on the ``GPT_3D_GRID`` grid: eight ranks, every one of
    which calls this; it sets the grid up and takes it down).  The loss of
    a step is the global one, the same on every rank; the gradient norms
    stay inside the sharded step, as in the JAX trace.

    ``params``: the global weights (the JAX ``GPT3DParams`` with numpy
    leaves, or the port's), default :func:`init_gpt_params` from
    ``seed``; ``tokens``: the global ``[8, 16]`` batch, default drawn from
    ``seed + 1``.  With ``with_grads`` the result is ``(trace, grads)``,
    ``grads`` this rank's shard of the first step's gradients (the
    ``GPT3DParams`` of ``init_fn``'s layout)."""
    from apex_tpu_torch import parallel
    from apex_tpu_torch.amp._tree import tree_leaves, tree_map
    from apex_tpu_torch.transformer.testing.gpt_parallel_train import (
        build_gpt_3d,
    )

    device = resolve_device(device)
    cfg = TransformerConfig(**GPT_3D)
    parallel.initialize_model_parallel(**GPT_3D_GRID)
    try:
        init_fn, _, make_train_step = build_gpt_3d(
            cfg, num_chunks=GPT_3D_CHUNKS,
            num_microbatches=GPT_3D_MICROBATCHES, device=device)
        local, specs = init_fn(seed, params=params)
        if tokens is None:
            gen = torch.Generator().manual_seed(seed + 1)
            tokens = torch.randint(0, cfg.padded_vocab_size, GPT_3D_BATCH,
                                   generator=gen)
        batch = parallel.dp_shard_batch(
            torch.as_tensor(tokens).to(device), axis="dp")
        opt = FusedAdam(tree_leaves(local), lr=1e-3)
        step = make_train_step(opt, specs)
        out: Dict[str, List[float]] = {"loss": [], "grad_norm": []}
        grads = None
        for i in range(ITERS):
            out["loss"].append(float(step(local, batch)))
            if i == 0 and with_grads:
                grads = tree_map(lambda p: p.grad.detach().clone(), local)
    finally:
        parallel.destroy_model_parallel()
    return (out, grads) if with_grads else out


def run_trace(name: str, **kw) -> Dict[str, List[float]]:
    """The trace of config ``name``: :func:`trace_gpt`'s keywords, or for
    ``"gpt_3d"`` :func:`trace_gpt_3d`'s."""
    if name == "gpt_3d":
        return trace_gpt_3d(**kw)
    return trace_gpt(name, **kw)


def compare_traces(got: Dict[str, List[float]],
                   baseline: Dict[str, List[float]],
                   loss_rtol: float = 1e-4,
                   grad_rtol: float = 1e-3) -> List[str]:
    """Per-iteration diff; a list of mismatch descriptions (empty =
    pass), as the JAX package's ``compare_traces``.  The ``loss_scale``
    series, when either side has one, must match exactly: the scaler's
    decisions are discrete."""
    problems = []
    keys = [("loss", loss_rtol), ("grad_norm", grad_rtol)]
    if "loss_scale" in baseline or "loss_scale" in got:
        keys.append(("loss_scale", 0.0))
    for key, rtol in keys:
        a, b = got.get(key, []), baseline.get(key, [])
        if len(a) != len(b):
            problems.append(f"{key}: {len(a)} iters vs baseline {len(b)}")
            continue
        for i, (x, y) in enumerate(zip(a, b)):
            if not np.isclose(x, y, rtol=rtol, atol=1e-7):
                problems.append(
                    f"{key}[{i}]: {x!r} vs baseline {y!r} (rtol {rtol})")
    return problems
