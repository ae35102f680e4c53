"""L1-style training traces (port of :mod:`apex_tpu.testing.l1`).

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
``_trace_rn50`` composes it (:func:`scaled_step` is that composition
after the loss); :func:`apply_policy` casts a module's parameters by an
amp policy.

:func:`trace_rn50` is the JAX ``_trace_rn50``: ResNet-50 with 10 classes
on one fixed batch of 8 images of 32 x 32 (numpy's ``RandomState(0)``,
as the JAX trace draws them), ten steps of FusedSGD (lr 0.005, momentum
0.9, weight decay 1e-4) or FusedLAMB (lr 1e-3, weight decay 1e-2), under
an amp policy (O0, O2, O3) and a loss scale (none, static 128, dynamic
from 2**10 growing every 4 steps), with local BN or SyncBatchNorm over
the data-parallel ranks (eight ranks, one image each, the loss and the
gradients averaged over them); ``RN50_CONFIGS`` holds the eight
``rn50_*`` cells.  Each step runs the forward in train mode (the running
statistics move even on a skipped step, as the JAX step returns its new
``batch_stats`` regardless), the mean of -log-softmax at the labels, the
scaled backward, the overflow check, the optimizer's step with the skip
and the scaler's update, and records the loss, the global norm of the
gradients unscaled by the scale before the update, and the scale.
:class:`RN50Trainer` is that loop one step at a time, with
:meth:`~RN50Trainer.snapshot` / :meth:`~RN50Trainer.restore` of the whole
training state (parameters, BN statistics, optimizer state, step count,
scaler), so that a step can be replayed from another run's state.

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
from apex_tpu_torch.amp.policy import policy as amp_policy
from apex_tpu_torch.amp.scaler import (
    DynamicLossScale,
    LossScaleState,
    StaticLossScale,
    all_finite,
)
from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB, FusedSGD
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
           "parallel_train_step", "amp_train_step", "scaled_step",
           "apply_policy", "global_grad_norm", "compare_traces",
           "RN50_CONFIGS", "RN50Trainer", "rn50_batch", "make_scaler",
           "trace_rn50"]

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


def scaled_step(loss: torch.Tensor, params, opt, scaler=None,
                state: Optional[LossScaleState] = None, *,
                reduce_grads=None):
    """The step after the loss: the backward of the loss (times the scale
    with a ``scaler``), ``reduce_grads()`` where given (the data-parallel
    average of the ``.grad``), then with a scaler the overflow check over
    every gradient (``all_finite``), ``opt.step`` with the gradients
    divided by the scale and the update skipped on overflow, and the
    scaler's update; without one a plain ``opt.step()``.  All on the
    device, with no host sync.  Returns ``(grad_norm, new_state)``: the
    global norm of the gradients unscaled by the scale before the update
    (not finite on an overflow step), and the next scaler state (``None``
    without a scaler)."""
    (loss if scaler is None else scaler.scale(loss, state)).backward()
    if reduce_grads is not None:
        reduce_grads()
    grads = [p.grad for p in params if p.grad is not None]
    if scaler is None:
        grad_norm = _norm(grads)
        opt.step()
        return grad_norm, None
    finite = all_finite(grads)
    grad_norm = _norm(scaler.unscale(grads, state))
    opt.step(grad_scale=state.scale, skip_update=~finite)
    return grad_norm, scaler.update(state, finite)


def amp_train_step(model: GPTModel, opt: FusedAdam, tokens, scaler,
                   state: LossScaleState,
                   generator: Optional[torch.Generator] = None):
    """One loss-scaled GPT step: :func:`scaled_step` on the mean
    next-token loss.  Returns ``(loss, grad_norm, new_state)``: the
    unscaled loss, the global norm of the unscaled gradients (not finite
    on an overflow step) and the next scaler state."""
    opt.zero_grad(set_to_none=True)
    loss = model(tokens, labels=tokens, generator=generator).mean()
    grad_norm, state = scaled_step(loss, list(model.parameters()), opt,
                                   scaler, state)
    return loss.detach(), grad_norm, state


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


# the JAX package's _trace_rn50 cells: (policy, loss scale, SyncBN, optimizer)
RN50_CONFIGS = {
    "rn50_smoke": ("O2", None, False, "sgd"),
    "rn50_O0": ("O0", None, False, "sgd"),
    "rn50_O2_static128": ("O2", 128.0, False, "sgd"),
    "rn50_O2_dynamic": ("O2", "dynamic", False, "sgd"),
    "rn50_O3": ("O3", None, False, "sgd"),
    "rn50_O2_syncbn": ("O2", None, True, "sgd"),
    "rn50_O2_dynamic_syncbn": ("O2", "dynamic", True, "sgd"),
    "rn50_O2_lamb": ("O2", None, False, "lamb"),
}
RN50_CLASSES = 10


def rn50_batch():
    """The JAX trace's batch as numpy: images ``[8, 32, 32, 3]`` (NHWC,
    fp32) and labels ``[8]``, from ``RandomState(0)``."""
    rng = np.random.RandomState(0)
    x = rng.randn(8, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, RN50_CLASSES, size=(8,))
    return x, y


def make_scaler(kind):
    """The trace's scaler: ``None``, ``"dynamic"`` (from 2**10, growing
    every 4 clean steps, so the ten steps see two growths) or a static
    scale."""
    if kind is None:
        return None
    if kind == "dynamic":
        return DynamicLossScale(init_scale=2.0 ** 10, growth_interval=4)
    return StaticLossScale(float(kind))


class RN50Trainer:
    """One ``rn50_*`` cell, a step at a time (``name``: a key of
    ``RN50_CONFIGS``, or such a ``(policy, loss scale, SyncBN,
    optimizer)`` tuple).

    ``variables``: the Flax model's ``{"params", "batch_stats"}`` (numpy)
    to start from (via :func:`~apex_tpu_torch.models.resnet.
    from_flax_resnet`), else the port's seeded weights (``seed``).  With
    SyncBN the caller is one rank of a ``torch.distributed`` job: the
    model's BN layers synchronize over ``"dp"`` and the gradients are
    averaged over it by :class:`~apex_tpu_torch.parallel.
    DistributedDataParallel` (the rank grid must be set up first)."""

    def __init__(self, name: str, *, variables=None, seed: int = 0,
                 device=None, num_classes: int = RN50_CLASSES,
                 optimizer_kw: Optional[dict] = None):
        from apex_tpu_torch.models.resnet import ResNet50, from_flax_resnet
        from apex_tpu_torch.parallel import DistributedDataParallel

        policy_name, loss_scale, self.sync_bn, optimizer = (
            RN50_CONFIGS[name] if isinstance(name, str) else name)
        self.device = resolve_device(device)
        self.policy = amp_policy(policy_name)
        self.model = ResNet50(num_classes=num_classes,
                              axis_name="dp" if self.sync_bn else None,
                              dtype=self.policy.compute_dtype,
                              device=self.device, seed=seed)
        if variables is not None:
            self.model.load_state_dict(from_flax_resnet(variables))
        apply_policy(self.model, self.policy)
        self.model.to(memory_format=torch.channels_last)
        self.ddp = (DistributedDataParallel(self.model) if self.sync_bn
                    else None)
        params = list(self.model.parameters())
        master = self.policy.master_weights
        if optimizer == "lamb":
            self.opt = FusedLAMB(params, **{**dict(
                lr=1e-3, weight_decay=1e-2, master_weights=master),
                **(optimizer_kw or {})})
        elif optimizer == "sgd":
            self.opt = FusedSGD(params, **{**dict(
                lr=0.005, momentum=0.9, weight_decay=1e-4,
                master_weights=master), **(optimizer_kw or {})})
        else:
            raise ValueError(f"unknown optimizer {optimizer!r}")
        self.scaler = make_scaler(loss_scale)
        self.sstate = (self.scaler.init(self.device) if self.scaler
                       else None)

    def images(self, x_nhwc) -> torch.Tensor:
        """NHWC numpy or tensor images as the model's ``[N, C, H, W]``
        channels-last input on the device, fp32."""
        x = torch.as_tensor(x_nhwc, dtype=torch.float32, device=self.device)
        return x.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)

    def step(self, x: torch.Tensor, y: torch.Tensor):
        """One training step on images ``x`` (from :meth:`images`) and
        labels ``y``; returns ``(loss, grad_norm)`` as device tensors (the
        loss averaged over the data-parallel ranks with SyncBN)."""
        from apex_tpu_torch.parallel import collectives as cc

        self.model.train()
        self.opt.zero_grad(set_to_none=True)
        logits = (self.ddp or self.model)(self.policy.cast_to_compute(x))
        logp = torch.log_softmax(logits, dim=-1)
        loss = -logp[torch.arange(y.shape[0], device=y.device), y].mean()
        reduce = self.ddp.reduce_gradients if self.ddp else None
        grad_norm, self.sstate = scaled_step(
            loss, self.model.parameters(), self.opt, self.scaler, self.sstate,
            reduce_grads=reduce)
        loss = loss.detach()
        if self.sync_bn:
            loss = cc.all_reduce(loss, "dp", "mean")
        return loss, grad_norm

    @torch.no_grad()
    def snapshot(self) -> dict:
        """The whole training state, copied to the CPU: ``model`` (the
        state dict: parameters and BN statistics), ``opt`` (the
        optimizer's ``opt_state`` over the parameters by name) and
        ``scaler`` (a ``LossScaleState`` or ``None``)."""
        from apex_tpu_torch.amp._tree import tree_map

        cpu = lambda t: (  # noqa: E731
            None if t is None else t.detach().to("cpu", copy=True))
        opt = self.opt.opt_state(dict(self.model.named_parameters()))
        return {
            "model": {k: cpu(v) for k, v in self.model.state_dict().items()},
            "opt": tree_map(cpu, opt),
            "scaler": tree_map(cpu, self.sstate),
        }

    @torch.no_grad()
    def restore(self, snap: dict) -> None:
        """Load a :meth:`snapshot` (from any device).  Its ``opt`` may be
        ``None``, which keeps the optimizer's state, and its masters are
        taken only where this trainer keeps them; the step count becomes
        a device tensor where a scaler skips steps, a host int otherwise,
        as this trainer's own run holds it."""
        self.model.load_state_dict(snap["model"])
        if snap["opt"] is not None:
            self.opt.load_opt_state(dict(self.model.named_parameters()),
                                    snap["opt"],
                                    step_on_device=bool(self.scaler))
        if snap["scaler"] is not None:
            self.sstate = LossScaleState(*(
                torch.as_tensor(t).to(self.device) for t in snap["scaler"]))


def trace_rn50(policy: str = "O2", loss_scale=None, sync_bn: bool = False,
               optimizer: str = "sgd", *, variables=None, seed: int = 0,
               device=None, snapshots: bool = False):
    """``{"loss", "grad_norm"[, "loss_scale"]}`` over ``ITERS`` steps of
    one RN50 cell (the JAX ``_trace_rn50``'s arguments: the amp policy's
    name, the loss scale, SyncBN, ``"sgd"`` or ``"lamb"``; see
    :class:`RN50Trainer`); with ``snapshots`` the result is ``(trace,
    states)``, ``states[i]`` the :meth:`RN50Trainer.snapshot` before step
    ``i``.  A SyncBN cell runs on every rank of an eight-rank job (each
    calls this; it sets up the rank grid and takes it down), each rank on
    its image."""
    from apex_tpu_torch import parallel

    if sync_bn:
        parallel.initialize_model_parallel()
    try:
        tr = RN50Trainer((policy, loss_scale, sync_bn, optimizer),
                         variables=variables, seed=seed, device=device)
        x_np, y_np = rn50_batch()
        x, y = tr.images(x_np), torch.as_tensor(y_np, device=tr.device)
        if sync_bn:
            x, y = parallel.dp_shard_batch((x, y), axis="dp")
        out: Dict[str, List[float]] = {"loss": [], "grad_norm": []}
        if tr.scaler:
            out["loss_scale"] = []
        states = []
        for _ in range(ITERS):
            if snapshots:
                states.append(tr.snapshot())
            loss, grad_norm = tr.step(x, y)
            out["loss"].append(float(loss))
            out["grad_norm"].append(float(grad_norm))
            if tr.scaler:
                out["loss_scale"].append(float(tr.sstate.scale))
    finally:
        if sync_bn:
            parallel.destroy_model_parallel()
    return (out, states) if snapshots else out


def run_trace(name: str, **kw) -> Dict[str, List[float]]:
    """The trace of config ``name``: :func:`trace_gpt`'s keywords, for
    ``"gpt_3d"`` :func:`trace_gpt_3d`'s, for an ``rn50_*`` cell
    :func:`trace_rn50`'s."""
    if name == "gpt_3d":
        return trace_gpt_3d(**kw)
    if name in RN50_CONFIGS:
        return trace_rn50(*RN50_CONFIGS[name], **kw)
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
