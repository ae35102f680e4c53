"""Rank-side halves of the port's context-parallel and expert-parallel
parity tests (``test_torch_context_parallel.py``, ``test_torch_moe.py``).

Each entry runs on every rank of an eight-rank gloo group started by
:func:`apex_tpu_torch.parallel.launch.start_multiprocess`, takes numpy
inputs from the test, sets up the grid it needs, and returns numpy
results for the test to hold against the JAX package.  Torch and the port
only: the spawned ranks never import JAX.
"""

import numpy as np
import torch

from apex_tpu_torch import parallel
from apex_tpu_torch.amp._tree import tree_map
from apex_tpu_torch.parallel import collectives as cc

CP = 4


def _np(tree):
    return tree_map(lambda t: None if t is None else t.detach().numpy(), tree)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _seq_shard(a, c, n, dim=2):
    size = a.shape[dim] // n
    return np.take(a, range(c * size, (c + 1) * size), axis=dim)


def _attention_case(case, c):
    """One ring or Ulysses call on this rank's sequence shard: the output,
    the gradients of ``<out, w>``, and the collectives of each pass."""
    from apex_tpu_torch.transformer import context_parallel as cpl

    q, k, v = (_t(_seq_shard(case[n], c, CP), True) for n in "qkv")
    w = _t(_seq_shard(case["w"], c, CP))
    fn = cpl.ring_attention if case["impl"] == "ring" \
        else cpl.ulysses_attention
    kw = dict(case.get("kw", {}))
    cc.zero_counts()
    out = fn(q, k, v, "cp", case["causal"], **kw)
    fwd = dict(cc.CALLS)
    (out * w).sum().backward()
    bwd = {n: cc.CALLS[n] - fwd[n] for n in fwd}
    return {**_np({"out": out, "dq": q.grad, "dk": k.grad, "dv": v.grad}),
            "calls": (fwd, bwd)}


def _gpt_case(cfg_kw, params, tokens):
    """``build_gpt_cp``'s loss, this rank's masked per-token losses, the
    gradients after ``reduce_gradients``, and the step's collectives."""
    from apex_tpu_torch.transformer.testing.gpt_cp_train import build_gpt_cp
    from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
        TransformerConfig,
    )

    cfg = TransformerConfig(**cfg_kw)
    init_fn, make_loss_fn, _ = build_gpt_cp(cfg, device="cpu")
    local, specs = init_fn(params=params)
    loss_fn = make_loss_fn(specs)
    tokens = torch.from_numpy(tokens)
    cc.zero_counts()
    loss = loss_fn(local, tokens)
    loss.backward()
    loss_fn.reduce_gradients(local)
    calls = dict(cc.CALLS)
    with torch.no_grad():
        per_tok, mask = loss_fn.per_token(local, tokens)
    return {"loss": float(loss.detach()),
            "grads": _np(tree_map(lambda p: p.grad, local)),
            "per_tok": (per_tok * mask).numpy(), "mask": mask.numpy(),
            "calls": calls}


def _steps(cfg_kw, params, tokens, n):
    """``n`` FusedAdam steps of ``build_gpt_cp``'s train step."""
    from apex_tpu_torch.amp._tree import tree_leaves
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.transformer.testing.gpt_cp_train import build_gpt_cp
    from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
        TransformerConfig,
    )

    init_fn, _, make_train_step = build_gpt_cp(
        TransformerConfig(**cfg_kw), device="cpu")
    local, specs = init_fn(params=params)
    step = make_train_step(FusedAdam(tree_leaves(local), lr=2e-3), specs)
    return [float(step(local, torch.from_numpy(tokens))) for _ in range(n)]


def context_cases(inputs):
    """Every rank-side check of the context-parallel module on the
    ``dp2 x cp4`` grid; a dict."""
    mesh = parallel.initialize_model_parallel(context_parallel_size=CP)
    c = mesh.coords["cp"]
    out = {"coords": mesh.coords}
    for name, case in inputs["attention"].items():
        out[f"attention/{name}"] = _attention_case(case, c)
    for name, (cfg_kw, params) in inputs["gpt"].items():
        out[f"gpt/{name}"] = _gpt_case(cfg_kw, params, inputs["tokens"])
    cfg_kw, params = inputs["gpt"]["ring"]
    out["trains"] = _steps(cfg_kw, params, inputs["tokens"], 6)
    parallel.destroy_model_parallel()
    return out


# ----------------------------------------------------- expert parallelism


def expert_parallel_case(inputs):
    """``SwitchMLP`` with its eight experts over an eight-rank ``cp`` axis
    (one expert a rank) on this rank's batch columns: the output, the
    gradients of ``sum(y ** 2)``, the collectives of each pass, and the
    local shapes and first draws of the rank-folded init."""
    from apex_tpu_torch.transformer.moe import SwitchMLP

    mesh = parallel.initialize_model_parallel(context_parallel_size=8)
    c = mesh.coords["cp"]
    p = inputs["params"]
    H, FFN = p["w1"].shape[1:]
    x_all = inputs["x"]
    cols = x_all.shape[1] // 8
    x = _t(x_all[:, c * cols:(c + 1) * cols], True)
    kw = dict(capacity_factor=8.0, device="cpu")
    ep = SwitchMLP(H, FFN, 8, expert_axis="cp", seed=4, **kw)
    drawn = {n: getattr(ep, n).detach().clone() for n in ("router", "w1")}
    with torch.no_grad():
        ep.router.copy_(_t(p["router"]))
        for n in ("w1", "b1", "w2", "b2"):
            getattr(ep, n).copy_(_t(p[n][c:c + 1]))
    cc.zero_counts()
    y, aux = ep(x)
    fwd = dict(cc.CALLS)
    (y ** 2).sum().backward()
    bwd = {n: cc.CALLS[n] - fwd[n] for n in fwd}
    res = {"y": y, "aux": aux, "dx": x.grad,
           **{f"d{n}": getattr(ep, n).grad
              for n in ("router", "w1", "b1", "w2", "b2")}}
    out = {**_np(res), "calls": (fwd, bwd), "shapes": {
        n: tuple(getattr(ep, n).shape) for n in ("w1", "b2")},
        "drawn": _np(drawn)}
    parallel.destroy_model_parallel()
    return out

