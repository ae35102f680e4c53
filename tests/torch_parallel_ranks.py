"""Rank-side halves of the port's tensor-, sequence- and data-parallel
parity tests (``test_torch_tensor_parallel.py``,
``test_torch_gpt_parallel.py``).

Each function here runs on every rank of a gloo group started by
:func:`apex_tpu_torch.parallel.launch.run_multiprocess`, takes numpy
inputs from the test, and returns numpy results for the test to hold
against the JAX package.  This module imports torch and the port only:
the spawned ranks never import JAX.
"""

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch import parallel
from apex_tpu_torch.amp import fp8
from apex_tpu_torch.amp.scaler import all_finite
from apex_tpu_torch.parallel import collectives as cc
from apex_tpu_torch.parallel import mesh
from apex_tpu_torch.transformer import tensor_parallel as tp
from apex_tpu_torch.transformer.amp import GradScaler
from apex_tpu_torch.transformer.layers import (
    allreduce_sequence_parallel_gradients,
)

DP = ("dcn", "dp")

# mapping name -> (port function, input sharded over tp, cotangent
# sharded over tp)
MAPPINGS = {
    "copy": (tp.copy_to_tensor_model_parallel_region, False, True),
    "reduce": (tp.reduce_from_tensor_model_parallel_region, True, False),
    "scatter_last": (tp.scatter_to_tensor_model_parallel_region, False, True),
    "gather_last": (tp.gather_from_tensor_model_parallel_region, True, False),
    "scatter_first": (tp.scatter_to_sequence_parallel_region, False, True),
    "gather_first_partial": (
        lambda x, axis: tp.gather_from_sequence_parallel_region(x, axis, True),
        True, True),
    "gather_first_whole": (
        lambda x, axis: tp.gather_from_sequence_parallel_region(x, axis,
                                                                False),
        True, False),
    "reduce_scatter": (tp.reduce_scatter_to_sequence_parallel_region, True,
                       True),
}


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return {f: _np(v) for f, v in zip(tree._fields, tree)}
    if tree is None:
        return None
    return tree.detach().float().numpy()


def _pick(a, d, t, sharded):
    return torch.from_numpy(np.array(a[d, t] if sharded else a[d]))


def _grad(fn, x, g):
    x = x.clone().requires_grad_(True)
    y = fn(x)
    y.backward(g)
    return y.detach().numpy(), x.grad.numpy()


def module_checks(inputs):
    """Every module-level check on a dp2 x tp2 grid; a dict of results."""
    mesh_ = parallel.initialize_model_parallel(2)
    d, t = mesh_.coords["dp"], mesh_.coords["tp"]
    out = {"coords": (d, t), "rank": dist.get_rank()}

    for name, (fn, x_sh, g_sh) in MAPPINGS.items():
        x = _pick(inputs[name]["x"], d, t, x_sh)
        g = _pick(inputs[name]["g"], d, t, g_sh)
        out[f"map/{name}"] = _grad(lambda v: fn(v, "tp"), x, g)

    for s in (0.0, 0.1):
        c = inputs["xent"]
        v_local = c["logits"].shape[-1] // 2
        logits = torch.from_numpy(
            c["logits"][d, :, t * v_local:(t + 1) * v_local].copy())
        out[f"xent/{s}"] = _grad(
            lambda v: tp.vocab_parallel_cross_entropy(
                v, torch.from_numpy(c["target"][d]), "tp", s),
            logits, torch.from_numpy(c["g"][d]))

    out["embedding"] = _embedding(inputs["embedding"], d, t)
    for sp in (False, True):
        out[f"column_row/sp={sp}"] = _column_row(inputs["column_row"], d, t,
                                                 sp)
    out["sp_grads_dict"] = _np(allreduce_sequence_parallel_gradients(
        {k: {kk: torch.from_numpy(vv[d, t]) for kk, vv in v.items()}
         for k, v in inputs["sp_grads"].items()}, "tp"))

    data = {"text": torch.from_numpy(inputs["broadcast"][d, t])}
    out["broadcast"] = tp.broadcast_data(["text"], data, torch.int32,
                                         "tp")["text"].numpy()

    gen = tp.model_parallel_seed(1234)
    init = tp.parallel_init(lambda v, g: v.normal_(generator=g), "tp")
    out["rng"] = {
        "model": torch.rand(4, generator=tp.get_rng_states_tracker().fork()
                            ).numpy(),
        "default": torch.rand(4, generator=gen).numpy(),
        "dp_seed": tp.data_parallel_rng_key(1234, DP),
        "parallel_init": init(torch.empty(3), gen).numpy(),
    }
    out["dp_step"] = _dp_step(inputs["dp_step"])

    m = inputs["meta"]
    meta = fp8.Fp8Meta(torch.from_numpy(m["history"].copy()),
                       torch.tensor(m["scale"]))
    new = fp8.update_meta(meta, float(m["amax"][d, t]), fp8.E4M3, axis="tp")
    out["update_meta"] = (new.amax_history.numpy(), new.scale.numpy())

    out["grad_scaler"] = _grad_scaler(inputs["scaler"], d, t)
    out["fp8_linears"] = _fp8_linears(inputs["column_row"], d, t)

    grads = {k: torch.from_numpy(v[d, t]) for k, v in inputs["ddp"].items()}
    for avg in (True, False):
        out[f"all_reduce_gradients/avg={avg}"] = _np(
            parallel.all_reduce_gradients(grads, "dp", gradient_average=avg,
                                          gradient_predivide_factor=2.0))

    out["collectives"] = _collectives(inputs["collectives"], d, t)
    parallel.destroy_model_parallel()
    return out


def _embedding(c, d, t):
    emb = tp.VocabParallelEmbedding(*c["table"].shape, axis="tp")
    v_local = c["table"].shape[0] // 2
    with torch.no_grad():
        emb.embedding.copy_(torch.from_numpy(
            c["table"][t * v_local:(t + 1) * v_local]))
    y = emb(torch.from_numpy(c["tokens"][d]))
    y.backward(torch.from_numpy(c["g"][d]))
    # the table's gradient over the whole batch: summed over the replicas
    return y.detach().numpy(), cc.all_reduce(emb.embedding.grad, "dp").numpy()


def _column_row(c, d, t, sp):
    h, f = c["w1"].shape[1], c["w1"].shape[0]
    col = tp.ColumnParallelLinear(h, f, sequence_parallel=sp, axis="tp")
    row = tp.RowParallelLinear(f, h, sequence_parallel=sp, axis="tp")
    fl, hl = f // 2, c["x"].shape[1] // 2
    with torch.no_grad():
        col.kernel.copy_(torch.from_numpy(c["w1"][t * fl:(t + 1) * fl]))
        col.bias.copy_(torch.from_numpy(c["b1"][t * fl:(t + 1) * fl]))
        row.kernel.copy_(torch.from_numpy(c["w2"][:, t * fl:(t + 1) * fl]))
        row.bias.copy_(torch.from_numpy(c["b2"]))
    x = torch.from_numpy(c["x"][d])
    g = torch.from_numpy(c["g"][d])
    if sp:
        x = x[t * hl:(t + 1) * hl]
        g = g[t * hl:(t + 1) * hl]
    x = x.clone().requires_grad_(True)
    y = row(torch.tanh(col(x)))
    y.backward(g)
    partial_b2 = row.bias.grad.clone()
    allreduce_sequence_parallel_gradients(row, "tp")
    grads = {"w1": col.kernel.grad, "b1": col.bias.grad,
             "w2": row.kernel.grad, "b2": row.bias.grad}
    grads = {k: cc.all_reduce(v, "dp") for k, v in grads.items()}
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(),
            "b2_marked": bool(getattr(row.bias, "sequence_parallel", False)),
            "b2_partial": cc.all_reduce(partial_b2, "dp").numpy(),
            **_np(grads)}


def _dp_step(c):
    """Two ``data_parallel_train_step`` steps (FusedAdam, two microbatches)
    of a linear least-squares model on this rank's slice of the batch."""
    from apex_tpu_torch.optimizers import FusedAdam

    w = torch.nn.Parameter(torch.from_numpy(c["w"].copy()))
    b = torch.nn.Parameter(torch.from_numpy(c["b"].copy()))
    batch = parallel.dp_shard_batch({k: torch.from_numpy(c[k])
                                     for k in ("x", "y")})

    def loss_fn(mb):
        return ((mb["x"] @ w.t() + b - mb["y"]) ** 2).mean()

    step = parallel.data_parallel_train_step(
        loss_fn, FusedAdam([w, b], lr=1e-2), microbatches=2)
    losses = [float(step(batch)) for _ in range(2)]
    return {"losses": losses, "w": w.detach().numpy(),
            "b": b.detach().numpy(), "rows": batch["x"].shape[0],
            "host_dp_ranks": parallel.host_dp_ranks()}


def _fp8_linears(c, d, t):
    """fp8 Column then Row at tp 2, two training-mode forwards: the second
    output and both layers' metas after two rolls, each amax the MAX over
    the tensor axis."""
    h, f = c["w1"].shape[1], c["w1"].shape[0]
    col = tp.ColumnParallelLinear(h, f, axis="tp", fp8=True)
    row = tp.RowParallelLinear(f, h, axis="tp", fp8=True)
    fl = f // 2
    with torch.no_grad():
        col.kernel.copy_(torch.from_numpy(c["w1"][t * fl:(t + 1) * fl]))
        col.bias.copy_(torch.from_numpy(c["b1"][t * fl:(t + 1) * fl]))
        row.kernel.copy_(torch.from_numpy(c["w2"][:, t * fl:(t + 1) * fl]))
        row.bias.copy_(torch.from_numpy(c["b2"]))
    x = torch.from_numpy(c["x"][d])
    for _ in range(2):
        y = row(torch.tanh(col(x)))
    metas = {name: {k: (getattr(layer.fp8_meta, k).amax_history.numpy(),
                        getattr(layer.fp8_meta, k).scale.numpy())
                    for k in ("x", "w")}
             for name, layer in (("col", col), ("row", row))}
    return {"y": y.detach().numpy(), "metas": metas}


def _grad_scaler(c, d, t):
    """An inf in one rank's shard of a tensor-parallel gradient: the data
    reduction carries it to that shard's other replica, and the scaler's
    agreement over tp to every rank."""
    grads = {k: torch.from_numpy(v[d, t].copy()) for k, v in c.items()}
    if (d, t) == (1, 1):
        grads["w"][0] = float("inf")
    grads = parallel.all_reduce_gradients(grads, DP)
    scaler = GradScaler()
    return {"local": bool(all_finite(list(grads.values()))),
            "agreed": bool(scaler.all_finite(list(grads.values()))),
            "agreed_clean": bool(scaler.all_finite(
                [torch.from_numpy(v[d, t]) for v in c.values()]))}


def _collectives(c, d, t):
    x = torch.from_numpy(c["x"][d, t])
    both = ("dp", "tp")
    return {
        "all_reduce/sum": cc.all_reduce(x, both, "sum").numpy(),
        "all_reduce/mean": cc.all_reduce(x, both, "mean").numpy(),
        "all_reduce/max": cc.all_reduce(x, "tp", "max").numpy(),
        "all_reduce/min": cc.all_reduce(x, "dp", "min").numpy(),
        "all_gather/tiled": cc.all_gather(x, both, concat_axis=1).numpy(),
        "all_gather/stacked": cc.all_gather(x, "tp", concat_axis=0,
                                            tiled=False).numpy(),
        "reduce_scatter": cc.reduce_scatter(x, both, scatter_axis=0).numpy(),
        "broadcast": cc.broadcast(x, both, root=3).numpy(),
        "ppermute": cc.ppermute(x, both, [(0, 2), (2, 1), (1, 0)]).numpy(),
        "send_recv_next": cc.send_recv_next(x, both).numpy(),
        "send_recv_prev": cc.send_recv_prev(x, "dp").numpy(),
        "all_to_all": cc.all_to_all(x, both, split_axis=0,
                                    concat_axis=1).numpy(),
        "axis_index": np.array([cc.axis_index(both), cc.axis_index("dp"),
                                cc.axis_index("tp")]),
        "axis_size": np.array([cc.axis_size(both), cc.axis_size("dp"),
                               cc.axis_size("tp"), cc.axis_size("pp")]),
    }


def gpt_cases(cases, tokens, steps):
    """Each case's GPT trained ``steps`` FusedAdam steps on ``tokens``
    through its grid: the dp-mean losses and the first step's gradients
    (this rank's shards, after the sequence-parallel and data-parallel
    reductions).  A case with ``"raises"`` only builds its model and
    reports the exception."""
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.serving.bridge import from_flax_gpt
    from apex_tpu_torch.testing.l1 import parallel_train_step
    from apex_tpu_torch.transformer.testing.standalone_gpt import GPTModel
    from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
        TransformerConfig,
    )

    results = []
    for case in cases:
        grid = parallel.initialize_model_parallel(case["tp"])
        cfg = TransformerConfig(**case["config"])
        if case.get("raises"):
            try:
                GPTModel(cfg, device="cpu")
                results.append(None)
            except Exception as e:  # noqa: BLE001 - reported to the test
                results.append(f"{type(e).__name__}: {e}")
            parallel.destroy_model_parallel()
            continue
        params = from_flax_gpt(case["params"])
        local = tp.shard_params(params, tp.infer_param_specs(params),
                                grid.coords["tp"], case["tp"])
        model = GPTModel(cfg, device="cpu")
        model.load_params(local)
        ddp = parallel.DistributedDataParallel(model)
        batch = parallel.dp_shard_batch(torch.from_numpy(tokens))
        opt = FusedAdam(model.parameters(), lr=1e-3)
        cc.zero_counts()
        losses, grads = [], None
        for step in range(steps):
            if step == 1:
                # the first step's gradients, as the optimizer took them
                grads = _np(model.export_params(grads=True))
            loss = parallel_train_step(ddp, opt, batch)
            losses.append(float(cc.all_reduce(loss, DP, "mean")))
        if steps == 1:
            grads = _np(model.export_params(grads=True))
        results.append({"losses": losses, "grads": grads,
                        "calls": dict(cc.CALLS), "coords": grid.coords})
        parallel.destroy_model_parallel()
    return results


def hang(seconds):
    """A rank that never answers in time (the launcher's deadline)."""
    import time

    time.sleep(seconds)


def fail_on_rank_one():
    """A rank that raises (the launcher's error report)."""
    if dist.get_rank() == 1:
        raise ValueError("rank one fails on purpose")
    return mesh.model_parallel_is_initialized()
