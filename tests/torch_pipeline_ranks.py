"""Rank-side halves of the port's pipeline and 3D GPT parity tests
(``test_torch_pipeline.py``, ``test_torch_gpt_3d.py``).

Each entry runs on every rank of an eight-rank gloo group started by
:func:`apex_tpu_torch.parallel.launch.start_multiprocess`, takes numpy
inputs from the test, sets up each grid it needs, and returns numpy
results for the test to hold against the JAX package.  Torch and the port
only: the spawned ranks never import JAX.
"""

import numpy as np
import torch

from apex_tpu_torch import parallel
from apex_tpu_torch.amp import fp8
from apex_tpu_torch.amp._tree import tree_leaves, tree_map
from apex_tpu_torch.parallel import collectives as cc
from apex_tpu_torch.transformer import pipeline_parallel as pl
from apex_tpu_torch.transformer import tensor_parallel as tp
from apex_tpu_torch.transformer.pipeline_parallel import p2p_communication

# pipeline_apply's options per variant; "local" passes this rank's
# [vpp, 1, ...] slice with params_already_local
VARIANTS = {
    "flat": {},
    "no_remat": {"remat": False},
    "remat_ticks": {"remat_ticks": True},
    "remat_ticks3": {"remat_ticks": 3},
    "local": {"params_already_local": True},
    "shard": {"shard_microbatches": True},
}
P2P = ("recv_forward", "recv_backward", "send_forward", "send_backward",
       "send_forward_recv_forward", "send_backward_recv_backward")
P2P_PAIRS = ("send_forward_recv_backward", "send_backward_recv_forward",
             "send_forward_backward_recv_forward_backward")


def _np(tree):
    return tree_map(lambda t: None if t is None else t.detach().numpy(), tree)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def stage(p, xa):
    """A stage with a two-leaf activation: the layer's output and a running
    per-row sum riding beside it."""
    x, z = xa
    y = torch.tanh(x @ p["w"] + p["b"])
    return y, z + y.mean(-1)


def fb_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def fb_whole(p, x):
    for layer in range(p["w"].shape[0]):
        x = torch.tanh(x @ p["w"][layer] + p["b"][layer])
    return x


def fb_loss(out, target):
    return ((out - target) ** 2).mean()


def pipeline_checks(inputs):
    """Every pipeline, p2p and overlap check of the module; a dict."""
    out = {}
    for name, c in inputs["pipeline"].items():
        pp, vpp = c["pp"], c["vpp"]
        parallel.initialize_model_parallel(
            pipeline_model_parallel_size=pp,
            virtual_pipeline_model_parallel_size=vpp if vpp > 1 else None)
        for variant in VARIANTS:
            out[f"pipeline/{name}/{variant}"] = _pipeline_case(c, variant)
        parallel.destroy_model_parallel()

    parallel.initialize_model_parallel(pipeline_model_parallel_size=2,
                                       virtual_pipeline_model_parallel_size=2)
    out["schedules"] = _schedules(inputs["schedules"])
    parallel.destroy_model_parallel()

    mesh = parallel.initialize_model_parallel(pipeline_model_parallel_size=4)
    out["p2p"] = _p2p(inputs["p2p"], mesh.coords["dp"], mesh.coords["pp"])
    parallel.destroy_model_parallel()

    for size in (2, 4):
        mesh = parallel.initialize_model_parallel(size)
        d, t = mesh.coords["dp"], mesh.coords["tp"]
        c = inputs["overlap"][size]
        out[f"overlap/{size}"] = _overlap(c, d, t, size, None)
        if size == 2:
            metas = {k: fp8.Fp8Meta(_t(m["history"]), _t(m["scale"]))
                     for k, m in inputs["fp8_metas"].items()}
            out["overlap/fp8"] = _overlap(c, d, t, size, metas)
            out["overlap_layers"] = _overlap_layers(inputs["column_row"],
                                                    d, t)
        parallel.destroy_model_parallel()
    return out


def _pipeline_case(c, variant):
    pp, vpp = c["pp"], c["vpp"]
    s = cc.axis_index("pp")
    w, b = _t(c["w"], True), _t(c["b"], True)
    x, z = _t(c["x"], True), _t(c["z"], True)
    params = {"w": w, "b": b}
    if variant == "local":
        params = tree_map(
            lambda l: l.reshape((vpp, pp) + tuple(l.shape[1:]))[:, s:s + 1],
            params)
    cc.zero_counts()
    y, zo = pl.pipeline_apply(stage, params, (x, z), num_chunks=vpp,
                              **VARIANTS[variant])
    calls_fwd = cc.CALLS["ppermute"]
    ((y * _t(c["gy"])).sum() + (zo * _t(c["gz"])).sum()).backward()
    res = {"y": y, "z": zo, "dw": cc.all_reduce(w.grad, "pp"),
           "db": cc.all_reduce(b.grad, "pp"), "dx": x.grad, "dz": z.grad}
    if variant == "shard":          # each rank's rows' gradients
        res["dx"] = cc.all_reduce(x.grad, "pp")
        res["dz"] = cc.all_reduce(z.grad, "pp")
    res = _np(res)
    res["ppermute"] = (calls_fwd, cc.CALLS["ppermute"] - calls_fwd)
    return res


def _schedules(c):
    x, target = _t(c["x"]), _t(c["target"])
    w, b = _t(c["w"]), _t(c["b"])
    out = {}
    for name, (vpp, pp, fn_stage, params) in {
            "no_pipelining": (None, 1, fb_whole, {"w": w, "b": b}),
            "without_interleaving": (None, 2, fb_stage,
                                     {"w": w[:2], "b": b[:2]}),
            "with_interleaving": (2, 2, fb_stage, {"w": w, "b": b}),
    }.items():
        fn = pl.get_forward_backward_func(vpp, pp)
        losses, grads = fn(fn_stage, fb_loss, params, x, target,
                           loss_scale=c["loss_scale"])
        out[name] = _np({"losses": losses, "grads": grads})
    return out


def _p2p(c, d, s):
    x = _t(c["x"][d, s])
    ids = _t(c["ids"][d, s])
    g = _t(c["g"][d, s])
    out = {}
    for ring in (False, True):
        for name in P2P:
            out[f"{name}/{ring}"] = _np(getattr(p2p_communication, name)(
                {"a": x, "ids": ids}, ring=ring))
        for name in P2P_PAIRS:
            out[f"{name}/{ring}"] = _np(getattr(p2p_communication, name)(
                x, g, ring=ring))
        xg = x.clone().requires_grad_(True)
        got = p2p_communication.send_forward_recv_forward(xg, ring=ring)
        (got * g).sum().backward()
        out[f"grad/{ring}"] = xg.grad.numpy()
    return out


def _overlap(c, d, t, size, metas):
    """gather_matmul and matmul_scatter on this rank's blocks: output and
    the gradients of <y, g>; the calls each made."""
    res = {}
    for name, fn in (("gather", tp.gather_matmul),
                     ("scatter", tp.matmul_scatter)):
        k = c[name]
        sl, il, ol = (k["x"].shape[1] // size, k["x"].shape[-1] // size,
                      k["w"].shape[0] // size)
        if name == "gather":
            x = k["x"][d, t * sl:(t + 1) * sl]
            w = k["w"][t * ol:(t + 1) * ol]
            g = k["g"][d, ..., t * ol:(t + 1) * ol]
        else:
            x = k["x"][d, ..., t * il:(t + 1) * il]
            w = k["w"][:, t * il:(t + 1) * il]
            g = k["g"][d, t * sl:(t + 1) * sl]
        x, w = _t(x, True), _t(w, True)
        cc.zero_counts()
        y = fn(x, w, "tp", fp8_metas=metas)
        (y * _t(g)).sum().backward()
        res[name] = {**_np({"y": y, "dx": x.grad, "dw": w.grad}),
                     "calls": dict(cc.CALLS)}
    return res


def _overlap_layers(c, d, t):
    """ColumnParallelLinear then RowParallelLinear with sequence
    parallelism and ``overlap_comm``: the rings in both directions."""
    h, f = c["w1"].shape[1], c["w1"].shape[0]
    kw = dict(sequence_parallel=True, overlap_comm=True, axis="tp")
    col = tp.ColumnParallelLinear(h, f, **kw)
    row = tp.RowParallelLinear(f, h, **kw)
    fl, sl = f // 2, c["x"].shape[1] // 2
    with torch.no_grad():
        col.kernel.copy_(_t(c["w1"][t * fl:(t + 1) * fl]))
        col.bias.copy_(_t(c["b1"][t * fl:(t + 1) * fl]))
        row.kernel.copy_(_t(c["w2"][:, t * fl:(t + 1) * fl]))
        row.bias.copy_(_t(c["b2"]))
    x = _t(c["x"][d, t * sl:(t + 1) * sl], True)
    cc.zero_counts()
    y = row(torch.tanh(col(x)))
    y.backward(_t(c["g"][d, t * sl:(t + 1) * sl]))
    calls = dict(cc.CALLS)
    from apex_tpu_torch.transformer.layers import (
        allreduce_sequence_parallel_gradients,
    )

    allreduce_sequence_parallel_gradients(row, "tp")
    grads = {"w1": col.kernel.grad, "b1": col.bias.grad,
             "w2": row.kernel.grad, "b2": row.bias.grad}
    grads = {k: cc.all_reduce(v, "dp") for k, v in grads.items()}
    return {**_np({"y": y, "dx": x.grad, **grads}), "calls": calls}


# ------------------------------------------------------------- the 3D GPT


def gpt_3d_cases(params, tokens, packed, moe):
    """The ``gpt_3d`` trace with the first step's gradients; one guarded
    step with an injected overflow; the block-diagonal packed loss; and
    the MoE step (``moe``: its config's changes and JAX's weights) with
    its first gradients and three losses."""
    from apex_tpu_torch.amp.scaler import DynamicLossScale
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.resilience.sentinel import sentinel_init
    from apex_tpu_torch.testing import l1
    from apex_tpu_torch.transformer.testing.gpt_parallel_train import (
        build_gpt_3d,
    )
    from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
        TransformerConfig,
    )

    trace, grads = l1.trace_gpt_3d(params=params, tokens=tokens,
                                   device="cpu", with_grads=True)
    mesh = parallel.initialize_model_parallel(**l1.GPT_3D_GRID)
    out = {"trace": trace, "grads": _np(grads), "coords": mesh.coords}
    batch = parallel.dp_shard_batch(torch.from_numpy(tokens), axis="dp")
    kw = dict(num_chunks=l1.GPT_3D_CHUNKS,
              num_microbatches=l1.GPT_3D_MICROBATCHES, device="cpu")

    # an inf in one rank's gradient: every rank skips, bit for bit
    init_fn, _, make_train_step = build_gpt_3d(
        TransformerConfig(**l1.GPT_3D), **kw)
    local, specs = init_fn(params=params)
    opt = FusedAdam(tree_leaves(local), lr=1e-3)
    scaler = DynamicLossScale(init_scale=2.0 ** 8)
    victim = 5

    def tap(grads):
        if torch.distributed.get_rank() == victim:
            grads.layers["mlp"]["dense_4h_to_h"]["kernel"][0, 0, 0, 0] = \
                float("inf")
        return grads

    step = make_train_step(opt, specs, scaler=scaler, grad_tap=tap)
    sent = sentinel_init(scaler, device="cpu")
    before = [p.detach().clone() for p in tree_leaves(local)]
    sent, loss = step(local, batch, sent)
    same = all(torch.equal(a, b) for a, b in zip(before, tree_leaves(local)))
    clean = make_train_step(opt, specs, scaler=scaler)
    sent2, loss2 = clean(local, batch, sent)
    moved = not all(torch.equal(a, b)
                    for a, b in zip(before, tree_leaves(local)))
    out["overflow"] = {
        "loss": float(loss), "unchanged": same,
        "skipped": int(sent.skipped_steps), "scale": float(sent.scale),
        "skipped_after_clean": int(sent2.skipped_steps),
        "moved_after_clean": moved, "clean_loss": float(loss2),
        "group_step": [int(g["step"]) for g in opt.param_groups]}

    # block-diagonal attention over packed rows, on the flash core
    flash = TransformerConfig(**dict(l1.GPT_3D, use_flash_attention=True))
    for name, segs in packed.items():
        seg_batch = parallel.dp_shard_batch(torch.from_numpy(segs),
                                            axis="dp")
        init_fn, make_loss_fn, _ = build_gpt_3d(
            flash, packed_inputs=True, block_diagonal=True, **kw)
        local, specs = init_fn(params=params)
        out[f"packed/{name}"] = float(
            make_loss_fn(specs)(local, (batch, seg_batch)).detach())
    init_fn, make_loss_fn, _ = build_gpt_3d(flash, **kw)
    local, specs = init_fn(params=params)
    out["flash_plain"] = float(make_loss_fn(specs)(local, batch).detach())

    # Switch MoE, the experts split over dp
    init_fn, _, make_train_step = build_gpt_3d(
        TransformerConfig(**dict(l1.GPT_3D, **moe["config"])), **kw)
    local, specs = init_fn(params=moe["params"])
    step = make_train_step(FusedAdam(tree_leaves(local), lr=1e-3), specs)
    cc.zero_counts()
    losses = [float(step(local, batch))]
    grads = tree_map(lambda p: p.grad.detach().clone(), local)
    calls = dict(cc.CALLS)
    losses += [float(step(local, batch)) for _ in range(2)]
    out["moe"] = {"losses": losses, "grads": _np(grads), "calls": calls,
                  "w1": tuple(local.layers["mlp"]["w1"].shape),
                  "router_dtype": str(local.layers["mlp"]["router"].dtype)}
    parallel.destroy_model_parallel()
    return out
