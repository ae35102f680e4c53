"""Rank-side half of ``test_torch_zero.py``: the ZeRO optimizers, the
hierarchical collectives, the ZeRO train step and the example on gloo
ranks.

Runs on every rank of a four-rank group started by
:func:`apex_tpu_torch.parallel.launch.start_multiprocess`: first on a
dp 4 grid, then on a dcn 2 x dp 2 grid; torch and the port only.
"""

import torch

from apex_tpu_torch import parallel
from apex_tpu_torch.parallel import collectives as cc

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy().copy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_np(v) for v in x) if not hasattr(x, "_fields") \
            else {f: _np(getattr(x, f)) for f in x._fields}
    return x


def make_params(case):
    return {k: torch.from_numpy(v).to(DTYPES[case["dtypes"].get(k, "float32")])
            .requires_grad_() for k, v in case["params"].items()}


def make_opt(case, params):
    from apex_tpu_torch.amp._tree import tree_leaves
    from apex_tpu_torch.contrib.optimizers import (
        DistributedFusedAdam,
        DistributedFusedLAMB,
    )

    cls = {"adam": DistributedFusedAdam, "lamb": DistributedFusedLAMB}
    kw = dict(case["kw"])
    if "dcn_reduce_dtype" in kw:
        kw["dcn_reduce_dtype"] = DTYPES[kw["dcn_reduce_dtype"]]
    return cls[case["opt"]](tree_leaves(params), **kw)


def run_case(case, rank):
    """``case["steps"]`` steps on this rank's gradients; the final
    parameters and this rank's state."""
    params = make_params(case)
    opt = make_opt(case, params)
    grads = case["grads"][rank]
    step_kw = {k: torch.tensor(v) for k, v in case["step_kw"].items()}
    for _ in range(case["steps"]):
        for k, p in params.items():
            p.grad = torch.from_numpy(grads[k]).to(p.dtype)
        opt.step(**step_kw)
    return {"params": _np(params), "state": _np(opt.opt_state(params)),
            "dtypes": {k: str(p.dtype) for k, p in params.items()}}


def _regression(w0, X, Y, kind, microbatches):
    """Five steps of the ZeRO step (or of ``data_parallel_train_step`` +
    FusedAdam for ``kind="dp"``) on a least-squares fit; the final
    weight and the losses."""
    from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam
    from apex_tpu_torch.optimizers import FusedAdam

    w = torch.from_numpy(w0.copy()).requires_grad_()
    batch = parallel.dp_shard_batch((torch.from_numpy(X),
                                     torch.from_numpy(Y)))

    def loss_fn(b):
        x, y = b
        return torch.mean((x @ w - y) ** 2)

    if kind == "dp":
        step = parallel.data_parallel_train_step(loss_fn, FusedAdam([w], lr=0.05))
    else:
        opt = DistributedFusedAdam([w], lr=0.05)
        parallel.zero_init(opt, [w])
        step = parallel.zero_data_parallel_train_step(
            loss_fn, opt, microbatches=microbatches)
    losses = [float(step(batch)) for _ in range(5)]
    return {"w": _np(w), "losses": losses}


def _primitives_dp4():
    """The outer hop of a hierarchical reduce-scatter on one slice (dcn
    of size 1) is skipped: one reduce-scatter, no all-reduce."""
    cc.zero_counts()
    x = torch.ones(8, 16)
    shard = cc.hierarchical_reduce_scatter(x[0], "dp", "dcn")
    return {"shard": _np(shard), "calls": dict(cc.CALLS)}


def _primitives_2x2(rank):
    """The hierarchical pair against the flat reduce-scatter over (dcn,
    dp), and the tile order of the flat rank."""
    from apex_tpu_torch.contrib.optimizers import _flat_bucket as fb

    x = torch.arange(4 * 32, dtype=torch.float32).reshape(4, 32)
    mine = x[rank]
    hier = cc.hierarchical_all_gather(
        cc.hierarchical_reduce_scatter(mine, "dp", "dcn"), "dp")
    flat = cc.all_gather(cc.hierarchical_reduce_scatter(
        mine, ("dcn", "dp"), None), ("dcn", "dp"))
    # only rank 0 contributes: the reduce-scatter's tile is this rank's
    # rows of the buffer, which local_slices must name with flat_rank
    params = [torch.zeros(700), torch.zeros(300)]
    tiles = {}
    for name, axis, outer in (("flat", ("dcn", "dp"), None),
                              ("hier", "dp", "dcn")):
        cfg = fb.resolve_axes(axis, outer)
        lay = fb.build_layout(params, world=cfg.world_scatter, n_buckets=2,
                              chunk=16)
        group = lay.groups[0]
        buf = torch.arange(group.rows * 16, dtype=torch.float32).reshape(
            group.rows, 16)
        got = fb.bucket_reduce_scatter(buf if rank == 0 else buf * 0,
                                       group, cfg, 2)
        want = fb.local_slices(buf, group, 2, fb.flat_rank(cfg))
        tiles[name] = {"rank": fb.flat_rank(cfg),
                       "equal": all(torch.equal(a, b)
                                    for a, b in zip(got, want))}
    return {"hier": _np(hier), "flat": _np(flat), "tiles": tiles}


def zero_cases(dp4_cases, hier_cases, regression):
    """Every case on the dp 4 grid, then on the dcn 2 x dp 2 grid: each
    rank's results by case name."""
    out = {}
    parallel.initialize_model_parallel()
    rank = cc.axis_index(("dcn", "dp"))
    out["prim_dp4"] = _primitives_dp4()
    for case in dp4_cases:
        out[case["name"]] = run_case(case, rank)
    w0, X, Y = regression
    for kind, mb in (("zero1", 1), ("zero2", 2), ("dp", 1)):
        out[f"regression_{kind}"] = _regression(w0, X, Y, kind, mb)

    parallel.initialize_model_parallel(dcn_data_parallel_size=2)
    rank = cc.axis_index(("dcn", "dp"))
    out["prim_2x2"] = _primitives_2x2(rank)
    for case in hier_cases:
        out[case["name"]] = run_case(case, rank)
    from apex_tpu_torch.examples import zero_grad_accum

    out["example"] = zero_grad_accum.main(steps=6, device="cpu")
    parallel.destroy_model_parallel()
    return out
