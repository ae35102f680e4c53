"""Rank-side half of ``test_torch_trainstats.py``: the 3D GPT step with and
without ``collect_stats`` on a gloo grid, then the ZeRO step's.

Runs on every rank of a four-rank group (dp 2 x tp 2 with sequence
parallelism, then dp 4 for ZeRO) started by
:func:`apex_tpu_torch.parallel.launch.start_multiprocess`; torch and the
port only.
"""

import numpy as np
import torch

from apex_tpu_torch import parallel
from apex_tpu_torch.amp._tree import tree_leaves
from apex_tpu_torch.parallel import collectives as cc

STEPS = 2


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy().tobytes()
    return repr(x)


def _setup(config, params, kw):
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.transformer.testing.gpt_parallel_train import (
        build_gpt_3d,
    )
    from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
        TransformerConfig,
    )

    init_fn, _, make_train_step = build_gpt_3d(TransformerConfig(**config),
                                               device="cpu", **kw)
    local, specs = init_fn(params=params)
    opt = FusedAdam(tree_leaves(local), lr=1e-3)
    return local, opt, specs, make_train_step


def stats_cases(cases, tokens, grid):
    """For each case ``(name, config, params, build kwargs)``: the bare
    and the instrumented step from the same weights, ``STEPS`` steps each,
    on this rank's dp slice of ``tokens``: whether the parameters, the
    optimizer state and the losses agree bit for bit, each step's
    collective counts, and the instrumented steps' stats as
    ``TrainStatsLogger`` fetches them (every rank's partial rows
    gathered)."""
    from apex_tpu_torch.observability import MetricRegistry
    from apex_tpu_torch.observability.trainstats import TrainStatsLogger

    parallel.initialize_model_parallel(**grid)
    batch = parallel.dp_shard_batch(torch.from_numpy(tokens), axis="dp")
    logger = TrainStatsLogger(MetricRegistry(rank=0, world=1), every_n=1)
    out = {}
    for name, config, params, kw in cases:
        runs = {}
        for collect in (False, True):
            local, opt, specs, make_train_step = _setup(config, params, kw)
            step = make_train_step(opt, specs, collect_stats=collect)
            losses, calls, fetched = [], [], []
            for _ in range(STEPS):
                before = dict(cc.CALLS)
                res = step(local, batch)
                calls.append({k: cc.CALLS[k] - before[k] for k in cc.CALLS})
                if collect:
                    loss, stats = res
                    fetched.append(logger.fetch(stats))
                else:
                    loss = res
                losses.append(loss.numpy().tobytes())
            state = opt.opt_state(dict(enumerate(tree_leaves(local))))
            runs[collect] = {
                "losses": losses, "calls": calls, "stats": fetched,
                "params": [t.detach().numpy().tobytes()
                           for t in tree_leaves(local)],
                "state": [_bytes(t) for t in tree_leaves(state)]}
        bare, instr = runs[False], runs[True]
        out[name] = {
            "same_params": bare["params"] == instr["params"],
            "same_state": bare["state"] == instr["state"],
            "same_losses": bare["losses"] == instr["losses"],
            "calls": (bare["calls"], instr["calls"]),
            "stats": instr["stats"],
            "loss": float(np.frombuffer(bare["losses"][0], np.float32)[0])}
    out["zero"] = zero_stats_cases()
    parallel.destroy_model_parallel()
    return out


def _stats_dict(stats):
    return {f: (None if v is None else v.detach().numpy().tolist())
            for f, v in stats._asdict().items()}


def zero_stats_cases():
    """The ZeRO step (``DistributedFusedAdam``, one flat bucket) on a dp 4
    grid, bare and with ``collect_stats`` from the same state, without
    a scaler (two microbatches) and with the sentinel; then the
    instrumented sentinel step on a NaN batch.  Per case: whether the
    parameters, the optimizer state (and the sentinel) and the loss
    agree bit for bit, both steps' collective counts, and the stats."""
    from apex_tpu_torch.amp.scaler import DynamicLossScale
    from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam
    from apex_tpu_torch.resilience import sentinel_init

    parallel.initialize_model_parallel()
    x = torch.arange(16 * 16, dtype=torch.float32).reshape(16, 16) / 100.0
    batch = parallel.dp_shard_batch((x, torch.ones(16, 8)))
    nan_batch = tuple(torch.full_like(t, float("nan")) for t in batch)
    scaler = DynamicLossScale()

    def setup(collect, **kw):
        params = {"b": torch.zeros(8).requires_grad_(),
                  "w": torch.ones(16, 8).requires_grad_()}
        opt = DistributedFusedAdam(tree_leaves(params), lr=1e-3,
                                   flat_bucket=True)
        parallel.zero_init(opt, params)
        step = parallel.zero_data_parallel_train_step(
            lambda b: torch.mean((b[0] @ params["w"] + params["b"] - b[1])
                                 ** 2), opt, collect_stats=collect, **kw)
        return params, opt, step

    def run(collect, data, **kw):
        params, opt, step = setup(collect, **kw)
        args = (data,) if "scaler" not in kw else (data,
                                                   sentinel_init(scaler,
                                                                 "cpu"))
        before = dict(cc.CALLS)
        out = step(*args)
        calls = {k: cc.CALLS[k] - before[k] for k in cc.CALLS}
        if not isinstance(out, tuple):
            out = (out,)
        stats = out[-1] if collect else None
        rest = out[:-1] if collect else out
        return {"params": [p.detach().numpy().tobytes()
                           for p in tree_leaves(params)],
                "state": [_bytes(t) for t in tree_leaves(opt.opt_state())],
                "rest": [_bytes(t) for t in tree_leaves(rest)],
                "calls": calls,
                "stats": None if stats is None else _stats_dict(stats)}

    out = {}
    for name, data, kw in (("plain", batch, dict(microbatches=2)),
                           ("scaler", batch, dict(scaler=scaler)),
                           ("poisoned", nan_batch, dict(scaler=scaler))):
        bare, instr = run(False, data, **kw), run(True, data, **kw)
        out[name] = {"same": all(bare[k] == instr[k]
                                 for k in ("params", "state", "rest")),
                     "calls": (bare["calls"], instr["calls"]),
                     "stats": instr["stats"],
                     "params": [np.frombuffer(b, np.float32).tolist()
                                for b in instr["params"]]}
    return out
