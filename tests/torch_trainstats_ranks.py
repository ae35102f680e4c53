"""Rank-side half of ``test_torch_trainstats.py``: the 3D GPT step with and
without ``collect_stats`` on a gloo grid.

Runs on every rank of a four-rank group (dp 2 x tp 2 with sequence
parallelism) started by :func:`apex_tpu_torch.parallel.launch.
start_multiprocess`; torch and the port only.
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
    parallel.destroy_model_parallel()
    return out
