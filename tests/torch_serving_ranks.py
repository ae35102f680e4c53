"""Rank-side half of the port's tensor-parallel serving parity test
(``test_torch_serving_tp.py``).

:func:`serving_tp_cases` runs on both ranks of a two-rank gloo group
started by :func:`apex_tpu_torch.parallel.launch.start_multiprocess`,
serves on a tp = 2 grid from the numpy weights and waves the test sends,
and returns numpy results for the test to hold against the JAX engine
under a two-device mesh.  Torch and the port only: the spawned ranks never
import JAX.
"""

import numpy as np
import torch

from apex_tpu_torch import parallel
from apex_tpu_torch.observability.metrics import MetricRegistry
from apex_tpu_torch.parallel import collectives as cc
from apex_tpu_torch.resilience import PreemptionGuard
from apex_tpu_torch.serving import (
    LoRAConfig,
    SamplingParams,
    ServingConfig,
    ServingEngine,
    SpeculativeConfig,
    init_kv_arena,
)
from apex_tpu_torch.serving.bridge import from_jax_params
from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
    TransformerConfig,
)

TP = 2
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


def serve(engine, wave, samplings=None):
    """Submit each ``(arrival step, prompt, max_new_tokens)`` at its step
    (with its entry of ``samplings``) and step until idle; the requests."""
    reqs, pending, step = [], list(enumerate(wave)), 0
    while pending or not engine.scheduler.idle:
        while pending and pending[0][1][0] <= step:
            i, (_, prompt, n_new) = pending.pop(0)
            sampling = None if samplings is None else samplings[i]
            reqs.append(engine.submit(prompt, n_new, sampling=sampling))
        engine.step()
        step += 1
        assert step < 500, "wave did not drain"
    return reqs


def _engine(spec, case, mesh, **kw):
    cfg = TransformerConfig(**spec["model"],
                            dtype=DTYPES[case.get("compute", "fp32")])
    shape = dict(spec["shape"], **case.get("shape", {}))
    if "cache" in case:
        shape["cache_dtype"] = DTYPES[case["cache"]]
    if "k" in case:
        shape["speculative"] = SpeculativeConfig(k=case["k"], backoff=4)
    if "lora_rank" in case:
        shape["lora"] = LoRAConfig(rank=case["lora_rank"], max_adapters=2)
    return ServingEngine(cfg, ServingConfig(**shape),
                         from_jax_params(spec["tree"]), mesh=mesh,
                         registry=MetricRegistry(), device="cpu", **kw)


def _greedy(B):
    return (torch.zeros(B), torch.zeros(B, dtype=torch.long),
            torch.ones(B), torch.zeros(B, dtype=torch.long),
            torch.zeros(B, dtype=torch.long))


def _prefill_logits(eng, seq, upto, arenas, tables, blocks):
    """Prefill ``seq[:upto]`` into slot 0 of fresh ``arenas``; the
    logits ``[B, T, vocab]``."""
    B, T = eng.serving.max_batch, eng.prefill_len
    cache = eng.cache
    bs = cache.block_size
    i64 = dict(dtype=torch.long)
    tokens = torch.zeros(B, T, **i64)
    tokens[0, :upto] = torch.tensor(seq[:upto])
    pos = torch.zeros(B, T, **i64)
    pos[0, :upto] = torch.arange(upto)
    limits = torch.zeros(B, T, dtype=torch.int32)
    limits[0, :upto] = torch.arange(1, upto + 1)
    lengths = torch.zeros(B, dtype=torch.int32)
    lengths[0] = upto
    db = torch.full((B, T), cache.n_blocks, **i64)
    do = torch.zeros(B, T, **i64)
    db[0, :upto] = torch.tensor([blocks[t // bs] for t in range(upto)])
    do[0, :upto] = torch.arange(upto) % bs
    si = torch.full((B,), T, **i64)
    _, logits = eng.model.prefill(arenas, tokens, pos, tables, lengths,
                                  limits, db, do, si, *_greedy(B))
    return logits


def _teacher_forced(spec, mesh):
    """Prefill a prefix, then decode the rest teacher-forced: each step's
    logits, and each beside a fresh full prefill's at that position."""
    case = spec["teacher"]
    eng = _engine(spec, case, mesh)
    seq, prefix = case["seq"], case["prefix"]
    B = eng.serving.max_batch
    mb = eng.cache.max_blocks_per_request
    blocks = list(range(mb))
    tables = torch.zeros(B, mb, dtype=torch.int32)
    tables[0] = torch.tensor(blocks, dtype=torch.int32)
    arenas = init_kv_arena(eng.cache, "cpu", mesh=mesh)
    _prefill_logits(eng, seq, prefix, arenas, tables, blocks)
    decode, full = [], []
    for t in range(prefix, len(seq)):
        toks = torch.zeros(B, 1, dtype=torch.long)
        toks[0, 0] = seq[t]
        pos = torch.zeros(B, dtype=torch.long)
        pos[0] = t
        active = torch.zeros(B, dtype=torch.bool)
        active[0] = True
        _, _, logits = eng.model.decode_step(arenas, toks, pos, tables,
                                             active, *_greedy(B))
        decode.append(logits[0, 0].numpy())
        fresh = init_kv_arena(eng.cache, "cpu", mesh=mesh)
        full.append(_prefill_logits(eng, seq, t + 1, fresh, tables,
                                    blocks)[0, t].numpy())
    return {"decode": np.stack(decode), "full": np.stack(full),
            "local_heads": tuple(arenas[0].shape)}


def _wave_case(spec, case, mesh):
    eng = _engine(spec, case, mesh)
    cc.zero_counts()
    reqs = serve(eng, spec["waves"][case["wave"]])
    eng.scheduler.allocator.check()
    sched = eng.scheduler
    return {"streams": [r.output_tokens for r in reqs],
            "preemptions": sched.preemptions,
            "hits": sched.prefix_cache.hits,
            "spec": (eng.spec_proposed, eng.spec_accepted),
            "calls": dict(cc.CALLS),
            "engine_calls": (eng.prefill_calls, eng.decode_calls),
            "arena": tuple(eng.arenas[0].shape)}


def _lora_case(spec, case, mesh):
    """Two adapters and bare requests in one wave: ``_lora_psum`` sums
    the dense and fc2 partial deltas over tp."""
    eng = _engine(spec, case, mesh)
    for aid, seed in case["adapters"]:
        eng.register_adapter(aid, seed=seed)
    samplings = [SamplingParams(adapter_id=aid) for aid in case["ids"]]
    cc.zero_counts()
    reqs = serve(eng, spec["waves"][case["wave"]], samplings)
    eng.adapter_arena.check()
    return {"streams": [r.output_tokens for r in reqs],
            "calls": dict(cc.CALLS),
            "engine_calls": (eng.prefill_calls, eng.decode_calls),
            "arena": [tuple(a.shape) for a in eng.adapters]}


def _run_to(eng, req, n_out):
    while len(req.output_tokens) < n_out or req.prefilling:
        eng.step()


def _migrate(spec, case, src, dst):
    """Serve ``case``'s prompt on ``src`` to ``n_out`` tokens, export it,
    import it into ``dst`` and finish there; the stitched stream, the
    meta, and the source's books after the acknowledgement."""
    prompt, n_new, n_out = case["prompt"], case["n_new"], case["n_out"]
    req = src.submit(prompt, n_new)
    _run_to(src, req, n_out)
    head = list(req.output_tokens)
    meta, payloads = src.export_request(req)
    moved = dst.import_request(list(prompt) + head, n_new - len(head),
                               cache_len=meta["cache_len"],
                               payloads=payloads)
    dst.run_until_drained()
    pinned = len(src.exports)
    src.release_export(req.rid, ok=True)
    src.scheduler.allocator.check()
    dst.scheduler.allocator.check()
    return {"stream": head + moved.output_tokens, "meta": meta,
            "pinned": pinned, "after": len(src.exports),
            "slab": tuple(payloads[0][0].shape)}


def _export_case(spec, mesh):
    case = spec["export"]
    whole = _engine(spec, case, mesh)
    twin = serve(whole, [(0, case["prompt"], case["n_new"])])[0]
    out = {"twin": twin.output_tokens}
    out["tp2_to_tp1"] = _migrate(spec, case, _engine(spec, case, mesh),
                                 _engine(spec, case, None))
    out["tp1_to_tp2"] = _migrate(spec, case, _engine(spec, case, None),
                                 _engine(spec, case, mesh))
    return out


def _drain_case(spec, mesh, rank):
    """Only rank 1's guard trips: the MAX all-reduce at the top of the
    next step drains both ranks in that same step."""
    case = spec["drain"]
    guard = PreemptionGuard(signals=())
    eng = _engine(spec, case, mesh, guard=guard)
    wave = spec["waves"][case["wave"]]
    reqs = [eng.submit(p, n) for _, p, n in wave]
    eng.step()
    if rank == 1:
        guard.trigger()
    eng.step()
    drained_at = eng.steps if eng.draining else None
    eng.run_until_drained()
    return {"tripped": guard.triggered, "drained_at": drained_at,
            "states": [r.state.value for r in reqs],
            "cancelled": eng.requests_cancelled}


def serving_tp_cases(spec):
    """Every case on this rank of a tp = 2 grid; numpy-able results."""
    mesh = parallel.initialize_model_parallel(tensor_model_parallel_size=TP)
    rank = cc.axis_index("tp")
    out = {"rank": rank, "teacher": _teacher_forced(spec, mesh)}
    for name, case in spec["cases"].items():
        if "lora_rank" in case:
            out[name] = _lora_case(spec, case, mesh)
        else:
            out[name] = _wave_case(spec, case, mesh)
    out["export"] = _export_case(spec, mesh)
    out["drain"] = _drain_case(spec, mesh, rank)
    parallel.destroy_model_parallel()
    return out
