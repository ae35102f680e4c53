"""The port's serving engine at tensor-parallel size 2 against the JAX
engine under a two-device mesh.

One module-scoped fixture starts two gloo CPU ranks
(``torch_serving_ranks.serving_tp_cases``, torch only) and computes the
JAX side while they run: ``ServingEngine(..., mesh=initialize_model_
parallel(tensor_model_parallel_size=2, devices=jax.devices()[:2]))`` on
the same numpy weights (``test_torch_serving._jax_tree``), one engine per
config.  The model is ``test_torch_serving.MODERN`` (hidden 64, 2
layers, 4 heads in 2 KV groups, rope, SwiGLU, vocabulary 128), so each
rank holds one KV group, two query heads, half the vocabulary, half of
each column-parallel and row-parallel weight.

Cases: the teacher-forced decode logits against a fresh prefill and
against JAX's (2e-4, fp32, as ``tests/test_serving.py`` holds its tp = 2
engine); greedy streams of a staggered wave with forced preemption and
prefix hits in bf16 compute and cache, over an int8 cache, with two LoRA
adapters (the row-parallel deltas summed over tp) and with k = 2 drafting
over the int8 cache, token for token against JAX's and each rank's the
same as the other's; a
tp = 2 export imported into a tp = 1 engine and the other way round,
bitwise the uninterrupted stream; a drain tripped on one rank only,
agreed on by both.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from apex_tpu import parallel as jparallel
from apex_tpu.observability.metrics import MetricRegistry
from apex_tpu.serving import LoRAConfig as JaxLoRAConfig
from apex_tpu.serving import SamplingParams as JaxSamplingParams
from apex_tpu.serving import ServingConfig as JaxServingConfig
from apex_tpu.serving import ServingEngine as JaxServingEngine
from apex_tpu.serving import SpeculativeConfig as JaxSpeculativeConfig
from apex_tpu.serving.kv_cache import init_kv_arena as jax_init_kv_arena
from apex_tpu.transformer.testing.standalone_transformer_lm import (
    TransformerConfig as JaxTransformerConfig,
)
from apex_tpu_torch.parallel.launch import start_multiprocess

import torch_serving_ranks as ranks
from test_torch_serving import MODERN, WAVE, _as_jax, _greedy, _jax_tree
from torch_threads import one_torch_thread  # noqa: F401

TP = 2
SHAPE = dict(max_batch=3, block_size=4, max_seq=32, prefill_len=6,
             n_blocks=8)
WAVES = {
    "wave": WAVE,
    # longer budgets, so the tiny model's greedy loops feed the drafts
    "spec": [(t, p, n + 8) for t, p, n in WAVE],
    "lora": [(t, p, n) for t, p, n in WAVE[:4]],
}
# each JAX engine compiles its own programs (about 5 s at tp = 2), so the
# cases share configs where they can: the teacher-forced loop runs on the
# LoRA engine's config before any adapter is registered (the zero adapter
# adds exact zeros), and the drafting engine over the int8 cache takes
# the int8 engine's prefill program (drafting does not change it)
CASES = {
    "bf16": dict(compute="bf16", cache="bf16", wave="wave"),
    "int8": dict(cache="int8", wave="wave"),
    "lora": dict(lora_rank=4, wave="lora",
                 shape=dict(n_blocks=None, prefill_len=16),
                 adapters=[("t0", 10), ("t1", 11)],
                 ids=["t0", "t1", None, "t0"]),
    "spec": dict(k=2, cache="int8", wave="spec"),
}
TEACHER = dict(CASES["lora"], seq=[5, 9, 33, 12, 44, 2, 17, 60, 21],
               prefix=4)
# the bf16 case's engine serves the export's prompt uninterrupted
EXPORT = dict(CASES["bf16"], prompt=WAVE[0][1], n_new=8, n_out=3)
DRAIN = dict(wave="wave", shape=dict(n_blocks=None))
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}
TOL = 2e-4


def _jax_engine(mesh, tree, case):
    cfg = JaxTransformerConfig(**MODERN, hidden_dropout=0.0,
                               attention_dropout=0.0, tensor_axis="tp",
                               dtype=JDT[case.get("compute", "fp32")])
    shape = dict(SHAPE, **case.get("shape", {}))
    if "cache" in case:
        shape["cache_dtype"] = JDT[case["cache"]]
    if "k" in case:
        shape["speculative"] = JaxSpeculativeConfig(k=case["k"], backoff=4)
    if "lora_rank" in case:
        shape["lora"] = JaxLoRAConfig(rank=case["lora_rank"], max_adapters=2)
    return JaxServingEngine(cfg, JaxServingConfig(**shape), _as_jax(tree),
                            mesh=mesh, registry=MetricRegistry())


def _jax_serve(engine, wave, samplings=None):
    reqs, pending, step = [], list(enumerate(wave)), 0
    while pending or not engine.scheduler.idle:
        while pending and pending[0][1][0] <= step:
            i, (_, prompt, n_new) = pending.pop(0)
            sampling = None if samplings is None else samplings[i]
            reqs.append(engine.submit(prompt, n_new, sampling=sampling))
        engine.step()
        step += 1
    return reqs


def _jax_teacher(eng, seq, prefix):
    """``tests/test_serving.py``'s teacher-forced loop on a LoRA engine,
    every slot on the zero adapter: each decode step's logits."""
    cache = eng.cache
    bs = cache.block_size
    B, T = eng.serving.max_batch, eng.prefill_len
    mb = cache.max_blocks_per_request
    tables = np.zeros((B, mb), np.int32)
    tables[0] = np.arange(mb)
    tokens = np.zeros((B, T), np.int32)
    tokens[0, :prefix] = seq[:prefix]
    pos = np.zeros((B, T), np.int32)
    pos[0, :prefix] = np.arange(prefix)
    limits = np.zeros((B, T), np.int32)
    limits[0, :prefix] = np.arange(1, prefix + 1)
    lengths = np.zeros((B,), np.int32)
    lengths[0] = prefix
    db = np.full((B, T), cache.n_blocks, np.int32)
    do = np.zeros((B, T), np.int32)
    db[0, :prefix] = np.arange(prefix) // bs
    do[0, :prefix] = np.arange(prefix) % bs
    zero = np.zeros((B,), np.int32)
    arenas, eng.adapters, _, _ = eng._prefill(
        jax_init_kv_arena(cache, eng.mesh, eng.tp_axis), eng.adapters,
        eng.params, tokens, pos, jnp.asarray(tables), lengths, limits, db,
        do, np.full((B,), T, np.int32), zero, *_greedy(B))
    out = []
    for t in range(prefix, len(seq)):
        toks = np.zeros((B, 1), np.int32)
        toks[0, 0] = seq[t]
        p = np.zeros((B,), np.int32)
        p[0] = t
        act = np.zeros((B,), bool)
        act[0] = True
        arenas, eng.adapters, _, _, logits = eng._decode(
            arenas, eng.adapters, eng.params, toks, p, jnp.asarray(tables),
            act, zero, zero, *_greedy(B))
        out.append(np.asarray(logits[0, 0]))
    return np.stack(out)


@pytest.fixture(scope="module")
def run():
    """Both ranks' results and the JAX side (computed while they run)."""
    mesh = jparallel.initialize_model_parallel(
        tensor_model_parallel_size=TP, devices=jax.devices()[:TP])
    jcfg = JaxTransformerConfig(**MODERN, hidden_dropout=0.0,
                                attention_dropout=0.0, tensor_axis="tp")
    tree = _jax_tree(jcfg, 3)
    spec = {"model": MODERN, "shape": SHAPE, "waves": WAVES,
            "cases": CASES, "teacher": TEACHER, "export": EXPORT,
            "drain": DRAIN, "tree": tree._asdict()}
    job = start_multiprocess(ranks.serving_tp_cases, TP, args=(spec,),
                             timeout=240.0, num_threads=1)
    engines = {name: _jax_engine(mesh, tree, case)
               for name, case in CASES.items()}
    engines["spec"]._prefill = engines["int8"]._prefill
    want = {"teacher": _jax_teacher(engines["lora"], TEACHER["seq"],
                                    TEACHER["prefix"])}
    for name, case in CASES.items():
        eng = engines[name]
        samplings = None
        if "lora_rank" in case:
            for aid, seed in case["adapters"]:
                eng.register_adapter(aid, seed=seed)
            samplings = [JaxSamplingParams(adapter_id=aid)
                         for aid in case["ids"]]
        reqs = _jax_serve(eng, WAVES[case["wave"]], samplings)
        sched = eng.scheduler
        want[name] = {"streams": [r.output_tokens for r in reqs],
                      "preemptions": sched.preemptions,
                      "hits": (sched.prefix_cache.hits
                               if sched.prefix_cache is not None else 0),
                      "spec": (eng.spec_proposed, eng.spec_accepted)}
        if name == "bf16":
            want["export"] = _jax_serve(
                eng, [(0, EXPORT["prompt"], EXPORT["n_new"])])[0]\
                .output_tokens
    return job.join(), want


def test_ranks_agree_bit_for_bit(run):
    """The gathered logits are the same bytes on both ranks, so every
    stream and decision is too."""
    got, _ = run
    assert [r["rank"] for r in got] == [0, 1]
    a, b = got
    np.testing.assert_array_equal(a["teacher"]["decode"],
                                  b["teacher"]["decode"])
    for name in CASES:
        assert a[name]["streams"] == b[name]["streams"], name
    assert a["export"] == b["export"]


def test_teacher_forced_decode_matches_prefill(run):
    got, _ = run
    t = got[0]["teacher"]
    err = float(np.abs(t["decode"] - t["full"]).max())
    assert err < TOL, err


def test_teacher_forced_logits_match_jax(run):
    got, want = run
    err = float(np.abs(got[0]["teacher"]["decode"] - want["teacher"]).max())
    assert err < TOL, err


@pytest.mark.parametrize("case", list(CASES))
def test_streams_match_jax(run, case):
    got, want = run
    for rank in got:
        assert rank[case]["streams"] == want[case]["streams"], case
    wave = WAVES[CASES[case]["wave"]]
    assert [len(s) for s in want[case]["streams"]] == [n for _, _, n in wave]


def test_wave_preempts_and_hits_like_jax(run):
    """The bf16 wave's pool forces preemption and serves prefix hits, as
    many of each as JAX's scheduler."""
    got, want = run
    for name in ("bf16", "int8"):
        r = got[0][name]
        assert r["preemptions"] > 0 and r["hits"] > 0, name
        assert (r["preemptions"], r["hits"]) == \
            (want[name]["preemptions"], want[name]["hits"]), name


def test_drafts_proposed_and_accepted_like_jax(run):
    got, want = run
    assert got[0]["spec"]["spec"] == want["spec"]["spec"]
    assert want["spec"]["spec"][1] > 0


def test_each_rank_holds_its_heads_and_adapter_shards(run):
    """One of two KV groups a rank, in every arena; the column-parallel
    adapters' B split on out, the row-parallel A on in."""
    got, _ = run
    r = got[0]
    L, hd = MODERN["num_layers"], 16
    assert r["teacher"]["local_heads"] == (L, 24, 4, 1, hd)
    assert r["int8"]["arena"] == (L, 8, 4, 1, hd)
    h, f, rank, slots = 64, 256, 4, 3
    qkv_out = (4 + 2 * 2) * hd
    assert r["lora"]["arena"] == [
        (L, slots, h, rank), (L, slots, rank, qkv_out // TP),
        (L, slots, 4 * hd // TP, rank), (L, slots, rank, h),
        (L, slots, h, rank), (L, slots, rank, f // TP),
        (L, slots, f // TP, rank), (L, slots, rank, h)]


@pytest.mark.parametrize("case", ["bf16", "lora"])
def test_collectives_per_call(run, case):
    """Each call reduces the embedding and the two row-parallel outputs
    of each layer and gathers the vocabulary once; with LoRA the two
    row-parallel deltas of each layer add one reduction each."""
    got, _ = run
    r = got[0][case]
    calls = sum(r["engine_calls"])
    L = MODERN["num_layers"]
    per_call = 1 + 2 * L + (2 * L if case == "lora" else 0)
    assert r["calls"]["all_reduce"] == per_call * calls
    assert r["calls"]["all_gather"] == calls
    assert r["calls"]["reduce_scatter"] == r["calls"]["ppermute"] == 0


@pytest.mark.parametrize("way", ["tp2_to_tp1", "tp1_to_tp2"])
def test_export_import_across_tp(run, way):
    """The continued stream is bitwise the uninterrupted one (the port's
    tp = 2 twin and JAX's); the payload holds all KV heads whatever the
    exporter's tp; the run stays pinned until the acknowledgement."""
    got, want = run
    for rank in got:
        e = rank["export"]
        m = e[way]
        assert m["stream"] == e["twin"] == want["export"]
        assert m["meta"]["kv_heads"] == 2 and m["meta"]["dtype"] == \
            "bfloat16"
        assert m["meta"]["n_out"] == EXPORT["n_out"]
        assert m["slab"] == (MODERN["num_layers"], 4, 2, 16)
        assert (m["pinned"], m["after"]) == (1, 0)


def test_drain_tripped_on_one_rank_drains_both(run):
    got, _ = run
    assert [r["drain"]["tripped"] for r in got] == [False, True]
    for r in got:
        d = r["drain"]
        assert d["drained_at"] == 2
        assert d["states"] == ["finished"] * 3 + ["cancelled"] * 2
        assert d["cancelled"] == 2
