"""The rest of the port's engine surface against the JAX engine, in one
process at tp = 1.

The model is ``test_torch_serving.MODERN`` (hidden 64, 2 layers, 4 heads
in 2 KV groups, rope, SwiGLU) on ``_jax_tree``'s numpy weights, the wave
``test_torch_serving.WAVE`` (a staggered arrival, a shared prefix, a pool
of 8 blocks that forces preemption and eviction).  Each JAX program is
compiled once for the module (``_build_jax_engine``).

- ``admission="reserve"`` and ``prefix_caching=False``: the streams and
  the per-step pool occupancy equal JAX's;
- the unfused paged attention against JAX's ``*_unfused`` functions (bf16
  and int8 caches, GQA; fp32 sums in another order: atol 1e-5), and
  ``fused_attention=False`` logits against JAX's at 1e-4 (as
  ``test_torch_serving`` holds the fused path);
- ``set_knobs``: clamping, the errors, and the streams under live caps;
- export and import: the continued stream bitwise the uninterrupted one
  (greedy, seeded, into a drafting engine, from JAX's own payload), the
  meta and the payload against JAX's, a malformed payload refused before
  any write, and the ``ExportLedger`` in lockstep with JAX's;
- ``introspect``'s keys, the registry's counters and gauges, and the
  timeline's event kinds and request ids, in order, after the same wave;
- a drain tripped by the guard and by the heartbeat, ``HeartbeatMonitor``
  and ``Histogram`` in lockstep with JAX's, and the MFU peak table.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apex_tpu.observability import metrics as jmetrics
from apex_tpu.observability import timeline as jtimeline
from apex_tpu.resilience import PreemptionGuard as JaxPreemptionGuard
from apex_tpu.serving import ServingConfig as JaxServingConfig
from apex_tpu.serving import ServingEngine as JaxServingEngine
from apex_tpu.serving import SpeculativeConfig as JaxSpeculativeConfig
from apex_tpu.serving import kv_cache as jkv
from apex_tpu.serving import paged_attention as jpa
from apex_tpu_torch.observability import (
    FlightRecorder,
    HeartbeatMonitor,
    MetricRegistry,
    mfu_or_reason,
    peak_flops_reason,
    serving_goodput_report,
)
from apex_tpu_torch.observability import timeline
from apex_tpu_torch.observability.metrics import Histogram
from apex_tpu_torch.resilience import PreemptionGuard
from apex_tpu_torch.serving import (
    BlockAllocator,
    DecodeModel,
    PrefixCache,
    SamplingParams,
    ServingConfig,
    ServingEngine,
    SpeculativeConfig,
    init_kv_arena,
    paged_attention_decode,
    paged_attention_decode_unfused,
    paged_prefill_attention,
    paged_prefill_attention_unfused,
)
from apex_tpu_torch.serving import fused_ops, paged_attention
from apex_tpu_torch.serving.bridge import from_jax_params
from apex_tpu_torch.serving.kv_cache import ExportLedger, KVCacheConfig
from apex_tpu_torch.serving.scheduler import RequestState

from test_torch_serving import (
    MODERN,
    WAVE,
    _as_jax,
    _configs,
    _greedy,
    _jax_tree,
    _mesh,
    _t,
)
from torch_threads import one_torch_thread  # noqa: F401

SHAPE = dict(max_batch=3, block_size=4, max_seq=32, prefill_len=6,
             n_blocks=8)
JCFG, TCFG = _configs(MODERN)
TREE = _jax_tree(JCFG, 3)
_JAX = {}
_PROGRAMS = {}
# host-side policy: engines that differ only in these run the same
# compiled programs, so they share them (a compile is about 3.5 s)
_HOST_POLICY = ("admission", "prefix_caching")


def _key(kw):
    return tuple(sorted((k, repr(v)) for k, v in kw.items()))


def _build_jax_engine(**kw):
    """A new JAX engine of one config, on the compiled programs of the
    first engine that had them."""
    programs = _key({k: v for k, v in kw.items() if k not in _HOST_POLICY})
    kw = dict(kw)
    if "speculative" in kw:
        kw["speculative"] = JaxSpeculativeConfig(**kw["speculative"])
    eng = JaxServingEngine(
        JCFG, JaxServingConfig(**dict(SHAPE, **kw)), _as_jax(TREE),
        mesh=_mesh(), registry=jmetrics.MetricRegistry())
    if programs in _PROGRAMS:
        eng._decode, eng._prefill = _PROGRAMS[programs]
    else:
        _PROGRAMS[programs] = (eng._decode, eng._prefill)
    return eng


def _jax_engine(**kw):
    """The module's JAX engine of one config."""
    key = _key(kw)
    if key not in _JAX:
        _JAX[key] = _build_jax_engine(**kw)
    return _JAX[key]


def _port_engine(**kw):
    kw = dict(kw)
    if "speculative" in kw:
        kw["speculative"] = SpeculativeConfig(**kw["speculative"])
    return ServingEngine(TCFG, ServingConfig(**dict(SHAPE, **kw)),
                         from_jax_params(TREE), registry=MetricRegistry(),
                         device="cpu")


def _serve(engine, wave, knobs=None, trace_occupancy=None):
    """Serve ``wave`` (arrivals by step); ``knobs`` maps a step to a
    ``set_knobs`` payload applied before it; the requests."""
    reqs, pending, step = [], list(wave), 0
    while pending or not engine.scheduler.idle:
        if knobs and step in knobs:
            engine.set_knobs(knobs[step])
        while pending and pending[0][0] <= step:
            _, prompt, n_new = pending.pop(0)
            reqs.append(engine.submit(prompt, n_new))
        engine.step()
        if trace_occupancy is not None:
            trace_occupancy.append(engine.scheduler.kv_occupancy())
        step += 1
        assert step < 500, "wave did not drain"
    return reqs


def _streams(reqs):
    return [r.output_tokens for r in reqs]


# ---------------------------------------------------------- admission


@pytest.mark.parametrize("kw", [dict(admission="reserve"),
                                dict(prefix_caching=False)],
                         ids=["reserve", "no_prefix_cache"])
def test_admission_variants_match_jax(kw):
    """Worst-case reservation and occupancy without a prefix cache: the
    streams and the pool's occupancy after every step equal JAX's;
    reserve never preempts and frees the whole pool."""
    occ, jocc = [], []
    port = _port_engine(**kw)
    got = _serve(port, WAVE, trace_occupancy=occ)
    ref = _jax_engine(**kw)
    want = _serve(ref, WAVE, trace_occupancy=jocc)
    assert _streams(got) == _streams(want)
    assert occ == jocc
    sched = port.scheduler
    assert sched.prefix_cache is None
    assert sched.preemptions == ref.scheduler.preemptions
    if kw.get("admission") == "reserve":
        assert sched.preemptions == 0 and sched.admission == "reserve"
        assert sched.allocator.n_free == sched.allocator.n_blocks
    sched.allocator.check()


def test_admission_is_checked_like_jax():
    for cls in (ServingConfig, JaxServingConfig):
        with pytest.raises(ValueError, match="occupancy"):
            cls(admission="lifo")
    assert ServingConfig().admission == JaxServingConfig().admission


# ---------------------------------------------------- unfused attention


def _paged_case(rng, cache):
    n_blocks, bs, g, n, d, b = 10, 4, 2, 4, 16, 3
    kv = rng.standard_normal((2, n_blocks, bs, g, d)).astype(np.float32)
    if cache == "int8":
        k = rng.integers(-127, 128, (n_blocks, bs, g, d)).astype(np.int8)
        v = rng.integers(-127, 128, (n_blocks, bs, g, d)).astype(np.int8)
        scales = (rng.random((2, n_blocks, bs, g)) * 0.02 + 1e-3
                  ).astype(np.float32)
        arenas = (k, v, scales[0], scales[1])
    else:
        arenas = tuple(torch.from_numpy(a).bfloat16().float().numpy()
                       for a in kv)
    tables = rng.permutation(n_blocks)[:6].reshape(b, 2).astype(np.int32)
    lengths = np.asarray([5, 0, 8], np.int32)
    q = rng.standard_normal((b, n, d)).astype(np.float32)
    qt = rng.standard_normal((b, 3, n, d)).astype(np.float32)
    limits = np.asarray([[3, 4, 5], [0, 0, 0], [6, 7, 8]], np.int32)
    return arenas, tables, lengths, q, qt, limits


def _port_arenas(arenas, cache):
    k, v = (torch.from_numpy(a) for a in arenas[:2])
    if cache == "bf16":
        k, v = k.bfloat16(), v.bfloat16()
    kw = {}
    if cache == "int8":
        kw = dict(k_scales=torch.from_numpy(arenas[2]),
                  v_scales=torch.from_numpy(arenas[3]))
    return k, v, kw


def _jax_arenas(arenas, cache):
    dt = jnp.bfloat16 if cache == "bf16" else None
    k, v = (jnp.asarray(a, dt) for a in arenas[:2])
    kw = {}
    if cache == "int8":
        kw = dict(k_scales=jnp.asarray(arenas[2]),
                  v_scales=jnp.asarray(arenas[3]))
    return k, v, kw


@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_unfused_attention_matches_jax(cache):
    """Decode, the 4-D verify through the decode entry and the chunked
    prefill, GQA (2 heads a group): the port's unfused functions against
    JAX's at atol 1e-5, and the same as the port's kernel wrappers' CPU
    path bit for bit; no launch counted."""
    rng = np.random.default_rng(5 if cache == "bf16" else 6)
    arenas, tables, lengths, q, qt, limits = _paged_case(rng, cache)
    k, v, kw = _port_arenas(arenas, cache)
    jk, jv, jkw = _jax_arenas(arenas, cache)
    t = [torch.from_numpy(a) for a in (tables, lengths, q, qt, limits)]
    calls = [
        (paged_attention_decode_unfused(t[2], k, v, t[0], t[1], **kw),
         jpa.paged_attention_decode_unfused(q, jk, jv, tables, lengths,
                                            **jkw),
         paged_attention_decode(t[2], k, v, t[0], t[1], **kw)),
        (paged_attention_decode_unfused(t[3], k, v, t[0], t[1],
                                        limits=t[4], **kw),
         jpa.paged_attention_decode_unfused(qt, jk, jv, tables, lengths,
                                            limits=limits, **jkw),
         paged_attention_decode(t[3], k, v, t[0], t[1], limits=t[4], **kw)),
        (paged_prefill_attention_unfused(t[3], k, v, t[0], t[1], t[4], **kw),
         jpa.paged_prefill_attention_unfused(qt, jk, jv, tables, lengths,
                                             limits, **jkw),
         paged_prefill_attention(t[3], k, v, t[0], t[1], t[4], **kw)),
    ]
    for got, want, plain in calls:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0)
        torch.testing.assert_close(got, plain, atol=0, rtol=0)
    assert (paged_attention.DECODE_LAUNCHES,
            paged_attention.PREFILL_LAUNCHES) == (0, 0)
    with pytest.raises(ValueError, match="limits"):
        paged_attention_decode_unfused(t[3], k, v, t[0], t[1], **kw)


def test_fused_attention_false_logits_match_jax():
    """Chunked prefill of two slots and one decode step through the
    unfused attention: logits within 1e-4 of JAX's (its engine built with
    ``fused_attention=False``) and of the port's fused path."""
    ref = _jax_engine(fused_attention=False)
    assert ref.model.fused_attention is False
    bs, T, B = SHAPE["block_size"], SHAPE["prefill_len"], SHAPE["max_batch"]
    cache = KVCacheConfig(n_layers=TCFG.num_layers,
                          n_blocks=ref.cache.n_blocks, block_size=bs,
                          kv_heads=TCFG.query_groups, head_dim=TCFG.head_dim,
                          max_seq=SHAPE["max_seq"])
    models = {f: DecodeModel(TCFG, cache, fused_attention=f, device="cpu")
              for f in (False, True)}
    for m in models.values():
        m.load_params(from_jax_params(TREE))
    arenas = {f: init_kv_arena(cache, device="cpu") for f in models}
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 128, 6), rng.integers(1, 128, 5)]
    blocks = [[0, 1], [2, 3]]
    tables = np.zeros((B, cache.max_blocks_per_request), np.int32)
    tokens = np.zeros((B, T), np.int32)
    pos = np.zeros((B, T), np.int32)
    limits = np.zeros((B, T), np.int32)
    lengths = np.zeros((B,), np.int32)
    db = np.full((B, T), cache.n_blocks, np.int32)
    do = np.zeros((B, T), np.int32)
    si = np.full((B,), T, np.int32)
    for s, (p, blk) in enumerate(zip(prompts, blocks)):
        n = len(p)
        tables[s, :2] = blk
        tokens[s, :n] = p
        pos[s, :n] = np.arange(n)
        limits[s, :n] = np.arange(1, n + 1)
        lengths[s] = n
        db[s, :n] = [blk[i // bs] for i in range(n)]
        do[s, :n] = np.arange(n) % bs
        si[s] = n - 1
    j_arenas, j_next, j_logits = ref._prefill(
        _init_jax_arenas(ref), ref.params, tokens, pos, jnp.asarray(tables),
        lengths, limits, db, do, si, *_greedy(B))
    out = {f: m.prefill(arenas[f], *_t(tokens, pos, tables, lengths, limits,
                                        db, do, si), *_t(*_greedy(B)))
           for f, m in models.items()}
    np.testing.assert_allclose(out[False][1].numpy(), np.asarray(j_logits),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(out[False][1].numpy(), out[True][1].numpy(),
                               atol=1e-4, rtol=0)
    toks = np.asarray(j_next, np.int32)[:, None]
    active = np.asarray([True, True, False])
    _, j_out, _, j_dl = ref._decode(
        j_arenas, ref.params, toks, lengths, jnp.asarray(tables), active,
        np.zeros((B,), np.int32), *_greedy(B))
    dec = {f: m.decode_step(arenas[f], *_t(toks, lengths, tables, active),
                            *_t(*_greedy(B)))
           for f, m in models.items()}
    np.testing.assert_allclose(dec[False][2].numpy(), np.asarray(j_dl),
                               atol=1e-4, rtol=0)
    np.testing.assert_array_equal(dec[False][0].numpy(), np.asarray(j_out))
    np.testing.assert_allclose(dec[False][2].numpy(), dec[True][2].numpy(),
                               atol=1e-4, rtol=0)


def _init_jax_arenas(eng):
    return jkv.init_kv_arena(eng.cache, eng.mesh, eng.tp_axis)


def test_fused_attention_false_streams_match_jax():
    """The wave through the unfused attention: JAX's streams, and no K1
    or K2 launch (K3 still on its CPU path)."""
    got = _serve(_port_engine(fused_attention=False), WAVE)
    assert _streams(got) == _streams(_serve(
        _jax_engine(fused_attention=False), WAVE))
    assert (paged_attention.DECODE_LAUNCHES,
            paged_attention.PREFILL_LAUNCHES,
            fused_ops.RESIDUAL_NORM_LAUNCHES) == (0, 0, 0)


# --------------------------------------------------------------- knobs


def test_set_knobs_clamps_and_refuses_like_jax():
    port = _port_engine(speculative=dict(k=2, backoff=4))
    ref = _jax_engine(speculative=dict(k=2, backoff=4))
    assert port.knobs() == ref.knobs()
    for payload in ({"prefill_chunk": 100, "spec_k": 9},
                    {"prefill_chunk": 2, "spec_k": 0},
                    {"prefill_chunk": None}, {"spec_k": None}, {}):
        assert port.set_knobs(payload) == ref.set_knobs(payload)
        assert port.scheduler.chunk_tokens == ref.scheduler.chunk_tokens
    for bad in ({"prefill_chunk": 0}, {"spec_k": -1}, {"chunk": 4}):
        for eng in (port, ref):
            with pytest.raises(ValueError):
                eng.set_knobs(bad)
    ref.set_knobs({"prefill_chunk": None, "spec_k": None})


def test_streams_under_live_caps_match_jax():
    """A draft cap and a prefill cap set mid-wave, then lifted: the
    streams equal JAX's under the same schedule and the uncapped ones
    (the caps change how much of each call is used, never a token)."""
    knobs = {0: {"spec_k": 1, "prefill_chunk": 2}, 6: {"spec_k": 0},
             12: {"spec_k": None, "prefill_chunk": None}}
    port = _port_engine(speculative=dict(k=2, backoff=4))
    got = _serve(port, WAVE, knobs=knobs)
    ref = _jax_engine(speculative=dict(k=2, backoff=4))
    want = _serve(ref, WAVE, knobs=knobs)
    ref.set_knobs({"prefill_chunk": None, "spec_k": None})
    assert _streams(got) == _streams(want)
    assert (port.spec_proposed, port.spec_accepted) == \
        (ref.spec_proposed, ref.spec_accepted)
    assert port.prefill_calls > _port_engine().prefill_calls
    assert _streams(got) == _streams(_serve(_port_engine(), WAVE))


# -------------------------------------------------------- export/import

PROMPT = list(range(1, 9))
EXPORT = dict(n_blocks=None)


def _single(**kw):
    eng = _port_engine(**EXPORT, **kw.pop("engine", {}))
    req = eng.submit(PROMPT, 10, **kw)
    eng.run_until_drained()
    return req.output_tokens


def _migrate(src, dst, after=3, sampling=None):
    req = src.submit(PROMPT, 10, sampling=sampling)
    while len(req.output_tokens) < after:
        src.step()
    head = list(req.output_tokens)
    meta, payloads = src.export_request(req)
    s2 = sampling
    if s2 is not None:
        s2 = dataclasses.replace(s2, step_offset=s2.step_offset + len(head))
    moved = dst.import_request(PROMPT + head, 10 - len(head), sampling=s2,
                               cache_len=meta["cache_len"],
                               payloads=payloads)
    src.release_export(req.rid, ok=True)
    dst.run_until_drained()
    return head + moved.output_tokens, meta, payloads, req


@pytest.mark.parametrize("mode", ["greedy", "seeded", "into_drafting"])
def test_export_import_continues_bit_for_bit(mode):
    """Exported after 3 tokens and imported into a fresh engine (one
    that drafts, for ``into_drafting``), the stitched stream is the
    uninterrupted one, bit for bit; both pools' books close."""
    sampling = (SamplingParams(temperature=0.8, top_k=8, seed=7)
                if mode == "seeded" else None)
    dst_kw = ({"speculative": dict(k=3)}
              if mode == "into_drafting" else {})
    src = _port_engine(**EXPORT)
    dst = _port_engine(**EXPORT, **dst_kw)
    stream, meta, _, req = _migrate(src, dst, sampling=sampling)
    assert stream == _single(sampling=sampling)
    assert req.state is RequestState.FINISHED and len(src.exports) == 0
    assert src.introspect()["prefix_cached_blocks"] > 0
    src.scheduler.allocator.check()
    dst.scheduler.allocator.check()


def test_export_meta_and_payload_match_jax_and_jax_payload_imports():
    """The meta dict equals the JAX engine's for the same request, the
    payload's slabs equal JAX's (fp32 cache: atol 1e-5), and JAX's own
    payload imported into the port continues the stream bit for bit."""
    src = _port_engine(**EXPORT)
    req = src.submit(PROMPT, 10)
    jsrc = _jax_engine(**EXPORT)
    jreq = jsrc.submit(PROMPT, 10)
    while len(req.output_tokens) < 3:
        src.step()
        jsrc.step()
    assert req.output_tokens == jreq.output_tokens
    meta, payloads = src.export_request(req)
    jmeta, jpayloads = jsrc.export_request(jreq)
    assert meta == jmeta
    assert len(payloads) == len(jpayloads) == meta["n_blocks"]
    for p, jp in zip(payloads, jpayloads):
        for s, js in zip(p, jp):
            np.testing.assert_allclose(s.numpy(), np.asarray(js),
                                       atol=1e-5, rtol=0)
    head = list(req.output_tokens)
    dst = _port_engine(**EXPORT)
    moved = dst.import_request(
        PROMPT + head, 7, cache_len=jmeta["cache_len"],
        payloads=[tuple(np.asarray(s) for s in p) for p in jpayloads])
    dst.run_until_drained()
    jsrc.release_export(jreq.rid, ok=True)
    src.release_export(req.rid, ok=False)
    assert head + moved.output_tokens == _single()
    assert src.registry.snapshot()["serving/kv_export_aborts"] == 1
    assert dst.registry.snapshot()["serving/kv_import_blocks"] == \
        meta["n_blocks"]


def test_malformed_payload_refused_before_any_write():
    """A slab short, a wrong shape, a wrong dtype: ``ValueError`` with
    the arenas, the slots and the pool as they were; an unstarted or a
    finished request is not exportable."""
    src = _port_engine(**EXPORT)
    req = src.submit(PROMPT, 6)
    with pytest.raises(ValueError):
        src.export_request(req)                   # nothing prefilled
    while len(req.output_tokens) < 2:
        src.step()
    meta, payloads = src.export_request(req)
    dst = _port_engine(**EXPORT)
    before = [a.clone() for a in dst.arenas]
    wire = PROMPT + list(req.output_tokens)
    bad = {
        "torn": [tuple(p[:-1]) for p in payloads],
        "shape": [tuple(s[:, :, :1] for s in p) for p in payloads],
        "dtype": [tuple(s.double() for s in p) for p in payloads],
    }
    for name, torn in bad.items():
        with pytest.raises(ValueError, match="slab"):
            dst.import_request(wire, 4, cache_len=meta["cache_len"],
                               payloads=torn)
    assert all(torch.equal(a, b) for a, b in zip(before, dst.arenas))
    assert dst.scheduler.idle and dst.scheduler.allocator.n_free == \
        dst.scheduler.allocator.n_blocks
    src.release_export(req.rid, ok=False)
    src.release_export(req.rid, ok=False)          # stale: a no-op
    src.scheduler.allocator.check()
    done = src.submit(PROMPT, 2)
    src.run_until_drained()
    with pytest.raises(ValueError):
        src.export_request(done)


def test_export_ledger_in_lockstep_with_jax():
    """Pin, the duplicate pin refused, release into the cache, a stale
    release, a failed migration's release, release_all: the same pool,
    cache and ledger states as JAX's ledger after each call."""
    sides = []
    for al_cls, pc_cls, led_cls in (
            (BlockAllocator, PrefixCache, ExportLedger),
            (jkv.BlockAllocator, jkv.PrefixCache, jkv.ExportLedger)):
        al = al_cls(12)
        pc = pc_cls(al, 4)
        sides.append((al, pc, led_cls(al, pc)))
    tokens = list(range(1, 12))
    seen = [[], []]
    for i, (al, pc, led) in enumerate(sides):
        a = al.alloc(3, owner="r1")
        b = al.alloc(2, owner="r2")
        led.pin("r1", a, tokens, 11)
        with pytest.raises(ValueError):
            led.pin("r1", a, tokens, 11)
        al.free(a, owner="r1")                     # the request leaves
        led.pin("r2", b, tokens[:6], 6)
        seen[i].append((al.n_free, al.n_owned, len(led), len(pc)))
        seen[i].append(led.release("r1", to_cache=True))
        seen[i].append(led.release("r1", to_cache=True))   # stale
        led.check()
        seen[i].append((al.n_free, al.n_owned, len(led), len(pc),
                        pc.evictable()))
        seen[i].append(led.release("r2", to_cache=False))
        al.free(b, owner="r2")
        seen[i].append((al.n_free, al.n_owned, len(led), len(pc)))
        c = al.alloc(1, owner="r3")
        led.pin("r3", c, tokens[:1], 1)
        led.release_all()
        al.free(c, owner="r3")
        seen[i].append(pc.evict_one())
        seen[i].append((al.n_free, len(led), pc.evictions))
        al.check()
        pc.check()
    assert seen[0] == seen[1]


# ------------------------------------------------ introspect, metrics


@pytest.fixture(scope="module")
def wave_pair():
    """The default engine of each side through WAVE with a recorder
    armed: (port, its events, jax, its events)."""
    out = []
    for mk, tl in ((_port_engine, timeline), (_jax_engine, jtimeline)):
        rec = tl.arm(tl.FlightRecorder())
        try:
            eng = mk()
            eng.timeline_tick_every = 2
            reqs = _serve(eng, WAVE)
        finally:
            tl.disarm()
        out += [eng, rec.events(), reqs]
    return out


def test_introspect_has_the_reference_keys(wave_pair):
    port, _, _, ref, _, _ = wave_pair
    got, want = port.introspect(), ref.introspect()
    assert set(got) == set(want)
    assert got["decode_compiles"] is None
    assert got["mfu"] is None and "cpu" in got["mfu_reason"]
    same = ("steps", "active_slots", "free_slots", "free_blocks",
            "total_blocks", "queue_depth", "draining", "admission",
            "kv_occupancy", "prefix_cached_blocks", "prefix_cache_hits",
            "evictions", "preemptions", "kv_exports_pinned", "spec_width",
            "knobs", "decode_calls", "cache_dtype")
    assert {k: got[k] for k in same} == {k: want[k] for k in same}
    assert got["last_decode_ms"] > 0


def test_registry_counters_after_a_wave_match_jax(wave_pair):
    port, _, preqs, ref, _, _ = wave_pair
    got = port.registry.snapshot_typed()
    want = ref.registry.snapshot_typed()
    assert got["counters"] == want["counters"]
    assert got["counters"]["serving/preemptions"] > 0
    assert got["counters"]["serving/tokens_generated"] == \
        sum(n for _, _, n in WAVE)
    assert got["gauges"] == want["gauges"]
    for name in ("serving/ttft_ms", "serving/tpot_ms"):
        assert got["histograms"][name]["count"] == \
            want["histograms"][name]["count"]
    assert port.ttft_ms and len(port.ttft_ms) == len(preqs)


def test_timeline_kinds_and_rids_in_order_match_jax(wave_pair):
    """Every event's kind, request id and payload but its times, in
    order; and the serving goodput report closes the books."""
    _, events, _, _, jevents, _ = wave_pair
    clock = {"t", "dur_s", "wall_ts", "mono_t0"}

    def strip(evs):
        return [{k: v for k, v in e.items() if k not in clock}
                for e in evs]

    assert strip(events) == strip(jevents)
    kinds = {e["kind"] for e in events}
    assert {"request_submit", "request_admit", "prefill",
            "request_prefilled", "decode_tick", "request_preempt",
            "request_finish"} <= kinds
    rep = serving_goodput_report(events)
    assert rep["totals"]["finished"] == len(WAVE)
    assert 0.0 < rep["goodput_fraction"] <= 1.0


def test_flight_recorder_spills_jsonl(tmp_path):
    """The spill holds every event as one JSON line, and the recorder's
    goodput report agrees with JAX's over the same events."""
    import json

    path = tmp_path / "t" / "timeline.jsonl"
    rec = FlightRecorder(str(path))
    rec.emit("request_submit", rid=np.int64(3))
    with rec.scope("drain"):
        pass
    rep = rec.flush()
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [e["kind"] for e in lines] == [
        "run_begin", "request_submit", "drain", "run_end"]
    assert lines[1]["rid"] == 3
    assert rep["buckets"]["drain"] == lines[2]["dur_s"]
    from apex_tpu.observability.goodput import goodput_report
    from apex_tpu_torch.observability.goodput import goodput_report as pgr
    assert pgr(lines) == goodput_report(lines)


# --------------------------------------------------------------- drain


@pytest.mark.parametrize("trip", ["guard", "heartbeat"])
def test_drain_by_guard_or_heartbeat_matches_jax(trip):
    """A tripped guard (or a heartbeat that missed its window, which
    trips it) drains at the next step: the running requests deliver, the
    queue is cancelled, a late submit is refused, as in JAX's engine."""
    results = []
    for mk, guard_cls, hb_cls in (
            (_port_engine, PreemptionGuard, HeartbeatMonitor),
            (_build_jax_engine, JaxPreemptionGuard,
             jmetrics.HeartbeatMonitor)):
        eng = mk(n_blocks=None)
        guard = guard_cls(signals=())
        hb = hb_cls(timeout_s=0.5, on_hang=guard, registry=eng.registry)
        eng.guard, eng.heartbeat = guard, hb
        reqs = [eng.submit(p, n) for _, p, n in WAVE]
        eng.step()
        assert hb.last_step == 1 and not hb.check_now()
        if trip == "guard":
            guard.trigger()
        else:
            hb.timeout_s = 0.02
            time.sleep(0.05)
            assert hb.check_now() and guard.triggered
        eng.step()
        late = eng.submit([1, 2], 2)
        eng.run_until_drained()
        results.append(([r.state.value for r in reqs + [late]],
                        _streams(reqs), eng.draining, hb.hang_count))
        eng.guard = eng.heartbeat = None
    assert results[0] == results[1]
    states = results[0][0]
    assert states == ["finished"] * 3 + ["cancelled"] * 2 + ["rejected"]


# ------------------------------------------------ heartbeat, histogram


def test_heartbeat_monitor_matches_jax():
    """Beats, a missed window firing ``on_hang`` (a guard, or a plain
    callable) once per episode, the re-arm by the next beat, and the
    registry's heartbeat gauges and hang counter."""
    seen = []
    for hb_cls, reg_cls in ((HeartbeatMonitor, MetricRegistry),
                            (jmetrics.HeartbeatMonitor,
                             jmetrics.MetricRegistry)):
        fired = []
        reg = reg_cls()
        hb = hb_cls(timeout_s=0.02, on_hang=lambda: fired.append(1),
                    registry=reg)
        trace = [hb.check_now()]                 # not armed yet
        hb.beat(1)
        trace.append(hb.check_now())
        time.sleep(0.04)
        trace += [hb.check_now(), hb.check_now()]
        hb.beat(2)
        trace.append(hb.hung)
        time.sleep(0.04)
        trace.append(hb.check_now())
        snap = reg.snapshot()
        seen.append((trace, len(fired), hb.hang_count, hb.last_step,
                     snap["heartbeat/last_step"], snap["heartbeat/hangs"]))
        with pytest.raises(ValueError):
            hb_cls(timeout_s=0)
    assert seen[0] == seen[1]
    assert seen[0][1] == 2


def test_histogram_percentiles_match_jax():
    rng = np.random.default_rng(4)
    values = rng.standard_normal(300) * 10
    port, ref = Histogram(keep_samples=128), jmetrics.Histogram(
        keep_samples=128)
    assert port.percentile(50) is None and ref.percentile(50) is None
    for v in values:
        port.observe(v)
        ref.observe(v)
    for q in (0, 1, 25, 50, 90, 99, 99.9, 100):
        assert port.percentile(q) == ref.percentile(q)
    assert port.summary() == ref.summary()
    bare = Histogram()
    bare.observe(1.0)
    assert bare.percentile(50) is None and "p50" not in bare.summary()


def test_mfu_peak_table_names_the_h100(monkeypatch):
    """The H100 takes NVIDIA's dense bf16 peak; another card and the CPU
    get the reason instead of a number."""
    assert peak_flops_reason(None)[0] is None
    peak, why = peak_flops_reason("cpu")
    assert peak is None and "'cpu'" in why
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert peak_flops_reason("cuda") == (989e12, None)
    value, why = mfu_or_reason(989e12 * 0.5, 1.0, device="cuda")
    assert value == 0.5 and why is None
    assert mfu_or_reason(1e12, 1.0, device="cuda", n_devices=2)[0] == \
        pytest.approx(1e12 / (2 * 989e12))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA A100-SXM4-80GB")
    peak, why = peak_flops_reason("cuda")
    assert peak is None and "a100" in why
    assert mfu_or_reason(None, 1.0, device="cuda")[0] is None


def test_engine_counts_decode_flops_with_the_attention():
    """The decode call's FLOP count grows with the live context (the
    paged attention's work is counted, not zero) and with LoRA."""
    eng = _port_engine(n_blocks=None)
    eng.submit(PROMPT, 3)
    eng.step()
    eng.step()
    B = SHAPE["max_batch"]
    pos, nd, act = np.zeros(B), np.zeros(B, np.int64), np.zeros(B, bool)
    base = eng._decode_flops(pos, nd, act)
    act[0], pos[0] = True, 20
    grown = eng._decode_flops(pos, nd, act)
    n, d, L = TCFG.num_attention_heads, TCFG.head_dim, TCFG.num_layers
    assert grown - base == 4 * n * d * 21 * L
    assert eng._last_decode_flops > base
