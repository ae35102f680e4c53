"""The port's multi-LoRA serving against the JAX package.

- The plain gathered delta (L1's CPU path) against the JAX Pallas kernel
  in interpret mode and its ``jnp.take`` twin.
- The adapter arena's refcounting in lockstep with the JAX arena, the
  fixture weights and their packing.
- ``adapter_id=None`` bitwise the bare model and engine (greedy, seeded,
  speculative with an int8 cache), and mixed-adapter streams equal to
  the JAX LoRA engine's through a hot swap and an LRU eviction.

Tolerances: fp32 deltas atol = rtol = 1e-5 (the same fp32 products
summed in another order); bf16 deltas one bf16 step (2**-7 relative:
both sides round the same fp32 sums once, which may land one step
apart); the zero adapter's rows exactly 0.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apex_tpu.observability.metrics import MetricRegistry
from apex_tpu.serving import LoRAConfig as JaxLoRAConfig
from apex_tpu.serving import SamplingParams as JaxSamplingParams
from apex_tpu.serving import ServingConfig as JaxServingConfig
from apex_tpu.serving import ServingEngine as JaxServingEngine
from apex_tpu.serving import lora as jax_lora
from apex_tpu_torch.serving import (
    AdapterArena,
    DecodeModel,
    LoRAConfig,
    OutOfAdapterSlotsError,
    SamplingParams,
    ServingConfig,
    ServingEngine,
    SpeculativeConfig,
    init_kv_arena,
)
from apex_tpu_torch.serving import lora
from apex_tpu_torch.serving.bridge import from_jax_params
from apex_tpu_torch.serving.scheduler import RequestState

from test_torch_serving import (
    GPT,
    MODERN,
    VOCAB,
    WAVE,
    _as_jax,
    _cache as _kv_config,
    _configs,
    _greedy,
    _jax_tree,
    _mesh,
    _t,
)

# ------------------------------------------------------------- kernel


def _delta_inputs(rng, S, B, IN, r, OUT, n_slots):
    x = rng.standard_normal((S, B, IN)).astype(np.float32)
    a = rng.standard_normal((n_slots, IN, r)).astype(np.float32)
    b = rng.standard_normal((n_slots, r, OUT)).astype(np.float32)
    a[0] = 0.0                      # slot 0: the zero adapter
    b[0] = 0.0
    return x, a, b


@pytest.mark.parametrize("S", [1, 5])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_delta_matches_jax_fused_and_unfused(dtype, S):
    rng = np.random.default_rng(7 + S)
    B, IN, r, OUT, n_slots = 5, 32, 4, 24, 5
    x, a, b = _delta_inputs(rng, S, B, IN, r, OUT, n_slots)
    slots = np.asarray([2, 0, 4, 2, 0], np.int32)   # zero and repeated
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    tx, ta, tb = (torch.from_numpy(v).to(tdt) for v in (x, a, b))
    # both sides from the same (rounded) values
    jx, ja, jb = (jnp.asarray(v.float().numpy(), jdt) for v in (tx, ta, tb))
    got = lora.lora_delta(tx, ta, tb, torch.from_numpy(slots))
    assert got.dtype == tdt and got.shape == (S, B, OUT)
    assert lora.LAUNCHES == 0
    fused = jax_lora.lora_delta_fused(jx, ja, jb, jnp.asarray(slots))
    unfused = jax_lora.lora_delta_unfused(jx, ja, jb, jnp.asarray(slots))
    tol = (dict(atol=1e-5, rtol=1e-5) if dtype == "fp32"
           else dict(atol=1e-6, rtol=2.0 ** -7))
    for want in (fused, unfused):
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)),
            **tol)
    # the zero slot gives exact zeros: what makes adapter_id=None bitwise
    assert not got[:, slots == 0].any()
    torch.testing.assert_close(
        got, lora.lora_delta_plain(tx, ta, tb, torch.from_numpy(slots)),
        atol=0, rtol=0)


def test_delta_takes_strided_x_and_checks_its_operands():
    """A sequence-major view with strides (no copy needed) gives the
    same delta as its contiguous copy; bad shapes raise; other devices
    launch a kernel or raise (no kernel for "meta")."""
    rng = np.random.default_rng(3)
    x, a, b = _delta_inputs(rng, 3, 4, 16, 2, 8, 3)
    slots = torch.tensor([1, 2, 0, 1], dtype=torch.int32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    bsx = torch.from_numpy(x).transpose(0, 1).contiguous()   # [B, S, in]
    view = bsx.transpose(0, 1)                               # [S, B, in]
    assert not view.is_contiguous()
    torch.testing.assert_close(lora.lora_delta(view, ta, tb, slots),
                               lora.lora_delta(view.contiguous(), ta, tb,
                                               slots), atol=0, rtol=0)
    with pytest.raises(ValueError, match="do not chain"):
        lora.lora_delta(view[..., :-1], ta, tb, slots)
    with pytest.raises(ValueError, match="slots"):
        lora.lora_delta(view, ta, tb, slots[:3])
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        lora.lora_delta(torch.empty(3, 4, 16, **meta),
                        torch.empty(3, 16, 2, **meta),
                        torch.empty(3, 2, 8, **meta),
                        torch.empty(4, dtype=torch.int32, **meta))
    assert lora.LAUNCHES == 0


def _aligned_view(t, offset):
    """``t``'s values in a fresh buffer, ``offset`` elements past its
    start (a misaligned view for ``offset`` not a multiple of 16 bytes)."""
    flat = torch.empty(t.numel() + offset, dtype=t.dtype)
    view = flat[offset:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("case,route", [
    ("r8", "cluster"), ("r4", "cluster"), ("r16", "cluster"),
    ("r8 bf16", "cluster"), ("r8 strided x", "cluster"),
    ("r1", "simt"), ("r12", "simt"), ("r32", "simt"),
    ("r8 a misaligned", "simt"), ("r8 b misaligned", "simt"),
])
def test_lora_route(case, route):
    """The cluster route takes ranks 4, 8 and 16 over 16-byte-aligned A
    and B (x may be a strided view); any other rank or alignment takes
    the first kernel.  On the CPU the route is only named: nothing
    launches."""
    r = int(case.split()[0][1:])
    dtype = torch.bfloat16 if "bf16" in case else torch.float32
    x = torch.zeros((5, 4, 64), dtype=dtype)
    a = torch.zeros((3, 64, r), dtype=dtype)
    b = torch.zeros((3, r, 40), dtype=dtype)
    if case.endswith("strided x"):
        x = torch.zeros((4, 5, 64), dtype=dtype).transpose(0, 1)
    if case.endswith("a misaligned"):
        a = _aligned_view(a, 1)
    if case.endswith("b misaligned"):
        b = _aligned_view(b, 1)
    assert lora.lora_route(x, a, b) == route
    lora.lora_delta(x, a, b, torch.zeros(4, dtype=torch.int32))
    assert (lora.LAUNCHES, lora.CLUSTER_LAUNCHES,
            lora.SIMT_LAUNCHES) == (0, 0, 0)


# the cluster route's arithmetic (csrc/lora_delta.cu, lora_cluster_kernel),
# in plain torch: a cluster of 8 CTAs per (slot, tile of 8 rows up to S = 8,
# else 16); CTA q takes the q-th slice of in (whole 16-byte chunks of x);
# a row's k in the slice go to the 32 lanes of one of nsplit warps (lane l
# of split sp: k0 + sp * 32 + l + m * nsplit * 32), each lane sums its
# products in order, the lanes meet in the xor-shuffle tree, the splits in
# order, the 8 partials in rank order; then y = t @ B summed over the rank
# in order, one cast
CLUSTER_RANKS = 8


def _shuffle_sum(v):
    """``__shfl_xor_sync`` tree over the last-but-one axis of 32 lanes."""
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ o, :]
    return v[..., 0, :]


def _cluster_delta(x, a, b, slots):
    S, B, n_in = x.shape
    r, n_out = b.shape[1], b.shape[2]
    xv = 16 // x.element_size()
    tile = 8 if S <= 8 else 16
    k_per = -(-n_in // (CLUSTER_RANKS * xv)) * xv
    x32, a32, b32 = x.float(), a.float(), b.float()
    y = torch.empty((S, B, n_out))
    for i in range(B):
        slot = int(slots[i])
        for s0 in range(0, S, tile):
            rows = min(tile, S - s0)
            nsplit = 8 // min(rows, 8)
            xr = x32[s0:s0 + rows, i]                        # [rows, in]
            t = None
            for q in range(CLUSTER_RANKS):
                k0 = min(n_in, q * k_per)
                k1 = min(n_in, k0 + k_per)
                part = torch.zeros((rows, r))
                for sp in range(nsplit):
                    acc = torch.zeros((rows, 32, r))         # one per lane
                    for first in range(k0 + sp * 32, k1, nsplit * 32):
                        k = first + torch.arange(32)
                        live = k < k1
                        kk = torch.where(live, k, 0)
                        term = xr[:, kk, None] * a32[slot, kk][None]
                        acc = acc + torch.where(live[None, :, None], term, 0.0)
                    part = part + _shuffle_sum(acc)
                t = part if t is None else t + part
            out = torch.zeros((rows, n_out))
            for j in range(r):
                out = out + t[:, j, None] * b32[slot, j][None]
            y[s0:s0 + rows, i] = out
    return y.to(x.dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("S,IN,r,OUT", [
    (1, 96, 8, 64), (5, 100, 4, 37), (5, 770, 8, 24), (17, 130, 16, 50)])
def test_tile_contract_matches_jax(S, IN, r, OUT, dtype):
    """The cluster route's decomposition (slices of in per CTA, k per
    lane, the shuffle tree, the splits and ranks in order) stays within
    the plain delta's tolerances of the JAX kernel (Pallas in interpret
    mode) at S = 1, 5 and 17, ragged in and out, ranks 4, 8 and 16; the
    zero adapter's rows are exact zeros.  A is scaled by 1/sqrt(in) and B
    by 1/sqrt(r), so t and y are of order 1, as a trained adapter's are:
    with unit-normal A and B the outputs reach a few hundred at in = 770,
    and the plain delta itself then differs from JAX's by more than 1e-5
    through summation order alone."""
    rng = np.random.default_rng(11 + S + IN + r)
    B, n_slots = 4, 5
    x, a, b = _delta_inputs(rng, S, B, IN, r, OUT, n_slots)
    a, b = a / np.float32(IN ** 0.5), b / np.float32(r ** 0.5)
    slots = np.asarray([3, 0, 1, 3], np.int32)
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    tx, ta, tb = (torch.from_numpy(v).to(tdt) for v in (x, a, b))
    jx, ja, jb = (jnp.asarray(v.float().numpy(), jdt) for v in (tx, ta, tb))
    got = _cluster_delta(tx, ta, tb, torch.from_numpy(slots))
    want = jax_lora.lora_delta_fused(jx, ja, jb, jnp.asarray(slots))
    tol = (dict(atol=1e-5, rtol=1e-5) if dtype == "fp32"
           else dict(atol=1e-6, rtol=2.0 ** -7))
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)), **tol)
    assert not got[:, slots == 0].any()


# -------------------------------------------------------------- arena


def test_arena_churn_matches_jax_and_strands_nothing():
    """200 seeded steps of register / pin / unpin / unregister churn on a
    4-resident arena, in lockstep with the JAX arena: the same slots,
    evictions and refusals, the invariants after every step, and after
    the storm every slot but the zero adapter free again."""
    rng = np.random.default_rng(17)
    port, ref = AdapterArena(n_slots=5), jax_lora.AdapterArena(n_slots=5)
    ids = [f"tenant-{i}" for i in range(12)]
    pins = {}
    next_rid = 0
    refused = 0
    for _ in range(200):
        op = int(rng.choice(4, p=[0.35, 0.35, 0.2, 0.1]))
        residents = port.residents()
        assert residents == ref.residents()
        if op == 0:
            aid = ids[int(rng.integers(len(ids)))]
            try:
                got = port.register(aid)
            except OutOfAdapterSlotsError:
                with pytest.raises(jax_lora.OutOfAdapterSlotsError):
                    ref.register(aid)
                assert set(residents) <= set(pins.values())
                refused += 1
            else:
                assert got == ref.register(aid)
                assert 0 < got[0] < port.n_slots
        elif op == 1 and residents:
            aid = residents[int(rng.integers(len(residents)))]
            assert port.pin(aid, next_rid) == ref.pin(aid, next_rid)
            pins[next_rid] = aid
            next_rid += 1
        elif op == 2 and pins:
            rid = list(pins)[int(rng.integers(len(pins)))]
            del pins[rid]
            port.unpin(rid)
            ref.unpin(rid)
        elif op == 3 and residents:
            aid = residents[int(rng.integers(len(residents)))]
            assert port.unregister(aid) == ref.unregister(aid)
        port.check()
        assert port.active == ref.active == len(pins)
    for rid in list(pins):
        port.unpin(rid)
    for aid in port.residents():
        port.unregister(aid)
    port.check()
    assert port.allocator.n_free == port.n_slots - 1 and port.active == 0
    assert (port.loads, port.evictions) == (ref.loads, ref.evictions)
    assert port.evictions > 0 and refused > 0, \
        "the churn never evicted or refused: the test tested nothing"


def test_arena_all_pinned_raises_and_unpin_is_idempotent():
    arena = AdapterArena(n_slots=3)
    arena.register("a")
    arena.register("b")
    arena.pin("a", rid=1)
    arena.pin("b", rid=2)
    with pytest.raises(OutOfAdapterSlotsError, match="pinned"):
        arena.register("c")
    arena.unregister("b")             # pinned: the slot outlives it
    assert not arena.resident("b") and arena.allocator.n_free == 0
    arena.unpin(2)
    assert arena.allocator.n_free == 1
    assert arena.register("c")[1] is None
    arena.unpin(2)                    # idempotent
    arena.unpin(99)                   # never pinned
    arena.check()
    with pytest.raises(ValueError, match=">= 2 slots"):
        AdapterArena(n_slots=1)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_fixture_weights_and_packing_match_jax(dtype):
    jcfg, tcfg = _configs(MODERN)
    cfg = LoRAConfig(rank=4, max_adapters=2)
    jlora = JaxLoRAConfig(rank=4, max_adapters=2)
    w = lora.init_adapter_weights(tcfg, cfg, seed=3)
    jw = jax_lora.init_adapter_weights(jcfg, jlora, seed=3)
    assert lora.adapter_shapes(tcfg, cfg) == \
        jax_lora.adapter_shapes(jcfg, jlora)
    for proj in lora.PROJECTIONS:
        for got, want in zip(w[proj], jw[proj]):
            np.testing.assert_array_equal(got, want)
    jdt, tdt = {"fp32": (np.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    vals = lora.pack_adapter_values(tcfg, cfg, w, tdt)
    jvals = jax_lora.pack_adapter_values(jcfg, jlora, w, jdt)
    assert len(vals) == 8
    for got, want in zip(vals, jvals):
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    with pytest.raises(ValueError, match="missing projection"):
        lora.pack_adapter_values(tcfg, cfg, {"qkv": w["qkv"]})
    bad = dict(w, fc1=(w["fc1"][0][:, :-1, :], w["fc1"][1]))
    with pytest.raises(ValueError, match="do not match arena"):
        lora.pack_adapter_values(tcfg, cfg, bad)
    with pytest.raises(ValueError, match="do not match arena"):
        lora.pack_adapter_values(
            tcfg, cfg, lora.init_adapter_weights(
                tcfg, LoRAConfig(rank=2), seed=0))


# -------------------------------------------------------------- model


@pytest.mark.parametrize("shape", [GPT, MODERN], ids=["gpt", "modern"])
def test_zero_adapter_is_bitwise_the_bare_model(shape):
    """Prefill and a decode step with adapters resident in slots 1-2 but
    every batch slot on the zero adapter: logits bit for bit the bare
    model's (the adapter path repeats the bare ops in order and adds
    exact zeros); on an adapter slot they move."""
    jcfg, tcfg = _configs(shape)
    params = from_jax_params(_jax_tree(jcfg, 4))
    cfg = LoRAConfig(rank=4, max_adapters=2)
    cache = _kv_config(tcfg, 8, 4)
    bare = DecodeModel(tcfg, cache, device="cpu")
    tuned = DecodeModel(tcfg, cache, lora=cfg, device="cpu")
    bare.load_params(params)
    tuned.load_params(params)
    adapters = lora.init_adapter_arena(tcfg, cfg, device="cpu")
    for slot in (1, 2):
        vals = lora.pack_adapter_values(
            tcfg, cfg, lora.init_adapter_weights(tcfg, cfg, seed=slot))
        for arena, val in zip(adapters, vals):
            arena[:, slot].copy_(val)

    B, T = 2, 5
    rng = np.random.default_rng(6)
    tokens = rng.integers(1, VOCAB, (B, T)).astype(np.int64)
    pos = np.tile(np.arange(T), (B, 1))
    tables = np.asarray([[0, 1, 0, 0], [2, 3, 0, 0]], np.int32)
    lengths = np.full((B,), T, np.int32)
    limits = (pos + 1).astype(np.int32)
    db, do = tables[:, :2][:, pos[0] // 4], pos % 4
    si = np.full((B,), T - 1)
    args = _t(tokens, pos, tables, lengths, limits, db, do, si)
    zero = torch.zeros(B, dtype=torch.int32)
    outs = []
    for model, kw in ((bare, {}),
                      (tuned, dict(adapters=adapters, adapter_slots=zero)),
                      (tuned, dict(adapters=adapters,
                                   adapter_slots=zero + 1))):
        arenas = init_kv_arena(cache, device="cpu")
        _, p_logits = model.prefill(arenas, *args, *_t(*_greedy(B)), **kw)
        step = _t(tokens[:, -1:], lengths, tables, np.ones((B,), bool))
        _, _, d_logits = model.decode_step(arenas, *step, *_t(*_greedy(B)),
                                           **kw)
        outs.append((p_logits, d_logits))
    for got, want in zip(outs[1], outs[0]):
        assert torch.equal(got, want)
    assert not torch.allclose(outs[2][1], outs[0][1], atol=1e-3)
    with pytest.raises(ValueError, match="both adapters"):
        tuned.decode_step(init_kv_arena(cache, device="cpu"), *step,
                          *_t(*_greedy(B)), adapters=adapters)


# ------------------------------------------------------------- engine

SHAPE = dict(max_batch=3, block_size=4, max_seq=32, prefill_len=6)
LORA = LoRAConfig(rank=4, max_adapters=3)


def _serve(engine, wave, *, sampling=None):
    reqs, pending, step = [], list(wave), 0
    while pending or not engine.scheduler.idle:
        while pending and pending[0][0] <= step:
            _, prompt, n_new = pending.pop(0)
            reqs.append(engine.submit(prompt, n_new, sampling=sampling))
        engine.step()
        step += 1
        assert step < 1000, "wave did not drain"
    engine.scheduler.allocator.check()
    assert all(r.state is RequestState.FINISHED for r in reqs)
    return [r.output_tokens for r in reqs]


@pytest.mark.parametrize("mode", ["greedy", "seeded", "spec_int8"])
def test_adapter_none_streams_are_the_bare_engines(mode):
    """A LoRA engine with adapters registered serves ``adapter_id=None``
    requests token for token as the bare engine: greedy, seeded, and
    through the k+1 verify over an int8 cache."""
    jcfg, tcfg = _configs(GPT)
    tree = _jax_tree(jcfg, 3)
    kw = (dict(cache_dtype=torch.int8,
               speculative=SpeculativeConfig(k=2, backoff=4))
          if mode == "spec_int8" else {})
    bare = ServingEngine(tcfg, ServingConfig(**SHAPE, **kw),
                         from_jax_params(tree), device="cpu")
    tuned = ServingEngine(tcfg, ServingConfig(**SHAPE, lora=LORA, **kw),
                          from_jax_params(tree), device="cpu")
    for aid in ("tenant-a", "tenant-b"):
        tuned.register_adapter(aid)
    sp = (SamplingParams(temperature=1.2, top_p=0.9, seed=42)
          if mode == "seeded" else None)
    assert _serve(tuned, WAVE, sampling=sp) == _serve(bare, WAVE,
                                                      sampling=sp)
    if mode == "spec_int8":
        assert tuned.spec_proposed > 0, "speculation never engaged"
    assert tuned.adapter_arena.active == 0


def _lockstep(engines, script):
    """Drive the engines through the same calls, registering the same
    numpy weights in each; returns each engine's requests by name."""
    _, tcfg = _configs(GPT)
    out = [{} for _ in engines]
    for action, *args in script:
        if action == "register":
            aid, seed = args
            weights = lora.init_adapter_weights(tcfg, LORA, seed=seed)
        for eng, reqs in zip(engines, out):
            if action == "register":
                eng.register_adapter(aid, weights)
            elif action == "submit":
                name, prompt, n_new, aid = args
                make = (JaxSamplingParams if isinstance(eng, JaxServingEngine)
                        else SamplingParams)
                reqs[name] = eng.submit(prompt, n_new,
                                        sampling=make(adapter_id=aid))
            elif action == "step":
                eng.step()
            else:
                eng.run_until_drained(max_steps=2000)
    return out


def test_mixed_adapter_streams_match_jax_with_hot_swap_and_eviction():
    """Tagged and bare requests in one batch, a hot swap after the first
    tick and an LRU eviction after the drain: every stream equals the
    JAX LoRA engine's on the same weights and adapters, distinct
    adapters give distinct streams, and the arena's books close."""
    jcfg, tcfg = _configs(GPT)
    tree = _jax_tree(jcfg, 3)
    port = ServingEngine(tcfg, ServingConfig(**SHAPE, lora=LORA),
                         from_jax_params(tree), device="cpu")
    ref = JaxServingEngine(
        jcfg, JaxServingConfig(**SHAPE, lora=JaxLoRAConfig(
            rank=LORA.rank, max_adapters=LORA.max_adapters)),
        _as_jax(tree), mesh=_mesh(), registry=MetricRegistry())
    prompt = [9, 8, 7, 6, 5]
    script = [("register", "t0", 10), ("register", "t1", 11),
              ("register", "t2", 12)]
    for i, aid in enumerate(["t0", "t1", "t2", None, "t0", "t2"]):
        script.append(("submit", f"r{i}", prompt + [i + 1], 8, aid))
    script += [("step",), ("register", "t2", 99),      # hot swap
               ("run",), ("register", "t3", 13),       # LRU eviction
               ("submit", "late", prompt, 8, "t3"),
               ("submit", "bare", prompt, 8, None), ("run",)]
    p_reqs, j_reqs = _lockstep([port, ref], script)
    for name, req in p_reqs.items():
        assert req.state is RequestState.FINISHED, name
        assert req.output_tokens == j_reqs[name].output_tokens, name
    arena = port.adapter_arena
    assert arena.residents() == ref.adapter_arena.residents()
    assert "t3" in arena.residents() and len(arena) == 3
    assert arena.evictions == ref.adapter_arena.evictions == 1
    assert arena.active == 0
    arena.check()
    streams = {n: r.output_tokens for n, r in p_reqs.items()}
    assert streams["r0"] != streams["r3"] and streams["r1"] != streams["r3"]
    assert streams["r0"] != streams["r1"]
    assert streams["late"] != streams["bare"]


def test_unknown_adapter_is_rejected():
    """An adapter that is not resident, or any adapter on an engine
    without LoRA, is refused at the door with ``REJECTED``: never
    queued, counted, nothing pinned."""
    _, tcfg = _configs(GPT)
    params = from_jax_params(_jax_tree(_configs(GPT)[0], 3))
    eng = ServingEngine(tcfg, ServingConfig(**SHAPE, lora=LORA), params,
                        device="cpu")
    ghost = eng.submit([1, 2, 3], 4,
                       sampling=SamplingParams(adapter_id="ghost"))
    assert ghost.state is RequestState.REJECTED and not ghost.output_tokens
    assert eng.scheduler.idle and eng.requests_rejected == 1
    eng.register_adapter("fleeting")
    eng.unregister_adapter("fleeting")
    gone = eng.submit([1, 2], 3,
                      sampling=SamplingParams(adapter_id="fleeting"))
    assert gone.state is RequestState.REJECTED
    assert eng.adapter_arena.active == 0 and eng.requests_rejected == 2
    bare = ServingEngine(tcfg, ServingConfig(**SHAPE), params, device="cpu")
    req = bare.submit([1, 2, 3], 4,
                      sampling=SamplingParams(adapter_id="tenant-a"))
    assert req.state is RequestState.REJECTED and bare.scheduler.idle
    with pytest.raises(RuntimeError, match="lora is None"):
        bare.register_adapter("tenant-a")
