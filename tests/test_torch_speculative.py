"""The port's speculative decoding against the JAX package.

- The n-gram proposer (a numpy copy) against the JAX original on seeded
  streams: suffix matching, back-off, probe, re-arm, the per-(slot,
  adapter) state and its cap.
- The k+1 verify through ``paged_attention_decode`` (4-D q + limits,
  the plain version on the CPU) against the JAX multi-query sweep in
  Pallas interpret mode, fp32 / bf16 / int8 caches, with padding rows.
- ``DecodeModel.decode_step`` at ``S = k + 1`` against the JAX step from
  bridged weights.
- Greedy streams of the port's speculative engine against the JAX
  speculative engine and the port's own plain engine (k = 2 and 4, an
  int8 cache with forced preemption, oracle and always-wrong proposers),
  and a seeded sampled stream with speculation on and off.

Tolerances: the verify attention atol = rtol = 1e-5 (both sides in fp32,
the sums in another order); the verify logits atol = rtol = 1e-5 (fp32
weights, cache and compute; the GEMMs sum in another order).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apex_tpu.observability.metrics import MetricRegistry
from apex_tpu.serving import SamplingParams as JaxSamplingParams
from apex_tpu.serving import ServingConfig as JaxServingConfig
from apex_tpu.serving import ServingEngine as JaxServingEngine
from apex_tpu.serving import SpeculativeConfig as JaxSpeculativeConfig
from apex_tpu.serving import paged_attention as jax_pa
from apex_tpu.serving import speculative as jax_spec
from apex_tpu.serving.scheduler import Request as JaxRequest
from apex_tpu_torch.serving import (
    DecodeModel,
    NGramProposer,
    SamplingParams,
    ServingConfig,
    ServingEngine,
    SpeculativeConfig,
    init_kv_arena,
    ngram_propose,
)
from apex_tpu_torch.serving import paged_attention as pa
from apex_tpu_torch.serving.bridge import from_jax_params
from apex_tpu_torch.serving.scheduler import Request
from apex_tpu_torch.transformer.testing.gpt_parallel_train import (
    init_gpt_params,
)

from test_torch_paged_attention import D, G, LENGTHS, _cache, _tables, _to_np
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

TOL = dict(atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------ proposer


@pytest.mark.parametrize("max_ngram,min_ngram", [(3, 1), (2, 2), (4, 2)])
def test_ngram_propose_matches_jax(max_ngram, min_ngram):
    """Seeded streams over small vocabularies (so suffixes recur), every
    k from 0 to 6: the same drafts as the JAX original."""
    rng = np.random.default_rng(max_ngram * 10 + min_ngram)
    hits = 0
    for _ in range(150):
        vocab = int(rng.integers(2, 9))
        stream = rng.integers(0, vocab, int(rng.integers(1, 40))).tolist()
        for k in range(7):
            got = ngram_propose(stream, k, max_ngram=max_ngram,
                                min_ngram=min_ngram)
            want = jax_spec.ngram_propose(stream, k, max_ngram=max_ngram,
                                          min_ngram=min_ngram)
            assert got == want, (stream, k)
            hits += bool(got)
    assert hits > 100
    # the reference's own cases: the longer match wins, cycles
    # self-extend, no match is empty
    toks = [7, 8, 9, 5, 8, 9, 6, 7, 8, 9]
    assert ngram_propose(toks, 2, max_ngram=3) == [5, 8]
    assert ngram_propose([3, 9, 4, 9, 4, 9], 4) == [4, 9, 4, 9]
    assert ngram_propose([1, 2, 3, 4, 5], 4) == []


def _twins(rid, prompt, slot, adapter_id):
    """The same request on both sides."""
    port = Request(rid=rid, prompt=np.asarray(prompt, np.int32),
                   max_new_tokens=64,
                   sampling=SamplingParams(adapter_id=adapter_id))
    ref = JaxRequest(rid=rid, prompt=np.asarray(prompt, np.int32),
                     max_new_tokens=64,
                     sampling=JaxSamplingParams(adapter_id=adapter_id))
    port.slot = ref.slot = slot
    return port, ref


def test_proposer_backoff_probe_rearm_and_keyed_state_match_jax():
    """300 seeded propose/observe rounds over bare and adapter-tagged
    requests sharing slots, mostly rejected (so back-off and probes
    fire), sometimes accepted (re-arm): the drafts, the per-request
    counters and the (slot, adapter) table match the JAX proposer's
    after every round, with the table's cap lowered to 4 so it evicts;
    then the real cap holds."""
    rng = np.random.default_rng(5)
    cfg = dict(k=3, backoff=2, probe_every=3)
    port = NGramProposer(SpeculativeConfig(**cfg))
    ref = jax_spec.NGramProposer(JaxSpeculativeConfig(**cfg))
    port._STATE_CAP = ref._STATE_CAP = 4
    motif = [1, 2, 3, 1, 2]
    pairs = [_twins(i, motif * 2, slot=i % 3,
                    adapter_id=None if i % 4 == 0 else f"a{i % 7}")
             for i in range(12)]
    seen = {"probe": 0, "silent": 0, "rearm": 0}
    for _ in range(300):
        p_req, j_req = pairs[int(rng.integers(len(pairs)))]
        max_k = int(rng.integers(1, 4))
        draft = port.propose(p_req, max_k)
        assert draft == ref.propose(j_req, max_k)
        if not draft:
            seen["silent"] += 1
        elif len(draft) == 1 and max_k > 1:
            seen["probe"] += 1
        accepted = (int(rng.integers(0, len(draft) + 1))
                    if draft and rng.random() < 0.2 else 0)
        seen["rearm"] += accepted > 0
        port.observe(p_req, len(draft), accepted)
        ref.observe(j_req, len(draft), accepted)
        token = int(rng.integers(1, 4))
        p_req.output_tokens.append(token)
        j_req.output_tokens.append(token)
        assert (p_req.spec_fails, p_req.spec_quiet) == \
            (j_req.spec_fails, j_req.spec_quiet)
        assert port._adapter_state == ref._adapter_state
        assert list(port._adapter_state) == list(ref._adapter_state)
    assert min(seen.values()) > 0, seen
    # the real cap bounds the table
    big = NGramProposer(SpeculativeConfig(k=2))
    for i in range(NGramProposer._STATE_CAP + 7):
        req, _ = _twins(i, [1, 2, 1, 2], slot=i % 8, adapter_id=f"a{i}")
        big.propose(req, 2)
    assert len(big._adapter_state) == NGramProposer._STATE_CAP


@pytest.mark.parametrize("kwargs,match", [
    (dict(k=0), "k must be >= 1"),
    (dict(min_ngram=3, max_ngram=2), "min_ngram"),
    (dict(min_ngram=0), "min_ngram"),
    (dict(backoff=0), "backoff"),
    (dict(probe_every=0), "probe_every"),
])
def test_speculative_config_validation_matches_jax(kwargs, match):
    with pytest.raises(ValueError, match=match) as got:
        SpeculativeConfig(**kwargs)
    with pytest.raises(ValueError) as want:
        JaxSpeculativeConfig(**kwargs)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------- verify kernel


@pytest.mark.parametrize("cache_dtype", ["fp32", "bf16", "int8"])
def test_decode_entry_4d_matches_jax_multi_query(cache_dtype):
    """The k+1 verify (4-D q + limits through the decode entry point):
    per slot, position t attends up to ``pos + t + 1``, positions past
    the slot's draft count are padding (limit 0, exact zeros); slot 0
    is inactive.  Equal to the JAX sweep, and to the chunked-prefill
    entry point, with no kernel launched on the CPU."""
    rng = np.random.default_rng(30)
    (jk, jv, jsc), (tk, tv, tsc) = _cache(rng, cache_dtype)
    S, b, n = 5, len(LENGTHS), 2 * G
    q = rng.standard_normal((b, S, n, D)).astype(np.float32)
    tables = _tables(rng, LENGTHS)
    n_draft = np.minimum([0, 3, 4, 2], np.maximum(LENGTHS - 1, 0))
    limits = np.zeros((b, S), np.int32)
    for i, length in enumerate(LENGTHS):
        if length:
            w = n_draft[i] + 1
            limits[i, :w] = length - w + 1 + np.arange(w)
    want = jax_pa.paged_attention_decode(
        jnp.asarray(q), jk, jv, jnp.asarray(tables), jnp.asarray(LENGTHS),
        limits=jnp.asarray(limits), **jsc)
    args = (torch.from_numpy(q), tk, tv, torch.from_numpy(tables),
            torch.from_numpy(LENGTHS))
    got = pa.paged_attention_decode(*args, limits=torch.from_numpy(limits),
                                    **tsc)
    assert got.shape == (b, S, n, D)
    np.testing.assert_allclose(got.numpy(), _to_np(want), **TOL)
    pad = torch.from_numpy(limits == 0)
    assert pad.sum() >= 8 and not got[pad].any(), \
        "padding rows (limit 0) must give exact zeros"
    prefill = pa.paged_prefill_attention(*args, torch.from_numpy(limits),
                                         **tsc)
    torch.testing.assert_close(got, prefill, atol=0, rtol=0)
    with pytest.raises(ValueError, match="limits"):
        pa.paged_attention_decode(*args, **tsc)                 # 4-D, none
    with pytest.raises(ValueError, match="limits"):
        pa.paged_attention_decode(args[0][:, 0], *args[1:],
                                  limits=torch.from_numpy(limits), **tsc)
    assert (pa.DECODE_LAUNCHES, pa.PREFILL_LAUNCHES) == (0, 0)


# --------------------------------------------------------- verify step


@pytest.mark.parametrize("shape", [GPT, MODERN], ids=["gpt", "modern"])
def test_verify_step_matches_jax(shape):
    """Prefill two slots, then three k+1 verify steps at the same
    positions, each drafting the previous step's outputs (so the
    accepted counts climb from the random first drafts): the tokens and
    accepted counts equal the JAX step's, the logits within 1e-5."""
    jcfg, tcfg = _configs(shape)
    tree = _jax_tree(jcfg, 1)
    bs, T, B, k = 4, 8, 2, 4
    S = k + 1
    eng = JaxServingEngine(
        jcfg, JaxServingConfig(max_batch=B, block_size=bs, max_seq=24,
                               prefill_len=T,
                               speculative=JaxSpeculativeConfig(k=k)),
        _as_jax(tree), mesh=_mesh(), registry=MetricRegistry())
    cache = _kv_config(tcfg, eng.cache.n_blocks, bs, max_seq=24)
    model = DecodeModel(tcfg, cache, device="cpu")
    model.load_params(from_jax_params(tree))
    arenas = init_kv_arena(cache, device="cpu")

    rng = np.random.default_rng(2)
    lens = [7, 5]
    tables = np.zeros((B, cache.max_blocks_per_request), np.int32)
    tables[0, :4], tables[1, :4] = [0, 1, 2, 3], [4, 5, 6, 7]
    tokens = np.zeros((B, T), np.int32)
    pos = np.zeros((B, T), np.int32)
    limits = np.zeros((B, T), np.int32)
    db = np.full((B, T), cache.n_blocks, np.int32)
    do = np.zeros((B, T), np.int32)
    for s, n in enumerate(lens):
        tokens[s, :n] = rng.integers(1, VOCAB, n)
        pos[s, :n] = np.arange(n)
        limits[s, :n] = np.arange(1, n + 1)
        db[s, :n] = tables[s, np.arange(n) // bs]
        do[s, :n] = np.arange(n) % bs
    lengths = np.asarray(lens, np.int32)
    si = lengths - 1
    j_arenas, j_next, _ = eng._prefill(
        eng.arenas, eng.params, tokens, pos, jnp.asarray(tables), lengths,
        limits, db, do, si, *_greedy(B))
    t_next, _ = model.prefill(
        arenas, *_t(tokens, pos, tables, lengths, limits, db, do, si),
        *_t(*_greedy(B)))
    np.testing.assert_array_equal(t_next.numpy(), np.asarray(j_next))

    verify = np.zeros((B, S), np.int32)
    verify[:, 0] = np.asarray(j_next)
    verify[:, 1:] = rng.integers(1, VOCAB, (B, k))
    active = np.ones((B,), bool)
    n_draft = np.asarray([k, k - 1], np.int32)
    accepted = []
    for _ in range(3):
        j_arenas, j_out, j_acc, j_logits = eng._decode(
            j_arenas, eng.params, verify, lengths, jnp.asarray(tables),
            active, n_draft, *_greedy(B))
        t_out, t_acc, t_logits = model.decode_step(
            arenas, *_t(verify, lengths, tables, active), *_t(*_greedy(B)),
            n_draft=torch.from_numpy(n_draft))
        np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
        np.testing.assert_array_equal(t_acc.numpy(), np.asarray(j_acc))
        live = np.arange(S)[None, :] <= n_draft[:, None]
        np.testing.assert_allclose(t_logits.numpy()[live],
                                   np.asarray(j_logits)[live], **TOL)
        accepted.append(t_acc.tolist())
        verify[:, 1:] = t_out.numpy()[:, :-1]
    assert accepted[0] != accepted[-1] and max(accepted[-1]) >= 2, accepted


# --------------------------------------------------------------- engine


def _serve(engine, wave, *, sampling=None, proposer=None):
    """Serve ``(arrival step, prompt, n_new)`` requests; returns the
    streams."""
    if proposer is not None:
        engine.proposer = proposer
    reqs, pending, step = [], list(wave), 0
    while pending or not engine.scheduler.idle:
        while pending and pending[0][0] <= step:
            _, prompt, n_new = pending.pop(0)
            reqs.append(engine.submit(prompt, n_new, sampling=sampling))
        engine.step()
        step += 1
        assert step < 1000, "wave did not drain"
    engine.scheduler.allocator.check()
    assert all(r.state.value == "finished" for r in reqs)
    return [r.output_tokens for r in reqs]


# longer budgets than the serving wave, so the tiny model's greedy loops
# make the streams self-predictive
SPEC_WAVE = [(t, p, n + 8) for t, p, n in WAVE]
SHAPE = dict(max_batch=3, block_size=4, max_seq=32, prefill_len=6)
_REFS = {}


def _port_engine(tcfg, tree, k=None, **kw):
    spec = SpeculativeConfig(k=k, backoff=4) if k else None
    return ServingEngine(tcfg, ServingConfig(**SHAPE, speculative=spec, **kw),
                         from_jax_params(tree), device="cpu")


def _reference(model):
    """(jcfg, tcfg, tree, streams, decode calls) of the plain port engine
    on SPEC_WAVE, computed once per model."""
    if model not in _REFS:
        jcfg, tcfg = _configs({"gpt": GPT, "modern": MODERN}[model])
        tree = _jax_tree(jcfg, 3)
        eng = _port_engine(tcfg, tree)
        refs = _serve(eng, SPEC_WAVE)
        _REFS[model] = (jcfg, tcfg, tree, refs, eng.decode_calls)
    return _REFS[model]


@pytest.mark.parametrize("model,k", [("gpt", 4), ("gpt", 2), ("modern", 4)])
def test_speculative_streams_match_jax_and_plain(model, k):
    """n-gram drafting at k: the port's greedy streams equal the JAX
    speculative engine's and the port's plain engine's, with drafts
    proposed and accepted and fewer decode calls than the plain run."""
    jcfg, tcfg, tree, refs, ref_calls = _reference(model)
    jeng = JaxServingEngine(
        jcfg, JaxServingConfig(**SHAPE, speculative=JaxSpeculativeConfig(
            k=k, backoff=4)),
        _as_jax(tree), mesh=_mesh(), registry=MetricRegistry())
    teng = _port_engine(tcfg, tree, k)
    got = _serve(teng, SPEC_WAVE)
    assert got == refs
    assert _serve(jeng, SPEC_WAVE) == got
    assert teng.spec_proposed > 0 and teng.spec_accepted > 0
    assert (teng.spec_proposed, teng.spec_accepted) == \
        (jeng.spec_proposed, jeng.spec_accepted)
    assert teng.decode_calls < ref_calls
    assert (pa.DECODE_LAUNCHES, pa.PREFILL_LAUNCHES) == (0, 0)


def test_speculative_int8_with_forced_preemption_matches_jax():
    """k = 2 over an int8 cache with the pool undersized, so eviction
    and preemption fire while drafting: the streams equal the JAX
    engine's and the port's plain int8 engine's."""
    jcfg, tcfg, tree, _, _ = _reference("gpt")
    kw = dict(n_blocks=8)
    plain = _port_engine(tcfg, tree, cache_dtype=torch.int8, **kw)
    refs = _serve(plain, SPEC_WAVE)
    teng = _port_engine(tcfg, tree, 2, cache_dtype=torch.int8, **kw)
    jeng = JaxServingEngine(
        jcfg, JaxServingConfig(**SHAPE, **kw, cache_dtype=jnp.int8,
                               speculative=JaxSpeculativeConfig(k=2,
                                                                backoff=4)),
        _as_jax(tree), mesh=_mesh(), registry=MetricRegistry())
    got = _serve(teng, SPEC_WAVE)
    assert got == refs
    assert _serve(jeng, SPEC_WAVE) == got
    assert teng.scheduler.preemptions > 0, "the pool never preempted"
    assert teng.scheduler.prefix_cache.evictions > 0
    assert teng.spec_proposed > 0
    assert teng.scheduler.preemptions == jeng.scheduler.preemptions


class _OracleProposer:
    """Forced acceptance: the drafts are the reference continuation."""

    def __init__(self, refs):
        self.refs = refs

    def propose(self, req, max_k):
        ref = self.refs[tuple(req.prompt.tolist())]
        done = len(req.output_tokens)
        return ref[done:done + max_k]

    def observe(self, req, proposed, accepted):
        assert accepted == proposed, f"oracle draft rejected ({accepted}" \
            f"/{proposed})"


class _WrongProposer(NGramProposer):
    """Forced rejection: every draft misses, and the inherited back-off
    silences each request after ``backoff`` proposals."""

    def __init__(self, config, refs):
        super().__init__(config)
        self.refs = refs
        self.proposals = 0

    def propose(self, req, max_k):
        if req.spec_fails >= self.config.backoff:
            return []
        self.proposals += 1
        ref = self.refs[tuple(req.prompt.tolist())]
        done = len(req.output_tokens)
        want = ref[done:done + max_k] or [0]
        return [(t + 1) % VOCAB for t in want]


def test_forced_acceptance_and_rejection():
    """An oracle proposer: every draft accepted, each verify emits a
    burst through the budget, far fewer decode calls.  An always-wrong
    proposer: nothing accepted, the streams unchanged, each request
    silenced after ``backoff`` proposals, and exactly the plain engine's
    decode calls."""
    _, tcfg, tree, refs, ref_calls = _reference("gpt")
    by_prompt = {tuple(p): r for (_, p, _), r in zip(SPEC_WAVE, refs)}
    oracle = _port_engine(tcfg, tree, 4)
    assert _serve(oracle, SPEC_WAVE,
                  proposer=_OracleProposer(by_prompt)) == refs
    assert oracle.spec_accepted == oracle.spec_proposed > 0
    total = sum(n for _, _, n in SPEC_WAVE)
    assert oracle.decode_calls <= total // 3, (oracle.decode_calls, total)

    wrong = _WrongProposer(SpeculativeConfig(k=4, backoff=2), by_prompt)
    eng = _port_engine(tcfg, tree, 4)
    assert _serve(eng, SPEC_WAVE, proposer=wrong) == refs
    assert eng.spec_accepted == 0 and eng.spec_proposed > 0
    assert wrong.proposals <= 2 * len(SPEC_WAVE)
    assert eng.decode_calls == ref_calls


def test_sampled_stream_identical_under_speculation():
    """Each verify position draws at its own output counter, so a seeded
    sampled stream is the same with drafting on and off: with n-gram
    drafts, and with an oracle proposing the sampled stream itself (every
    draft accepted, so every token after a tick's first was drawn at a
    later position of the verify).  Small-init weights keep the
    distributions wide, so the draws depend on their keys."""
    _, tcfg = _configs(GPT)
    params = init_gpt_params(tcfg, 1, device="cpu")
    wave = [(0, [9, 8, 7, 9, 8, 7], 12), (0, [4, 5, 4, 5], 10),
            (1, [3, 3, 3], 9)]

    def engine(k=None):
        spec = SpeculativeConfig(k=k) if k else None
        return ServingEngine(tcfg, ServingConfig(**SHAPE, speculative=spec),
                             params, device="cpu")

    sp = SamplingParams(temperature=1.0, seed=21)
    plain = _serve(engine(), wave, sampling=sp)
    other = _serve(engine(), wave, sampling=dataclasses.replace(sp, seed=22))
    assert other != plain, "the seed does not reach the draws"
    eng = engine(4)
    assert _serve(eng, wave, sampling=sp) == plain
    assert eng.spec_proposed > 0
    oracle = engine(4)
    by_prompt = {tuple(p): r for (_, p, _), r in zip(wave, plain)}
    assert _serve(oracle, wave, sampling=sp,
                  proposer=_OracleProposer(by_prompt)) == plain
    assert oracle.spec_accepted == oracle.spec_proposed > 0


def test_spec_width_is_checked_against_max_seq():
    _, tcfg = _configs(GPT)
    with pytest.raises(ValueError, match="below the speculative"):
        ServingEngine(tcfg, ServingConfig(
            max_batch=2, block_size=4, max_seq=4,
            speculative=SpeculativeConfig(k=8)),
            from_jax_params(_jax_tree(_configs(GPT)[0], 0)), device="cpu")
