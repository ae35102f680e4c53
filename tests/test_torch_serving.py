"""The port's serving slice against the JAX package on the same weights.

The JAX side runs as ``tests/test_serving.py`` runs it: a tp=1 mesh on the
CPU, Pallas kernels in interpret mode.  The port runs with
``device="cpu"``, where its kernel wrappers take their plain versions.
Weights and inputs come from numpy seeds and go to both sides.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import parallel
from apex_tpu.observability.metrics import MetricRegistry
from apex_tpu.serving import ServingConfig as JaxServingConfig
from apex_tpu.serving import ServingEngine as JaxServingEngine
from apex_tpu.serving.sampling import sample_tokens as jax_sample_tokens
from apex_tpu.transformer.testing.gpt_parallel_train import (
    GPT3DParams as JaxGPT3DParams,
    build_gpt_3d,
)
from apex_tpu.transformer.testing.standalone_transformer_lm import (
    TransformerConfig as JaxTransformerConfig,
)
from apex_tpu_torch.serving import (
    DecodeModel,
    ServingConfig,
    ServingEngine,
    init_kv_arena,
)
from apex_tpu_torch.serving import fused_ops, paged_attention
from apex_tpu_torch.serving.lora import LoRAConfig, init_adapter_arena
from apex_tpu_torch.serving.bridge import from_jax_params
from apex_tpu_torch.serving.sampling import filtered_logits, sample_tokens
from apex_tpu_torch.transformer.testing.gpt_parallel_train import (
    init_gpt_params,
)
from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
    TransformerConfig,
)

REPO = Path(__file__).resolve().parent.parent
VOCAB = 128
# a tiny GPT (learned positions, MHA, GELU) and its modern variant
GPT = dict(hidden_size=64, num_layers=2, num_attention_heads=4,
           padded_vocab_size=VOCAB, max_position_embeddings=32)
MODERN = dict(GPT, position_embedding_type="rope", num_query_groups=2,
              swiglu=True)


def _configs(shape):
    jcfg = JaxTransformerConfig(**shape, hidden_dropout=0.0,
                                attention_dropout=0.0, tensor_axis="tp")
    return jcfg, TransformerConfig(**shape)


def _mesh():
    return parallel.initialize_model_parallel(
        tensor_model_parallel_size=1, devices=jax.devices()[:1])


def _jax_tree(jcfg, seed):
    """A JAX GPT3DParams in the pipeline form [vpp=L, pp=1, ...], with
    numpy leaves scaled so logits spread well apart (greedy streams then
    do not hinge on last-bit differences)."""
    rng = np.random.default_rng(seed)
    L, h, f = jcfg.num_layers, jcfg.hidden_size, jcfg.ffn_size
    n, g, d = jcfg.num_attention_heads, jcfg.query_groups, jcfg.head_dim

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-1])
                ).astype(np.float32)

    def b(*shape):
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    def linear(n_out, n_in):
        return {"kernel": w(L, 1, n_out, n_in), "bias": b(L, 1, n_out)}

    def norm(*lead):
        return {"scale": (1.0 + b(*lead, h)).astype(np.float32),
                "bias": b(*lead, h)}

    mlp = {"dense_h_to_4h": linear(f, h), "dense_4h_to_h": linear(h, f)}
    if jcfg.swiglu:
        mlp["dense_h_to_4h_gate"] = linear(f, h)
    layers = {"input_layernorm": norm(L, 1),
              "self_attention": {"query_key_value": linear((n + 2 * g) * d, h),
                                 "dense": linear(h, n * d)},
              "post_attention_layernorm": norm(L, 1),
              "mlp": mlp}
    emb = {"word_embeddings": {
        "embedding": rng.standard_normal((VOCAB, h)).astype(np.float32)}}
    if jcfg.position_embedding_type == "learned":
        emb["position_embeddings"] = {"embedding": rng.standard_normal(
            (jcfg.max_position_embeddings, h)).astype(np.float32)}
    return JaxGPT3DParams(embedding=emb, layers=layers, final_ln=norm())


def _as_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


# ---------------------------------------------------------------- (a)


@pytest.mark.parametrize("shape", [GPT, MODERN], ids=["gpt", "modern"])
def test_bridge_round_trip(shape):
    """Every tensor crosses unchanged, and the hand-built tree has the
    structure and shapes of ``build_gpt_3d``'s real init."""
    jcfg, tcfg = _configs(shape)
    tree = _jax_tree(jcfg, 0)
    init_fn, _, _ = build_gpt_3d(jcfg, num_chunks=jcfg.num_layers,
                                 num_microbatches=1, mesh=_mesh())
    real = jax.eval_shape(lambda k, t: init_fn(k, t)[0],
                          jax.random.PRNGKey(0), jnp.zeros((2, 4), jnp.int32))
    want = jax.tree_util.tree_map(lambda a: a.shape, real)
    assert jax.tree_util.tree_map(np.shape, tree) == want

    params = from_jax_params(tree)
    L = jcfg.num_layers
    for part in ("embedding", "layers", "final_ln"):
        src = dict(_leaves(getattr(tree, part)))
        got = dict(_leaves(getattr(params, part)))
        assert src.keys() == got.keys()
        for name, a in src.items():
            if part == "layers":
                a = a.reshape((L,) + a.shape[2:])
            np.testing.assert_array_equal(got[name].numpy(), a, err_msg=name)

    model = DecodeModel(tcfg, _cache(tcfg, 16, 4), device="cpu")
    model.load_params(params)
    state = model.state_dict()
    for name, a in _leaves(tree.layers):
        for i in range(L):
            np.testing.assert_array_equal(
                state[f"layers.{i}.{name}"].numpy(), a[i, 0], err_msg=name)


# ---------------------------------------------------------------- (b)


def _cache(tcfg, n_blocks, block_size, max_seq=16, dtype=torch.float32):
    from apex_tpu_torch.serving import KVCacheConfig

    return KVCacheConfig(n_layers=tcfg.num_layers, n_blocks=n_blocks,
                         block_size=block_size, kv_heads=tcfg.query_groups,
                         head_dim=tcfg.head_dim, max_seq=max_seq,
                         dtype=dtype)


def _greedy(B):
    return (np.zeros((B,), np.float32), np.zeros((B,), np.int32),
            np.ones((B,), np.float32), np.zeros((B,), np.uint32),
            np.zeros((B,), np.int32))


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a).astype(
        np.int64 if a.dtype == np.uint32 else a.dtype)) for a in arrays]


@pytest.mark.parametrize("shape", [GPT, MODERN], ids=["gpt", "modern"])
def test_prefill_and_decode_logits_match_jax(shape):
    """Chunked prefill of two slots, then one decode step: the logits of
    both calls agree with the JAX DecodeModel to atol 1e-4 (fp32 weights,
    cache and compute; the GEMMs and softmax sum in another order)."""
    _check_logits(shape, fuse_epilogue=True)


def test_unfused_epilogue_logits_match_jax():
    """The same with ``fuse_epilogue=False`` on both sides: the layers'
    epilogue as the reference's separate ops."""
    _check_logits(GPT, fuse_epilogue=False)


def _check_logits(shape, fuse_epilogue):
    jcfg, tcfg = _configs(shape)
    tree = _jax_tree(jcfg, 1)
    bs, T, B = 4, 8, 2
    eng = JaxServingEngine(
        jcfg, JaxServingConfig(max_batch=B, block_size=bs, max_seq=16,
                               prefill_len=T, fuse_epilogue=fuse_epilogue),
        _as_jax(tree), mesh=_mesh(), registry=MetricRegistry())
    assert eng.model.fuse_epilogue is fuse_epilogue
    cache = _cache(tcfg, eng.cache.n_blocks, bs)
    model = DecodeModel(tcfg, cache, fuse_epilogue=fuse_epilogue,
                        device="cpu")
    model.load_params(from_jax_params(tree))
    arenas = init_kv_arena(cache, device="cpu")

    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, VOCAB, 7), rng.integers(1, VOCAB, 5)]
    blocks = [[0, 1], [2, 3]]
    tables = np.zeros((B, cache.max_blocks_per_request), np.int32)
    tokens = np.zeros((B, T), np.int32)
    pos = np.zeros((B, T), np.int32)
    limits = np.zeros((B, T), np.int32)
    lengths = np.zeros((B,), np.int32)
    db = np.full((B, T), cache.n_blocks, np.int32)
    do = np.zeros((B, T), np.int32)
    si = np.zeros((B,), np.int32)
    for s, (p, blk) in enumerate(zip(prompts, blocks)):
        n = len(p)
        tables[s, :len(blk)] = blk
        tokens[s, :n] = p
        pos[s, :n] = np.arange(n)
        limits[s, :n] = np.arange(1, n + 1)
        lengths[s] = n
        db[s, :n] = [blk[t // bs] for t in range(n)]
        do[s, :n] = np.arange(n) % bs
        si[s] = n - 1
    j_arenas, j_next, j_logits = eng._prefill(
        eng.arenas, eng.params, tokens, pos, jnp.asarray(tables), lengths,
        limits, db, do, si, *_greedy(B))
    t_next, t_logits = model.prefill(
        arenas, *_t(tokens, pos, tables, lengths, limits, db, do, si),
        *_t(*_greedy(B)))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=1e-4, rtol=0)
    np.testing.assert_array_equal(t_next.numpy(), np.asarray(j_next))

    toks = np.asarray(j_next, np.int32)[:, None]
    positions = lengths.copy()
    active = np.ones((B,), bool)
    _, j_out, j_acc, j_dlogits = eng._decode(
        j_arenas, eng.params, toks, positions, jnp.asarray(tables), active,
        np.zeros((B,), np.int32), *_greedy(B))
    t_out, t_acc, t_dlogits = model.decode_step(
        arenas, *_t(toks, positions, tables, active), *_t(*_greedy(B)))
    np.testing.assert_allclose(t_dlogits.numpy(), np.asarray(j_dlogits),
                               atol=1e-4, rtol=0)
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(t_acc.numpy(), np.asarray(j_acc))


# ---------------------------------------------------------------- (c)

# (arrival step, prompt, max_new_tokens); prompts 0 and 2 share a 12-token
# (three-block) prefix, prompts longer than prefill_len take several chunks
_rng = np.random.default_rng(7)
_PREFIX = _rng.integers(1, VOCAB, 12).tolist()
WAVE = [
    (0, _PREFIX + _rng.integers(1, VOCAB, 2).tolist(), 8),
    (0, _rng.integers(1, VOCAB, 9).tolist(), 6),
    (4, _PREFIX + _rng.integers(1, VOCAB, 1).tolist(), 8),
    (5, _rng.integers(1, VOCAB, 5).tolist(), 10),
    (7, _rng.integers(1, VOCAB, 11).tolist(), 5),
]


def _serve(engine, wave):
    reqs, pending, step = [], list(wave), 0
    while pending or not engine.scheduler.idle:
        while pending and pending[0][0] <= step:
            _, prompt, n_new = pending.pop(0)
            reqs.append(engine.submit(prompt, n_new))
        engine.step()
        step += 1
        assert step < 500, "wave did not drain"
    return reqs


@pytest.mark.parametrize("model,cache_dtype", [
    ("gpt", "bf16"), ("gpt", "int8"), ("modern", "bf16")])
def test_engine_streams_match_jax(model, cache_dtype):
    """A staggered wave with chunked prefill, a prefix-cache hit and a
    preemption: the port's greedy streams are token-identical to the JAX
    engine's on the same weights."""
    _check_streams(model, cache_dtype, fuse_epilogue=True)


def test_unfused_epilogue_streams_match_jax():
    """The same wave with ``ServingConfig(fuse_epilogue=False)`` on both
    sides: token-identical, and no kernel launched."""
    _check_streams("gpt", "bf16", fuse_epilogue=False)


def _check_streams(model, cache_dtype, fuse_epilogue):
    jcfg, tcfg = _configs({"gpt": GPT, "modern": MODERN}[model])
    tree = _jax_tree(jcfg, 3)
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16),
                "int8": (jnp.int8, torch.int8)}[cache_dtype]
    shape = dict(max_batch=3, block_size=4, max_seq=32, prefill_len=6,
                 n_blocks=8, fuse_epilogue=fuse_epilogue)
    jeng = JaxServingEngine(jcfg, JaxServingConfig(**shape, cache_dtype=jdt),
                            _as_jax(tree), mesh=_mesh(),
                            registry=MetricRegistry())
    teng = ServingEngine(tcfg, ServingConfig(**shape, cache_dtype=tdt),
                         from_jax_params(tree), device="cpu")
    assert teng.model.fuse_epilogue is fuse_epilogue
    j_reqs = _serve(jeng, WAVE)
    t_reqs = _serve(teng, WAVE)
    for jr, tr in zip(j_reqs, t_reqs):
        assert tr.output_tokens == jr.output_tokens, tr.rid
        assert len(tr.output_tokens) == tr.max_new_tokens
    sched, jsched = teng.scheduler, jeng.scheduler
    assert sched.preemptions > 0 and sched.prefix_cache.hits > 0
    assert (sched.preemptions, sched.prefix_cache.hits) == \
        (jsched.preemptions, jsched.prefix_cache.hits)
    assert teng.requests_finished == len(WAVE)
    assert teng.tokens_generated == sum(n for _, _, n in WAVE)
    sched.allocator.check()
    # on the CPU no kernel launched: the plain versions ran
    assert (paged_attention.DECODE_LAUNCHES, paged_attention.PREFILL_LAUNCHES,
            fused_ops.RESIDUAL_NORM_LAUNCHES) == (0, 0, 0)


def test_engine_drain_cancels_the_queue_and_finishes_the_running():
    """Drain: waiting requests are cancelled, a submit during the drain
    is refused, running requests still deliver every token."""
    _, tcfg = _configs(GPT)
    eng = ServingEngine(tcfg, ServingConfig(max_batch=1, block_size=4,
                                            max_seq=32),
                        init_gpt_params(tcfg, 0, device="cpu"),
                        device="cpu")
    first = eng.submit([5, 6, 7], 4)
    queued = eng.submit([8, 9], 4)
    eng.step()
    assert eng.drain() == [queued] and queued.state.value == "cancelled"
    late = eng.submit([1, 2], 2)
    assert late.state.value == "rejected"
    eng.run_until_drained()
    assert first.state.value == "finished" and len(first.output_tokens) == 4
    assert (eng.requests_finished, eng.requests_cancelled) == (1, 1)
    eng.scheduler.allocator.check()


# ---------------------------------------------------------------- (d)


def _allowed(logits, temperature, top_k, top_p):
    """The filtered token set, computed independently in numpy."""
    x = logits / temperature
    kth = np.sort(x)[::-1][top_k - 1]
    x = np.where(x < kth, -np.inf, x)
    p = np.exp(x - x.max())
    p /= p.sum()
    order = np.argsort(-x, kind="stable")
    cs = np.cumsum(p[order])
    keep = (cs - p[order]) < top_p
    return set(order[keep].tolist())


def test_sampling_filters_redraws_and_matches_jax_distribution():
    """Temperature/top-k/top-p sampling: no token outside the filtered
    set, the same (seed, step) redraws the same token, and over 4000
    draws the port's frequencies agree with JAX's: the two-sample
    chi-square statistic stays under its 0.999 quantile (a false alarm
    once in a thousand seeds; these seeds are fixed)."""
    from scipy.stats import chi2

    rng = np.random.default_rng(11)
    V, N = 16, 4000
    logits = rng.standard_normal(V).astype(np.float32) * 2.0
    temperature, top_k, top_p = 0.8, 6, 0.9
    allowed = _allowed(logits, temperature, top_k, top_p)
    assert 1 < len(allowed) < top_k

    policy = (np.full((N,), temperature, np.float32),
              np.full((N,), top_k, np.int32), np.full((N,), top_p, np.float32),
              np.full((N,), 1234, np.uint32), np.arange(N, dtype=np.int32))
    rows = np.broadcast_to(logits, (N, V))
    t_draw = sample_tokens(torch.from_numpy(rows.copy()), *_t(*policy)).numpy()
    j_draw = np.asarray(jax_sample_tokens(jnp.asarray(rows), *policy))
    assert set(t_draw.tolist()) <= allowed
    assert set(j_draw.tolist()) <= allowed

    again = sample_tokens(torch.from_numpy(rows.copy()), *_t(*policy)).numpy()
    np.testing.assert_array_equal(again, t_draw)

    cats = sorted(allowed)
    ct = np.array([(t_draw == c).sum() for c in cats], np.float64)
    cj = np.array([(j_draw == c).sum() for c in cats], np.float64)
    stat = float(((ct - cj) ** 2 / (ct + cj)).sum())
    assert stat < chi2.ppf(0.999, len(cats) - 1), (stat, ct, cj)

    # the filter itself agrees with the independent numpy set
    x = filtered_logits(torch.from_numpy(logits[None]),
                        *_t(*(a[:1] for a in policy[:3])))
    assert set(torch.nonzero(x[0] > -1e29).flatten().tolist()) == allowed


def test_greedy_is_the_fp32_argmax():
    rng = np.random.default_rng(12)
    logits = rng.standard_normal((5, 40)).astype(np.float32)
    logits[2, 7] = logits[2, 9] = logits[2].max() + 1.0   # tie: first index
    got = sample_tokens(torch.from_numpy(logits), *_t(*_greedy(5)))
    np.testing.assert_array_equal(got.numpy(), logits.argmax(-1))
    assert got[2] == 7


# ---------------------------------------------------------------- (e)


def _port_files():
    return sorted((REPO / "apex_tpu_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return (module == "jax" or module.startswith("jax.")
            or module == "apex_tpu" or module.startswith("apex_tpu."))


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert {"speculative.py", "lora.py", "engine.py", "pallas_norm.py",
            "fused_layer_norm.py"} <= {p.name for p in files}
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [f"{path.name}:{node.lineno} {m}" for m in names
                    if _forbidden(m)]
    assert not bad, bad


def test_importing_the_port_leaves_jax_unloaded():
    code = (
        "import pkgutil, importlib, sys, apex_tpu_torch\n"
        "for m in pkgutil.walk_packages(apex_tpu_torch.__path__, "
        "'apex_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'apex_tpu' or m.startswith('apex_tpu.')]\n"
        "print(len(list(pkgutil.walk_packages(apex_tpu_torch.__path__))), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---------------------------------------------------------------- (f)


def test_entry_points_default_to_cuda_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jcfg, tcfg = _configs(GPT)
    params = init_gpt_params(tcfg, 0, device="cpu")
    cache = _cache(tcfg, 8, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(tcfg, ServingConfig(max_batch=2, block_size=4,
                                          max_seq=16), params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeModel(tcfg, cache)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_kv_arena(cache)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_gpt_params(tcfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_adapter_arena(tcfg, LoRAConfig(rank=2, max_adapters=1))
