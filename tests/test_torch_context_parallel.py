"""The port's context parallelism (ring and Ulysses attention, the
context-parallel GPT step ``build_gpt_cp``) against the JAX package.

One module-scoped fixture starts eight gloo CPU ranks on the ``dp2 x
cp4`` grid (``torch_context_ranks.context_cases``) and computes the JAX
side while they run, on the eight-device CPU mesh of the same shape under
``shard_over`` (jitted; the flash kernels in interpret mode): rank ``r``
holds the shard device ``r`` holds.  The attention cases are ``[1, h,
64, 8]`` sequences split four ways; the GPT cases are
``tests/test_gpt_cp.py``'s (hidden 32, 2 layers, 4 heads, vocab 64,
sequence 32, batch 4), with JAX's ``init_fn`` weights carried by
``from_flax_gpt_cp``.  The file takes about 40 s on one worker.  The
configuration errors run in this process without the spawn.

Limits, the reference's own (``tests/test_flash_attention.py``,
``tests/test_gpt_cp.py``): attention outputs within 2e-5 and gradients
within rtol/atol 2e-4; GPT losses within rtol 1e-5, gradients within
rtol 2e-4 / atol 2e-5, per-token losses within 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_context_ranks as ranks
from apex_tpu import parallel as jparallel
from apex_tpu.ops.flash_attention import flash_attention as j_flash
from apex_tpu.ops.softmax import AttnMaskType as JMask
from apex_tpu.ops.xentropy import softmax_cross_entropy_loss as j_xent
from apex_tpu.parallel import collectives as jcc
from apex_tpu.transformer import context_parallel as jcp
from apex_tpu.transformer.layers.layer_norm import FusedLayerNorm as JaxLN
from apex_tpu.transformer.testing import TransformerConfig as JaxConfig
from apex_tpu.transformer.testing.gpt_cp_train import build_gpt_cp as j_build
from apex_tpu.transformer.testing.standalone_transformer_lm import (
    Embedding as JaxEmbedding,
    ParallelTransformerLayer as JaxLayer,
    parallel_lm_logits as j_lm_logits,
)
from apex_tpu_torch.ops.softmax import AttnMaskType
from apex_tpu_torch.parallel.launch import start_multiprocess
from apex_tpu_torch.transformer.testing.gpt_cp_train import build_gpt_cp
from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
    CoreAttention,
    TransformerConfig,
)
from torch_threads import one_torch_thread  # noqa: F401

WORLD, CP, DP = 8, 4, 2
B, S_LOCAL, D = 1, 16, 8
VOCAB, SEQ = 64, 32
DROP_SEED = 1234
# name -> (impl, heads, kv heads, causal, extra keywords)
ATTENTION = {
    "ring/causal": ("ring", 2, 2, True, {}),
    "ring/full": ("ring", 2, 2, False, {}),
    "ring/gqa2": ("ring", 8, 2, True, {}),
    "ring/gqa4": ("ring", 8, 4, True, {}),
    "ulysses": ("ulysses", 4, 4, True, {}),
    "ulysses/gqa2": ("ulysses", 8, 2, True, {}),
    "ulysses/gqa4": ("ulysses", 8, 4, True, {}),
    "ulysses/dropout": ("ulysses", 4, 4, True,
                        {"dropout_rate": 0.1, "dropout_seed": DROP_SEED}),
}
GPT = dict(hidden_size=32, num_layers=2, num_attention_heads=4,
           padded_vocab_size=VOCAB, max_position_embeddings=SEQ,
           hidden_dropout=0.0, attention_dropout=0.0, tensor_axis=None,
           use_flash_attention=True, context_axis="cp")
# name -> the config's changes from GPT
GPTS = {"ring": {}, "ulysses": {"context_impl": "ulysses"},
        "rope": {"position_embedding_type": "rope"},
        "gqa": {"num_query_groups": 2}}


def _attention_inputs():
    rng = np.random.default_rng(0)
    cases = {}
    for name, (impl, h, g, causal, kw) in ATTENTION.items():
        S = S_LOCAL * CP

        def f(heads):
            return rng.standard_normal((B, heads, S, D)).astype(np.float32)

        cases[name] = {"impl": impl, "causal": causal, "kw": kw, "q": f(h),
                       "k": f(g), "v": f(g), "w": f(h)}
    return cases


def _jax_attention(case):
    """JAX's ring/Ulysses under ``shard_over`` on the cp4 mesh: the output
    and the gradients of ``<out, w>`` with respect to q, k, v."""
    fn = jcp.ring_attention if case["impl"] == "ring" \
        else jcp.ulysses_attention
    spec = P(None, None, "cp")
    w = jnp.asarray(case["w"])

    def loss(q, k, v):
        out = jcc.shard_over(
            lambda q, k, v: fn(q, k, v, "cp", case["causal"], **case["kw"]),
            in_specs=(spec,) * 3, out_specs=spec)(q, k, v)
        return jnp.sum(out * w), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(case[n]) for n in "qkv"))
    return {"out": np.asarray(out),
            **{f"d{n}": np.asarray(g) for n, g in zip("qkv", grads)}}


def _jax_flash(case):
    """Single-device flash on the whole sequence: output and gradients."""
    w = jnp.asarray(case["w"])

    def loss(q, k, v):
        out = j_flash(q, k, v, causal=case["causal"])
        return jnp.sum(out * w), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(case[n]) for n in "qkv"))
    return {"out": np.asarray(out),
            **{f"d{n}": np.asarray(g) for n, g in zip("qkv", grads)}}


def _serial(cfg, params, tokens):
    """The same modules and parameters on the full sequence, no mesh
    (flash core): the mean loss and the per-token losses ``[b, s - 1]``."""
    cfg = dataclasses.replace(cfg, context_axis=None)
    h = JaxEmbedding(cfg).apply({"params": params["embedding"]}, tokens)
    layer = JaxLayer(cfg, self_attn_mask_type=JMask.causal)
    for i in range(cfg.num_layers):
        h = layer.apply({"params": params[f"layer_{i}"]}, h, None)
    h = JaxLN(cfg.hidden_size, eps=cfg.layernorm_epsilon).apply(
        {"params": params["final_ln"]}, h)
    logits = j_lm_logits(
        h, params["embedding"]["word_embeddings"]["embedding"], cfg)
    per_tok = j_xent(
        jnp.transpose(logits[:-1], (1, 0, 2)).reshape(-1, VOCAB)
        .astype(jnp.float32), tokens[:, 1:].reshape(-1), padding_idx=-1)
    per_tok = per_tok.reshape(tokens.shape[0], -1)
    return jnp.mean(per_tok), per_tok


@pytest.fixture(scope="module")
def run():
    """The eight ranks' results and the JAX side (computed while they
    run)."""
    mesh = jparallel.initialize_model_parallel(context_parallel_size=CP)
    tokens = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (DP * 2, SEQ), 0, VOCAB)).astype(np.int64)
    gpts, jcfgs, specs = {}, {}, {}
    try:
        for name, kw in GPTS.items():
            jcfgs[name] = JaxConfig(**GPT, **kw)
            init_fn, _, _ = j_build(jcfgs[name], mesh=mesh)
            params, specs[name] = init_fn(jax.random.PRNGKey(0), tokens)
            gpts[name] = (dict(GPT, **kw),
                          jax.tree_util.tree_map(np.asarray, params))
        attention = _attention_inputs()
        job = start_multiprocess(
            ranks.context_cases, WORLD,
            args=({"attention": attention, "gpt": gpts, "tokens": tokens},),
            timeout=240.0, num_threads=1)
        want = {"attention": {n: _jax_attention(c)
                              for n, c in attention.items()},
                "flash": {n: _jax_flash(attention[n])
                          for n in ("ring/causal", "ring/full")},
                "gpt": {}}
        for name in GPTS:
            cfg, params = jcfgs[name], gpts[name][1]
            loss, per_tok = jax.jit(
                lambda p, c=cfg: _serial(c, p, tokens))(params)
            rec = {"serial": float(loss), "per_tok": np.asarray(per_tok)}
            if name in ("ring", "ulysses"):
                _, make_loss_fn, _ = j_build(cfg, mesh=mesh)
                l_cp, g_cp = jax.jit(jax.value_and_grad(
                    make_loss_fn(specs[name])))(params, tokens)
                rec.update(loss=float(l_cp), grads=jax.tree_util.tree_map(
                    np.asarray, g_cp))
            want["gpt"][name] = rec
    finally:
        jparallel.destroy_model_parallel()
    return attention, job.join(), want


def _rank(d, c):
    return d * CP + c


def _gathered(results, key, field):
    """One dp replica's shards of ``field`` joined along the sequence."""
    return np.concatenate([results[_rank(0, c)][key][field]
                           for c in range(CP)], axis=2)


def test_grid_coordinates(run):
    _, results, _ = run
    for r, res in enumerate(results):
        assert res["coords"]["cp"] == r % CP and res["coords"]["dp"] == r // CP


@pytest.mark.parametrize("name", list(ATTENTION))
def test_attention_matches_jax(run, name):
    """Output and q/k/v gradients against JAX's ``ring_attention`` or
    ``ulysses_attention`` under ``shard_over``; every dp replica alike."""
    _, results, want = run
    key = f"attention/{name}"
    for field in ("out", "dq", "dk", "dv"):
        got = _gathered(results, key, field)
        tol = dict(rtol=2e-5, atol=2e-5) if field == "out" \
            else dict(rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got, want["attention"][name][field],
                                   err_msg=f"{name} {field}", **tol)
        for c in range(CP):
            np.testing.assert_array_equal(results[_rank(1, c)][key][field],
                                          results[_rank(0, c)][key][field])


@pytest.mark.parametrize("name", ["ring/causal", "ring/full"])
def test_ring_matches_single_device_flash(run, name):
    _, results, want = run
    for field in ("out", "dq", "dk", "dv"):
        np.testing.assert_allclose(
            _gathered(results, f"attention/{name}", field),
            want["flash"][name][field], rtol=2e-4, atol=2e-4,
            err_msg=f"{name} {field}")


def test_every_rank_issues_the_same_collectives(run):
    """The causal case decides which kernel runs, never whether a rotation
    happens: ``cp - 1`` batched permutes forward (the last would only bring
    K/V home), ``cp`` backward (dk/dv come home); Ulysses four all-to-alls
    each way (q, k, v, out)."""
    _, results, _ = run
    for name, (impl, *_rest) in ATTENTION.items():
        calls = {str(r["attention/" + name]["calls"]) for r in results}
        assert len(calls) == 1, (name, calls)
        fwd, bwd = results[0]["attention/" + name]["calls"]
        if impl == "ring":
            assert fwd["ppermute"] == CP - 1 and bwd["ppermute"] == CP
            assert fwd["all_to_all"] == bwd["all_to_all"] == 0
        else:
            assert fwd["all_to_all"] == bwd["all_to_all"] == 4
            assert fwd["ppermute"] == bwd["ppermute"] == 0


def test_ulysses_dropout_keeps_jax_mask(run):
    """The same seed drops the same entries: the dropped outputs agree
    with JAX's and differ from the undropped ones."""
    _, results, want = run
    got = _gathered(results, "attention/ulysses/dropout", "out")
    np.testing.assert_allclose(
        got, want["attention"]["ulysses/dropout"]["out"], rtol=2e-5,
        atol=2e-5)
    assert np.abs(got - _gathered(results, "attention/ulysses",
                                  "out")).max() > 1e-2


@pytest.mark.parametrize("name", ["ring", "ulysses"])
def test_gpt_cp_loss_matches_jax(run, name):
    _, results, want = run
    w = want["gpt"][name]
    for res in results:
        np.testing.assert_allclose(res[f"gpt/{name}"]["loss"], w["loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(res[f"gpt/{name}"]["loss"], w["serial"],
                                   rtol=1e-5)


@pytest.mark.parametrize("name", ["ring", "ulysses"])
def test_gpt_cp_gradients_match_jax_grad(run, name):
    """Every gradient, summed over ``(dp, cp)`` by ``reduce_gradients``,
    the same on every rank and within rtol 2e-4 / atol 2e-5 of
    ``jax.grad`` of JAX's context-parallel loss."""
    _, results, want = run
    flat = jax.tree_util.tree_flatten_with_path(want["gpt"][name]["grads"])
    for path, w in flat[0]:
        for res in results:
            g = res[f"gpt/{name}"]["grads"]
            for k in path:
                g = g[k.key]
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5,
                                       err_msg=f"{name} {path}")
    assert len(flat[0]) >= 20


@pytest.mark.parametrize("name", list(GPTS))
def test_gpt_cp_per_token_losses_match_serial(run, name):
    """The per-token losses of every rank's block, put back in place:
    each position's next-token loss within 1e-5 of the serial model's (the
    label across each shard boundary came from the next rank), the
    global last position masked."""
    _, results, want = run
    per = np.zeros((DP * 2, SEQ), np.float32)
    mask = np.zeros((DP * 2, SEQ), np.float32)
    s = SEQ // CP
    for d in range(DP):
        for c in range(CP):
            res = results[_rank(d, c)][f"gpt/{name}"]
            per[d * 2:(d + 1) * 2, c * s:(c + 1) * s] = res["per_tok"]
            mask[d * 2:(d + 1) * 2, c * s:(c + 1) * s] = res["mask"]
    assert (mask[:, :-1] == 1).all() and (mask[:, -1] == 0).all()
    np.testing.assert_allclose(per[:, :-1], want["gpt"][name]["per_tok"],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["rope", "gqa"])
def test_modern_gpt_under_cp_matches_serial(run, name):
    """RoPE with each shard's global positions, and grouped K/V sent
    compact around the ring, against the serial JAX model's loss."""
    _, results, want = run
    for res in results:
        np.testing.assert_allclose(res[f"gpt/{name}"]["loss"],
                                   want["gpt"][name]["serial"], rtol=1e-5)


def test_gpt_cp_step_collectives(run):
    """One loss + backward + reduction: one permute of the labels' first
    column, the two (dp, cp) reductions of the loss's sum and count, ring
    attention's permutes (2 layers x (cp - 1) forward, x cp backward), and
    one all-reduce of the gradients."""
    _, results, _ = run
    for res in results:
        calls = res["gpt/ring"]["calls"]
        assert calls["ppermute"] == 1 + 2 * (CP - 1) + 2 * CP, calls
        assert calls["all_reduce"] == 3, calls
        assert calls["all_to_all"] == 0, calls
        assert res["gpt/ulysses"]["calls"]["all_to_all"] == 2 * 4 * 2


def test_gpt_cp_trains(run):
    _, results, _ = run
    losses = results[0]["trains"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    for res in results:
        assert res["trains"] == losses


# ------------------------------------------------ no spawn: one process


def _cfg(**kw):
    return TransformerConfig(**dict(GPT, **kw))


def test_cp_configuration_errors():
    with pytest.raises(ValueError, match="mutually exclusive"):
        _cfg(sequence_parallel=True)
    with pytest.raises(ValueError, match="context_impl"):
        _cfg(context_impl="tree")
    with pytest.raises(ValueError, match="context_axis"):
        build_gpt_cp(_cfg(context_axis=None), device="cpu")
    with pytest.raises(ValueError, match="tensor_axis"):
        build_gpt_cp(_cfg(tensor_axis="tp"), device="cpu")


def test_cp_core_refuses_non_causal_and_ring_dropout():
    q = torch.zeros(8, 1, 4, 8)
    core = CoreAttention(_cfg(), attn_mask_type=AttnMaskType.padding)
    with pytest.raises(NotImplementedError, match="causal"):
        core(q, q, q)
    core = CoreAttention(_cfg(attention_dropout=0.1),
                         attn_mask_type=AttnMaskType.causal)
    with pytest.raises(NotImplementedError, match="ring"):
        core(q, q, q, generator=torch.Generator().manual_seed(0))
    # deterministic (no generator): the ring runs without dropout
    assert core(q, q, q).shape == (8, 1, 32)


def test_ulysses_dropout_needs_a_seed():
    from apex_tpu_torch.transformer.context_parallel import ulysses_attention

    q = torch.zeros(1, 4, 8, 8)
    with pytest.raises(ValueError, match="dropout_seed"):
        ulysses_attention(q, q, q, dropout_rate=0.1)
