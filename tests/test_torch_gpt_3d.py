"""The port's 3D-parallel GPT step (dp2 x pp2(vpp2) x tp2 with sequence
parallelism, ``build_gpt_3d``) against the JAX package.

The weights and tokens are the JAX ``_trace_gpt_3d``'s: its ``init_fn``
(jitted; its eager ``shard_map`` runs op by op, 80 s) and its
``PRNGKey(1)`` tokens, drawn under ``jax.threefry_partitionable(False)``,
the PRNG mode ``tests/L1/baselines/gpt_3d.json`` was recorded in (under
jax 0.9's default the live JAX trace parts from it by 7.1e-3, under the
old mode by 1.25e-7).  One module-scoped fixture starts eight gloo CPU
ranks (``torch_pipeline_ranks.gpt_3d_cases``) and computes the JAX side
while they run: the serial loss and its ``jax.grad`` over the same global
parameters (``tests/test_gpt_3d.py::serial_loss``'s pattern) and the
serial packed loss with block-diagonal flash attention.  The same spawn
runs the Switch-MoE step (``num_experts=4, expert_axis="dp"``, JAX's
jitted ``init_fn`` weights of that config), held against ``jax.grad`` of
JAX's own ``build_gpt_3d`` loss and three of its FusedAdam steps.  The
file takes about 70 s on one worker.

Limits: the ten losses at ``compare_traces``' ``loss_rtol=1e-4`` against
the stored baseline; the first step's gathered gradients within rtol
2e-4 / atol 1e-5 of JAX's; the first loss and the packed losses within
1e-5 of JAX's serial ones; the MoE step's three losses within 1e-5.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_pipeline_ranks as ranks
from apex_tpu import parallel as jparallel
from apex_tpu.optimizers import FusedAdam as JaxAdam
from apex_tpu.data.sequence import segment_loss_mask as j_segment_loss_mask
from apex_tpu.ops.softmax import AttnMaskType
from apex_tpu.transformer.layers.layer_norm import FusedLayerNorm as JaxLN
from apex_tpu.transformer.testing import TransformerConfig as JaxConfig
from apex_tpu.transformer.testing.gpt_parallel_train import (
    build_gpt_3d as j_build_gpt_3d,
    gpt3d_logical_folds as j_folds,
    GPT3DParams as JaxGPT3DParams,
)
from apex_tpu.transformer.testing.standalone_gpt import (
    gpt_next_token_loss as j_next_token_loss,
    init_gpt_layer_stack as j_init_layer_stack,
)
from apex_tpu.transformer.testing.standalone_transformer_lm import (
    Embedding as JaxEmbedding,
    ParallelTransformerLayer as JaxLayer,
    parallel_lm_logits as j_lm_logits,
)
from apex_tpu_torch.data.sequence import segment_loss_mask
from apex_tpu_torch.parallel.launch import start_multiprocess
from apex_tpu_torch.testing import l1
from apex_tpu_torch.transformer import tensor_parallel as tp
from apex_tpu_torch.transformer.testing.gpt_parallel_train import (
    GPT3DParams,
    build_gpt_3d,
    gpt3d_logical_folds,
    init_gpt_params,
)
from apex_tpu_torch.transformer.testing.standalone_gpt import (
    GPTModel,
    init_gpt_layer_stack,
)
from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
    TransformerConfig,
)
from torch_threads import one_torch_thread  # noqa: F401

WORLD, DP, PP, TP, VPP, M = 8, 2, 2, 2, 2, 2
MOE = {"num_experts": 4, "expert_axis": "dp"}
MOE_STEPS = 3
BASELINE = pathlib.Path(__file__).parent / "L1" / "baselines" / "gpt_3d.json"


def _segments():
    """Packed rows: documents of 3-9 tokens, some rows ending in padding
    (id 0); and one document spanning every row."""
    rng = np.random.default_rng(7)
    docs = np.zeros((8, 16), np.int64)
    for r in range(8):
        pos, seg = 0, 1
        end = 16 - (r % 3)                   # 0-2 padding tokens
        while pos < end:
            n = min(int(rng.integers(3, 10)), end - pos)
            docs[r, pos:pos + n] = seg
            pos, seg = pos + n, seg + 1
    return {"docs": docs, "full": np.ones((8, 16), np.int64)}


def _serial_losses(cfg, params, tokens, segments=None):
    """The serial per-shard loss sum of the JAX modules over the same
    global parameters (no mesh bound, so tp degrades to one rank): with
    ``segments`` the block-diagonal packed ``(masked sum, count)``, else
    the dp-mean of the microbatches' mean losses."""
    embed = JaxEmbedding(cfg)
    layer = JaxLayer(cfg, self_attn_mask_type=AttnMaskType.causal)
    ln = JaxLN(cfg.hidden_size, eps=cfg.layernorm_epsilon)
    per_shard = tokens.shape[0] // DP
    mb = per_shard // M
    losses, sums, counts = [], 0.0, 0.0
    for i in range(DP * M):
        t = tokens[i * mb:(i + 1) * mb]
        seg = None if segments is None else segments[i * mb:(i + 1) * mb]
        h = embed.apply({"params": params.embedding}, t)
        for v in range(cfg.num_layers):
            lp = jax.tree_util.tree_map(lambda l: l[v // PP, v % PP],
                                        params.layers)
            kw = {} if seg is None else {"segment_ids": seg}
            h = layer.apply({"params": lp}, h, None, **kw)
        h = ln.apply({"params": params.final_ln}, h)
        logits = j_lm_logits(
            h, params.embedding["word_embeddings"]["embedding"], cfg)
        per_tok = j_next_token_loss(logits, t, cfg)
        if seg is None:
            losses.append(jnp.mean(per_tok))
        else:
            mask = j_segment_loss_mask(seg)
            sums = sums + jnp.sum(per_tok * mask)
            counts = counts + jnp.sum(mask)
    if segments is None:
        return jnp.mean(jnp.stack(losses))
    return sums / counts


@pytest.fixture(scope="module")
def run():
    """The eight ranks' results and the JAX side (computed while they
    run)."""
    cfg = JaxConfig(**l1.GPT_3D)
    with jax.threefry_partitionable(False):
        mesh = jparallel.initialize_model_parallel(**l1.GPT_3D_GRID)
        try:
            init_fn, _, _ = j_build_gpt_3d(cfg, num_chunks=VPP,
                                           num_microbatches=M, mesh=mesh)
            tokens = jax.random.randint(jax.random.PRNGKey(1),
                                        l1.GPT_3D_BATCH, 0, 64)
            params = jax.jit(lambda k, t: init_fn(k, t)[0])(
                jax.random.PRNGKey(0), tokens)
        finally:
            jparallel.destroy_model_parallel()
        moe_params, moe_want = _jax_moe(tokens)
    params = jax.tree_util.tree_map(np.asarray, params)
    tokens = np.asarray(tokens).astype(np.int64)
    segments = _segments()
    job = start_multiprocess(
        ranks.gpt_3d_cases, WORLD,
        args=(dict(params._asdict()), tokens, segments,
              {"config": MOE, "params": dict(moe_params._asdict())}),
        timeout=240.0, num_threads=1)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: _serial_losses(cfg, p, tokens)))(params)
    flash = JaxConfig(**dict(l1.GPT_3D, use_flash_attention=True))
    packed = jax.jit(lambda p, s: _serial_losses(flash, p, tokens, s))(
        params, segments["docs"])
    want = {"loss": float(loss), "packed/docs": float(packed),
            "grads": jax.tree_util.tree_map(np.asarray, grads),
            "moe": moe_want()}
    return params, job.join(), want


def _jax_moe(tokens):
    """JAX's MoE ``build_gpt_3d`` on the same grid: its jitted ``init_fn``
    weights (numpy), and a function computing, while the ranks run, the
    first step's loss and gradients (``jax.grad`` of its ``make_loss_fn``)
    and three FusedAdam steps' losses."""
    mesh = jparallel.initialize_model_parallel(**l1.GPT_3D_GRID)
    init_fn, make_loss_fn, _ = j_build_gpt_3d(
        JaxConfig(**dict(l1.GPT_3D, **MOE)), num_chunks=VPP,
        num_microbatches=M, mesh=mesh)
    held = {}

    def init(k, t):
        p, held["specs"] = init_fn(k, t)
        return p

    params = jax.jit(init)(jax.random.PRNGKey(0), tokens)

    def steps():
        jparallel.initialize_model_parallel(**l1.GPT_3D_GRID)
        try:
            value_and_grad = jax.jit(jax.value_and_grad(
                make_loss_fn(held["specs"])))
            opt = JaxAdam(lr=1e-3)
            p, state = params, opt.init(params)
            update = jax.jit(opt.step)
            losses, first = [], None
            for _ in range(MOE_STEPS):
                loss, g = value_and_grad(p, tokens)
                losses.append(float(loss))
                first = first or jax.tree_util.tree_map(np.asarray, g)
                p, state = update(g, state, p)
        finally:
            jparallel.destroy_model_parallel()
        return {"losses": losses, "grads": first}

    jparallel.destroy_model_parallel()
    return jax.tree_util.tree_map(np.asarray, params), steps


def _rank(d, s, t):
    return (d * PP + s) * TP + t


def test_gpt_3d_trace_matches_the_stored_baseline(run):
    """Ten FusedAdam steps on every rank against ``gpt_3d.json`` at
    ``compare_traces``' defaults (the largest gap is in ROADMAP.md)."""
    _, results, _ = run
    baseline = json.loads(BASELINE.read_text())
    for r, res in enumerate(results):
        assert res["trace"]["loss"] == results[0]["trace"]["loss"], r
        assert l1.compare_traces(res["trace"], baseline) == []
    gap = max(abs(a - b) / abs(b) for a, b in
              zip(results[0]["trace"]["loss"], baseline["loss"]))
    assert gap < 1e-4
    assert results[0]["trace"]["loss"][-1] < results[0]["trace"]["loss"][0]


def test_first_loss_matches_the_serial_jax_loss(run):
    _, results, want = run
    np.testing.assert_allclose(results[0]["trace"]["loss"][0], want["loss"],
                               rtol=1e-5)


def _leaves_with_path(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _gathered(results, d):
    """dp replica ``d``'s first-step gradients: the tp shards gathered,
    the pp stages' ``[vpp, 1, ...]`` layer stacks joined on dim 1."""
    per_stage = []
    for s in range(PP):
        shards = [results[_rank(d, s, t)]["grads"] for t in range(TP)]
        specs = tp.infer_param_specs(shards[0])
        per_stage.append(tp.gather_params(shards, specs))
    layers = jax.tree_util.tree_map(
        lambda *ls: np.concatenate([np.asarray(x) for x in ls], axis=1),
        *[g.layers for g in per_stage])
    return per_stage, GPT3DParams(embedding=per_stage[0].embedding,
                                  layers=layers,
                                  final_ln=per_stage[0].final_ln)


@pytest.mark.parametrize("d", range(DP))
def test_first_step_gradients_match_serial_jax_grad(run, d):
    """The gradients the first step's FusedAdam took, gathered over tp and
    pp, leaf by leaf against ``jax.grad`` of the serial loss: the tied
    embedding with its entry part summed over pp and its head part counted
    once, the sequence-parallel leaves summed over tp, all averaged over
    dp."""
    _, results, want = run
    _, got = _gathered(results, d)
    n = 0
    for field in ("embedding", "layers", "final_ln"):
        for path, w in _leaves_with_path(getattr(want["grads"], field)):
            g = getattr(got, field)
            for k in path:
                g = g[k.key]
            np.testing.assert_allclose(np.asarray(g), w, rtol=2e-4,
                                       atol=1e-5,
                                       err_msg=f"dp{d} {field}/{path}")
            n += 1
    assert n >= 16


def test_pipeline_replicated_gradients_agree_on_every_stage(run):
    """The embedding and ``final_ln`` are whole on every pipeline rank, and
    so are their gradients (the pp sum of the entry, the head once)."""
    _, results, _ = run
    for d in range(DP):
        stages, _ = _gathered(results, d)
        for field in ("embedding", "final_ln"):
            for a, b in zip(jax.tree_util.tree_leaves(
                    getattr(stages[0], field)), jax.tree_util.tree_leaves(
                    getattr(stages[1], field))):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_an_overflow_skips_the_step_on_every_rank(run):
    """``make_train_step(scaler=...)`` with an inf injected into one rank's
    gradient by ``grad_tap``: every rank agrees, the parameters keep their
    bits, one skip is counted and the scale halves; the next clean step
    applies."""
    _, results, _ = run
    losses = {round(r["overflow"]["loss"], 6) for r in results}
    assert len(losses) == 1
    for res in results:
        o = res["overflow"]
        assert o["unchanged"] and o["skipped"] == 1
        assert o["scale"] == 2.0 ** 7
        assert o["skipped_after_clean"] == 1 and o["moved_after_clean"]
        assert o["group_step"] == [1]
        np.testing.assert_allclose(o["clean_loss"], o["loss"], rtol=1e-6)


def test_block_diagonal_packed_loss_matches_jax(run):
    """``packed_inputs`` + ``block_diagonal`` on the flash core: the
    segment ids ride the pipeline and mask attention per document; the
    loss against the JAX modules' serial packed loss (flash in interpret
    mode, the same segment ids)."""
    _, results, want = run
    for res in results:
        np.testing.assert_allclose(res["packed/docs"], want["packed/docs"],
                                   rtol=1e-5)


def test_full_coverage_segments_give_the_plain_flash_loss(run):
    _, results, _ = run
    for res in results:
        np.testing.assert_allclose(res["packed/full"], res["flash_plain"],
                                   rtol=1e-6)
        assert abs(res["packed/docs"] - res["flash_plain"]) > 1e-3


# ------------------------------------------------ no spawn: one process


def _small(**kw):
    return TransformerConfig(**dict(l1.GPT_3D, tensor_axis=None,
                                    sequence_parallel=False, **kw))


def test_moe_3d_step_matches_jax(run):
    """The MoE step's first loss, and the next two after FusedAdam, within
    1e-5 of JAX's on every rank; the experts split over dp (two of four a
    rank), the router kept in fp32."""
    _, results, want = run
    for res in results:
        np.testing.assert_allclose(res["moe"]["losses"],
                                   want["moe"]["losses"], rtol=1e-5)
        assert res["moe"]["w1"] == (VPP, 1, 2, 32, 128)
        assert res["moe"]["router_dtype"] == "torch.float32"
    assert want["moe"]["losses"][-1] < want["moe"]["losses"][0]


def test_moe_3d_gradients_match_jax_grad(run):
    """The first step's gradients, gathered over tp and pp and the expert
    stacks joined over dp, leaf by leaf against ``jax.grad`` of JAX's MoE
    ``build_gpt_3d`` loss (whose aux term is the tp mean of each rank's
    routing loss): the experts' gradients whole on their owner (not
    summed over dp), the router's and experts' summed over tp."""
    _, results, want = run
    per_dp = []
    for d in range(DP):
        moe = [dict(r, grads=r["moe"]["grads"]) for r in results]
        per_dp.append(_gathered(moe, d)[1])
    experts = ("w1", "b1", "w2", "b2")
    n = 0
    for field in ("embedding", "layers", "final_ln"):
        for path, w in _leaves_with_path(getattr(want["moe"]["grads"],
                                                 field)):
            keys = [k.key for k in path]

            def at(tree):
                t = getattr(tree, field)
                for k in keys:
                    t = t[k]
                return np.asarray(t)

            if field == "layers" and keys[-1] in experts:
                got = np.concatenate([at(g) for g in per_dp], axis=2)
            else:
                got = at(per_dp[0])
                np.testing.assert_array_equal(got, at(per_dp[1]))
            np.testing.assert_allclose(got, w, rtol=2e-4, atol=1e-5,
                                       err_msg=f"{field}/{keys}")
            n += 1
    assert n >= 16


def test_moe_3d_collectives(run):
    """Every rank issues the same collectives in one step, among them the
    expert all-to-alls: 4 layers x 2 microbatches, one each way forward
    (and again in each tick's recomputation), one each way backward."""
    _, results, _ = run
    calls = {str(r["moe"]["calls"]) for r in results}
    assert len(calls) == 1, calls
    assert results[0]["moe"]["calls"]["all_to_all"] > 0


@pytest.mark.parametrize("what", ["num_experts", "collect_stats"])
def test_unported_options_raise_naming_the_roadmap_item(what):
    """Both options are ported now.  ``num_experts``: without a grid the
    MoE step is the serial MoE model's mean over the microbatches of
    ``loss + 1e-2 * aux``.  ``collect_stats``: the step returns the bare
    step's loss with its ``PartialTrainStats`` (held against JAX in
    ``test_torch_trainstats.py``)."""
    if what == "num_experts":
        from apex_tpu_torch.transformer.moe import collect_moe_aux

        cfg = _small(num_experts=4)
        tokens = torch.randint(0, 64, (8, 16),
                               generator=torch.Generator().manual_seed(2))
        init_fn, make_loss_fn, _ = build_gpt_3d(cfg, num_chunks=4,
                                                num_microbatches=M,
                                                device="cpu")
        params, specs = init_fn(3)
        loss = make_loss_fn(specs)(params, tokens)
        model = GPTModel(cfg, device="cpu")
        model.load_params(init_gpt_params(cfg, 3, device="cpu"))
        ce, aux = [], []
        for t in tokens.chunk(M):
            ce.append(model(t, labels=t).mean())
            aux.append(collect_moe_aux(model))
        ref = torch.stack(ce).mean() + 1e-2 * torch.stack(aux).mean()
        torch.testing.assert_close(loss, ref, rtol=1e-6, atol=0)
        return
    from apex_tpu_torch.amp._tree import tree_leaves
    from apex_tpu_torch.observability.trainstats import PartialTrainStats
    from apex_tpu_torch.optimizers import FusedAdam

    tokens = torch.randint(0, 64, (8, 16),
                           generator=torch.Generator().manual_seed(2))
    losses = []
    for collect in (False, True):
        init_fn, _, make_train_step = build_gpt_3d(_small(), num_chunks=4,
                                                   device="cpu")
        params, specs = init_fn(0)
        step = make_train_step(FusedAdam(tree_leaves(params), lr=1e-3),
                               specs, collect_stats=collect)
        out = step(params, tokens)
        if collect:
            loss, stats = out
            assert isinstance(stats, PartialTrainStats)
            assert torch.equal(stats.loss, loss)
        losses.append(out if not collect else loss)
    assert torch.equal(*losses)


def test_without_a_grid_the_step_is_the_serial_model():
    """No grid: one pipeline stage of four chunks; the loss is the
    standalone GPT's mean over the microbatches' mean losses."""
    cfg = _small()
    tokens = torch.randint(0, 64, (8, 16),
                           generator=torch.Generator().manual_seed(2))
    for kw in ({}, {"remat_ticks": True}):
        init_fn, make_loss_fn, _ = build_gpt_3d(cfg, num_chunks=4,
                                                num_microbatches=M,
                                                device="cpu", **kw)
        params, specs = init_fn(3)
        loss = make_loss_fn(specs)(params, tokens)
        model = GPTModel(cfg, device="cpu")
        model.load_params(init_gpt_params(cfg, 3, device="cpu"))
        ref = torch.stack([model(t, labels=t).mean()
                           for t in tokens.chunk(M)]).mean()
        torch.testing.assert_close(loss, ref, rtol=1e-6, atol=0)


def test_moe_aux_rides_the_packed_block_diagonal_pipeline():
    """With the experts, ``packed_inputs`` and ``block_diagonal`` the aux
    slot rides beside the activations and the segment ids, and its term is
    added after the masked division: with one document a row the loss is
    the plain MoE step's (the masked mean of equal microbatches is the mean
    of their means)."""
    cfg = _small(num_experts=4, use_flash_attention=True)
    tokens = torch.randint(0, 64, (8, 16),
                           generator=torch.Generator().manual_seed(4))
    kw = dict(num_chunks=4, num_microbatches=M, device="cpu")
    init_fn, make_loss_fn, _ = build_gpt_3d(cfg, **kw)
    params, specs = init_fn(5)
    plain = make_loss_fn(specs)(params, tokens)
    init_fn, make_loss_fn, _ = build_gpt_3d(
        cfg, packed_inputs=True, block_diagonal=True, **kw)
    params, specs = init_fn(5)
    packed = make_loss_fn(specs)(params, (tokens, torch.ones_like(tokens)))
    torch.testing.assert_close(packed, plain, rtol=1e-6, atol=0)


def test_segment_loss_mask_matches_jax():
    segs = _segments()["docs"]
    np.testing.assert_array_equal(
        segment_loss_mask(torch.from_numpy(segs)).numpy(),
        np.asarray(j_segment_loss_mask(segs)))


def test_logical_folds_match_jax():
    tree = {"params": GPT3DParams({"a": 1}, {"b": {"c": 2}, "d": 3},
                                  {"e": 4}),
            "other": [5, {"f": 6}]}
    jtree = {"params": JaxGPT3DParams({"a": 1}, {"b": {"c": 2}, "d": 3},
                                      {"e": 4}),
             "other": [5, {"f": 6}]}
    got = gpt3d_logical_folds(tree)
    want = j_folds(jtree)
    assert jax.tree_util.tree_leaves(got) == jax.tree_util.tree_leaves(want)
    assert got["params"].layers == {"b": {"c": 2}, "d": 2}


def test_layer_stack_stage_fn_matches_jax():
    """``init_gpt_layer_stack``'s stage function against the JAX one on
    the port's drawn layer parameters."""
    cfg = _small()
    make_stage_fn, per_layer = init_gpt_layer_stack(5, cfg, device="cpu")
    assert len(per_layer) == cfg.num_layers
    x = np.random.default_rng(8).standard_normal((16, 2, 32)).astype(
        np.float32)
    jcfg = JaxConfig(**dict(l1.GPT_3D, tensor_axis=None,
                            sequence_parallel=False))
    jmake, _ = j_init_layer_stack(jax.random.PRNGKey(0), jcfg,
                                  jnp.asarray(x))
    lp = jax.tree_util.tree_map(lambda t: t.numpy(), per_layer[1])
    want = np.asarray(jmake()(lp, jnp.asarray(x)))
    got = make_stage_fn()(per_layer[1], torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
