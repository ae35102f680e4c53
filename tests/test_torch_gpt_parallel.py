"""The port's GPT training step under data, tensor and sequence
parallelism against the JAX package's tensor-parallel ``GPTModel``.

The model is the reference's ``_trace_gpt_3d`` width (hidden 32, 4
heads, vocabulary 64, 16 positions, no dropout, fp32) at 2 layers with
no pipeline.  Four gloo CPU ranks (one spawn for the module, every case
in it) train it through the port's path: the weights sharded by
``shard_params``, the batch by ``dp_shard_batch``, the forward through
the vocab-parallel embedding, the tensor-parallel layers and the
vocab-parallel cross entropy, the backward, the sequence-parallel
gradient sum, the data-parallel all-reduce, and ``FusedAdam`` on the
local shards.  JAX trains the same weights on a four-device sub-mesh
under ``shard_over`` with the loss averaged over ``dp`` and ``tp``.

Limits: the first step's loss within 1e-5 (relative), every gathered
gradient within rtol 2e-4 / atol 1e-5 (the JAX package's own limits
between its two tensor-parallel schedules,
``test_overlap_gpt_train_loss_and_grads_match``), five steps' losses
within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_parallel_ranks as ranks
from apex_tpu import parallel as jparallel
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.parallel import collectives as jcc
from apex_tpu.transformer import tensor_parallel as jtp
from apex_tpu.transformer.testing import GPTModel as JaxGPT
from apex_tpu.transformer.testing import TransformerConfig as JaxConfig
from apex_tpu_torch.parallel.launch import run_multiprocess
from apex_tpu_torch.serving.bridge import from_flax_gpt
from apex_tpu_torch.transformer import tensor_parallel as tp

WORLD, STEPS, BATCH, SEQ = 4, 5, 4, 16
GPT = dict(hidden_size=32, num_layers=2, num_attention_heads=4,
           padded_vocab_size=64, max_position_embeddings=SEQ,
           hidden_dropout=0.0, attention_dropout=0.0)
# name -> (tp size, config on top of GPT)
CASES = {
    "dp2_tp2_sp": (2, dict(sequence_parallel=True)),
    "dp1_tp4": (4, {}),
    "dp2_tp2_sp_modern": (2, dict(sequence_parallel=True,
                                  num_query_groups=2,
                                  position_embedding_type="rope",
                                  swiglu=True)),
    "dp2_tp2_sp_flash": (2, dict(sequence_parallel=True,
                                 use_flash_attention=True)),
}
# configs the tensor-parallel size cannot divide: (tp size, config)
RAISES = {
    "query_groups": (2, dict(num_query_groups=1)),
    "heads": (4, dict(num_attention_heads=2, hidden_size=32)),
    "vocab": (4, dict(padded_vocab_size=66)),
}


def _params(cfg, seed):
    """Random global weights in the Flax GPT's tree: normal kernels and
    tables (std 0.02), and biases and norm parameters off their inits so
    their gradients carry through every path."""
    shapes = jax.eval_shape(
        lambda: JaxGPT(cfg).init(jax.random.PRNGKey(0),
                                 jnp.zeros((2, SEQ), jnp.int32)))["params"]
    leaves, tree = jax.tree_util.tree_flatten_with_path(shapes)
    rng = np.random.default_rng(seed)
    out = []
    for path, s in leaves:
        name = str(path[-1].key)
        x = rng.standard_normal(s.shape).astype(np.float32)
        out.append(1.0 + 0.1 * x if name == "scale" else 0.02 * x)
    return jax.tree_util.tree_unflatten(tree, out)


def _tokens():
    return np.random.default_rng(1).integers(
        0, GPT["padded_vocab_size"], (BATCH, SEQ)).astype(np.int64)


def _jax_trace(tp_size, cfg, params, tokens):
    """JAX's dp-mean losses over STEPS FusedAdam steps and the first
    step's global gradients (numpy, Flax tree)."""
    jparallel.initialize_model_parallel(tensor_model_parallel_size=tp_size,
                                        devices=jax.devices()[:WORLD])
    try:
        model = JaxGPT(cfg)
        specs = jtp.infer_param_specs(params)

        def local(p, t):
            losses = model.apply({"params": p}, t, labels=t)
            return jcc.all_reduce(jnp.mean(losses), ("dp", "tp"),
                                  "mean")[None]

        f = jcc.shard_over(local, in_specs=(specs, P("dp")),
                           out_specs=P(None))
        grad_fn = jax.jit(jax.value_and_grad(lambda p, t: f(p, t)[0]))
        opt = JaxFusedAdam(lr=1e-3)
        step = jax.jit(lambda g, s, p: opt.step(g, s, p))
        p = jax.tree_util.tree_map(jnp.asarray, params)
        state = opt.init(p)
        t = jnp.asarray(tokens, jnp.int32)
        losses, first = [], None
        for i in range(STEPS):
            loss, grads = grad_fn(p, t)
            losses.append(float(loss))
            if i == 0:
                first = jax.tree_util.tree_map(np.asarray, grads)
            p, state = step(grads, state, p)
        return losses, first
    finally:
        jparallel.destroy_model_parallel()


@pytest.fixture(scope="module")
def traces():
    """Every case on both sides: the port's four ranks in one spawn, JAX
    in this process."""
    tokens = _tokens()
    port_cases, jax_side = [], {}
    for name, (tp_size, extra) in CASES.items():
        cfg = dict(GPT, tensor_axis="tp", **extra)
        params = _params(JaxConfig(**cfg), seed=len(port_cases))
        port_cases.append({"tp": tp_size, "config": cfg,
                           "params": params})
        jax_side[name] = (tp_size, cfg, params)
    for name, (tp_size, extra) in RAISES.items():
        port_cases.append({"tp": tp_size, "raises": True,
                           "config": dict(GPT, tensor_axis="tp", **extra)})
    results = run_multiprocess(ranks.gpt_cases, WORLD,
                               args=(port_cases, tokens, STEPS),
                               timeout=150.0, num_threads=1)
    out = {}
    for i, name in enumerate(CASES):
        tp_size, cfg, params = jax_side[name]
        jl, jg = _jax_trace(tp_size, JaxConfig(**cfg), params, tokens)
        out[name] = (tp_size, params, [r[i] for r in results], jl, jg)
    for j, name in enumerate(RAISES, start=len(CASES)):
        out[name] = [r[j] for r in results]
    return out


def _global(tree):
    return from_flax_gpt(tree)


@pytest.mark.parametrize("case", list(CASES))
def test_first_loss_matches_jax(traces, case):
    _, _, port, jax_losses, _ = traces[case]
    for rank in port:
        np.testing.assert_allclose(rank["losses"][0], jax_losses[0],
                                   rtol=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_gathered_gradients_match_jax(traces, case):
    """The first step's gradients, the tensor-parallel shards gathered,
    against JAX's global gradients, leaf by leaf; every data-parallel
    replica holds the same ones."""
    tp_size, params, port, _, jax_grads = traces[case]
    specs = tp.infer_param_specs(_global(params))
    want = _global(jax_grads)
    dp = WORLD // tp_size
    for d in range(dp):
        shards = [port[d * tp_size + t]["grads"] for t in range(tp_size)]
        got = tp.gather_params(
            [type(want)(**{k: s[k] for k in want._fields}) for s in shards],
            specs)
        n = 0
        for field in want._fields:
            flat_w = jax.tree_util.tree_flatten_with_path(
                getattr(want, field))[0]
            for path, w in flat_w:
                g = getattr(got, field)
                for k in path:
                    g = g[k.key]
                np.testing.assert_allclose(
                    np.asarray(g), np.asarray(w), rtol=2e-4, atol=1e-5,
                    err_msg=f"{case} dp{d} {field}/{path}")
                n += 1
        assert n >= 16


@pytest.mark.parametrize("case", list(CASES))
def test_five_adam_steps_match_jax(traces, case):
    _, _, port, jax_losses, _ = traces[case]
    for rank in port:
        np.testing.assert_allclose(rank["losses"], jax_losses, rtol=1e-4)
        assert rank["losses"][-1] < rank["losses"][0]


@pytest.mark.parametrize("case", list(CASES))
def test_the_step_runs_through_the_collectives(traces, case):
    """Every rank reduced its gradients over dp each step (one flat
    all-reduce; the loss's dp mean another), and tensor parallelism ran
    its regions: all-reduces without sequence parallelism, all-gathers
    and reduce-scatters with it."""
    tp_size, _, port, _, _ = traces[case]
    sp = CASES[case][1].get("sequence_parallel", False)
    for rank in port:
        calls = rank["calls"]
        assert calls["all_reduce"] >= 2 * STEPS
        if sp:
            assert calls["all_gather"] > 0 and calls["reduce_scatter"] > 0
        else:
            assert calls["reduce_scatter"] == 0
            assert calls["all_reduce"] > 2 * STEPS


@pytest.mark.parametrize("case", list(RAISES))
def test_an_indivisible_config_raises_like_the_reference(traces, case):
    """Query groups, heads or vocabulary that tp cannot divide: the port
    raises ``ValueError`` at build, as the reference's ``divide`` does
    under ``shard_over``."""
    tp_size, extra = RAISES[case]
    for got in traces[case]:
        assert got is not None and got.startswith("ValueError"), got
    cfg = JaxConfig(**dict(GPT, tensor_axis="tp", **extra))
    jparallel.initialize_model_parallel(tensor_model_parallel_size=tp_size,
                                        devices=jax.devices()[:WORLD])
    try:
        init = jcc.shard_over(
            lambda t: jax.tree_util.tree_leaves(
                JaxGPT(cfg).init(jax.random.PRNGKey(0), t))[0][None],
            in_specs=P(), out_specs=P(None))
        with pytest.raises(ValueError, match="not divisible"):
            jax.eval_shape(init, jnp.zeros((2, SEQ), jnp.int32))
    finally:
        jparallel.destroy_model_parallel()


def test_world_size_one_is_the_single_device_step():
    """With no grid the tensor-parallel config is the single-device model:
    the same loss and gradients, bit for bit, as ``tensor_axis=None``."""
    from apex_tpu_torch.transformer.testing.gpt_parallel_train import (
        init_gpt_params,
    )
    from apex_tpu_torch.transformer.testing.standalone_gpt import GPTModel
    from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
        TransformerConfig,
    )

    tokens = torch.from_numpy(_tokens())
    out = []
    for axis in ("tp", None):
        cfg = TransformerConfig(**GPT, tensor_axis=axis,
                                sequence_parallel=True)
        model = GPTModel(cfg, device="cpu")
        model.load_params(init_gpt_params(cfg, 0, device="cpu"))
        loss = model(tokens, labels=tokens).mean()
        loss.backward()
        out.append([loss.detach()] + [p.grad for p in model.parameters()])
        assert not any(getattr(p, "sequence_parallel", False)
                       for p in model.parameters())
    for a, b in zip(*out):
        assert torch.equal(a, b)
