"""The port's Switch mixture of experts (``switch_route``, ``SwitchMLP``,
``collect_moe_aux``, the MoE ``GPTModel``) against the JAX package.

The routing tensors are held for equality (a token sent to another
expert or queue slot would be another function); the module's output
and gradients at ``tests/test_moe.py``'s shapes and limits (``S, B, H,
FFN, E = 8, 4, 16, 32, 4``; 2e-5 out, 2e-4 gradients) on the Flax
module's carried weights; the MoE GPT's first step against
``jax.value_and_grad`` of JAX's ``mean(losses) + 1e-2 * aux``.  Expert
parallelism runs on eight gloo CPU ranks started once
(``torch_context_ranks.expert_parallel_case``: eight experts over an
eight-rank ``cp`` axis, one a rank) against the JAX dense module on the
gathered stacks, computed while the ranks run.  The file takes about
25 s on one worker.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_context_ranks as ranks
from apex_tpu.transformer.moe import (
    SwitchMLP as JaxSwitch,
    collect_moe_aux as j_collect,
    switch_route as j_route,
)
from apex_tpu.transformer.testing import (
    GPTModel as JaxGPT,
    TransformerConfig as JaxConfig,
)
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.parallel.launch import start_multiprocess
from apex_tpu_torch.serving.bridge import from_flax_gpt
from apex_tpu_torch.transformer.moe import (
    SwitchMLP,
    collect_moe_aux,
    switch_route,
)
from apex_tpu_torch.transformer.testing import GPTModel, TransformerConfig
from torch_threads import one_torch_thread  # noqa: F401

S, B, H, FFN, E = 8, 4, 16, 32, 4
EP = 8
NAMES = ("router", "w1", "b1", "w2", "b2")
GPT = dict(hidden_size=32, num_layers=2, num_attention_heads=4,
           padded_vocab_size=64, max_position_embeddings=16,
           hidden_dropout=0.0, attention_dropout=0.0, tensor_axis=None,
           num_experts=4)
AUX_COEFF = 1e-2


def _route_logits(kind):
    rng = np.random.default_rng(0)
    if kind == "random":
        return rng.standard_normal((32, E)).astype(np.float32)
    if kind == "ties":          # whole rows equal, and pairs tied at the top
        x = rng.standard_normal((32, E)).astype(np.float32)
        x[:8] = 0.0
        x[8:16, 1] = x[8:16, 2] = 3.0
        return x
    x = np.zeros((8, E), np.float32)       # every token wants expert 0
    x[:, 0] = 10.0
    return x


@pytest.mark.parametrize("kind,capacity", [("random", 16), ("random", 5),
                                           ("ties", 8), ("crowded", 2)])
def test_switch_route_matches_jax(kind, capacity):
    """The dispatch tensor equal to JAX's bit for bit (the first maximum on
    ties, the 1-based queue order, the capacity cut), the gate and aux
    within 1e-6."""
    logits = _route_logits(kind)
    d, g, a = switch_route(torch.from_numpy(logits), capacity)
    jd, jg, ja = j_route(jnp.asarray(logits), capacity)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6)
    np.testing.assert_allclose(float(a), float(ja), rtol=1e-6)
    flat = d.numpy().reshape(d.shape[0], -1)
    assert (flat.sum(axis=1) <= 1).all()       # one slot a token at most
    assert (d.numpy().sum(axis=0) <= 1).all()  # no slot booked twice
    if kind == "crowded":
        assert d[:, 0].sum() == 2 and d[:2, 0].sum() == 2
        assert d[:, 1:].sum() == 0
    if kind == "random" and capacity == 16:
        assert d.sum() == 32 and float(a) >= 1.0 - 1e-6


def _carried_switch(capacity_factor=1.25):
    x = np.random.default_rng(1).standard_normal((S, B, H)).astype(np.float32)
    m = JaxSwitch(hidden_size=H, ffn_size=FFN, num_experts=E,
                  capacity_factor=capacity_factor)
    params = jax.tree_util.tree_map(
        np.asarray, m.init(jax.random.PRNGKey(2), x)["params"])
    # spread the routing over the experts, so some queues overflow
    params["router"] = params["router"] * 50.0
    t = SwitchMLP(H, FFN, E, capacity_factor=capacity_factor, device="cpu")
    with torch.no_grad():
        for n in NAMES:
            getattr(t, n).copy_(torch.from_numpy(np.array(params[n])))
    return m, params, t, x


def test_switch_mlp_matches_jax():
    """Output, aux and the gradients of ``sum(y ** 2) + aux`` (every
    parameter and x), with queues overflowing at capacity factor 1.25."""
    m, params, t, x = _carried_switch()

    def loss(p, x):
        (y, aux), _ = m.apply({"params": p}, x, mutable=["losses"])
        return jnp.sum(y ** 2) + aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    yt, auxt = t(xt)
    ((yt ** 2).sum() + auxt).backward()
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(float(auxt.detach()), float(aux), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=2e-4,
                               atol=2e-5)
    for n in NAMES:
        np.testing.assert_allclose(getattr(t, n).grad.numpy(),
                                   np.asarray(gp[n]), rtol=2e-4, atol=2e-5,
                                   err_msg=n)
    # tokens were dropped: the capacity is int(ceil(32 * 1.25 / 4)) = 10
    assert t.capacity(S * B) == 10
    logits = torch.from_numpy(x.reshape(-1, H)) @ t.router
    d, _, _ = switch_route(logits, 10)
    assert d.sum() < S * B


def test_collect_moe_aux():
    """The sum over every SwitchMLP's last forward; 0.0 before any ran or
    without one; a TypeError on anything but a module (as the reference
    on anything but the mutated collections)."""
    model = GPTModel(TransformerConfig(**GPT), device="cpu")
    assert float(collect_moe_aux(model)) == 0.0
    assert float(collect_moe_aux(torch.nn.Linear(2, 2))) == 0.0
    tokens = torch.randint(0, 64, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model(tokens)
    layers = model.language_model.encoder.layers
    want = sum(float(layer.mlp.last_aux.detach()) for layer in layers)
    assert len(layers) == 2
    np.testing.assert_allclose(float(collect_moe_aux(model)), want,
                               rtol=1e-6)
    np.testing.assert_allclose(float(collect_moe_aux(layers[1])),
                               float(layers[1].mlp.last_aux), rtol=0)
    with pytest.raises(TypeError, match="Module"):
        collect_moe_aux({"losses": {}})
    with pytest.raises(TypeError):
        j_collect([1.0])


def _gpt_tokens():
    return np.asarray(jax.random.randint(jax.random.PRNGKey(0), (4, 16), 0,
                                         64)).astype(np.int64)


@pytest.fixture(scope="module")
def jax_gpt():
    """JAX's MoE GPT: its weights, and the first step's loss, aux and
    gradients of ``mean(losses) + 1e-2 * aux``."""
    model = JaxGPT(JaxConfig(**GPT))
    tokens = _gpt_tokens()
    params = model.init(jax.random.PRNGKey(1), tokens)["params"]

    def loss_fn(p):
        losses, mut = model.apply({"params": p}, tokens, labels=tokens,
                                  mutable=["losses"])
        aux = j_collect(mut)
        return jnp.mean(losses) + AUX_COEFF * aux, aux

    (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn,
                                                    has_aux=True))(params)
    np_tree = jax.tree_util.tree_map(np.asarray, params)
    return np_tree, float(loss), float(aux), from_flax_gpt(
        {"language_model": jax.tree_util.tree_map(
            np.asarray, grads["language_model"])})


def _port_gpt(params):
    model = GPTModel(TransformerConfig(**GPT), device="cpu")
    model.load_params(from_flax_gpt(params))
    return model


def test_moe_gpt_first_step_matches_jax(jax_gpt):
    params, loss, aux, grads = jax_gpt
    model = _port_gpt(params)
    tokens = torch.from_numpy(_gpt_tokens())
    got = model(tokens, labels=tokens).mean()
    got_aux = collect_moe_aux(model)
    (got + AUX_COEFF * got_aux).backward()
    total = (got + AUX_COEFF * got_aux).detach()
    np.testing.assert_allclose(float(total), loss, rtol=1e-5)
    np.testing.assert_allclose(float(got_aux.detach()), aux, rtol=1e-5)
    port = model.export_params(grads=True)
    n = 0
    for field in ("embedding", "layers", "final_ln"):
        want = jax.tree_util.tree_flatten_with_path(getattr(grads, field))[0]
        for path, w in want:
            g = getattr(port, field)
            for k in path:
                g = g[k.key]
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-4,
                                       atol=1e-5, err_msg=f"{field}{path}")
            n += 1
    assert n >= 15 and "router" in port.layers["mlp"]


def test_moe_gpt_trains(jax_gpt):
    """15 FusedAdam steps on ``mean(losses) + 1e-2 * aux``: the loss falls,
    the aux loss is real (>= 1, Cauchy-Schwarz) and in the objective."""
    model = _port_gpt(jax_gpt[0])
    opt = FusedAdam(model.parameters(), lr=1e-3)
    tokens = torch.from_numpy(_gpt_tokens())
    losses = []
    for _ in range(15):
        opt.zero_grad(set_to_none=True)
        aux_free = model(tokens, labels=tokens).mean()
        aux = collect_moe_aux(model)
        loss = aux_free + AUX_COEFF * aux
        loss.backward()
        opt.step()
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert float(aux) >= 1.0 - 1e-6
    assert model.language_model.encoder.layers[0].mlp.router.grad.abs() \
        .sum() > 0


def test_moe_params_keep_the_reference_layout(jax_gpt):
    """``from_flax_gpt`` carries ``mlp/{router, w1, b1, w2, b2}`` as they
    are, stacked over the layers."""
    tree = from_flax_gpt(jax_gpt[0])
    mlp = tree.layers["mlp"]
    assert sorted(mlp) == sorted(NAMES)
    assert tuple(mlp["router"].shape) == (2, 32, 4)
    assert tuple(mlp["w1"].shape) == (2, 4, 32, 128)
    assert tuple(mlp["w2"].shape) == (2, 4, 128, 32)


# --------------------------------------------- expert parallelism (spawn)


@pytest.fixture(scope="module")
def ep_run():
    rng = np.random.default_rng(3)

    def f(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    params = {"router": f(H, EP), "w1": f(EP, H, FFN, scale=0.2),
              "b1": f(EP, FFN, scale=0.1), "w2": f(EP, FFN, H, scale=0.2),
              "b2": f(EP, H, scale=0.1)}
    x = f(S, B * EP, H)
    job = start_multiprocess(ranks.expert_parallel_case, EP,
                             args=({"params": params, "x": x},),
                             timeout=180.0, num_threads=1)
    dense = JaxSwitch(hidden_size=H, ffn_size=FFN, num_experts=EP,
                      capacity_factor=8.0)

    def loss(p, x):
        (y, _), _ = dense.apply({"params": p}, x, mutable=["losses"])
        return jnp.sum(y ** 2), y

    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    want = {"y": np.asarray(y), "dx": np.asarray(gx),
            **{f"d{n}": np.asarray(gp[n]) for n in NAMES}}
    return job.join(), want


def _cols(results, field):
    return np.concatenate([r[field] for r in results], axis=1)


def test_expert_parallel_matches_dense_jax(ep_run):
    """Each rank holds one expert; the all-to-all pair moves the tokens:
    the output and x's gradient against JAX's dense module on the
    gathered stacks (2e-5, 2e-4); each expert's gradient whole on its
    owner, the router's summed over the ranks' tokens (2e-4)."""
    results, want = ep_run
    np.testing.assert_allclose(_cols(results, "y"), want["y"], rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(_cols(results, "dx"), want["dx"], rtol=2e-4,
                               atol=2e-5)
    for n in ("w1", "b1", "w2", "b2"):
        got = np.concatenate([r[f"d{n}"] for r in results])
        np.testing.assert_allclose(got, want[f"d{n}"], rtol=2e-4,
                                   atol=2e-5, err_msg=n)
    np.testing.assert_allclose(sum(r["drouter"] for r in results),
                               want["drouter"], rtol=2e-4, atol=2e-5)


def test_expert_parallel_layout_and_collectives(ep_run):
    """Local stacks of one expert; the router drawn alike on every rank,
    the experts' init folded by the rank; one all-to-all each way in the
    forward and in the backward."""
    results, _ = ep_run
    for r in results:
        assert r["shapes"] == {"w1": (1, H, FFN), "b2": (1, H)}
        assert r["calls"][0]["all_to_all"] == 2
        assert r["calls"][1]["all_to_all"] == 2
        np.testing.assert_array_equal(r["drawn"]["router"],
                                      results[0]["drawn"]["router"])
        assert np.isfinite(r["aux"]) and r["aux"] >= 1.0 - 1e-6
    assert not np.allclose(results[0]["drawn"]["w1"],
                           results[1]["drawn"]["w1"])
