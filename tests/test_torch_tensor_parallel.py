"""The port's tensor, sequence and data parallelism against the JAX
package, module by module, on four gloo CPU ranks.

One process group serves the whole module: a module-scoped fixture
spawns four ranks (``run_multiprocess``, dp2 x tp2 on the port's rank
grid), runs every rank-side check of ``torch_parallel_ranks.
module_checks`` in that one run, and returns numpy results; each test
then asserts one of them.  The JAX side runs in this process on a
four-device sub-mesh of the same shape under ``cc.shard_over``, from the
same numpy inputs; rank ``r`` of the port holds what device ``r`` of the
mesh holds.

Each check's global function is chosen so that its gradient is what the
reference's autograd pairs give each rank: a value that is the same on
every tensor-parallel rank counts once in the loss (its cotangent is the
same on every rank), a sharded one counts on each rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_parallel_ranks as ranks
from apex_tpu import parallel as jparallel
from apex_tpu.amp import fp8 as jfp8
from apex_tpu.parallel import collectives as jcc
from apex_tpu.parallel.distributed import all_reduce_gradients as j_arg
from apex_tpu.transformer import tensor_parallel as jtp
from apex_tpu.transformer.layers.layer_norm import (
    allreduce_sequence_parallel_gradients as j_sp_grads,
)
from apex_tpu_torch.parallel.launch import run_multiprocess
from apex_tpu_torch.transformer import tensor_parallel as tp

WORLD, TP, DP = 4, 2, 2
RTOL = 1e-6


def _inputs():
    rng = np.random.default_rng(0)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    maps = {
        "copy": (f(DP, 8, 3), f(DP, TP, 8, 3)),
        "reduce": (f(DP, TP, 8, 3), f(DP, 8, 3)),
        "scatter_last": (f(DP, 3, 8), f(DP, TP, 3, 4)),
        "gather_last": (f(DP, TP, 3, 4), f(DP, 3, 8)),
        "scatter_first": (f(DP, 8, 3), f(DP, TP, 4, 3)),
        "gather_first_partial": (f(DP, TP, 4, 3), f(DP, TP, 8, 3)),
        "gather_first_whole": (f(DP, TP, 4, 3), f(DP, 8, 3)),
        "reduce_scatter": (f(DP, TP, 8, 3), f(DP, TP, 4, 3)),
    }
    inputs = {k: {"x": x, "g": g} for k, (x, g) in maps.items()}
    inputs["xent"] = {"logits": 3 * f(DP, 6, 8),
                      "target": rng.integers(0, 8, (DP, 6)).astype(np.int64),
                      "g": f(DP, 6)}
    inputs["embedding"] = {"table": f(8, 4),
                           "tokens": rng.integers(0, 8, (DP, 2, 4)),
                           "g": f(DP, 2, 4, 4)}
    inputs["column_row"] = {"x": f(DP, 8, 2, 4), "g": f(DP, 8, 2, 4),
                            "w1": f(8, 4), "b1": f(8), "w2": f(4, 8),
                            "b2": f(4)}
    inputs["sp_grads"] = {"input_layernorm": {"scale": f(DP, TP, 4)},
                          "mlp": {"kernel": f(DP, TP, 4, 3)}}
    inputs["broadcast"] = rng.integers(0, 1000, (DP, TP, 3, 5)).astype(
        np.int32)
    inputs["meta"] = {"history": np.abs(f(16)), "scale": np.float32(2.0),
                      "amax": 4 * np.abs(f(DP, TP))}
    inputs["scaler"] = {"w": f(DP, TP, 3, 2), "b": f(DP, TP, 2)}
    inputs["ddp"] = {"a": f(DP, TP, 3, 4), "b": f(DP, TP, 5)}
    inputs["collectives"] = {"x": f(DP, TP, 4, 2)}
    inputs["dp_step"] = {"x": f(8, 3), "y": f(8, 2), "w": f(2, 3),
                         "b": f(2)}
    return inputs


@pytest.fixture(scope="module")
def run():
    """The four ranks' results (rank order) and the inputs."""
    inputs = _inputs()
    results = run_multiprocess(ranks.module_checks, WORLD, args=(inputs,),
                               timeout=120.0, num_threads=1)
    return inputs, results


@pytest.fixture
def mesh():
    m = jparallel.initialize_model_parallel(
        tensor_model_parallel_size=TP, devices=jax.devices()[:WORLD])
    yield m
    jparallel.destroy_model_parallel()


def _rank(d, t):
    return d * TP + t


def _close(got, want, tol=1e-5):
    """Within ``tol`` of ``want``, relative to each element and to the
    tensor's largest magnitude (a sum of fp32 GEMM partials taken in
    another order parts by a few ulps of its terms, not of itself)."""
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def _local(a, sharded):
    """The per-device block of a [dp, (tp,) ...] input inside shard_over."""
    return a[0, 0] if sharded else a[0]


def _spec(sharded):
    return P("dp", "tp") if sharded else P("dp")


def _jax_value_and_grad(fn, x, g, x_sh, g_sh, y_sh, loss_over_tp):
    """The JAX mapping's value on every device and the gradient of the
    global loss (sum of <y, g>, counted over tp where ``loss_over_tp``)."""
    def per(x, g):
        y = fn(_local(x, x_sh))
        loss = jnp.sum(y * _local(g, g_sh))
        loss = jcc.all_reduce(loss, ("dp", "tp") if loss_over_tp else "dp")
        return loss[None], (y[None, None] if y_sh else y[None])

    f = jcc.shard_over(per, in_specs=(_spec(x_sh), _spec(g_sh)),
                       out_specs=(P(None), _spec(y_sh)))

    def loss(x, g):
        total, y = f(x, g)
        return total[0], y

    (_, y), dx = jax.value_and_grad(loss, has_aux=True)(x, g)
    return np.asarray(y), np.asarray(dx)


# name -> (JAX function of the local block, output sharded over tp, the
# loss counted on every tp rank)
JAX_MAPPINGS = {
    "copy": (lambda x: jtp.copy_to_tensor_model_parallel_region(x, "tp"),
             True, True),
    "reduce": (lambda x: jtp.reduce_from_tensor_model_parallel_region(x, "tp"),
               False, False),
    "scatter_last": (
        lambda x: jtp.scatter_to_tensor_model_parallel_region(x, "tp"),
        True, True),
    "gather_last": (
        lambda x: jtp.gather_from_tensor_model_parallel_region(x, "tp"),
        False, False),
    "scatter_first": (
        lambda x: jtp.scatter_to_sequence_parallel_region(x, "tp"),
        True, True),
    "gather_first_partial": (
        lambda x: jtp.gather_from_sequence_parallel_region(x, "tp"),
        False, True),
    "gather_first_whole": (
        lambda x: jtp.gather_from_sequence_parallel_region(x, "tp"),
        False, False),
    "reduce_scatter": (
        lambda x: jtp.reduce_scatter_to_sequence_parallel_region(x, "tp"),
        True, True),
}


def _by_rank(results, key):
    return {r: res[key] for r, res in enumerate(results)}


@pytest.mark.parametrize("name", list(JAX_MAPPINGS))
def test_mapping_forward_and_gradient_match_jax(run, mesh, name):
    """Each region's value on every rank and the gradient its backward
    collective gives (``gather_first`` with ``tensor_parallel_output_grad``
    true and false)."""
    inputs, results = run
    _, x_sh, g_sh = ranks.MAPPINGS[name]
    fn, y_sh, over_tp = JAX_MAPPINGS[name]
    x, g = inputs[name]["x"], inputs[name]["g"]
    y, dx = _jax_value_and_grad(fn, x, g, x_sh, g_sh, y_sh, over_tp)
    for d in range(DP):
        for t in range(TP):
            got_y, got_dx = results[_rank(d, t)][f"map/{name}"]
            np.testing.assert_allclose(got_y, y[d, t] if y_sh else y[d],
                                       rtol=RTOL, atol=1e-7)
            np.testing.assert_allclose(got_dx, dx[d, t] if x_sh else dx[d],
                                       rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_vocab_parallel_cross_entropy_matches_jax(run, mesh, smoothing):
    """Loss per token and the vocab-sharded logits' gradient."""
    inputs, results = run
    c = inputs["xent"]

    def per(logits, target, g):
        loss = jtp.vocab_parallel_cross_entropy(logits[0], target[0], "tp",
                                                smoothing)
        total = jcc.all_reduce(jnp.sum(loss * g[0]), "dp")
        return total[None], loss[None]

    f = jcc.shard_over(per, in_specs=(P("dp", None, "tp"), P("dp"), P("dp")),
                       out_specs=(P(None), P("dp")))

    def total(logits):
        t, loss = f(logits, c["target"], c["g"])
        return t[0], loss

    (_, loss), dlogits = jax.value_and_grad(total, has_aux=True)(c["logits"])
    v = c["logits"].shape[-1] // TP
    for d in range(DP):
        for t in range(TP):
            got_loss, got_d = results[_rank(d, t)][f"xent/{smoothing}"]
            np.testing.assert_allclose(got_loss, np.asarray(loss)[d],
                                       rtol=RTOL, atol=1e-6)
            np.testing.assert_allclose(
                got_d, np.asarray(dlogits)[d, :, t * v:(t + 1) * v],
                rtol=RTOL, atol=1e-7)


def test_vocab_parallel_cross_entropy_is_the_fused_one_at_one_rank():
    """Without an axis it is ``softmax_cross_entropy_loss`` at smoothing
    ``s * V / (V - 1)``, bit for bit, loss and gradient."""
    from apex_tpu_torch.ops.xentropy import softmax_cross_entropy_loss

    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(7, 50, generator=gen).to(torch.bfloat16)
    target = torch.randint(0, 50, (7,), generator=gen)
    g = torch.randn(7, generator=gen)
    for s in (0.0, 0.1):
        a = logits.clone().requires_grad_(True)
        b = logits.clone().requires_grad_(True)
        la = tp.vocab_parallel_cross_entropy(a, target, None, s)
        lb = softmax_cross_entropy_loss(b, target, s * 50 / 49, -1, True)
        la.backward(g)
        lb.backward(g)
        assert torch.equal(la, lb) and torch.equal(a.grad, b.grad)


def test_vocab_parallel_embedding_matches_jax(run, mesh):
    inputs, results = run
    c = inputs["embedding"]
    mod = jtp.VocabParallelEmbedding(num_embeddings=8, embedding_dim=4,
                                     axis="tp")

    def per(table, tokens, g):
        y = mod.apply({"params": {"embedding": table}}, tokens[0])
        return jcc.all_reduce(jnp.sum(y * g[0]), "dp")[None], y[None]

    f = jcc.shard_over(per, in_specs=(P("tp", None), P("dp"), P("dp")),
                       out_specs=(P(None), P("dp")))

    def total(table):
        t, y = f(table, c["tokens"], c["g"])
        return t[0], y

    (_, y), dtable = jax.value_and_grad(total, has_aux=True)(c["table"])
    for d in range(DP):
        for t in range(TP):
            got_y, got_d = results[_rank(d, t)]["embedding"]
            _close(got_y, np.asarray(y)[d])
            _close(got_d, np.asarray(dtable)[t * 4:(t + 1) * 4])


def _column_row_jax(c, sp):
    col = jtp.ColumnParallelLinear(input_size=4, output_size=8,
                                   sequence_parallel=sp, axis="tp")
    row = jtp.RowParallelLinear(input_size=8, output_size=4,
                                sequence_parallel=sp, axis="tp")
    x_spec = P("dp", "tp") if sp else P("dp")

    def per(params, x, g):
        h = col.apply({"params": {"kernel": params["w1"],
                                  "bias": params["b1"]}}, x[0])
        y = row.apply({"params": {"kernel": params["w2"],
                                  "bias": params["b2"]}}, jnp.tanh(h))
        loss = jnp.sum(y * g[0])
        loss = jcc.all_reduce(loss, ("dp", "tp") if sp else "dp")
        return loss[None], y[None]

    specs = {"w1": P("tp", None), "b1": P("tp"), "w2": P(None, "tp"),
             "b2": P()}
    f = jcc.shard_over(per, in_specs=(specs, x_spec, x_spec),
                       out_specs=(P(None), x_spec))
    params = {k: c[k] for k in specs}

    def total(params, x):
        t, y = f(params, x, c["g"])
        return t[0], y

    (_, y), (dp_, dx) = jax.value_and_grad(total, argnums=(0, 1),
                                           has_aux=True)(params, c["x"])
    return np.asarray(y), jax.tree_util.tree_map(np.asarray, dp_), \
        np.asarray(dx)


@pytest.mark.parametrize("sp", [False, True])
def test_column_then_row_parallel_linear_match_jax(run, mesh, sp):
    """Column∘Row with and without sequence parallelism: output, input
    gradient and every weight gradient (the row bias's summed over tp by
    ``allreduce_sequence_parallel_gradients`` under SP)."""
    inputs, results = run
    c = inputs["column_row"]
    y, dparams, dx = _column_row_jax(c, sp)
    S = c["x"].shape[1] // TP
    for d in range(DP):
        for t in range(TP):
            got = results[_rank(d, t)][f"column_row/sp={sp}"]
            rows = slice(t * S, (t + 1) * S) if sp else slice(None)
            _close(got["y"], y[d, rows])
            _close(got["dx"], dx[d, rows])
            _close(got["w1"], dparams["w1"][t * 4:(t + 1) * 4])
            _close(got["b1"], dparams["b1"][t * 4:(t + 1) * 4])
            _close(got["w2"], dparams["w2"][:, t * 4:(t + 1) * 4])
            _close(got["b2"], dparams["b2"])
            assert got["b2_marked"] == sp


def test_allreduce_sequence_parallel_gradients(run, mesh):
    """Under SP the row bias's own gradient covers one sequence shard and
    is not JAX's; summed over tp it is.  On a gradient tree, the norm
    leaves are summed over tp and the rest are left, as in JAX."""
    inputs, results = run
    _, dparams, _ = _column_row_jax(inputs["column_row"], True)
    for r in range(WORLD):
        got = results[r]["column_row/sp=True"]
        assert not np.allclose(got["b2_partial"], dparams["b2"], rtol=1e-3)
        _close(got["b2"], dparams["b2"])
    tree = inputs["sp_grads"]
    spec = {"input_layernorm": {"scale": P("dp", "tp")},
            "mlp": {"kernel": P("dp", "tp")}}
    f = jcc.shard_over(
        lambda g: jax.tree_util.tree_map(
            lambda v: v[None, None],
            j_sp_grads(jax.tree_util.tree_map(lambda v: v[0, 0], g), "tp")),
        in_specs=(spec,), out_specs=spec)
    want = jax.tree_util.tree_map(np.asarray, f(tree))
    for d in range(DP):
        for t in range(TP):
            got = results[_rank(d, t)]["sp_grads_dict"]
            for k, sub in want.items():
                for kk, v in sub.items():
                    np.testing.assert_allclose(got[k][kk], v[d, t],
                                               rtol=RTOL)


def test_broadcast_data_takes_tensor_rank_zero(run, mesh):
    inputs, results = run
    data = inputs["broadcast"]
    f = jcc.shard_over(
        lambda x: jtp.broadcast_data(["text"], {"text": x[0, 0]}, jnp.int32,
                                     "tp")["text"][None, None],
        in_specs=P("dp", "tp"), out_specs=P("dp", "tp"))
    want = np.asarray(f(data))
    for d in range(DP):
        for t in range(TP):
            got = results[_rank(d, t)]["broadcast"]
            np.testing.assert_array_equal(got, want[d, t])
            np.testing.assert_array_equal(got, data[d, 0])


def test_rng_tracker_streams(run):
    """The model-parallel stream differs across tp and agrees across dp;
    the default stream agrees everywhere; the data-parallel seed differs
    across dp."""
    _, results = run
    rng = _by_rank(results, "rng")
    for d in range(DP):
        assert not np.array_equal(rng[_rank(d, 0)]["model"],
                                  rng[_rank(d, 1)]["model"])
        assert rng[_rank(d, 0)]["dp_seed"] == rng[_rank(d, 1)]["dp_seed"]
    for t in range(TP):
        np.testing.assert_array_equal(rng[_rank(0, t)]["model"],
                                      rng[_rank(1, t)]["model"])
    assert rng[_rank(0, 0)]["dp_seed"] != rng[_rank(1, 0)]["dp_seed"]
    for r in range(WORLD):
        np.testing.assert_array_equal(rng[r]["default"], rng[0]["default"])
    # parallel_init draws a tp rank's shard from the model-parallel stream
    for d in range(DP):
        assert not np.array_equal(rng[_rank(d, 0)]["parallel_init"],
                                  rng[_rank(d, 1)]["parallel_init"])
    for t in range(TP):
        np.testing.assert_array_equal(rng[_rank(0, t)]["parallel_init"],
                                      rng[_rank(1, t)]["parallel_init"])


def test_data_parallel_train_step_matches_jax(run, mesh):
    """Two steps of ``data_parallel_train_step`` (FusedAdam, two
    microbatches) on each rank's slice: the dp-mean losses and the
    stepped weights, as JAX's step over the batch sharded on ``dp``;
    ``host_dp_ranks`` is the rank's own replica."""
    from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
    from apex_tpu.parallel.distributed import (
        data_parallel_train_step as j_step,
        dp_shard_batch as j_shard,
    )

    inputs, results = run
    c = inputs["dp_step"]

    def loss_fn(p, batch):
        return jnp.mean((batch["x"] @ p["w"].T + p["b"] - batch["y"]) ** 2)

    opt = JaxFusedAdam(lr=1e-2)
    step = j_step(loss_fn, opt, microbatches=2, donate=False)
    params = {"w": jnp.asarray(c["w"]), "b": jnp.asarray(c["b"])}
    state = opt.init(params)
    batch = j_shard({"x": c["x"], "y": c["y"]})
    losses = []
    for _ in range(2):
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
    for d in range(DP):
        for t in range(TP):
            got = results[_rank(d, t)]["dp_step"]
            assert got["rows"] == 4 and got["host_dp_ranks"] == [d]
            np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
            _close(got["w"], np.asarray(params["w"]))
            _close(got["b"], np.asarray(params["b"]))


def test_grad_accumulation_and_split_match_jax():
    """``grad_accumulation`` over four microbatches is the full batch's
    mean loss and gradient, as JAX's; ``split_tensor_along_last_dim``
    cuts as JAX's does."""
    from apex_tpu.parallel.distributed import grad_accumulation as j_accum
    from apex_tpu_torch.parallel import grad_accumulation

    rng = np.random.default_rng(3)
    x, w = rng.standard_normal((8, 3), np.float32), rng.standard_normal(
        (3,), np.float32)

    def torch_fn(p, batch):
        p = p.clone().requires_grad_(True)
        loss = (torch.tanh(batch @ p) ** 2).mean()
        loss.backward()
        return loss, {"w": p.grad}

    def jax_fn(p, batch):
        return jax.value_and_grad(
            lambda p: jnp.mean(jnp.tanh(batch @ p) ** 2))(p)

    loss, grads = grad_accumulation(torch_fn, 4)(torch.from_numpy(w),
                                                 torch.from_numpy(x))
    jloss, jgrad = j_accum(jax_fn, 4)(jnp.asarray(w), jnp.asarray(x))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(grads["w"].numpy(), np.asarray(jgrad),
                               rtol=1e-5, atol=1e-7)
    for got, want in zip(tp.split_tensor_along_last_dim(
            torch.from_numpy(x[:, :2].copy()), 2),
            jtp.split_tensor_along_last_dim(jnp.asarray(x[:, :2]), 2)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_update_meta_over_the_tensor_axis_matches_jax_pmax(run, mesh):
    inputs, results = run
    m = inputs["meta"]
    meta = jfp8.Fp8Meta(jnp.asarray(m["history"]), jnp.asarray(m["scale"]))

    def per(amax):
        new = jfp8.update_meta(meta, amax[0, 0], jfp8.E4M3, axis="tp")
        return new.amax_history[None, None], new.scale[None, None]

    f = jcc.shard_over(per, in_specs=P("dp", "tp"),
                       out_specs=(P("dp", "tp"), P("dp", "tp")))
    hist, scale = (np.asarray(a) for a in f(m["amax"]))
    for d in range(DP):
        for t in range(TP):
            got_hist, got_scale = results[_rank(d, t)]["update_meta"]
            np.testing.assert_array_equal(got_hist, hist[d, t])
            np.testing.assert_array_equal(got_scale, scale[d, t])
        # every tp rank took the group's largest amax
        assert hist[d, 0, 0] == m["amax"][d].max()


def test_fp8_parallel_linears_share_the_amax_over_tp_as_jax(run, mesh):
    """fp8 Column then Row at tp 2, two training-mode forwards: the output
    and every meta (history and scale) after two rolls, as JAX's fp8
    linears with the ``"fp8_meta"`` collection mutable; the histories bit
    for bit the same on both tp ranks (the shared MAX)."""
    inputs, results = run
    c = inputs["column_row"]
    col = jtp.ColumnParallelLinear(input_size=4, output_size=8, axis="tp",
                                   fp8=True)
    row = jtp.RowParallelLinear(input_size=8, output_size=4, axis="tp",
                                fp8=True)

    def init():
        return {"metas": {"x": jfp8.Fp8Meta.init(), "w": jfp8.Fp8Meta.init()}}

    def per(params, x):
        mc, mr = init(), init()
        for _ in range(2):
            h, vc = col.apply({"params": {"kernel": params["w1"],
                                          "bias": params["b1"]},
                               "fp8_meta": mc}, x[0], mutable=["fp8_meta"])
            y, vr = row.apply({"params": {"kernel": params["w2"],
                                          "bias": params["b2"]},
                               "fp8_meta": mr}, jnp.tanh(h),
                              mutable=["fp8_meta"])
            mc, mr = vc["fp8_meta"], vr["fp8_meta"]
        metas = {"col": mc["metas"], "row": mr["metas"]}
        return y[None], jax.tree_util.tree_map(lambda a: a[None, None], metas)

    specs = {"w1": P("tp", None), "b1": P("tp"), "w2": P(None, "tp"),
             "b2": P()}
    f = jcc.shard_over(per, in_specs=(specs, P("dp")),
                       out_specs=(P("dp"), P("dp", "tp")))
    y, metas = f({k: c[k] for k in specs}, c["x"])
    y = np.asarray(y)
    for d in range(DP):
        for t in range(TP):
            got = results[_rank(d, t)]["fp8_linears"]
            _close(got["y"], y[d])
            for layer in ("col", "row"):
                for k in ("x", "w"):
                    hist, scale = got["metas"][layer][k]
                    want = metas[layer][k]
                    # one ulp apart at most: the row's x is a tanh, whose
                    # last bit torch and XLA round apart near 1
                    np.testing.assert_allclose(
                        hist, np.asarray(want.amax_history)[d, t], rtol=RTOL)
                    np.testing.assert_allclose(
                        scale, np.asarray(want.scale)[d, t], rtol=RTOL)
                    other = results[_rank(d, 1 - t)]["fp8_linears"]
                    np.testing.assert_array_equal(
                        hist, other["metas"][layer][k][0])


def test_grad_scaler_agrees_over_the_tensor_axis(run):
    """An inf in one rank's gradient shard: after the data-parallel
    reduction only that shard's replicas see it, and after the scaler's
    agreement every rank skips; with no inf none does."""
    _, results = run
    sc = _by_rank(results, "grad_scaler")
    assert [sc[r]["local"] for r in range(WORLD)] == [True, False,
                                                      True, False]
    assert not any(sc[r]["agreed"] for r in range(WORLD))
    assert all(sc[r]["agreed_clean"] for r in range(WORLD))


@pytest.mark.parametrize("average", [True, False])
def test_all_reduce_gradients_predivide_matches_jax(run, mesh, average):
    """``gradient_predivide_factor=2`` with ``gradient_average`` on (the
    mean) and off (the sum over the predivide factor)."""
    inputs, results = run
    g = inputs["ddp"]
    spec = {k: P("dp", "tp") for k in g}
    f = jcc.shard_over(
        lambda g: jax.tree_util.tree_map(
            lambda v: v[None, None],
            j_arg(jax.tree_util.tree_map(lambda v: v[0, 0], g), "dp",
                  gradient_average=average, gradient_predivide_factor=2.0)),
        in_specs=(spec,), out_specs=spec)
    want = jax.tree_util.tree_map(np.asarray, f(g))
    for d in range(DP):
        for t in range(TP):
            got = results[_rank(d, t)][f"all_reduce_gradients/avg={average}"]
            for k in g:
                np.testing.assert_allclose(got[k], want[k][d, t], rtol=RTOL)


COLLECTIVES = ["all_reduce/sum", "all_reduce/mean", "all_reduce/max",
               "all_reduce/min", "all_gather/tiled", "all_gather/stacked",
               "reduce_scatter", "broadcast", "ppermute", "send_recv_next",
               "send_recv_prev", "all_to_all", "axis_index"]


def _jax_collective_outputs(x):
    both = ("dp", "tp")
    calls = {
        "all_reduce/sum": lambda x: jcc.all_reduce(x, both, "sum"),
        "all_reduce/mean": lambda x: jcc.all_reduce(x, both, "mean"),
        "all_reduce/max": lambda x: jcc.all_reduce(x, "tp", "max"),
        "all_reduce/min": lambda x: jcc.all_reduce(x, "dp", "min"),
        "all_gather/tiled": lambda x: jcc.all_gather(x, both, concat_axis=1),
        "all_gather/stacked": lambda x: jcc.all_gather(
            x, "tp", concat_axis=0, tiled=False),
        "reduce_scatter": lambda x: jcc.reduce_scatter(x, both,
                                                       scatter_axis=0),
        "broadcast": lambda x: jcc.broadcast(x, both, root=3),
        "ppermute": lambda x: jcc.ppermute(x, both, [(0, 2), (2, 1), (1, 0)]),
        "send_recv_next": lambda x: jcc.send_recv_next(x, both),
        "send_recv_prev": lambda x: jcc.send_recv_prev(x, "dp"),
        "all_to_all": lambda x: jcc.all_to_all(x, both, split_axis=0,
                                               concat_axis=1),
        "axis_index": lambda x: jnp.stack([jcc.axis_index(both),
                                           jcc.axis_index("dp"),
                                           jcc.axis_index("tp")]),
    }

    def per(x):
        return {k: fn(x[0, 0])[None, None] for k, fn in calls.items()}

    f = jcc.shard_over(per, in_specs=P("dp", "tp"),
                       out_specs={k: P("dp", "tp") for k in calls})
    return {k: np.asarray(v) for k, v in f(x).items()}


@pytest.fixture(scope="module")
def jax_collectives(run):
    inputs, _ = run
    jparallel.initialize_model_parallel(tensor_model_parallel_size=TP,
                                        devices=jax.devices()[:WORLD])
    try:
        return _jax_collective_outputs(inputs["collectives"]["x"])
    finally:
        jparallel.destroy_model_parallel()


@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective_matches_jax(run, jax_collectives, name):
    """Each collective over a named axis or a tuple of them, rank by rank
    (``ppermute`` with a partial permutation: rank 3 gets zeros)."""
    _, results = run
    want = jax_collectives[name]
    for d in range(DP):
        for t in range(TP):
            got = results[_rank(d, t)]["collectives"][name]
            np.testing.assert_allclose(got, want[d, t], rtol=RTOL)


def test_axis_sizes(run):
    _, results = run
    for r in range(WORLD):
        np.testing.assert_array_equal(
            results[r]["collectives"]["axis_size"], [4, 2, 2, 1])


def test_infer_param_specs_match_jax_over_the_gpt_tree():
    """Leaf by leaf over a tp2+sp GPT's parameters (GQA, SwiGLU, learned
    positions), and over the port's stacked ``GPT3DParams`` form, whose
    specs name the per-layer dims."""
    from apex_tpu.transformer.testing import GPTModel as JaxGPT
    from apex_tpu.transformer.testing import TransformerConfig as JaxConfig
    from apex_tpu_torch.serving.bridge import from_flax_gpt

    cfg = JaxConfig(hidden_size=32, num_layers=2, num_attention_heads=4,
                    num_query_groups=2, swiglu=True, padded_vocab_size=64,
                    max_position_embeddings=16, tensor_axis="tp",
                    sequence_parallel=True)
    shapes = jax.eval_shape(
        lambda: JaxGPT(cfg).init(jax.random.PRNGKey(0),
                                 jnp.zeros((2, 16), jnp.int32)))["params"]
    want = jtp.infer_param_specs(shapes)
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)
    got = tp.infer_param_specs(tree)
    flat_want = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, P))[0]
    assert len(flat_want) == 2 * 14 + 4     # 14 leaves a SwiGLU layer
    for path, spec in flat_want:
        leaf = got
        for k in path:
            leaf = leaf[k.key]
        assert isinstance(leaf, tp.PartitionSpec)
        assert tuple(leaf) == tuple(spec), (path, leaf, spec)
    stacked = tp.infer_param_specs(from_flax_gpt(tree))
    assert stacked.layers["self_attention"]["query_key_value"]["kernel"] \
        == tp.PartitionSpec("tp", None)
    assert stacked.embedding["word_embeddings"]["embedding"] \
        == tp.PartitionSpec("tp", None)
    assert stacked.final_ln["scale"] == tp.PartitionSpec()


def test_shard_and_gather_params_round_trip():
    """``shard_params`` cuts the split dim of each leaf (the per-layer
    dim of a layer stack) and ``gather_params`` puts the tree back."""
    from apex_tpu_torch.transformer.testing.gpt_parallel_train import (
        init_gpt_params,
    )
    from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
        TransformerConfig,
    )

    cfg = TransformerConfig(hidden_size=32, num_layers=2,
                            num_attention_heads=4, padded_vocab_size=64,
                            max_position_embeddings=16)
    params = init_gpt_params(cfg, 0, device="cpu")
    specs = tp.infer_param_specs(params)
    shards = [tp.shard_params(params, specs, r, 4) for r in range(4)]
    qkv = shards[1].layers["self_attention"]["query_key_value"]["kernel"]
    assert qkv.shape == (2, 96 // 4, 32)
    torch.testing.assert_close(
        qkv, params.layers["self_attention"]["query_key_value"]["kernel"][
            :, 24:48], rtol=0, atol=0)
    dense = shards[3].layers["self_attention"]["dense"]["kernel"]
    assert dense.shape == (2, 32, 8)
    back = tp.gather_params(shards, specs)
    for f in params._fields:
        jax.tree_util.tree_map(
            lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0),
            getattr(params, f), getattr(back, f))


def test_checkpoint_recomputes_with_the_same_dropout():
    """``checkpoint`` with dropout from an explicit generator and from the
    tracker gives the gradients of the plain call, and leaves both
    streams where the plain call leaves them."""
    from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
        dropout,
    )

    def fn(x, gen):
        h = dropout(torch.tanh(x), 0.5, gen)
        return dropout(h * 2.0, 0.5, tp.get_rng_states_tracker().fork())

    x0 = torch.randn(6, 5, generator=torch.Generator().manual_seed(1))
    outs = []
    for ckpt in (False, True):
        gen = tp.model_parallel_seed(7, axis=None)
        x = x0.clone().requires_grad_(True)
        y = tp.checkpoint(fn, x, gen) if ckpt else fn(x, gen)
        y.sum().backward()
        outs.append((y.detach(), x.grad, torch.rand(3, generator=gen),
                     torch.rand(3, generator=tp.get_rng_states_tracker()
                                .fork())))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_overlap_comm_raises_and_names_the_next_slice():
    """``overlap_comm`` was queued for the pipeline's slice, which ported
    it (``tensor_parallel/overlap.py``; its rings at tp > 1 are held
    against JAX in ``test_torch_pipeline.py``): it no longer raises, and
    without a grid the linears and the GPT are their one-rank forms, bit
    for bit those built without it."""
    from apex_tpu_torch.transformer.testing.gpt_parallel_train import (
        init_gpt_params,
    )
    from apex_tpu_torch.transformer.testing.standalone_gpt import GPTModel
    from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
        TransformerConfig,
    )

    x = torch.randn(3, 2, 4, generator=torch.Generator().manual_seed(0))
    ys = []
    for overlap in (True, False):
        col = tp.ColumnParallelLinear(4, 8, overlap_comm=overlap,
                                      sequence_parallel=True)
        with torch.no_grad():
            col.kernel.copy_(torch.arange(32.0).reshape(8, 4) / 32)
        ys.append(col(x))
    assert torch.equal(*ys)
    tokens = torch.randint(0, 64, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    losses = []
    for overlap in (True, False):
        cfg = TransformerConfig(hidden_size=32, num_attention_heads=4,
                                padded_vocab_size=64, num_layers=1,
                                overlap_comm=overlap, sequence_parallel=True)
        model = GPTModel(cfg, device="cpu")
        model.load_params(init_gpt_params(cfg, 0, device="cpu"))
        losses.append(model(tokens, labels=tokens))
    assert torch.equal(*losses)


def test_launcher_kills_ranks_that_outlive_the_deadline():
    with pytest.raises(RuntimeError, match="did not answer"):
        run_multiprocess(ranks.hang, 2, args=(60.0,), timeout=8.0,
                         num_threads=1)


def test_launcher_reports_a_rank_that_raises():
    with pytest.raises(RuntimeError, match="rank one fails on purpose"):
        run_multiprocess(ranks.fail_on_rank_one, 2, timeout=60.0,
                         num_threads=1)
