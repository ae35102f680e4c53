"""The port's pipeline (microbatch calculators, utils, p2p wrappers, the
rotation schedules) and its ring-overlapped collective matmul against the
JAX package.

One module-scoped fixture starts eight gloo CPU ranks
(``start_multiprocess``, ``torch.set_num_threads(1)``, a deadline), which
run every rank-side check of ``torch_pipeline_ranks.pipeline_checks`` on
the grids each needs (pp2, pp2 x vpp2, pp4; tp2, tp4; dp filling the
rest), while this process computes the JAX side on the eight-device CPU
mesh under ``shard_over``; rank ``r`` of the port holds what device ``r``
of the same mesh holds.  The file takes about 20 s on one worker.  The
calculators, the LM masks, the schedule arithmetic and
dropout replay under remat run in this process without the spawn.

Limits: every value and gradient within rtol 1e-5, with an absolute part
of 1e-5 of the tensor's largest magnitude (fp32 sums taken in another
order); remat, grouped remat and the flat schedule agree to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_pipeline_ranks as ranks
from apex_tpu import parallel as jparallel
from apex_tpu.amp import fp8 as jfp8
from apex_tpu.parallel import collectives as jcc
from apex_tpu.transformer import microbatches as jmb
from apex_tpu.transformer import tensor_parallel as jtp
from apex_tpu.transformer.pipeline_parallel import p2p_communication as jp2p
from apex_tpu.transformer.pipeline_parallel import schedules as jsched
from apex_tpu.transformer.pipeline_parallel import utils as jutils
from apex_tpu.transformer.tensor_parallel import overlap as jov
from apex_tpu_torch.parallel.launch import start_multiprocess
from apex_tpu_torch.transformer import microbatches as mb
from apex_tpu_torch.transformer import pipeline_parallel as pl
from apex_tpu_torch.transformer.pipeline_parallel import schedules
from apex_tpu_torch.transformer.pipeline_parallel import utils
from torch_threads import one_torch_thread  # noqa: F401

WORLD, H, B, M = 8, 4, 2, 4
CASES = {"pp2_vpp1": (2, 1), "pp2_vpp2": (2, 2), "pp4_vpp1": (4, 1)}
LOSS_SCALE = 8.0


def _inputs():
    rng = np.random.default_rng(0)

    def f(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    inputs = {"pipeline": {}}
    for name, (pp, vpp) in CASES.items():
        inputs["pipeline"][name] = {
            "pp": pp, "vpp": vpp, "w": f(pp * vpp, H, H, scale=0.5),
            "b": f(pp * vpp, H, scale=0.1), "x": f(M, B, H), "z": f(M, B),
            "gy": f(M, B, H), "gz": f(M, B)}
    inputs["schedules"] = {"w": f(4, H, H, scale=0.5), "b": f(4, H),
                           "x": f(M, B, H), "target": f(M, B, H),
                           "loss_scale": LOSS_SCALE}
    inputs["p2p"] = {"x": f(2, 4, 2, 3), "g": f(2, 4, 2, 3),
                     "ids": rng.integers(0, 100, (2, 4, 3)).astype(np.int64)}
    inputs["overlap"] = {}
    for size in (2, 4):
        dp = WORLD // size
        inputs["overlap"][size] = {
            "gather": {"x": f(dp, 8, 2, 4), "w": f(8, 4), "g": f(dp, 8, 2, 8)},
            "scatter": {"x": f(dp, 8, 2, 8), "w": f(4, 8),
                        "g": f(dp, 8, 2, 4)}}
    inputs["fp8_metas"] = {
        "x": {"history": np.abs(f(16)) + 1.0, "scale": np.float32(4.0)},
        "w": {"history": np.abs(f(16)) + 1.0, "scale": np.float32(16.0)}}
    inputs["column_row"] = {"x": f(4, 8, 2, 4), "g": f(4, 8, 2, 4),
                            "w1": f(8, 4), "b1": f(8), "w2": f(4, 8),
                            "b2": f(4)}
    return inputs


def _jstage(p, xa):
    x, z = xa
    y = jnp.tanh(x @ p["w"] + p["b"])
    return y, z + y.mean(-1)


def _jfb_stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _jfb_whole(p, x):
    for layer in range(p["w"].shape[0]):
        x = jnp.tanh(x @ p["w"][layer] + p["b"][layer])
    return x


def _jfb_loss(out, target):
    return jnp.mean((out - target) ** 2)


def _grid(**kw):
    return jparallel.initialize_model_parallel(**kw)


def _jax_pipeline(c):
    pp, vpp = c["pp"], c["vpp"]
    mesh = _grid(pipeline_model_parallel_size=pp,
                 virtual_pipeline_model_parallel_size=vpp if vpp > 1
                 else None)
    try:
        def f(params, x, z):
            y, zo = jsched.pipeline_apply(_jstage, params, (x, z),
                                          num_chunks=vpp, mesh=mesh)
            return jnp.sum(y * c["gy"]) + jnp.sum(zo * c["gz"]), (y, zo)

        (_, (y, zo)), (dp_, dx, dz) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1, 2), has_aux=True))(
            {"w": c["w"], "b": c["b"]}, c["x"], c["z"])
        return {"y": y, "z": zo, "dw": dp_["w"], "db": dp_["b"], "dx": dx,
                "dz": dz}
    finally:
        jparallel.destroy_model_parallel()


def _jax_schedules(c):
    _grid(pipeline_model_parallel_size=2,
          virtual_pipeline_model_parallel_size=2)
    try:
        out = {}
        for name, (vpp, pp, stage, n) in {
                "no_pipelining": (None, 1, _jfb_whole, 4),
                "without_interleaving": (None, 2, _jfb_stage, 2),
                "with_interleaving": (2, 2, _jfb_stage, 4)}.items():
            fn = jsched.get_forward_backward_func(vpp, pp)
            params = {"w": c["w"][:n], "b": c["b"][:n]}
            out[name] = jax.jit(lambda p, x, t, fn=fn, stage=stage: fn(
                stage, _jfb_loss, p, x, t, loss_scale=LOSS_SCALE))(
                params, c["x"], c["target"])
        return out
    finally:
        jparallel.destroy_model_parallel()


def _jax_p2p(c):
    _grid(pipeline_model_parallel_size=4)
    try:
        spec = P("dp", "pp")

        def per(x, ids, g):
            tree = {"a": x[0, 0], "ids": ids[0, 0]}
            outs = {}
            for ring in (False, True):
                for name in ranks.P2P:
                    outs[f"{name}/{ring}"] = getattr(jp2p, name)(
                        tree, ring=ring)
                for name in ranks.P2P_PAIRS:
                    outs[f"{name}/{ring}"] = getattr(jp2p, name)(
                        x[0, 0], g[0, 0], ring=ring)
            return jax.tree_util.tree_map(lambda v: v[None, None], outs)

        vals = jax.jit(jcc.shard_over(per, in_specs=(spec, spec, spec),
                                      out_specs=spec))(
            c["x"], c["ids"], c["g"])
        grads = {}
        for ring in (False, True):
            def loss(x, ring=ring):
                def local(x, g):
                    y = jp2p.send_forward_recv_forward(x[0, 0], ring=ring)
                    return jcc.all_reduce(jnp.sum(y * g[0, 0]),
                                          ("dp", "pp"))[None]
                return jcc.shard_over(local, in_specs=(spec, spec),
                                      out_specs=P(None))(x, c["g"])[0]
            grads[ring] = jax.jit(jax.grad(loss))(c["x"])
        return vals, grads
    finally:
        jparallel.destroy_model_parallel()


def _jax_overlap(c, size, metas=None):
    _grid(tensor_model_parallel_size=size)
    try:
        def per(xg, wg, gg, xs, ws, gs):
            yg = jov.gather_matmul(xg[0], wg, "tp", fp8_metas=metas)
            ys = jov.matmul_scatter(xs[0], ws, "tp", fp8_metas=metas)
            loss = jnp.sum(yg * gg[0]) + jnp.sum(ys * gs[0])
            return (jcc.all_reduce(loss, ("dp", "tp"))[None], yg[None],
                    ys[None])

        last = P("dp", None, None, "tp")
        f = jcc.shard_over(
            per, in_specs=(P("dp", "tp"), P("tp", None), last, last,
                           P(None, "tp"), P("dp", "tp")),
            out_specs=(P(None), last, P("dp", "tp")))
        g, s = c["gather"], c["scatter"]

        def total(xg, wg, xs, ws):
            t, yg, ys = f(xg, wg, g["g"], xs, ws, s["g"])
            return t[0], (yg, ys)

        (_, (yg, ys)), grads = jax.jit(jax.value_and_grad(
            total, argnums=(0, 1, 2, 3), has_aux=True))(
            g["x"], g["w"], s["x"], s["w"])
        return {"gather": {"y": yg, "dx": grads[0], "dw": grads[1]},
                "scatter": {"y": ys, "dx": grads[2], "dw": grads[3]}}
    finally:
        jparallel.destroy_model_parallel()


def _jax_overlap_layers(c):
    _grid(tensor_model_parallel_size=2)
    try:
        kw = dict(sequence_parallel=True, axis="tp", overlap_comm=True)
        col = jtp.ColumnParallelLinear(input_size=4, output_size=8, **kw)
        row = jtp.RowParallelLinear(input_size=8, output_size=4, **kw)

        def per(params, x, g):
            h = col.apply({"params": {"kernel": params["w1"],
                                      "bias": params["b1"]}}, x[0])
            y = row.apply({"params": {"kernel": params["w2"],
                                      "bias": params["b2"]}}, jnp.tanh(h))
            loss = jcc.all_reduce(jnp.sum(y * g[0]), ("dp", "tp"))
            return loss[None], y[None]

        specs = {"w1": P("tp", None), "b1": P("tp"), "w2": P(None, "tp"),
                 "b2": P()}
        xs = P("dp", "tp")
        f = jcc.shard_over(per, in_specs=(specs, xs, xs),
                           out_specs=(P(None), xs))

        def total(params, x):
            t, y = f(params, x, c["g"])
            return t[0], y

        (_, y), (dparams, dx) = jax.jit(jax.value_and_grad(
            total, argnums=(0, 1), has_aux=True))(
            {k: c[k] for k in specs}, c["x"])
        return y, dparams, dx
    finally:
        jparallel.destroy_model_parallel()


@pytest.fixture(scope="module")
def run():
    """The eight ranks' results and the JAX side, computed while the ranks
    run."""
    inputs = _inputs()
    job = start_multiprocess(ranks.pipeline_checks, WORLD, args=(inputs,),
                             timeout=240.0, num_threads=1)
    metas = {k: jfp8.Fp8Meta(jnp.asarray(m["history"]),
                             jnp.asarray(m["scale"]))
             for k, m in inputs["fp8_metas"].items()}
    want = {
        "pipeline": {n: _jax_pipeline(c)
                     for n, c in inputs["pipeline"].items()},
        "schedules": _jax_schedules(inputs["schedules"]),
        "p2p": _jax_p2p(inputs["p2p"]),
        "overlap": {s: _jax_overlap(inputs["overlap"][s], s)
                    for s in (2, 4)},
        "overlap/fp8": _jax_overlap(inputs["overlap"][2], 2, metas),
        "overlap_layers": _jax_overlap_layers(inputs["column_row"]),
    }
    return inputs, job.join(), jax.tree_util.tree_map(np.asarray, want)


def _close(got, want, tol=1e-5, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-30), err_msg=what)


@pytest.mark.parametrize("variant", list(ranks.VARIANTS))
@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_apply_matches_jax(run, case, variant):
    """Outputs (the two-leaf pytree) and the gradients of the stacked
    parameters and of the inputs, on every rank, against JAX's
    ``pipeline_apply`` under ``shard_over`` (flat, remat, grouped remat
    by period and by 3 ticks, local parameters, sharded microbatches)."""
    _, results, want = run
    jw = want["pipeline"][case]
    for r, res in enumerate(results):
        got = res[f"pipeline/{case}/{variant}"]
        for k in ("y", "z", "dw", "db", "dx", "dz"):
            _close(got[k], jw[k], what=f"rank {r} {k}")


@pytest.mark.parametrize("variant", ["no_remat", "remat_ticks",
                                     "remat_ticks3"])
@pytest.mark.parametrize("case", list(CASES))
def test_remat_variants_equal_the_flat_schedule(run, case, variant):
    _, results, _ = run
    for res in results:
        flat = res[f"pipeline/{case}/flat"]
        got = res[f"pipeline/{case}/{variant}"]
        for k in ("y", "z", "dw", "db", "dx", "dz"):
            _close(got[k], flat[k], tol=1e-6)


@pytest.mark.parametrize("case", list(CASES))
def test_rotation_is_one_batched_permute_per_tick(run, case):
    """Each tick shifts its whole pytree in one call, forward; the backward
    sends every consumed shift back once, and grouped remat re-runs each
    group's shifts once more; every rank issues the same number (else
    they would have deadlocked)."""
    _, results, _ = run
    pp, vpp = CASES[case]
    ticks = schedules.pipeline_total_ticks(M, pp, vpp)
    want = {"flat": (ticks, ticks - 1), "no_remat": (ticks, ticks - 1),
            "remat_ticks": (ticks, 2 * ticks - 1),
            "remat_ticks3": (ticks, 2 * ticks - 1),
            "local": (ticks, ticks - 1), "shard": (ticks, ticks - 1)}
    for res in results:
        for variant, calls in want.items():
            assert tuple(res[f"pipeline/{case}/{variant}"]["ppermute"]) \
                == calls, variant


@pytest.mark.parametrize("name", ["no_pipelining", "without_interleaving",
                                  "with_interleaving"])
def test_forward_backward_schedules_match_jax(run, name):
    """The three schedules through ``get_forward_backward_func``: the
    per-microbatch losses and the gradients of ``loss * loss_scale``,
    summed over microbatches, of the whole stack on every rank."""
    _, results, want = run
    jl, jg = want["schedules"][name]
    for res in results:
        got = res["schedules"][name]
        _close(got["losses"], jl)
        for k in ("w", "b"):
            _close(got["grads"][k], jg[k])


def test_get_forward_backward_func_dispatches_like_jax():
    for vpp, pp in ((None, 1), (None, 2), (2, 2), (3, 4)):
        got = pl.get_forward_backward_func(vpp, pp)
        ref = jsched.get_forward_backward_func(vpp, pp)
        name = getattr(got, "func", got).__name__
        assert name == getattr(ref, "func", ref).__name__
        assert getattr(got, "keywords", {}) == getattr(ref, "keywords", {})
    with pytest.raises(ValueError, match="num_chunks >= 2"):
        pl.forward_backward_pipelining_with_interleaving(
            None, None, {}, None, None, num_chunks=1)


@pytest.mark.parametrize("name", ranks.P2P + ranks.P2P_PAIRS)
def test_p2p_wrappers_match_jax(run, name):
    """At pp = 4 (dp = 2): every wrapper with and without ``ring``, the
    edges receiving zeros (integer leaves too), against JAX's."""
    _, results, want = run
    vals = want["p2p"][0]
    for r, res in enumerate(results):
        d, s = divmod(r, 4)
        for ring in (False, True):
            key = f"{name}/{ring}"
            got = jax.tree_util.tree_leaves(res["p2p"][key])
            ref = jax.tree_util.tree_leaves(
                jax.tree_util.tree_map(lambda v: v[d, s], vals[key]))
            assert len(got) == len(ref)
            for a, b in zip(got, ref):
                np.testing.assert_array_equal(a, b)


def test_p2p_edges_receive_zeros_and_the_ring_wraps(run):
    inputs, results, _ = run
    x = inputs["p2p"]["x"]
    for r, res in enumerate(results):
        d, s = divmod(r, 4)
        plain = res["p2p"]["send_forward_recv_forward/False"]["a"]
        ring = res["p2p"]["send_forward_recv_forward/True"]["a"]
        np.testing.assert_array_equal(ring, x[d, (s - 1) % 4])
        np.testing.assert_array_equal(
            plain, np.zeros_like(plain) if s == 0 else x[d, s - 1])


def test_p2p_gradient_is_the_inverse_shift(run):
    """The backward of a shift sends the gradient back along the inverse
    pairs, as JAX's transpose of ``ppermute``."""
    _, results, want = run
    grads = want["p2p"][1]
    for r, res in enumerate(results):
        d, s = divmod(r, 4)
        for ring in (False, True):
            np.testing.assert_array_equal(res["p2p"][f"grad/{ring}"],
                                          grads[ring][d, s])


def _overlap_check(results, want, key, size, tol=1e-5):
    dp = WORLD // size
    for name in ("gather", "scatter"):
        w = want[name]
        dw = np.zeros_like(w["dw"])
        for r, res in enumerate(results):
            d, t = divmod(r, size)
            got = res[key][name]
            k = got["dx"].shape
            if name == "gather":
                sl, ol = k[0], got["y"].shape[-1]
                _close(got["y"], w["y"][d, ..., t * ol:(t + 1) * ol], tol)
                _close(got["dx"], w["dx"][d, t * sl:(t + 1) * sl], tol)
                dw[t * ol:(t + 1) * ol] += got["dw"]
            else:
                sl, il = got["y"].shape[0], k[-1]
                _close(got["y"], w["y"][d, t * sl:(t + 1) * sl], tol)
                _close(got["dx"], w["dx"][d, ..., t * il:(t + 1) * il], tol)
                dw[:, t * il:(t + 1) * il] += got["dw"]
            hops = size - 1
            calls = got["calls"]
            assert calls["ppermute"] == (3 if name == "gather" else 2) * hops
            assert calls["all_gather"] == calls["reduce_scatter"] == 0
        assert dp * size == WORLD
        _close(dw, w["dw"], tol)


@pytest.mark.parametrize("size", [2, 4])
def test_overlap_rings_match_jax(run, size):
    """``gather_matmul`` and ``matmul_scatter`` at tp = 2 and 4: output,
    dx and dw (summed over the data-parallel replicas, as JAX's replicated
    weight gradient is) against the JAX rings; only ring hops, tp - 1 per
    ring (the gather's backward runs two rings, the scatter's one)."""
    _, results, want = run
    _overlap_check(results, want["overlap"][size], f"overlap/{size}", size)


def test_overlap_fp8_route_first_step_matches_jax(run):
    """The rings through the fp8 GEMM (e4m3 operands, an e5m2 cotangent
    scaled per chunk) at tp = 2: forward and gradients against JAX's."""
    _, results, want = run
    _overlap_check(results, want["overlap/fp8"], "overlap/fp8", 2)


def test_overlap_comm_layers_match_jax(run):
    """``ColumnParallelLinear`` then ``RowParallelLinear`` with sequence
    parallelism and ``overlap_comm`` at tp = 2 against JAX's layers: the
    output, dx and every weight gradient; the rings replaced the
    all-gathers and reduce-scatters."""
    inputs, results, want = run
    y, dparams, dx = want["overlap_layers"]
    for r, res in enumerate(results):
        d, t = divmod(r, 2)
        got = res["overlap_layers"]
        _close(got["y"], y[d, t * 4:(t + 1) * 4])
        _close(got["dx"], dx[d, t * 4:(t + 1) * 4])
        _close(got["w1"], dparams["w1"][t * 4:(t + 1) * 4])
        _close(got["b1"], dparams["b1"][t * 4:(t + 1) * 4])
        _close(got["w2"], dparams["w2"][:, t * 4:(t + 1) * 4])
        _close(got["b2"], dparams["b2"])
        assert got["calls"]["all_gather"] == 0
        assert got["calls"]["reduce_scatter"] == 0
        assert got["calls"]["ppermute"] == 3 + 2


# ------------------------------------------- no spawn: host arithmetic


@pytest.mark.parametrize("m,pp,vpp", [(4, 2, 1), (4, 2, 2), (4, 4, 1),
                                      (8, 4, 2), (3, 2, 3), (1, 1, 1)])
def test_schedule_arithmetic_matches_jax(m, pp, vpp):
    assert schedules.pipeline_total_ticks(m, pp, vpp) == \
        jsched.pipeline_total_ticks(m, pp, vpp)
    assert schedules.pipeline_bubble_fraction(m, pp, vpp) == \
        jsched.pipeline_bubble_fraction(m, pp, vpp)
    np.testing.assert_array_equal(schedules._entry_ticks(m, pp, vpp),
                                  jsched._entry_ticks(m, pp, vpp))
    ticks = schedules.pipeline_total_ticks(m, pp, vpp)
    for a, b in zip(schedules._exit_schedule(ticks, pp * vpp, pp, m),
                    jsched._exit_schedule(ticks, pp * vpp, pp, m)):
        np.testing.assert_array_equal(a, b)


def test_microbatch_calculators_match_jax():
    for args in ((16, 2, 2), (12, 3, 1)):
        a, b = (mb.ConstantNumMicroBatches(*args),
                jmb.ConstantNumMicroBatches(*args))
        assert (a.get(), a.get_current_global_batch_size()) == \
            (b.get(), b.get_current_global_batch_size())
    with pytest.raises(ValueError):
        mb.ConstantNumMicroBatches(15, 2, 2)
    for ramp in ([4, 4, 100], [4, 2, 0], [16, 4, 50]):
        a = mb.build_num_microbatches_calculator(0, ramp, 16, 2, 2)
        b = jmb.build_num_microbatches_calculator(0, ramp, 16, 2, 2)
        for consumed in range(0, 160, 7):
            a.update(consumed, False)
            b.update(consumed, False)
            assert (a.get(), a.get_current_global_batch_size()) == \
                (b.get(), b.get_current_global_batch_size())
    with pytest.raises(ValueError, match="expected the following format"):
        mb.build_num_microbatches_calculator(0, [4, 4], 16, 2, 2)


def test_global_calculator_accessors():
    utils.setup_microbatch_calculator(0, [4, 4, 100], 16, 2, 2)
    try:
        with pytest.raises(RuntimeError, match="already initialized"):
            utils.setup_microbatch_calculator(0, None, 16, 2, 2)
        assert (utils.get_num_microbatches(),
                utils.get_current_global_batch_size()) == (1, 4)
        utils.update_num_microbatches(60)        # one 33.3-sample step
        assert (utils.get_num_microbatches(),
                utils.get_current_global_batch_size()) == (2, 8)
    finally:
        utils._destroy_microbatch_calculator()


@pytest.mark.parametrize("reset_pos,reset_att,eod_mask", [
    (False, False, False), (True, False, True), (False, True, False),
    (True, True, True)])
def test_ltor_masks_and_position_ids_match_jax(reset_pos, reset_att,
                                               eod_mask):
    data = np.random.default_rng(3).integers(0, 6, (3, 11))
    data[0, 4] = data[1, 0] = data[2, 10] = 5
    kw = dict(eod_token=5, reset_position_ids=reset_pos,
              reset_attention_mask=reset_att, eod_mask_loss=eod_mask)
    got = utils.get_ltor_masks_and_position_ids(torch.from_numpy(data), **kw)
    want = jutils.get_ltor_masks_and_position_ids(jnp.asarray(data), **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.shape == b.shape


def test_loss_average_and_params_norm_match_jax():
    rng = np.random.default_rng(4)
    losses = [rng.standard_normal((3,)).astype(np.float32) for _ in range(4)]
    np.testing.assert_allclose(
        utils.average_losses_across_data_parallel_group(
            [torch.from_numpy(l) for l in losses]).numpy(),
        np.asarray(jutils.average_losses_across_data_parallel_group(
            [jnp.asarray(l) for l in losses])), rtol=1e-6)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": {"c": rng.standard_normal((5,)).astype(np.float32)}}
    tparams = {"a": torch.from_numpy(params["a"]),
               "b": {"c": torch.from_numpy(params["b"]["c"])}}
    np.testing.assert_allclose(float(utils.calc_params_l2_norm(tparams)),
                               float(jutils.calc_params_l2_norm(params)),
                               rtol=1e-6)
    per = utils.calc_params_l2_norm(tparams, per_tensor=True)
    jper = jutils.calc_params_l2_norm(params, per_tensor=True)
    np.testing.assert_allclose(float(per["b"]["c"]), float(jper["b"]["c"]),
                               rtol=1e-6)
    assert utils.report_memory("cpu") == ""


@pytest.mark.parametrize("kw", [{}, {"remat_ticks": True}],
                         ids=["remat", "remat_ticks"])
def test_dropout_replays_under_remat(kw):
    """A stage drawing dropout from the tracker's model-parallel stream:
    the recomputation in the backward draws the same masks, so outputs
    and gradients equal the run without remat bit for bit, and the stream
    ends where it did."""
    from apex_tpu_torch.transformer.tensor_parallel import random as tpr

    def stage(p, x):
        y = torch.tanh(x @ p)
        keep = torch.rand(y.shape, generator=tpr.get_rng_states_tracker()
                          .fork()) < 0.7
        return torch.where(keep, y / 0.7, torch.zeros_like(y))

    w0 = torch.randn(4, 3, 3, generator=torch.Generator().manual_seed(0))
    x = torch.randn(5, 2, 3, generator=torch.Generator().manual_seed(1))
    outs = []
    for opts in ({"remat": False}, kw):
        tpr.model_parallel_seed(11)
        w = w0.clone().requires_grad_(True)
        y = pl.pipeline_apply(stage, w, x, num_chunks=4, **opts)
        y.square().sum().backward()
        outs.append((y.detach(), w.grad,
                     tpr.get_rng_states_tracker().fork().get_state()))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
