"""The port's training statistics (``apex_tpu_torch.observability.
trainstats``) and ``build_gpt_3d(collect_stats=True)`` against the JAX
package's.

Every function of the module runs on the same numpy gradients and
parameters (one leaf NaN in one case) through both packages; the values
agree within fp32 rounding (rtol 1e-6), the counts exactly, and
``TrainStatsLogger`` logs at the reference's ``every_n`` steps with the
same flattened records.  ``device_partial_norms`` is held by its
contract: the rows of every rank of a simulated dp 2 x tp 2 grid sum to
the global sums of squares.

The ZeRO step (``zero_data_parallel_train_step(collect_stats=True)``, the
reference's ``test_observability.py`` setup) on the same four ranks at
dp 4: the bare step's collectives and bits, with and without the
sentinel, and its stats against the JAX package's on a dp 4 mesh; on a
NaN batch the stats count the poisoned leaves and the skip.

The 3D step: JAX's ``build_gpt_3d`` with ``collect_stats=True`` on an
eight-device dp mesh (two layers, hidden 32; its jitted plain and
sentinel steps), against the port's at one rank on the same global
batch and weights, two FusedAdam steps each: the losses within 1e-5,
the finalized stats within 1e-4 (grad norm) and 1e-5 (the rest), the
counts and scales exactly.  The port's bare and instrumented steps are
bit for bit the same, in one process and on four gloo ranks (dp 2 x tp 2
with sequence parallelism, dense and Switch MoE), where the instrumented
step makes the bare step's collectives (``collectives.CALLS``, the
port's form of the reference's HLO collective count) and its gathered
stats are the one-rank step's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import torch_trainstats_ranks as ranks
from apex_tpu import parallel as jparallel
from apex_tpu.amp.scaler import DynamicLossScale as JaxScale
from apex_tpu.observability import trainstats as jts
from apex_tpu.observability.metrics import MetricRegistry as JaxRegistry
from apex_tpu.optimizers import FusedAdam as JaxAdam
from apex_tpu.resilience import sentinel_init as j_sentinel_init
from apex_tpu.transformer.testing import TransformerConfig as JaxConfig
from apex_tpu.transformer.testing.gpt_parallel_train import (
    build_gpt_3d as j_build_gpt_3d,
)
from apex_tpu_torch.amp._tree import tree_leaves
from apex_tpu_torch.amp.scaler import DynamicLossScale
from apex_tpu_torch.observability import MetricRegistry
from apex_tpu_torch.observability import trainstats as ts
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.parallel.launch import run_multiprocess
from apex_tpu_torch.resilience.sentinel import sentinel_init
from apex_tpu_torch.testing import l1
from apex_tpu_torch.transformer.tensor_parallel import PartitionSpec
from apex_tpu_torch.transformer.testing.gpt_parallel_train import (
    GPT3DParams,
    build_gpt_3d,
)
from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
    TransformerConfig,
)

RTOL = 1e-6


def _grads(nan=False):
    rng = np.random.RandomState(0)
    tree = {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": {"c": rng.standard_normal((5,)).astype(np.float32),
                  "d": rng.standard_normal((2, 2)).astype(np.float32)},
            "e": np.arange(3, dtype=np.int32)}
    if nan:
        tree["b"]["c"][2] = np.nan
    return tree


def _torch(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _close(got, want, rtol=RTOL):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


def _same_stats(got, want, rtol=RTOL):
    assert type(got).__name__ == type(want).__name__
    assert got._fields == want._fields
    for name, a, b in zip(want._fields, got, want):
        if b is None:
            assert a is None, name
        else:
            _close(a, b, rtol)


@pytest.mark.parametrize("nan", [False, True])
def test_local_grad_stats_and_train_stats_match_jax(nan):
    g, p = _grads(nan), _grads()
    for a, b in zip(ts.local_grad_stats(_torch(g)),
                    jts.local_grad_stats(_jnp(g))):
        _close(a, b)
    kw = dict(grad_scale=8.0, loss_scale=8.0, skipped_steps=3,
              moe_aux=np.array([0.5, 0.25], np.float32))
    _same_stats(ts.train_stats(1.5, _torch(g), _torch(p),
                               **dict(kw, moe_aux=torch.tensor(
                                   kw["moe_aux"]))),
                jts.train_stats(1.5, _jnp(g), _jnp(p),
                                **dict(kw, moe_aux=jnp.asarray(
                                    kw["moe_aux"]))))
    _same_stats(ts.train_stats(torch.tensor(2.0), _torch(g), _torch(p)),
                jts.train_stats(jnp.float32(2.0), _jnp(g), _jnp(p)))
    empty = ts.local_grad_stats({"i": torch.arange(3)})
    assert float(empty[0]) == 0 and int(empty[1]) == 0


def test_pack_and_reduce_match_jax():
    g1, g2, p = _grads(), _grads(nan=True), _grads()
    t = ts.pack_local_stats(1.25, _torch(g1)) + ts.pack_local_stats(
        torch.tensor(0.75), _torch(g2))
    j = jts.pack_local_stats(1.25, _jnp(g1)) + jts.pack_local_stats(
        jnp.float32(0.75), _jnp(g2))
    assert t.shape == (ts.PACK_LEN,)
    _close(t, j)
    tl, tstats = ts.stats_from_reduced(t, 2, _torch(p), grad_scale=4.0,
                                       loss_scale=4.0, skipped_steps=1)
    jl, jstats = jts.stats_from_reduced(j, 2, _jnp(p), grad_scale=4.0,
                                        loss_scale=4.0, skipped_steps=1)
    _close(tl, jl)
    _same_stats(tstats, jstats)


def test_partial_stats_finalize_and_specs_match_jax():
    parts = np.random.RandomState(1).rand(4, 5).astype(np.float32)
    parts[:, 2:] = [[0, 1, 0], [0, 0, 0], [0, 1, 1], [0, 0, 0]]
    kw = dict(grad_scale=2.0, loss_scale=2.0, skipped_steps=2)
    t = ts.partial_train_stats(torch.tensor(0.5), torch.from_numpy(parts),
                               moe_aux=torch.tensor([1.0, 2.0]), **kw)
    j = jts.partial_train_stats(jnp.float32(0.5), jnp.asarray(parts),
                                moe_aux=jnp.asarray([1.0, 2.0]), **kw)
    _same_stats(t.finalize(), jax.device_get(j).finalize())
    assert t.gathered() is t       # no process group: this rank's rows
    for moe in (False, True):
        got, want = (ts.stats_partition_specs(moe_aux=moe),
                     jts.stats_partition_specs(moe_aux=moe))
        assert [tuple(x) if x is not None else None for x in got] == \
            [tuple(x) if x is not None else None for x in want]


class _Mesh:
    shape = {"dcn": 1, "dp": 2, "pp": 1, "cp": 1, "tp": 2}


def test_device_partial_norms_rows_sum_to_the_global_norms():
    """A simulated dp 2 x tp 2 grid: leaf ``w`` split over tp (two
    shards), ``e`` over dp and tp (four), ``b`` replicated; each rank's
    row weighs its leaves by 1/replication, so the rows' sum is the
    global sum of squares, and a NaN in one shard flags its leaf."""
    rng = np.random.RandomState(3)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    e = rng.standard_normal((4, 2)).astype(np.float32)
    b = rng.standard_normal((3,)).astype(np.float32)
    specs = {"w": PartitionSpec(None, "tp"), "e": PartitionSpec(("dp", "tp")),
             "b": PartitionSpec()}
    fn = ts.device_partial_norms(_Mesh(), specs)
    rows = []
    for d in range(2):
        for t in range(2):
            local = {"w": torch.from_numpy(w[:, 3 * t:3 * t + 3]),
                     "e": torch.from_numpy(e[2 * d + t:2 * d + t + 1]),
                     "b": torch.from_numpy(b)}
            grads = {k: 2 * v for k, v in local.items()}
            if (d, t) == (1, 0):
                grads["w"] = grads["w"].clone()
                grads["w"][0, 0] = float("nan")
            rows.append(fn(grads, local))
    parts = torch.cat(rows)
    assert parts.shape == (4, 5)
    want = sum(float((x.astype(np.float64) ** 2).sum()) for x in (w, e, b))
    np.testing.assert_allclose(float(parts[:, 1].sum()), want, rtol=1e-6)
    stats = ts.partial_train_stats(torch.tensor(0.0), parts).finalize()
    np.testing.assert_allclose(stats.param_norm, np.sqrt(want), rtol=1e-6)
    assert int(stats.nonfinite_leaves) == 1  # leaf order b, e, w
    assert parts[:, 4].tolist() == [0.0, 0.0, 1.0, 0.0]


def test_logger_cadence_and_records_match_jax(tmp_path):
    from apex_tpu.observability.writers import JsonlWriter as JaxWriter
    from apex_tpu_torch.observability import JsonlWriter, read_jsonl

    treg, jreg = MetricRegistry(rank=0, world=1), JaxRegistry(rank=0,
                                                              world=1)
    tlog = ts.TrainStatsLogger(treg, every_n=3,
                               writer=JsonlWriter(str(tmp_path / "t.jsonl")))
    jlog = jts.TrainStatsLogger(jreg, every_n=3,
                                writer=JaxWriter(str(tmp_path / "j.jsonl")))
    g, p = _grads(), _grads()
    parts = np.random.RandomState(2).rand(2, 6).astype(np.float32)
    parts[:, 2:] = 0.0
    for step in range(8):
        if step % 2:
            t = ts.train_stats(step * 0.5, _torch(g), _torch(p),
                               moe_aux=torch.tensor([0.1, 0.3]))
            j = jts.train_stats(step * 0.5, _jnp(g), _jnp(p),
                                moe_aux=jnp.asarray([0.1, 0.3]))
        else:
            t = ts.partial_train_stats(torch.tensor(step * 0.5),
                                       torch.from_numpy(parts))
            j = jts.partial_train_stats(jnp.float32(step * 0.5),
                                        jnp.asarray(parts))
        a = tlog.maybe_log(step, t, extra={"lr": 0.1})
        b = jlog.maybe_log(step, j, extra={"lr": 0.1})
        assert (a is None) == (b is None) == bool(step % 3)
        if a is not None:
            assert a.keys() == b.keys()
            np.testing.assert_allclose([np.asarray(v, float).sum()
                                        for v in a.values()],
                                       [np.asarray(v, float).sum()
                                        for v in b.values()], rtol=RTOL)
    with pytest.raises(ValueError):
        ts.TrainStatsLogger(treg, every_n=0)
    tsnap, jsnap = treg.snapshot(), jreg.snapshot()
    assert tsnap.keys() == jsnap.keys()
    assert tsnap["train/logged_steps"] == jsnap["train/logged_steps"] == 3
    np.testing.assert_allclose(tsnap["train/moe_aux_mean"],
                               jsnap["train/moe_aux_mean"], rtol=RTOL)
    assert [r["step"] for r in read_jsonl(str(tmp_path / "t.jsonl"))] == \
        [0, 3, 6]


# ------------------------------------------------------ the 3D GPT step

LAYERS, M = 2, 2
TOKENS = np.random.RandomState(5).randint(0, 64, (16, 16)).astype(np.int64)


def _config(**kw):
    return dict(l1.GPT_3D, num_layers=LAYERS, tensor_axis=None,
                sequence_parallel=False, **kw)


def _jax_steps():
    """JAX's plain and sentinel collect-stats steps on an eight-device dp
    mesh: the initial weights (numpy) and each step's ``(loss, finalized
    stats)`` over two FusedAdam steps."""
    mesh = jparallel.initialize_model_parallel()
    try:
        init_fn, _, make_train_step = j_build_gpt_3d(
            JaxConfig(**_config()), num_chunks=LAYERS, num_microbatches=M,
            mesh=mesh)
        tokens = jnp.asarray(TOKENS.astype(np.int32))
        held = {}

        def init(k, t):
            p, held["specs"] = init_fn(k, t)
            return p

        with jax.threefry_partitionable(False):
            params = jax.jit(init)(jax.random.PRNGKey(0), tokens)
        # replicated over the mesh, as the step returns them: with the
        # first call's inputs on one device the step compiles twice
        rep = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
        params = jax.device_put(params, rep)
        opt = JaxAdam(lr=1e-3)
        out = {"params": jax.tree_util.tree_map(np.asarray, params)}
        scaler = JaxScale(init_scale=2.0 ** 8)
        for name in ("plain", "sentinel"):
            step = jax.jit(make_train_step(
                opt, held["specs"], scaler=scaler if name == "sentinel"
                else None, collect_stats=True))
            p, state = params, jax.device_put(opt.init(params), rep)
            sent = jax.device_put(j_sentinel_init(scaler), rep)
            rows = []
            for _ in range(2):
                if name == "plain":
                    p, state, loss, stats = step(p, state, tokens)
                else:
                    p, state, sent, loss, stats = step(p, state, tokens,
                                                       sent)
                rows.append((float(loss), jax.device_get(stats).finalize()))
            out[name] = rows
    finally:
        jparallel.destroy_model_parallel()
    out["zero"] = _jax_zero_stats()
    return out


def _jax_zero_stats():
    """The reference's ZeRO stats setup (``test_observability.py``'s
    ``_zero_setup``) on a dp 4 mesh: each instrumented step's stats (the
    plain step with two microbatches, the sentinel step, the sentinel
    step on a NaN batch) and the last one's parameters."""
    from apex_tpu.contrib.optimizers import DistributedFusedAdam as JZero
    from apex_tpu.parallel.distributed import (
        dp_shard_batch,
        replicate,
        zero_data_parallel_train_step,
        zero_init,
    )

    mesh = jparallel.initialize_model_parallel(devices=jax.devices()[:4])
    try:
        params = replicate({"w": jnp.ones((16, 8)), "b": jnp.zeros((8,))},
                           mesh)

        def loss_fn(p, batch):
            x, y = batch
            return jnp.mean((x @ p["w"] + p["b"] - y) ** 2)

        opt = JZero(lr=1e-3, flat_bucket=True)
        state = zero_init(opt, params, mesh)
        x = jnp.arange(16 * 16, dtype=jnp.float32).reshape(16, 16) / 100.0
        batch = dp_shard_batch((x, jnp.ones((16, 8))), mesh)
        scaler = JaxScale()
        sent = j_sentinel_init(scaler)
        plain = zero_data_parallel_train_step(
            loss_fn, opt, mesh=mesh, donate=False, microbatches=2,
            collect_stats=True)
        guarded = zero_data_parallel_train_step(
            loss_fn, opt, mesh=mesh, donate=False, scaler=scaler,
            collect_stats=True)
        nan_batch = jax.tree_util.tree_map(lambda t: jnp.full_like(t, jnp.nan),
                                           batch)
        out = {"plain": jax.device_get(plain(params, state, batch)[-1]),
               "scaler": jax.device_get(guarded(params, state, batch,
                                                sent)[-1])}
        p, _, _, _, stats = guarded(params, state, nan_batch, sent)
        out["poisoned"] = jax.device_get(stats)
        out["poisoned_params"] = jax.tree_util.tree_map(np.asarray, p)
        return out
    finally:
        jparallel.destroy_model_parallel()


def _port_run(params, name, collect=True, steps=2):
    init_fn, _, make_train_step = build_gpt_3d(
        TransformerConfig(**_config()), num_chunks=LAYERS,
        num_microbatches=M, device="cpu")
    local, specs = init_fn(params=params)
    opt = FusedAdam(tree_leaves(local), lr=1e-3)
    scaler = DynamicLossScale(init_scale=2.0 ** 8)
    step = make_train_step(opt, specs, scaler=scaler if name == "sentinel"
                           else None, collect_stats=collect)
    sent = sentinel_init(scaler, device="cpu")
    tokens = torch.from_numpy(TOKENS)
    rows = []
    for _ in range(steps):
        if name == "plain":
            res = step(local, tokens)
        else:
            sent, *res = step(local, tokens, sent)
            res = res if collect else res[0]
        rows.append(res)
    return rows, local, opt


@pytest.mark.parametrize("name", ["plain", "sentinel"])
def test_collect_stats_step_matches_jax_for_two_steps(jax_steps, name):
    rows, _, _ = _port_run(GPT3DParams(**jax_steps["params"]._asdict()),
                           name)
    for (loss, stats), (jloss, jstats) in zip(rows, jax_steps[name]):
        assert isinstance(stats, ts.PartialTrainStats)
        n_leaves = len(jax.tree_util.tree_leaves(jax_steps["params"]))
        assert stats.norm_partials.shape == (1, 2 + n_leaves)
        np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
        got = stats.finalize()
        for field in ("loss", "param_norm"):
            np.testing.assert_allclose(getattr(got, field),
                                       getattr(jstats, field), rtol=1e-5)
        np.testing.assert_allclose(got.grad_norm, jstats.grad_norm,
                                   rtol=1e-4)
        for field in ("nonfinite_leaves", "loss_scale", "skipped_steps"):
            assert getattr(got, field) == getattr(jstats, field), field
        np.testing.assert_array_equal(got.moe_aux, np.zeros(M, np.float32))
        np.testing.assert_array_equal(got.moe_aux, jstats.moe_aux)
    if name == "sentinel":
        assert rows[0][1].loss_scale == 2.0 ** 8


@pytest.mark.parametrize("name", ["plain", "sentinel"])
def test_collect_stats_leaves_the_training_bit_for_bit(jax_steps, name):
    params = GPT3DParams(**jax_steps["params"]._asdict())
    instr, p1, o1 = _port_run(params, name, collect=True, steps=3)
    bare, p2, o2 = _port_run(params, name, collect=False, steps=3)
    for a, b in zip(instr, bare):
        assert torch.equal(a[0], b)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        assert torch.equal(a, b)
    s1 = o1.opt_state(dict(enumerate(tree_leaves(p1))))
    s2 = o2.opt_state(dict(enumerate(tree_leaves(p2))))
    for a, b in zip(tree_leaves(s1), tree_leaves(s2)):
        assert a is b is None or torch.equal(torch.as_tensor(a),
                                             torch.as_tensor(b))


GRID = dict(tensor_model_parallel_size=2)
MOE = dict(num_experts=4, expert_axis="dp")


def _gloo_cases():
    cases = []
    for name, extra in (("dense", {}), ("moe", MOE)):
        config = dict(l1.GPT_3D, num_layers=LAYERS, **extra)
        init_fn, _, _ = build_gpt_3d(TransformerConfig(**dict(
            config, tensor_axis=None, sequence_parallel=False)),
            num_chunks=LAYERS, device="cpu")
        params, _ = init_fn(seed=7)
        params = GPT3DParams(*(jax.tree_util.tree_map(
            lambda t: t.detach().numpy(), part) for part in params))
        cases.append((name, config, params,
                      dict(num_chunks=LAYERS, num_microbatches=M)))
    return cases


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's plain and sentinel steps (``_jax_steps``)."""
    return _jax_steps()


@pytest.fixture(scope="module")
def gloo_runs():
    """Four gloo ranks (dp 2 x tp 2 + sp) run the bare and instrumented
    steps of a dense and a MoE config; then the one-rank instrumented
    dense step runs on the ranks' global batch."""
    cases = _gloo_cases()
    results = run_multiprocess(ranks.stats_cases, 4,
                               args=(cases, TOKENS, GRID), timeout=240.0,
                               num_threads=1)
    one, _, _ = _port_run(cases[0][2], "plain")
    return results, one


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_instrumented_step_on_gloo_ranks_adds_no_collective(gloo_runs,
                                                            name):
    results, _ = gloo_runs
    for r in results:
        res = r[name]
        assert res["same_params"] and res["same_state"]
        assert res["same_losses"]
        bare, instr = res["calls"]
        assert bare == instr, (bare, instr)
        assert bare[0]["all_reduce"] > 0
    fetched = [r[name]["stats"] for r in results]
    assert all(f == fetched[0] for f in fetched)
    for step in fetched[0]:
        assert np.isfinite(step["grad_norm"]) and step["param_norm"] > 0
        assert step["nonfinite_leaves"] == 0 and len(step["moe_aux"]) == M
        assert all(np.isfinite(step["moe_aux"]))
        if name == "dense":
            assert step["moe_aux"] == [0.0] * M
        else:
            assert min(step["moe_aux"]) > 0


def test_gathered_gloo_stats_are_the_one_rank_step(gloo_runs):
    """The dense instrumented step on four ranks, its partial rows
    gathered and finalized, against the same step at one rank on the
    whole batch."""
    results, one = gloo_runs
    for fetched, (loss, stats) in zip(results[0]["dense"]["stats"], one):
        want = stats.finalize()
        np.testing.assert_allclose(fetched["loss"], float(loss), rtol=1e-5)
        for field in ("loss", "param_norm"):
            np.testing.assert_allclose(fetched[field], getattr(want, field),
                                       rtol=1e-5)
        np.testing.assert_allclose(fetched["grad_norm"], want.grad_norm,
                                   rtol=1e-4)


# --------------------------------------------------------- the ZeRO step


@pytest.mark.parametrize("name", ["plain", "scaler", "poisoned"])
def test_zero_stats_ride_the_loss_reduction(gloo_runs, name):
    """The ZeRO step with ``collect_stats`` on four gloo ranks (dp 4) makes
    the bare step's collectives (the ZeRO exchange live) and leaves its
    parameters, shards, sentinel and loss bit for bit; with and without
    the scaler, and on a NaN batch."""
    results, _ = gloo_runs
    for r in results:
        res = r["zero"][name]
        assert res["same"]
        bare, instr = res["calls"]
        assert bare == instr, (bare, instr)
        assert bare["reduce_scatter"] > 0 and bare["all_gather"] > 0


@pytest.mark.parametrize("name", ["plain", "scaler"])
def test_zero_stats_match_jax(gloo_runs, jax_steps, name):
    results, _ = gloo_runs
    got = results[0]["zero"][name]["stats"]
    want = jax_steps["zero"][name]
    for field in ("loss", "grad_norm", "param_norm"):
        np.testing.assert_allclose(got[field], float(getattr(want, field)),
                                   rtol=1e-5, err_msg=field)
    for field in ("nonfinite_leaves", "loss_scale", "skipped_steps"):
        assert got[field] == float(getattr(want, field)) == (
            2.0 ** 16 if field == "loss_scale" and name == "scaler"
            else 1.0 if field == "loss_scale" else 0), field
    assert all(r["zero"][name]["stats"] == got for r in results)


def test_zero_stats_see_poisoned_grads(gloo_runs, jax_steps):
    """The sentinel step on a NaN batch: its stats count the non-finite
    leaves the sentinel acted on (JAX's count), one skipped step, and the
    parameters keep their bits."""
    results, _ = gloo_runs
    want = jax_steps["zero"]["poisoned"]
    for r in results:
        res = r["zero"]["poisoned"]
        assert res["stats"]["nonfinite_leaves"] == int(
            want.nonfinite_leaves) > 0
        assert res["stats"]["skipped_steps"] == int(want.skipped_steps) == 1
        b, w = res["params"]
        assert b == [0.0] * 8 and w == [1.0] * 128
    np.testing.assert_array_equal(
        jax_steps["zero"]["poisoned_params"]["w"], np.ones((16, 8)))
