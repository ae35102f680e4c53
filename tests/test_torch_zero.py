"""The port's ZeRO (``apex_tpu_torch.contrib.optimizers``, the
hierarchical collectives, ``zero_init`` and the ZeRO train step) against
the JAX package's.

Four gloo ranks (``tests/torch_zero_ranks.py``, started once for the
module) run every optimizer case on a dp 4 grid, then the hierarchical
cases on a dcn 2 x dp 2 grid: ``DistributedFusedAdam`` flat-bucket at
one and two buckets, per leaf, with a bf16 and an fp32 dtype-group, with
the bf16 + remainder master, with ``skip_update`` and a predivide;
``DistributedFusedLAMB`` flat-bucket, per leaf and with the global-norm
clip; each rank stepping its own numpy gradients (made from a seed)
three times.  The JAX side runs the same cases jitted under
``shard_map`` on four of the eight virtual CPU devices, each grid's
cases in one program.  Parameters and the gathered shards agree at the
reference's rtol 1e-5 / atol 1e-6 (one bf16 ulp for bf16 parameters),
the uint16 remainders bit for bit, and the port matches its own
``FusedAdam`` / ``FusedLAMB`` on the mean gradients.  The same spawn
holds the hierarchical pair against the flat reduce-scatter, the flat
rank against the reduce-scatter's tile order, the accumulated train step
against the full batch and against ``data_parallel_train_step``, and
runs the ZeRO example (``apex_tpu_torch/examples/zero_grad_accum.py``)
at dcn 2 x dp 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from torch_threads import one_torch_thread  # noqa: F401

import torch_zero_ranks as ranks
from apex_tpu import parallel as jparallel
from apex_tpu.contrib.optimizers import (
    DistributedFusedAdam as JAdam,
    DistributedFusedLAMB as JLamb,
)
from apex_tpu.contrib.optimizers import distributed_fused_adam as jdfa
from apex_tpu.parallel import collectives as jcc
from apex_tpu_torch.contrib.optimizers import (
    DistributedFusedAdam,
    DistributedFusedLAMB,
)
from apex_tpu_torch.contrib.optimizers import _flat_bucket as fb
from apex_tpu_torch.contrib.optimizers import distributed_fused_adam as dfa
from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB
from apex_tpu_torch.parallel.launch import run_multiprocess
from apex_tpu_torch.transformer.tensor_parallel import PartitionSpec

RTOL, ATOL = 1e-5, 1e-6
BF16_ULP = 2.0 ** -7          # relative: one bf16 ulp at the top of a binade
STEPS = 3


def _params(seed, mixed=False, dtype="float32"):
    rng = np.random.RandomState(seed)
    p = {"w": rng.randn(13, 7), "b": rng.randn(8), "e": rng.randn(4, 4, 2)}
    if mixed:
        p["h"] = rng.randn(9, 3)
    p = {k: v.astype(np.float32) for k, v in p.items()}
    dtypes = {k: dtype for k in p}
    if mixed:
        dtypes["h"] = "bfloat16"
    # bf16 leaves start from bf16 values on both sides
    for k, dt in dtypes.items():
        if dt == "bfloat16":
            p[k] = torch.from_numpy(p[k]).bfloat16().float().numpy()
    return p, dtypes


def _grads(params, dtypes, seed, n):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        g = {k: rng.randn(*v.shape).astype(np.float32)
             for k, v in sorted(params.items())}
        for k, dt in dtypes.items():
            if dt == "bfloat16":
                g[k] = torch.from_numpy(g[k]).bfloat16().float().numpy()
        out.append(g)
    return out


def _case(name, opt, kw, seed, mixed=False, dtype="float32", step_kw=None,
          n=4):
    params, dtypes = _params(seed, mixed, dtype)
    return {"name": name, "opt": opt, "kw": kw, "params": params,
            "dtypes": dtypes, "grads": _grads(params, dtypes, seed + 1, n),
            "steps": STEPS, "step_kw": step_kw or {}}


ADAM = dict(lr=1e-2, weight_decay=0.01)
DP4_CASES = [
    _case("adam_k1", "adam", ADAM, 0),
    _case("adam_k2", "adam", dict(ADAM, n_buckets=2), 0),
    _case("adam_leaf", "adam", dict(ADAM, flat_bucket=False), 0),
    _case("adam_mixed", "adam", ADAM, 2, mixed=True),
    _case("adam_mixed_leaf", "adam", dict(ADAM, flat_bucket=False), 2,
          mixed=True),
    _case("adam_rem", "adam", dict(lr=1e-2, store_param_remainders=True,
                                   n_buckets=2), 4, dtype="bfloat16"),
    _case("adam_rem_leaf", "adam", dict(lr=1e-2, store_param_remainders=True,
                                        flat_bucket=False), 4,
          dtype="bfloat16"),
    _case("adam_bf16", "adam", dict(lr=1e-2, n_buckets=2), 4,
          dtype="bfloat16"),
    _case("adam_skip", "adam", dict(lr=1e-2), 6,
          step_kw={"skip_update": True}),
    _case("adam_predivide", "adam", dict(ADAM, grad_predivide_factor=2.0),
          8),
    _case("lamb_flat", "lamb", ADAM, 10),
    _case("lamb_leaf", "lamb", dict(ADAM, flat_bucket=False), 10),
    _case("lamb_leaf_per_tensor", "lamb",
          dict(ADAM, flat_bucket=False, flat=False), 10),
    _case("lamb_clip", "lamb", dict(lr=1e-2, max_grad_norm=0.5), 12),
    _case("lamb_clip_leaf", "lamb", dict(lr=1e-2, max_grad_norm=0.5,
                                         flat_bucket=False), 12),
]
HIER_CASES = [
    _case("hier", "adam", ADAM, 14),
    _case("hier_flat_axis", "adam", dict(ADAM, axis=("dcn", "dp"),
                                         outer_axis=None), 14),
    _case("hier_bf16_wire", "adam", dict(ADAM, dcn_reduce_dtype="bfloat16"),
          14),
    _case("hier_lamb", "lamb", dict(ADAM, n_buckets=2), 16),
]
CASES = {c["name"]: c for c in DP4_CASES + HIER_CASES}


def _regression():
    rng = np.random.RandomState(1)
    w0 = rng.randn(4, 2).astype(np.float32)
    X = rng.randn(64, 4).astype(np.float32)
    Y = (X @ rng.randn(4, 2)).astype(np.float32)
    return w0, X, Y


# ----------------------------------------------------------- the JAX side


def _jax_opt(case):
    kw = dict(case["kw"])
    if "dcn_reduce_dtype" in kw:
        kw["dcn_reduce_dtype"] = jnp.bfloat16
    return {"adam": JAdam, "lamb": JLamb}[case["opt"]](**kw)


def _jax_params(case):
    return {k: jnp.asarray(v, dtype=jnp.dtype(case["dtypes"][k]))
            for k, v in case["params"].items()}


def _jax_run(cases, rank_fn):
    """Each case's final parameters and state (global arrays: every
    rank's shard concatenated), all cases in one jitted shard_map."""
    opts = {c["name"]: _jax_opt(c) for c in cases}
    params = {c["name"]: _jax_params(c) for c in cases}
    grads = {c["name"]: {k: jnp.stack([jnp.asarray(g[k]) for g in c["grads"]])
                         for k in c["params"]} for c in cases}

    def local(params, grads):
        r = rank_fn()
        out = {}
        for c in cases:
            name = c["name"]
            opt, p = opts[name], params[name]
            g = {k: jax.lax.dynamic_index_in_dim(v, r, 0, keepdims=False)
                 .astype(p[k].dtype) for k, v in grads[name].items()}
            kw = {k: jnp.asarray(v) for k, v in c["step_kw"].items()}
            state = opt.init(p)
            for _ in range(c["steps"]):
                p, state = opt.step(g, state, p, **kw)
            out[name] = (p, state)
        return out

    out_specs = {c["name"]: (JP(), opts[c["name"]].state_partition_specs(
        params[c["name"]])) for c in cases}
    fn = jax.jit(jcc.shard_over(local, in_specs=(JP(), JP()),
                                out_specs=out_specs))
    return jax.tree_util.tree_map(np.asarray, fn(params, grads))


def _jax_regression(w0, X, Y):
    from apex_tpu.parallel import (
        dp_shard_batch,
        replicate,
        zero_data_parallel_train_step,
        zero_init,
    )

    m = jparallel.mesh.get_mesh()

    def loss_fn(p, batch):
        x, y = batch
        return jnp.mean((x @ p["w"] - y) ** 2)

    opt = JAdam(lr=0.05)
    p = replicate({"w": jnp.asarray(w0)}, m)
    s = zero_init(opt, p, m)
    step = zero_data_parallel_train_step(loss_fn, opt, mesh=m, donate=False,
                                         microbatches=2)
    batch = dp_shard_batch((jnp.asarray(X), jnp.asarray(Y)), m)
    losses = []
    for _ in range(5):
        p, s, loss = step(p, s, batch)
        losses.append(float(loss))
    return {"w": np.asarray(p["w"]), "losses": losses}


@pytest.fixture(scope="module")
def runs():
    """The four gloo ranks, then the JAX side: ``(port, jax)``, the port's
    a list of each rank's results by case name."""
    port = run_multiprocess(ranks.zero_cases, 4,
                            args=(DP4_CASES, HIER_CASES, _regression()),
                            timeout=240.0, num_threads=1)
    devices = jax.devices()[:4]
    jax_out = {}
    try:
        jparallel.initialize_model_parallel(devices=devices)
        jax_out.update(_jax_run(DP4_CASES, lambda: jcc.axis_index("dp")))
        jax_out["regression"] = _jax_regression(*_regression())
        jparallel.destroy_model_parallel()
        jparallel.initialize_model_parallel(dcn_data_parallel_size=2,
                                            devices=devices)
        jax_out.update(_jax_run(
            HIER_CASES, lambda: jcc.axis_index("dcn") * jcc.axis_size("dp")
            + jcc.axis_index("dp")))
    finally:
        jparallel.destroy_model_parallel()
    return port, jax_out


# -------------------------------------------------------------- helpers


def _close(got, want, dtype, what, rtol=RTOL, atol=ATOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dtype == "bfloat16":
        # the same fp32 update may round to either neighbour in bf16
        np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=ATOL,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=what)


def _global_state(port, name, ranks_of_shards):
    """The port's per-rank state leaves concatenated over the ranks that
    hold distinct shards, in the JAX state's structure."""
    states = [port[r][name]["state"] for r in ranks_of_shards]

    def cat(*xs):
        return xs[0] if np.ndim(xs[0]) == 0 else np.concatenate(xs, axis=0)

    return jax.tree_util.tree_map(cat, *states)


def _joined_master(case, params, master):
    """The fp32 master a remainder state encodes: its uint16 low halves
    joined with the bf16 parameters' bits, laid out as the state (a group
    buffer a bucket, or a padded ravel a leaf, the ranks' rows
    concatenated)."""
    leaves = [torch.from_numpy(np.asarray(params[k], np.float32)).bfloat16()
              for k in sorted(params)]
    lo = [torch.from_numpy(np.array(x))
          for x in jax.tree_util.tree_leaves(master)]
    if case["kw"].get("flat_bucket", True):
        lay = fb.build_layout(leaves, world=4,
                              n_buckets=case["kw"].get("n_buckets", 1))
        (group,) = lay.groups
        hi = fb.bucket_slices(fb.flatten_group(lay, group, leaves,
                                               dtype=torch.bfloat16),
                              group, lay.n_buckets)
    else:
        hi = [torch.nn.functional.pad(x.reshape(-1), (0, y.numel()
                                                      - x.numel()))
              for x, y in zip(leaves, lo)]
    return [dfa.join_fp32(h.reshape(x.shape), x).numpy()
            for h, x in zip(hi, lo)]


def _replicated_ref(case):
    """The port's single-process FusedAdam / FusedLAMB (fp32 masters) on
    the mean gradients."""
    params = ranks.make_params(case)
    kw = {k: v for k, v in case["kw"].items()
          if k in ("lr", "weight_decay", "max_grad_norm")}
    cls = {"adam": FusedAdam, "lamb": FusedLAMB}[case["opt"]]
    opt = cls(list(params[k] for k in sorted(params)), master_weights=True,
              **kw)
    mean = {k: np.mean([g[k] for g in case["grads"]], axis=0)
            for k in params}
    for _ in range(case["steps"]):
        for k, p in params.items():
            p.grad = torch.from_numpy(mean[k]).to(p.dtype)
        opt.step()
    return {k: v.detach().float().numpy() for k, v in params.items()}


# ------------------------------------------------------- optimizer cases


@pytest.mark.parametrize("name", [c["name"] for c in DP4_CASES
                                  + HIER_CASES])
def test_zero_case_matches_the_jax_optimizer(runs, name):
    """Final parameters on every rank equal, and equal to JAX's; the
    shards, gathered over the ranks, equal JAX's global state."""
    port, jax_out = runs
    case = CASES[name]
    mine = port[0][name]
    for r in range(1, 4):
        for k in case["params"]:
            np.testing.assert_array_equal(port[r][name]["params"][k],
                                          mine["params"][k])
    jp, jstate = jax_out[name]
    for k, dt in case["dtypes"].items():
        assert mine["dtypes"][k] == f"torch.{dt}"
        _close(mine["params"][k], jp[k], dt, f"{name}: params[{k}]")
    hier = name.startswith("hier") and "outer_axis" not in case["kw"]
    holders = [0, 1] if hier else [0, 1, 2, 3]
    got = _global_state(port, name, holders)
    assert int(got["step"]) == int(jstate.step) == (
        0 if case["step_kw"].get("skip_update") else STEPS)
    for slot in ("exp_avg", "exp_avg_sq"):
        want = jstate.slots[slot]
        for a, b in zip(jax.tree_util.tree_leaves(got["slots"][slot]),
                        jax.tree_util.tree_leaves(want)):
            assert a.shape == b.shape, (name, slot, a.shape, b.shape)
            _close(a, b, "float32", f"{name}: {slot}")
    mine_m = jax.tree_util.tree_leaves(got["master"])
    theirs_m = jax.tree_util.tree_leaves(jstate.master)
    if case["kw"].get("store_param_remainders"):
        # each package's remainders joined with its own bf16 parameters
        mine_m = _joined_master(case, mine["params"], got["master"])
        theirs_m = _joined_master(case, jp, jstate.master)
    for a, b in zip(mine_m, theirs_m):
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
        _close(a, b, "float32", f"{name}: master")


@pytest.mark.parametrize("name", ["adam_k1", "adam_k2", "adam_leaf",
                                  "lamb_flat", "lamb_leaf", "hier",
                                  "hier_flat_axis"])
def test_zero_matches_the_fused_optimizer_on_mean_gradients(runs, name):
    port, _ = runs
    ref = _replicated_ref(CASES[name])
    for k, v in ref.items():
        _close(port[0][name]["params"][k], v, "float32", f"{name}: {k}")


def test_flat_bucket_equals_per_leaf(runs):
    """The bucketed exchange re-plumbs the per-leaf one: Adam to 1e-6
    (the bf16 + fp32 groups to 1e-4, as the reference), LAMB's segmented
    trust ratios to 1e-6, its per-tensor and chunked per-leaf forms too,
    and the clip engages in both."""
    port, _ = runs
    p = {name: port[0][name]["params"] for name in CASES}
    for a, b, tol in (("adam_k1", "adam_leaf", 1e-6),
                      ("adam_mixed", "adam_mixed_leaf", 1e-4),
                      ("lamb_flat", "lamb_leaf", 1e-6),
                      ("lamb_leaf", "lamb_leaf_per_tensor", 1e-6),
                      ("lamb_clip", "lamb_clip_leaf", 2e-6),
                      ("adam_rem", "adam_rem_leaf", 0.0)):
        for k in p[a]:
            np.testing.assert_allclose(p[a][k], p[b][k], rtol=tol,
                                       atol=tol, err_msg=f"{a} vs {b}: {k}")


def test_remainder_path_is_the_fp32_master_bit_for_bit(runs):
    """bf16 parameters + uint16 remainders against the bf16 model with a
    full fp32 master (the same seed and buckets): the master they encode
    is the fp32 master bit for bit, in the port as in the JAX package,
    and the parameters are one bf16 ulp apart (truncation against
    rounding)."""
    port, jax_out = runs
    case = CASES["adam_rem"]
    rem, full = port[0]["adam_rem"], port[0]["adam_bf16"]
    for k in rem["params"]:
        np.testing.assert_allclose(rem["params"][k], full["params"][k],
                                   rtol=2 * BF16_ULP, atol=1e-2)
    got = _global_state(port, "adam_rem", [0, 1, 2, 3])
    assert all(x.dtype == np.uint16 for g in got["master"] for x in g)
    want = jax.tree_util.tree_leaves(
        _global_state(port, "adam_bf16", [0, 1, 2, 3])["master"])
    for a, b in zip(_joined_master(case, rem["params"], got["master"]),
                    want):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    jp, js = jax_out["adam_rem"]
    jwant = jax.tree_util.tree_leaves(jax_out["adam_bf16"][1].master)
    for a, b in zip(_joined_master(case, jp, js.master), jwant):
        np.testing.assert_array_equal(a.view(np.uint32),
                                      np.asarray(b).view(np.uint32))


def test_skip_update_leaves_everything_bit_unchanged(runs):
    port, _ = runs
    case = CASES["adam_skip"]
    for r in range(4):
        for k, v in case["params"].items():
            np.testing.assert_array_equal(port[r]["adam_skip"]["params"][k],
                                          v)
        st = port[r]["adam_skip"]["state"]
        assert all(not np.any(x) for g in st["slots"]["exp_avg"] for x in g)


def test_hierarchical_pair_equals_the_flat_reduce_scatter(runs):
    """RS over dp + the shard all-reduced over dcn, gathered over dp,
    equals one flat RS over (dcn, dp) gathered back: both the full sum;
    and on one slice the outer hop is skipped (one collective)."""
    port, _ = runs
    want = np.arange(4 * 32, dtype=np.float32).reshape(4, 32).sum(axis=0)
    for r in range(4):
        np.testing.assert_array_equal(port[r]["prim_2x2"]["hier"], want)
        np.testing.assert_array_equal(port[r]["prim_2x2"]["flat"], want)
        prim = port[r]["prim_dp4"]
        np.testing.assert_array_equal(prim["shard"], np.full(4, 4.0))
        assert prim["calls"]["reduce_scatter"] == 1
        assert prim["calls"]["all_reduce"] == 0


def test_flat_rank_is_the_reduce_scatter_tile(runs):
    """At dcn 2 x dp 2, ``local_slices`` at ``flat_rank`` names the rows
    the reduce-scatter gives the rank, over ("dcn", "dp") (ranks 0-3 in
    grid order) and over dp under the dcn tier."""
    port, _ = runs
    for r in range(4):
        tiles = port[r]["prim_2x2"]["tiles"]
        assert tiles["flat"] == {"rank": r, "equal": True}
        assert tiles["hier"] == {"rank": r % 2, "equal": True}


def test_bf16_dcn_wire_stays_within_its_rounding(runs):
    """``dcn_reduce_dtype=bfloat16`` over gloo (which sums bf16 on the
    CPU) against the fp32 hierarchical step: within bf16 wire noise, as
    the reference's 5e-2."""
    port, _ = runs
    a, b = port[0]["hier_bf16_wire"]["params"], port[0]["hier"]["params"]
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=5e-2, atol=5e-2)
        assert not np.array_equal(a[k], b[k]) or k == "b"


def test_accumulated_train_step_matches_the_full_batch(runs):
    """``zero_data_parallel_train_step`` with two microbatches equals one,
    equals ``data_parallel_train_step`` + FusedAdam, and equals the JAX
    ZeRO step with two microbatches."""
    port, jax_out = runs
    z1 = port[0]["regression_zero1"]
    z2 = port[0]["regression_zero2"]
    dp = port[0]["regression_dp"]
    np.testing.assert_allclose(z1["w"], z2["w"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(z1["losses"], z2["losses"], rtol=RTOL)
    np.testing.assert_allclose(z1["w"], dp["w"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(z2["w"], jax_out["regression"]["w"],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(z2["losses"], jax_out["regression"]["losses"],
                               rtol=RTOL)
    for r in range(1, 4):
        assert port[r]["regression_zero2"]["losses"] == z2["losses"]


def test_example_trains_at_dcn2_dp2(runs):
    """``examples/zero_grad_accum.py`` (two buckets, four microbatches)
    at dp 2 in each of two dcn slices: the loss falls, the same on every
    rank."""
    port, _ = runs
    losses = port[0]["example"]
    assert len(losses) == 6 and losses[-1] < losses[0]
    assert all(np.isfinite(losses))
    assert all(port[r]["example"] == losses for r in range(4))


# ----------------------------------------------------------- in process


def test_split_join_fp32_is_the_references_bits():
    """``split_fp32`` / ``join_fp32``: the round trip is exact over every
    exponent and sign, and both halves are the JAX package's bytes."""
    rng = np.random.RandomState(0)
    x = (rng.randn(4096) * np.exp2(rng.randint(-60, 60, 4096))).astype(
        np.float32)
    x[:4] = [0.0, -0.0, np.inf, -np.inf]
    hi, lo = dfa.split_fp32(torch.from_numpy(x))
    assert hi.dtype == torch.bfloat16 and lo.dtype == torch.uint16
    np.testing.assert_array_equal(dfa.join_fp32(hi, lo).numpy().view(
        np.uint32), x.view(np.uint32))
    jhi, jlo = jdfa.split_fp32(jnp.asarray(x))
    np.testing.assert_array_equal(hi.view(torch.int16).numpy(),
                                  np.asarray(jhi).view(np.int16))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))


def _spec_tree(x):
    """A PartitionSpec tree as plain tuples, either package's."""
    if isinstance(x, (JP, PartitionSpec)):
        return ("P",) + tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                              for e in x)
    if isinstance(x, dict):
        return {k: _spec_tree(v) for k, v in x.items()}
    if hasattr(x, "_fields"):
        return {f: _spec_tree(getattr(x, f)) for f in x._fields}
    if isinstance(x, (list, tuple)):
        return [_spec_tree(v) for v in x]
    return x


@pytest.mark.parametrize("kw", [dict(n_buckets=2), dict(flat_bucket=False),
                                dict(axis=("dcn", "dp"), outer_axis=None)])
def test_state_partition_specs_structure(kw):
    """The spec tree mirrors the state: two dtype-groups x two buckets of
    ``P("dp")``, or ``P("dp")`` a leaf; the same tree as JAX's."""
    tparams = {"w": torch.ones(13, 7), "h": torch.ones(8,
                                                       dtype=torch.bfloat16)}
    jparams = {"w": jnp.ones((13, 7)), "h": jnp.ones((8,), jnp.bfloat16)}
    from apex_tpu_torch.amp._tree import tree_leaves

    mine = DistributedFusedAdam(tree_leaves(tparams), **kw) \
        .state_partition_specs(tparams)
    theirs = JAdam(**kw).state_partition_specs(jparams)
    assert _spec_tree(mine) == _spec_tree(theirs)
    assert mine.step == PartitionSpec()
    if kw.get("flat_bucket", True):
        assert len(mine.master) == 2 and all(len(b) == 2 or "axis" in kw
                                             for b in mine.master)
    else:
        assert mine.slots["exp_avg"]["w"] == PartitionSpec("dp")


def test_layout_is_the_references():
    """``build_layout``: the same groups, rows, bucket rows and leaf ids
    as the JAX package's for a mixed tree at world 4, two buckets."""
    from apex_tpu.contrib.optimizers import _flat_bucket as jfb

    rng = np.random.RandomState(3)
    shapes = {"a": (300,), "b": (13, 7), "c": (1000,), "d": (5,)}
    tp = {k: torch.from_numpy(rng.randn(*s).astype(np.float32))
          for k, s in shapes.items()}
    tp["c"] = tp["c"].bfloat16()
    jp = {k: jnp.asarray(v.float().numpy(), jnp.dtype(str(v.dtype)[6:]))
          for k, v in tp.items()}
    mine = fb.build_layout(tp, world=4, n_buckets=2, chunk=64)
    theirs = jfb.build_layout(jp, world=4, n_buckets=2, chunk=64)
    assert len(mine.groups) == len(theirs.groups) == 2
    for a, b in zip(mine.groups, theirs.groups):
        assert (a.indices, a.rows, a.rows_per_bucket, a.local_rows) == (
            b.indices, b.rows, b.rows_per_bucket, b.local_rows)
        np.testing.assert_array_equal(a.meta.leaf_ids, b.meta.leaf_ids)
        buf = fb.flatten_group(mine, a, [tp[k] for k in sorted(tp)])
        jbuf = jfb.flatten_group(theirs, b, [jp[k] for k in sorted(jp)])
        np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))


def test_zero_optimizers_refuse_what_they_cannot_shard():
    w = torch.ones(3, requires_grad=True)
    with pytest.raises(ValueError, match="one parameter group"):
        DistributedFusedLAMB([{"params": [w]}, {"params": [torch.ones(2)]}])
    with pytest.raises(ValueError, match="outer_axis"):
        fb.resolve_axes(("dcn", "dp"), "tp")
