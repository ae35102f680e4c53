"""The port's checkpoint files against the JAX package's: either package
reads what the other wrote, bit for bit.

At one rank (this process): the same numpy-seeded tree (fp32, int32,
bool and 0-d leaves, a ``GPT3DParams``) saved by one package and
restored by the other, flat and sharded, sync and async, with the two
packages' manifests (leaf paths, shapes, dtypes) and crc32s equal; bf16
leaves (the port's round trip, and the port reading the reference's
file, which the reference itself cannot restore: ROADMAP.md section C);
and the twins of ``tests/test_checkpoint.py``.  ZeRO at one rank
against the JAX package at dp 4 (one jitted program): the portable state
of ``gather_zero_state`` over remainders x flat buckets equals the
reference's, scatters back bit for bit, crosses between the packages
both ways, and resumes bit for bit; a flat-bucket ZeRO checkpoint
written by either package restores, resharded, in the other.

Across four ranks: one module-scoped fixture writes the reference's
sharded and flat checkpoints of a GPT train state (params, an
``OptState``, the sentinel) from a 4-device (pp 2, tp 2) mesh, starts
four gloo CPU ranks (``torch_checkpoint_ranks.checkpoint_cases``, torch
only) on the same grid with sequence parallelism, and meanwhile serves
the same weights on JAX's engine at tp 2.  The ranks save the
same state sharded, async and flat; the reference's ``load_logical`` of
those equals its own; the ranks restore the reference's checkpoints on
their grid and, resharded, on a (dp 2, tp 2) grid; this process restores
it at world size 1; and the ranks serve the port's own checkpoint at
tp 2 through ``restore_gpt_for_serving``, token for token JAX's streams.
The port's ``ShardingSpec`` JSON equals the reference's ``to_json``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from apex_tpu import checkpoint as jck
from apex_tpu import parallel as jparallel
from apex_tpu.amp.scaler import DynamicLossScale as JaxScale
from apex_tpu.observability.metrics import MetricRegistry
from apex_tpu.optimizers._common import OptState as JaxOptState
from apex_tpu.resilience import reshard as jreshard
from apex_tpu.resilience import sentinel_init as j_sentinel_init
from apex_tpu.serving import ServingConfig as JaxServingConfig
from apex_tpu.serving import ServingEngine as JaxServingEngine
from apex_tpu.transformer.tensor_parallel.partition import (
    infer_param_specs as j_infer_specs,
)
from apex_tpu.transformer.testing.gpt_parallel_train import (
    GPT3DParams as JaxGPT3DParams,
    _prepend as j_prepend,
    gpt3d_logical_folds as j_folds,
)
from apex_tpu.transformer.testing.standalone_transformer_lm import (
    TransformerConfig as JaxTransformerConfig,
)
from apex_tpu_torch import checkpoint as ckpt
from apex_tpu_torch.amp._tree import tree_leaves
from apex_tpu_torch.amp.scaler import DynamicLossScale
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.optimizers._common import OptState
from apex_tpu_torch.parallel.launch import start_multiprocess
from apex_tpu_torch.resilience import build_spec, restore_resharded
from apex_tpu_torch.transformer.testing.gpt_parallel_train import (
    GPT3DParams,
    gpt3d_logical_folds,
)

import torch_checkpoint_ranks as ranks
from test_torch_serving import GPT, WAVE, _jax_tree
from torch_threads import one_torch_thread  # noqa: F401
from torch_world import world1  # noqa: F401

SERVING = dict(max_batch=3, block_size=4, max_seq=32, prefill_len=6,
               n_blocks=16)


def _numpy_tree(seed=0):
    """One tree of every leaf kind the cross-reads cover: fp32, int32,
    bool, 0-d, nested dicts and a small ``GPT3DParams``."""
    rng = np.random.default_rng(seed)

    def f(*s):
        return rng.standard_normal(s).astype(np.float32)

    gpt = dict(embedding={"word_embeddings": {"embedding": f(16, 4)}},
               layers={"mlp": {"kernel": f(1, 2, 8, 4), "bias": f(1, 2, 8)}},
               final_ln={"scale": f(4), "bias": f(4)})
    return {"w": f(6, 5), "n": rng.integers(-9, 9, (7,)).astype(np.int32),
            "mask": rng.integers(0, 2, (3, 2)).astype(bool),
            "scalar": np.float32(2.5), "count": np.int32(11),
            "nested": {"b": f(3), "a": f(2, 2)}, "gpt": gpt}


def _jax_side(t):
    gpt = JaxGPT3DParams(**t["gpt"])
    out = {k: v for k, v in t.items() if k != "gpt"}
    return jax.tree_util.tree_map(jnp.asarray, dict(out, gpt=gpt))


def _port_side(t):
    def conv(x):
        return torch.from_numpy(np.array(x))

    gpt = GPT3DParams(**jax.tree_util.tree_map(conv, t["gpt"]))
    out = jax.tree_util.tree_map(
        conv, {k: v for k, v in t.items() if k != "gpt"})
    return dict(out, gpt=gpt)


def _as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_leaves(a, b):
    la = [_as_np(x) for _, x in ckpt._leaves_with_path(a)]
    lb = [np.asarray(x) for x in jax.tree_util.tree_leaves(b)]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _manifests(path):
    """Every npz manifest of a checkpoint (file or directory), and the
    checksums of all its arrays."""
    files = ([os.path.join(path, n) for n in sorted(os.listdir(path))
              if n.endswith(".npz")] if os.path.isdir(path) else [path])
    mans, sums = [], {}
    for p in files:
        with np.load(p, allow_pickle=False) as data:
            m = json.loads(str(data["__manifest__"]))
        mans.append(m)
        sums.update(m["checksums"])
    return mans, sums


# ---------------------------------------------------------------------------
# One rank: cross-reads both ways
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("layout", ["flat", "sharded"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cross_read_bit_for_bit(tmp_path, writer, layout, mode):
    """One package writes, the other restores, bit for bit; both
    packages' files of the same tree have equal leaf lists and crc32s."""
    t = _numpy_tree()
    jt, pt = _jax_side(t), _port_side(t)
    paths = {}
    for who, mod, tree in (("jax", jck, jt), ("port", ckpt, pt)):
        path = str(tmp_path / (who + (".npz" if layout == "flat" else "")))
        paths[who] = path
        if layout == "flat" and mode == "sync":
            mod.save_checkpoint(path, tree, step=9)
        elif layout == "flat":
            mod.save_checkpoint_async(path, tree, step=9).result(timeout=60)
        elif mode == "sync":
            mod.save_checkpoint_sharded(path, tree, step=9)
        else:
            mod.save_checkpoint_sharded_async(path, tree, step=9) \
                .finalize(timeout=60)
    (jm,), jsums = _manifests(paths["jax"])
    (pm,), psums = _manifests(paths["port"])
    assert jm["leaves"] == pm["leaves"]
    assert jsums == psums
    src = paths[writer]
    if writer == "jax":
        restore = (ckpt.restore_checkpoint if layout == "flat"
                   else ckpt.restore_checkpoint_sharded)
        got, step = restore(src, pt)
    else:
        restore = (jck.restore_checkpoint if layout == "flat"
                   else jck.restore_checkpoint_sharded)
        got, step = restore(src, jt)
        got = jax.tree_util.tree_map(np.asarray, got)
        got = dict(got, gpt=GPT3DParams(*got["gpt"]))
    assert step == 9
    _same_leaves(got, jt)


def test_bf16_leaves_round_trip_and_read_the_reference(tmp_path):
    """A bf16 leaf is stored as the reference stores it (``V2`` bytes,
    manifest dtype ``bfloat16``): the port's own round trip is bit for
    bit, both packages write the same crc32, and the port reads the
    reference's file, which the reference's ``restore_checkpoint``
    cannot (numpy has no cast from ``V2``: ROADMAP.md section C)."""
    x = np.random.default_rng(1).standard_normal((3, 5)).astype(np.float32)
    port = {"x": torch.from_numpy(x).to(torch.bfloat16), "y": torch.ones(2)}
    ref = {"x": jnp.asarray(x, jnp.bfloat16), "y": jnp.ones(2)}
    for layout in ("flat", "sharded"):
        p = str(tmp_path / f"p_{layout}")
        j = str(tmp_path / f"j_{layout}")
        if layout == "flat":
            p, j = p + ".npz", j + ".npz"
            ckpt.save_checkpoint(p, port, step=1)
            jck.save_checkpoint(j, ref, step=1)
            read = ckpt.restore_checkpoint
        else:
            ckpt.save_checkpoint_sharded(p, port, step=1)
            jck.save_checkpoint_sharded(j, ref, step=1)
            read = ckpt.restore_checkpoint_sharded
        (pm,), psums = _manifests(p)
        (jm,), jsums = _manifests(j)
        assert pm["leaves"] == jm["leaves"]
        assert pm["leaves"][0]["dtype"] == "bfloat16"
        assert psums == jsums
        for src in (p, j):
            got, _ = read(src, port)
            assert got["x"].dtype == torch.bfloat16
            assert torch.equal(got["x"].view(torch.int16),
                               port["x"].view(torch.int16))
    with pytest.raises(ValueError, match="cast"):
        jck.restore_checkpoint(str(tmp_path / "j_flat.npz"), ref)


# ---------------------------------------------------------------------------
# Twins of tests/test_checkpoint.py
# ---------------------------------------------------------------------------


def test_roundtrip_bit_exact_resume(tmp_path):
    """Save at step 3, train to 6; restore at 3, train to 6: identical
    (an MLP under FusedAdam with the loss scale's skip, the whole state
    through ``opt_state``/``load_opt_state``)."""
    from apex_tpu_torch import amp

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(32, 8, generator=gen)
    y = torch.randint(0, 4, (32,), generator=gen)

    def build():
        g = torch.Generator().manual_seed(2)
        params = {"w1": torch.randn(8, 16, generator=g).mul_(0.3),
                  "w2": torch.randn(16, 4, generator=g).mul_(0.3)}
        params = {k: v.requires_grad_(True) for k, v in params.items()}
        return params, FusedAdam(tree_leaves(params), lr=1e-2)

    scaler = DynamicLossScale()

    def step(params, opt, sstate):
        opt.zero_grad(set_to_none=True)
        logits = torch.relu(x @ params["w1"]) @ params["w2"]
        loss = torch.nn.functional.cross_entropy(logits, y)
        (loss * sstate.scale).backward()
        grads = {k: p.grad / sstate.scale for k, p in params.items()}
        finite = amp.all_finite(grads)
        sstate = scaler.update(sstate, finite)
        for k, p in params.items():
            p.grad = grads[k]
        opt.step(skip_update=~finite)
        return sstate, loss.detach()

    params, opt = build()
    sstate = scaler.init("cpu")
    for _ in range(3):
        sstate, _ = step(params, opt, sstate)
    path = str(tmp_path / "c.npz")
    ckpt.save_checkpoint(path, {"params": params,
                                "opt": opt.opt_state(params),
                                "scaler": sstate}, step=3)
    losses = []
    for _ in range(3):
        sstate, loss = step(params, opt, sstate)
        losses.append(loss)

    params2, opt2 = build()
    like = {"params": params2, "opt": opt2.opt_state(params2),
            "scaler": scaler.init("cpu")}
    restored, at = ckpt.restore_checkpoint(path, like)
    assert at == 3
    with torch.no_grad():
        for k in params2:
            params2[k].copy_(restored["params"][k])
    opt2.load_opt_state(params2, restored["opt"])
    sstate2 = restored["scaler"]
    for want in losses:
        sstate2, loss = step(params2, opt2, sstate2)
        assert torch.equal(loss, want)
    for k in params:
        assert torch.equal(params[k].detach(), params2[k].detach())
        for s in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[params[k]][s],
                               opt2.state[params2[k]][s])


def test_async_save_roundtrip(tmp_path):
    """The async save snapshots on the caller's thread: changing the
    tensors after the call cannot reach the file."""
    w = torch.arange(12.0).reshape(3, 4)
    host = np.arange(5)
    path = str(tmp_path / "a.npz")
    fut = ckpt.save_checkpoint_async(path, {"w": w, "host": host}, step=4)
    w.mul_(-1)
    host += 100
    assert fut.result(timeout=30) == path
    got, step = ckpt.restore_checkpoint(
        path, {"w": torch.zeros(3, 4), "host": np.zeros(5, np.int64)})
    assert step == 4
    assert torch.equal(got["w"], torch.arange(12.0).reshape(3, 4))
    np.testing.assert_array_equal(got["host"], np.arange(5))


def test_restore_mismatch_raises(tmp_path):
    path = str(tmp_path / "c.npz")
    ckpt.save_checkpoint(path, {"a": torch.ones(3)}, step=0)
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore_checkpoint(path, {"a": torch.ones(3),
                                       "b": torch.ones(1)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_checkpoint(path, {"a": torch.ones(4)})
    with pytest.raises(ValueError, match="path"):
        ckpt.restore_checkpoint(path, {"z": torch.ones(3)})


def test_sharded_roundtrip_single_process(tmp_path):
    rng = np.random.RandomState(0)
    tree = {"w": torch.from_numpy(rng.randn(16, 8).astype(np.float32)),
            "b": torch.from_numpy(rng.randn(8).astype(np.float32)),
            "scale": torch.tensor(3.5), "host": np.arange(3)}
    d = str(tmp_path / "sharded")
    ckpt.save_checkpoint_sharded(d, tree, step=11)
    restored, step = ckpt.restore_checkpoint_sharded(d, tree)
    assert step == 11
    for k in ("w", "b", "scale"):
        assert torch.equal(restored[k], tree[k])
    np.testing.assert_array_equal(restored["host"], np.arange(3))
    with np.load(f"{d}/shard_0.npz") as data:
        keys = sorted(k for k in data.files if k != "__manifest__")
    assert keys == ["leaf_0|0:8", "leaf_1|full", "leaf_2|scalar",
                    "leaf_3|0:16,0:8"]


def test_sharded_rejects_stale_and_casts_dtype(tmp_path):
    d = str(tmp_path / "c")
    w = torch.arange(32.0).reshape(8, 4)
    ckpt.save_checkpoint_sharded(d, {"w": w}, step=2)
    import shutil

    shutil.copy(f"{d}/shard_0.npz", f"{d}/shard_7.npz")
    restored, step = ckpt.restore_checkpoint_sharded(d, {"w": w})
    assert step == 2
    os.unlink(f"{d}/manifest.json")
    with pytest.raises(ValueError, match="stale|duplicate"):
        ckpt.restore_checkpoint_sharded(d, {"w": w})
    ckpt.save_checkpoint_sharded(d, {"w": w}, step=3)
    assert not os.path.exists(f"{d}/shard_7.npz")
    restored, step = ckpt.restore_checkpoint_sharded(d, {"w": w})
    assert step == 3
    r2, _ = ckpt.restore_checkpoint_sharded(
        d, {"w": torch.zeros(8, 4, dtype=torch.bfloat16)})
    assert r2["w"].dtype == torch.bfloat16
    assert torch.equal(r2["w"].float(), torch.arange(32.0).reshape(8, 4))


def test_sharded_async_save_roundtrip(tmp_path):
    w = torch.arange(32.0).reshape(8, 4)
    host = np.arange(5)
    d = str(tmp_path / "async_sharded")
    handle = ckpt.save_checkpoint_sharded_async(d, {"w": w, "host": host},
                                                step=9)
    w.fill_(-1.0)
    host += 100
    path = handle.finalize(timeout=30)
    assert path.endswith("shard_0.npz")
    restored, step = ckpt.restore_checkpoint_sharded(
        d, {"w": torch.zeros(8, 4), "host": np.zeros(5, np.int64)})
    assert step == 9
    assert torch.equal(restored["w"], torch.arange(32.0).reshape(8, 4))
    np.testing.assert_array_equal(restored["host"], np.arange(5))


# ---------------------------------------------------------------------------
# Four ranks against the reference's 4-device mesh
# ---------------------------------------------------------------------------


def _jax_pack(tree, slots, mesh):
    """The reference's train state on the (pp 2, tp 2) mesh: the params
    placed by ``build_gpt_3d``'s specs, an ``OptState`` whose slots are
    placed alike, the sentinel replicated."""
    e_specs = j_infer_specs(tree.embedding, axis="tp")
    l_specs = j_prepend(j_infer_specs(
        jax.tree_util.tree_map(lambda x: x[0, 0], tree.layers),
        axis="tp"), None, "pp")
    specs = JaxGPT3DParams(
        embedding=e_specs, layers=l_specs,
        final_ln=jax.tree_util.tree_map(lambda _: JP(), tree.final_ln))

    def place(t):
        return jax.tree_util.tree_map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), t, specs,
            is_leaf=lambda x: isinstance(x, np.ndarray))

    rep = NamedSharding(mesh, JP())
    opt = JaxOptState(step=jax.device_put(jnp.int32(3), rep),
                      slots={k: place(v) for k, v in slots.items()},
                      master=None)
    sent = jax.device_put(j_sentinel_init(JaxScale()), rep)
    return {"params": place(tree), "opt": opt, "sent": sent}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt4")
    d = {k: str(root / k) for k in ("ref_sharded", "port_sharded",
                                    "port_async", "port_mgr",
                                    "port_split")}
    d.update(ref_flat=str(root / "ref_flat.npz"),
             port_flat=str(root / "port_flat.npz"))
    jcfg = JaxTransformerConfig(**GPT, hidden_dropout=0.0,
                                attention_dropout=0.0, tensor_axis="tp",
                                sequence_parallel=True)
    L = GPT["num_layers"]

    def stack2(t):                         # [L, 1, ...] -> [1, pp=2, ...]
        return t._replace(layers=jax.tree_util.tree_map(
            lambda x: x.reshape((1, L) + x.shape[2:]), t.layers))

    tree = stack2(_jax_tree(jcfg, 5))
    slots = {"exp_avg": jax.tree_util.tree_map(lambda x: x * 0.5, tree),
             "exp_avg_sq": jax.tree_util.tree_map(np.square, tree)}
    mesh = jparallel.initialize_model_parallel(
        tensor_model_parallel_size=2, pipeline_model_parallel_size=2,
        devices=jax.devices()[:4])
    try:
        jpack = _jax_pack(tree, slots, mesh)
        jspec = jreshard.build_spec(jpack, mesh=mesh, folds=j_folds(jpack))
        jck.save_checkpoint_sharded(d["ref_sharded"], jpack, step=5,
                                    spec=jspec)
        jck.save_checkpoint(d["ref_flat"], jpack, step=5, spec=jspec)
    finally:
        jparallel.destroy_model_parallel()
    spec = {"model": GPT, "tree": tree._asdict(),
            "exp_avg": slots["exp_avg"]._asdict(),
            "exp_avg_sq": slots["exp_avg_sq"]._asdict(), "opt_step": 3,
            "dirs": d, "serving": SERVING, "wave": WAVE}
    job = start_multiprocess(ranks.checkpoint_cases, 4, args=(spec,),
                             timeout=240.0, num_threads=1)
    # meanwhile: JAX's engine serves the same weights at tp 2
    smesh = jparallel.initialize_model_parallel(
        tensor_model_parallel_size=2, devices=jax.devices()[:2])
    try:
        scfg = JaxTransformerConfig(**GPT, hidden_dropout=0.0,
                                    attention_dropout=0.0, tensor_axis="tp")
        sparams = jax.tree_util.tree_map(
            jnp.asarray, tree._replace(layers=jax.tree_util.tree_map(
                lambda x: x.reshape((L, 1) + x.shape[2:]), tree.layers)))
        eng = JaxServingEngine(scfg, JaxServingConfig(**SERVING), sparams,
                               mesh=smesh, registry=MetricRegistry())
        reqs, pending, step = [], list(WAVE), 0
        while pending or not eng.scheduler.idle:
            while pending and pending[0][0] <= step:
                _, prompt, n_new = pending.pop(0)
                reqs.append(eng.submit(prompt, n_new))
            eng.step()
            step += 1
        streams = [r.output_tokens for r in reqs]
    finally:
        jparallel.destroy_model_parallel()
    got = job.join()
    return {"ranks": got, "dirs": d, "jspec": jspec.to_json(),
            "tree": tree, "slots": slots, "streams": streams}


def test_ranks_spec_json_equals_the_reference(run):
    """The port's ``build_spec`` from ``build_gpt_3d``'s PartitionSpecs
    and the grid gives the reference's JSON (axes per dim, ``pp`` on the
    ``[vpp, pp]`` stack, folds, mesh sizes) on every rank."""
    for r in run["ranks"]:
        assert r["spec"] == run["jspec"], r["rank"]


def test_ranks_sharded_checkpoint_reads_in_the_reference(run):
    """Four ranks' ``shard_{r}.npz`` files: the leaf list equals the
    reference's, every slice written once with the reference's key and
    crc32, and the reference's ``load_logical`` of it is its own state,
    sync and async."""
    d = run["dirs"]
    jmans, jsums = _manifests(d["ref_sharded"])
    want, step = jreshard.load_logical(d["ref_sharded"])
    assert step == 5
    for name in ("port_sharded", "port_async"):
        pmans, psums = _manifests(d[name])
        assert len(pmans) == 4
        assert {m["process_count"] for m in pmans} == {4}
        assert all(m["leaves"] == jmans[0]["leaves"] for m in pmans)
        assert psums == jsums
        got, step = jreshard.load_logical(d[name])
        assert step == 5 and sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_ranks_flat_checkpoint_restores_in_the_reference(run):
    """The flat save gathers each leaf over the grid: the file's arrays
    and crc32s are the reference's, and the reference's
    ``restore_checkpoint`` reads it."""
    d = run["dirs"]
    (pm,), psums = _manifests(d["port_flat"])
    (jm,), jsums = _manifests(d["ref_flat"])
    assert pm["leaves"] == jm["leaves"] and psums == jsums
    like = jax.tree_util.tree_map(
        np.asarray, jck.restore_checkpoint(d["ref_flat"], {
            "params": run["tree"], "opt": JaxOptState(
                step=np.int32(0), slots=run["slots"], master=None),
            "sent": j_sentinel_init(JaxScale())})[0])
    got, step = jck.restore_checkpoint(d["port_flat"], like)
    assert step == 5
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(like)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_reference_checkpoint_restores_on_the_ranks(run):
    """Each rank reads its slices of the reference's sharded and flat
    checkpoints, and ``restore_resharded`` gives the same on its grid and
    on a (dp 2, tp 2) grid, the stack re-factored to ``[2, 1, ...]``."""
    for r in run["ranks"]:
        for case in ("restore_sharded", "restore_flat",
                     "resharded_same_grid", "resharded_other_grid"):
            assert r[case] == [5, True] or r[case] == (5, True), \
                (r["rank"], case)


def test_reference_checkpoint_restores_at_world_size_one(run):
    """This process, one rank: ``restore_resharded`` of the reference's
    4-device checkpoint onto whole leaves with the stack ``[2, 1, ...]``
    (the logical path) is the state bit for bit."""
    tree, slots = run["tree"], run["slots"]

    def port(t):
        """Zeros of ``t``'s shapes, the layer stack ``[2, 1, ...]``."""
        def z(x):
            return torch.zeros(x.shape)

        return GPT3DParams(
            embedding=jax.tree_util.tree_map(z, t.embedding),
            layers=jax.tree_util.tree_map(
                lambda x: torch.zeros((2, 1) + x.shape[2:]), t.layers),
            final_ln=jax.tree_util.tree_map(z, t.final_ln))

    from apex_tpu_torch.resilience import sentinel_init

    like = {"params": port(tree),
            "opt": OptState(step=torch.tensor(0, dtype=torch.int32),
                            slots={k: port(v) for k, v in slots.items()},
                            master=None),
            "sent": sentinel_init(DynamicLossScale(), "cpu")}
    spec = build_spec(like, folds=gpt3d_logical_folds(like))
    got, step = restore_resharded(run["dirs"]["ref_sharded"], like, spec)
    assert step == 5
    for src, out in ((tree, got["params"]),
                     (slots["exp_avg"], got["opt"].slots["exp_avg"]),
                     (slots["exp_avg_sq"], got["opt"].slots["exp_avg_sq"])):
        for a, b in zip(jax.tree_util.tree_leaves(tuple(src)),
                        tree_leaves(tuple(out))):
            np.testing.assert_array_equal(
                b.numpy().reshape(a.shape), a)
    assert int(got["opt"].step) == 3


def test_ranks_target_spec_places_a_leaf_the_source_split(run):
    """A leaf the source split over dp, restored with a target spec that
    gives it no record, comes back whole on every rank of the dp 2 x tp
    2 grid: ``restore_resharded`` places each leaf by the spec it is
    given and takes no axes from the source's."""
    for r in run["ranks"]:
        assert r["replicated_from_split"] == (2, True), r["rank"]


def test_ranks_serve_the_trained_checkpoint_as_jax_at_tp2(run):
    """``restore_gpt_for_serving`` of the port's four-rank training
    checkpoint onto a tp 2 grid serves the wave token for token as JAX's
    engine at tp 2 serves the same weights, on every rank."""
    for r in run["ranks"]:
        assert r["serving_step"] == 7
        assert r["serving_stack"] == [GPT["num_layers"], 1,
                                      GPT["hidden_size"]]
        assert r["streams"] == run["streams"], r["rank"]


# ---------------------------------------------------------------- ZeRO

ZERO_COMBOS = [(rem, flat) for flat in (True, False) for rem in (False, True)]


def _zero_numpy(seed=0):
    rng = np.random.RandomState(seed)
    params = {"w": rng.randn(13, 7), "b": rng.randn(8)}
    grads = {"w": rng.randn(13, 7), "b": rng.randn(8)}
    def bf16(v):
        return torch.from_numpy(v.astype(np.float32)).bfloat16().float() \
            .numpy()

    # bf16 gradient values: a bf16 model's gradients on both sides
    return ({k: v.astype(np.float32) for k, v in params.items()},
            {k: bf16(v) for k, v in params.items()},
            {k: bf16(v) for k, v in grads.items()})


def _zero_kw(rem, flat):
    return dict(lr=1e-2, store_param_remainders=rem, flat_bucket=flat,
                n_buckets=2)


def _port_zero(rem, flat, steps=2):
    """The port's optimizer over fresh parameters, ``steps`` steps of the
    fixed gradients: ``(opt, params, grads)``."""
    from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam

    f32, b16, g = _zero_numpy()
    dtype = torch.bfloat16 if rem else torch.float32
    params = {k: torch.from_numpy(b16[k] if rem else f32[k]).to(dtype)
              .requires_grad_() for k in f32}
    opt = DistributedFusedAdam(tree_leaves(params), **_zero_kw(rem, flat))
    grads = {k: torch.from_numpy(v) for k, v in g.items()}
    _port_zero_steps(opt, params, grads, steps)
    return opt, params, grads


def _port_zero_steps(opt, params, grads, steps):
    for _ in range(steps):
        for k, p in params.items():
            p.grad = grads[k].to(p.dtype)
        opt.step()


def _np_tree(tree):
    return jax.tree_util.tree_map(
        lambda x: x.detach().float().numpy() if isinstance(x, torch.Tensor)
        and x.dtype == torch.bfloat16 else _as_np(x), tree,
        is_leaf=lambda x: isinstance(x, torch.Tensor))


@pytest.fixture(scope="module")
def jax_zero():
    """The JAX package's DistributedFusedAdam at dp 4, each combination
    two steps from the same weights and gradients (the same on every
    rank), in one jitted program: ``{(rem, flat): (opt, params, state,
    portable)}``."""
    from apex_tpu.contrib.optimizers import DistributedFusedAdam as JAdam
    from apex_tpu.parallel import collectives as jcc

    f32, b16, g = _zero_numpy()
    opts = {c: JAdam(**_zero_kw(*c)) for c in ZERO_COMBOS}
    params = {c: {k: jnp.asarray(b16[k] if c[0] else f32[k],
                                 jnp.bfloat16 if c[0] else jnp.float32)
                  for k in f32} for c in ZERO_COMBOS}
    grads = {k: jnp.asarray(v) for k, v in g.items()}

    def local(params, grads):
        out = {}
        for c in ZERO_COMBOS:
            p, opt = params[c], opts[c]
            s = opt.init(p)
            for _ in range(2):
                p, s = opt.step(grads, s, p)
            out[c] = (p, s)
        return out

    try:
        jparallel.initialize_model_parallel(devices=jax.devices()[:4])
        out = jax.jit(jcc.shard_over(
            local, in_specs=(JP(), JP()),
            out_specs={c: (JP(), opts[c].state_partition_specs(params[c]))
                       for c in ZERO_COMBOS}))(params, grads)
        return {c: (opts[c], out[c][0], out[c][1],
                    jck.gather_zero_state(opts[c], out[c][1], out[c][0]))
                for c in ZERO_COMBOS}
    finally:
        jparallel.destroy_model_parallel()


def _portable_close(got, want, what):
    assert int(np.asarray(got["step"])) == int(np.asarray(want["step"]))
    for name in ("slots", "master"):
        a = jax.tree_util.tree_leaves(_np_tree(got[name]))
        b = [np.asarray(x) for x in jax.tree_util.tree_leaves(want[name])]
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.shape == y.shape and x.dtype == y.dtype == np.float32
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{what}: {name}")


@pytest.mark.parametrize("rem, flat", ZERO_COMBOS)
def test_zero_state_gather_scatter(world1, jax_zero, rem, flat):
    """The portable ZeRO state (``test_checkpoint.py``'s twin): every slot
    leaf shaped as its parameter, an fp32 master; the reference's own at
    dp 4 within 1e-5; scattered back bit for bit; each package's portable
    state scatters in the other; and a resume from the scattered state
    is the uninterrupted run bit for bit."""
    from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam

    opt, params, grads = _port_zero(rem, flat)
    s1 = opt.opt_state(params)
    portable = ckpt.gather_zero_state(opt, s1, params)
    for name, tree in portable["slots"].items():
        for k, p in params.items():
            assert tuple(tree[k].shape) == tuple(p.shape)
    assert all(x.dtype == torch.float32
               for x in tree_leaves(portable["master"]))
    jopt, jp, js, jportable = jax_zero[(rem, flat)]
    _portable_close(portable, jportable, f"portable rem={rem} flat={flat}")

    back = ckpt.scatter_zero_state(opt, portable, s1, params)
    for a, b in zip(tree_leaves(s1), tree_leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_as_np(a), _as_np(b))

    # the reference's portable state, scattered by the port, and the
    # port's, scattered by the reference
    theirs = ckpt.scatter_zero_state(opt, jax.tree_util.tree_map(
        lambda x: torch.from_numpy(np.array(x)), jportable), s1, params)
    for a, b in zip(tree_leaves(theirs), tree_leaves(s1)):
        assert a.dtype == b.dtype
        if a.dtype == torch.uint16:
            continue                      # held through the join below
        np.testing.assert_allclose(_as_np(a), _as_np(b), rtol=1e-5, atol=1e-6)
    mine_in_jax = jck.scatter_zero_state(
        jopt, jax.tree_util.tree_map(jnp.asarray, _np_tree(portable)), js, jp)
    _portable_close(ckpt.gather_zero_state(opt, theirs, params),
                    jck.gather_zero_state(jopt, mine_in_jax, jp),
                    "crossed scatters")

    # resume: a fresh optimizer over a copy of the parameters loads the
    # scattered state; two more steps each
    resumed = {k: p.detach().clone().requires_grad_()
               for k, p in params.items()}
    opt_r = DistributedFusedAdam(tree_leaves(resumed), **_zero_kw(rem, flat))
    opt_r.load_opt_state(resumed, ckpt.scatter_zero_state(
        opt_r, portable, opt_r.opt_state(resumed), resumed))
    _port_zero_steps(opt, params, grads, 2)
    _port_zero_steps(opt_r, resumed, grads, 2)
    for a, b in zip(tree_leaves(params) + tree_leaves(opt.opt_state(params)),
                    tree_leaves(resumed)
                    + tree_leaves(opt_r.opt_state(resumed))):
        np.testing.assert_array_equal(_as_np(a.detach().view(torch.int16)
                                             if a.dtype == torch.bfloat16
                                             else a.detach()),
                                      _as_np(b.detach().view(torch.int16)
                                             if b.dtype == torch.bfloat16
                                             else b.detach()))


def _port_zero_pack(opt, params):
    from apex_tpu_torch.parallel import get_mesh

    pack = {"opt": opt.opt_state(params), "params": params}
    return pack, build_spec(pack, mesh=get_mesh(),
                            zero_states=[("opt", opt, params)])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_zero_checkpoint_crosses_the_packages(world1, jax_zero, tmp_path,
                                              writer):
    """A flat-bucket ZeRO train state written by one package (the JAX
    package at dp 4, sharded; the port at one rank, flat) restores,
    resharded onto the other's world, and its logical view (every bucket
    group unflattened to its leaves) is the written one bit for bit."""
    from apex_tpu_torch.resilience import reshard

    opt, params, _ = _port_zero(False, True)
    pack, spec = _port_zero_pack(opt, params)
    jopt, jp, js, _ = jax_zero[(False, True)]
    src = str(tmp_path / "src")
    dst = str(tmp_path / "dst")
    if writer == "jax":
        try:
            mesh = jparallel.initialize_model_parallel(
                devices=jax.devices()[:4])
            jpack = {"opt": js, "params": jp}
            jck.save_checkpoint_sharded(
                src, jpack, step=2,
                spec=jreshard.build_spec(jpack, mesh=mesh,
                                         zero_states=[("opt", jopt, jp)]))
        finally:
            jparallel.destroy_model_parallel()
        restored, at = restore_resharded(src, pack, spec)
        assert at == 2
        for a, b in zip(tree_leaves(restored), tree_leaves(pack)):
            assert a.shape == b.shape and a.dtype == b.dtype
        ckpt.save_checkpoint(dst, restored, step=2, spec=spec)
    else:
        ckpt.save_checkpoint(src, pack, step=2, spec=spec)
        try:
            mesh = jparallel.initialize_model_parallel(
                devices=jax.devices()[:4])
            jpack = {"opt": js, "params": jp}
            jspec = jreshard.build_spec(jpack, mesh=mesh,
                                        zero_states=[("opt", jopt, jp)])
            restored, at = jreshard.restore_resharded(src, jpack, jspec)
            assert at == 2
            jck.save_checkpoint_sharded(dst, restored, step=2, spec=jspec)
        finally:
            jparallel.destroy_model_parallel()
    a, _ = reshard.load_logical(src)
    b, _ = reshard.load_logical(dst)
    assert sorted(a) == sorted(b)
    assert any("[" in key for key in a)          # the groups' leaves
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
