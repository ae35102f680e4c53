"""The port's restore-anywhere layer: the twins of
``tests/test_reshard.py`` at one rank.  Its ZeRO cases cross the
packages: a ZeRO train state the JAX package saved at dp 4 or dp 2
(flat buckets, whose rows are padded to a multiple of ``world *
n_buckets``, and per-leaf padded ravels) restores at the port's one rank
through the manager, with the target spec or with a bare ``mesh=`` spec
that takes the source's group and axes records, and the re-saved
checkpoint's ``load_logical`` view equals the source's bit for bit.

``ShardingSpec`` JSON round trip and validation errors that name the
field (corruption-class, so ``restore_latest`` falls back past a bad
spec); folded layer stacks (``[vpp, pp, ...]``) re-factored across a
pipeline-depth change by reshape; the manifest's back-compat (a
version-1, spec-less manifest restores onto its own shapes, a newer one
is corruption-class, a shape-mismatched spec-less one fails naming the
missing ``sharding_spec``); retention counting only committed steps and
pinning the in-flight and the restoring step; and the fallback-depth
counter.  The spec's per-leaf axes against the reference's and the
restores across four ranks are in ``test_torch_checkpoint.py``.
"""

import json
import os

import numpy as np
import pytest
import torch

from apex_tpu_torch import checkpoint as ckpt
from apex_tpu_torch.optimizers._common import OptState
from apex_tpu_torch.resilience import CheckpointManager, reshard
from apex_tpu_torch.testing import faults
from apex_tpu_torch.transformer.tensor_parallel.partition import (
    PartitionSpec as P,
)
from apex_tpu_torch.transformer.testing.gpt_parallel_train import (
    GPT3DParams,
    gpt3d_logical_folds,
)
from torch_threads import one_torch_thread  # noqa: F401
from torch_world import world1  # noqa: F401


def _rewrite(path, edit):
    with np.load(path, allow_pickle=False) as data:
        manifest = json.loads(str(data["__manifest__"]))
        arrays = {k: data[k] for k in data.files if k != "__manifest__"}
    edit(manifest)
    with open(path, "wb") as f:
        np.savez(f, __manifest__=json.dumps(manifest), **arrays)


def _gpt_pack(vpp=1, pp=2, seed=0):
    """A small GPT train state ``{"params", "opt", "sent"}`` with the
    layer stack ``[vpp, pp, ...]``, and its folded spec."""
    gen = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=gen)

    params = GPT3DParams(
        embedding={"word_embeddings": {"embedding": r(16, 4)}},
        layers={"mlp": {"kernel": r(vpp, pp, 8, 4), "bias": r(vpp, pp, 8)}},
        final_ln={"scale": r(4), "bias": r(4)})
    zeros = GPT3DParams(*(
        {k: (torch.zeros_like(v) if isinstance(v, torch.Tensor) else
             {kk: torch.zeros_like(vv) for kk, vv in v.items()})
         for k, v in part.items()} for part in params))
    pack = {"params": params,
            "opt": OptState(step=torch.tensor(3, dtype=torch.int32),
                            slots={"exp_avg": zeros, "exp_avg_sq": zeros},
                            master=None),
            "sent": {"skipped": torch.tensor(0, dtype=torch.int32)}}
    return pack, reshard.build_spec(pack, folds=gpt3d_logical_folds(pack))


# ---------------------------------------------------------------------------
# ShardingSpec: build / serialize / validate
# ---------------------------------------------------------------------------


def test_spec_json_roundtrip():
    pack, spec = _gpt_pack()
    doc = json.loads(json.dumps(spec.to_json()))  # through real JSON
    back = reshard.ShardingSpec.from_json(doc)
    assert back.to_json() == spec.to_json()
    folded = sorted(p for p, rec in spec.leaves.items() if rec.get("fold"))
    assert folded == sorted(
        f"{top}/.layers/mlp/{k}" for k in ("bias", "kernel")
        for top in ("opt/.slots/exp_avg", "opt/.slots/exp_avg_sq",
                    "params"))
    assert all(spec.leaves[p]["fold"] == 2 for p in folded)


def test_spec_records_trailing_partition_specs_and_the_pipeline_dim():
    """A PartitionSpec names a leaf's trailing dims: ``build_spec`` pads
    it with ``None`` in front and puts the pipeline axis on the ``[vpp,
    pp]`` dim of a folded stack, the reference's ``P(None, "pp", ...)``;
    a leaf with no spec records no axes."""
    pack, _ = _gpt_pack()
    specs = {"params": GPT3DParams(
        embedding={"word_embeddings": {"embedding": P("tp", None)}},
        layers={"mlp": {"kernel": P("tp", None), "bias": P("tp")}},
        final_ln=P()), "opt": None, "sent": P()}
    spec = reshard.build_spec(pack, folds=gpt3d_logical_folds(pack),
                              specs=specs)
    leaves = spec.leaves
    assert leaves["params/.embedding/word_embeddings/embedding"] == {
        "axes": [["tp"], None]}
    assert leaves["params/.layers/mlp/kernel"] == {
        "axes": [None, ["pp"], ["tp"], None], "fold": 2}
    assert leaves["params/.layers/mlp/bias"] == {
        "axes": [None, ["pp"], ["tp"]], "fold": 2}
    assert leaves["params/.final_ln/scale"] == {"axes": [None]}
    assert leaves["sent/skipped"] == {"axes": []}
    assert leaves["opt/.slots/exp_avg/.layers/mlp/kernel"] == {"fold": 2}
    assert "opt/.step" not in leaves


@pytest.mark.parametrize("doc, names", [
    ("not-a-dict", ["not an object"]),
    ({"version": 99, "leaves": {}, "groups": {}}, ["version", "99"]),
    ({"version": 1, "groups": {}}, ["leaves", "missing"]),
    ({"version": 1, "leaves": {}}, ["groups", "missing"]),
])
def test_spec_validation_names_the_field(doc, names):
    with pytest.raises(ckpt.CheckpointCorruptError) as e:
        reshard.ShardingSpec.from_json(doc)
    for frag in names:
        assert frag in str(e.value)


def _port_zero_pack(flat_bucket=True, seed=1):
    """A small ZeRO train state at this process's one rank: parameters
    and a ``DistributedFusedAdam`` state (two buckets), its spec with
    ``zero_states``."""
    from apex_tpu_torch.amp._tree import tree_leaves
    from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam
    from apex_tpu_torch.parallel import get_mesh, zero_init

    gen = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(13, 7, generator=gen),
              "b": torch.arange(7.0) * 0.25}
    opt = DistributedFusedAdam(tree_leaves(params), lr=1e-2,
                               flat_bucket=flat_bucket, n_buckets=2)
    pack = {"params": params, "opt": zero_init(opt, params)}
    return pack, reshard.build_spec(pack, mesh=get_mesh(),
                                    zero_states=[("opt", opt, params)])


def _jax_zero_save(root, world, step, flat_bucket=True):
    """The JAX package's ZeRO train state (``test_reshard.py``'s
    ``_zero_pack``) at dp ``world``, saved through its manager; the
    path."""
    import jax
    import jax.numpy as jnp

    from apex_tpu import parallel as jparallel
    from apex_tpu.contrib.optimizers import DistributedFusedAdam as JAdam
    from apex_tpu.parallel.distributed import replicate, zero_init
    from apex_tpu.resilience import CheckpointManager as JManager
    from apex_tpu.resilience import reshard as jreshard

    opt = JAdam(lr=1e-2, flat_bucket=flat_bucket, n_buckets=2)
    try:
        mesh = jparallel.initialize_model_parallel(
            devices=jax.devices()[:world])
        params = replicate({"w": jax.random.normal(jax.random.PRNGKey(0),
                                                   (13, 7)),
                            "b": jnp.arange(7.0) * 0.25}, mesh)
        # moments that are not zero, so the bucket layout shows
        state = zero_init(opt, params, mesh)
        state = state._replace(slots={
            k: jax.tree_util.tree_map(lambda x, i=i: x + 0.5 + i, v)
            for i, (k, v) in enumerate(sorted(state.slots.items()))})
        pack = {"params": params, "opt": state}
        spec = jreshard.build_spec(pack, mesh=mesh,
                                   zero_states=[("opt", opt, params)])
        return JManager(root, sharded=True, spec=spec).save(pack, step)
    finally:
        jparallel.destroy_model_parallel()


def test_zero_spec_names_every_bucket_and_round_trips(world1):
    """Every bucket leaf of the flat-bucket state carries its group, its
    bucket and the dp axis on its rows; the groups hold the leaves'
    shapes; the JSON round trip is exact; a per-leaf state carries
    ``ravel_of``."""
    _, spec = _port_zero_pack()
    doc = json.loads(json.dumps(spec.to_json()))
    assert reshard.ShardingSpec.from_json(doc).to_json() == spec.to_json()
    grouped = {p: rec for p, rec in spec.leaves.items() if "group" in rec}
    assert len(grouped) == 3 * 2      # (exp_avg, exp_avg_sq, master) x K
    for p, rec in grouped.items():
        assert p.startswith("opt/.") and rec["axes"] == [["dp"], None]
    assert spec.groups["opt/master/0"] == {
        "paths": ["opt/.master/0/0", "opt/.master/0/1"], "chunk": 256,
        "n_buckets": 2, "shapes": [[7], [13, 7]]}
    _, leafy = _port_zero_pack(flat_bucket=False)
    assert leafy.leaves["opt/.slots/exp_avg/w"] == {"axes": [["dp"]],
                                                    "ravel_of": [13, 7]}
    assert not leafy.groups


@pytest.mark.parametrize("src_world, flat_bucket",
                         [(4, True), (2, True), (4, False)])
def test_zero_reshard_from_the_reference_bit_exact(world1, tmp_path,
                                                   src_world, flat_bucket):
    """The JAX package's ZeRO state saved at dp ``src_world`` restores at
    one rank through ``restore_latest`` (the buffers are shaped for the
    new world), and re-saved, its logical view is the source's bit for
    bit."""
    src = _jax_zero_save(str(tmp_path / "src"), src_world, 3, flat_bucket)
    like, spec = _port_zero_pack(flat_bucket)
    restored, at = CheckpointManager(
        str(tmp_path / "src"), sharded=True, spec=spec).restore_latest(like)
    assert at == 3
    for (path, a), (_, b) in zip(ckpt._leaves_with_path(restored),
                                 ckpt._leaves_with_path(like)):
        assert a.shape == b.shape, path
    dst = CheckpointManager(str(tmp_path / "dst"), sharded=True,
                            spec=spec).save(restored, 3)
    a, _ = reshard.load_logical(src)
    b, _ = reshard.load_logical(dst)
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_bare_spec_mesh_kwarg_reshards_zero_state(world1, tmp_path):
    """``restore_latest(like, mesh=...)`` with no spec of its own: the
    bare target spec takes the source's group records and axes (names,
    not sizes), so the flat buckets still reshard."""
    from apex_tpu_torch.parallel import get_mesh

    root = str(tmp_path / "m")
    src = _jax_zero_save(root, 4, 0)
    like, spec = _port_zero_pack()
    restored, at = CheckpointManager(root, sharded=True).restore_latest(
        like, mesh=get_mesh())
    assert at == 0
    dst = CheckpointManager(str(tmp_path / "m2"), sharded=True,
                            spec=spec).save(restored, 0)
    a, _ = reshard.load_logical(src)
    b, _ = reshard.load_logical(dst)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_manager_embeds_spec_in_manifest(tmp_path):
    pack, spec = _gpt_pack()
    mgr = CheckpointManager(str(tmp_path / "m"), sharded=True, spec=spec)
    mgr.save(pack, 0)
    manifest = mgr.verify(0)
    assert manifest["version"] == ckpt.MANIFEST_VERSION
    assert manifest["sharding_spec"]["version"] == reshard.SPEC_VERSION
    assert manifest["sharding_spec"] == spec.to_json()


# ---------------------------------------------------------------------------
# Resharded restores: folded layer stacks
# ---------------------------------------------------------------------------


def test_mixed_step_shard_dir_is_corruption(tmp_path):
    """A legacy (manifest-less) shard directory holding shards of two
    steps fails as corruption, not a blended state."""
    d = str(tmp_path / "s")
    ckpt.save_checkpoint_sharded(
        d, {"w": torch.arange(16.0).reshape(8, 2)}, step=0)
    import shutil

    shutil.copy(os.path.join(d, "shard_0.npz"),
                os.path.join(d, "shard_1.npz"))

    def later(manifest):
        manifest["step"] = 1

    _rewrite(os.path.join(d, "shard_1.npz"), later)
    os.unlink(os.path.join(d, "manifest.json"))  # legacy layout
    with pytest.raises(ckpt.CheckpointCorruptError, match="mixed"):
        reshard.load_logical(d)


def test_load_logical_propagates_malformed_spec(tmp_path):
    path = str(tmp_path / "c.npz")
    ckpt.save_checkpoint(path, {"w": torch.arange(6.0)}, step=0)
    leaves, _ = reshard.load_logical(path)  # spec-less: plain leaves
    assert list(leaves) == ["w"]

    def bad(manifest):
        manifest["sharding_spec"] = {"version": reshard.SPEC_VERSION,
                                     "leaves": ["not", "a", "dict"],
                                     "groups": {}}

    _rewrite(path, bad)
    with pytest.raises(ckpt.CheckpointCorruptError, match="leaves"):
        reshard.load_logical(path)


@pytest.mark.parametrize("sharded", [False, True], ids=["flat", "sharded"])
def test_folded_layer_stack_refactors(tmp_path, sharded):
    """A ``[vpp, pp, ...]`` stack marked ``fold=2`` restores across a
    pipeline-depth change by reshape: (vpp 1, pp 2) -> (vpp 2, pp 1),
    bit for bit and in virtual-stage-major order, the whole train state
    through ``restore_latest``'s resharded path."""
    pack, spec = _gpt_pack(vpp=1, pp=2)
    root = str(tmp_path / "m")
    CheckpointManager(root, sharded=sharded, spec=spec).save(pack, 4)
    like, spec2 = _gpt_pack(vpp=2, pp=1, seed=1)
    restored, at = CheckpointManager(
        root, sharded=sharded, spec=spec2).restore_latest(like)
    assert at == 4
    for k in ("kernel", "bias"):
        got = restored["params"].layers["mlp"][k]
        want = pack["params"].layers["mlp"][k]
        assert got.shape == like["params"].layers["mlp"][k].shape
        assert torch.equal(got.reshape((2,) + got.shape[2:]),
                           want.reshape((2,) + want.shape[2:]))
    assert torch.equal(restored["params"].final_ln["scale"],
                       pack["params"].final_ln["scale"])
    assert int(restored["opt"].step) == 3
    logical, step = reshard.load_logical(
        CheckpointManager(root, sharded=sharded).step_path(4))
    assert step == 4
    assert logical["params/.layers/mlp/kernel"].shape == (2, 8, 4)


# ---------------------------------------------------------------------------
# Manifest back-compat
# ---------------------------------------------------------------------------


def _downgrade_to_v1(path):
    def v1(manifest):
        manifest["version"] = 1
        manifest.pop("sharding_spec", None)

    _rewrite(path, v1)


def test_legacy_v1_manifest_restores_same_mesh(tmp_path):
    root = str(tmp_path / "m")
    mgr = CheckpointManager(root, keep=3)
    tree = {"w": torch.arange(12.0).reshape(3, 4), "n": torch.ones(2)}
    mgr.save(tree, 0)
    _downgrade_to_v1(mgr._path(0))

    restored, at = ckpt.restore_checkpoint(mgr._path(0), tree)
    assert at == 0
    spec = reshard.build_spec(tree)
    restored, at = CheckpointManager(
        root, keep=3, spec=spec).restore_latest(tree)
    assert at == 0
    assert torch.equal(restored["w"], tree["w"])


def test_legacy_manifest_shape_mismatch_names_missing_spec(tmp_path):
    root = str(tmp_path / "m")
    mgr = CheckpointManager(root, keep=3)
    mgr.save({"w": torch.arange(12.0).reshape(3, 4)}, 0)
    _downgrade_to_v1(mgr._path(0))
    like = {"w": torch.zeros(4, 3)}  # a different layout
    spec = reshard.build_spec(like)
    with pytest.raises(FileNotFoundError, match="sharding_spec"):
        CheckpointManager(root, keep=3, spec=spec).restore_latest(like)


def test_newer_manifest_version_is_corruption_class(tmp_path):
    root = str(tmp_path / "m")
    mgr = CheckpointManager(root, keep=3)
    tree = {"w": torch.arange(4.0)}
    mgr.save(tree, 0)
    mgr.save(tree, 1)

    def newer(manifest):
        manifest["version"] = ckpt.MANIFEST_VERSION + 1

    _rewrite(mgr._path(1), newer)
    with pytest.raises(ckpt.CheckpointCorruptError, match="newer"):
        ckpt.restore_checkpoint(mgr._path(1), tree)
    restored, at = mgr.restore_latest(tree, verify=False)
    assert at == 0


# ---------------------------------------------------------------------------
# Retention: committed-only counting and the pins
# ---------------------------------------------------------------------------


def test_retention_ignores_uncommitted_crash_artifacts(tmp_path):
    root = str(tmp_path / "m")
    mgr = CheckpointManager(root, keep=2, sharded=True)
    tree = {"w": torch.arange(8.0)}
    mgr.save(tree, 0)
    mgr.save(tree, 1)
    for s in (2, 3, 5):
        os.makedirs(mgr._path(s))
        with open(os.path.join(mgr._path(s), "shard_0.npz"), "wb") as f:
            f.write(b"torn")
    mgr.save(tree, 4)
    assert not os.path.exists(mgr._path(0))
    assert mgr.verify(1) and mgr.verify(4)
    assert not os.path.exists(mgr._path(2))
    assert not os.path.exists(mgr._path(3))
    assert os.path.exists(mgr._path(5))
    _, at = mgr.restore_latest(tree)
    assert at == 4


def test_retention_never_deletes_last_committed_under_hung_write(
        tmp_path):
    root = str(tmp_path / "m")
    mgr = CheckpointManager(root, keep=1, sharded=True)
    tree = {"w": torch.arange(8.0)}
    mgr.save(tree, 0)
    with faults.hung_writes(path_prefix=root) as gate:
        handle = mgr.save_async({"w": torch.full((8,), 9.0)}, 1)
        assert gate.entered.wait(timeout=30)
        mgr._apply_retention()
        assert mgr.verify(0)
        assert os.path.exists(mgr._path(1))
        gate.release()
        handle.result(timeout=30)
    mgr.wait()
    _, at = mgr.restore_latest(tree)
    assert at == 1
    assert not os.path.exists(mgr._path(0))


def test_retention_pins_step_a_restore_is_reading(tmp_path):
    root = str(tmp_path / "m")
    mgr = CheckpointManager(root, keep=1, sharded=True)
    tree = {"w": torch.arange(8.0)}
    mgr.save(tree, 0)
    mgr._pinned.add(0)
    try:
        mgr.save(tree, 1)
        assert mgr.verify(0)
    finally:
        mgr._pinned.discard(0)
    mgr.save(tree, 2)
    assert not os.path.exists(mgr._path(0))
    assert not os.path.exists(mgr._path(1))


# ---------------------------------------------------------------------------
# Observability: the fallback-depth counter and the spans
# ---------------------------------------------------------------------------


def test_restore_latest_counts_fallback_depth(tmp_path):
    from apex_tpu_torch.observability.metrics import default_registry

    root = str(tmp_path / "m")
    mgr = CheckpointManager(root, keep=3)
    tree = {"w": torch.arange(64.0)}
    for s in range(3):
        mgr.save({"w": torch.full((64,), float(s))}, s)
    faults.corrupt_checkpoint(mgr._path(2))
    faults.corrupt_checkpoint(mgr._path(1))

    reg = default_registry()
    before = reg.counter("ckpt/fallback_depth").value
    restored, at = mgr.restore_latest(tree)
    assert at == 0
    assert reg.counter("ckpt/fallback_depth").value - before == 2
    assert any(k.startswith("span_ms/checkpoint/restore_latest")
               for k in reg.snapshot())


def test_manager_events_feed_the_goodput_buckets(tmp_path):
    """With a flight recorder armed, the manager's save, async submit,
    verify and restore land as the timeline events the goodput report
    buckets (``checkpoint`` and ``restore``)."""
    from apex_tpu_torch.observability import timeline
    from apex_tpu_torch.observability.goodput import classify_event

    rec = timeline.arm(timeline.FlightRecorder())
    try:
        mgr = CheckpointManager(str(tmp_path / "m"), keep=2)
        mgr.save({"w": torch.ones(2)}, 0)
        mgr.save_async({"w": torch.ones(2)}, 1)
        mgr.wait()
        mgr.restore_latest({"w": torch.zeros(2)})
    finally:
        timeline.disarm()
    kinds = [e["kind"] for e in rec.events()
             if e["kind"].startswith("checkpoint")]
    assert kinds == ["checkpoint_save", "checkpoint_save_async_submit",
                     "checkpoint_verify", "checkpoint_restore"]
    assert [classify_event(e) for e in rec.events()
            if e["kind"] in kinds] == ["checkpoint"] * 3 + ["restore"]


def test_spans_record_and_trace_window_captures(tmp_path):
    """``span`` records ``span_ms/<name>``; ``TraceWindow`` starts a
    capture every ``every_n`` steps for ``capture_steps`` steps, and a
    failing profiler disables it instead of raising; the real
    ``torch.profiler`` window writes its Chrome trace."""
    from apex_tpu_torch.observability.metrics import MetricRegistry
    from apex_tpu_torch.observability.spans import (
        TraceWindow,
        named_span,
        span,
        step_trace,
    )

    reg = MetricRegistry()
    with span("unit/x", registry=reg), named_span("inner"), step_trace(3):
        torch.ones(2).sum()
    assert reg.snapshot()["span_ms/unit/x"]["count"] == 1

    calls = []

    class Fake:
        def start_trace(self, path):
            calls.append(("start", os.path.basename(path)))

        def stop_trace(self):
            calls.append(("stop",))

    win = TraceWindow(str(tmp_path / "t"), every_n=4, capture_steps=2,
                      _profiler=Fake())
    for step in range(10):
        win.on_step(step)
    win.close()
    assert calls == [("start", "step_00000000"), ("stop",),
                     ("start", "step_00000004"), ("stop",),
                     ("start", "step_00000008"), ("stop",)]
    assert win.windows_captured == 3

    class Broken:
        def start_trace(self, path):
            raise RuntimeError("profiler busy")

    bad = TraceWindow(str(tmp_path / "b"), every_n=1, _profiler=Broken())
    bad.on_step(0)
    assert not bad.enabled and not bad.active

    real = TraceWindow(str(tmp_path / "r"), every_n=5, capture_steps=1)
    real.on_step(0)
    torch.ones(4).mul(2)
    real.on_step(1)
    assert os.path.exists(tmp_path / "r" / "step_00000000" / "trace.json")
