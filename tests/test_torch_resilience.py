"""The port's crash-safe checkpointing, driven by its fault injection:
the twins of ``tests/test_resilience.py`` at one rank, torch tensors
where the reference has JAX arrays (its ZeRO case on a one-rank gloo
group).

Checksummed atomic writes, ``verify_checkpoint`` catching bit flips and
torn files, ``CheckpointManager`` retention, retry with backoff and
``restore_latest``'s fallback past corruption with a bit-identical
resumed step, the async writer's failure re-raised (a dropped handle
cannot fake durability), the concurrent sharded-save cleanup race, and
SIGTERM preemption with its drain.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from apex_tpu_torch import checkpoint as ckpt
from apex_tpu_torch.amp._tree import tree_leaves
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.resilience import CheckpointManager, PreemptionGuard
from apex_tpu_torch.testing import faults
from torch_threads import one_torch_thread  # noqa: F401
from torch_world import world1  # noqa: F401


def _leaves_equal(a, b):
    for x, y in zip(ckpt._leaves_with_path(a), ckpt._leaves_with_path(b)):
        assert torch.equal(torch.as_tensor(x[1]), torch.as_tensor(y[1])), \
            ckpt._path_str(x[0])


def _rewrite(path, edit):
    """Rewrite a flat checkpoint with ``edit(manifest)`` applied."""
    with np.load(path, allow_pickle=False) as data:
        manifest = json.loads(str(data["__manifest__"]))
        arrays = {k: data[k] for k in data.files if k != "__manifest__"}
    edit(manifest)
    with open(path, "wb") as f:
        np.savez(f, __manifest__=json.dumps(manifest), **arrays)


# ---------------------------------------------------------------------------
# verify_checkpoint
# ---------------------------------------------------------------------------


def test_manifest_carries_checksums(tmp_path):
    path = str(tmp_path / "c.npz")
    ckpt.save_checkpoint(path, {"w": torch.arange(8.0), "n": np.arange(4)},
                         step=3)
    manifest = ckpt.verify_checkpoint(path)
    assert manifest["step"] == 3
    assert set(manifest["checksums"]) == {"leaf_0", "leaf_1"}


@pytest.mark.parametrize("mode", ["bitflip", "truncate"])
def test_verify_detects_corruption(tmp_path, mode):
    path = str(tmp_path / "c.npz")
    ckpt.save_checkpoint(path, {"w": torch.arange(512.0)}, step=1)
    faults.corrupt_checkpoint(path, mode=mode)
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.verify_checkpoint(path)


def test_verify_detects_checksum_mismatch_with_valid_zip(tmp_path):
    """A well-formed archive whose recorded checksum lies is caught by the
    manifest crc32 though zipfile's own CRC is happy."""
    path = str(tmp_path / "c.npz")
    ckpt.save_checkpoint(path, {"w": torch.arange(4.0)}, step=1)

    def lie(manifest):
        manifest["checksums"]["leaf_0"] ^= 0xFFFF

    _rewrite(path, lie)
    with pytest.raises(ckpt.CheckpointCorruptError, match="checksum"):
        ckpt.verify_checkpoint(path)


def test_verify_sharded(tmp_path):
    d = str(tmp_path / "s")
    w = torch.arange(64.0).reshape(8, 8)
    ckpt.save_checkpoint_sharded(d, {"w": w}, step=5)
    manifest = ckpt.verify_checkpoint_sharded(d)
    assert manifest["step"] == 5
    faults.corrupt_checkpoint(d)  # hits shard_0.npz
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.verify_checkpoint_sharded(d)


# ---------------------------------------------------------------------------
# CheckpointManager: retention, retry, fallback, bit-exact resume
# ---------------------------------------------------------------------------


def test_manager_retention_keeps_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "m"), keep=2)
    for s in range(5):
        mgr.save({"w": torch.full((4,), float(s))}, s)
    assert mgr.all_steps() == [3, 4]


def test_manager_step_paths_grow_past_eight_digits(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "m"), keep=3)
    mgr.save({"w": torch.ones(2)}, 7)
    mgr.save({"w": torch.ones(2)}, 123456789)
    assert os.path.basename(mgr.step_path(123456789)) == "step_123456789.npz"
    assert mgr.all_steps() == [7, 123456789]


def test_manager_retry_with_backoff(tmp_path):
    root = str(tmp_path / "m")
    mgr = CheckpointManager(root, keep=2, retries=3, backoff_s=0.01)
    with faults.transient_os_errors(2, path_prefix=root) as counter:
        mgr.save({"w": torch.ones(3)}, 0)
    assert counter.failed == 2
    mgr.verify(0)

    with faults.transient_os_errors(10, path_prefix=root):
        with pytest.raises(OSError):
            mgr.save({"w": torch.ones(3)}, 1)  # budget exhausted


@pytest.mark.parametrize("mode", ["bitflip", "truncate"])
def test_restore_latest_falls_back_and_resumes_bit_exact(tmp_path, mode):
    """Corrupt the newest checkpoint: ``restore_latest`` detects it by
    checksum, falls back to the previous intact one, and the step resumed
    from there is bit-identical to the uninterrupted run's."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(16, 8, generator=gen)
    w = torch.randn(8, 4, generator=gen).requires_grad_(True)
    params = {"w": w}
    opt = FusedAdam(tree_leaves(params), lr=1e-2)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = ((x @ params["w"]) ** 2).mean()
        loss.backward()
        opt.step()
        return loss.detach()

    def state():
        return {"p": params, "s": opt.opt_state(params)}

    mgr = CheckpointManager(str(tmp_path / "m"), keep=3)
    losses = []
    for i in range(4):
        losses.append(step())
        mgr.save(state(), i)
    final = {k: v.clone() for k, v in opt.state[w].items()}
    w_final = w.detach().clone()

    faults.corrupt_checkpoint(mgr._path(3), mode=mode)
    restored, at = mgr.restore_latest(state())
    assert at == 2  # fell back past the damaged step 3
    with torch.no_grad():
        w.copy_(restored["p"]["w"])
    opt.load_opt_state(params, restored["s"], step_on_device=False)
    assert torch.equal(step(), losses[3])
    assert torch.equal(w.detach(), w_final)
    for k, v in final.items():
        assert torch.equal(opt.state[w][k], v), k


def test_restore_latest_sharded_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "m"), keep=3, sharded=True)
    for s in range(2):
        mgr.save({"w": torch.full((8, 4), float(s))}, s)
    faults.corrupt_checkpoint(mgr._path(1))
    restored, at = mgr.restore_latest({"w": torch.zeros(8, 4)})
    assert at == 0
    assert torch.equal(restored["w"], torch.zeros(8, 4))


def test_restore_latest_no_intact_checkpoint_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "m"), keep=3)
    with pytest.raises(FileNotFoundError):
        mgr.restore_latest({"w": torch.zeros(2)})
    mgr.save({"w": torch.ones(2)}, 0)
    faults.corrupt_checkpoint(mgr._path(0))
    with pytest.raises(FileNotFoundError, match="no intact"):
        mgr.restore_latest({"w": torch.zeros(2)})


def test_zero_sharded_optimizer_state_rides_manager(world1, tmp_path):
    """A flat-bucket ZeRO optimizer's state checkpoints and falls back
    through the manager like any tree, and stepping the restored state
    reproduces the step after it bit for bit."""
    from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam

    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(13, 7, generator=gen).requires_grad_()}
    opt = DistributedFusedAdam(tree_leaves(params), lr=1e-2, n_buckets=2)
    grad = torch.full((13, 7), 1e-3)

    def step():
        params["w"].grad = grad.clone()
        opt.step()

    def state():
        return {"p": params, "s": opt.opt_state(params)}

    def snapshot():
        return [x.detach().clone() for x in tree_leaves(state())]

    mgr = CheckpointManager(str(tmp_path / "m"), keep=2, sharded=True)
    step()
    state1 = snapshot()
    mgr.save(state(), 0)
    step()
    state2 = snapshot()
    mgr.save(state(), 1)

    faults.corrupt_checkpoint(mgr._path(1))
    restored, at = mgr.restore_latest(state())
    assert at == 0
    for a, b in zip(tree_leaves(restored), state1):
        assert torch.equal(a, b)
    with torch.no_grad():
        params["w"].copy_(restored["p"]["w"])
    opt.load_opt_state(params, restored["s"], step_on_device=False)
    step()
    for a, b in zip(tree_leaves(state()), state2):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Async writer failures: no silent non-durable saves
# ---------------------------------------------------------------------------


def _wait_done(handle, timeout=30.0):
    t0 = time.monotonic()
    while not handle.done():
        if time.monotonic() - t0 > timeout:
            raise TimeoutError("async write never finished")
        time.sleep(0.01)


def test_async_write_failure_reraised_on_next_save(tmp_path):
    path = str(tmp_path / "a.npz")
    tree = {"w": torch.arange(4.0)}
    with faults.transient_os_errors(1, path_prefix=str(tmp_path)):
        fut = ckpt.save_checkpoint_async(path, tree, step=0)
        _wait_done(fut)  # failed in the background; handle dropped
    with pytest.raises(RuntimeError, match="NOT durable"):
        ckpt.save_checkpoint_async(path, tree, step=1)
    fut = ckpt.save_checkpoint_async(path, tree, step=2)
    assert fut.result(timeout=30) == path
    assert ckpt.verify_checkpoint(path)["step"] == 2


def test_async_sharded_write_failure_reraised_on_next_save(tmp_path):
    d = str(tmp_path / "s")
    tree = {"w": torch.arange(4.0)}
    with faults.transient_os_errors(1, path_prefix=d):
        handle = ckpt.save_checkpoint_sharded_async(d, tree, step=0)
        _wait_done(handle)
    with pytest.raises(RuntimeError, match="NOT durable"):
        ckpt.save_checkpoint_sharded_async(d, tree, step=1)
    handle = ckpt.save_checkpoint_sharded_async(d, tree, step=2)
    handle.finalize(timeout=30)
    assert ckpt.verify_checkpoint_sharded(d)["step"] == 2


def test_manager_async_failure_raises_on_wait_and_falls_back(tmp_path):
    root = str(tmp_path / "m")
    mgr = CheckpointManager(root, keep=3, retries=0)
    mgr.save({"w": torch.ones(3)}, 0)
    with faults.transient_os_errors(1, path_prefix=root):
        handle = mgr.save_async({"w": torch.full((3,), 2.0)}, 1)
        _wait_done(handle)
        with pytest.raises(OSError):
            mgr.wait()
    restored, at = mgr.restore_latest({"w": torch.zeros(3)})
    assert at == 0
    assert torch.equal(restored["w"], torch.ones(3))
    # the failure was observed (raised from wait): a retry of the same
    # step must not trip the dropped-handle guard
    mgr.save_async({"w": torch.full((3,), 2.0)}, 1)
    mgr.wait()
    restored, at = mgr.restore_latest({"w": torch.zeros(3)})
    assert at == 1
    assert torch.equal(restored["w"], torch.full((3,), 2.0))


def test_dropped_handle_failure_fires_across_step_paths(tmp_path):
    """The dropped-handle guard fires on the next save to a sibling
    destination (same parent directory)."""
    tree = {"w": torch.arange(4.0)}
    with faults.transient_os_errors(1, path_prefix=str(tmp_path)):
        fut = ckpt.save_checkpoint_async(
            str(tmp_path / "step_7.npz"), tree, step=7)
        _wait_done(fut)
    with pytest.raises(RuntimeError, match="NOT durable"):
        ckpt.save_checkpoint_async(str(tmp_path / "step_8.npz"), tree,
                                   step=8)


def test_sync_save_surfaces_then_supersedes_async_failure(tmp_path):
    path = str(tmp_path / "a.npz")
    tree = {"w": torch.arange(4.0)}
    with faults.transient_os_errors(1, path_prefix=str(tmp_path)):
        fut = ckpt.save_checkpoint_async(path, tree, step=0)
        _wait_done(fut)
    with pytest.raises(RuntimeError, match="NOT durable"):
        ckpt.save_checkpoint(path, tree, step=1)
    ckpt.save_checkpoint(path, tree, step=1)  # surfaced: retry is clean
    fut = ckpt.save_checkpoint_async(path, tree, step=2)
    assert fut.result(timeout=30) == path
    assert ckpt.verify_checkpoint(path)["step"] == 2


def test_hung_writer_leaves_no_torn_checkpoint(tmp_path):
    """While an async writer hangs, nothing of the new save is visible
    and the previous checkpoint restores."""
    root = str(tmp_path / "m")
    mgr = CheckpointManager(root, keep=3)
    mgr.save({"w": torch.ones(3)}, 0)
    with faults.hung_writes(path_prefix=root) as gate:
        handle = mgr.save_async({"w": torch.full((3,), 9.0)}, 1)
        assert gate.entered.wait(timeout=30)
        restored, at = mgr.restore_latest({"w": torch.zeros(3)})
        assert at == 0
        gate.release()
        handle.result(timeout=30)
    mgr.wait()
    restored, at = mgr.restore_latest({"w": torch.zeros(3)})
    assert at == 1


# ---------------------------------------------------------------------------
# Concurrent sharded saves against the stale-shard cleanup
# ---------------------------------------------------------------------------


def test_cleanup_spares_in_flight_shards_and_temps(tmp_path):
    d = str(tmp_path / "s")
    tree = {"w": torch.arange(8.0)}
    ckpt.save_checkpoint_sharded(d, tree, step=0)
    import shutil

    shutil.copy(os.path.join(d, "shard_0.npz"),
                os.path.join(d, "shard_3.npz"))
    tmp_name = os.path.join(d, "shard_0.npz.tmp.deadbeef")
    with open(tmp_name, "wb") as f:
        f.write(b"partial bytes")

    ckpt._clean_stale_shards(d)
    assert os.path.exists(os.path.join(d, "shard_3.npz")), \
        "cleanup deleted a shard an in-flight save just wrote"
    assert os.path.exists(tmp_name), "cleanup touched a young temp file"

    manifest_mtime = os.path.getmtime(os.path.join(d, "manifest.json"))
    os.utime(os.path.join(d, "shard_3.npz"),
             (manifest_mtime - 10, manifest_mtime - 10))
    ckpt._clean_stale_shards(d)
    assert not os.path.exists(os.path.join(d, "shard_3.npz"))
    os.unlink(tmp_name)


def test_two_overlapping_sharded_handles(tmp_path):
    """Two in-flight handles to one directory: in-order finalize gives a
    consistent checkpoint; an out-of-order finalize is detected."""
    d = str(tmp_path / "s")
    t1 = {"w": torch.full((4,), 1.0)}
    t2 = {"w": torch.full((4,), 2.0)}
    with faults.hung_writes(path_prefix=d) as gate:
        h1 = ckpt.save_checkpoint_sharded_async(d, t1, step=1)
        assert gate.entered.wait(timeout=30)
        gate.release()
        h1.result(timeout=30)
    h2 = ckpt.save_checkpoint_sharded_async(d, t2, step=2)
    h2.finalize(timeout=30)
    assert ckpt.verify_checkpoint_sharded(d)["step"] == 2
    restored, at = ckpt.restore_checkpoint_sharded(d, {"w": torch.zeros(4)})
    assert at == 2
    assert torch.equal(restored["w"], torch.full((4,), 2.0))
    h1.finalize(timeout=30)  # stale commit over newer shard bytes
    with pytest.raises(ckpt.CheckpointCorruptError, match="overlapping"):
        ckpt.verify_checkpoint_sharded(d)


# ---------------------------------------------------------------------------
# Preemption
# ---------------------------------------------------------------------------


def test_preemption_guard_catches_sigterm_and_drains(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "m"), keep=2)
    with PreemptionGuard() as guard:
        assert not guard.triggered
        mgr.save_async({"w": torch.ones(3)}, 0)
        faults.simulate_sigterm()
        assert guard.triggered
        mgr.wait()
        mgr.save({"w": torch.full((3,), 2.0)}, 1)
    restored, at = mgr.restore_latest({"w": torch.zeros(3)})
    assert at == 1
    assert torch.equal(restored["w"], torch.full((3,), 2.0))


def test_preemption_guard_off_main_thread_falls_back():
    """A guard built off the main thread degrades to the programmatic
    ``trigger()``; an uncatchable signal on the main thread still
    raises."""
    out = {}

    def build():
        try:
            out["guard"] = PreemptionGuard()
        except BaseException as e:
            out["error"] = e

    t = threading.Thread(target=build)
    t.start()
    t.join(timeout=10)
    assert "error" not in out, repr(out.get("error"))
    guard = out["guard"]
    assert guard.signals_installed is False
    assert not guard.triggered
    guard.trigger()
    assert guard.triggered
    guard.uninstall()
    with PreemptionGuard() as main_guard:
        assert main_guard.signals_installed is True
    import signal as _signal

    with pytest.raises((ValueError, OSError)):
        PreemptionGuard(signals=(_signal.SIGKILL,))


def test_poison_grads_hits_one_leaf_at_its_step():
    """``poison_grads`` fills leaf ``leaf`` (JAX order: keys sorted) with
    the chosen value at ``at_step`` only, the same as the reference's."""
    import jax.numpy as jnp

    from apex_tpu.testing import faults as jfaults

    grads = {"b": np.arange(3.0, dtype=np.float32),
             "a": np.ones((2, 2), np.float32)}
    for step in (1, 2):
        for kind in ("nan", "inf", "-inf"):
            got = faults.poison_grads(
                {k: torch.from_numpy(v) for k, v in grads.items()},
                step=torch.tensor(step), at_step=2, kind=kind, leaf=1)
            want = jfaults.poison_grads(
                {k: jnp.asarray(v) for k, v in grads.items()},
                step=step, at_step=2, kind=kind, leaf=1)
            for k in grads:
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]))
