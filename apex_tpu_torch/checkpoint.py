"""Checkpoint / resume for full training state (port of
:mod:`apex_tpu.checkpoint`).

A checkpoint is "any tree, restored against a template": dicts (keys
sorted), lists, tuples and NamedTuples of torch tensors, numpy arrays
and Python scalars, ``None`` holding no leaf, as the JAX package's
pytrees.  :func:`save_checkpoint` writes the leaves as host numpy plus a
manifest of tree paths, shapes, dtypes and per-array crc32s;
:func:`restore_checkpoint` reads them back into the structure of a
``like`` tree and casts each leaf to the template's dtype and device.

**The files on disk are the JAX package's.**  A leaf's path is the
reference's ``_path_str`` (a dict key as it is, a NamedTuple field with
a leading dot, ``params/.embedding/word_embeddings/embedding``), the
arrays are ``leaf_{i}`` in the JAX leaf order, the manifest is the same
JSON (``MANIFEST_VERSION = 2``), and the sharded layout is the same
``shard_{r}.npz`` files keyed ``leaf_{i}|start:stop,...`` with a
``manifest.json`` committed last by rank 0 between two barriers.  Either
package reads what the other wrote.  A bf16 leaf is stored as the
reference stores it: its two bytes a value as a ``V2`` array, the
manifest's dtype ``"bfloat16"``; the port reads a leaf by the manifest's
dtype, never by the npz's (numpy has no bf16 of its own).

**Placement.**  A JAX array carries its sharding; a torch tensor does
not.  Here a process is one ``torch.distributed`` rank holding its shard
of each leaf, and the leaf's per-dim mesh axes come from the
:class:`~apex_tpu_torch.resilience.reshard.ShardingSpec` passed as
``spec`` (its ``leaves[path]["axes"]``, built by
:func:`~apex_tpu_torch.resilience.reshard.build_spec` from the
``PartitionSpec`` tree), with the rank's coordinates on the live grid
(:func:`apex_tpu_torch.parallel.initialize_model_parallel`).  A tensor
leaf without axes is whole on every rank.  The sharded save writes each
distinct slice once, from the lowest rank holding it (every coordinate
off the leaf's axes 0: the reference's ``replica_id == 0``), and the
restores give each rank its own slice of a template placed by the same
``spec``.  The barriers are the process group's; none runs at world
size 1 or without a group.

:func:`gather_zero_state` / :func:`scatter_zero_state` turn a ZeRO
optimizer's sharded state into the reference's portable form and back,
at any data-parallel world size.
"""

from __future__ import annotations

import json
import os
import threading
import zlib
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "save_checkpoint",
    "save_checkpoint_async",
    "save_checkpoint_sharded",
    "save_checkpoint_sharded_async",
    "restore_checkpoint",
    "restore_checkpoint_sharded",
    "verify_checkpoint",
    "verify_checkpoint_sharded",
    "CheckpointCorruptError",
    "ShardedSaveHandle",
    "gather_zero_state",
    "scatter_zero_state",
]


class CheckpointCorruptError(ValueError):
    """A checkpoint failed integrity verification (checksum mismatch,
    torn/truncated file, unreadable archive).  Subclasses ``ValueError``
    so ``except ValueError`` restore guards keep working;
    :meth:`apex_tpu_torch.resilience.CheckpointManager.restore_latest`
    catches it to fall back to the previous intact checkpoint."""


# Manifest schema version.  1 = leaves + checksums; 2 adds the optional
# ``sharding_spec`` logical-state description (``resilience/reshard.py``).
# Readers accept anything <= MANIFEST_VERSION and treat a NEWER version as
# corruption-class (an old reader must fall back, not misread).
MANIFEST_VERSION = 2


def _check_manifest_version(manifest: dict, path: str) -> None:
    ver = manifest.get("version", 1)
    if not isinstance(ver, int) or ver > MANIFEST_VERSION:
        raise CheckpointCorruptError(
            f"{path}: manifest version {ver!r} is newer than this reader "
            f"supports ({MANIFEST_VERSION}) — upgrade before restoring")


def _attach_spec(manifest: dict, spec) -> dict:
    """Embed a ShardingSpec (or an already-serialized dict)."""
    if spec is None:
        return manifest
    manifest = dict(manifest)
    manifest["sharding_spec"] = (spec if isinstance(spec, dict)
                                 else spec.to_json())
    return manifest


def _checksum(arr: np.ndarray) -> int:
    """crc32 over a leaf's raw bytes, fed through the buffer protocol
    (``tobytes()`` would double host memory per leaf)."""
    flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return zlib.crc32(flat) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# The tree walk (the JAX package's pytree order and path strings)
# ---------------------------------------------------------------------------


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _leaves_with_path(tree, path=()) -> List[Tuple[tuple, Any]]:
    """``[(path, leaf)]`` in JAX's order: dict keys sorted, NamedTuple
    fields and sequence items in order, ``None`` no leaf.  A path is a
    tuple of ``("key", k)``, ``("attr", name)`` or ``("idx", i)``."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves_with_path(tree[k], path + (("key", k),))
        return out
    if _is_namedtuple(tree):
        out = []
        for f, v in zip(tree._fields, tree):
            out += _leaves_with_path(v, path + (("attr", f),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _leaves_with_path(v, path + (("idx", i),))
        return out
    return [(path, tree)]


def _unflatten(like, leaves: List[Any]):
    """``like``'s structure holding ``leaves`` (in :func:`_leaves_with_path`
    order)."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            new = {k: build(node[k]) for k in sorted(node)}
            return type(node)((k, new[k]) for k in node)
        if _is_namedtuple(node):
            return type(node)(*(build(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def _path_str(path) -> str:
    """The reference's ``_path_str``: a dict key or sequence index as it
    is, a NamedTuple field as ``str(GetAttrKey)`` (``.name``)."""
    return "/".join(f".{v}" if kind == "attr" else str(v)
                    for kind, v in path)


def _tree_paths(tree) -> List[Tuple[str, Any]]:
    return [(_path_str(p), x) for p, x in _leaves_with_path(tree)]


# ---------------------------------------------------------------------------
# Leaves <-> host arrays
# ---------------------------------------------------------------------------


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(np.asarray(x).dtype)


def _shape(x) -> Tuple[int, ...]:
    return tuple(x.shape) if isinstance(x, torch.Tensor) \
        else tuple(np.shape(x))


def _to_host(x, copy: bool = False) -> np.ndarray:
    """One leaf as a host numpy array in its on-disk form (bf16 as ``V2``).
    A CUDA tensor gets a fresh host buffer from the copy; ``copy`` also
    copies leaves whose storage is host memory (a CPU tensor's
    ``.numpy()`` is a view), so the async save's snapshot cannot be
    changed by the caller after the call."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        on_host = t.device.type == "cpu"
        t = t.cpu()
        if t.dtype == torch.bfloat16:
            arr = t.view(torch.int16).numpy().view(np.uint16).view("V2")
        else:
            arr = t.numpy()
        return np.array(arr) if (copy and on_host) else arr
    arr = np.asarray(x)
    return np.array(arr) if copy else arr


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"no torch dtype for checkpoint dtype {name!r}")
    return dt


def _from_host(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A stored array as a CPU tensor, decoded by the manifest's dtype."""
    arr = np.asarray(arr, order="C")  # (keeps a 0-d array 0-d)
    if dtype_name == "bfloat16":
        raw = arr.view(np.uint16).view(np.int16)
        return torch.from_numpy(raw.copy()).view(torch.bfloat16)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr)


def _template_dtype(tleaf):
    """The restored leaf's dtype: the template's (torch or numpy)."""
    if isinstance(tleaf, torch.Tensor):
        return tleaf.dtype
    return np.asarray(tleaf).dtype


def _stored_dtype(arr: np.ndarray) -> str:
    """The dtype name of an array in its stored form (``V2``: bf16)."""
    return "bfloat16" if arr.dtype == np.dtype("V2") else str(arr.dtype)


def _as_template(host: np.ndarray, dtype_name: Optional[str], tleaf):
    """A host array in the template leaf's kind, dtype and device: a
    tensor for a tensor template, numpy otherwise.  ``dtype_name`` is the
    manifest's (``None``: read off the stored form)."""
    t = _from_host(host, dtype_name or _stored_dtype(host))
    if isinstance(tleaf, torch.Tensor):
        return t.to(device=tleaf.device, dtype=tleaf.dtype)
    want = np.asarray(tleaf).dtype
    if t.dtype == torch.bfloat16:
        t = t.float()
    return np.asarray(t.numpy(), dtype=want)


# ---------------------------------------------------------------------------
# Ranks and placement
# ---------------------------------------------------------------------------


def _dist_on() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """The number of ranks (the reference's ``jax.process_count()``)."""
    import torch.distributed as dist

    return dist.get_world_size() if _dist_on() else 1


def process_index() -> int:
    """This rank (the reference's ``jax.process_index()``)."""
    import torch.distributed as dist

    return dist.get_rank() if _dist_on() else 0


def _barrier() -> None:
    if process_count() > 1:
        import torch.distributed as dist

        dist.barrier()


def _grid() -> Tuple[dict, dict]:
    """``(axis sizes, this rank's coordinates)`` of the live grid; both
    empty without one (every axis then has size 1)."""
    from apex_tpu_torch.parallel import mesh as mesh_lib

    if not mesh_lib.model_parallel_is_initialized():
        return {}, {}
    m = mesh_lib.get_mesh()
    return m.shape, dict(m.coords)


def _spec_axes(spec, path: str):
    """The per-dim axes a spec records for ``path`` (None: whole)."""
    if spec is None:
        return None
    leaves = spec.get("leaves") if isinstance(spec, dict) else spec.leaves
    if not isinstance(leaves, dict):
        return None
    return (leaves.get(path) or {}).get("axes")


class _Place:
    """One leaf's place on the grid: its global shape, the slices of it
    this rank holds, and whether this rank is the slice's first replica
    (every coordinate off the leaf's axes 0)."""

    def __init__(self, local_shape, axes, grid, path: str = ""):
        sizes, coords = grid
        local_shape = tuple(int(d) for d in local_shape)
        if axes is not None and len(axes) != len(local_shape):
            raise ValueError(
                f"{path}: sharding axes {axes} do not match rank "
                f"{len(local_shape)}")
        self.global_shape, self.index = [], []
        named = set()
        for d, n_local in enumerate(local_shape):
            names = (axes[d] or []) if axes is not None else []
            count, pos = 1, 0
            for a in names:
                named.add(a)
                size = int(sizes.get(a, 1))
                pos = pos * size + int(coords.get(a, 0))
                count *= size
            self.global_shape.append(n_local * count)
            self.index.append(slice(pos * n_local, (pos + 1) * n_local))
        self.global_shape = tuple(self.global_shape)
        self.index = tuple(self.index)
        self.split = {d: tuple(axes[d]) for d in range(len(local_shape))
                      if axes is not None and axes[d]
                      and int(np.prod([sizes.get(a, 1)
                                       for a in axes[d]])) > 1}
        if coords:
            self.first = all(c == 0 for a, c in coords.items()
                             if a not in named)
        else:
            self.first = process_index() == 0


def _places(flat, spec) -> List[_Place]:
    grid = _grid()
    return [_Place(_shape(x), _spec_axes(spec, _path_str(p)), grid,
                   _path_str(p)) for p, x in flat]


def _gather_full(x: torch.Tensor, place: _Place) -> torch.Tensor:
    """The whole leaf from every rank's shard (all-gathers along its
    split dims, the ``process_allgather`` of the reference)."""
    from apex_tpu_torch.parallel import collectives as cc

    t = x.detach()
    # 16-bit integers (the ZeRO remainders) cross as bf16 bit patterns:
    # gloo moves no int16; a gather copies bytes and computes nothing
    wire = torch.bfloat16 if t.dtype in (torch.int16, torch.uint16) else None
    if wire is not None:
        t = t.view(wire)
    for d, names in sorted(place.split.items()):
        t = cc.all_gather(t.contiguous(), names, concat_axis=d)
    return t if wire is None else t.view(x.dtype)


# ---------------------------------------------------------------------------
# Atomic writes
# ---------------------------------------------------------------------------


def _atomic_write(path, writer) -> str:
    """Crash-safe file write: ``writer(fileobj)`` into a unique temp in
    the target dir, fsync the file before the atomic ``os.replace`` and
    the directory after it (without both, a host preemption can leave the
    rename durable but the data pages not).  The temp is unlinked on any
    failure; ``O_CREAT`` with mode 0o666 lets the umask apply."""
    import uuid

    tmp = f"{path}.tmp.{uuid.uuid4().hex}"
    fd = os.open(tmp, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o666)
    try:
        with os.fdopen(fd, "wb") as f:
            writer(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(os.path.dirname(os.path.abspath(path)))
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def _write_npz(path, manifest, arrays) -> str:
    # every array's crc32 rides in the manifest, so torn or bit-flipped
    # data is detectable at verify/restore time
    manifest = dict(manifest)
    manifest["checksums"] = {k: _checksum(v) for k, v in arrays.items()}
    return _atomic_write(
        path,
        lambda f: np.savez(f, __manifest__=json.dumps(manifest), **arrays))


def _fsync_dir(dirpath: str) -> None:
    """Make a rename durable (no-op where a directory cannot be opened)."""
    try:
        dfd = os.open(dirpath, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(dfd)
    except OSError:
        pass
    finally:
        os.close(dfd)


# ---------------------------------------------------------------------------
# Flat (single-file) checkpoints
# ---------------------------------------------------------------------------


def _snapshot(tree, step, spec=None, copy_host_leaves=False):
    """Every leaf whole on the host (sharded leaves all-gathered over the
    grid, a collective) and the restore-time manifest."""
    flat = _leaves_with_path(tree)
    places = _places(flat, spec)
    arrays = {}
    for i, ((_, x), place) in enumerate(zip(flat, places)):
        if isinstance(x, torch.Tensor) and place.split:
            x = _gather_full(x, place)
            arrays[f"leaf_{i}"] = _to_host(x)
        else:
            arrays[f"leaf_{i}"] = _to_host(x, copy=copy_host_leaves)
    manifest = {
        "version": MANIFEST_VERSION,
        "step": step,
        "leaves": [
            {"path": _path_str(p), "shape": list(arrays[f"leaf_{i}"].shape),
             "dtype": _dtype_name(x)}
            for i, (p, x) in enumerate(flat)
        ],
    }
    return arrays, manifest


def save_checkpoint(path: str, tree: Any, step: Optional[int] = None,
                    spec=None) -> None:
    """Write ``tree`` to ``path`` (.npz): the leaves on the host with a
    manifest of tree paths, shapes, dtypes and crc32s.  ``spec`` (a
    ShardingSpec) is embedded as the logical-state description and, at
    world size > 1, says how each leaf is split, so it is gathered whole.

    Several ranks: call from every rank (the gather is a collective);
    rank 0 writes the file, and a barrier orders the write before any
    rank returns."""
    _reraise_pending_failure(path)
    arrays, manifest = _snapshot(tree, step, spec)
    manifest = _attach_spec(manifest, spec)
    if process_index() == 0:
        _write_npz(path, manifest, arrays)
    _clear_write_failure(path)
    _barrier()


def save_checkpoint_async(path: str, tree: Any,
                          step: Optional[int] = None, spec=None):
    """Overlapped checkpointing: the copy to the host runs on the
    caller's thread (the next step may overwrite the tensors as soon as
    this returns), the serialization and disk write on a background
    thread.  Returns a handle with ``result()`` (waits; re-raises a write
    error) and ``done()``.  Single rank only: a save over several ranks
    needs :func:`save_checkpoint`'s collective gather (or the gather-free
    :func:`save_checkpoint_sharded_async`)."""
    if process_count() > 1:
        raise ValueError(
            "save_checkpoint_async is single-process; multi-host saves "
            "need the collective gather of save_checkpoint (or the "
            "gather-free save_checkpoint_sharded_async)")
    _reraise_pending_failure(path)
    arrays, manifest = _snapshot(tree, step, spec, copy_host_leaves=True)
    manifest = _attach_spec(manifest, spec)
    return _submit_write(path, manifest, arrays, "async checkpoint")


# Failed background writes, keyed by destination (file path or sharded
# dir): the next save to the same destination, or to a sibling in the
# same directory, re-raises a failure nobody waited on.
_FAILED_WRITES: dict = {}
_FAILED_WRITES_LOCK = threading.Lock()


def _record_write_failure(key: str, exc: BaseException) -> None:
    with _FAILED_WRITES_LOCK:
        _FAILED_WRITES[key] = exc


def _clear_write_failure(key: str) -> None:
    """Cleared once observed (``result()`` re-raised it) or superseded (a
    later durable save to the same destination)."""
    with _FAILED_WRITES_LOCK:
        _FAILED_WRITES.pop(key, None)


def _reraise_pending_failure(dest: str) -> None:
    """Surface a recorded unobserved failure before a new save to
    ``dest`` or to a sibling destination (same parent directory): the
    step-indexed layouts write each save to a fresh path."""
    parent = os.path.dirname(os.path.abspath(dest))
    with _FAILED_WRITES_LOCK:
        key = next(
            (k for k in _FAILED_WRITES
             if k == dest or os.path.dirname(os.path.abspath(k)) == parent),
            None)
        exc = _FAILED_WRITES.pop(key, None) if key is not None else None
    if exc is not None:
        raise RuntimeError(
            f"a previous async checkpoint write to {key!r} failed and was "
            "never waited on — the checkpoint there is NOT durable"
        ) from exc


class _TrackedFuture:
    """A future that clears the destination's failure record when the
    failure is delivered through ``result()`` (a timeout is not a
    delivery)."""

    def __init__(self, future, key):
        self._future = future
        self._key = key

    def done(self) -> bool:
        return self._future.done()

    def result(self, timeout=None):
        import concurrent.futures

        try:
            return self._future.result(timeout)
        except (TimeoutError, concurrent.futures.TimeoutError):
            raise
        except BaseException:
            _clear_write_failure(self._key)
            raise


def _submit_write(path, manifest, arrays, label, failure_key=None):
    """Background write on a single-use worker: a failure is logged from
    the worker, re-raised by the handle's ``result()`` and recorded under
    ``failure_key`` for the next save to the same destination."""
    import concurrent.futures

    key = failure_key if failure_key is not None else path

    def _write_logged():
        try:
            return _write_npz(path, manifest, arrays)
        except BaseException as e:
            import logging

            logging.getLogger(__name__).exception(
                "%s write to %r failed", label, path)
            _record_write_failure(key, e)
            raise

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    future = pool.submit(_write_logged)
    pool.shutdown(wait=False)
    return _TrackedFuture(future, key)


def _validate_template(manifest, like, spec=None):
    """The restore-time template check (leaf count, per-leaf path and
    global shape).  Returns ``(like_flat, places)``."""
    flat = _leaves_with_path(like)
    if len(flat) != len(manifest["leaves"]):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, template "
            f"has {len(flat)}")
    places = _places(flat, spec)
    for i, (rec, (p, _), place) in enumerate(
            zip(manifest["leaves"], flat, places)):
        tpath = _path_str(p)
        if rec["path"] != tpath:
            raise ValueError(
                f"leaf {i} path mismatch: checkpoint {rec['path']!r} vs "
                f"template {tpath!r}")
        if tuple(rec["shape"]) != place.global_shape:
            raise ValueError(
                f"{tpath}: checkpoint shape {rec['shape']} vs template "
                f"{list(place.global_shape)}")
    return [x for _, x in flat], places


def restore_checkpoint(path: str, like: Any, spec=None):
    """Read a checkpoint into the structure of ``like``; returns ``(tree,
    step)``.  Leaf count and per-leaf paths and shapes must match the
    template; each leaf is cast to the template's dtype (and a tensor
    moved to its device).  With ``spec`` a template leaf is this rank's
    shard, and the rank gets its slice."""
    with np.load(path, allow_pickle=False) as data:
        manifest = json.loads(str(data["__manifest__"]))
        _check_manifest_version(manifest, path)
        leaves = [data[f"leaf_{i}"] for i in range(len(manifest["leaves"]))]

    like_flat, places = _validate_template(manifest, like, spec)
    out = [_as_template(arr[place.index] if place.split else arr,
                        rec["dtype"], tleaf)
           for arr, rec, tleaf, place in zip(
               leaves, manifest["leaves"], like_flat, places)]
    return _unflatten(like, out), manifest["step"]


def _verify_npz(path: str) -> dict:
    """Integrity-check one ``.npz``: the archive readable and every array
    matching its manifest crc32.  Returns the manifest; raises
    :class:`CheckpointCorruptError` on any damage.  A checkpoint without
    checksums verifies structurally only."""
    try:
        with np.load(path, allow_pickle=False) as data:
            manifest = json.loads(str(data["__manifest__"]))
            _check_manifest_version(manifest, path)
            sums = manifest.get("checksums")
            keys = [k for k in data.files if k != "__manifest__"]
            for key in keys:
                arr = data[key]  # zipfile's own CRC also trips here
                if sums is not None:
                    want = sums.get(key)
                    if want is None:
                        raise CheckpointCorruptError(
                            f"{path}: array {key!r} missing from the "
                            "checksum manifest")
                    got = _checksum(arr)
                    if got != want:
                        raise CheckpointCorruptError(
                            f"{path}: checksum mismatch on {key!r} "
                            f"(stored {want}, recomputed {got})")
            if sums is not None and set(sums) - set(keys):
                raise CheckpointCorruptError(
                    f"{path}: arrays missing from archive: "
                    f"{sorted(set(sums) - set(keys))}")
    except CheckpointCorruptError:
        raise
    except Exception as e:
        # BadZipFile, zlib.error, OSError on a truncated read, a torn
        # manifest's JSON: all corruption here
        raise CheckpointCorruptError(f"{path}: unreadable ({e!r})") from e
    return manifest


def verify_checkpoint(path: str) -> dict:
    """Full integrity pass over a flat checkpoint; returns the manifest,
    raises :class:`CheckpointCorruptError`."""
    return _verify_npz(path)


# ---------------------------------------------------------------------------
# Sharded (per-rank) checkpoints
# ---------------------------------------------------------------------------


def _shard_key(index, shape) -> str:
    """Stable string key for a shard's global slice tuple."""
    if not shape:
        return "scalar"
    parts = []
    for s, dim in zip(index, shape):
        start = 0 if s.start is None else int(s.start)
        stop = dim if s.stop is None else int(s.stop)
        parts.append(f"{start}:{stop}")
    return ",".join(parts)


def save_checkpoint_sharded(ckpt_dir: str, tree: Any,
                            step: Optional[int] = None,
                            spec=None) -> None:
    """Gather-free checkpoint: every rank writes only its own slices to
    ``shard_{rank}.npz`` under ``ckpt_dir``, each distinct slice once
    globally (from its first replica), and rank 0 commits
    ``manifest.json`` after a barrier.  Call from every rank; ``spec``
    says how each tensor leaf is split over the grid."""
    _reraise_pending_failure(ckpt_dir)
    _clean_stale_shards(ckpt_dir)
    arrays, manifest, proc = _sharded_snapshot(tree, step, spec)
    manifest = _attach_spec(manifest, spec)
    _write_npz(os.path.join(ckpt_dir, f"shard_{proc}.npz"),
               manifest, arrays)
    _clear_write_failure(ckpt_dir)
    _finish_sharded_save(ckpt_dir, manifest)


def _finish_sharded_save(ckpt_dir: str, manifest: Optional[dict]) -> None:
    """The commit protocol, shared by the sync save and
    ``ShardedSaveHandle.finalize``: barrier (every rank's shard is
    written) -> rank 0's ``manifest.json`` -> second barrier (no rank
    returns, and perhaps restores, before the commit is durable)."""
    _barrier()
    if manifest is not None:
        _commit_shard_manifest(ckpt_dir, manifest)
    _barrier()


def _sharded_snapshot(tree, step, spec=None, copy_host_leaves=False):
    """This rank's shard arrays and the manifest; the copies to the host
    finish before return."""
    flat = _leaves_with_path(tree)
    places = _places(flat, spec)
    proc = process_index()
    arrays, leaf_meta = {}, []
    for i, ((p, x), place) in enumerate(zip(flat, places)):
        if isinstance(x, torch.Tensor):
            if place.first:
                key = _shard_key(place.index, place.global_shape)
                arrays[f"leaf_{i}|{key}"] = _to_host(x, copy_host_leaves)
        elif proc == 0:  # host numpy / scalar leaves: rank 0 owns them
            arrays[f"leaf_{i}|full"] = _to_host(x, copy_host_leaves)
        leaf_meta.append({"path": _path_str(p),
                          "shape": list(place.global_shape),
                          "dtype": _dtype_name(x)})
    manifest = {"version": MANIFEST_VERSION, "step": step, "sharded": True,
                "process_count": process_count(),
                "leaves": leaf_meta}
    return arrays, manifest, proc


_SHARD_MANIFEST = "manifest.json"


def _commit_shard_manifest(ckpt_dir: str, shard_manifest: dict) -> None:
    """Rank 0 commits the save by writing ``manifest.json`` (atomic) after
    every shard is written; it names the shard files the save owns, so a
    restore reads exactly those and the stale-shard cleanup knows what is
    referenced."""
    if process_index() != 0:
        return
    count = shard_manifest.get("process_count", 1)
    doc = {
        "version": 1,
        "step": shard_manifest.get("step"),
        "process_count": count,
        "files": [f"shard_{p}.npz" for p in range(count)],
    }
    _atomic_write(os.path.join(ckpt_dir, _SHARD_MANIFEST),
                  lambda f: f.write(json.dumps(doc).encode()))


def _read_shard_manifest(ckpt_dir: str) -> Optional[dict]:
    try:
        with open(os.path.join(ckpt_dir, _SHARD_MANIFEST)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _clean_stale_shards(ckpt_dir) -> None:
    """Rank 0 drops stale shard files so a later restore cannot blend old
    weights in.  A shard file goes only when it is not referenced by the
    committed ``manifest.json`` and strictly older than it (a file a
    second in-flight save just renamed into place is younger and
    survives); temps are never touched.  Without a committed manifest the
    index-vs-process-count rule applies."""
    import glob as _glob

    os.makedirs(ckpt_dir, exist_ok=True)
    if process_index() != 0:
        return
    committed = _read_shard_manifest(ckpt_dir)
    try:
        manifest_mtime = os.path.getmtime(
            os.path.join(ckpt_dir, _SHARD_MANIFEST))
    except OSError:
        manifest_mtime = None

    for old in _glob.glob(os.path.join(ckpt_dir, "shard_*.npz")):
        name = os.path.basename(old)
        try:
            idx = int(name[len("shard_"):-len(".npz")])
        except ValueError:
            continue
        if committed is not None and manifest_mtime is not None:
            if name in committed.get("files", []):
                continue  # referenced by the committed save
            try:
                if os.path.getmtime(old) >= manifest_mtime:
                    continue  # younger than the commit: in-flight writer
                os.unlink(old)
            except OSError:
                continue
        elif idx >= process_count():
            os.unlink(old)


class ShardedSaveHandle:
    """Handle for :func:`save_checkpoint_sharded_async`.

    ``result()`` waits for this rank's background write (re-raising its
    error).  ``finalize()`` waits, then runs the barrier and rank 0's
    commit: call it from the main thread on every rank before relying on
    the checkpoint or starting the next save to the same directory.
    ``timeout`` bounds only the local wait; the barrier is a collective.
    """

    def __init__(self, future, ckpt_dir, manifest=None):
        self._future = future
        self._ckpt_dir = ckpt_dir
        self._manifest = manifest

    def done(self) -> bool:
        return self._future.done()

    def result(self, timeout=None):
        return self._future.result(timeout)

    def finalize(self, timeout=None):
        path = self.result(timeout)
        # commit after every shard is durable; in a fresh directory a
        # crash before this leaves the new shards uncommitted and inert
        _finish_sharded_save(self._ckpt_dir, self._manifest)
        return path


def save_checkpoint_sharded_async(ckpt_dir: str, tree: Any,
                                  step: Optional[int] = None,
                                  spec=None) -> ShardedSaveHandle:
    """Overlapped gather-free checkpoint: this rank's slices copied to the
    host on the caller's thread, its ``shard_{r}.npz`` written in the
    background; the barrier and commit move into
    :meth:`ShardedSaveHandle.finalize`."""
    _reraise_pending_failure(ckpt_dir)
    _clean_stale_shards(ckpt_dir)
    arrays, manifest, proc = _sharded_snapshot(
        tree, step, spec, copy_host_leaves=True)
    manifest = _attach_spec(manifest, spec)
    path = os.path.join(ckpt_dir, f"shard_{proc}.npz")
    return ShardedSaveHandle(
        _submit_write(path, manifest, arrays, "async sharded checkpoint",
                      failure_key=ckpt_dir),
        ckpt_dir, manifest)


def _shard_paths(ckpt_dir: str):
    """The shard files a restore or verify reads: those the committed
    ``manifest.json`` names, else every ``shard_*.npz`` (legacy)."""
    committed = _read_shard_manifest(ckpt_dir)
    if committed is not None:
        paths = [os.path.join(ckpt_dir, name)
                 for name in committed.get("files", [])]
        missing = [p for p in paths if not os.path.exists(p)]
        if missing:
            raise CheckpointCorruptError(
                f"{ckpt_dir}: manifest references missing shard files "
                f"{[os.path.basename(p) for p in missing]}")
        return paths
    import glob

    return sorted(glob.glob(os.path.join(ckpt_dir, "shard_*.npz")))


def verify_checkpoint_sharded(ckpt_dir: str) -> dict:
    """Full integrity pass over a sharded checkpoint directory: every
    referenced shard readable with matching crc32s, step and process
    count consistent across shards and with the file count and the
    commit.  Returns the first shard's manifest; raises
    :class:`CheckpointCorruptError`."""
    paths = _shard_paths(ckpt_dir)
    if not paths:
        raise CheckpointCorruptError(
            f"{ckpt_dir}: no shard files to verify")
    first = None
    for p in paths:
        m = _verify_npz(p)
        if first is None:
            first = m
        elif (m.get("step") != first.get("step")
              or m.get("process_count") != first.get("process_count")):
            raise CheckpointCorruptError(
                f"{ckpt_dir}: inconsistent shard manifests "
                f"({os.path.basename(p)}: step={m.get('step')} "
                f"process_count={m.get('process_count')} vs "
                f"step={first.get('step')} "
                f"process_count={first.get('process_count')})")
    if len(paths) != first.get("process_count"):
        raise CheckpointCorruptError(
            f"{ckpt_dir}: {len(paths)} shard files but the checkpoint "
            f"was written by {first.get('process_count')} processes")
    committed = _read_shard_manifest(ckpt_dir)
    if committed is not None and committed.get("step") != first.get("step"):
        raise CheckpointCorruptError(
            f"{ckpt_dir}: committed manifest is step "
            f"{committed.get('step')} but shard contents are step "
            f"{first.get('step')} — overlapping saves to one dir?")
    return first


def _open_shards(ckpt_dir: str, error=ValueError):
    """``(manifest, open npz files, key -> npz)`` of a sharded directory,
    the keys indexed lazily (an entry decompresses only when read)."""
    paths = _shard_paths(ckpt_dir)
    if not paths:
        raise FileNotFoundError(f"no shard_*.npz under {ckpt_dir!r}")
    manifest, files, shards = None, [], {}
    try:
        for p in paths:
            data = np.load(p, allow_pickle=False)
            files.append(data)
            m = json.loads(str(data["__manifest__"]))
            _check_manifest_version(m, p)
            if manifest is None:
                manifest = m
            elif (m.get("step") != manifest.get("step")
                  or m.get("process_count") != manifest.get("process_count")):
                raise error(
                    f"inconsistent shard files under {ckpt_dir!r}: "
                    f"{os.path.basename(p)} has step={m.get('step')} "
                    f"process_count={m.get('process_count')} vs "
                    f"step={manifest.get('step')} process_count="
                    f"{manifest.get('process_count')} — torn or mixed "
                    "checkpoint")
            for key in data.files:
                if key == "__manifest__":
                    continue
                if key in shards:
                    raise error(
                        f"duplicate shard {key!r} across files under "
                        f"{ckpt_dir!r} — mixed checkpoints?")
                shards[key] = data
    except BaseException:
        for f in files:
            f.close()
        raise
    return manifest, files, shards


def _read_slice(shards, i: int, index, shape) -> np.ndarray:
    """Slice ``index`` of leaf ``i``: its stored piece, the rank 0
    ``full`` array cut, or pieces stitched together."""
    key_full = f"leaf_{i}|full"
    if key_full in shards:
        full = shards[key_full][key_full]
        return full[index] if shape else full
    key = f"leaf_{i}|{_shard_key(index, shape)}"
    if key in shards:
        return shards[key][key]
    return _assemble_slice(shards, i, index, shape)


def restore_checkpoint_sharded(ckpt_dir: str, like: Any, spec=None):
    """Restore a :func:`save_checkpoint_sharded` checkpoint against
    ``like``; returns ``(tree, step)``.  Each tensor leaf of ``like`` is
    this rank's shard as ``spec`` places it (whole without one), and the
    rank reads only its own slice, stitched from the stored pieces where
    the grid differs from save time.  Numpy and scalar templates get the
    whole leaf as numpy."""
    manifest, files, shards = _open_shards(ckpt_dir)
    try:
        if len(files) != manifest.get("process_count"):
            raise ValueError(
                f"{len(files)} shard files under {ckpt_dir!r} but the "
                f"checkpoint was written by "
                f"{manifest.get('process_count')} processes — stale or "
                "missing shard files")
        like_flat, places = _validate_template(manifest, like, spec)
        out = []
        for i, (rec, tleaf, place) in enumerate(
                zip(manifest["leaves"], like_flat, places)):
            shape = tuple(rec["shape"])
            if isinstance(tleaf, torch.Tensor):
                host = _read_slice(shards, i, place.index, shape)
            else:
                host = _read_slice(shards, i,
                                   tuple(slice(0, d) for d in shape), shape)
            out.append(_as_template(host, rec["dtype"], tleaf))
        return _unflatten(like, out), manifest["step"]
    finally:
        for f in files:
            f.close()


def _assemble_slice(shards, leaf_i, index, shape):
    """Build an arbitrary slice of leaf ``leaf_i`` from the stored pieces
    (used when restore-time shard boundaries differ from save time)."""
    starts = [0 if s.start is None else int(s.start) for s in index] \
        if shape else []
    stops = [shape[d] if index[d].stop is None else int(index[d].stop)
             for d in range(len(shape))]
    if not shape:
        key = f"leaf_{leaf_i}|scalar"
        npz = shards.get(key)
        if npz is None:
            raise KeyError(f"leaf {leaf_i}: scalar shard missing")
        return npz[key]
    out = None
    prefix = f"leaf_{leaf_i}|"
    for key, npz in shards.items():
        if not key.startswith(prefix) or key.endswith("|full"):
            continue
        spec = key[len(prefix):]
        if spec in ("scalar",):
            continue
        bounds = [tuple(map(int, part.split(":")))
                  for part in spec.split(",")]
        # overlap with the requested slice, from the key alone, so pieces
        # that do not overlap are never read
        inter = [(max(b0, s0), min(b1, s1))
                 for (b0, b1), (s0, s1) in zip(bounds, zip(starts, stops))]
        if any(a >= b for a, b in inter):
            continue
        data = npz[key]
        if out is None:
            out = np.empty([b - a for a, b in zip(starts, stops)],
                           dtype=data.dtype)
            filled = np.zeros(out.shape, dtype=bool)
        src = tuple(slice(a - b0, b - b0) for (a, b), (b0, _) in
                    zip(inter, bounds))
        dst = tuple(slice(a - s0, b - s0) for (a, b), s0 in
                    zip(inter, starts))
        out[dst] = data[src]
        filled[dst] = True
    if out is None or not filled.all():
        raise KeyError(
            f"leaf {leaf_i}: stored shards do not cover requested slice "
            f"{[(a, b) for a, b in zip(starts, stops)]}")
    return out


# ---------------------------------------------------------------------------
# ZeRO (DistributedFusedAdam/LAMB) portability
# ---------------------------------------------------------------------------


def _gather_zero_flat(opt, state, params):
    """The flat-bucket gather: bucket ``k``'s shards, all-gathered over
    the scatter axes, are rows ``[k * rpb, (k + 1) * rpb)`` of the group
    buffer, so the whole buffer is their concatenation, unflattened in
    fp32 (with ``store_param_remainders`` each shard is first joined with
    its rows of the bf16 parameters' high bits)."""
    from apex_tpu_torch.contrib.optimizers import _flat_bucket as fbk
    from apex_tpu_torch.contrib.optimizers.distributed_fused_adam import (
        join_fp32,
    )
    from apex_tpu_torch.utils.tree import unflatten_from_chunked

    cfg, lay = opt._cfg_now, opt._lay
    own = opt._params()

    def unpack(groups_bufs, transform=None):
        out: List[Any] = [None] * len(own)
        for group, bufs in zip(lay.groups, groups_bufs):
            if transform is not None:
                bufs = transform(bufs, group)
            buf = fbk.bucket_all_gather(bufs, group, cfg)
            meta = group.meta._replace(
                dtypes=(torch.float32,) * len(group.indices))
            for i, leaf in zip(group.indices,
                               unflatten_from_chunked(buf, meta)):
                out[i] = leaf
        return opt._as_tree(params, out)

    slots = {name: unpack(tree) for name, tree in state.slots.items()}
    master = None
    if state.master is not None:
        if getattr(opt, "store_param_remainders", False):
            # joined on each rank, so the gather moves fp32, not uint16
            def join(lo_bufs, group):
                hi = fbk.flatten_group(lay, group, own, dtype=torch.bfloat16)
                return [join_fp32(h, lo) for h, lo in zip(
                    fbk.local_slices(hi, group, lay.n_buckets,
                                     fbk.flat_rank(cfg)), lo_bufs)]
            master = unpack(state.master, transform=join)
        else:
            master = unpack(state.master)
    return {"step": state.step, "slots": slots, "master": master}


def _scatter_zero_flat(opt, portable, state_like, params):
    """The inverse of :func:`_gather_zero_flat` into this rank's layout
    (the world size of the optimizer's grid, which may differ from the
    one that gathered): each group's full buffer packed from the portable
    leaves, and this rank's rows of each bucket taken."""
    from apex_tpu_torch.contrib.optimizers import _flat_bucket as fbk
    from apex_tpu_torch.contrib.optimizers.distributed_fused_adam import (
        split_fp32,
    )
    from apex_tpu_torch.utils.tree import tree_flatten

    cfg, lay = opt._cfg_now, opt._lay
    rank = fbk.flat_rank(cfg)
    order = opt._leaf_index(params)

    def pack(full_tree, groups_like, transform=None):
        by_param: List[Any] = [None] * len(order)
        for j, leaf in zip(order, tree_flatten(full_tree)[0]):
            by_param[j] = torch.as_tensor(leaf)
        out = []
        for group, like in zip(lay.groups, groups_like):
            buf = fbk.flatten_group(lay, group, by_param)
            if transform is not None:
                buf = transform(buf)
            out.append([b.to(dtype=x.dtype, device=x.device, copy=True)
                        for b, x in zip(fbk.local_slices(
                            buf, group, lay.n_buckets, rank), like)])
        return out

    slots = {name: pack(portable["slots"][name], state_like.slots[name])
             for name in state_like.slots}
    master = None
    if state_like.master is not None:
        transform = ((lambda buf: split_fp32(buf)[1])
                     if getattr(opt, "store_param_remainders", False)
                     else None)
        master = pack(portable["master"], state_like.master, transform)
    return type(state_like)(step=torch.as_tensor(portable["step"]),
                            slots=slots, master=master)


def gather_zero_state(opt, state, params):
    """The portable (unsharded, fp32-master) state of a ZeRO optimizer,
    the ``state_dict(gather_on_root=True)`` analog: ``{"step", "slots":
    {name: tree like params}, "master": tree like params or None}``.

    ``state`` is this rank's ``OptState`` (``opt.opt_state(params)``),
    ``params`` a tree of the optimizer's parameters.  The shards are
    all-gathered over the scatter axes, so every rank of the grid calls
    it (a collective) and every rank gets the whole state.  The form is
    the JAX package's and independent of the layout: a flat-bucket state
    scatters into a per-leaf optimizer and back, at any world size, and
    a state gathered by either package scatters in the other."""
    from apex_tpu_torch.contrib.optimizers.distributed_fused_adam import (
        join_fp32,
        shard_leaf,
        unshard_leaf,
    )
    from apex_tpu_torch.utils.tree import tree_flatten

    if getattr(opt, "flat_bucket", False):
        return _gather_zero_flat(opt, state, params)
    p_leaves, treedef = tree_flatten(params)

    def unshard(chunks):
        return treedef([unshard_leaf(c.float(), p.shape, torch.float32,
                                     opt.axis)
                        for c, p in zip(tree_flatten(chunks)[0], p_leaves)])

    slots = {name: unshard(tree) for name, tree in state.slots.items()}
    master = None
    if state.master is not None:
        if getattr(opt, "store_param_remainders", False):
            def join(lo, p):
                hi = shard_leaf(p.detach(), opt.axis).to(torch.bfloat16)
                return unshard_leaf(join_fp32(hi, lo), p.shape,
                                    torch.float32, opt.axis)
            master = treedef([join(lo, p) for lo, p in zip(
                tree_flatten(state.master)[0], p_leaves)])
        else:
            master = unshard(state.master)
    return {"step": state.step, "slots": slots, "master": master}


def scatter_zero_state(opt, portable, state_like, params):
    """The inverse of :func:`gather_zero_state`: this rank's ``OptState``
    in the layout of ``state_like`` (``opt.opt_state(params)`` on the
    live grid, whose world size may differ from the one that gathered),
    as new tensors; load it with ``opt.load_opt_state``.  No
    communication."""
    from apex_tpu_torch.contrib.optimizers.distributed_fused_adam import (
        shard_leaf,
        split_fp32,
    )
    from apex_tpu_torch.utils.tree import tree_flatten

    if getattr(opt, "flat_bucket", False):
        return _scatter_zero_flat(opt, portable, state_like, params)

    def shard(full_tree, like_tree, transform=None):
        like, treedef = tree_flatten(like_tree)
        out = []
        for full, x in zip(tree_flatten(full_tree)[0], like):
            chunk = shard_leaf(torch.as_tensor(full).to(
                device=x.device, dtype=torch.float32), opt.axis)
            if transform is not None:
                chunk = transform(chunk)
            out.append(chunk.to(x.dtype))
        return treedef(out)

    slots = {name: shard(portable["slots"][name], tree)
             for name, tree in state_like.slots.items()}
    master = None
    if state_like.master is not None:
        # the padding's fp32 zeros split into zero remainders
        transform = ((lambda m: split_fp32(m)[1])
                     if getattr(opt, "store_param_remainders", False)
                     else None)
        master = shard(portable["master"], state_like.master, transform)
    return type(state_like)(step=torch.as_tensor(portable["step"]),
                            slots=slots, master=master)
