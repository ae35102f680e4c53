"""Mesh-agnostic checkpoint resharding, restore-anywhere (port of
:mod:`apex_tpu.resilience.reshard`).

A sharded save records placed arrays, and a pipeline layer stack
``[vpp, pp, ...]`` changes its leading dims when the pipeline depth
changes.  This module describes state *logically*, independent of
placement, and reshards on load:

- :class:`ShardingSpec` / :func:`build_spec` — the JSON description of a
  checkpointed tree, the reference's to the byte: per-leaf mesh axes,
  fold counts (leading dims that are a reshape of one logical axis) and
  the mesh's axis sizes.  The save path embeds it in the manifest.
- :func:`restore_resharded` — map a committed checkpoint (flat file or
  sharded directory) onto an arbitrary target template: leaves of
  unchanged global shape restore through the per-slice reader, the others
  through their logical form on the host (reshape only, so fp32 state is
  bit for bit).
- :func:`load_logical` — every leaf of a checkpoint in logical form on
  the host, the mesh-independent fingerprint.

The reference reads each leaf's axes from its ``NamedSharding``; a torch
tensor carries none, so :func:`build_spec` takes the
``tensor_parallel.PartitionSpec`` tree (``build_gpt_3d``'s specs, one
per leaf, naming the trailing dims) and adds the pipeline axis on the
``[vpp, pp]`` dims of every folded layer stack, as the reference's
``P(None, "pp", ...)``.  A target template's tensors are this rank's
shards, placed by the target spec's axes on the live grid.

ZeRO state (``build_spec(zero_states=...)``): a flat-bucket
optimizer's ``(rows, chunk)`` buckets, whose rows are padded to a
multiple of ``world * n_buckets``, are recorded as groups (their member
leaves' shapes, the chunk and the bucket paths) and restore onto another
world by unflattening to the logical leaves and re-chunking; a per-leaf
optimizer's padded ravels carry ``ravel_of``, the parameter's shape.
Both get the optimizer's split axis on their rows where no spec gives
one.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch import checkpoint as ckpt
from apex_tpu_torch.checkpoint import CheckpointCorruptError
from apex_tpu_torch.parallel.mesh import PIPELINE_AXIS

__all__ = [
    "ShardingSpec",
    "build_spec",
    "with_source_leaves",
    "restore_resharded",
    "load_logical",
    "slot_path",
]

SPEC_VERSION = 1


def _spec_error(msg: str) -> CheckpointCorruptError:
    """Spec problems are corruption-class: ``restore_latest`` falls back
    past a checkpoint whose logical description is missing or bad."""
    return CheckpointCorruptError(msg)


@dataclasses.dataclass
class ShardingSpec:
    """Logical sharding description of one checkpointed tree.

    ``leaves``: checkpoint leaf path -> record with ``axes`` (per-dim
    mesh axis names, ``None`` replicated), ``fold`` (N > 0: the leading
    N dims are a row-major reshape of one logical axis, the ``[vpp, pp]``
    -> ``[L]`` map), ``ravel_of`` (a ZeRO per-leaf chunk: the padded
    ravel of a leaf of this shape) or ``group`` / ``bucket`` (a ZeRO
    flat bucket).  ``groups``: the ZeRO flat-bucket layouts, key ->
    ``paths``, ``chunk``, ``n_buckets`` and the member leaves'
    ``shapes``.  ``mesh``: axis name -> size at build time.
    """

    mesh: Dict[str, int] = dataclasses.field(default_factory=dict)
    leaves: Dict[str, dict] = dataclasses.field(default_factory=dict)
    groups: Dict[str, dict] = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        return {"version": SPEC_VERSION, "mesh": dict(self.mesh),
                "leaves": self.leaves, "groups": self.groups}

    @classmethod
    def from_json(cls, doc: Any, *, where: str = "checkpoint"
                  ) -> "ShardingSpec":
        if not isinstance(doc, dict):
            raise _spec_error(
                f"{where}: sharding_spec is not an object ({type(doc)})")
        ver = doc.get("version")
        if ver != SPEC_VERSION:
            raise _spec_error(
                f"{where}: sharding_spec.version is {ver!r}, this reader "
                f"supports {SPEC_VERSION}")
        for field in ("leaves", "groups"):
            if not isinstance(doc.get(field), dict):
                raise _spec_error(
                    f"{where}: sharding_spec.{field} missing or invalid")
        return cls(mesh=dict(doc.get("mesh") or {}),
                   leaves=doc["leaves"], groups=doc["groups"])

    def leaf(self, path: str) -> dict:
        return self.leaves.get(path) or {}


def _spec_leaves(specs, tree) -> List[Any]:
    """The PartitionSpec of every leaf of ``tree`` (``None`` where a
    subtree of ``specs`` is ``None``; one PartitionSpec over a subtree
    applies to each of its leaves)."""
    from apex_tpu_torch.transformer.tensor_parallel.partition import (
        PartitionSpec,
    )

    out: List[Any] = []

    def walk(node, spec):
        if node is None:
            return
        if spec is None or isinstance(spec, PartitionSpec):
            out.extend([spec] * len(ckpt._leaves_with_path(node)))
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], spec[k])
        elif ckpt._is_namedtuple(node):
            for f in node._fields:
                walk(getattr(node, f), getattr(spec, f))
        elif isinstance(node, (list, tuple)):
            for v, s in zip(node, spec):
                walk(v, s)
        else:
            raise ValueError(f"specs has no PartitionSpec for leaf {node!r}")

    walk(tree, specs)
    return out


def _leaf_axes(x, spec, fold: int):
    """Per-dim axis lists of one leaf: the trailing-aligned PartitionSpec
    left-padded with ``None``, the pipeline axis on dim 1 of a folded
    ``[vpp, pp, ...]`` stack."""
    if spec is None or not isinstance(x, torch.Tensor):
        return None
    ndim = x.dim()
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} names more dims than rank {ndim}")
    entries = [None] * (ndim - len(spec)) + list(spec)
    if fold == 2 and entries[1] is None:
        entries[1] = PIPELINE_AXIS
    out: List[Optional[List[str]]] = []
    for entry in entries:
        if entry is None:
            out.append(None)
        elif isinstance(entry, (tuple, list)):
            out.append([str(a) for a in entry])
        else:
            out.append([str(entry)])
    return out


def build_spec(tree, *, mesh=None, folds=None, specs=None,
               zero_states: Sequence[Tuple[str, Any, Any]] = ()
               ) -> ShardingSpec:
    """Build the :class:`ShardingSpec` for ``tree`` as it will be saved.

    ``mesh``  — the live :class:`~apex_tpu_torch.parallel.mesh.RankMesh`
                (its axis sizes are recorded).
    ``folds`` — optional tree of ints of ``tree``'s structure (0 = plain
                leaf): leading dims that fold into one logical axis
                (``gpt_parallel_train.gpt3d_logical_folds``).
    ``specs`` — optional tree of ``PartitionSpec`` over ``tree``'s
                structure (a spec over a subtree covers its leaves,
                ``None`` records no axes): each tensor leaf's axes, as
                ``build_gpt_3d`` returns them; a leaf folded by 2 also
                takes ``"pp"`` on its pipeline dim.  These axes are
                what the sharded save places each rank's slice by.
    ``zero_states`` — ``(path_prefix, optimizer, params)`` triples, one
                for every ZeRO ``OptState`` inside ``tree`` (``("opt",
                opt, params)`` when the saved tree is ``{"opt": state,
                ...}``): a flat-bucket optimizer gets its bucket groups,
                a per-leaf one the ``ravel_of`` markers.
    """
    flat = ckpt._tree_paths(tree)
    fold_by_path: Dict[str, int] = {}
    if folds is not None:
        fflat = [f for _, f in ckpt._leaves_with_path(folds)]
        if len(fflat) != len(flat):
            raise ValueError(
                f"folds tree has {len(fflat)} leaves, tree has "
                f"{len(flat)} — structures must match")
        fold_by_path = {p: int(f) for (p, _), f in zip(flat, fflat) if f}
    spec_list = (_spec_leaves(specs, tree) if specs is not None
                 else [None] * len(flat))

    leaves: Dict[str, dict] = {}
    for (path, x), pspec in zip(flat, spec_list):
        rec: dict = {}
        fold = fold_by_path.get(path, 0)
        axes = _leaf_axes(x, pspec, fold)
        if axes is not None:
            rec["axes"] = axes
        if fold:
            shape = ckpt._shape(x)
            if fold >= len(shape) + 1:
                raise ValueError(
                    f"{path}: fold={fold} exceeds rank {len(shape)}")
            rec["fold"] = fold
        if rec:
            leaves[path] = rec
    groups: Dict[str, dict] = {}
    paths = [p for p, _ in flat]
    for prefix, opt, params in zero_states:
        _add_zero_state(leaves, groups, paths, prefix, opt, params)
    mesh_sizes = dict(mesh.shape) if mesh is not None else {}
    return ShardingSpec(mesh=mesh_sizes, leaves=leaves, groups=groups)


def _zero_axes(opt, ndim: int) -> List[Optional[List[str]]]:
    """A ZeRO state leaf's axes: its rows split over the optimizer's
    scatter axes (a hierarchical outer tier holds copies)."""
    axis = opt.axis
    names = [str(a) for a in axis] if isinstance(axis, (tuple, list)) \
        else [str(axis)]
    return [names] + [None] * (ndim - 1)


def _add_zero_state(leaves, groups, paths, prefix, opt, params) -> None:
    """Annotate one ZeRO ``OptState``'s leaves under ``prefix``."""
    from apex_tpu_torch.contrib.optimizers import _flat_bucket as fbk

    if getattr(opt, "flat_bucket", False):
        # the layout is the optimizer's own parameter order
        _, leaves_list, raw_groups = fbk.host_groups(opt._params())
        n_buckets = int(opt.n_buckets)
        chunk = int(opt.chunk)
        for slot in _zero_slot_names(paths, prefix):
            for g, (_, idx) in enumerate(raw_groups):
                key = f"{prefix}/{slot}/{g}"
                bucket_paths = [f"{prefix}/.{slot_path(slot)}/{g}/{k}"
                                for k in range(n_buckets)]
                missing = [p for p in bucket_paths if p not in paths]
                if missing:
                    raise ValueError(
                        f"zero_states[{prefix!r}]: expected bucket leaves "
                        f"{missing} not found in the saved tree — is the "
                        "OptState stored under a different key?")
                groups[key] = {
                    "paths": bucket_paths,
                    "chunk": chunk,
                    "n_buckets": n_buckets,
                    "shapes": [list(leaves_list[i].shape) for i in idx],
                }
                for k, p in enumerate(bucket_paths):
                    rec = leaves.setdefault(p, {})
                    rec["group"] = key
                    rec["bucket"] = k
                    rec.setdefault("axes", _zero_axes(opt, 2))
    else:
        # per-leaf layout: every slot/master leaf is the zero-padded
        # rank-major ravel of the same-suffixed parameter leaf
        by_suffix = {p: ckpt._shape(x) for p, x in ckpt._tree_paths(params)}
        for path in paths:
            suffix = _zero_leaf_suffix(path, prefix)
            if suffix is None or suffix not in by_suffix:
                continue
            rec = leaves.setdefault(path, {})
            rec["ravel_of"] = list(by_suffix[suffix])
            rec.setdefault("axes", _zero_axes(opt, 1))


def _zero_slot_names(paths, prefix) -> List[str]:
    """The slot names in the saved tree, and ``master`` when the
    optimizer keeps a master copy."""
    names = []
    slots_prefix = f"{prefix}/.slots/"
    for p in paths:
        if p.startswith(slots_prefix):
            name = p[len(slots_prefix):].split("/", 1)[0]
            if name not in names:
                names.append(name)
    if any(p.startswith(f"{prefix}/.master/") for p in paths):
        names.append("master")
    return names


def _zero_leaf_suffix(path, prefix) -> Optional[str]:
    slots_prefix = f"{prefix}/.slots/"
    if path.startswith(slots_prefix):
        parts = path[len(slots_prefix):].split("/", 1)
        return parts[1] if len(parts) == 2 else None
    master_prefix = f"{prefix}/.master/"
    if path.startswith(master_prefix):
        return path[len(master_prefix):]
    return None


def with_source_leaves(spec: ShardingSpec, source: ShardingSpec
                       ) -> ShardingSpec:
    """``spec`` with the leaf records it lacks taken from ``source`` (the
    checkpoint's): axes, folds and the ZeRO markers are names, not sizes,
    so a bare target spec places the source's split leaves by them on the
    live grid."""
    return ShardingSpec(mesh=dict(spec.mesh),
                        leaves={**source.leaves, **spec.leaves},
                        groups=dict(spec.groups))


def slot_path(slot: str) -> str:
    """Tree-path component of one optimizer state family: ``slots/<name>``
    leaves live under ``.slots/<name>``, the master copy under
    ``.master``."""
    return "master" if slot == "master" else f"slots/{slot}"


# ---------------------------------------------------------------------------
# Source side: committed checkpoint -> whole / logical host arrays
# ---------------------------------------------------------------------------


class _Source:
    """Read-side view of a committed checkpoint (flat ``.npz`` or sharded
    directory): the manifest, and ``full(i)`` / ``slice(i, index)``
    assembling leaf ``i`` on the host.  The npz handles stay open (lazy
    decompress) until ``close``."""

    def __init__(self, path: str):
        self._files = []
        self._shards: Dict[str, Any] = {}
        self._flat = None
        if os.path.isdir(path):
            manifest, self._files, self._shards = ckpt._open_shards(
                path, error=CheckpointCorruptError)
        else:
            data = np.load(path, allow_pickle=False)
            self._files.append(data)
            manifest = json.loads(str(data["__manifest__"]))
            ckpt._check_manifest_version(manifest, path)
            self._flat = data
        self.path = path
        self.manifest = manifest
        self.leaves = manifest["leaves"]

    def spec(self) -> ShardingSpec:
        doc = self.manifest.get("sharding_spec")
        if doc is None:
            raise _spec_error(
                f"{self.path}: manifest (version "
                f"{self.manifest.get('version', 1)}) has no sharding_spec "
                "— it predates the logical-spec layer, so it can only be "
                "restored onto the mesh shape that wrote it (use the "
                "plain restore path / a matching template)")
        return ShardingSpec.from_json(doc, where=self.path)

    def full(self, i: int) -> np.ndarray:
        """Leaf ``i``'s whole global value (stored form) on the host."""
        shape = tuple(self.leaves[i]["shape"])
        if self._flat is not None:
            return np.asarray(self._flat[f"leaf_{i}"])
        return np.asarray(ckpt._read_slice(
            self._shards, i, tuple(slice(0, d) for d in shape), shape))

    def slice(self, i: int, index) -> np.ndarray:
        """Slice ``index`` of leaf ``i`` (lazy per-piece read)."""
        shape = tuple(self.leaves[i]["shape"])
        if self._flat is not None:
            return np.asarray(self._flat[f"leaf_{i}"])[index]
        return np.asarray(ckpt._read_slice(self._shards, i, index, shape))

    def close(self) -> None:
        for f in self._files:
            f.close()
        self._files, self._shards, self._flat = [], {}, None

    def __enter__(self) -> "_Source":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _chunk_rows(size: int, chunk: int) -> int:
    """The rows one leaf takes in a ``(rows, chunk)`` buffer (as
    ``utils.tree.chunked_meta``: a zero-size leaf takes none)."""
    return -(-size // chunk)


def _unflatten_np(buffer: np.ndarray, shapes, chunk: int
                  ) -> List[np.ndarray]:
    """The host inverse of ``flatten_to_chunked``: each logical leaf's
    rows sliced back out (indexing only: bit for bit)."""
    flat = np.ascontiguousarray(buffer).reshape(-1)
    out, row = [], 0
    for shape in shapes:
        size = int(np.prod(shape)) if shape else 1
        start = row * chunk
        if start + size > flat.size:
            raise _spec_error(
                "flat-bucket buffer too small for its sharding_spec "
                f"shapes (need {start + size} elements, buffer has "
                f"{flat.size})")
        out.append(flat[start:start + size].reshape(shape))
        row += _chunk_rows(size, chunk)
    return out


def _flatten_np(leaves, chunk: int, rows_total: int, dtype) -> np.ndarray:
    """The host ``flatten_to_chunked``: logical leaves packed into a
    zero-padded ``(rows_total, chunk)`` buffer."""
    flat = np.zeros((rows_total * chunk,), dtype=dtype)
    row = 0
    for leaf in leaves:
        size = int(leaf.size)
        start = row * chunk
        if start + size > flat.size:
            raise _spec_error(
                "target flat-bucket layout too small for the logical "
                f"leaves (need {start + size} elements, buffer has "
                f"{flat.size} = {rows_total} x {chunk} rows)")
        flat[start:start + size] = np.ascontiguousarray(leaf).reshape(-1)
        row += _chunk_rows(size, chunk)
    return flat.reshape(rows_total, chunk)


def _leaf_logical(full: np.ndarray, rec: dict, path: str) -> np.ndarray:
    """A leaf's inverse transform: stored whole value -> logical."""
    fold = int(rec.get("fold", 0) or 0)
    ravel_of = rec.get("ravel_of")
    if fold:
        shape = full.shape
        if fold > len(shape):
            raise _spec_error(
                f"{path}: sharding_spec fold={fold} exceeds stored rank "
                f"{len(shape)}")
        return full.reshape((-1,) + tuple(shape[fold:]))
    if ravel_of is not None:
        target = tuple(int(d) for d in ravel_of)
        n = int(np.prod(target)) if target else 1
        flat = full.reshape(-1)
        if flat.size < n:
            raise _spec_error(
                f"{path}: stored padded ravel has {flat.size} elements, "
                f"sharding_spec.ravel_of {list(target)} needs {n}")
        return flat[:n].reshape(target)
    return full


def _leaf_placed(logical: np.ndarray, rec: dict, target_shape, path: str
                 ) -> np.ndarray:
    """A leaf's forward transform: logical -> target layout."""
    target_shape = tuple(int(d) for d in target_shape)
    fold = int(rec.get("fold", 0) or 0)
    if rec.get("ravel_of") is not None:
        n = int(np.prod(target_shape)) if target_shape else 1
        flat = np.ascontiguousarray(logical).reshape(-1)
        if flat.size > n:
            raise _spec_error(
                f"{path}: logical leaf has {flat.size} elements, target "
                f"padded ravel {list(target_shape)} holds only {n}")
        out = np.zeros((n,), dtype=logical.dtype)
        out[:flat.size] = flat
        return out.reshape(target_shape)
    if logical.size != int(np.prod(target_shape) if target_shape else 1):
        raise _spec_error(
            f"{path}: logical element count {logical.size} does not "
            f"match target shape {list(target_shape)}"
            + (f" (fold={fold})" if fold else ""))
    return logical.reshape(target_shape)


# ---------------------------------------------------------------------------
# The restore-anywhere entry points
# ---------------------------------------------------------------------------


def load_logical(path: str) -> Tuple[Dict[str, np.ndarray], Optional[int]]:
    """Canonical mesh-independent view of a committed checkpoint: every
    leaf assembled on the host in its logical form (folds merged, padded
    ravels cut), keyed by path; a flat-bucket group expands to its member
    leaves, keyed ``<group>[<j>]``, in place of its bucket leaves.
    Returns ``(leaves, step)``.  A bf16 leaf comes back as its two bytes
    a value (``uint16``), so digests compare bits.  Only an absent spec
    falls back to the plain leaves; a malformed one raises.
    """
    with _Source(path) as src:
        doc = src.manifest.get("sharding_spec")
        spec = (ShardingSpec() if doc is None
                else ShardingSpec.from_json(doc, where=src.path))
        index = {rec["path"]: i for i, rec in enumerate(src.leaves)}
        out: Dict[str, np.ndarray] = {}
        done_groups = set()
        for i, rec in enumerate(src.leaves):
            p = rec["path"]
            lrec = spec.leaf(p)
            key = lrec.get("group")
            if key is not None:
                if key in done_groups:
                    continue
                done_groups.add(key)
                for j, leaf in enumerate(
                        _group_logical(src, spec, key, index)):
                    out[f"{key}[{j}]"] = leaf
                continue
            out[p] = _leaf_logical(src.full(i), lrec, p)
        return out, src.manifest.get("step")


def _group_logical(src: "_Source", spec: ShardingSpec, key: str,
                   index: Dict[str, int]) -> List[np.ndarray]:
    """One flat-bucket group's logical leaves from its stored bucket
    buffers (rows concatenated, then unflattened by position)."""
    grp = spec.groups.get(key)
    if grp is None:
        raise _spec_error(
            f"{src.path}: leaf references sharding_spec group {key!r} "
            "which is not in sharding_spec.groups")
    for field in ("paths", "chunk", "shapes"):
        if field not in grp:
            raise _spec_error(
                f"{src.path}: sharding_spec.groups[{key!r}] missing "
                f"{field!r}")
    bufs = []
    for p in grp["paths"]:
        if p not in index:
            raise _spec_error(
                f"{src.path}: sharding_spec.groups[{key!r}] references "
                f"leaf {p!r} absent from the manifest")
        bufs.append(src.full(index[p]))
    buffer = np.concatenate(bufs, axis=0) if len(bufs) > 1 else bufs[0]
    shapes = [tuple(int(d) for d in s) for s in grp["shapes"]]
    return _unflatten_np(buffer, shapes, int(grp["chunk"]))


def restore_resharded(path: str, like: Any, spec: ShardingSpec):
    """Restore a committed checkpoint onto an arbitrary target grid.

    ``like`` gives the target structure, shapes, dtypes and devices (its
    tensors this rank's shards); ``spec`` is the TARGET's logical spec
    (:func:`build_spec` over ``like`` with the target mesh, specs, folds
    and ``zero_states``), which places each shard as it is given (a
    bare spec built from ``mesh`` alone takes the source's leaf records
    first, :func:`with_source_leaves`, as
    ``CheckpointManager.restore_latest(mesh=)`` does).  The
    source's spec comes from the manifest; leaves are matched by path,
    groups by key.  Returns ``(tree, step)``.  Leaves of unchanged
    global shape are read slice by slice; the others go through their
    logical form, and each flat-bucket group is unflattened to its
    leaves and re-chunked for the target's rows (reshape, concatenation,
    padding and truncation only: bit for bit).
    """
    with _Source(path) as src:
        src_spec = src.spec()
        flat = ckpt._leaves_with_path(like)
        if len(flat) != len(src.leaves):
            raise _spec_error(
                f"{path}: checkpoint has {len(src.leaves)} leaves, "
                f"template has {len(flat)}")
        index = {rec["path"]: i for i, rec in enumerate(src.leaves)}
        places = ckpt._places(flat, spec)
        by_path = {ckpt._path_str(p): place
                   for (p, _), place in zip(flat, places)}

        # every target flat-bucket group once: logical leaves from the
        # source layout, re-chunked into the target's global rows.  The
        # group records are mesh-independent (every size that depends on
        # the target comes from the template), so where the target spec
        # has none (a bare spec) the source's serve
        tgt_groups = dict(src_spec.groups)
        tgt_groups.update(spec.groups)
        group_out: Dict[str, np.ndarray] = {}
        for key, tgt in tgt_groups.items():
            logical = _group_logical(src, src_spec, key, index)
            shapes = [tuple(int(d) for d in s) for s in tgt["shapes"]]
            if [tuple(x.shape) for x in logical] != shapes:
                raise _spec_error(
                    f"{path}: group {key!r} logical shapes "
                    f"{[list(x.shape) for x in logical]} do not match "
                    f"the target sharding_spec shapes "
                    f"{[list(s) for s in shapes]}")
            tgt_rows = []
            for p in tgt["paths"]:
                if p not in by_path:
                    raise _spec_error(
                        f"target sharding_spec group {key!r} references "
                        f"template leaf {p!r} absent from the template")
                tgt_rows.append(int(by_path[p].global_shape[0]))
            buffer = _flatten_np(logical, int(tgt["chunk"]), sum(tgt_rows),
                                 logical[0].dtype if logical
                                 else np.float32)
            off = 0
            for p, rows in zip(tgt["paths"], tgt_rows):
                group_out[p] = buffer[off:off + rows]
                off += rows

        out = []
        for i, ((p, tleaf), rec, place) in enumerate(
                zip(flat, src.leaves, places)):
            tpath = ckpt._path_str(p)
            if rec["path"] != tpath:
                raise _spec_error(
                    f"{path}: leaf {i} path mismatch: checkpoint "
                    f"{rec['path']!r} vs template {tpath!r}")
            src_shape = tuple(rec["shape"])
            tgt_shape = place.global_shape
            is_tensor = isinstance(tleaf, torch.Tensor)
            src_rec = src_spec.leaf(tpath)
            if tpath in group_out:
                host = group_out[tpath]
                if is_tensor:
                    host = host[place.index]
            elif src_shape == tgt_shape:
                host = (src.slice(i, place.index) if is_tensor
                        else src.full(i))
            else:
                if src_rec.get("group") is not None:
                    raise _spec_error(
                        f"{path}: {tpath} belongs to source group "
                        f"{src_rec['group']!r} but the target spec maps "
                        "it to no group — flat-bucket state cannot "
                        "restore into a non-bucketed layout here (use "
                        "checkpoint.gather_zero_state's portable form)")
                # fold and ravel_of are mesh-independent markers: a bare
                # target spec inherits them from the source; the shape is
                # the template's
                tgt_rec = spec.leaf(tpath) or src_rec
                logical = _leaf_logical(src.full(i), src_rec, tpath)
                host = _leaf_placed(logical, tgt_rec, tgt_shape, tpath)
                if is_tensor:
                    host = host[place.index]
            out.append(ckpt._as_template(host, rec["dtype"], tleaf))
        return ckpt._unflatten(like, out), src.manifest.get("step")
