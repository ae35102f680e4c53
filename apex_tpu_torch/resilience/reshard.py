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

Not ported: the ZeRO flat-bucket groups and padded ravels
(``zero_states``), which come with ZeRO (ROADMAP.md, section A.5); a
checkpoint that carries them raises.
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
    mesh axis names, ``None`` replicated) and ``fold`` (N > 0: the leading
    N dims are a row-major reshape of one logical axis, the ``[vpp, pp]``
    -> ``[L]`` map).  ``groups``: the ZeRO flat-bucket layouts (none in
    the port until ZeRO lands).  ``mesh``: axis name -> size at build
    time.
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
    ``zero_states`` — ZeRO optimizer states: not ported (section A.5).
    """
    if zero_states:
        raise NotImplementedError(
            "build_spec(zero_states=...): ZeRO optimizers are not ported "
            "yet (ROADMAP.md, section A.5)")
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
    mesh_sizes = dict(mesh.shape) if mesh is not None else {}
    return ShardingSpec(mesh=mesh_sizes, leaves=leaves, groups={})


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


def _leaf_logical(full: np.ndarray, rec: dict, path: str) -> np.ndarray:
    """A leaf's inverse transform: stored whole value -> logical."""
    fold = int(rec.get("fold", 0) or 0)
    if rec.get("ravel_of") is not None or rec.get("group") is not None:
        raise _spec_error(
            f"{path}: ZeRO optimizer state in the checkpoint; ZeRO is not "
            "ported yet (ROADMAP.md, section A.5)")
    if fold:
        shape = full.shape
        if fold > len(shape):
            raise _spec_error(
                f"{path}: sharding_spec fold={fold} exceeds stored rank "
                f"{len(shape)}")
        return full.reshape((-1,) + tuple(shape[fold:]))
    return full


def _leaf_placed(logical: np.ndarray, rec: dict, target_shape, path: str
                 ) -> np.ndarray:
    """A leaf's forward transform: logical -> target layout."""
    target_shape = tuple(int(d) for d in target_shape)
    fold = int(rec.get("fold", 0) or 0)
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
    leaf assembled on the host in its logical form (folds merged), keyed
    by path.  Returns ``(leaves, step)``.  A bf16 leaf comes back as its
    two bytes a value (``uint16``), so digests compare bits.  Only an
    absent spec falls back to the plain leaves; a malformed one raises.
    """
    with _Source(path) as src:
        doc = src.manifest.get("sharding_spec")
        spec = (ShardingSpec() if doc is None
                else ShardingSpec.from_json(doc, where=src.path))
        if spec.groups:
            raise _spec_error(
                f"{src.path}: ZeRO flat-bucket groups in the checkpoint; "
                "ZeRO is not ported yet (ROADMAP.md, section A.5)")
        out: Dict[str, np.ndarray] = {}
        for i, rec in enumerate(src.leaves):
            p = rec["path"]
            out[p] = _leaf_logical(src.full(i), spec.leaf(p), p)
        return out, src.manifest.get("step")


def restore_resharded(path: str, like: Any, spec: ShardingSpec):
    """Restore a committed checkpoint onto an arbitrary target grid.

    ``like`` gives the target structure, shapes, dtypes and devices (its
    tensors this rank's shards); ``spec`` is the TARGET's logical spec
    (:func:`build_spec` over ``like`` with the target mesh, specs and
    folds), which places each shard.  The source's spec comes from the
    manifest; leaves are matched by path.  Returns ``(tree, step)``.
    Leaves of unchanged global shape are read slice by slice; the others
    go through their logical form (reshape only: bit for bit).
    """
    with _Source(path) as src:
        src_spec = src.spec()
        if src_spec.groups:
            raise _spec_error(
                f"{path}: ZeRO flat-bucket groups in the checkpoint; ZeRO "
                "is not ported yet (ROADMAP.md, section A.5)")
        flat = ckpt._leaves_with_path(like)
        if len(flat) != len(src.leaves):
            raise _spec_error(
                f"{path}: checkpoint has {len(src.leaves)} leaves, "
                f"template has {len(flat)}")
        places = ckpt._places(flat, spec)
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
            if src_shape == tgt_shape:
                host = (src.slice(i, place.index) if is_tensor
                        else src.full(i))
            else:
                # fold is a mesh-independent marker: a bare target spec
                # inherits it from the source; the shape is the template's
                src_rec = src_spec.leaf(tpath)
                tgt_rec = spec.leaf(tpath) or src_rec
                logical = _leaf_logical(src.full(i), src_rec, tpath)
                host = _leaf_placed(logical, tgt_rec, tgt_shape, tpath)
                if is_tensor:
                    host = host[place.index]
            out.append(ckpt._as_template(host, rec["dtype"], tleaf))
        return ckpt._unflatten(like, out), src.manifest.get("step")
