"""The rank grid and its process groups (port of
:mod:`apex_tpu.parallel.mesh`).

The JAX package lays its devices out as one named mesh, ``(dcn, dp, pp,
cp, tp)`` row-major with ``tp`` innermost, and a collective names the
mesh axes it runs over.  Here every process is one rank of
``torch.distributed``, and :func:`initialize_model_parallel` lays the
ranks out on the same grid: rank ``r`` sits where device ``r`` of a JAX
mesh of the same shape sits, so it holds the same shard.  For every set
of axes it builds the process group of the ranks that differ only along
those axes; a collective's ``axis`` (``"tp"``, or a tuple such as
``("dcn", "dp")``) resolves to this rank's group of that set
(:func:`get_group`), and the rank's index in it is row-major over the
named axes, as ``jax.lax.axis_index`` counts a tuple of axes.

The accessors keep the reference's names.  :func:`get_mesh` gives a
:class:`RankMesh`, the grid of global ranks with the axes' names and
sizes, where the reference gives its ``jax.sharding.Mesh``.  The
pipeline groups carry the rotation schedule's transfers
(:mod:`apex_tpu_torch.transformer.pipeline_parallel`); the
virtual-pipeline rank is host bookkeeping, as in the reference.

:func:`initialize_model_parallel` needs ``torch.distributed``
initialised (:func:`apex_tpu_torch.parallel.launch.initialize_distributed`)
and must be called by every rank, since each group is made by all of
them together.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch.distributed as dist

__all__ = [
    "DCN_AXIS",
    "DATA_AXIS",
    "TENSOR_AXIS",
    "PIPELINE_AXIS",
    "CONTEXT_AXIS",
    "MeshSpec",
    "RankMesh",
    "initialize_model_parallel",
    "model_parallel_is_initialized",
    "destroy_model_parallel",
    "get_mesh",
    "get_group",
    "get_subgroup",
    "group_ranks",
    "axis_names",
    "get_data_parallel_world_size",
    "get_dcn_data_parallel_world_size",
    "get_tensor_model_parallel_world_size",
    "get_pipeline_model_parallel_world_size",
    "get_context_parallel_world_size",
    "get_data_parallel_rank",
    "get_tensor_model_parallel_rank",
    "get_pipeline_model_parallel_rank",
    "get_context_parallel_rank",
    "get_virtual_pipeline_model_parallel_world_size",
    "get_virtual_pipeline_model_parallel_rank",
    "set_virtual_pipeline_model_parallel_rank",
    "get_pipeline_model_parallel_split_rank",
    "get_rank_info",
]

DCN_AXIS = "dcn"
DATA_AXIS = "dp"
PIPELINE_AXIS = "pp"
CONTEXT_AXIS = "cp"
TENSOR_AXIS = "tp"

_AXIS_ORDER = (DCN_AXIS, DATA_AXIS, PIPELINE_AXIS, CONTEXT_AXIS, TENSOR_AXIS)

AxisName = Union[str, Sequence[str]]


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """The parallel decomposition: the reference's argument bundle."""

    tensor_model_parallel_size: int = 1
    pipeline_model_parallel_size: int = 1
    context_parallel_size: int = 1
    data_parallel_size: Optional[int] = None  # None = fill the world
    dcn_data_parallel_size: int = 1           # the outer data-parallel axis
    virtual_pipeline_model_parallel_size: Optional[int] = None
    pipeline_model_parallel_split_rank: Optional[int] = None

    def resolve_dp(self, n_ranks: int) -> int:
        model = (self.tensor_model_parallel_size
                 * self.pipeline_model_parallel_size
                 * self.context_parallel_size
                 * self.dcn_data_parallel_size)
        if n_ranks % model != 0:
            raise ValueError(
                f"world size {n_ranks} not divisible by dcn*tp*pp*cp={model} "
                f"(dcn={self.dcn_data_parallel_size}, "
                f"tp={self.tensor_model_parallel_size}, "
                f"pp={self.pipeline_model_parallel_size}, "
                f"cp={self.context_parallel_size})")
        dp = n_ranks // model
        if self.data_parallel_size is not None and self.data_parallel_size != dp:
            raise ValueError(
                f"data_parallel_size={self.data_parallel_size} inconsistent "
                f"with {n_ranks} ranks / model-parallel size {model} (= {dp})")
        return dp


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """The grid of global ranks, ``ranks[dcn, dp, pp, cp, tp]``.

    ``shape`` maps each axis name to its size, as ``Mesh.shape`` does;
    ``coords`` are this rank's coordinates."""

    ranks: np.ndarray
    coords: Dict[str, int]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return _AXIS_ORDER

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(_AXIS_ORDER, self.ranks.shape))


class _State:
    mesh: Optional[RankMesh] = None
    spec: Optional[MeshSpec] = None
    # the canonical axis tuple (size-1 axes dropped) -> this rank's group
    # and the global ranks of that group, in group-rank order
    groups: Dict[Tuple[str, ...], object] = {}
    members: Dict[Tuple[str, ...], Tuple[int, ...]] = {}
    # (axis tuple, index groups) -> this rank's sub-group of that axis
    subgroups: Dict[Tuple, object] = {}
    virtual_pipeline_rank: Optional[int] = None


_STATE = _State()


def axis_names(axis: AxisName) -> Tuple[str, ...]:
    """``axis`` as a tuple of names, each checked against the grid's."""
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    for name in names:
        if name not in _AXIS_ORDER:
            raise ValueError(f"unknown axis {name!r}; the axes are "
                             f"{_AXIS_ORDER}")
    return names


def _canonical(names: Sequence[str], shape: Dict[str, int]) -> Tuple[str, ...]:
    return tuple(a for a in _AXIS_ORDER if a in names and shape[a] > 1)


def _ranks_along(grid: np.ndarray, coords: Dict[str, int],
                 axes: Tuple[str, ...]) -> Tuple[int, ...]:
    """The global ranks that differ from ``coords`` only along ``axes``,
    row-major over them (which is ascending, since the grid is)."""
    index = tuple(slice(None) if a in axes else coords[a]
                  for a in _AXIS_ORDER)
    return tuple(int(r) for r in grid[index].reshape(-1))


def initialize_model_parallel(
    tensor_model_parallel_size: int = 1,
    pipeline_model_parallel_size: int = 1,
    virtual_pipeline_model_parallel_size: Optional[int] = None,
    pipeline_model_parallel_split_rank: Optional[int] = None,
    context_parallel_size: int = 1,
    dcn_data_parallel_size: Optional[int] = None,
) -> RankMesh:
    """Lay the world's ranks on the ``(dcn, dp, pp, cp, tp)`` grid and
    build a process group for every set of axes; ``dp`` fills what the
    other sizes leave.  Collective: every rank calls it with the same
    arguments.  Returns the :class:`RankMesh`."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "torch.distributed is not initialised; call "
            "apex_tpu_torch.parallel.initialize_distributed(...) first")
    if virtual_pipeline_model_parallel_size is not None \
            and pipeline_model_parallel_size < 2:
        raise ValueError("virtual pipeline parallelism requires "
                         "pipeline_model_parallel_size >= 2")
    world, me = dist.get_world_size(), dist.get_rank()
    spec = MeshSpec(
        tensor_model_parallel_size=tensor_model_parallel_size,
        pipeline_model_parallel_size=pipeline_model_parallel_size,
        context_parallel_size=context_parallel_size,
        dcn_data_parallel_size=dcn_data_parallel_size or 1,
        virtual_pipeline_model_parallel_size=(
            virtual_pipeline_model_parallel_size),
        pipeline_model_parallel_split_rank=pipeline_model_parallel_split_rank)
    dp = spec.resolve_dp(world)
    grid = np.arange(world).reshape(
        spec.dcn_data_parallel_size, dp, pipeline_model_parallel_size,
        context_parallel_size, tensor_model_parallel_size)
    coords = dict(zip(_AXIS_ORDER, (int(c) for c in
                                    np.argwhere(grid == me)[0])))
    mesh = RankMesh(ranks=grid, coords=coords)
    destroy_model_parallel()
    # one group per distinct rank set, made in the same order on every
    # rank (new_group is collective over the whole world)
    made: Dict[Tuple[int, ...], object] = {}
    world_ranks = tuple(range(world))
    for n in range(0, len(_AXIS_ORDER) + 1):
        for axes in itertools.combinations(_AXIS_ORDER, n):
            if _canonical(axes, mesh.shape) != axes:
                continue
            sets = {_ranks_along(grid, dict(zip(_AXIS_ORDER, c)), axes)
                    for c in np.ndindex(grid.shape)}
            for ranks in sorted(sets):
                if ranks not in made:
                    made[ranks] = (dist.group.WORLD if ranks == world_ranks
                                   else dist.new_group(list(ranks)))
            mine = _ranks_along(grid, coords, axes)
            _STATE.groups[axes] = made[mine]
            _STATE.members[axes] = mine
    _STATE.mesh = mesh
    _STATE.spec = spec
    return mesh


def model_parallel_is_initialized() -> bool:
    return _STATE.mesh is not None


def destroy_model_parallel() -> None:
    """Forget the grid and its groups (the groups themselves go with
    ``torch.distributed.destroy_process_group``)."""
    _STATE.mesh = None
    _STATE.spec = None
    _STATE.groups = {}
    _STATE.members = {}
    _STATE.subgroups = {}
    _STATE.virtual_pipeline_rank = None


def get_mesh() -> RankMesh:
    if _STATE.mesh is None:
        raise RuntimeError(
            "model parallel mesh is not initialized; call "
            "apex_tpu_torch.parallel.initialize_model_parallel(...) first")
    return _STATE.mesh


def _key(axis: AxisName) -> Tuple[str, ...]:
    return _canonical(axis_names(axis), get_mesh().shape)


def get_group(axis: AxisName):
    """This rank's process group over ``axis`` (a name or a tuple)."""
    return _STATE.groups[_key(axis)]


def get_subgroup(axis: AxisName, axis_index_groups):
    """This rank's process group among ``axis_index_groups`` (lists of
    indices along ``axis``, as JAX's collectives take them): the ranks of
    its group over ``axis`` at the indices of the index group holding
    this rank's index.  ``None`` gives :func:`get_group`.  Collective on
    first use: every rank of the world makes every such group, in the
    same order."""
    if axis_index_groups is None:
        return get_group(axis)
    key = (_key(axis), tuple(tuple(int(i) for i in g)
                             for g in axis_index_groups))
    if key not in _STATE.subgroups:
        mesh, axes = get_mesh(), key[0]
        along = sorted({_ranks_along(mesh.ranks, dict(zip(_AXIS_ORDER, c)),
                                     axes)
                        for c in np.ndindex(mesh.ranks.shape)})
        me = dist.get_rank()
        for ranks in along:
            for index_group in key[1]:
                members = [ranks[i] for i in index_group]
                group = dist.new_group(members)
                if me in members:
                    _STATE.subgroups[key] = group
    return _STATE.subgroups[key]


def group_ranks(axis: AxisName) -> Tuple[int, ...]:
    """The global ranks of this rank's group over ``axis``, in group-rank
    order (row-major over the axes named)."""
    return _STATE.members[_key(axis)]


def _axis_size(axis: str) -> int:
    return get_mesh().shape[axis]


def _axis_rank(axis: str) -> int:
    return get_mesh().coords[axis]


def get_data_parallel_world_size() -> int:
    """The total replica count, the inner and the outer data axes."""
    return _axis_size(DATA_AXIS) * _axis_size(DCN_AXIS)


def get_dcn_data_parallel_world_size() -> int:
    return _axis_size(DCN_AXIS)


def get_tensor_model_parallel_world_size() -> int:
    return _axis_size(TENSOR_AXIS)


def get_pipeline_model_parallel_world_size() -> int:
    return _axis_size(PIPELINE_AXIS)


def get_context_parallel_world_size() -> int:
    return _axis_size(CONTEXT_AXIS)


def get_data_parallel_rank() -> int:
    """The replica index over ``(dcn, dp)``, dcn-major."""
    return _axis_rank(DCN_AXIS) * _axis_size(DATA_AXIS) + _axis_rank(DATA_AXIS)


def get_tensor_model_parallel_rank() -> int:
    return _axis_rank(TENSOR_AXIS)


def get_pipeline_model_parallel_rank() -> int:
    return _axis_rank(PIPELINE_AXIS)


def get_context_parallel_rank() -> int:
    return _axis_rank(CONTEXT_AXIS)


def get_virtual_pipeline_model_parallel_world_size() -> Optional[int]:
    if _STATE.spec is None:
        return None
    return _STATE.spec.virtual_pipeline_model_parallel_size


def get_virtual_pipeline_model_parallel_rank() -> Optional[int]:
    """The model chunk of the interleaved schedule's current step: host
    bookkeeping, not a property of the rank."""
    return _STATE.virtual_pipeline_rank


def set_virtual_pipeline_model_parallel_rank(rank: Optional[int]) -> None:
    _STATE.virtual_pipeline_rank = rank


def get_pipeline_model_parallel_split_rank() -> Optional[int]:
    """The encoder/decoder split stage of T5-style models."""
    if _STATE.spec is None:
        return None
    return _STATE.spec.pipeline_model_parallel_split_rank


def get_rank_info() -> str:
    """A readable summary of the grid and this rank's place on it."""
    if not model_parallel_is_initialized():
        return "mesh uninitialized"
    m = get_mesh()
    sizes = ", ".join(f"{a}={n}" for a, n in m.shape.items())
    where = ", ".join(f"{a}={c}" for a, c in m.coords.items())
    return (f"mesh({sizes}) rank {dist.get_rank()}/{dist.get_world_size()} "
            f"at ({where})")
