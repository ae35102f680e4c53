"""Per-step training telemetry — the :class:`TrainStats` tuple (port of
:mod:`apex_tpu.observability.trainstats`).

The contract is the reference's, because a metrics layer that slows the
step it measures is worse than none:

- **no extra host syncs** — every field is a tensor computed on the
  step's device from tensors the step already has; nothing is fetched
  until a host-side logger decides to (:class:`TrainStatsLogger`,
  ``every_n`` steps), so steady-state steps stay asynchronous;
- **no collective beyond the ones already on the path** — stats that
  need cross-rank agreement ride an all-reduce the trainer already makes
  (the loss reduction), *widened* by a few elements rather than added
  (:func:`pack_local_stats` / :func:`stats_from_reduced`); norms over
  sharded parameters leave the step as each rank's partial sums
  (:func:`device_partial_norms`, no collective at all), reduced on the
  host at fetch time;
- **bit-identical training** — the statistics are computed under
  ``torch.no_grad()`` from the step's own tensors and never feed back, so
  the instrumented step's parameters and optimizer state match the bare
  step's bit for bit.

Threaded through ``build_gpt_3d``'s ``make_train_step
(collect_stats=True)``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from apex_tpu_torch.utils.tree import tree_flatten, tree_l2_norm

__all__ = [
    "TrainStats",
    "PartialTrainStats",
    "train_stats",
    "partial_train_stats",
    "device_partial_norms",
    "local_grad_stats",
    "pack_local_stats",
    "stats_from_reduced",
    "stats_partition_specs",
    "TrainStatsLogger",
]


class TrainStats(NamedTuple):
    """Per-step telemetry (tensors on the step's device until fetched).

    ``loss``             — unscaled mean training loss (fp32).
    ``grad_norm``        — global L2 norm of the (unscaled) gradients.
    ``param_norm``       — global L2 norm of the parameters (pre-update).
    ``nonfinite_leaves`` — int32 count of gradient leaves containing any
                           NaN/Inf this step (0 on a healthy step).
    ``loss_scale``       — the loss scale the step ran under (1.0 when no
                           scaler is armed).
    ``skipped_steps``    — cumulative skipped updates from
                           ``resilience.SentinelState`` (0 when no
                           sentinel is armed).
    ``moe_aux``          — per-microbatch MoE auxiliary loss ``[m]``
                           (``None`` for trainers without microbatches).
    """

    loss: torch.Tensor
    grad_norm: torch.Tensor
    param_norm: torch.Tensor
    nonfinite_leaves: torch.Tensor
    loss_scale: torch.Tensor
    skipped_steps: torch.Tensor
    moe_aux: Optional[torch.Tensor] = None


def stats_partition_specs(*, moe_aux: bool = False) -> TrainStats:
    """The per-field rank layout of a :class:`TrainStats`: every field is
    replicated, the same value on every rank (``PartitionSpec()``), and
    ``None`` for an absent ``moe_aux``.

    The reference returns the ``PartitionSpec`` tree a stats output needs
    to cross a ``shard_map`` boundary.  Eager PyTorch has no such
    boundary, so here the tree only describes the layout: the fields of
    :class:`TrainStats` are replicated because they come from reduced
    values (the widened loss reduction, the host finalize of
    :class:`PartialTrainStats`), while the ``norm_partials`` that
    :func:`device_partial_norms` returns hold one row a rank, split over
    every axis of the grid."""
    from apex_tpu_torch.transformer.tensor_parallel.partition import (
        PartitionSpec as P,
    )

    return TrainStats(
        loss=P(), grad_norm=P(), param_norm=P(), nonfinite_leaves=P(),
        loss_scale=P(), skipped_steps=P(),
        moe_aux=P() if moe_aux else None,
    )


def _floating_leaves(tree):
    leaves, _ = tree_flatten(tree)
    return [torch.as_tensor(x) for x in leaves
            if x is not None and torch.as_tensor(x).is_floating_point()]


def _leaf_sumsqs(leaves):
    """Each leaf's fp32 sum of squares, the square of its L2 norm from
    one multi-tensor launch (``torch._foreach_norm``, accumulated in fp32
    without an fp32 copy of the leaf)."""
    norms = torch._foreach_norm(leaves, 2, dtype=torch.float32)
    return torch._foreach_mul(norms, norms)


def _leaf_nonfinite(leaves):
    """A bool vector, True where a leaf has a non-finite element: its
    max-abs norm (one multi-tensor launch) is then inf or NaN, and only
    then."""
    return ~torch.isfinite(torch.stack(torch._foreach_norm(
        leaves, float("inf"), dtype=torch.float32)))


@torch.no_grad()
def local_grad_stats(grads):
    """``(sumsq, nonfinite_leaves)`` of a gradient tree — pure local
    arithmetic (fp32 sum of squares; int32 count of floating leaves with
    any non-finite element).  No collective, no host sync."""
    leaves = [x.detach() for x in _floating_leaves(grads)]
    if not leaves:
        return (torch.zeros((), dtype=torch.float32),
                torch.zeros((), dtype=torch.int32))
    sumsq = torch.stack(_leaf_sumsqs(leaves)).sum()
    bad = _leaf_nonfinite(leaves).sum().to(torch.int32)
    return sumsq, bad


def _f32(x, default, device=None):
    """``x`` (or ``default``) as a 0-d fp32 tensor on ``device``; a host
    number is filled in on the device (``torch.full``), never copied
    there, so no host sync."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32)
    return torch.full((), float(default if x is None else x),
                      dtype=torch.float32, device=device)


def _i32(x, device=None):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.int32)
    return torch.full((), 0 if x is None else int(x), dtype=torch.int32,
                      device=device)


@torch.no_grad()
def train_stats(loss, grads, params, *, grad_scale=None, loss_scale=None,
                skipped_steps=None, moe_aux=None) -> TrainStats:
    """Stats for **unsharded/replicated** tensors (single-device trainers,
    host-side tests): everything is local arithmetic.  For a trainer
    whose parameters are sharded over ranks (``build_gpt_3d``) use
    :func:`device_partial_norms` + :func:`partial_train_stats`.

    ``grad_scale`` — the scale the loss (hence grads) was multiplied by;
    the reported ``grad_norm`` is divided back so it is always
    unscaled."""
    sumsq, bad = local_grad_stats(grads)
    dev = sumsq.device
    norm = torch.sqrt(sumsq)
    if grad_scale is not None:
        norm = norm * (1.0 / _f32(grad_scale, 1.0, dev))
    return TrainStats(
        loss=_f32(loss, 0.0, dev),
        grad_norm=norm,
        param_norm=tree_l2_norm(params).to(dev),
        nonfinite_leaves=bad,
        loss_scale=_f32(loss_scale, 1.0, dev),
        skipped_steps=_i32(skipped_steps, dev),
        moe_aux=moe_aux,
    )


# --- ride the existing loss all-reduce ----------------------------------

# Element layout of the packed stats vector (one widened collective):
_PACK_LOSS, _PACK_SUMSQ, _PACK_BAD, PACK_LEN = 0, 1, 2, 3


@torch.no_grad()
def pack_local_stats(loss, grads) -> torch.Tensor:
    """``[loss, grad_sumsq, nonfinite_leaves]`` as one ``(3,)`` fp32
    vector, to be **sum**-reduced over the data axes *in place of* the
    trainer's existing scalar loss reduction — the collective count stays
    exactly what the bare step had; only its payload widens by two
    elements.  Pass the loss pre-divided by any loss scale so element 0
    reduces to the same value the bare path's mean produced."""
    sumsq, bad = local_grad_stats(grads)
    loss = torch.as_tensor(loss).detach().to(torch.float32).reshape(())
    return torch.stack([loss, sumsq.to(loss.device),
                        bad.to(device=loss.device, dtype=torch.float32)])


@torch.no_grad()
def stats_from_reduced(reduced: torch.Tensor, world: int, params, *,
                       grad_scale=None, loss_scale=None, skipped_steps=None,
                       moe_aux=None):
    """Unpack the sum-reduced stats vector into ``(mean_loss,
    TrainStats)``.  ``world`` is the replica count of the reduction, so
    ``reduced[0] / world`` is the mean loss.  ``grad_norm`` here is the
    L2 norm over the *stacked* per-replica local grads (``sqrt`` of the
    summed local sums of squares); ``nonfinite_leaves`` sums every
    replica's count.  ``param_norm`` stays local arithmetic (params are
    replicated)."""
    dev = reduced.device
    loss = reduced[_PACK_LOSS] / world
    norm = torch.sqrt(reduced[_PACK_SUMSQ])
    if grad_scale is not None:
        norm = norm * (1.0 / _f32(grad_scale, 1.0, dev))
    stats = TrainStats(
        loss=loss,
        grad_norm=norm,
        param_norm=tree_l2_norm(params).to(dev),
        nonfinite_leaves=torch.round(reduced[_PACK_BAD]).to(torch.int32),
        loss_scale=_f32(loss_scale, 1.0, dev),
        skipped_steps=_i32(skipped_steps, dev),
        moe_aux=moe_aux,
    )
    return loss, stats


# --- sharded parameters: per-rank partials, host finalize ---------------


class PartialTrainStats(NamedTuple):
    """Rank-partial form of :class:`TrainStats`, for trainers whose
    params/grads are SHARDED over ranks (``build_gpt_3d``).

    A global norm over a tp/pp-sharded tree needs a cross-rank reduction,
    which the bare step does not make.  So the step emits
    ``norm_partials`` — this rank's ``[1, 2 + n_leaves]`` row of partial
    sums (:func:`device_partial_norms`, no collective) — and the final
    reduction over the rows of every rank happens on the **host**, at
    fetch time (:meth:`gathered`, then :meth:`finalize`).

    :class:`TrainStatsLogger` gathers and finalizes transparently.
    """

    loss: torch.Tensor
    norm_partials: torch.Tensor  # [D, 2+L] — see device_partial_norms
    grad_scale: torch.Tensor
    loss_scale: torch.Tensor
    skipped_steps: torch.Tensor
    moe_aux: Optional[torch.Tensor] = None

    def gathered(self) -> "PartialTrainStats":
        """The same stats with every rank's rows of ``norm_partials``
        (an all-gather over the default process group, made at fetch
        time, outside the step; every rank must call it).  Without a
        process group of more than one rank, ``self``."""
        import torch.distributed as dist

        if not dist.is_available() or not dist.is_initialized() \
                or dist.get_world_size() == 1:
            return self
        rows = self.norm_partials.detach()
        out = [torch.empty_like(rows) for _ in range(dist.get_world_size())]
        dist.all_gather(out, rows)
        return self._replace(norm_partials=torch.cat(out))

    def finalize(self) -> TrainStats:
        """Host-side reduction of the partials matrix (numpy; the rows it
        holds — call on :meth:`gathered` stats for the global value)."""
        parts = _host(self.norm_partials).astype(np.float32)
        g_sumsq = parts[:, 0].sum()
        p_sumsq = parts[:, 1].sum()
        # A leaf is non-finite if ANY rank's shard of it was.
        leaf_bad = parts[:, 2:].max(axis=0) > 0.5
        inv = 1.0 / float(np.float32(_host(self.grad_scale)))
        return TrainStats(
            loss=np.float32(_host(self.loss)),
            grad_norm=np.float32(np.sqrt(g_sumsq) * inv),
            param_norm=np.float32(np.sqrt(p_sumsq)),
            nonfinite_leaves=np.int32(leaf_bad.sum()),
            loss_scale=np.float32(_host(self.loss_scale)),
            skipped_steps=np.int32(_host(self.skipped_steps)),
            moe_aux=None if self.moe_aux is None else _host(self.moe_aux),
        )


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def device_partial_norms(mesh, param_specs, *, split_leaves=None):
    """Build ``fn(grads, params) -> [1, 2 + n_leaves]`` — this rank's row
    of norm partials feeding :class:`PartialTrainStats`, pure local
    arithmetic (no collective).  Columns:

    - 0 — this rank's gradient sum of squares, each leaf weighted by
      1/replication (a leaf replicated over grid axes its spec does not
      name would otherwise be counted once per replica), so the column's
      SUM over every rank is the exact global sum of squares;
    - 1 — the same for the params;
    - ``2+k`` — 1.0 iff any element of this rank's shard of gradient
      leaf ``k`` is non-finite (the host ORs the column across ranks,
      then counts flagged leaves).

    ``mesh``: the rank grid (:class:`~apex_tpu_torch.parallel.mesh.
    RankMesh`, its ``shape`` the size of each axis), or ``None`` for the
    initialized grid (one rank when there is none).  ``param_specs``: the
    :class:`~apex_tpu_torch.transformer.tensor_parallel.PartitionSpec`
    tree of the parameters.  ``split_leaves``: a tree like ``param_specs``
    of ``PartitionSpec``s naming the axes each leaf is also split over
    though its spec does not say so (the 3D step's layer stack over
    ``pp``: each pipeline rank holds its own stages), ``None`` for none.
    Leaves are taken in the JAX order (dict keys sorted)."""
    from apex_tpu_torch.parallel import collectives as cc
    from apex_tpu_torch.parallel import mesh as mesh_lib
    from apex_tpu_torch.transformer.tensor_parallel.partition import (
        PartitionSpec,
    )

    if mesh is None and mesh_lib.model_parallel_is_initialized():
        mesh = mesh_lib.get_mesh()
    if mesh is None:
        shape = {}
    else:
        shape = dict(mesh.shape)
    n_devices = int(np.prod(list(shape.values()))) if shape else 1

    def size(axis) -> int:
        if axis is None:
            return 1
        if isinstance(axis, (tuple, list)):
            return int(np.prod([size(a) for a in axis]))
        return shape.get(axis, cc.bound_axis_size(axis) if shape else 1)

    spec_leaves = _spec_leaves(param_specs, PartitionSpec)
    extra = ([PartitionSpec()] * len(spec_leaves) if split_leaves is None
             else _spec_leaves(split_leaves, PartitionSpec))
    weights = []
    for spec, more in zip(spec_leaves, extra):
        axes = {a for entry in tuple(spec) + tuple(more) if entry is not None
                for a in (entry if isinstance(entry, (tuple, list))
                          else (entry,))}
        weights.append(size(tuple(sorted(axes))) / n_devices)

    @torch.no_grad()
    def fn(grads, params):
        g_leaves, _ = tree_flatten(grads)
        p_leaves, _ = tree_flatten(params)
        if len(g_leaves) != len(weights) or len(p_leaves) != len(weights):
            raise ValueError(
                f"param_specs leaves ({len(weights)}) do not match "
                f"grads ({len(g_leaves)}) / params ({len(p_leaves)})")

        g_leaves = [torch.as_tensor(x).detach() for x in g_leaves]
        p_leaves = [torch.as_tensor(x).detach() for x in p_leaves]

        def wsumsq(leaves):
            return torch.stack(torch._foreach_mul(_leaf_sumsqs(leaves),
                                                  weights)).sum()

        flags = _leaf_nonfinite(g_leaves).to(torch.float32)
        vec = torch.cat([torch.stack([wsumsq(g_leaves), wsumsq(p_leaves)]),
                         flags])
        return vec[None, :]

    return fn


def _spec_leaves(tree, spec_type):
    """The specs of a spec tree in the JAX order (a spec, itself a tuple,
    is one leaf)."""
    if isinstance(tree, spec_type):
        return [tree]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _spec_leaves(tree[k],
                                                              spec_type)]
    return [s for v in tree for s in _spec_leaves(v, spec_type)]


@torch.no_grad()
def partial_train_stats(loss, norm_partials, *, grad_scale=None,
                        loss_scale=None, skipped_steps=None,
                        moe_aux=None) -> PartialTrainStats:
    """Assemble a :class:`PartialTrainStats` (defaults mirror
    :func:`train_stats`; ``grad_scale`` divides the reported grad norm
    back to unscaled at finalize time)."""
    dev = norm_partials.device
    return PartialTrainStats(
        loss=_f32(loss, 0.0, dev),
        norm_partials=norm_partials,
        grad_scale=_f32(grad_scale, 1.0, dev),
        loss_scale=_f32(loss_scale, 1.0, dev),
        skipped_steps=_i32(skipped_steps, dev),
        moe_aux=moe_aux,
    )


# --- host side: the log_every_n fetch ------------------------------------


class TrainStatsLogger:
    """The only place device stats meet the host — on a schedule.

    ``maybe_log(step, stats)`` is a no-op (not even a device poll) except
    every ``every_n``-th step, when the :class:`TrainStats` is fetched
    (one blocking copy of a handful of scalars), written into the
    registry's gauges, and flushed to ``writer`` (a
    :class:`apex_tpu_torch.observability.JsonlWriter`) — so the
    steady-state step stays asynchronous while the logged step pays one
    small sync.  Returns the fetched ``dict`` when it logged, else
    ``None``.  With :class:`PartialTrainStats` over several ranks every
    rank must log the same steps (the fetch gathers their rows).
    """

    def __init__(self, registry=None, *, every_n: int = 50, writer=None,
                 prefix: str = "train"):
        if every_n < 1:
            raise ValueError(f"every_n must be >= 1, got {every_n}")
        if registry is None:
            from apex_tpu_torch.observability.metrics import (
                default_registry,
            )

            registry = default_registry()
        self.registry = registry
        self.every_n = every_n
        self.writer = writer
        self.prefix = prefix

    def fetch(self, stats) -> dict:
        """Blocking device→host fetch of one stats tuple
        (:class:`TrainStats` or :class:`PartialTrainStats` — partials are
        gathered and finalized here), flattened to plain floats/ints
        (``moe_aux`` becomes a list)."""
        if isinstance(stats, PartialTrainStats):
            stats = stats.gathered().finalize()
        out = {}
        for name, val in zip(TrainStats._fields, stats):
            if val is None:
                continue
            arr = _host(val)
            if arr.ndim == 0:
                out[name] = (int(arr) if np.issubdtype(arr.dtype, np.integer)
                             else float(arr))
            else:
                out[name] = [float(v) for v in arr.tolist()]
        return out

    def maybe_log(self, step: int, stats, extra: Optional[dict] = None):
        if step % self.every_n:
            return None
        return self.log(step, stats, extra=extra)

    def log(self, step: int, stats, extra: Optional[dict] = None) -> dict:
        """Unconditional fetch + record (the ``every_n`` hit path)."""
        values = self.fetch(stats)
        for name, val in values.items():
            if isinstance(val, list):  # per-microbatch vector: log the mean
                if val:
                    self.registry.gauge(
                        f"{self.prefix}/{name}_mean").set(
                            sum(val) / len(val))
                continue
            self.registry.gauge(f"{self.prefix}/{name}").set(val)
        self.registry.counter(f"{self.prefix}/logged_steps").inc()
        record = dict(values)
        if extra:
            record.update(extra)
        self.registry.flush(self.writer, step=step, extra=record)
        return values
