"""Restore training checkpoints onto the serving engine (port of
:mod:`apex_tpu.serving.loader`).

Serving is one more grid with two twists:

- the serving grid has ``pp = 1`` (the decode step runs every layer on
  every rank), so the training ``[vpp, pp, ...]`` layer stack becomes
  ``[L, 1, ...]``.  Both are row-major views of the same
  virtual-stage-major logical ``[L]`` stack
  (``gpt3d_logical_folds``), so the re-factor is a reshape, bit for bit;
- serving needs only the params subtree of the saved train state, so the
  loader reads :func:`~apex_tpu_torch.resilience.reshard.load_logical`'s
  mesh-independent ``{path: leaf}`` view and places just the
  ``params/...`` leaves on the serving template: an optimizer-state
  layout change never breaks a rollout.

Verification and the corrupt-newest fallback mirror ``restore_latest``.
The port's engine takes the whole parameters on every rank and keeps its
tensor-parallel shard itself, so the restored tree is whole on each rank.

Cookbook::

    mgr = CheckpointManager(ckpt_dir, sharded=True, spec=spec)
    mgr.save({"params": params, "opt": opt.opt_state(params),
              "sent": sent}, step)
    ...
    params, specs = restore_gpt_for_serving(ckpt_dir, config)
    engine = ServingEngine(config, ServingConfig(...), params)
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Tuple

import numpy as np

__all__ = ["restore_gpt_for_serving", "serving_like"]

logger = logging.getLogger(__name__)


def serving_like(config, mesh=None, *, tp_axis: str = "tp", seed: int = 0,
                 device=None):
    """A serving ``(params, specs)`` template for ``config`` on
    ``device`` (default: the card), built by ``build_gpt_3d``'s own init
    at pp = 1 (``num_chunks = num_layers``, so the stack is ``[L, 1,
    ...]``): the one source of shapes, dtypes and tree structure.  The
    parameters are whole (the engine shards them); ``specs`` are their
    PartitionSpecs over ``tp_axis``."""
    from apex_tpu_torch.transformer.testing.gpt_parallel_train import (
        build_gpt_3d,
    )

    if mesh is not None and mesh.shape["pp"] != 1:
        raise ValueError(
            f"serving mesh must have pp=1 (got pp={mesh.shape['pp']}); "
            "a 1-token decode step has no pipeline to fill")
    whole = dataclasses.replace(config, tensor_axis=None,
                                sequence_parallel=False)
    init_fn, _, _ = build_gpt_3d(
        whole, num_chunks=config.num_layers, num_microbatches=1,
        mesh=mesh, tp_axis=tp_axis, device=device)
    params, specs = init_fn(seed=seed)
    from apex_tpu_torch.amp._tree import tree_map

    return tree_map(lambda t: t.detach(), params), specs


def _place_subtree(logical: dict, like, prefix: str):
    """The logical ``{path: array}`` leaves under ``prefix/`` placed on
    the template tree (reshape only, the template's dtypes and device)."""
    from apex_tpu_torch.checkpoint import (
        CheckpointCorruptError,
        _as_template,
        _leaves_with_path,
        _path_str,
        _unflatten,
    )

    out = []
    for p, tleaf in _leaves_with_path(like):
        path = f"{prefix}/{_path_str(p)}"
        if path not in logical:
            raise CheckpointCorruptError(
                f"checkpoint has no leaf {path!r} (saved tree does not "
                f"carry the served params under {prefix!r}?)")
        host = logical[path]
        tgt_shape = tuple(tleaf.shape)
        if int(np.prod(host.shape)) != int(np.prod(tgt_shape)):
            raise CheckpointCorruptError(
                f"{path}: logical shape {list(host.shape)} cannot "
                f"reshape to serving shape {list(tgt_shape)}")
        host = np.asarray(host, order="C").reshape(tgt_shape)
        out.append(_as_template(host, None, tleaf))
    return _unflatten(like, out)


def restore_gpt_for_serving(ckpt_dir: str, config, *, mesh=None,
                            tp_axis: str = "tp", key: str = "params",
                            sharded: bool = True, verify: bool = True,
                            with_step: bool = False, device=None
                            ) -> Tuple[object, ...]:
    """Restore the newest intact GPT checkpoint for serving.

    ``ckpt_dir`` is a :class:`~apex_tpu_torch.resilience.CheckpointManager`
    directory whose checkpoints hold the train state as a mapping with the
    ``GPT3DParams`` under ``key`` (the 3D trainer's convention); the
    optimizer state and sentinel are ignored.  Returns ``(params, specs)``
    with the layer stack in the serving ``[L, 1, ...]`` form, from
    whatever ``(vpp, pp, tp, dp)`` layout the checkpoint was trained on,
    on ``device`` (default: the card; ``"cpu"`` for the CPU).
    ``with_step=True`` returns ``(params, specs, step)``: a fleet replica
    reports the step it serves, so a fallback past a corrupt newest
    checkpoint is visible.
    """
    from apex_tpu_torch import checkpoint as ckpt
    from apex_tpu_torch.observability.spans import span
    from apex_tpu_torch.resilience import CheckpointManager, reshard

    like_params, specs = serving_like(config, mesh, tp_axis=tp_axis,
                                      device=device)
    mgr = CheckpointManager(ckpt_dir, sharded=sharded)
    failures = []
    with span("serving/restore"):
        for step in reversed(mgr.all_steps()):
            try:
                if verify:
                    mgr.verify(step)
                logical, _ = reshard.load_logical(mgr.step_path(step))
                params = _place_subtree(logical, like_params, key)
                if failures:
                    logger.warning(
                        "serving restore fell back to step %d past %s",
                        step, "; ".join(failures))
                if with_step:
                    return params, specs, step
                return params, specs
            except (ckpt.CheckpointCorruptError, ValueError, OSError,
                    KeyError) as e:
                failures.append(f"step {step}: {e!r}")
                logger.warning(
                    "checkpoint step %d unusable for serving (%r); "
                    "falling back", step, e)
    raise FileNotFoundError(
        f"no checkpoint under {ckpt_dir!r} restorable for serving"
        + (f" (tried: {'; '.join(failures)})" if failures else ""))
