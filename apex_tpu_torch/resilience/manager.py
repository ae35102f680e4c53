"""Crash-safe checkpoint lifecycle, the ``CheckpointManager`` (port of
:mod:`apex_tpu.resilience.manager`).

:mod:`apex_tpu_torch.checkpoint` makes one save atomic and verifiable
(temp + fsync + rename, per-array crc32); this module owns the sequence
of saves a run makes: step-indexed paths, keep-last-k retention, retry
with backoff on transient I/O errors, and a ``restore_latest`` that falls
back to the previous intact checkpoint when the newest fails
verification.

Layout under ``directory``::

    step_00000003.npz        # flat layout (sharded=False)
    step_00000007/           # sharded layout (sharded=True)
        shard_0.npz ... shard_{P-1}.npz
        manifest.json        # committed last; authority for restore

Several ranks: ``save`` (sync, sharded) is collective; call it from every
rank.  Retries run at world size 1 only: a collective save has a fixed
barrier sequence, and one rank re-entering it would deadlock its peers.
"""

from __future__ import annotations

import logging
import os
import re
import shutil
import time
from typing import Any, Optional

from apex_tpu_torch import checkpoint as ckpt
from apex_tpu_torch.observability import timeline
from apex_tpu_torch.observability.spans import span

__all__ = ["CheckpointManager"]

logger = logging.getLogger(__name__)

_STEP_RE = re.compile(r"^step_(\d{8,})(\.npz)?$")  # :08d grows past 8


class CheckpointManager:
    """Manage a directory of step-indexed checkpoints.

    ``keep``      — retain at most this many newest **committed**
                    checkpoints; an uncommitted step (a crashed or
                    in-flight save) never displaces a durable one, the
                    in-flight async step and any step a ``restore_latest``
                    is reading are pinned, and uncommitted steps older
                    than the newest committed one are reaped.
    ``sharded``   — the per-rank ``save_checkpoint_sharded`` layout (one
                    directory per step) instead of one file per step.
    ``spec``      — optional :class:`~apex_tpu_torch.resilience.reshard.
                    ShardingSpec`: embedded in every save's manifest, the
                    placement of each rank's slices, and the default
                    target spec of ``restore_latest``.
    ``retries`` / ``backoff_s`` — an ``OSError`` in a sync save (or in
                    the snapshot and submission of an async one) is
                    retried up to ``retries`` times, sleeping
                    ``backoff_s * 2**k``; a failed background write is
                    raised once from ``wait()`` or the next save.
    """

    def __init__(self, directory: str, *, keep: int = 3,
                 sharded: bool = False, retries: int = 3,
                 backoff_s: float = 0.25, spec=None):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = directory
        self.keep = keep
        self.sharded = sharded
        self.retries = retries
        self.backoff_s = backoff_s
        self.spec = spec
        self._inflight = None  # (step, handle) of the pending async save
        self._pinned: set = set()  # steps a restore is currently reading
        os.makedirs(directory, exist_ok=True)

    # -- paths ---------------------------------------------------------

    def _path(self, step: int) -> str:
        name = f"step_{step:08d}"
        return os.path.join(self.directory,
                            name if self.sharded else name + ".npz")

    def step_path(self, step: int) -> str:
        """One step's checkpoint artifact (the shard directory or the
        flat ``.npz``), for readers of a subtree such as
        :mod:`apex_tpu_torch.serving.loader`."""
        return self._path(step)

    def all_steps(self):
        """Step numbers with a checkpoint present, ascending (presence,
        not integrity: ``restore_latest`` verifies)."""
        steps = []
        try:
            entries = os.listdir(self.directory)
        except OSError:
            return []
        for name in entries:
            m = _STEP_RE.match(name)
            if m is None:
                continue
            is_dir = m.group(2) is None
            if is_dir != self.sharded:
                continue
            steps.append(int(m.group(1)))
        return sorted(steps)

    # -- save ----------------------------------------------------------

    def _with_retries(self, fn, what: str):
        """Run ``fn``, retrying a transient ``OSError`` with backoff; one
        attempt at world size > 1 (a collective save must not be
        re-entered by one rank)."""
        retries = self.retries if ckpt.process_count() == 1 else 0
        for attempt in range(retries + 1):
            try:
                return fn()
            except OSError as e:
                if attempt == retries:
                    raise
                delay = self.backoff_s * (2.0 ** attempt)
                logger.warning(
                    "%s failed (%r), retry %d/%d in %.2fs",
                    what, e, attempt + 1, retries, delay)
                time.sleep(delay)

    def save(self, tree: Any, step: int) -> str:
        """Synchronous checkpoint of ``tree`` at ``step``; returns its
        path.  Waits for an in-flight async save first (raising its
        failure), then applies retention."""
        self.wait()
        path = self._path(step)
        # the span_ms/checkpoint/save histogram makes the stall a metric,
        # the timeline event attributes it to the goodput checkpoint
        # bucket (no-op when no recorder is armed)
        with span("checkpoint/save"), \
                timeline.scope("checkpoint_save", step=step):
            if self.sharded:
                self._with_retries(
                    lambda: ckpt.save_checkpoint_sharded(
                        path, tree, step=step, spec=self.spec),
                    f"sharded save step {step}")
            else:
                self._with_retries(
                    lambda: ckpt.save_checkpoint(path, tree, step=step,
                                                 spec=self.spec),
                    f"save step {step}")
        self._apply_retention()
        return path

    def save_async(self, tree: Any, step: int):
        """Overlapped checkpoint: the snapshot now (the tensors may change
        once this returns), the write in the background.  Returns the
        handle; the next ``save``/``save_async``/``wait`` drains it and
        re-raises a write failure, and applies retention."""
        self.wait()
        path = self._path(step)
        # only the snapshot and submission are on the training thread;
        # the span bounds exactly that step-time cost
        with span("checkpoint/save_async_submit"), \
                timeline.scope("checkpoint_save_async_submit", step=step):
            if self.sharded:
                handle = self._with_retries(
                    lambda: ckpt.save_checkpoint_sharded_async(
                        path, tree, step=step, spec=self.spec),
                    f"async sharded save step {step}")
            else:
                handle = self._with_retries(
                    lambda: ckpt.save_checkpoint_async(
                        path, tree, step=step, spec=self.spec),
                    f"async save step {step}")
        self._inflight = (step, handle)
        return handle

    def wait(self, timeout: Optional[float] = None) -> None:
        """Drain the in-flight async save (the sharded commit included),
        re-raising its failure; no-op when idle.  A checkpoint is durable
        only once waited on.  A ``timeout`` expiry keeps the handle
        tracked; a failure is raised once and nothing is deleted (the
        same path may hold an older durable save)."""
        if self._inflight is None:
            return
        import concurrent.futures

        step, handle = self._inflight
        try:
            if hasattr(handle, "finalize"):  # ShardedSaveHandle
                handle.finalize(timeout)
            else:
                handle.result(timeout)
        except (TimeoutError, concurrent.futures.TimeoutError):
            raise  # still writing: keep tracking, the caller may wait again
        except Exception:
            self._inflight = None
            raise
        self._inflight = None
        self._apply_retention()

    def _discard(self, path: str) -> None:
        try:
            if os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)
            elif os.path.exists(path):
                os.unlink(path)
        except OSError:
            pass

    def _is_committed(self, step: int) -> bool:
        """A step is committed when its durable artifact exists: the
        ``.npz`` (flat: the rename is the commit) or the step directory's
        ``manifest.json`` (sharded: written last)."""
        path = self._path(step)
        if not self.sharded:
            return os.path.exists(path)
        return os.path.exists(os.path.join(path, "manifest.json"))

    def _apply_retention(self) -> None:
        """Drop committed checkpoints beyond the ``keep`` newest committed
        ones (pinned steps exempt), and reap uncommitted steps strictly
        older than the newest committed one (a live writer is never older
        than a later commit).  Rank 0 alone deletes."""
        if ckpt.process_index() != 0:
            return
        all_steps = self.all_steps()
        committed = [s for s in all_steps if self._is_committed(s)]
        pinned = set(self._pinned)
        if self._inflight is not None:
            pinned.add(self._inflight[0])
        for step in committed[:-self.keep]:  # keep >= 1 (__init__)
            if step in pinned:
                logger.info(
                    "retention: step %d is referenced (in-flight save or "
                    "active restore), not dropping", step)
                continue
            logger.info("retention: dropping checkpoint step %d", step)
            self._discard(self._path(step))
        if committed:
            for step in all_steps:
                if (step >= committed[-1] or step in pinned
                        or self._is_committed(step)):
                    continue
                logger.info(
                    "retention: reaping dead uncommitted artifact "
                    "step %d", step)
                self._discard(self._path(step))

    # -- restore -------------------------------------------------------

    def verify(self, step: int) -> dict:
        """Integrity pass over one step (checksums, torn files); raises
        :class:`apex_tpu_torch.checkpoint.CheckpointCorruptError`."""
        path = self._path(step)
        with span("checkpoint/verify"), \
                timeline.scope("checkpoint_verify", step=step):
            if self.sharded:
                return ckpt.verify_checkpoint_sharded(path)
            return ckpt.verify_checkpoint(path)

    def _template_matches(self, step: int, like: Any, spec) -> bool:
        """True when the stored global shapes equal the template's (the
        same-grid case, restored through the plain path); a read problem
        gives True so the plain restore raises the real error."""
        try:
            manifest = self._manifest(step)
            flat = ckpt._leaves_with_path(like)
            leaves = manifest.get("leaves", [])
            if len(leaves) != len(flat):
                return True
            places = ckpt._places(flat, spec)
            return all(tuple(rec["shape"]) == place.global_shape
                       for rec, place in zip(leaves, places))
        except Exception:
            return True

    def _bare_spec(self, step: int, spec):
        """A spec built from ``mesh`` alone, given the leaf records of the
        candidate's own spec that it lacks (the axes of the ZeRO state
        and of every other split leaf are names, placed on the live
        grid); ``spec`` as it is when the candidate's manifest is
        missing, cannot be read or holds no spec (the restore then
        raises the real error)."""
        import zipfile

        from apex_tpu_torch.resilience import reshard

        try:
            doc = self._manifest(step).get("sharding_spec")
        except (OSError, KeyError, ValueError, zipfile.BadZipFile,
                ckpt.CheckpointCorruptError):
            return spec
        if doc is None:
            return spec
        return reshard.with_source_leaves(
            spec, reshard.ShardingSpec.from_json(doc))

    def _manifest(self, step: int) -> dict:
        """One step's manifest without a checksum pass."""
        import json

        import numpy as np

        path = self._path(step)
        if not self.sharded:
            with np.load(path, allow_pickle=False) as data:
                return json.loads(str(data["__manifest__"]))
        shard_paths = ckpt._shard_paths(path)
        if not shard_paths:
            raise ckpt.CheckpointCorruptError(f"{path}: no shard files")
        with np.load(shard_paths[0], allow_pickle=False) as data:
            return json.loads(str(data["__manifest__"]))

    def restore_latest(self, like: Any, *, verify: bool = True,
                       spec=None, mesh=None):
        """Restore the newest intact checkpoint into the structure of
        ``like`` (its tensors this rank's shards, placed by ``spec``);
        returns ``(tree, step)``.

        Newest first, each candidate is verified (a full checksum pass)
        before the restore; one that fails verification or restore is
        logged and skipped.  Raises ``FileNotFoundError`` when no intact
        checkpoint exists.  With a target ``spec`` (default the manager's;
        or a bare one built from ``mesh``) a candidate whose stored shapes
        differ from the template's restores through
        :func:`~apex_tpu_torch.resilience.reshard.restore_resharded`.
        ``verify=False`` trades the second read for speed.

        The attempt runs under a ``span_ms/checkpoint/restore_latest``
        histogram, and the candidates skipped before success are counted
        into ``ckpt/fallback_depth`` in the default registry.
        """
        if spec is None:
            spec = self.spec
        bare = spec is None and mesh is not None
        if bare:
            from apex_tpu_torch.resilience import reshard

            spec = reshard.build_spec(like, mesh=mesh)
        failures = []
        with span("checkpoint/restore_latest"):
            for step in reversed(self.all_steps()):
                path = self._path(step)
                self._pinned.add(step)
                try:
                    if verify:
                        self.verify(step)
                    cand = self._bare_spec(step, spec) if bare else spec
                    resharded = (cand is not None and not
                                 self._template_matches(step, like, cand))
                    # verify and restore are disjoint timeline intervals
                    with span("checkpoint/restore"), \
                            timeline.scope("checkpoint_restore", step=step,
                                           resharded=resharded):
                        if resharded:
                            from apex_tpu_torch.resilience import reshard

                            tree, at = reshard.restore_resharded(
                                path, like, cand)
                        elif self.sharded:
                            tree, at = ckpt.restore_checkpoint_sharded(
                                path, like, spec=cand)
                        else:
                            tree, at = ckpt.restore_checkpoint(
                                path, like, spec=cand)
                    if failures:
                        logger.warning(
                            "restore_latest fell back to step %d past %s",
                            step, "; ".join(failures))
                    from apex_tpu_torch.observability.metrics import (
                        default_registry,
                    )

                    default_registry().counter(
                        "ckpt/fallback_depth").inc(len(failures))
                    return tree, at
                except (ckpt.CheckpointCorruptError, ValueError, OSError,
                        KeyError) as e:
                    failures.append(f"step {step}: {e!r}")
                    logger.warning(
                        "checkpoint step %d unusable (%r); falling back",
                        step, e)
                finally:
                    self._pinned.discard(step)
        raise FileNotFoundError(
            f"no intact checkpoint under {self.directory!r}"
            + (f" (tried: {'; '.join(failures)})" if failures else ""))
