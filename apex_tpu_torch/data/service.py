"""Data-service split: dedicated loader processes feeding the trainer
(port of :mod:`apex_tpu.data.service`).

The third scaling stage of the input pipeline (after in-process worker
pools and per-host ``dp_ranks`` sharding): move the WHOLE loader — the
sampler walk, the decode/gather pool, the batch assembly — into a
dedicated process, and hand the training process nothing but a local
queue to pop.  This is the tf.data-service / grain per-host split at
single-host scope: the trainer's Python thread spends zero time in
decode glue (no GIL contention with dispatch), the loader process can be
scheduled/priority-pinned independently, and an OOM or codec crash in
the loader surfaces as a clean relayed exception instead of taking the
training step down.

The service keeps the loader resume surface (``local_batch``/``dp``/
``consumed_samples``) so :func:`~apex_tpu_torch.data.prefetch.
prefetch_to_device` composes unchanged on top::

    svc = DataService(make_loader, consumed_samples=restored)
    for batch in prefetch_to_device(svc, mesh):
        ...
    # checkpoint prefetcher.consumed_samples; on restore rebuild both

``factory`` must be picklable (a module-level function or
``functools.partial`` over picklable args): the child process calls
``factory(consumed_samples)`` to build the loader, then streams batches
continuously ACROSS epochs (re-iterating the loader at each epoch end —
the Megatron samplers advance through epochs by ``consumed_samples``),
so the service is an infinite stream like
``synthetic_image_batches``, not a one-epoch iterator.

``consumed_samples`` counts GLOBAL samples in batches delivered to the
consuming process — batches buffered in the queue (or in the child) are
NOT counted, so a checkpoint taken between steps resumes at the first
undelivered batch, exactly the loaders' contract.

The child never touches CUDA: the loader yields numpy batches, which
cross the queue pickled, and placement on the card happens in the
trainer (``prefetch_to_device``).  This module imports no torch.
"""

from __future__ import annotations

import logging
import queue as queue_mod
from typing import Callable, Optional

__all__ = ["DataService"]

logger = logging.getLogger(__name__)


def _shutdown_service(stop, proc) -> None:
    """Minimal teardown used by the GC/exit finalizer: signal, join,
    escalate.  Must exist because the service process is non-daemonic —
    multiprocessing's own atexit hook JOINS non-daemon children, so a
    service leaked without close() would deadlock interpreter exit;
    ``weakref.finalize`` callbacks run before that hook (atexit is LIFO
    and multiprocessing registers first, at import)."""
    from apex_tpu_torch.data._producer import reap_process

    stop.set()
    reap_process(proc, 10.0, what="data-service process")


def _service_worker(factory: Callable, consumed_samples: int, q,
                    stop, parent_pid: int) -> None:
    """Loader-process main: build the loader, stream batches + their
    post-delivery consumed_samples forever; relay errors; honor stop.

    The service process is deliberately NON-daemonic (a daemonic process
    may not spawn children, which would forbid the documented
    ``ImageFolderLoader(backend="process")`` factory), so it watches for
    orphanhood itself: when the parent dies without a clean ``close()``
    (SIGKILL), the ppid changes and the worker exits instead of living
    on as a detached loader."""
    import os

    def orphaned() -> bool:
        return os.getppid() != parent_pid

    loader = None
    try:
        loader = factory(consumed_samples)
        meta = (int(loader.local_batch), int(loader.dp))
        q.put(("meta", meta))
        while not (stop.is_set() or orphaned()):
            delivered_any = False
            for batch in loader:
                delivered_any = True
                while not (stop.is_set() or orphaned()):
                    try:
                        q.put(("batch", batch), timeout=0.2)
                        break
                    except queue_mod.Full:
                        continue
                if stop.is_set() or orphaned():
                    return
            if not delivered_any:
                # a loader that yields nothing would spin this loop hot
                q.put(("error", RuntimeError(
                    "DataService loader yielded no batches")))
                return
    except BaseException as e:  # noqa: BLE001 — relayed, not eaten
        # Pre-test picklability HERE: mp.Queue.put pickles later, in the
        # feeder thread — an unpicklable exception would be dropped
        # silently there, never raising at this put() call.
        import pickle

        try:
            pickle.dumps(e)
        except Exception:
            e = RuntimeError(repr(e))  # degrade to its repr
        q.put(("error", e))
    finally:
        close = getattr(loader, "close", None)
        if callable(close):
            close()


class DataService:
    """Run a loader in a dedicated process; iterate its batches here.

    ``factory(consumed_samples) -> loader`` builds the loader inside the
    service process (so the decode pool, memmaps and samplers never live
    in the trainer).  ``depth`` bounds the inter-process queue — the
    double-buffer window between loader and trainer.  ``start_method``
    defaults to ``spawn`` (a forked child inheriting the trainer's CUDA
    context and threads can deadlock).

    The service exposes the loader resume surface (``local_batch``,
    ``dp``, ``consumed_samples``) read from a startup handshake, so
    ``prefetch_to_device`` and ``CheckpointManager`` compose exactly as
    with an in-process loader.
    """

    def __init__(self, factory: Callable, *, consumed_samples: int = 0,
                 depth: int = 4, start_method: str = "spawn"):
        import multiprocessing as mp
        import os

        self._ctx = mp.get_context(start_method)
        self._queue = self._ctx.Queue(maxsize=max(1, depth))
        self._stop = self._ctx.Event()
        self._consumed0 = consumed_samples
        self._delivered = 0
        self._meta: Optional[tuple] = None
        self._closed = False
        # NON-daemonic: a daemonic process may not have children, which
        # would forbid factories that build process-backend loaders (the
        # documented composition).  Orphan safety comes from the
        # worker's own ppid watchdog (see _service_worker).
        self._proc = self._ctx.Process(
            target=_service_worker,
            args=(factory, consumed_samples, self._queue, self._stop,
                  os.getpid()),
            daemon=False, name="apex-data-service")
        self._proc.start()
        import weakref

        self._finalizer = weakref.finalize(
            self, _shutdown_service, self._stop, self._proc)

    # -- handshake / resume surface ------------------------------------

    def _ensure_meta(self, timeout: float = 120.0) -> tuple:
        if self._meta is None:
            kind, payload = self._get(timeout)
            if kind == "error":
                raise payload
            if kind != "meta":
                raise RuntimeError(
                    f"DataService handshake got {kind!r} before meta")
            self._meta = payload
        return self._meta

    @property
    def local_batch(self) -> int:
        return self._ensure_meta()[0]

    @property
    def dp(self) -> int:
        return self._ensure_meta()[1]

    @property
    def consumed_samples(self) -> int:
        """GLOBAL samples in batches delivered to THIS process."""
        return (self._consumed0
                + self._delivered * self.local_batch * self.dp)

    # -- stream ---------------------------------------------------------

    def _get(self, timeout: float):
        import queue as q_mod

        deadline = None if timeout is None else timeout
        try:
            return self._queue.get(timeout=deadline)
        except q_mod.Empty:
            if not self._proc.is_alive():
                raise RuntimeError(
                    "DataService loader process died without relaying an "
                    f"error (exitcode {self._proc.exitcode})") from None
            raise

    def __iter__(self) -> "DataService":
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        self._ensure_meta()
        while True:
            try:
                kind, payload = self._get(timeout=5.0)
            except queue_mod.Empty:
                continue  # slow loader; the process is alive, keep waiting
            if kind == "error":
                raise payload
            self._delivered += 1
            return payload

    # -- shutdown -------------------------------------------------------

    def close(self, timeout: float = 10.0) -> None:
        """Stop the loader process (idempotent): signal, drain, join;
        escalate to terminate/kill if it does not exit in ``timeout``."""
        if self._closed:
            return
        self._closed = True
        self._finalizer.detach()  # close() supersedes the exit guard
        self._stop.set()
        # drain so a child blocked on a full queue can see the stop flag
        try:
            while True:
                self._queue.get_nowait()
        except Exception:
            pass
        from apex_tpu_torch.data._producer import reap_process

        reap_process(self._proc, timeout, what="data-service process")
        self._queue.close()

    def __enter__(self) -> "DataService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # best-effort backstop
        try:
            self.close()
        except Exception:
            pass
