"""Device-transfer prefetch: overlap host->device copies with compute
(port of :mod:`apex_tpu.data.prefetch`).

Behavioral spec: the reference's ``data_prefetcher``
(``examples/imagenet/main_amp.py:256-276``) — batch N+1's H2D copy runs
on a side CUDA stream while the model computes on batch N, so the copy
never sits on the step's critical path.

The JAX package gets that overlap from ``jax.device_put``, which is
asynchronous.  Here it is built by hand.  A dedicated transfer thread
pulls host batches from the source and, for each one:

1. copies every array leaf into page-locked (pinned) host memory;
2. issues ``.to(device, non_blocking=True)`` for each leaf on a side
   CUDA stream of its own (the thread sets its device and stream
   context), and records an event on that stream;
3. queues the device batch with its event (bounded by ``depth``).

The thread keeps each pinned buffer alive until its copy's event has
passed (``Event.query``, which does not block), so a buffer is never
freed under a copy in flight.  The consumer's ``__next__`` makes its
current stream wait on the event (``Stream.wait_event``, which does not
block the host) and calls ``record_stream`` on every delivered tensor
for that stream, so the caching allocator does not hand the tensor's
memory to a later copy on the side stream while the step still reads it.
Nothing here synchronizes the host with the card.  While step N
computes, batch N+1's copy is in flight *and* the source's own decode
pool is filling batch N+2.  On the CPU (``device="cpu"``) the placement
is ``torch.as_tensor``, with no stream.

The consumer only blocks when all of the pipeline falls behind, and that
block is the **stall**: every ``__next__`` records it into the
``data/stall_ms`` gauge (last step) and the ``span_ms/data/next_wait``
histogram of the default :class:`~apex_tpu_torch.observability.metrics.
MetricRegistry`, inside the ``apex/data/next_wait`` profiler range
(:func:`~apex_tpu_torch.observability.spans.named_span`), and emits a
``data_stall`` interval into the flight recorder when one is armed.

Composition contract (enforced): wrap a **loader** (``ImageFolderLoader``
/ ``PackedLoader`` / ``PackedSequenceLoader`` / ``DataService``) directly
— nothing in between — and checkpoint the *wrapper's*
``consumed_samples``.  Wrapping another :class:`DevicePrefetcher` raises
immediately rather than mis-counting ``local_batch * dp`` from the wrong
layer.  With a mesh, or once model parallelism is set up, a batch is
first cut to this rank's data-parallel slice
(:func:`~apex_tpu_torch.parallel.dp_shard_batch`), then placed.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Callable, Iterable, Optional

import numpy as np

__all__ = ["DevicePrefetcher", "prefetch_to_device"]


class _End:
    """Exhaustion sentinel — distinct from any source item, so a source
    legitimately yielding ``None`` is delivered, not dropped."""


class _Error:
    """Exception relay from the transfer thread to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class _Placed:
    """A batch placed on the card: its device tree and the event its
    copies' side stream recorded after them."""

    def __init__(self, tree, event, device):
        self.tree = tree
        self.event = event
        self.device = device


def _map(tree, fn):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(v, fn) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _is_array(x) -> bool:
    import torch

    return isinstance(x, (np.ndarray, torch.Tensor))


class _CudaPlacer:
    """Places host batches on one CUDA device through pinned buffers and a
    side stream (module docstring); called on the transfer thread."""

    def __init__(self, device):
        self.device = device
        self._stream = None
        # (event, pinned buffers) whose copies may still be in flight
        self._held: collections.deque = collections.deque()

    def _release_passed(self) -> None:
        while self._held and self._held[0][0].query():
            self._held.popleft()

    def __call__(self, batch):
        import torch

        if self._stream is None:
            torch.cuda.set_device(self.device)
            self._stream = torch.cuda.Stream(self.device)
        self._release_passed()
        pinned = []

        def pin(x):
            if not _is_array(x):
                return x
            t = torch.as_tensor(x)
            if t.device.type != "cpu":
                return t
            t = t.contiguous().pin_memory()
            pinned.append(t)
            return t

        host = _map(batch, pin)
        event = torch.cuda.Event()
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            tree = _map(host, lambda t: t.to(self.device, non_blocking=True)
                        if isinstance(t, torch.Tensor) else t)
            event.record(self._stream)
        self._held.append((event, pinned))
        return _Placed(tree, event, self.device)

    def drain(self) -> None:
        """Wait for every copy still holding a pinned buffer (``close``:
        the buffers may then go)."""
        for event, _ in self._held:
            event.synchronize()
        self._held.clear()


def _deliver(placed):
    """The consumer's side of a placed batch: its current stream waits on
    the copies' event, and every tensor is marked in use by that stream
    (``record_stream``); no host sync."""
    if not isinstance(placed, _Placed):
        return placed
    import torch

    stream = torch.cuda.current_stream(placed.device)
    stream.wait_event(placed.event)

    def mark(t):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            t.record_stream(stream)
        return t

    return _map(placed.tree, mark)


class DevicePrefetcher:
    """Iterator over device-placed batches; see :func:`prefetch_to_device`.

    ``consumed_samples`` is the checkpoint-correct resume point: samples
    in batches already **delivered to the caller** — tracked directly as
    ``consumed_at_construction + delivered_batches * (local_batch * dp)``
    so a concurrent transfer thread can never skew it (the source's own
    count runs ahead by the in-flight window).  Checkpoint this wrapper's
    value, not the loader's, and re-wrap a fresh loader from it after
    restore.

    Resource contract: ``close()`` (or the context manager) stops the
    transfer thread, closes the source iterator, **closes the source
    loader** (pass-through — the decode pool does not live until
    ``__del__``), and rewinds the source's samplers past any batches
    pulled but never delivered (``rewind_batches``), so after ``close()``
    the source's ``consumed_samples`` agrees with the wrapper's.
    """

    def __init__(self, source, place: Optional[Callable], depth: int,
                 mesh=None, registry=None, device=None):
        if isinstance(source, DevicePrefetcher):
            raise TypeError(
                "prefetch_to_device(prefetch_to_device(...)): nested "
                "device prefetchers are unsupported — the wrapper reads "
                "local_batch/dp from its source for resume bookkeeping, "
                "which a second wrapper layer would mis-count.  Compose "
                "as loader -> prefetch_to_device, nothing in between.")
        self._source = source
        self._it = iter(source)
        self._place = place  # None: resolved lazily at first batch
        self._placer: Optional[_CudaPlacer] = None
        self._mesh = mesh
        self._device = device  # resolved with the default placement
        self._depth = max(0, depth)
        self._registry = registry
        self._lock = threading.Lock()
        self._delivered = 0   # batches handed to the caller
        self._pulled = 0      # batches taken from the source iterator
        self._consumed0 = getattr(source, "consumed_samples", None)
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._exhausted = False
        self._closed = False

    # -- resume bookkeeping -------------------------------------------

    def _per_batch(self) -> int:
        try:
            return self._source.local_batch * self._source.dp
        except AttributeError:
            raise AttributeError(
                "the wrapped source has no local_batch/dp; wrap a loader "
                "(ImageFolderLoader/PackedLoader/PackedSequenceLoader/"
                "DataService) directly — composition order is "
                "loader -> prefetch_to_device, nothing in between") \
                from None

    @property
    def in_flight(self) -> int:
        """Batches pulled from the source but not yet delivered (queued
        on the device or mid-placement).  When the source exposes
        ``consumed_samples``, derived as ``(source.consumed -
        wrapper.consumed) / per_batch``, so ``source == wrapper +
        in_flight`` holds at any instant and survives a close() whose
        thread join timed out."""
        src = getattr(self._source, "consumed_samples", None)
        if src is not None:
            try:
                per = self._per_batch()
            except AttributeError:
                per = None
            if per:
                with self._lock:
                    mine = self._consumed0 + self._delivered * per
                return max(0, (src - mine) // per)
        with self._lock:
            return self._pulled - self._delivered

    @property
    def consumed_samples(self) -> int:
        if self._consumed0 is None:
            raise AttributeError(
                "the wrapped source has no consumed_samples; wrap a "
                "loader (not a plain iterator) for resume bookkeeping — "
                "composition order is loader -> prefetch_to_device, "
                "nothing in between")
        with self._lock:
            return self._consumed0 + self._delivered * self._per_batch()

    # -- placement -----------------------------------------------------

    def _resolve_place(self) -> Callable:
        # Deferred to first use so a wrapper constructed *before*
        # initialize_model_parallel() still takes this rank's dp slice
        # once iteration starts.
        import torch

        from apex_tpu_torch._device import resolve_device
        from apex_tpu_torch.parallel import distributed as dist
        from apex_tpu_torch.parallel import mesh as mesh_lib

        self._device = resolve_device(self._device)
        if self._device.type == "cuda":
            if self._device.index is None:
                # the consumer's current device, named for the thread
                self._device = torch.device("cuda",
                                            torch.cuda.current_device())
            self._placer = _CudaPlacer(self._device)
            to_device = self._placer
        else:
            dev = self._device
            to_device = lambda b: _map(  # noqa: E731
                b, lambda x: torch.as_tensor(x).to(dev)
                if _is_array(x) else x)
        if (self._mesh is not None
                or mesh_lib.model_parallel_is_initialized()):
            mesh = self._mesh
            return lambda b: to_device(dist.dp_shard_batch(b, mesh))
        return to_device

    # -- transfer thread ----------------------------------------------

    def _pull_and_place(self):
        """One source pull + device placement; returns the queue item."""
        try:
            item = next(self._it)
        except StopIteration:
            return _End()
        except BaseException as e:  # noqa: BLE001 — relayed, not eaten
            return _Error(e)
        with self._lock:
            self._pulled += 1
        try:
            return self._place(item)
        except BaseException as e:  # noqa: BLE001
            return _Error(e)

    def _run(self) -> None:
        while not self._stop.is_set():
            out = self._pull_and_place()
            final = isinstance(out, (_End, _Error))
            while not self._stop.is_set():
                try:
                    self._queue.put(out, timeout=0.2)
                    break
                except queue.Full:
                    continue
            if final:
                return

    # -- iterator ------------------------------------------------------

    def __iter__(self) -> "DevicePrefetcher":
        return self

    def __next__(self):
        if self._exhausted or self._closed:
            raise StopIteration
        if self._place is None:
            self._place = self._resolve_place()
        if self._depth == 0:
            # degenerate synchronous mode: map(place, source)
            out = self._pull_and_place()
        else:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="apex-device-prefetch",
                    daemon=True)
                self._thread.start()
            out = self._get_with_stall()
        if isinstance(out, _End):
            self._exhausted = True
            raise StopIteration
        if isinstance(out, _Error):
            self._exhausted = True
            raise out.exc
        with self._lock:
            self._delivered += 1
        return _deliver(out)

    def _get_with_stall(self):
        """Blocking queue pop, measured: the time the consumer waits here
        is the pipeline's *stall*.  Poll-with-timeout rather than a bare
        blocking get: a concurrent ``close()`` from a watchdog thread must
        wake a consumer already parked here."""
        from apex_tpu_torch.observability import timeline
        from apex_tpu_torch.observability.spans import named_span

        if self._registry is None:
            from apex_tpu_torch.observability.metrics import (
                default_registry,
            )

            self._registry = default_registry()
        t0 = time.perf_counter()
        with named_span("data/next_wait"):
            while True:
                try:
                    out = self._queue.get(timeout=0.5)
                    break
                except queue.Empty:
                    if self._stop.is_set():
                        out = _End()
                        break
        stall_ms = (time.perf_counter() - t0) * 1e3
        self._registry.gauge("data/stall_ms").set(stall_ms)
        self._registry.histogram("span_ms/data/next_wait").observe(stall_ms)
        # the flight recorder (no-op unless armed): the same wait as a
        # timeline interval feeding the goodput ``data_stall`` bucket
        timeline.emit("data_stall", dur_s=stall_ms / 1e3)
        return out

    # -- shutdown ------------------------------------------------------

    def close(self, *, close_source: bool = True) -> None:
        """Stop the transfer thread, close the source iterator, rewind
        the source's samplers past undelivered in-flight batches (so its
        ``consumed_samples`` matches the wrapper's), wait for the copies
        still reading pinned buffers, and — the resource pass-through —
        close the source loader itself, releasing its decode pool.
        Idempotent.

        ``close_source=False`` leaves the loader open (the multi-epoch
        loop shape: re-wrap the same loader for the next epoch)."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        if self._thread is not None:
            # unblock a producer waiting on a full queue
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._placer is not None:
            self._placer.drain()
        # generator sources (the loaders' __iter__) rewind their OWN
        # prefetch window in their finally block when closed.  Guard:
        # for self-iterating sources (DataService, plain iterators with
        # close()), iter(source) IS the source — closing "the iterator"
        # there would close the source even under close_source=False.
        if self._it is not self._source:
            it_close = getattr(self._it, "close", None)
            if callable(it_close):
                try:
                    it_close()
                except Exception:
                    pass  # a producer stuck past the join timeout
        undelivered = self.in_flight
        rewind = getattr(self._source, "rewind_batches", None)
        if undelivered and callable(rewind):
            rewind(undelivered)
            with self._lock:
                self._pulled -= undelivered
        if close_source:
            src_close = getattr(self._source, "close", None)
            if callable(src_close):
                src_close()

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # best-effort backstop
        # does NOT close the source: a dropped (e.g. exhausted) wrapper
        # must not yank the decode pool out from under a loader the
        # caller re-wrapped for the next epoch — only an explicit
        # close() passes through
        try:
            self.close(close_source=False)
        except Exception:
            pass


def prefetch_to_device(iterator: Iterable, mesh=None, depth: int = 2,
                       place: Optional[Callable] = None,
                       registry=None, device=None) -> DevicePrefetcher:
    """Yield batches from ``iterator`` already placed on ``device``
    (default: the CUDA device; ``device="cpu"`` for the CPU), with a
    dedicated transfer thread keeping up to ``depth`` placed batches
    queued ahead of the consumer.

    ``place`` maps a host batch to device tensors; the default copies
    through pinned memory on a side CUDA stream (module docstring), after
    cutting this rank's data-parallel slice with
    :func:`apex_tpu_torch.parallel.dp_shard_batch` when a ``mesh`` is
    given (or one is initialized).  The default placement is resolved at
    *first iteration*, not at construction.

    ``depth=0`` degenerates to ``map(place, iterator)`` (no thread).
    For exact mid-epoch resume, checkpoint the returned wrapper's
    ``consumed_samples`` (NOT the loader's own, which runs ahead by the
    in-flight window) and rebuild loader + wrapper from it after
    restore.  Composition order is enforced: wrap a loader directly —
    nesting two device prefetchers raises ``TypeError``.

    Observability: each ``__next__`` records its blocking wait into the
    ``data/stall_ms`` gauge and the ``span_ms/data/next_wait`` histogram
    of ``registry`` (default: the process registry).
    """
    return DevicePrefetcher(iterator, place, depth, mesh=mesh,
                            registry=registry, device=device)
