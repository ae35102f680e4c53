"""Shared producer-thread loader machinery (port of
:mod:`apex_tpu.data._producer`).

One implementation of the bounded-queue background-producer pattern the
decode-free loaders share (:class:`~apex_tpu_torch.data.packed.PackedLoader`
over image shards, :class:`~apex_tpu_torch.data.sequence.PackedSequenceLoader`
over token shards): Megatron-sampler DP sharding, per-``__iter__``
iteration state (own stop flag, bounded queue, producer thread),
``consumed_samples`` mid-epoch resume with undelivered-batch rewind, the
single-live-iteration preemption contract, and producer-error relay into
the consuming train loop.  Subclasses provide only :meth:`_gather` (index
lists -> host batch) and the dataset length, so the contracts hold for
every subclass by construction.

Per-host input sharding: like ``ImageFolderLoader``, ``dp_ranks``
restricts a loader to the dp shards this host's devices own
(``parallel.host_dp_ranks``: one rank a process in the port); ``consumed_samples`` stays in GLOBAL
samples so one checkpointed integer resumes every host coherently.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Iterator, Optional, Sequence

__all__ = ["ProducerLoader", "make_dp_samplers", "reap_process"]


def reap_process(proc, timeout: float, what: str = "worker") -> None:
    """Bounded process teardown — join, then escalate terminate -> kill.
    The ONE reaping ladder shared by the process-pool decode backend,
    ``DataService.close``, and the service's GC/exit finalizer, so a
    wedged child (uninterruptible NFS/FUSE read) can never hang trainer
    shutdown, and the escalation policy cannot drift between sites."""
    proc.join(timeout=max(0.0, timeout))
    if not proc.is_alive():
        return
    logging.getLogger(__name__).warning(
        "%s %s did not exit in %.1fs; terminating",
        what, getattr(proc, "pid", "?"), timeout)
    proc.terminate()
    proc.join(timeout=2.0)
    if proc.is_alive():
        proc.kill()
        proc.join(timeout=2.0)


def make_dp_samplers(total_samples: int, local_batch: int,
                     data_parallel_size: int, consumed_samples: int,
                     dp_ranks: Optional[Sequence[int]]):
    """Validate ``dp_ranks`` and build one Megatron sampler per rank —
    the ONE definition of the per-host sharding surface, shared by
    :class:`ProducerLoader` and ``ImageFolderLoader`` so their
    validation (range, non-empty, no duplicates) cannot diverge.
    Returns ``(dp_ranks tuple, samplers list)``."""
    from apex_tpu_torch.transformer._data import (
        MegatronPretrainingRandomSampler,
    )

    if dp_ranks is None:
        dp_ranks = range(data_parallel_size)
    dp_ranks = tuple(dp_ranks)
    if not dp_ranks:
        raise ValueError("dp_ranks must name at least one dp rank")
    if len(set(dp_ranks)) != len(dp_ranks):
        raise ValueError(f"dp_ranks has duplicates: {dp_ranks} — a rank "
                         "decoded twice silently trains duplicated data")
    for r in dp_ranks:
        if not 0 <= r < data_parallel_size:
            raise ValueError(
                f"dp_ranks entry {r} outside [0, {data_parallel_size})")
    samplers = [
        MegatronPretrainingRandomSampler(
            total_samples=total_samples,
            consumed_samples=consumed_samples,
            local_minibatch_size=local_batch,
            data_parallel_rank=r,
            data_parallel_size=data_parallel_size,
        )
        for r in dp_ranks
    ]
    return dp_ranks, samplers


class _ProducerError:
    """Exception relay from the producer thread to the consuming iterator."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class _Iteration:
    """Per-``__iter__`` state: its own stop flag, bounded queue, producer
    thread, and count of sampler-advanced-but-undelivered batches."""

    def __init__(self, prefetch: int):
        self.stop = threading.Event()
        self.queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self.thread: Optional[threading.Thread] = None
        self.mine = 0


class ProducerLoader:
    """Base DP-sharded producer-thread iterator (see module docstring).

    Subclass contract::

        class MyLoader(ProducerLoader):
            def _gather(self, idx_per_rank):  # index lists -> host batch
                ...

    The producer is a single background thread: per batch it draws one
    index list per dp rank from the shared samplers (under the lock) and
    gathers the batch; ``prefetch`` bounds the queue.  One live iteration
    per loader: starting a second tears down (and rewinds) the first.
    """

    def __init__(self, total_samples: int, local_batch: int,
                 data_parallel_size: int = 1, consumed_samples: int = 0,
                 seed: int = 0, prefetch: int = 2,
                 dp_ranks: Optional[Sequence[int]] = None):
        self.local_batch = local_batch
        self.dp = data_parallel_size
        self.seed = seed
        self.prefetch = max(1, prefetch)
        self.dp_ranks, self.samplers = make_dp_samplers(
            total_samples, local_batch, data_parallel_size,
            consumed_samples, dp_ranks)
        self._lock = threading.Lock()
        self._active: list = []  # live _Iteration states (usually 0 or 1)

    # -- subclass surface ----------------------------------------------

    def _gather(self, idx_per_rank):
        """Per-rank index lists -> one host batch (numpy arrays)."""
        raise NotImplementedError

    # -- resume bookkeeping --------------------------------------------

    @property
    def consumed_samples(self) -> int:
        """GLOBAL samples in batches already yielded.  Producer threads
        run the samplers ``prefetch`` batches ahead; batches pulled but
        not delivered (queued, mid-gather, or discarded by an early
        ``close()``) are subtracted under the same lock the producers
        advance under, so a checkpoint taken between steps resumes at the
        first undelivered batch — exactly ImageFolderLoader's contract."""
        with self._lock:
            return (self.samplers[0].consumed_samples
                    - sum(st.mine for st in self._active)
                    * self.local_batch * self.dp)

    def rewind_batches(self, n: int) -> None:
        """Roll the samplers back ``n`` yielded batches (the
        ``DevicePrefetcher.close()`` resume surface)."""
        with self._lock:
            for s in self.samplers:
                s.consumed_samples -= n * self.local_batch * self.dp

    # -- lifecycle ------------------------------------------------------

    def close(self) -> None:
        """Stop every live iteration and rewind the samplers past any
        batches gathered but never delivered, so re-iterating (or
        resuming from ``consumed_samples``) replays exactly the
        undelivered data — ImageFolderLoader's abandoned-iteration
        contract."""
        with self._lock:
            states = list(self._active)
        for st in states:
            self._finish(st)

    def __enter__(self) -> "ProducerLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- producer -------------------------------------------------------

    def _produce(self, st: "_Iteration") -> None:
        its = [iter(s) for s in self.samplers]
        while not st.stop.is_set():
            try:
                with self._lock:
                    idx_per_rank = [next(it) for it in its]
                    st.mine += 1
                batch = self._gather(idx_per_rank)
            except StopIteration:
                # epoch end: sentinel wakes the consumer, which returns
                st.queue.put(None)
                return
            except BaseException as e:  # noqa: BLE001 — relayed, not eaten
                # a dead producer must fail the training loop, not wedge
                # it in queue.get() (ImageFolderLoader propagates decode
                # errors through future.result() the same way)
                st.queue.put(_ProducerError(e))
                return
            while not st.stop.is_set():
                try:
                    st.queue.put(batch, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def _finish(self, st: "_Iteration") -> None:
        """Tear down one iteration: stop+join its producer, then rewind
        the samplers by its undelivered batches (``st.mine``)."""
        st.stop.set()
        # claim the thread under the lock: _finish can race itself (an
        # iterator finalizer vs an explicit stop) and only one caller
        # may join/drain — the loser must see None, not a torn teardown
        with self._lock:
            thread, st.thread = st.thread, None
        if thread is not None:
            # unblock a producer waiting on a full queue; drained batches
            # stay counted in st.mine (they were never delivered)
            try:
                while True:
                    st.queue.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=5.0)
            # wake a consumer still blocked in queue.get() (a preempted
            # iterator whose producer exited without a sentinel): drain
            # anything the producer managed to enqueue before stopping,
            # then leave one end-of-epoch sentinel
            try:
                while True:
                    st.queue.get_nowait()
            except queue.Empty:
                pass
            try:
                st.queue.put_nowait(None)
            except queue.Full:
                pass
            if thread.is_alive():
                # a producer stuck >5 s (cold memmap page-in on a slow
                # disk) is left daemonized but must be visible, not a
                # silently leaked thread holding the drained queue
                logging.getLogger(__name__).warning(
                    "%s: producer thread did not exit within 5 s of stop; "
                    "leaking it as a daemon (likely blocked in a gather)",
                    type(self).__name__)
        with self._lock:
            if st in self._active:
                self._active.remove(st)
            undelivered, st.mine = st.mine, 0
            if undelivered:
                for s in self.samplers:
                    s.consumed_samples -= (
                        undelivered * self.local_batch * self.dp)

    # -- consumer -------------------------------------------------------

    def __iter__(self) -> Iterator:
        # one epoch per __iter__ call, mirroring ImageFolderLoader: the
        # samplers hold position, so re-iterating starts the next epoch.
        # All iteration state is per-call so overlapping/abandoned
        # iterators never share a stop flag or queue — but the SAMPLERS
        # are shared, so two *live* producers would interleave duplicate
        # index streams while double-advancing consumed_samples.  Only
        # one live iteration is supported (as with ImageFolderLoader):
        # starting a new one first tears down any still-active prior
        # iteration (covers abandoned, un-GC'd generators) and rewinds
        # its undelivered batches.
        with self._lock:
            stale = list(self._active)
        for old in stale:
            self._finish(old)
        st = _Iteration(self.prefetch)
        with self._lock:
            self._active.append(st)
        st.thread = threading.Thread(
            target=self._produce, args=(st,), daemon=True)
        st.thread.start()
        try:
            while True:
                # poll-with-timeout rather than a bare blocking get: a
                # preempted iteration (stop set by a newer __iter__) must
                # terminate even if its wake-up sentinel was lost to a
                # racing put from a slow-to-exit producer
                try:
                    batch = st.queue.get(timeout=0.5)
                except queue.Empty:
                    if st.stop.is_set():
                        return
                    continue
                if batch is None:
                    return
                if isinstance(batch, _ProducerError):
                    raise batch.exc
                with self._lock:
                    # check-and-decrement must be one atomic section:
                    # _finish (a competing __iter__ or close()) sets stop,
                    # rewinds the samplers and zeroes st.mine under this
                    # same lock — a stop check outside it could pass just
                    # before the teardown, and the decrement after it
                    # would both deliver an already-rewound batch twice
                    # and drive st.mine to -1
                    if st.stop.is_set():
                        return
                    st.mine -= 1
                yield batch
        finally:
            self._finish(st)
