"""Host-side metrics: registry, MFU, heartbeat (port of
:mod:`apex_tpu.observability.metrics`).

- :class:`MetricRegistry`: rank-aware counters, gauges and histograms.
  Every process may record; ``flush`` writes only on the writer rank
  (rank 0 of ``torch.distributed``, or the one process without it).
- :func:`mfu` / :func:`mfu_or_reason`: model FLOPs utilization, a FLOP
  count over a measured time over the card's peak (:func:`peak_flops_for`).
  The reference reads its FLOP count from XLA's cost analysis of the
  compiled program (``compiled_flops``); eager PyTorch compiles no
  program, so that function has no counterpart here and a caller counts
  its own FLOPs (the serving engine counts its decode call's from the
  shapes, see :class:`~apex_tpu_torch.serving.engine.ServingEngine`).
- :class:`HeartbeatMonitor`: records the last completed step and, when
  no beat arrives within ``timeout_s``, flags the hang to a
  :class:`~apex_tpu_torch.resilience.PreemptionGuard` (anything with
  ``.trigger()``, or a plain callable), so the loop drains instead of
  wedging on a dead collective.
"""

from __future__ import annotations

import collections
import logging
import math
import threading
import time
from typing import Any, Callable, Dict, Optional

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "default_registry",
    "is_host_local",
    "HOST_LOCAL_PREFIXES",
    "PEAK_FLOPS",
    "peak_flops_for",
    "peak_flops_reason",
    "mfu",
    "mfu_or_reason",
    "HeartbeatMonitor",
]

logger = logging.getLogger(__name__)


def _safe_rank_world():
    """(rank, world size) of ``torch.distributed`` when a process group
    is up, else (0, 1); never starts one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Counter:
    """Monotonic counter (``inc``-only)."""

    def __init__(self, lock: Optional[threading.Lock] = None):
        self._lock = lock if lock is not None else threading.Lock()
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-write-wins scalar."""

    def __init__(self, lock: Optional[threading.Lock] = None):
        self._lock = lock if lock is not None else threading.Lock()
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)


class Histogram:
    """Streaming summary (count/total/min/max/last) — enough for span
    timings and rates without holding samples.

    ``keep_samples > 0`` additionally retains the most recent N
    observations in a ring buffer so :meth:`percentile` works — the
    serving runtime's per-request latency percentiles (p50/p99
    time-per-output-token) need the distribution, not
    just the moments.  Bounded by construction: an unbounded sample
    list in a weeks-long serving process is a slow leak.
    """

    def __init__(self, lock: Optional[threading.Lock] = None,
                 keep_samples: int = 0):
        self._lock = lock if lock is not None else threading.Lock()
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.last: Optional[float] = None
        self._samples = (collections.deque(maxlen=keep_samples)
                         if keep_samples > 0 else None)

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            self.last = v
            if self._samples is not None:
                self._samples.append(v)

    @property
    def mean(self) -> Optional[float]:
        return self.total / self.count if self.count else None

    @staticmethod
    def _nearest_rank(ordered, q: float):
        rank = math.ceil(q / 100.0 * len(ordered))   # 1-indexed
        return ordered[max(0, min(len(ordered) - 1, rank - 1))]

    def percentile(self, q: float) -> Optional[float]:
        """q-th percentile (0..100, nearest-rank) over the retained
        window; ``None`` without samples (not constructed with
        ``keep_samples``, or nothing observed yet)."""
        with self._lock:
            if not self._samples:
                return None
            ordered = sorted(self._samples)
        return self._nearest_rank(ordered, q)

    def summary(self) -> dict:
        with self._lock:
            out = {"count": self.count, "total": self.total,
                   "mean": self.mean, "min": self.min, "max": self.max,
                   "last": self.last}
            # one copy+sort for all the percentile keys: the window can
            # be 64k samples and flush holds the lock observe() needs
            ordered = sorted(self._samples) if self._samples else None
        if self._samples is not None:
            out["p50"] = (self._nearest_rank(ordered, 50.0)
                          if ordered else None)
            out["p99"] = (self._nearest_rank(ordered, 99.0)
                          if ordered else None)
        return out


# Catalog prefixes whose values are HOST-LOCAL facts: every process
# measures its own (this host's input stall, this host's span timings,
# this host's serving slots), and rank 0's flush describes only rank 0.
# Everything else in the catalog (``train/*``) is a GLOBAL fact — the
# in-graph stats are reduced over the mesh before they reach any host,
# so rank 0's value IS the job's value and the default rank-0-only
# flush loses nothing.  For the host-local names, opt into
# ``flush(..., all_ranks=True)`` (rank-stamped records) when per-host
# visibility matters.
HOST_LOCAL_PREFIXES = (
    "data/", "span_ms/", "heartbeat/", "serving/", "ckpt/", "loader/",
    "fleet/",
)


def is_host_local(name: str) -> bool:
    """True when a catalog entry is a per-host fact (only the writer
    rank's value survives a default ``flush``) rather than a globally
    reduced one."""
    return name.startswith(HOST_LOCAL_PREFIXES)


class MetricRegistry:
    """Named metric store with rank-aware flushing.

    ``rank``/``world`` default to ``torch.distributed``'s rank and world
    size when a process group is up, else ``0``/``1``, so the registry
    works in host-only tests and before the group is up alike.
    Thread-safe (the heartbeat thread records too).
    """

    def __init__(self, *, rank: Optional[int] = None,
                 world: Optional[int] = None):
        auto_rank, auto_world = _safe_rank_world()
        self.rank = auto_rank if rank is None else rank
        self.world = auto_world if world is None else world
        # RLock, shared with every metric this registry creates: metric
        # mutation is atomic against snapshot(), and snapshot() can call
        # Histogram.summary() (which re-acquires) without deadlocking.
        self._lock = threading.RLock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    @property
    def is_writer(self) -> bool:
        """Exactly one process owns the durable metrics artifact."""
        return self.rank == 0

    def _get(self, store: dict, name: str, factory):
        with self._lock:
            if name not in store:
                store[name] = factory(self._lock)
            return store[name]

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, name, Gauge)

    def histogram(self, name: str, *, keep_samples: int = 0) -> Histogram:
        """``keep_samples`` applies only on first creation (an existing
        histogram keeps its window — last-write-wins reconfiguration
        would silently truncate someone else's percentiles)."""
        return self._get(self._histograms, name,
                         lambda lock: Histogram(lock, keep_samples))

    def snapshot(self) -> dict:
        """Flat ``{name: value}`` view (histograms as summary dicts)."""
        typed = self.snapshot_typed()
        out: Dict[str, Any] = dict(typed["counters"])
        out.update(typed["gauges"])
        out.update(typed["histograms"])
        return out

    def snapshot_typed(self) -> dict:
        """Per-kind snapshot ``{"counters": {name: value}, "gauges":
        {...}, "histograms": {name: summary}}`` — for consumers that
        must know a metric's kind (the Prometheus exposition needs
        ``# TYPE`` lines), taken under the registry lock so it is
        consistent against concurrent recording."""
        with self._lock:
            return {
                "counters": {n: c.value for n, c in self._counters.items()},
                "gauges": {n: g.value for n, g in self._gauges.items()},
                "histograms": {n: h.summary()
                               for n, h in self._histograms.items()},
            }

    def flush(self, writer, *, step: Optional[int] = None,
              extra: Optional[dict] = None,
              all_ranks: bool = False) -> Optional[dict]:
        """Write one record ``{ts, step, rank, metrics, **extra}`` via
        ``writer.write`` — **only on the writer rank** (other ranks
        return ``None`` without touching storage).  ``writer=None`` is a
        no-op, so callers thread an optional writer without branching.

        ``all_ranks=True`` opts into a per-rank flush: every process
        writes its (rank-stamped) record.  This exists because much of
        the catalog is **host-local** (:func:`is_host_local` —
        ``data/stall_ms``, loader throughput, span timings): under the
        default rank-0 gate, a rank-3 input stall is invisible in the
        durable record.  Point each rank's writer at a rank-qualified
        path (``metrics.rank{k}.jsonl``) — the JSONL append protocol is
        line-atomic but interleaving ranks in one file makes per-rank
        series needlessly order-dependent."""
        if writer is None or not (self.is_writer or all_ranks):
            return None
        record: Dict[str, Any] = {"ts": time.time(), "rank": self.rank}
        if step is not None:
            record["step"] = step
        record["metrics"] = self.snapshot()
        if extra:
            record.update(extra)
        writer.write(record)
        return record


_DEFAULT: Optional[MetricRegistry] = None
_DEFAULT_LOCK = threading.Lock()


def default_registry() -> MetricRegistry:
    """The process-wide registry (what the serving engine records into
    unless it is given one)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = MetricRegistry()
        return _DEFAULT


# --- MFU -----------------------------------------------------------------

# Dense bf16 tensor-core peak FLOP/s by device name: NVIDIA's data sheet
# for the H100 SXM part at its full 700 W power limit (a card set lower
# runs slower under load; its MFU is still stated against this peak).
PEAK_FLOPS = (
    ("h100", 989e12),
)


def peak_flops_reason(device):
    """``(peak_bf16_flops, reason)`` for a torch device (or a device
    string) - exactly one of the pair is ``None``.  The reason names why
    MFU is undefined (no device, a platform or card without a table
    entry), so a report can print "MFU: n/a (<reason>)"."""
    import torch

    if device is None:
        return None, "no device given (peak FLOP/s unknown)"
    device = torch.device(device)
    if device.type != "cuda":
        return None, (f"no peak-FLOPs table entry for platform "
                      f"{device.type!r} (MFU is defined against a card's "
                      f"peak)")
    kind = torch.cuda.get_device_name(device).lower()
    for tag, peak in PEAK_FLOPS:
        if tag in kind:
            return peak, None
    return None, f"no peak-FLOPs table entry for device kind {kind!r}"


def peak_flops_for(device) -> Optional[float]:
    """Peak bf16 FLOP/s of a torch device, ``None`` when unknown (the
    CPU, a card without an entry).  :func:`peak_flops_reason` says
    why."""
    return peak_flops_reason(device)[0]


def mfu_or_reason(flops_per_step: Optional[float], step_time_s: float, *,
                  peak_flops: Optional[float] = None,
                  device=None, n_devices: int = 1):
    """``(mfu, reason)`` - exactly one of the pair is ``None``.

    The reason tells a missing FLOP count from an unknown device peak;
    callers with a text channel (the serving engine's ``introspect``)
    surface it."""
    if step_time_s <= 0:
        return None, f"non-positive step time ({step_time_s})"
    if flops_per_step is None:
        return None, "no FLOP count for the step"
    if peak_flops is None:
        peak_flops, reason = peak_flops_reason(device)
        if peak_flops is None:
            return None, reason
    value = flops_per_step / step_time_s / (peak_flops * max(n_devices, 1))
    return value, None


def mfu(flops_per_step: Optional[float], step_time_s: float, *,
        peak_flops: Optional[float] = None,
        device=None, n_devices: int = 1) -> Optional[float]:
    """Model FLOPs utilization: ``flops / time / (peak * n_devices)``.

    ``flops_per_step`` is the FLOP count of the whole step over all its
    ranks, hence ``n_devices`` in the denominator.  ``None`` when the
    count or the peak is unknown; :func:`mfu_or_reason` says which."""
    return mfu_or_reason(flops_per_step, step_time_s,
                         peak_flops=peak_flops, device=device,
                         n_devices=n_devices)[0]


# --- heartbeat -----------------------------------------------------------


class HeartbeatMonitor:
    """Hung-step detector: ``beat(step)`` after every completed step; a
    background thread flags ``hung`` (and fires ``on_hang``) when no
    beat lands within ``timeout_s``.

    ``on_hang`` duck-types :class:`apex_tpu_torch.resilience.PreemptionGuard`
    (``.trigger()`` preferred, else called directly): a hang is handled
    exactly like a preemption notice — the loop's next alive moment
    drains async saves and checkpoints, instead of the job dying wedged
    with hours of unsaved progress.  The flag fires once per hang
    episode (re-armed by the next beat) so a slow-but-alive step cannot
    machine-gun the guard.

    ``check_now()`` runs one poll synchronously; deterministic tests use
    it instead of racing the thread.
    """

    def __init__(self, *, timeout_s: float, on_hang: Optional[Any] = None,
                 registry: Optional[MetricRegistry] = None,
                 poll_s: Optional[float] = None):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.timeout_s = timeout_s
        self.on_hang = on_hang
        self.registry = registry if registry is not None else \
            default_registry()
        self.poll_s = poll_s if poll_s is not None else \
            max(timeout_s / 4.0, 0.01)
        self.last_step: Optional[int] = None
        self.last_beat_time: Optional[float] = None
        self.hung = False
        self.hang_count = 0
        self._armed = False  # a beat arrived since the last hang flag
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def beat(self, step: int) -> None:
        """Record step completion (call from the training loop, after
        the step's results are materialized)."""
        with self._lock:
            self.last_step = step
            self.last_beat_time = time.monotonic()
            self.hung = False
            self._armed = True
        self.registry.gauge("heartbeat/last_step").set(step)
        self.registry.gauge("heartbeat/last_beat_ts").set(time.time())

    def check_now(self) -> bool:
        """One poll: returns (and latches) the hung verdict."""
        fire: Optional[Callable] = None
        with self._lock:
            if not self._armed or self.last_beat_time is None:
                return self.hung
            if time.monotonic() - self.last_beat_time > self.timeout_s:
                self.hung = True
                self.hang_count += 1
                self._armed = False  # once per episode
                on_hang = self.on_hang
                if on_hang is not None:
                    fire = getattr(on_hang, "trigger", on_hang)
        if fire is not None:
            logger.warning(
                "heartbeat: no step completed in %.1fs (last step %s) — "
                "flagging hang", self.timeout_s, self.last_step)
            self.registry.counter("heartbeat/hangs").inc()
            try:
                fire()
            except Exception as e:  # telemetry never kills training
                logger.warning("heartbeat on_hang raised: %r", e)
        elif self.hung:
            self.registry.counter("heartbeat/hangs").inc()
        return self.hung

    def start(self) -> "HeartbeatMonitor":
        if self._thread is not None:
            return self
        # Arm from "now" so a wedge BEFORE the first completed step —
        # the most common wedge shape (dead collective / compile hang on
        # step 0) — is detected too, not only gaps between beats.
        with self._lock:
            if self.last_beat_time is None:
                self.last_beat_time = time.monotonic()
                self._armed = True
        self._stop.clear()

        def run():
            while not self._stop.wait(self.poll_s):
                self.check_now()

        self._thread = threading.Thread(
            target=run, name="apex-heartbeat", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "HeartbeatMonitor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
