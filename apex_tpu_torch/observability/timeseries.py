"""Longitudinal metrics history — fixed-memory ring-buffer time series
(port of :mod:`apex_tpu.observability.timeseries`).

Every number the fleet exposes today is a *snapshot*: ``/fleet/statusz``
answers "what is the p99 right now", the autopilot's trend deque holds
whatever samples happened to land in its window, and nothing can answer
"what was the queue depth ninety seconds before the burst".
:class:`MetricHistory` is the memory: it snapshots a
:class:`~apex_tpu_torch.observability.metrics.MetricRegistry` on an
injectable-clock cadence and folds every reading into multi-resolution
ring buffers — by default 1 s × 512, 10 s × 512, 60 s × 512 buckets, so
RAM is bounded regardless of uptime (the coarse rings ARE the
downsample: one bucket aggregates count/sum/min/max/last of every raw
sample that landed in its window, so the 10 s ring's mean/max equals
the mean/max of the 1 s ring over the same span — pinned by
``tests/test_slo.py``).

Reading rules, per registry type:

- **counters** become *rates* (delta / sample interval).  A monotonic
  drop — a replica restart resetting its counters — is treated as a
  reset: the post-reset value is the delta (never a negative rate).
- **gauges** record their value (``None`` gauges are skipped).
- **sampled histograms** record their windowed ``p50``/``p99`` under
  ``<name>:p50`` / ``<name>:p99``, plus a ``<name>:rate`` series from
  the observation-count delta (same reset handling as counters).

Cardinality is bounded twice: the registry's own key caps upstream, and
``max_series`` here — a novel series name past the cap lands in the
explicit ``(other)`` overflow series and fires ``on_overflow`` (the
fleet router wires that to the ``fleet/series_overflow`` counter), so
an adversarial tenant-id stream cannot grow the store.

Replica → router shipping rides the existing state-heartbeat path as
*compacted deltas*: :meth:`MetricHistory.export_delta` returns only the
fine-ring buckets completed since the last export, and the router's
:meth:`MetricHistory.ingest_delta` merges them under a
``replica/<name>/`` prefix, rebasing the replica's monotonic bucket
stamps onto the local clock by the export-time offset (error bounded by
heartbeat cadence + link delay: cross-host clocks are never compared
raw).

Torch-free, stdlib-only, single-threaded by design: the router samples
from its own pump loop, a replica from its heartbeat closure.
"""

from __future__ import annotations

import math
import time
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["MetricHistory", "match_series"]

# Bucket layout (a plain list, mutated in place on merge):
# [t_bucket_start, count, sum, min, max, last]
_T, _COUNT, _SUM, _MIN, _MAX, _LAST = range(6)

DEFAULT_RESOLUTIONS: Tuple[Tuple[float, int], ...] = (
    (1.0, 512), (10.0, 512), (60.0, 512))

OVERFLOW_SERIES = "(other)"


def match_series(pattern: str, name: str) -> bool:
    """Segment-wise series-name match: ``*`` matches exactly one
    ``/``-separated segment (``fleet/tenant/*/ttft_ms:p99`` matches
    every tenant's TTFT tail and nothing else)."""
    pseg = pattern.split("/")
    nseg = name.split("/")
    if len(pseg) != len(nseg):
        return False
    return all(p == "*" or p == n for p, n in zip(pseg, nseg))


class MetricHistory:
    """Fixed-memory multi-resolution history over one metric registry."""

    def __init__(self, registry=None, *,
                 resolutions: Sequence[Tuple[float, int]] = DEFAULT_RESOLUTIONS,
                 max_series: int = 512,
                 clock: Callable[[], float] = time.monotonic,
                 on_overflow: Optional[Callable[[], None]] = None):
        if not resolutions:
            raise ValueError("resolutions must be non-empty")
        res = [(float(r), int(n)) for r, n in resolutions]
        for (r, n) in res:
            if r <= 0 or n <= 0:
                raise ValueError(f"bad resolution {(r, n)!r}")
        if any(res[i][0] >= res[i + 1][0] for i in range(len(res) - 1)):
            raise ValueError("resolutions must be strictly ascending")
        if max_series < 1:
            raise ValueError("max_series must be >= 1")
        self.resolutions: Tuple[Tuple[float, int], ...] = tuple(res)
        self.max_series = int(max_series)
        self._registry = registry
        self._clock = clock
        self._on_overflow = on_overflow
        self._series: Dict[str, List[deque]] = {}
        self._prev: Dict[Tuple[str, str], float] = {}   # counter/count memory
        self._cursor: Dict[str, float] = {}             # export watermark
        self._last_t: Optional[float] = None
        self._samples = 0

    # ------------------------------------------------------------ write

    def _rings_for(self, name: str) -> Tuple[str, List[deque]]:
        rings = self._series.get(name)
        if rings is None:
            if len(self._series) >= self.max_series \
                    and name != OVERFLOW_SERIES:
                if self._on_overflow is not None:
                    self._on_overflow()
                name = OVERFLOW_SERIES
                rings = self._series.get(name)
            if rings is None:
                rings = [deque(maxlen=n) for _r, n in self.resolutions]
                self._series[name] = rings
        return name, rings

    def _merge(self, name: str, t: float, count: float, total: float,
               vmin: float, vmax: float, last: float) -> None:
        _name, rings = self._rings_for(name)
        for (res, _n), ring in zip(self.resolutions, rings):
            tb = math.floor(t / res) * res
            if ring and ring[-1][_T] >= tb:
                b = ring[-1]          # in-order or late: fold into newest
                b[_COUNT] += count
                b[_SUM] += total
                if vmin < b[_MIN]:
                    b[_MIN] = vmin
                if vmax > b[_MAX]:
                    b[_MAX] = vmax
                b[_LAST] = last
            else:
                ring.append([tb, count, total, vmin, vmax, last])

    def record(self, name: str, value: float,
               now: Optional[float] = None) -> None:
        """Fold one raw reading into every resolution ring."""
        t = self._clock() if now is None else float(now)
        v = float(value)
        self._merge(name, t, 1.0, v, v, v, v)

    def _rated(self, kind: str, name: str, cur: float,
               dt: Optional[float]) -> Optional[float]:
        """Counter→rate with monotonic-reset handling: a drop means the
        source restarted, so the post-reset value IS the delta."""
        prev = self._prev.get((kind, name))
        self._prev[(kind, name)] = cur
        if prev is None or dt is None or dt <= 0:
            return None
        delta = cur - prev if cur >= prev else cur
        return delta / dt

    def sample(self, now: Optional[float] = None) -> None:
        """Snapshot the registry once: counters as rates, gauges as
        values, sampled histograms as ``:p50``/``:p99``/``:rate``."""
        if self._registry is None:
            raise ValueError("MetricHistory built without a registry")
        t = self._clock() if now is None else float(now)
        dt = None if self._last_t is None else t - self._last_t
        snap = self._registry.snapshot_typed()
        for name in sorted(snap["counters"]):
            rate = self._rated("c", name, float(snap["counters"][name]), dt)
            if rate is not None:
                self.record(name, rate, now=t)
        for name in sorted(snap["gauges"]):
            val = snap["gauges"][name]
            if val is not None:
                self.record(name, float(val), now=t)
        for name in sorted(snap["histograms"]):
            summ = snap["histograms"][name]
            for field in ("p50", "p99"):
                val = summ.get(field)
                if val is not None:
                    self.record(f"{name}:{field}", float(val), now=t)
            rate = self._rated("h", name, float(summ.get("count", 0)), dt)
            if rate is not None:
                self.record(f"{name}:rate", rate, now=t)
        self._last_t = t
        self._samples += 1

    # ------------------------------------------------------- delta wire

    def export_delta(self, now: Optional[float] = None) -> Optional[dict]:
        """Fine-ring buckets completed since the last export (a bucket
        is complete once its window closed), or ``None`` when nothing
        new finished — the compacted payload the replica heartbeat
        attaches to its ``("state", snap)`` event."""
        t = self._clock() if now is None else float(now)
        res = self.resolutions[0][0]
        series: Dict[str, List[list]] = {}
        for name, rings in self._series.items():
            cur = self._cursor.get(name)
            fresh = [list(b) for b in rings[0]
                     if (cur is None or b[_T] > cur) and b[_T] + res <= t]
            if fresh:
                series[name] = fresh
                self._cursor[name] = fresh[-1][_T]
        if not series:
            return None
        return {"v": 1, "res": res, "now": t, "series": series}

    def ingest_delta(self, payload: dict, *, prefix: str = "",
                     now: Optional[float] = None) -> int:
        """Merge an exported delta (rebased onto the local clock by the
        export-time offset) under ``prefix``; returns buckets merged."""
        if not payload:
            return 0
        t = self._clock() if now is None else float(now)
        offset = t - float(payload.get("now", t))
        merged = 0
        for name, buckets in sorted((payload.get("series") or {}).items()):
            for b in buckets:
                tb, count, total, vmin, vmax, last = b
                self._merge(prefix + name, float(tb) + offset,
                            float(count), float(total), float(vmin),
                            float(vmax), float(last))
                merged += 1
        return merged

    # ------------------------------------------------------------- read

    def series_names(self) -> List[str]:
        return sorted(self._series)

    def _ring_covering(self, rings: List[deque],
                       cut: float) -> Tuple[float, deque]:
        """The finest ring whose retained span still reaches back to
        ``cut`` (else the coarsest non-empty ring)."""
        best = None
        for (res, _n), ring in zip(self.resolutions, rings):
            if ring:
                best = (res, ring)
                if ring[0][_T] <= cut:
                    break
        return best if best is not None else (self.resolutions[0][0],
                                              deque())

    def bucket_points(self, name: str, window_s: float, *,
                      now: Optional[float] = None,
                      field: str = "mean") -> List[Tuple[float, float]]:
        """``(bucket_midpoint_t, value)`` pairs over the trailing
        window, from the finest ring that still covers it."""
        rings = self._series.get(name)
        if not rings:
            return []
        t = self._clock() if now is None else float(now)
        cut = t - float(window_s)
        res, ring = self._ring_covering(rings, cut)
        out = []
        for b in ring:
            if b[_T] + res <= cut or b[_T] > t:
                continue
            if field == "mean":
                v = b[_SUM] / b[_COUNT] if b[_COUNT] else 0.0
            elif field == "max":
                v = b[_MAX]
            elif field == "min":
                v = b[_MIN]
            elif field == "last":
                v = b[_LAST]
            else:
                raise ValueError(f"unknown field {field!r}")
            out.append((b[_T] + res / 2.0, v))
        return out

    def bad_fraction(self, name: str, window_s: float, objective: float,
                     *, now: Optional[float] = None,
                     field: str = "mean") -> float:
        """Fraction of trailing-window buckets whose ``field`` aggregate
        exceeds ``objective`` (0.0 with no data retained there).  This
        is the SLO evaluator's inner loop — three window scans per
        policy row per cadence tick — so it walks the ring in place
        instead of materializing :meth:`bucket_points` tuples (~3x off
        the armed-path cost the ``serving_slo_overhead`` bench gates)."""
        rings = self._series.get(name)
        if not rings:
            return 0.0
        t = self._clock() if now is None else float(now)
        cut = t - float(window_s)
        res, ring = self._ring_covering(rings, cut)
        total = bad = 0
        # newest-first with an early break: a 5 s fast window touches
        # ~6 buckets of a 512-bucket ring, not all of them
        for b in reversed(ring):
            if b[_T] > t:
                continue
            if b[_T] + res <= cut:
                break
            if field == "mean":
                v = b[_SUM] / b[_COUNT] if b[_COUNT] else 0.0
            elif field == "max":
                v = b[_MAX]
            elif field == "last":
                v = b[_LAST]
            else:
                raise ValueError(f"unknown field {field!r}")
            total += 1
            if v > objective:
                bad += 1
        return bad / total if total else 0.0

    def window(self, name: str, window_s: float, *,
               now: Optional[float] = None) -> Optional[dict]:
        """Aggregate over the trailing window: ``{count, mean, min,
        max, last}``, or ``None`` with no data retained there."""
        rings = self._series.get(name)
        if not rings:
            return None
        t = self._clock() if now is None else float(now)
        cut = t - float(window_s)
        res, ring = self._ring_covering(rings, cut)
        hits = [b for b in ring if b[_T] + res > cut and b[_T] <= t]
        if not hits:
            return None
        count = sum(b[_COUNT] for b in hits)
        total = sum(b[_SUM] for b in hits)
        return {"count": count,
                "mean": total / count if count else 0.0,
                "min": min(b[_MIN] for b in hits),
                "max": max(b[_MAX] for b in hits),
                "last": hits[-1][_LAST]}

    def latest(self, name: str) -> Optional[float]:
        rings = self._series.get(name)
        for ring in (rings or []):
            if ring:
                return ring[-1][_LAST]
        return None

    def slope(self, name: str, window_s: float, *,
              now: Optional[float] = None,
              field: str = "mean") -> float:
        """Least-squares slope (value units per second) over the
        trailing window; 0.0 until two buckets exist — the longitudinal
        replacement for the router's ad-hoc trend deque."""
        pts = self.bucket_points(name, window_s, now=now, field=field)
        if len(pts) < 2:
            return 0.0
        n = float(len(pts))
        mean_t = sum(t for t, _v in pts) / n
        mean_v = sum(v for _t, v in pts) / n
        den = sum((t - mean_t) ** 2 for t, _v in pts)
        if den <= 0:
            return 0.0
        num = sum((t - mean_t) * (v - mean_v) for t, v in pts)
        return num / den

    def match(self, pattern: str) -> List[str]:
        """Series names matching a ``*``-segment pattern (sorted)."""
        if "*" not in pattern:
            return [pattern] if pattern in self._series else []
        return [n for n in self.series_names() if match_series(pattern, n)]

    def introspect(self) -> dict:
        return {
            "series": len(self._series),
            "max_series": self.max_series,
            "overflowed": OVERFLOW_SERIES in self._series,
            "resolutions": [[r, n] for r, n in self.resolutions],
            "samples": self._samples,
            "last_sample_t": self._last_t,
        }
