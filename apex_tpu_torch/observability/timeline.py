"""Flight recorder: the run timeline (port of
:mod:`apex_tpu.observability.timeline`).

One object, :class:`FlightRecorder`, owns one monotonic-clock event log
that a person or :mod:`.goodput` can replay to see where a run's wall
clock went:

- **events** are flat JSON dicts ``{"t": <monotonic seconds since the
  recorder armed>, "kind": <type>, ...}``; interval kinds also carry
  ``dur_s`` and are emitted at the interval's end, so a crash loses at
  most the interval in flight;
- a **bounded in-memory ring** keeps the newest events (:meth:`tail`);
- an optional **JSONL spill** appends every event as one ``O_APPEND``
  write of one line, so a SIGKILL tears at most the last line
  (``fsync=False`` by default: process death cannot tear a written line,
  only power loss can);
- **goodput buckets accumulate at emit time**, so goodput so far is one
  read at any instant, even after the ring wrapped.

The serving engine's events (:class:`~apex_tpu_torch.serving.engine.
ServingEngine`):

=====================  ====================================================
kind                   payload (beyond ``t`` / ``dur_s``)
=====================  ====================================================
``run_begin``          ``wall_ts`` (epoch seconds), ``mono_t0``, metadata
``run_end``            ``wall_s``, the armed wall clock
``preemption``         ``wall_ts``: the engine began to drain
``request_submit``     ``rid``, ``prompt_tokens``, ``max_new_tokens``
                       (``imported=True`` for a KV import)
``request_admit``      ``rid``, ``slot``, ``blocks``, ``hit_blocks``
``prefill``            ``rids`` (this call's slots), ``tokens``; ``dur_s``
``request_prefilled``  ``rid``, ``tokens``: the prompt is in the cache
``decode_tick``        ``rid``, ``tokens``, every N generated tokens
``request_preempt``    ``rid``, ``tokens``: back to the queue
``request_export``     ``rid``, ``tokens``, ``blocks``: migrated out
``request_finish``     ``rid``, ``tokens``
``request_cancel``     ``rid``: drained out of the queue
``request_reject``     ``rid``: refused at submit, never queued
``adapter_load``       ``adapter_id``, ``slot``, ``evicted``
``adapter_unload``     ``adapter_id``, ``slot``
=====================  ====================================================

Arming is process-wide and opt-in: the module-level :func:`emit` and
:func:`scope` the engine calls are one ``is None`` check when no
recorder is armed.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from apex_tpu_torch.observability.goodput import (
    assemble_report,
    classify_event,
)

__all__ = [
    "FlightRecorder",
    "arm",
    "arm_from_env",
    "disarm",
    "active",
    "emit",
    "scope",
    "TIMELINE_ENV_VAR",
]

TIMELINE_ENV_VAR = "APEX_TPU_TIMELINE_DIR"


def _json_default(obj):
    """numpy scalars and anything else JSON lacks, as plain values."""
    if hasattr(obj, "item"):
        return obj.item()
    return str(obj)


class _Spill:
    """Append-only JSONL file: one ``O_APPEND`` write of one whole line
    per event over one descriptor, fsync'd when asked."""

    def __init__(self, path: str, *, fsync: bool = False):
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self.path = path
        self.fsync = fsync
        self._fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                           0o644)

    def write(self, record: dict) -> None:
        data = (json.dumps(record, separators=(",", ":"),
                           default=_json_default) + "\n").encode()
        sent = 0
        while sent < len(data):
            sent += os.write(self._fd, data[sent:])
        if self.fsync:
            os.fsync(self._fd)

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1


class FlightRecorder:
    """Crash-safe structured event log on one process-local monotonic
    clock.

    ``path``   — optional JSONL spill; every event is durably appended
                 (torn-tail-only loss under SIGKILL).  ``None`` keeps
                 the ring only (unit tests, pure introspection).
    ``ring``   — in-memory tail size for live introspection.
    ``fsync``  — per-event fsync on the spill.  Off by default: the
                 single ``os.write`` of a full line already survives
                 process death; fsync only buys power-loss durability
                 at a syscall per event.
    ``meta``   — extra fields stamped onto the ``run_begin`` event
                 (run name, mesh shape, ...).
    """

    def __init__(self, path: Optional[str] = None, *, ring: int = 4096,
                 fsync: bool = False, meta: Optional[dict] = None):
        if ring < 1:
            raise ValueError(f"ring must be >= 1, got {ring}")
        self.path = path
        # one descriptor held for the recorder's life: an open per
        # event would be the armed path's dominant cost at serving event
        # rates; each event is still one O_APPEND write of a whole line
        self._writer = _Spill(path, fsync=fsync) if path else None
        self._ring: "collections.deque[dict]" = collections.deque(maxlen=ring)
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self.events_emitted = 0
        # incremental goodput accounting: bucket -> attributed seconds
        # (exact after the ring wraps; the classes are goodput.py's)
        self._bucket_s: Dict[str, float] = {}
        # mono_t0 anchors this spill on the process's monotonic clock,
        # so an event's relative ``t`` maps back to it as mono_t0 + t
        self.emit("run_begin", wall_ts=time.time(),
                  mono_t0=round(self._t0, 6), **(meta or {}))

    # ------------------------------------------------------------ clock

    @property
    def elapsed_s(self) -> float:
        return time.monotonic() - self._t0

    # ------------------------------------------------------------- emit

    def emit(self, kind: str, *, dur_s: Optional[float] = None,
             **fields: Any) -> dict:
        """Record one event now.  Interval events pass ``dur_s`` (the
        caller measured it; the event lands at the interval's end)."""
        ev: Dict[str, Any] = {"t": round(self.elapsed_s, 6), "kind": kind}
        if dur_s is not None:
            ev["dur_s"] = round(float(dur_s), 6)
        ev.update(fields)
        bucket = classify_event(ev)
        with self._lock:
            self._ring.append(ev)
            self.events_emitted += 1
            if bucket is not None and dur_s is not None:
                self._bucket_s[bucket] = (
                    self._bucket_s.get(bucket, 0.0) + float(dur_s))
        if self._writer is not None:
            self._writer.write(ev)
        return ev

    @contextlib.contextmanager
    def scope(self, kind: str, **fields: Any):
        """Time a block and emit one ``kind`` event with its ``dur_s``
        when it exits (even on exception — the crash-visible shape is a
        *missing* final event, never a dangling half-interval)."""
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.emit(kind, dur_s=time.monotonic() - t0, **fields)

    # ----------------------------------------------------- typed helpers

    def step(self, step: int, **fields: Any):
        """Scope for one training step's host dispatch+sync window."""
        return self.scope("step", step=step, **fields)

    def compile(self, what: str):
        return self.scope("compile", what=what)

    def data_stall(self, dur_s: float, **fields: Any) -> dict:
        return self.emit("data_stall", dur_s=dur_s, **fields)

    def sentinel_skip(self, step: int, skipped_steps: int) -> dict:
        return self.emit("sentinel_skip", step=step,
                         skipped_steps=skipped_steps)

    def preemption(self, **fields: Any) -> dict:
        return self.emit("preemption", wall_ts=time.time(), **fields)

    # ------------------------------------------------------ introspection

    def events(self) -> List[dict]:
        """Snapshot of the in-memory ring (oldest retained first)."""
        with self._lock:
            return list(self._ring)

    def tail(self, n: int = 32) -> List[dict]:
        with self._lock:
            if n >= len(self._ring):
                return list(self._ring)
            return list(self._ring)[-n:]

    def report(self) -> dict:
        """Goodput so far from the incremental bucket accounting (exact
        even after the ring wrapped); :func:`~apex_tpu_torch.
        observability.goodput.goodput_report` recomputes it offline from
        the events."""
        with self._lock:
            buckets = dict(self._bucket_s)
        return assemble_report(buckets, wall_s=self.elapsed_s)

    # ------------------------------------------------------------- flush

    def flush(self, goodput_path: Optional[str] = None) -> dict:
        """Emit ``run_end``, compute the final goodput report, and
        optionally write it as JSON.  Idempotent-ish: callable once per
        run end (a second call emits a second ``run_end``)."""
        wall = self.elapsed_s
        self.emit("run_end", wall_s=round(wall, 6))
        report = self.report()
        if goodput_path:
            parent = os.path.dirname(goodput_path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            tmp = goodput_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(report, f, indent=1)
            os.replace(tmp, goodput_path)
        return report


# --- process-global arming ------------------------------------------------

_ACTIVE: Optional[FlightRecorder] = None
_ARM_LOCK = threading.Lock()


def arm(recorder_or_path) -> FlightRecorder:
    """Install the process-wide recorder (a :class:`FlightRecorder`, or
    a path string to spill to).  Instrumented subsystems pick it up via
    the module-level :func:`emit`/:func:`scope`."""
    global _ACTIVE
    rec = (recorder_or_path if isinstance(recorder_or_path, FlightRecorder)
           else FlightRecorder(recorder_or_path))
    with _ARM_LOCK:
        _ACTIVE = rec
    return rec


def arm_from_env() -> Optional[FlightRecorder]:
    """Arm from ``APEX_TPU_TIMELINE_DIR`` (spill to
    ``<dir>/timeline.jsonl``); ``None`` when the variable is unset, the
    default that costs nothing."""
    d = os.environ.get(TIMELINE_ENV_VAR)
    if not d:
        return None
    return arm(os.path.join(d, "timeline.jsonl"))


def disarm() -> Optional[FlightRecorder]:
    """Remove (and return) the process recorder."""
    global _ACTIVE
    with _ARM_LOCK:
        rec, _ACTIVE = _ACTIVE, None
    return rec


def active() -> Optional[FlightRecorder]:
    return _ACTIVE


def emit(kind: str, *, dur_s: Optional[float] = None,
         **fields: Any) -> Optional[dict]:
    """Emit into the armed recorder; a single ``None`` check when
    unarmed — safe on any hot host path."""
    rec = _ACTIVE
    if rec is None:
        return None
    return rec.emit(kind, dur_s=dur_s, **fields)


@contextlib.contextmanager
def scope(kind: str, **fields: Any):
    """Module-level :meth:`FlightRecorder.scope`; no-op (no clock read,
    no allocation beyond the generator) when unarmed."""
    rec = _ACTIVE
    if rec is None:
        yield
        return
    with rec.scope(kind, **fields):
        yield
