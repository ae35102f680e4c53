"""Goodput/badput attribution over a flight-recorder timeline (port of
:mod:`apex_tpu.observability.goodput`).

Of a run's wall clock, how much went to useful work (**goodput**) and
where did the rest go (**badput**, itemized)?  The input is the event log
of :mod:`.timeline`; the output is a report in which every wall-clock
second is attributed to exactly one bucket:

==============  ==========================================================
bucket          source events
==============  ==========================================================
``compute``     ``step`` intervals (not flagged ``skipped``)
``compile``     ``compile`` intervals
``data_stall``  ``data_stall`` intervals (blocking input wait)
``checkpoint``  ``checkpoint_save`` / ``_save_async_submit`` / ``_verify``
``restore``     ``checkpoint_restore`` intervals
``skipped_step````step`` intervals flagged ``skipped`` (sentinel)
``drain``       ``drain`` intervals (preemption wind-down)
``other``       the remainder: wall - sum(attributed)
==============  ==========================================================

The instrumented intervals are main-thread blocking time measured at
call sites that do not nest; if one ever did, the report shows it as
``overcommit_s > 0`` instead of counting a second twice.

Serving attribution (:func:`serving_goodput_report`) works per request
from the lifecycle events: ``queue_wait`` (submit -> admit), ``active``
(admit -> finish: prefill and decode, the useful serving work) and
``drained`` (submitted, then cancelled or rejected).  Its
``goodput_fraction`` is active over total request-seconds.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

__all__ = [
    "TRAIN_BUCKETS",
    "classify_event",
    "assemble_report",
    "split_runs",
    "goodput_report",
    "serving_goodput_report",
    "format_report",
]

TRAIN_BUCKETS = ("compute", "compile", "data_stall", "checkpoint",
                 "restore", "skipped_step", "drain", "other")

# kind -> bucket for the unconditional cases; ``step`` branches on the
# ``skipped`` flag in classify_event.
_KIND_BUCKET = {
    "compile": "compile",
    "data_stall": "data_stall",
    "checkpoint_save": "checkpoint",
    "checkpoint_save_async_submit": "checkpoint",
    "checkpoint_verify": "checkpoint",
    "checkpoint_restore": "restore",
    "drain": "drain",
}


def classify_event(event: dict) -> Optional[str]:
    """Bucket of one event, ``None`` for kinds that carry no wall-clock
    attribution (markers, serving lifecycle — those feed
    :func:`serving_goodput_report` instead)."""
    kind = event.get("kind")
    if kind == "step":
        return "skipped_step" if event.get("skipped") else "compute"
    return _KIND_BUCKET.get(kind)


def assemble_report(bucket_s: Dict[str, float], *, wall_s: float) -> dict:
    """Close the books over accumulated per-bucket seconds: fill the
    missing buckets with 0, attribute the remainder to ``other``, and
    derive ``goodput_fraction``.  ``overcommit_s`` > 0 means attributed
    time exceeded wall-clock — an instrumentation nesting bug, surfaced
    rather than hidden (``other`` is clamped at 0)."""
    buckets = {b: round(bucket_s.get(b, 0.0), 6) for b in TRAIN_BUCKETS
               if b != "other"}
    attributed = sum(buckets.values())
    wall_s = float(wall_s)
    buckets["other"] = round(max(0.0, wall_s - attributed), 6)
    return {
        "wall_s": round(wall_s, 6),
        "buckets": buckets,
        "goodput_fraction": (round(buckets["compute"] / wall_s, 6)
                             if wall_s > 0 else None),
        "overcommit_s": round(max(0.0, attributed - wall_s), 6),
    }


def _wall_from_events(events: List[dict]) -> float:
    """Run wall-clock: ``run_end.wall_s`` when the run closed cleanly,
    else the newest event's timestamp (the crash case — the tail of the
    run after the last event is unknowable and not counted)."""
    wall = 0.0
    for ev in events:
        if ev.get("kind") == "run_end" and "wall_s" in ev:
            wall = max(wall, float(ev["wall_s"]))
        elif "t" in ev:
            wall = max(wall, float(ev["t"]))
    return wall


def split_runs(events: Iterable[dict]) -> List[List[dict]]:
    """Segment a spilled timeline into its runs (each ``run_begin``
    starts a new segment).  A spill path reused across process
    restarts — the crash→resume shape — APPENDS runs to one file, and
    each run's ``t`` clock restarts at its own arm time, so events from
    different segments must never be summed together."""
    runs: List[List[dict]] = [[]]
    for ev in events:
        if ev.get("kind") == "run_begin" and runs[-1]:
            runs.append([])
        runs[-1].append(ev)
    return [r for r in runs if r]


def goodput_report(events: Iterable[dict], *,
                   wall_s: Optional[float] = None) -> dict:
    """Offline recompute over a (possibly torn) spilled timeline, a
    list of its events.  Agrees with the armed recorder's incremental
    :meth:`~apex_tpu_torch.observability.timeline.FlightRecorder.report`.

    A file carrying several appended runs (spill path reused across
    restarts) reports the NEWEST run — per-run clocks make a cross-run
    sum meaningless; map :func:`split_runs` to analyze the history."""
    runs = split_runs(events)
    events = runs[-1] if runs else []
    bucket_s: Dict[str, float] = {}
    for ev in events:
        bucket = classify_event(ev)
        if bucket is not None and "dur_s" in ev:
            bucket_s[bucket] = bucket_s.get(bucket, 0.0) + float(ev["dur_s"])
    if wall_s is None:
        wall_s = _wall_from_events(events)
    return assemble_report(bucket_s, wall_s=wall_s)


# --- serving ---------------------------------------------------------------


def serving_goodput_report(events: Iterable[dict]) -> dict:
    """Per-request attribution from the serving lifecycle events.

    For every request id seen: ``queue_wait_s`` (submit → admit),
    ``active_s`` (admit → finish — prefill plus decode, the useful
    work), or ``drained_s`` (submit → cancel/reject, wholly wasted;
    rejected requests are also counted in ``totals["rejected"]``).
    Requests
    still in flight at the end of the log are counted ``open`` and
    excluded from the fraction (their split is not yet known).  A
    terminal request whose ``request_submit`` fell off a wrapped ring
    still counts toward ``finished``/``cancelled`` — it just
    contributes no seconds (the fraction covers fully-observed
    lifecycles only)."""
    reqs: Dict[object, dict] = {}

    def rec(rid):
        return reqs.setdefault(rid, {"submit": None, "admit": None,
                                     "end": None, "state": "open",
                                     "tokens": 0})

    for ev in events:
        kind, rid = ev.get("kind"), ev.get("rid")
        if rid is None:
            continue
        t = float(ev.get("t", 0.0))
        if kind == "request_submit":
            rec(rid)["submit"] = t
        elif kind == "request_admit":
            rec(rid)["admit"] = t
        elif kind == "decode_tick":
            rec(rid)["tokens"] = max(rec(rid)["tokens"],
                                     int(ev.get("tokens", 0)))
        elif kind == "request_finish":
            r = rec(rid)
            r["end"], r["state"] = t, "finished"
            r["tokens"] = max(r["tokens"], int(ev.get("tokens", 0)))
        elif kind == "request_cancel":
            r = rec(rid)
            r["end"], r["state"] = t, "cancelled"
        elif kind == "request_reject":
            r = rec(rid)
            r["end"], r["state"] = t, "rejected"

    per_request = {}
    tot_queue = tot_active = tot_drained = 0.0
    n_finished = n_cancelled = n_rejected = n_open = 0
    for rid, r in reqs.items():
        sub = r["submit"]
        row = {"state": r["state"], "tokens": r["tokens"]}
        # Counts follow the terminal state even when the submit event
        # fell off a wrapped ring (only the time split needs the submit
        # timestamp) — totals must never contradict per-request states.
        if r["state"] == "finished":
            n_finished += 1
            if sub is not None:
                admit = r["admit"] if r["admit"] is not None else sub
                row["queue_wait_s"] = round(admit - sub, 6)
                row["active_s"] = round(r["end"] - admit, 6)
                tot_queue += row["queue_wait_s"]
                tot_active += row["active_s"]
        elif r["state"] == "cancelled":
            n_cancelled += 1
            if sub is not None:
                row["drained_s"] = round(r["end"] - sub, 6)
                tot_drained += row["drained_s"]
        elif r["state"] == "rejected":
            # refused at submit (drain window / overload shed): a typed
            # terminal state that holds ~zero request-seconds — counted,
            # and its sliver of wall lands in the wasted bucket
            n_rejected += 1
            if sub is not None:
                row["drained_s"] = round(r["end"] - sub, 6)
                tot_drained += row["drained_s"]
        else:
            n_open += 1
        per_request[rid] = row

    total = tot_queue + tot_active + tot_drained
    return {
        "requests": per_request,
        "totals": {
            "finished": n_finished, "cancelled": n_cancelled,
            "rejected": n_rejected, "open": n_open,
            "queue_wait_s": round(tot_queue, 6),
            "active_s": round(tot_active, 6),
            "drained_s": round(tot_drained, 6),
        },
        "goodput_fraction": (round(tot_active / total, 6)
                             if total > 0 else None),
    }


def format_report(report: dict) -> str:
    """One human-readable block (what the dryrun/smoke entries print)."""
    lines = [f"goodput: wall {report['wall_s']:.3f}s, "
             f"fraction {report['goodput_fraction']}"]
    wall = report["wall_s"] or 1.0
    for name in TRAIN_BUCKETS:
        sec = report["buckets"].get(name, 0.0)
        if sec:
            lines.append(f"  {name:<13} {sec:10.3f}s  {sec / wall:6.1%}")
    if report.get("overcommit_s"):
        lines.append(f"  OVERCOMMIT    {report['overcommit_s']:.3f}s "
                     "(instrumentation overlap bug)")
    return "\n".join(lines)
