"""Distributed tracing over the fleet — stitch N spills into one story
(port of :mod:`apex_tpu.observability.trace`).

The run-timeline layer answers "where did this *process's*
wall-clock go"; in a fleet a single request traverses
router queue → wire → replica queue → admission → chunked prefill →
decode ticks, possibly detouring through preemption-recompute or a
kill-mid-decode failover onto a *different replica* — and no
process-local view can answer "where did this request's 900 ms go".
This module is the merge: given the router's spill and every replica's
spill (each written by its own :class:`~apex_tpu_torch.observability.
timeline.FlightRecorder`, process identity in the ``run_begin`` meta),
it reconstructs one span tree per ``trace_id`` and attributes **every
wall-clock millisecond of the request to exactly one hop bucket**:

==================  =====================================================
hop bucket          interval
==================  =====================================================
``router_queue``    ``fleet_submit`` → ``fleet_dispatch`` (router pool)
``wire``            dispatch → replica ``request_submit`` (transport +
                    command queue), and replica ``request_finish`` →
                    router ``fleet_finish`` (the return leg)
``replica_queue``   ``request_submit`` → ``request_admit`` (the engine's
                    waiting deque — no free slot / first-chunk blocks)
``admission_wait``  ``request_admit`` → the request's first prefill
                    chunk actually starting (admitted but the packed
                    prefill hasn't picked it up yet)
``prefill``         first own chunk start → ``request_prefilled``
                    (includes inter-chunk waits while other slots run)
``decode``          ``request_prefilled`` → ``request_finish``
``preempted``       ``request_preempt`` → re-``request_admit``
                    (recompute-on-readmit)
``failover_replay`` the dead replica's last flushed event →
                    the re-``fleet_dispatch`` (detection + probe ladder
                    + router requeue — the failover *cost*)
``kv_migrate``      ``fleet_migrate_start`` → the dispatch onto the
                    decode replica
==================  =====================================================

Exhaustive and disjoint **by construction**: the attribution is a
single monotone walk over the request's merged milestones, so the hop
sum equals the trace's wall-clock exactly — the goodput report's
discipline (``overcommit_s``) applied per-request, fleet-wide.  What *can* go
wrong cross-process is the clock: mapped timestamps from different
hosts can disagree by up to the link RTT, so the walk clamps any
backwards step and reports the total as ``clock_clamped_s`` instead of
silently reordering (a large value means the offset samples are stale
or the link asymmetric, not that time ran backwards).

Clock alignment (cross-host clocks are never compared raw): the socket transport's ping/pong and hello exchanges carry the
replica host's monotonic stamp; :func:`estimate_offset` is the NTP
midpoint construction — the remote stamped its clock somewhere inside
the client's ``[t_send, t_recv]`` window, so ``offset = midpoint −
remote`` errs by at most RTT/2.  The router mirrors each sample into
its spill as a ``link_clock`` event (refreshed per ping), and the
merger maps every replica event onto the **router host's** monotonic
clock via the sample nearest on the replica's own clock — so a stepped
or restarted replica clock uses the samples of its own era.  Links
with no samples (the in-process ``ReplicaProcess`` transport — same
host, one ``CLOCK_MONOTONIC``) map with offset 0.

Report: :func:`format_trace_report` over :func:`summarize_traces`.
"""

from __future__ import annotations

import bisect
import glob
import itertools
import os
import re
from typing import Dict, List, Optional, Tuple

from apex_tpu_torch.observability.goodput import split_runs
from apex_tpu_torch.observability.timeline import FlightRecorder
from apex_tpu_torch.observability.writers import read_jsonl

__all__ = [
    "TRACE_HOP_BUCKETS",
    "arm_process",
    "estimate_offset",
    "map_time",
    "read_fleet_spills",
    "stitch_traces",
    "summarize_traces",
    "collect_decisions",
    "collect_slo_events",
    "merge_dir",
    "format_trace_report",
    "TRACE_UNATTRIBUTED_KINDS",
]

TRACE_HOP_BUCKETS = (
    "router_queue", "wire", "replica_queue", "admission_wait",
    "prefill", "decode", "preempted", "failover_replay", "kv_migrate",
)

# Milestone kinds and their state transitions (the walk below).  Rank
# breaks exact-time ties in logical order — at equal mapped timestamps
# a dispatch must precede the replica-side submit it caused, and a
# replica finish must precede the router observing it.
_KIND_RANK = {
    "fleet_submit": 0, "fleet_dispatch": 1, "request_submit": 2,
    "request_admit": 3, "prefill_chunk_start": 4,
    "prefill_chunk_end": 5, "decode_tick": 6, "request_prefilled": 6,
    "request_preempt": 7, "request_cancel": 7, "request_reject": 7,
    "fleet_migrate_start": 7,
    "fleet_replay": 8, "request_finish": 9, "fleet_finish": 10,
    "fleet_reject": 10,
}
_ROUTER_KINDS = ("fleet_submit", "fleet_dispatch", "fleet_replay",
                 "fleet_migrate_start", "fleet_finish", "fleet_reject")
_REPLICA_KINDS = ("request_submit", "request_admit",
                  "request_prefilled", "decode_tick", "request_preempt",
                  "request_cancel", "request_reject", "request_finish")

# Marker kinds deliberately outside every attribution bucket, each with
# the reason it is a point event, not an interval.  The event-schema
# lint (APX302, apex_tpu.analysis.control_plane) holds every other
# emitted kind to a consumer in this module or goodput.py, and fails
# when an entry here goes stale (nothing emits it anymore).
TRACE_UNATTRIBUTED_KINDS = {
    "preemption": "guard-trip marker; the drain cost it starts is "
                  "attributed by the 'drain' scope / 'preempted' hop",
    "sentinel_skip": "forensic marker; goodput charges skipped time via "
                     "the 'step' event's skipped flag, not this point",
    "request_export": "KV-handoff forensics on the prefill side; the "
                      "migration interval is the 'kv_migrate' hop "
                      "(fleet_migrate_start -> commit dispatch)",
    "adapter_load": "registration forensics; load latency is router-"
                    "side (fleet/adapter_loads + ack pump), not a "
                    "request interval",
    "adapter_unload": "registration forensics, same as adapter_load",
}


# --------------------------------------------------------------- arming


def arm_process(timeline_dir: str, role: str, name: str) -> FlightRecorder:
    """Arm this process's flight recorder for fleet tracing: the spill
    lands at ``<dir>/timeline.<role>.<name>.<pid>.jsonl`` and the
    ``run_begin`` meta carries the same identity, which is what
    :func:`read_fleet_spills` classifies on.  One directory per fleet
    run; every process (the router and each replica) arms its own."""
    from apex_tpu_torch.observability import timeline as tl

    os.makedirs(timeline_dir, exist_ok=True)
    pid = os.getpid()
    rec = FlightRecorder(
        os.path.join(timeline_dir,
                     f"timeline.{role}.{name}.{pid}.jsonl"),
        meta={"role": role, "name": name, "pid": pid})
    return tl.arm(rec)


# --------------------------------------------------------- clock algebra


def estimate_offset(t_send: float, t_recv: float,
                    remote_mono: float) -> Tuple[float, float]:
    """One round trip's clock-offset estimate: ``(offset_s, err_s)``
    with ``local ≈ remote + offset``.

    The NTP midpoint construction: the remote stamped ``remote_mono``
    somewhere inside the local ``[t_send, t_recv]`` window, so mapping
    it to the midpoint errs by at most half the round trip —
    ``err_s = (t_recv - t_send) / 2`` is the hard bound the
    injected-clock tests pin, however skewed or stepped the remote
    clock is."""
    if t_recv < t_send:
        raise ValueError(
            f"t_recv ({t_recv}) precedes t_send ({t_send})")
    offset = (t_send + t_recv) / 2.0 - remote_mono
    return offset, (t_recv - t_send) / 2.0


def map_time(raw_mono: float,
             samples: List[Tuple[float, float]]) -> float:
    """Map a remote monotonic stamp onto the local (router) clock using
    the offset sample **nearest on the remote's own clock** —
    ``samples`` is a sorted list of ``(remote_mono, offset_s)``.  A
    remote clock that stepped (process restart, a different boot epoch)
    gets the samples of its own era; no samples means the identity map
    (the same-host transports share one CLOCK_MONOTONIC)."""
    if not samples:
        return raw_mono
    i = bisect.bisect_left(samples, (raw_mono, float("-inf")))
    best = None
    for j in (i - 1, i):
        if 0 <= j < len(samples):
            if best is None or (abs(samples[j][0] - raw_mono)
                                < abs(samples[best][0] - raw_mono)):
                best = j
    return raw_mono + samples[best][1]


# ------------------------------------------------------------- spill IO


def _run_meta(run: List[dict]) -> dict:
    head = run[0] if run and run[0].get("kind") == "run_begin" else {}
    return head


_ROTATED_RE = re.compile(r"\.rot-(\d+)\.jsonl$")


def _spill_groups(timeline_dir: str) -> List[List[str]]:
    """Group a spill directory's files into logical streams: a
    ``JsonlWriter(rotate_bytes=...)`` leaves ``<stem>.rot-NNNNNN.jsonl``
    segments beside the live ``<stem>.jsonl``; each group is
    its segments in rotation order with the live file last, so
    concatenating a group replays the stream's append order exactly."""
    groups: Dict[str, List[Tuple[int, str]]] = {}
    for path in sorted(glob.glob(
            os.path.join(timeline_dir, "timeline*.jsonl"))):
        m = _ROTATED_RE.search(path)
        if m:
            base = path[:m.start()] + ".jsonl"
            seq = int(m.group(1))
        else:
            base, seq = path, 1 << 62
        groups.setdefault(base, []).append((seq, path))
    return [[p for _seq, p in sorted(groups[base])]
            for base in sorted(groups)]


def read_fleet_spills(timeline_dir: str, *, strict: bool = True):
    """Discover and load a fleet run's spills: ``(router_run,
    replica_runs)`` where ``replica_runs`` maps replica name → list of
    runs (a rolled replica leaves one spill per incarnation, each its
    own pid).  Rotated segments of one stream are concatenated back in
    order first; then the newest run per stream (`split_runs` — a
    reused spill path appends).  Files whose ``run_begin`` carries no
    fleet role are ignored (a plain timeline can share the
    directory)."""
    router_run: Optional[List[dict]] = None
    replica_runs: Dict[str, List[List[dict]]] = {}
    for group in _spill_groups(timeline_dir):
        events: List[dict] = []
        for path in group:
            events.extend(read_jsonl(path, strict=strict))
        runs = split_runs(events)
        if not runs:
            continue
        run = runs[-1]
        meta = _run_meta(run)
        role = meta.get("role")
        if role == "router":
            if router_run is not None:
                raise ValueError(
                    f"{timeline_dir}: more than one router spill "
                    "(one merge covers one router's fleet)")
            router_run = run
        elif role == "replica":
            replica_runs.setdefault(str(meta.get("name")), []).append(run)
    if router_run is None:
        raise ValueError(
            f"{timeline_dir}: no router spill found (arm the router "
            "process with trace.arm_process(dir, 'router', <name>))")
    return router_run, replica_runs


# ------------------------------------------------------------ stitching


def _link_samples(router_run: List[dict]) -> Dict[str, list]:
    """Per-replica sorted ``(remote_mono, offset_s)`` samples from the
    router spill's ``link_clock`` events."""
    samples: Dict[str, list] = {}
    for ev in router_run:
        if ev.get("kind") == "link_clock":
            samples.setdefault(str(ev.get("replica")), []).append(
                (float(ev["remote_mono"]), float(ev["offset_s"])))
    for lst in samples.values():
        lst.sort()
    return samples


def stitch_traces(router_run: List[dict],
                  replica_runs: Dict[str, List[List[dict]]]) -> dict:
    """Merge one router run + N replica runs into per-request traces:
    ``{trace_id: record}`` where every record's ``hops`` partition its
    wall-clock exactly (see the module docstring for the walk)."""
    router_t0 = float(_run_meta(router_run).get("mono_t0", 0.0))
    samples = _link_samples(router_run)
    seq = itertools.count()
    milestones: Dict[str, list] = {}
    meta_by_trace: Dict[str, dict] = {}

    def add(tid: str, t: float, kind: str, process: str, ev: dict):
        milestones.setdefault(tid, []).append(
            (t, _KIND_RANK.get(kind, 6), next(seq), kind, process, ev))

    for ev in router_run:
        tid = ev.get("trace_id")
        kind = ev.get("kind")
        if tid is None or kind not in _ROUTER_KINDS:
            continue
        if kind == "fleet_submit":
            meta_by_trace[tid] = {
                "rid": ev.get("rid"), "tenant": ev.get("tenant"),
                "priority": ev.get("priority"),
                "prompt_tokens": ev.get("prompt_tokens"),
                "max_new_tokens": ev.get("max_new_tokens"),
            }
        add(tid, float(ev["t"]), kind, "router", ev)

    for name, runs in replica_runs.items():
        link = samples.get(name, [])
        for run in runs:
            t0 = float(_run_meta(run).get("mono_t0", 0.0))
            rid_to_trace: Dict[object, str] = {}

            def mapped(t: float) -> float:
                return map_time(t0 + float(t), link) - router_t0

            for ev in run:
                kind = ev.get("kind")
                tid = ev.get("trace_id")
                if tid is not None and "rid" in ev:
                    rid_to_trace[ev["rid"]] = tid
                if tid is not None and kind in _REPLICA_KINDS:
                    add(tid, mapped(ev["t"]), kind, name, ev)
                elif kind == "prefill":
                    # the packed prefill scope covers several slots; a
                    # traced request's FIRST own chunk start is its
                    # admission_wait → prefill boundary (rid → trace
                    # resolved through the process-local submit events)
                    t_end = mapped(ev["t"])
                    t_start = t_end - float(ev.get("dur_s", 0.0))
                    for rid in ev.get("rids", ()):
                        rtid = rid_to_trace.get(rid)
                        if rtid is not None:
                            add(rtid, t_start, "prefill_chunk_start",
                                name, ev)
                            add(rtid, t_end, "prefill_chunk_end",
                                name, ev)

    traces = {}
    for tid, events in milestones.items():
        events, clamped = _clamp_causal(events)
        events.sort(key=lambda m: m[:3])
        record = _walk(events)
        record["clock_clamped_s"] = round(
            record["clock_clamped_s"] + clamped, 6)
        record["trace_id"] = tid
        record.update(meta_by_trace.get(tid, {}))
        traces[tid] = record
    return traces


def _clamp_causal(events: list) -> Tuple[list, float]:
    """Clock-offset error can map a replica event *before* the router
    dispatch that caused it (bounded by the link RTT — the estimator's
    hard bound).  Causality wins: every replica-side milestone of
    attempt k is clamped forward to that attempt's ``fleet_dispatch``
    time, and the total shift is reported as ``clock_clamped_s`` (a
    large value means stale offset samples or an asymmetric link, not
    a broken trace — the hop books still close exactly)."""
    dispatch_t: Dict[int, float] = {}
    for m in events:
        if m[3] == "fleet_dispatch":
            dispatch_t[int(m[5].get("attempt", 1))] = m[0]
    clamped = 0.0
    fixed = []
    for t, rank, seq, kind, process, ev in events:
        if kind in _REPLICA_KINDS:
            dt = dispatch_t.get(int(ev.get("attempt", 0) or 0))
            if dt is not None and t < dt:
                clamped += dt - t
                t = dt
        fixed.append((t, rank, seq, kind, process, ev))
    return fixed, clamped


# The state a milestone transitions the walk INTO (None = activity
# marker, no transition).  ``return_wire`` is the replica-finish →
# router-finish leg, bucketed as wire.
_TRANSITION = {
    "fleet_submit": "router_queue",
    "fleet_dispatch": "wire",
    "request_submit": "replica_queue",
    "request_admit": "admission_wait",
    "request_prefilled": "decode",
    "request_preempt": "preempted",
    "fleet_replay": "failover_replay",
    # the disaggregation handoff: opened by the router's
    # migrate-start, closed by the dispatch-onto-decode (the ordinary
    # "wire" transition) — a failed handoff exits through fleet_replay
    # instead, so either way the books close
    "fleet_migrate_start": "kv_migrate",
    "request_finish": "return_wire",
}
_BUCKET_OF = {state: state for state in TRACE_HOP_BUCKETS}
_BUCKET_OF["return_wire"] = "wire"
_TERMINAL = {"fleet_finish": "finished", "fleet_reject": "rejected"}


def _walk(events: list) -> dict:
    """One monotone pass over a trace's merged milestones: each
    inter-milestone interval lands in exactly one hop bucket (the state
    the walk was in), so the buckets partition the wall-clock by
    construction.  Backwards mapped time (clock-offset error, bounded
    by the link RTT) is clamped forward and totalled, never reordered;
    ``fleet_replay`` retro-attributes the interval since the dead
    replica's last flushed event to ``failover_replay`` (the unknowable
    post-kill remainder is failover cost, not decode)."""
    hops = {b: 0.0 for b in TRACE_HOP_BUCKETS}
    spans: List[dict] = []
    state: Optional[str] = None
    prev_t: Optional[float] = None
    t_begin: Optional[float] = None
    clamped = 0.0
    replicas: List[str] = []
    attempts = 0
    terminal = None
    for t, _rank, _seq, kind, process, ev in events:
        if terminal is not None:
            break
        if prev_t is not None and t < prev_t:
            clamped += prev_t - t
            t = prev_t
        if state is not None and prev_t is not None and t > prev_t:
            bucket = ("failover_replay" if kind == "fleet_replay"
                      else _BUCKET_OF[state])
            hops[bucket] += t - prev_t
            if (spans and spans[-1]["hop"] == bucket
                    and spans[-1]["process"] == process
                    and spans[-1]["t1"] == round(prev_t, 6)):
                # coalesce adjacent same-hop activity (per-token decode
                # ticks would otherwise leave a span per token)
                spans[-1]["t1"] = round(t, 6)
            else:
                spans.append({"t0": round(prev_t, 6),
                              "t1": round(t, 6),
                              "hop": bucket, "process": process})
        if kind == "fleet_submit" and t_begin is None:
            t_begin = t
        if kind == "fleet_dispatch":
            attempts = max(attempts, int(ev.get("attempt", 1)))
            rep = ev.get("replica")
            if rep is not None and rep not in replicas:
                replicas.append(rep)
        if kind in _TERMINAL:
            terminal = _TERMINAL[kind]
        elif kind == "prefill_chunk_start":
            # conditional boundary: only the request's FIRST chunk of
            # this admission ends its admission_wait — later chunks
            # (and other slots' chunks it rode along with) are just
            # prefill-phase activity
            if state == "admission_wait":
                state = "prefill"
        elif kind in _TRANSITION:
            state = _TRANSITION[kind]
        prev_t = t
    wall = (prev_t - t_begin) if (prev_t is not None
                                  and t_begin is not None) else 0.0
    attributed = sum(hops.values())
    return {
        "state": terminal if terminal is not None else "open",
        "t_submit": round(t_begin, 6) if t_begin is not None else None,
        "t_end": round(prev_t, 6) if prev_t is not None else None,
        "wall_s": round(wall, 6),
        "hops": {b: round(s, 6) for b, s in hops.items()},
        "spans": spans,
        "attempts": attempts,
        "replicas": replicas,
        # the per-request books, closed: a monotone partition cannot
        # double-count, so both stay 0 unless the milestone chain
        # itself is malformed — surfaced, never hidden
        "overcommit_s": round(max(0.0, attributed - wall), 6),
        "unattributed_s": round(max(0.0, wall - attributed), 6),
        "clock_clamped_s": round(clamped, 6),
    }


# ------------------------------------------------------------ reporting


def summarize_traces(traces: dict, *, tail_pct: float = 99.0) -> dict:
    """Fleet-level rollup: total seconds per hop bucket, terminal-state
    counts, and **slowest-hop attribution for the tail** — the traces
    at or above the ``tail_pct`` wall-clock percentile, each with the
    hop that dominated it (the "where did the p99's time go" answer)."""
    closed = [r for r in traces.values() if r["state"] != "open"]
    hop_totals = {b: 0.0 for b in TRACE_HOP_BUCKETS}
    states: Dict[str, int] = {}
    for rec in traces.values():
        states[rec["state"]] = states.get(rec["state"], 0) + 1
        for b, s in rec["hops"].items():
            hop_totals[b] += s
    tail = []
    tail_wall = None
    if closed:
        walls = sorted(r["wall_s"] for r in closed)
        idx = max(0, min(len(walls) - 1,
                         int(round(tail_pct / 100.0 * len(walls))) - 1))
        tail_wall = walls[idx]
        for rec in sorted(closed, key=lambda r: -r["wall_s"]):
            if rec["wall_s"] < tail_wall:
                break
            slowest = max(rec["hops"], key=lambda b: rec["hops"][b])
            tail.append({
                "trace_id": rec["trace_id"], "rid": rec.get("rid"),
                "wall_s": rec["wall_s"], "slowest_hop": slowest,
                "slowest_hop_s": rec["hops"][slowest],
                "attempts": rec["attempts"],
                "replicas": rec["replicas"],
            })
    return {
        "requests": len(traces),
        "states": states,
        "hop_totals_s": {b: round(s, 6) for b, s in hop_totals.items()},
        "overcommit_s": round(sum(r["overcommit_s"]
                                  for r in traces.values()), 6),
        "unattributed_s": round(sum(r["unattributed_s"]
                                    for r in traces.values()), 6),
        "clock_clamped_s": round(sum(r["clock_clamped_s"]
                                     for r in traces.values()), 6),
        "tail_pct": tail_pct,
        "tail_wall_s": tail_wall,
        "tail": tail,
    }


def collect_decisions(router_run: Optional[List[dict]]) -> List[dict]:
    """ Reconstruct the autopilot's decision timeline from
    the router spill: the four ``autopilot_*`` event kinds grouped by
    ``decision_id`` into ``{decision_id, t, loop, action, reason,
    verdict, events}`` rows in decision order — the "why did the fleet
    change shape" answer printed next to the request traces."""
    by_id: Dict[str, dict] = {}
    for ev in router_run or []:
        kind = ev.get("kind", "")
        if not kind.startswith("autopilot_"):
            continue
        did = ev.get("decision_id")
        rec = by_id.setdefault(did, {
            "decision_id": did, "t": ev.get("t"), "loop": None,
            "action": None, "reason": None, "verdict": None,
            "events": []})
        rec["events"].append(dict(ev))
        if ev.get("loop") is not None:
            rec["loop"] = ev["loop"]
        if kind == "autopilot_decide":
            rec["action"] = ev.get("action")
            rec["reason"] = ev.get("reason")
        elif kind == "autopilot_verdict":
            rec["verdict"] = ev.get("verdict")
    return sorted(by_id.values(),
                  key=lambda r: (r["t"] if r["t"] is not None else 0.0,
                                 str(r["decision_id"])))


def collect_slo_events(events: Optional[List[dict]]) -> dict:
    """ Reconstruct the SLO plane's story from a spill: the
    burn-rate transition events and the periodic budget-table snapshots
    the evaluator emitted.  ``{"alerts": [...], "clears": [...],
    "states": [...], "open": [...]}`` — ``open`` lists the
    ``(policy, metric)`` pairs whose newest transition is an alert with
    no later clear (an incident still burning at end of spill).  This
    is the consumption side of the ``slo_burn_alert`` /
    ``slo_burn_clear`` / ``slo_state`` vocabulary (APX302) and the raw
    material of ``scripts/slo_report.py``."""
    alerts: List[dict] = []
    clears: List[dict] = []
    states: List[dict] = []
    last: Dict[Tuple[str, str], str] = {}
    for ev in events or []:
        kind = ev.get("kind")
        if kind == "slo_burn_alert":
            alerts.append(dict(ev))
            last[(str(ev.get("policy")), str(ev.get("metric")))] = "alert"
        elif kind == "slo_burn_clear":
            clears.append(dict(ev))
            last[(str(ev.get("policy")), str(ev.get("metric")))] = "clear"
        elif kind == "slo_state":
            states.append(dict(ev))
    return {"alerts": alerts, "clears": clears, "states": states,
            "open": sorted(k for k, v in last.items() if v == "alert")}


def merge_dir(timeline_dir: str, *, strict: bool = True,
              tail_pct: float = 99.0) -> dict:
    """The one-call merge: read a fleet run's spills, stitch, and
    summarize — ``{"traces": {...}, "summary": {...}, "decisions":
    [...]}`` (``decisions`` is the autopilot's reconstructed timeline,
    empty when no autopilot ran)."""
    router_run, replica_runs = read_fleet_spills(timeline_dir,
                                                 strict=strict)
    traces = stitch_traces(router_run, replica_runs)
    return {"traces": traces,
            "summary": summarize_traces(traces, tail_pct=tail_pct),
            "decisions": collect_decisions(router_run)}


def format_trace_report(report: dict) -> str:
    """Human-readable block (what ``scripts/trace_report.py`` prints)."""
    summary = report["summary"]
    lines = [
        f"traces: {summary['requests']} request(s), "
        f"states {summary['states']}",
    ]
    total = sum(summary["hop_totals_s"].values()) or 1.0
    for bucket in TRACE_HOP_BUCKETS:
        sec = summary["hop_totals_s"].get(bucket, 0.0)
        if sec:
            lines.append(f"  {bucket:<16} {sec:10.3f}s  "
                         f"{sec / total:6.1%}")
    for key in ("overcommit_s", "unattributed_s", "clock_clamped_s"):
        if summary.get(key):
            lines.append(f"  {key.upper()} {summary[key]:.6f}s")
    if summary["tail"]:
        lines.append(f"tail (>= p{summary['tail_pct']:g} wall "
                     f"{summary['tail_wall_s']:.3f}s):")
        for row in summary["tail"]:
            lines.append(
                f"  {row['trace_id']} rid={row['rid']} "
                f"wall {row['wall_s']:.3f}s <- {row['slowest_hop']} "
                f"({row['slowest_hop_s']:.3f}s, "
                f"attempts={row['attempts']}, "
                f"replicas={row['replicas']})")
    decisions = report.get("decisions") or []
    if decisions:
        lines.append(f"autopilot decisions: {len(decisions)}")
        for rec in decisions:
            verdict = rec["verdict"] if rec["verdict"] is not None \
                else "(open)"
            lines.append(
                f"  {rec['decision_id']} t={rec['t']:.3f} "
                f"[{rec['loop']}] {rec['action']} -> {verdict}"
                + (f"  # {rec['reason']}" if rec.get("reason") else ""))
    return "\n".join(lines)
