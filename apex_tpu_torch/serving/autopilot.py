"""SLO autopilot: the control loop that operates the fleet (port of
:mod:`apex_tpu.serving.autopilot`).

The router has the sensors (per-tenant/per-priority windowed TTFT/TPOT,
link RTT histograms, trace critical paths naming the slowest hop of
every tail request) and the actuators (``replica_serve`` host daemons,
ready-handshake + SIGTERM-drain lifecycle, rollout/swap, live knob
broadcasts).  :class:`FleetAutopilot` closes three loops beside
``FleetRouter.pump()``:

**Scale** — grow/drain replicas off queue depth and the windowed
p99-trend slope, through an injected ``spawn(name) -> client`` factory.
New replicas join via the ordinary ready handshake (never dispatched
before ready); drained replicas leave via the ordinary SIGTERM-drain
path (never a stranded request).  Never below ``min_replicas``, at most
one scale action per cool-down window, and a flapping replica (up/down
churn, or a spawn that keeps dying before ready) is QUARANTINED under
capped exponential back-off (``fleet/autopilot/quarantines``) instead
of re-spawned in a hot loop.  A partition during scale-up reaps the
half-born replica (``fleet/autopilot/reaps``) — it is removed from the
routing table, not leaked.  A tail driven by a degraded link is demoted
in placement by the router already; the autopilot recognizes that
signature (trend up, queues shallow, a link flagged degraded) and
explicitly decides *not* to scale.

**Retune** — when trace attribution (an injected ``attribution()``
callable; see :func:`trace_attribution`) blames a hop, actuate the
matching knob: shrink the chunked-prefill ``prefill_chunk`` when
``prefill`` dominates tail traces, lower speculative ``spec_k`` when
acceptance sags below the floor, tighten/relax the router's
``max_queue_depth`` shed bound when ``router_queue`` grows.  Engine
knobs travel as a broadcast command with acks (the ``swap_adapter``
discipline, over :meth:`FleetRouter.set_knobs`).

**Canary** — every engine-knob change lands on ONE replica first and is
judged over a bounded observation window by the paired
median-of-ratios A/B machinery the bench uses: at each round boundary
the canary's windowed p99 TPOT is paired with the control replicas'
median p99; the median of the per-round ratios is the verdict.  A
regressing canary is rolled back automatically
(``fleet/autopilot/rollbacks``); a healthy one is committed fleet-wide.
A canary host that dies mid-observation yields verdict
``inconclusive`` — no rollback storm, the knob died with the host.
Router-local knobs (the shed bound) have no per-replica split, so they
are judged before/after against the fleet p99 over the same window.

Every decision is four typed timeline events — ``autopilot_observe``
(the signal snapshot) → ``autopilot_decide`` (action + reason) →
``autopilot_act`` (what was actuated) → ``autopilot_verdict`` (how it
resolved) — sharing a ``decision_id`` and riding the trace plane's
spill files, so a trace report can reconstruct *why* the fleet changed
shape next to the request traces that made it.  The
whole loop runs on an injectable clock (default: the router's), reads
only router/registry state, and draws ids from deterministic counters:
the same signals produce the same action sequence, run after run.

Disarmed is free: an unconstructed autopilot touches nothing — no
event, no counter, no per-replica histogram, no placement change (the
router's ``per_replica_slo`` flag exists so even the canary windows
cost nothing until an autopilot flips it on).

Torch-free by design, like the router it drives.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
from typing import Any, Callable, Dict, List, Optional

from apex_tpu_torch.observability import timeline

__all__ = ["AutopilotConfig", "FleetAutopilot", "trace_attribution"]

logger = logging.getLogger(__name__)


def trace_attribution(timeline_dir: str, *, tail_pct: float = 99.0,
                      strict: bool = False) -> Optional[dict]:
    """Tail attribution off a trace spill dir — the default glue
    between the trace plane and the retune loop: returns
    ``{"slowest_hop": <bucket>, "share": <0..1>, "tail": n}`` for the
    hop that dominates the most tail traces (ties break toward the
    alphabetically-first bucket, deterministically), or ``None`` when
    there is no closed tail yet.  Wrap in a lambda to inject:
    ``FleetAutopilot(router, attribution=lambda:
    trace_attribution(spill_dir))``."""
    from apex_tpu_torch.observability.trace import merge_dir

    try:
        tail = merge_dir(timeline_dir, strict=strict,
                         tail_pct=tail_pct)["summary"]["tail"]
    except FileNotFoundError:
        return None
    if not tail:
        return None
    votes: Dict[str, int] = {}
    for row in tail:
        votes[row["slowest_hop"]] = votes.get(row["slowest_hop"], 0) + 1
    hop = min(votes, key=lambda h: (-votes[h], h))
    return {"slowest_hop": hop,
            "share": round(votes[hop] / len(tail), 4),
            "tail": len(tail)}


@dataclasses.dataclass(frozen=True)
class AutopilotConfig:
    """Autopilot policy — every threshold the three loops read.

    Scale: grow when fleet queue depth reaches
    ``scale_up_queue_depth`` OR the windowed p99-TPOT slope reaches
    ``scale_up_trend_ms_per_s`` (unless the trend is explained by a
    degraded link); drain back when depth falls to
    ``scale_down_queue_depth`` with a non-positive trend.  One scale
    action per ``scale_cooldown_s``; pool clamped to
    [``min_replicas``, ``max_replicas``].  A replica with
    ``flap_threshold`` down-edges inside ``flap_window_s`` is
    quarantined ``quarantine_base_s`` (doubling per quarantine, capped
    at ``quarantine_cap_s``).

    Retune: one knob change per ``retune_cooldown_s``, canaried over
    ``canary_observe_s`` split into ``canary_rounds`` paired samples;
    fewer than ``canary_min_rounds`` valid pairs is inconclusive;
    a median ratio above ``canary_regress_ratio`` rolls back.
    """

    # -- scale loop
    min_replicas: int = 1
    max_replicas: int = 8
    scale_up_queue_depth: int = 16
    scale_up_trend_ms_per_s: float = 5.0
    scale_down_queue_depth: int = 2
    scale_cooldown_s: float = 30.0
    join_timeout_s: float = 300.0
    drain_timeout_s: float = 120.0
    # -- flap quarantine
    flap_window_s: float = 120.0
    flap_threshold: int = 3
    quarantine_base_s: float = 30.0
    quarantine_cap_s: float = 600.0
    # -- retune loop
    retune_cooldown_s: float = 60.0
    prefill_shrink: float = 0.5
    prefill_floor: int = 32
    spec_acceptance_floor: float = 0.3
    spec_k_floor: int = 0
    queue_bound_min: int = 16
    queue_bound_step: float = 2.0
    # -- canary judge
    canary_observe_s: float = 10.0
    canary_rounds: int = 5
    canary_min_rounds: int = 3
    canary_regress_ratio: float = 1.2
    # -- predictive scale: when the router's longitudinal
    # history is armed, project the fleet TTFT p99 forward by the
    # regression slope over ``predictive_window_s`` of real buckets; a
    # projected breach of the objective within ``predictive_horizon_s``
    # (or a slow-window SLO burn at/over ``predictive_burn``) triggers
    # scale-up BEFORE the queue-depth threshold trips.
    # ``predictive_objective_ms`` 0.0 derives the objective from the
    # router's own TTFT SLO policies (the tightest one).  A disarmed
    # router (history=None) makes the whole path a no-op.
    predictive_horizon_s: float = 10.0
    predictive_window_s: float = 10.0
    predictive_objective_ms: float = 0.0
    predictive_burn: float = 6.0

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {self.min_replicas}")
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"max_replicas ({self.max_replicas}) < min_replicas "
                f"({self.min_replicas})")
        if not (0.0 < self.prefill_shrink < 1.0):
            raise ValueError(
                f"prefill_shrink must be in (0, 1), got "
                f"{self.prefill_shrink}")
        if self.canary_rounds < 1 or self.canary_min_rounds < 1:
            raise ValueError("canary rounds must be >= 1")
        if self.flap_threshold < 2:
            raise ValueError(
                f"flap_threshold must be >= 2, got {self.flap_threshold}")
        if self.queue_bound_step <= 1.0:
            raise ValueError(
                f"queue_bound_step must be > 1, got "
                f"{self.queue_bound_step}")
        if self.predictive_horizon_s < 0 or self.predictive_window_s <= 0:
            raise ValueError(
                "predictive_horizon_s must be >= 0 and "
                "predictive_window_s > 0")
        if self.predictive_burn <= 0:
            raise ValueError(
                f"predictive_burn must be positive, got "
                f"{self.predictive_burn}")


class FleetAutopilot:
    """The fleet control loop.  Construct beside a
    :class:`~apex_tpu_torch.serving.fleet.FleetRouter` and call :meth:`tick`
    from the same loop that pumps it::

        ap = FleetAutopilot(router, spawn=lambda name:
                            ReplicaProcess(spec, name))
        while serving:
            router.pump()
            ap.tick()

    ``spawn``: the scale actuator — ``None`` disables growing (the
    retune and quarantine loops still run).  ``attribution``: a
    zero-arg callable returning ``{"slowest_hop": ...}`` or ``None``
    (see :func:`trace_attribution`).  ``clock`` defaults to the
    router's injected clock, so one fake clock drives both
    deterministically.
    """

    def __init__(self, router, *, spawn: Optional[Callable] = None,
                 config: Optional[AutopilotConfig] = None,
                 attribution: Optional[Callable[[], Optional[dict]]] = None,
                 clock: Optional[Callable[[], float]] = None,
                 registry=None):
        self.router = router
        self.spawn = spawn
        self.config = config if config is not None else AutopilotConfig()
        self.attribution = attribution
        self._clock = clock if clock is not None else router._clock
        self.registry = registry if registry is not None else \
            router.registry
        # arm the per-replica canary windows (the ONE router-side flag
        # that separates armed from disarmed)
        router.per_replica_slo = True
        self._ids = itertools.count(1)        # decision ids
        self._spawn_seq = itertools.count(1)  # auto-replica names
        self._last_scale_t: Optional[float] = None
        self._last_none_t: Optional[float] = None
        self._last_retune_t: Optional[float] = None
        self._joining: Dict[str, dict] = {}    # name -> {deadline, id}
        self._draining: Dict[str, dict] = {}   # name -> {deadline, id}
        self._downs: Dict[str, List[float]] = {}   # down-edge times
        self._was_down: Dict[str, bool] = {}
        self._quarantine: Dict[str, dict] = {}  # {until, backoff_s}
        self._canary: Optional[dict] = None     # in-flight observation
        # committed fleet-wide knob state (None = engine default); the
        # rollback payload for the NEXT canary of the same knob
        self.knobs: Dict[str, Any] = {}
        self._base_max_queue_depth = int(router.max_queue_depth)
        # bounded decision log (the determinism tests compare these)
        self.decisions: List[dict] = []

    # ------------------------------------------------------------ events

    def _count(self, name: str) -> None:
        self.registry.counter(f"fleet/autopilot/{name}").inc()

    def _emit(self, kind: str, decision_id: str, **fields) -> None:
        """One typed decision event: appended to the bounded local log
        (what tests compare) and emitted on the timeline with the trace
        plane's ids (what ``trace_report`` reconstructs)."""
        rec = {"kind": kind, "decision_id": decision_id,
               "t": round(self._clock(), 6)}
        rec.update(fields)
        self.decisions.append(rec)
        if len(self.decisions) > 512:
            del self.decisions[:len(self.decisions) - 512]
        timeline.emit(kind, decision_id=decision_id, **fields)

    def _decide(self, loop: str, action: str, reason: str,
                observe: dict, **fields) -> str:
        """Open a decision: observe + decide share one id; act/verdict
        follow under the same id."""
        did = f"ap{next(self._ids)}"
        self._emit("autopilot_observe", did, loop=loop, **observe)
        self._emit("autopilot_decide", did, loop=loop, action=action,
                   reason=reason, **fields)
        self._count("decisions")
        return did

    # -------------------------------------------------------------- tick

    def tick(self) -> None:
        """One control iteration — non-blocking decisions on the
        injected clock (the canary *observation* spans ticks; only the
        knob-broadcast ack is pump-waited, the swap_adapter
        discipline).  Safe to call at any cadence; a tick with nothing
        to do reads a few signals and returns."""
        now = self._clock()
        self._note_downs(now)
        self._pump_joining(now)
        self._pump_draining(now)
        if self._canary is not None:
            self._judge_canary(now)
            return        # one action in flight: observe, don't stack
        self._repair(now)
        if self._maybe_scale(now):
            return
        self._maybe_retune(now)

    # ----------------------------------------------------- flap tracking

    def _note_downs(self, now: float) -> None:
        """Down-edge detection per replica name; ``flap_threshold``
        edges inside ``flap_window_s`` quarantines the name under
        doubling (capped) back-off."""
        for name, view in list(self.router._views.items()):
            cur = bool(view.down) or not view.client.alive()
            if name in self._joining or name in self._draining \
                    or view.drained:
                # orchestrated exits are not flaps: a drain completing
                # is success, and a join dying is _pump_joining's one
                # reap-and-note (never double-counted here)
                self._was_down[name] = cur
                continue
            if cur and not self._was_down.get(name, False):
                self._note_flap(name, now,
                                reason=view.down_reason or "dead")
            self._was_down[name] = cur

    def _note_flap(self, name: str, now: float, *,
                   reason: str = "down") -> None:
        edges = self._downs.setdefault(name, [])
        edges.append(now)
        cutoff = now - self.config.flap_window_s
        while edges and edges[0] < cutoff:
            edges.pop(0)
        if len(edges) < self.config.flap_threshold:
            return
        prev = self._quarantine.get(name)
        backoff = min(self.config.quarantine_cap_s,
                      prev["backoff_s"] * 2.0 if prev is not None
                      else self.config.quarantine_base_s)
        self._quarantine[name] = {"until": now + backoff,
                                  "backoff_s": backoff}
        edges.clear()
        self._count("quarantines")
        did = self._decide(
            "scale", "quarantine",
            f"{self.config.flap_threshold} down-edges in "
            f"{self.config.flap_window_s:g}s (last: {reason})",
            {"replica": name,
             "flap_threshold": self.config.flap_threshold},
            replica=name)
        self._emit("autopilot_act", did, action="quarantine",
                   replica=name, backoff_s=backoff)
        self._emit("autopilot_verdict", did, verdict="quarantined",
                   replica=name, until=round(now + backoff, 6))

    def _quarantined(self, name: str, now: float) -> bool:
        q = self._quarantine.get(name)
        return q is not None and now < q["until"]

    # -------------------------------------------------- join/drain pumps

    def _pump_joining(self, now: float) -> None:
        """Confirm ready joins; reap half-born replicas (join timeout,
        or death before ready — the partition-during-scale-up row)."""
        for name, rec in list(self._joining.items()):
            view = self.router._views.get(name)
            if view is not None and view.ready and not view.down:
                del self._joining[name]
                self._emit("autopilot_verdict", rec["id"],
                           verdict="joined", replica=name)
                continue
            dead = (view is None or view.down
                    or not view.client.alive())
            if dead or now > rec["deadline"]:
                del self._joining[name]
                self.router.remove_replica(name)
                self._count("reaps")
                self._emit("autopilot_verdict", rec["id"],
                           verdict="reaped", replica=name,
                           reason=("died before ready" if dead
                                   else "join timeout"))
                # a join that keeps dying counts toward the flap
                # quarantine — the anti-hot-loop backstop
                self._note_flap(name, now, reason="died before ready")

    def _pump_draining(self, now: float) -> None:
        """Complete scale-downs: once the drain finishes (or times
        out), retire the replica from the routing table."""
        for name, rec in list(self._draining.items()):
            view = self.router._views.get(name)
            done = (view is None or view.down or view.drained
                    or not view.client.alive())
            if not done and now <= rec["deadline"]:
                continue
            del self._draining[name]
            self.router.remove_replica(name)
            self._emit("autopilot_verdict", rec["id"],
                       verdict=("drained" if done else "drain timeout"),
                       replica=name)

    # ------------------------------------------------------------- scale

    def _live_views(self) -> List:
        return [v for v in self.router._views.values()
                if not v.down and v.client.alive()]

    def _repair(self, now: float) -> None:
        """Min-pool repair: respawn dead replicas (same name — the
        routing table replaces the down holder) up to ``min_replicas``.
        Repair bypasses the scale cool-down (it restores promised
        capacity, it does not chase load) — the quarantine back-off is
        what bounds a flapping replica's respawn rate."""
        if self.spawn is None:
            return
        capacity = len(self._live_views()) + len(self._joining)
        if capacity >= self.config.min_replicas:
            return
        for name in sorted(self.router._views):
            if capacity >= self.config.min_replicas:
                break
            view = self.router._views[name]
            if not view.down or name in self._joining:
                continue
            if self._quarantined(name, now):
                continue
            did = self._decide(
                "scale", "respawn",
                f"live capacity {capacity} below min_replicas "
                f"{self.config.min_replicas}",
                {"live": capacity, "min_replicas":
                 self.config.min_replicas, "replica": name},
                replica=name)
            if self._spawn_into(name, did, now):
                capacity += 1
                self._count("respawns")

    def _spawn_into(self, name: str, decision_id: str,
                    now: float) -> bool:
        try:
            client = self.spawn(name)
        except Exception as e:  # noqa: BLE001 — verdict, not crash
            logger.warning("autopilot: spawn(%s) failed: %r", name, e)
            self._emit("autopilot_verdict", decision_id,
                       verdict="spawn failed", replica=name,
                       reason=repr(e))
            self._note_flap(name, now, reason=f"spawn failed: {e!r}")
            return False
        self.router.add_replica(client)
        self._was_down[name] = False
        self._joining[name] = {
            "deadline": now + self.config.join_timeout_s,
            "id": decision_id}
        self._emit("autopilot_act", decision_id, action="spawn",
                   replica=name)
        self._count("actions")
        return True

    def _predict(self, now: float):
        """Predictive scale signal off the router's longitudinal
        history: project the fleet TTFT p99 forward by its
        regression slope; a projected objective breach within the
        horizon — or a slow-window SLO burn over ``predictive_burn`` —
        is a scale-up trigger that fires BEFORE queue depth does.
        Returns ``(predictive, extra_observe)``; ``(False, None)`` when
        the history plane is disarmed."""
        cfg = self.config
        history = getattr(self.router, "history", None)
        if history is None or cfg.predictive_horizon_s <= 0:
            return False, None
        series = "fleet/ttft_ms:p99"
        slope = history.slope(series, cfg.predictive_window_s, now=now)
        last = history.latest(series)
        objective = cfg.predictive_objective_ms
        slo = getattr(self.router, "slo", None)
        if objective <= 0 and slo is not None:
            objs = [p.objective for p in slo.policies
                    if p.metric.startswith("fleet/ttft_ms")]
            if objs:
                objective = min(objs)
        burn = 0.0
        if slo is not None and slo.last_rows:
            burn = max(r["burn_slow"] for r in slo.last_rows)
        extra = {"history_slope_ms_per_s": round(slope, 4),
                 "history_p99_ms": (None if last is None
                                    else round(last, 3)),
                 "burn_slow": round(burn, 4)}
        breach = bool(
            last is not None and slope > 0 and objective > 0
            and last + slope * cfg.predictive_horizon_s >= objective)
        return breach or burn >= cfg.predictive_burn, extra

    def _maybe_scale(self, now: float) -> bool:
        """One load-driven scale action per cool-down window."""
        cfg = self.config
        if self._joining or self._draining:
            return False     # a membership change is already in flight
        if self._last_scale_t is not None and \
                now - self._last_scale_t < cfg.scale_cooldown_s:
            return False
        live = self._live_views()
        depth = self.router.total_queue_depth()
        trend = self.router.p99_trend("tpot_ms")
        observe = {"queue_depth": depth,
                   "p99_trend_ms_per_s": round(trend, 4),
                   "live": len(live)}
        predictive, pred_obs = self._predict(now)
        if pred_obs is not None:
            observe.update(pred_obs)
        deep = depth >= cfg.scale_up_queue_depth
        trending = trend >= cfg.scale_up_trend_ms_per_s
        if (deep or trending or predictive) and self.spawn is not None \
                and len(live) < cfg.max_replicas:
            if (trending or predictive) and not deep \
                    and any(v.link_degraded for v in live):
                # the slow-link row of the fault matrix: the tail
                # slope is the wire's, and placement already demotes
                # the degraded replica — more capacity would not move
                # the p99, so the explicit decision is "none"
                if self._last_none_t is None or \
                        now - self._last_none_t >= cfg.scale_cooldown_s:
                    self._last_none_t = now
                    did = self._decide(
                        "scale", "none",
                        "p99 trend explained by a degraded link "
                        "(demoted in placement, not scaled)",
                        dict(observe, link_degraded=[
                            v.name for v in live if v.link_degraded]))
                    self._emit("autopilot_verdict", did,
                               verdict="no action")
                return False
            name = f"auto{next(self._spawn_seq)}"
            while name in self.router._views:
                name = f"auto{next(self._spawn_seq)}"
            did = self._decide(
                "scale", "scale_up",
                ("queue depth over threshold" if deep
                 else "predicted p99 TTFT breach within horizon"
                 if predictive and not trending
                 else "p99 TPOT trending up"),
                observe, replica=name)
            if self._spawn_into(name, did, now):
                self._count("scale_up")
                self._last_scale_t = now
            return True
        if depth <= cfg.scale_down_queue_depth and trend <= 0.0 \
                and not predictive and len(live) > cfg.min_replicas:
            victim = self._pick_drain_victim(live)
            if victim is None:
                return False
            did = self._decide(
                "scale", "scale_down",
                "queue drained and tail flat; above min_replicas",
                observe, replica=victim.name)
            try:
                victim.client.begin_drain()
            except Exception as e:  # noqa: BLE001 — verdict, not crash
                self._emit("autopilot_verdict", did,
                           verdict="drain failed", replica=victim.name,
                           reason=repr(e))
                return True
            self._draining[victim.name] = {
                "deadline": now + cfg.drain_timeout_s, "id": did}
            self._emit("autopilot_act", did, action="drain",
                       replica=victim.name)
            self._count("actions")
            self._count("scale_down")
            self._last_scale_t = now
            return True
        return False

    def _pick_drain_victim(self, live: List):
        """Deterministic: the newest autopilot-spawned replica first
        (drain back what the burst grew), else the lexicographically
        last name."""
        def order(v):
            auto = v.name.startswith("auto")
            return (0 if auto else 1,
                    -int(v.name[4:]) if auto and v.name[4:].isdigit()
                    else 0, v.name)
        for v in sorted(live, key=order):
            return v
        return None

    # ------------------------------------------------------------ retune

    def _knob_base(self, key: str) -> Optional[int]:
        """Current effective value of an engine knob: the committed
        override if set, else the engine default read off the state
        heartbeats (the smallest across live replicas — conservative)."""
        if self.knobs.get(key) is not None:
            return int(self.knobs[key])
        default_key = {"prefill_chunk": "prefill_len",
                       "spec_k": "spec_k_max"}[key]
        vals = []
        for v in self._live_views():
            knobs = (v.state or {}).get("knobs") or {}
            if knobs.get(default_key) is not None:
                vals.append(int(knobs[default_key]))
        return min(vals) if vals else None

    def _min_spec_acceptance(self) -> Optional[float]:
        vals = [v.state["spec_acceptance"] for v in self._live_views()
                if v.state and v.state.get("spec_acceptance") is not None]
        return min(vals) if vals else None

    def _maybe_retune(self, now: float) -> None:
        cfg = self.config
        if self._last_retune_t is not None and \
                now - self._last_retune_t < cfg.retune_cooldown_s:
            return
        live = self._live_views()
        if not live:
            return
        attr = self.attribution() if self.attribution is not None \
            else None
        hop = (attr or {}).get("slowest_hop")
        # knob priority is fixed (deterministic): prefill attribution,
        # then acceptance sag, then the router's own queue
        if hop == "prefill":
            base = self._knob_base("prefill_chunk")
            if base is not None:
                target = max(cfg.prefill_floor,
                             int(base * cfg.prefill_shrink))
                if target < base:
                    self._start_knob_canary(
                        now, {"prefill_chunk": target},
                        {"prefill_chunk": self.knobs.get(
                            "prefill_chunk")},
                        reason=f"prefill dominates the tail "
                               f"(share {attr.get('share')})",
                        observe={"attribution": attr,
                                 "prefill_chunk": base})
                    return
        acc = self._min_spec_acceptance()
        if acc is not None and acc < cfg.spec_acceptance_floor:
            base = self._knob_base("spec_k")
            if base is not None and base > cfg.spec_k_floor:
                self._start_knob_canary(
                    now, {"spec_k": base - 1},
                    {"spec_k": self.knobs.get("spec_k")},
                    reason=f"spec acceptance {acc:.3f} below floor "
                           f"{cfg.spec_acceptance_floor:g}",
                    observe={"spec_acceptance": acc, "spec_k": base})
                return
        if hop == "router_queue":
            self._retune_queue_bound(now, attr)

    def _start_knob_canary(self, now: float, payload: dict,
                           rollback: dict, *, reason: str,
                           observe: dict) -> None:
        """Apply an engine-knob change to ONE replica and open the
        paired observation window."""
        cfg = self.config
        names = sorted(v.name for v in self._live_views())
        canary, controls = names[0], names[1:]
        did = self._decide("retune", "set_knobs", reason, observe,
                           payload=dict(payload), canary=canary)
        self._last_retune_t = now
        res = self.router.set_knobs(payload, names=[canary])
        ok, info = res.get(canary, (False, "replica down"))
        self._count("actions")
        self._count("retunes")
        self._emit("autopilot_act", did, action="set_knobs",
                   canary=canary, payload=dict(payload),
                   ok=bool(ok), info=repr(info) if not ok else None)
        if not ok:
            self._emit("autopilot_verdict", did, verdict="act failed",
                       canary=canary, reason=repr(info))
            return
        step = cfg.canary_observe_s / cfg.canary_rounds
        self._canary = {
            "id": did, "mode": "knob", "payload": dict(payload),
            "rollback": dict(rollback), "canary": canary,
            "controls": controls, "pairs": [], "next_round": 0,
            "round_ends": [now + step * (i + 1)
                           for i in range(cfg.canary_rounds)],
        }

    def _retune_queue_bound(self, now: float,
                            attr: Optional[dict]) -> None:
        """Tighten the router's shed bound when its own queue is the
        tail's slowest hop (shed earlier, protect admitted tails);
        judged before/after over the same canary window since the knob
        is router-local (no per-replica split exists)."""
        cfg = self.config
        cur = int(self.router.max_queue_depth)
        target = max(cfg.queue_bound_min, int(cur / cfg.queue_bound_step))
        if target >= cur:
            return
        did = self._decide(
            "retune", "queue_bound",
            "router_queue dominates the tail: tighten the shed bound",
            {"attribution": attr, "max_queue_depth": cur},
            payload={"max_queue_depth": target})
        self._last_retune_t = now
        self.router.max_queue_depth = target
        self._count("actions")
        self._count("retunes")
        self._emit("autopilot_act", did, action="queue_bound",
                   payload={"max_queue_depth": target})
        step = cfg.canary_observe_s / cfg.canary_rounds
        self._canary = {
            "id": did, "mode": "router",
            "payload": {"max_queue_depth": target},
            "rollback": {"max_queue_depth": cur},
            "baseline": self._fleet_p99(), "pairs": [],
            "next_round": 0,
            "round_ends": [now + step * (i + 1)
                           for i in range(cfg.canary_rounds)],
        }

    # ------------------------------------------------------------ canary

    def _replica_p99(self, name: str) -> Optional[float]:
        return self.router._slo_hist(
            f"fleet/replica/{name}/tpot_ms").percentile(99)

    def _fleet_p99(self) -> Optional[float]:
        hist = self.registry._histograms.get("fleet/tpot_ms")
        return hist.percentile(99) if hist is not None else None

    def _sample_pair(self, c: dict) -> Optional[tuple]:
        """One paired (treated, control) p99 sample, or None when
        either side has no window yet."""
        if c["mode"] == "knob":
            treated = self._replica_p99(c["canary"])
            ctrl = sorted(p for p in (self._replica_p99(n)
                                      for n in c["controls"])
                          if p is not None)
            control = ctrl[len(ctrl) // 2] if ctrl else None
        else:
            treated, control = self._fleet_p99(), c["baseline"]
        if treated is None or control is None:
            return None
        return (float(treated), float(control))

    def _rollback(self, c: dict) -> None:
        if c["mode"] == "knob":
            self.router.set_knobs(c["rollback"], names=[c["canary"]])
        else:
            self.router.max_queue_depth = \
                int(c["rollback"]["max_queue_depth"])

    def _judge_canary(self, now: float) -> None:
        """Advance the paired observation; at the window's end, the
        median of per-round (treated / control) p99 ratios is the
        verdict — the bench's paired median-of-ratios machinery run
        live."""
        c, cfg = self._canary, self.config
        if c["mode"] == "knob":
            view = self.router._views.get(c["canary"])
            if view is None or view.down or not view.client.alive():
                # canary host died mid-observation: the knob died with
                # it — verdict inconclusive, no rollback storm (failure
                # detection + repair own the host; the knob change was
                # never committed fleet-wide)
                self._canary = None
                self._count("inconclusive")
                self._emit("autopilot_verdict", c["id"],
                           verdict="inconclusive",
                           reason="canary host died mid-observation",
                           canary=c["canary"])
                return
        while c["next_round"] < len(c["round_ends"]) and \
                now >= c["round_ends"][c["next_round"]]:
            pair = self._sample_pair(c)
            if pair is not None:
                c["pairs"].append(pair)
            c["next_round"] += 1
        if now < c["round_ends"][-1]:
            return
        self._canary = None
        pairs = c["pairs"]
        if len(pairs) < cfg.canary_min_rounds:
            # not enough paired signal to judge: restore the canary
            # (it is alive — this is caution, not a regression verdict)
            self._rollback(c)
            self._count("inconclusive")
            self._emit("autopilot_verdict", c["id"],
                       verdict="inconclusive",
                       reason=f"only {len(pairs)} paired samples "
                              f"(need {cfg.canary_min_rounds})",
                       restored=True)
            return
        ratios = sorted(t / max(ctrl, 1e-9) for t, ctrl in pairs)
        ratio = ratios[len(ratios) // 2]
        if ratio > cfg.canary_regress_ratio:
            self._rollback(c)
            self._count("rollbacks")
            self._emit("autopilot_verdict", c["id"],
                       verdict="rollback",
                       ratio=round(ratio, 4), rounds=len(pairs),
                       payload=c["payload"], rolled_back=c["rollback"])
            return
        # healthy: commit fleet-wide
        if c["mode"] == "knob":
            rest = [n for n in sorted(
                v.name for v in self._live_views())
                if n != c["canary"]]
            if rest:
                self.router.set_knobs(c["payload"], names=rest)
        self.knobs.update(c["payload"])
        self._count("commits")
        self._emit("autopilot_verdict", c["id"], verdict="commit",
                   ratio=round(ratio, 4), rounds=len(pairs),
                   payload=c["payload"])

    # ----------------------------------------------------- introspection

    def introspect(self) -> dict:
        """Controller state for operators and tests — what is joining,
        draining, quarantined, committed, and under observation."""
        now = self._clock()
        return {
            "armed": True,
            "joining": sorted(self._joining),
            "draining": sorted(self._draining),
            "quarantined": {
                name: round(q["until"] - now, 3)
                for name, q in sorted(self._quarantine.items())
                if now < q["until"]},
            "knobs": dict(self.knobs),
            "canary": (None if self._canary is None else {
                "decision_id": self._canary["id"],
                "mode": self._canary["mode"],
                "payload": dict(self._canary["payload"]),
                "canary": self._canary.get("canary"),
                "pairs": len(self._canary["pairs"]),
            }),
            "decisions": len(self.decisions),
        }
