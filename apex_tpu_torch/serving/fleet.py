"""Fleet router: N engine replicas behind one SLO-aware front door (port
of :mod:`apex_tpu.serving.fleet`).

A single :class:`~apex_tpu_torch.serving.engine.ServingEngine` is a
single point of failure with no overload policy beyond its FIFO, and it
cannot take new weights without going dark.  This module is the
host-side router over a fleet of :mod:`~apex_tpu_torch.serving.replica`
processes, built from the engine's drain, ``introspect()`` and KV
export/import.

**Failover replay.**  A replica SIGKILLed mid-decode is detected by
dead pipe / missed heartbeat (with retry+backoff before the verdict),
marked down, and its in-flight requests are *replayed*: each one is
re-submitted to a surviving replica with ``prompt + tokens emitted so
far`` as the new prompt and the remaining token budget.  Greedy decode
is a deterministic function of the prefix, so the stitched stream is
**bitwise identical** to an uninterrupted one.

**Shed on overload.**  Once fleet-wide queue depth (router backlog +
every live replica's reported queue) crosses ``max_queue_depth``,
``submit`` returns a request in the typed ``REJECTED`` terminal state
and increments ``serving/requests_rejected`` — an observable refusal,
never a silent hang.  Below the bound, admission is SLO-aware: strict
priority classes, and weighted per-tenant fairness (stride scheduling)
within a class.

**Zero-downtime rollout.**  :meth:`FleetRouter.rollout` walks the
fleet one replica at a time: SIGTERM (the ``PreemptionGuard`` drain —
in-flight requests deliver, queued ones come back to the router and
are rescheduled), clean exit, replacement spawned, rejoin on
handshake — under continuous load, with every request reaching a
terminal state.

**Per-request sampling over the wire** (failover replay rebases the
seeded draw counter by the emitted prefix, so a sampled stream is
stitched bitwise like a greedy one), **prefix-cache affinity** (a
placement tie-break read off the ``prefix_cache_hits``/
``kv_occupancy`` heartbeats, never overriding free-blocks/queue-depth
pressure), and the **streaming client API** (:meth:`FleetRouter.stream`,
an iterator over a request's tokens as events arrive).

The router is **torch-free and transport-agnostic**: it drives anything
with the replica client surface (``alive``/``poll``/``submit``/
``begin_drain``/``close`` — the duck type
:mod:`~apex_tpu_torch.serving.transport` documents), which is how every
policy branch is tested with in-memory fakes, and how the framed TCP
:class:`~apex_tpu_torch.serving.transport.SocketTransport` slots in
where ``ReplicaProcess`` did.  Two network-shaped policies ride on top:

**Graceful link degradation.**  A transport whose link RTT
(``link_rtt_s``, measured by ping/pong on the router's monotonic clock)
passes ``link_degraded_rtt_s`` is **demoted** in placement but never
hard-failed (``fleet/link_degraded`` counts the transitions).

**Bounded-deadline shed when unreachable.**  When *no* replica is
dispatchable, pending requests wait at most ``dispatch_deadline_s`` and
are then shed in the typed REJECTED terminal state.

``FleetRouter.introspect()`` duck-types the debug server's engine slot,
so ``DebugServer(engine=router)`` serves live fleet state at
``/statusz``.  Metrics (host-local): ``fleet/requests_submitted`` /
``fleet/requests_finished`` / ``serving/requests_rejected``,
``fleet/replays`` / ``fleet/failovers`` / ``fleet/reschedules`` /
``fleet/rollouts``, ``fleet/reconnects`` / ``fleet/frames_corrupt`` /
``fleet/link_degraded``, the ``fleet/replicas_live`` /
``fleet/queue_depth`` gauges and the router-observed ``fleet/ttft_ms`` /
``fleet/tpot_ms`` histograms.

**Tracing.**  With a flight recorder armed
(:mod:`~apex_tpu_torch.observability.timeline`), ``submit`` mints a
``trace_id`` per request and every dispatch stamps ``{trace_id,
attempt}`` onto the wire, so the router's hop events and every
replica's engine events stitch into ONE per-request trace across
processes (:mod:`~apex_tpu_torch.observability.trace`).  SLO accounting
rides the same registry (``fleet/tenant/<t>/*``, ``fleet/priority/<p>/*``)
and :meth:`FleetRouter.fleet_statusz` serves it merged.  Unarmed, all
of it is a None check.

**Disaggregated prefill/decode.**  A replica's ``ReplicaSpec.role``
rides its ready handshake: initial dispatch prefers prefill-eligible
replicas, and once a request on a ``role="prefill"`` replica has its
first token the router migrates its paged KV to a decode-eligible
replica, one frame per block (``kv_meta`` → N×``kv_block`` →
``kv_export_done`` up from the source; ``import_kv`` → N×``kv_block`` →
``import_commit`` down to the destination).  The source keeps the run
PINNED until the router's ``kv_ack``, and every fault degrades to the
re-prefill/replay path.  ``role="both"`` fleets never migrate.
Counters: ``fleet/kv_migrate_started`` / ``_completed`` / ``_failed`` /
``_blocks`` / ``_bytes`` and the ``fleet/kv_migrate_ms`` histogram.

**Multi-LoRA.**  ``adapter_id`` rides ``SamplingParams``;
:meth:`load_adapter` broadcasts an adapter to every live replica and
pump-waits the acks; :meth:`swap_adapter` hot-swaps it one replica at a
time.  Placement has an adapter-affinity tie-break, and the SLO plane a
per-adapter axis.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import logging
import time
import uuid
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from apex_tpu_torch.observability import timeline
from apex_tpu_torch.serving.sampling import SamplingParams
from apex_tpu_torch.serving.scheduler import RequestState

__all__ = ["FleetRequest", "FleetRouter"]

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class FleetRequest:
    """One request's fleet-level state (the router's source of truth;
    replica-side Request objects are per-attempt and disposable)."""

    rid: int
    prompt: np.ndarray            # int32 [prompt_len] — the ORIGINAL
    max_new_tokens: int
    eos_id: Optional[int] = None
    tenant: str = "default"
    priority: int = 0             # lower = more urgent (class 0 first)
    sampling: Optional[SamplingParams] = None   # None = greedy

    state: RequestState = RequestState.WAITING
    output_tokens: List[int] = dataclasses.field(default_factory=list)
    replica: Optional[str] = None   # current / last assignment
    replays: int = 0                # failover re-submissions
    reschedules: int = 0            # drain-cancel / reject re-routes
    t_submit: float = 0.0
    t_first_token: Optional[float] = None
    t_last_token: Optional[float] = None
    # distributed tracing: the fleet-wide trace id minted at
    # submit when a flight recorder is armed (None otherwise — tracing
    # unarmed is a None check end to end), and how many times dispatch
    # has seated this request (the hop stamp's attempt number: attempt
    # k > 1 means a failover replay / drain reschedule re-dispatch)
    trace_id: Optional[str] = None
    dispatches: int = 0
    # set at migration commit: the next inter-token gap
    # spans the handoff (already accounted in fleet/kv_migrate_ms), so
    # the per-ROLE pool-health TPOT skips it once — tenant-facing TPOT
    # keeps the gap (the stall is real user-visible latency)
    migrated_gap: bool = False
    # bounded SLO accounting keys, resolved ONCE at submit (the token
    # path is the router's hottest loop — it must not re-derive them
    # per token): (tenant_key, priority_key, adapter_key-or-None),
    # "(other)" past the cap.  The adapter key comes off
    # ``sampling.adapter_id``; None — the bare-engine majority — costs
    # nothing on the token path (every adapter site is a None check).
    slo_keys: tuple = ("default", "0", None)

    @property
    def done(self) -> bool:
        return self.state in (RequestState.FINISHED, RequestState.CANCELLED,
                              RequestState.REJECTED)

    @property
    def remaining(self) -> int:
        return self.max_new_tokens - len(self.output_tokens)


class _ReplicaView:
    """Router-side bookkeeping for one replica client."""

    def __init__(self, client, now: float):
        self.client = client
        # a client whose handshake was already consumed out-of-band
        # (ReplicaProcess.wait_ready before router construction) is
        # ready on arrival; otherwise the ("ready", meta) event flips it
        self.meta: Optional[dict] = getattr(client, "meta", None)
        self.ready = self.meta is not None
        self.state: Optional[dict] = None   # last introspect snapshot
        self.last_event_t = now             # any event counts as a beat
        self.down = False
        self.down_reason: Optional[str] = None
        self.draining = False
        self.drained = False
        self.rolling = False                # excluded from dispatch
        self.probes = 0                     # missed-heartbeat probes so far
        self.next_probe_t: Optional[float] = None
        self.assigned: Dict[int, FleetRequest] = {}
        # transport link state: last-synced client counters
        # and the degradation verdict placement demotes on
        self.tx_reconnects = 0
        self.tx_frames_corrupt = 0
        self.link_rtt_s: Optional[float] = None
        self.link_degraded = False
        # mp-relay batching mirror
        self.tx_relay_batches = 0
        self.tx_relay_events = 0

    @property
    def name(self) -> str:
        return self.client.name

    @property
    def role(self) -> str:
        """Fleet role from the ready handshake; a transport
        that does not say (older daemons, hermetic fakes) reads as
        ``"both"`` — the never-migrates default."""
        return (self.meta or {}).get("role") or "both"

    def dispatchable(self) -> bool:
        return (self.ready and not self.down and not self.draining
                and not self.rolling and self.client.alive())

    def in_flight(self) -> int:
        """Replica-side load: everything queued or decoding there.  The
        replica's own snapshot (queue + active slots) and the router's
        ``assigned`` map are two views of the same population offset by
        transport lag — take their max, never their sum (summing
        double-counts every request between dispatch and the next state
        heartbeat, which halves the effective limits and over-sheds)."""
        reported = 0
        if self.state is not None:
            reported = (int(self.state.get("queue_depth", 0))
                        + int(self.state.get("active_slots", 0)))
        return max(reported, len(self.assigned))

    def backlog(self) -> int:
        """Replica-side *waiting* load only — what the shed bound sums.
        A full-but-flowing fleet (every slot decoding, nothing queued)
        has zero backlog and must not shed; :meth:`in_flight` is the
        placement ceiling, this is the overload signal.  Same max-not-
        sum rule: dispatched-but-unreported requests (no first token
        yet) are the router's view of the same queue the replica
        reports."""
        reported = 0
        if self.state is not None:
            reported = int(self.state.get("queue_depth", 0))
        local = sum(1 for r in self.assigned.values()
                    if r.t_first_token is None)
        return max(reported, local)


class FleetRouter:
    """Admit, place, replay, and roll requests across engine replicas.

    ``replicas``: clients with the replica surface (see module
    docstring).  ``max_queue_depth``: the fleet-wide shed bound.
    ``replica_queue_limit``: per-replica dispatch ceiling (backlog past
    it stays in the router, where it can still be re-routed).
    ``heartbeat_timeout_s`` / ``probe_retries`` / ``probe_backoff_s``:
    failure detection — a silent replica is probed ``probe_retries``
    times, ``probe_backoff_s`` apart, before the down verdict (a dead
    pipe / dead process short-circuits the probes).  ``clock`` is
    injectable so the detection ladder is deterministic under test.

    Drive with :meth:`pump` (one poll+detect+dispatch iteration) from
    whatever loop owns the host thread; nothing here blocks.
    """

    def __init__(self, replicas: Sequence, *, max_queue_depth: int = 64,
                 replica_queue_limit: int = 4,
                 heartbeat_timeout_s: float = 10.0,
                 probe_retries: int = 3, probe_backoff_s: float = 0.2,
                 max_attempts: int = 8, keep_done: int = 4096,
                 affinity_occupancy_cap: float = 0.95,
                 link_degraded_rtt_s: float = 1.0,
                 dispatch_deadline_s: float = 120.0,
                 slo_key_cap: int = 64,
                 migrate_min_remaining: int = 2,
                 migrate_max_inflight: int = 16,
                 trend_window_s: float = 1.0, trend_windows: int = 8,
                 history_every_s: float = 0.0,
                 history_max_series: int = 512,
                 slo_policies=None,
                 registry=None, clock: Callable[[], float] = time.monotonic):
        from apex_tpu_torch.observability.metrics import default_registry

        self._clock = clock
        self.max_queue_depth = max_queue_depth
        self.replica_queue_limit = replica_queue_limit
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.probe_retries = probe_retries
        self.probe_backoff_s = probe_backoff_s
        # link RTT past this demotes the replica in placement (never a
        # hard failure); transports that report no RTT are exempt
        self.link_degraded_rtt_s = link_degraded_rtt_s
        # the all-replicas-unreachable bound: pending requests wait at
        # most this long with zero dispatchable replicas before the
        # typed REJECTED shed (a partitioned fleet refuses observably)
        self.dispatch_deadline_s = dispatch_deadline_s
        self._no_dispatch_since: Optional[float] = None
        # a request the fleet keeps bouncing (replica-level rejects,
        # drain cancels, failover replays) is parked REJECTED after
        # this many re-routes — a poison request (e.g. one no replica's
        # pool shape can serve) must reach a terminal state, not
        # ping-pong forever
        self.max_attempts = max_attempts
        self.keep_done = keep_done
        self.registry = registry if registry is not None else \
            default_registry()
        now = clock()
        self._views: Dict[str, _ReplicaView] = {}
        for client in replicas:
            if client.name in self._views:
                # a silent overwrite would leak the first client's
                # process (never polled, never closed): validate, don't
                # collapse
                raise ValueError(
                    f"duplicate replica name {client.name!r}")
            self._views[client.name] = _ReplicaView(client, now)
        self._ids = itertools.count()
        self.requests: Dict[int, FleetRequest] = {}
        # terminal rids in completion order; beyond keep_done the oldest
        # are evicted from `requests` (callers keep their FleetRequest
        # handles — eviction only bounds the router's own maps, so a
        # weeks-long router does not grow per-request state forever)
        self._done_ring: collections.deque = collections.deque()
        # pending[(priority, tenant)] -> deque of WAITING requests;
        # replays go to the LEFT (they already waited their turn)
        self._pending: Dict[tuple, collections.deque] = {}
        self._tenant_pass: Dict[str, float] = {}
        self._tenant_weight: Dict[str, float] = {}
        # prefix-cache affinity: tenant -> the replica that last served
        # it (whose PrefixCache plausibly holds the tenant's template
        # blocks); a placement tie-break, gated on the replica's
        # heartbeat-reported kv_occupancy staying under the cap.
        # LRU-bounded (insertion order + refresh-on-write): tenants are
        # caller-supplied strings, and an unbounded map would grow
        # forever under unique-tenant-per-request traffic — losing an
        # affinity hint costs one cold prefill, never correctness
        self.affinity_occupancy_cap = affinity_occupancy_cap
        self._tenant_affinity: Dict[str, str] = {}
        self._tenant_affinity_cap = 4096
        # SLO accounting: the tenant / priority-class keys
        # ever seen, so /fleet/statusz can enumerate its per-key
        # windowed histograms and counters without walking the
        # registry.  Tenants are caller-supplied strings, so the key
        # space is CAPPED: past slo_key_cap distinct keys, new arrivals
        # account under the "(other)" overflow bucket — a client
        # stamping a unique tenant per request must not grow router
        # memory (3 windowed histograms + counters per key) or scrape
        # size without bound.
        self.slo_key_cap = slo_key_cap
        self._slo_tenants: set = set()
        self._slo_priorities: set = set()
        # per-adapter SLO keys: same bounded-cap discipline —
        # adapter ids are caller-supplied strings too
        self._slo_adapters: set = set()
        # adapter broadcast acks: (replica_name, adapter_id) ->
        # (ok, info), filled by the adapter_loaded/_unloaded events the
        # load_adapter/swap_adapter pump-waits consume
        self._adapter_acks: Dict[tuple, tuple] = {}
        # KV migration: rid -> handoff record.  A request on
        # a role="prefill" replica becomes a migration candidate once
        # it has a first token AND at least migrate_min_remaining
        # budget left (a stream about to finish is cheaper to let
        # finish in place than to ship).  migrate_max_inflight bounds
        # concurrent handoffs so a prefill flood cannot turn the
        # router into an unbounded block relay.
        # record: {"src", "dst", "phase": "export"|"transfer"|"commit"
        #          |"aborted", "meta", "n_sent", "t_start"}
        self.migrate_min_remaining = int(migrate_min_remaining)
        self.migrate_max_inflight = int(migrate_max_inflight)
        self._migrations: Dict[int, dict] = {}
        # controller-readable p99-trend: every
        # trend_window_s (on the injected clock) the pump snapshots the
        # fleet TTFT/TPOT p99 into a bounded window; the least-squares
        # slope over the last trend_windows snapshots is the "is the
        # tail getting worse" signal — first-class on introspect() /
        # fleet_statusz so the autopilot and external probes read the
        # SAME number instead of each diffing histogram scrapes.
        self.trend_window_s = float(trend_window_s)
        self.trend_windows = int(trend_windows)
        self._trend: Dict[str, collections.deque] = {
            "ttft_ms": collections.deque(maxlen=self.trend_windows),
            "tpot_ms": collections.deque(maxlen=self.trend_windows)}
        self._trend_last_t = now
        # per-replica SLO windows exist only while a FleetAutopilot is
        # attached (it flips this on) — the canary judge needs paired
        # per-replica p99s, but a disarmed fleet must observe NOTHING
        # extra
        self.per_replica_slo = False
        # live-retune broadcast acks: the adapter-ack
        # discipline applied to set_knobs — (replica_name, token) ->
        # (ok, info), filled by knobs_set events, consumed by the
        # set_knobs pump-wait; tokens come from a deterministic counter
        # so knob rounds are reproducible under injected clocks
        self._knob_acks: Dict[tuple, tuple] = {}
        self._knob_tokens = itertools.count(1)
        # longitudinal history + SLO burn-rate plane: armed
        # by history_every_s > 0, the pump snapshots the registry into
        # a fixed-memory MetricHistory on that cadence, merges the
        # compacted deltas replicas ship on their state heartbeats, and
        # (when policies are given) evaluates multi-window burn rates
        # into slo_burn_alert/slo_burn_clear timeline events.  DISARMED
        # (the default) every touch point below is a single None check.
        self.history_every_s = float(history_every_s)
        if self.history_every_s > 0:
            from apex_tpu_torch.observability.slo import SLOEvaluator
            from apex_tpu_torch.observability.timeseries import MetricHistory

            self.history = MetricHistory(
                self.registry, clock=clock,
                max_series=history_max_series,
                on_overflow=lambda: self.registry.counter(
                    "fleet/series_overflow").inc())
            self.slo = SLOEvaluator(self.history, slo_policies or (),
                                    clock=clock) \
                if slo_policies else None
            self._history_last_t: Optional[float] = None
        else:
            if slo_policies:
                raise ValueError(
                    "slo_policies need the history armed: pass "
                    "history_every_s > 0")
            self.history = None
            self.slo = None

    # ----------------------------------------------------------- tenants

    def set_tenant_weight(self, tenant: str, weight: float) -> None:
        """Weighted fairness within a priority class: a tenant with
        weight w gets ~w shares per round of dispatch (stride
        scheduling — the pass/stride virtual clock)."""
        if weight <= 0:
            raise ValueError(f"weight must be > 0, got {weight}")
        self._tenant_weight[tenant] = float(weight)

    def _see_tenant(self, tenant: str) -> None:
        """Pin a tenant's virtual clock at first sight (the current
        minimum): a late arrival starts level with the pack, neither
        owed the whole history nor forever trailing it."""
        if tenant not in self._tenant_pass:
            self._tenant_pass[tenant] = min(
                self._tenant_pass.values(), default=0.0)

    def _charge(self, tenant: str) -> None:
        self._see_tenant(tenant)
        self._tenant_pass[tenant] += \
            1.0 / self._tenant_weight.get(tenant, 1.0)

    # ------------------------------------------------------------ submit

    def total_queue_depth(self) -> int:
        """Fleet-wide backlog: router pending + every non-down
        replica's *waiting* queue.  Deliberately excludes requests
        already decoding — a fully-utilized fleet with empty queues is
        healthy, not overloaded, and must not shed."""
        depth = sum(len(q) for q in self._pending.values())
        for view in self._views.values():
            if not view.down:
                depth += view.backlog()
        return depth

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               eos_id: Optional[int] = None, *, tenant: str = "default",
               priority: int = 0,
               sampling: Optional[SamplingParams] = None) -> FleetRequest:
        """Admit or shed.  Above ``max_queue_depth`` the request comes
        back REJECTED — a typed terminal state the caller can observe
        and retry against, never a silent hang — and
        ``serving/requests_rejected`` counts it.

        ``sampling`` rides the replica wire per request (the engine's
        sampling API, fleet-routed).  Failover replay stays stream-exact:
        the engine keys draw i at ``seed, step_offset + i``, and every
        dispatch rebases ``step_offset`` by the emitted prefix it
        re-prefills — a survivor continues the SAME stochastic stream
        the dead replica was emitting."""
        req = FleetRequest(
            rid=next(self._ids),
            prompt=np.asarray(prompt, np.int32),
            max_new_tokens=int(max_new_tokens), eos_id=eos_id,
            tenant=tenant, priority=int(priority), sampling=sampling,
            t_submit=time.monotonic())
        self.requests[req.rid] = req
        self._slo_keys(req)
        self.registry.counter("fleet/requests_submitted").inc()
        if timeline.active() is not None:
            # trace context minted HERE (the request's first hop is the
            # router); unarmed routers mint nothing — the free-telemetry
            # None-check discipline applied to tracing
            req.trace_id = uuid.uuid4().hex[:16]
            timeline.emit("fleet_submit", rid=req.rid,
                          trace_id=req.trace_id, tenant=req.tenant,
                          priority=req.priority,
                          prompt_tokens=int(req.prompt.size),
                          max_new_tokens=req.max_new_tokens)
        if self.total_queue_depth() >= self.max_queue_depth:
            self._reject(req)
            return req
        self._enqueue(req)
        return req

    def _slo_hist(self, name: str):
        return self.registry.histogram(name, keep_samples=4096)

    def _slo_key(self, keys: set, key) -> str:
        """Bounded SLO accounting key: a known key passes through, a
        new one registers while the cap holds, and everything past the
        cap lands in the "(other)" overflow bucket (metrics stay
        bounded however many distinct tenants callers invent)."""
        key = str(key)
        if key in keys:
            return key
        if len(keys) >= self.slo_key_cap:
            # the overflow is itself observable: a fleet
            # whose tenant cardinality blew the cap should say so
            self.registry.counter("fleet/series_overflow").inc()
            keys.add("(other)")
            return "(other)"
        keys.add(key)
        return key

    def _slo_keys(self, req: FleetRequest) -> tuple:
        """Resolve (and cache on the request) its bounded accounting
        keys — called once at submit; every later site reads the
        cached triple."""
        aid = getattr(req.sampling, "adapter_id", None) \
            if req.sampling is not None else None
        req.slo_keys = (
            self._slo_key(self._slo_tenants, req.tenant),
            self._slo_key(self._slo_priorities, req.priority),
            (self._slo_key(self._slo_adapters, aid)
             if aid is not None else None))
        return req.slo_keys

    def _reject(self, req: FleetRequest) -> None:
        req.state = RequestState.REJECTED
        self.registry.counter("serving/requests_rejected").inc()
        tkey, pkey, akey = req.slo_keys
        self.registry.counter(f"fleet/tenant/{tkey}/rejected").inc()
        self.registry.counter(f"fleet/priority/{pkey}/rejected").inc()
        if akey is not None:
            self.registry.counter(f"fleet/adapter/{akey}/rejected").inc()
        if req.trace_id is not None:
            timeline.emit("fleet_reject", rid=req.rid,
                          trace_id=req.trace_id)
        self._note_done(req)

    def _note_done(self, req: FleetRequest) -> None:
        """Bound the per-request maps: remember terminal rids in order
        and evict the oldest past ``keep_done`` (the caller's own
        FleetRequest handle stays valid — only the router forgets)."""
        self._done_ring.append(req.rid)
        while len(self._done_ring) > self.keep_done:
            self.requests.pop(self._done_ring.popleft(), None)

    def _enqueue(self, req: FleetRequest, *, front: bool = False) -> None:
        req.state = RequestState.WAITING
        req.replica = None
        self._see_tenant(req.tenant)
        q = self._pending.setdefault((req.priority, req.tenant),
                                     collections.deque())
        if front:
            q.appendleft(req)
        else:
            q.append(req)

    # -------------------------------------------------------------- pump

    def pump(self) -> None:
        """One router iteration: poll events, run failure detection,
        dispatch what fits.  Non-blocking; call it from the serving
        host's loop (the smoke pumps at ~1 kHz)."""
        for view in list(self._views.values()):
            if not view.down:
                self._poll_view(view)
        for view in list(self._views.values()):
            if not view.down:
                self._detect_failure(view)
        self._dispatch()
        self._pump_migrations()
        live = sum(1 for v in self._views.values()
                   if not v.down and v.client.alive())
        self.registry.gauge("fleet/replicas_live").set(live)
        self.registry.gauge("fleet/queue_depth").set(
            self.total_queue_depth())
        self._update_trend()
        if self.history is not None:
            self._pump_history()

    def _pump_history(self) -> None:
        """One history snapshot + SLO evaluation per elapsed cadence
        window (injected clock) — armed fleets only."""
        now = self._clock()
        if self._history_last_t is not None \
                and now - self._history_last_t < self.history_every_s:
            return
        self._history_last_t = now
        self.history.sample(now)
        if self.slo is not None:
            self.slo.evaluate(now)

    def _update_trend(self) -> None:
        """One p99 snapshot per elapsed trend window (injected clock)."""
        now = self._clock()
        if now - self._trend_last_t < self.trend_window_s:
            return
        self._trend_last_t = now
        for metric in ("ttft_ms", "tpot_ms"):
            # read-only peek: never CREATE the histogram (an idle
            # fleet's registry must stay byte-identical to a router
            # without trend windows)
            hist = self.registry._histograms.get(f"fleet/{metric}")
            p99 = hist.percentile(99) if hist is not None else None
            if p99 is not None:
                self._trend[metric].append((now, float(p99)))

    def p99_trend(self, metric: str = "tpot_ms") -> float:
        """Slope of the windowed p99 in ms per second — least-squares
        over the last ``trend_windows`` (t, p99) snapshots; 0.0 until
        two windows exist.  Positive = the tail is getting worse."""
        pts = self._trend.get(metric)
        if pts is None or len(pts) < 2:
            return 0.0
        n = len(pts)
        mt = sum(t for t, _ in pts) / n
        mv = sum(v for _, v in pts) / n
        denom = sum((t - mt) ** 2 for t, _ in pts)
        if denom <= 0.0:
            return 0.0
        return sum((t - mt) * (v - mv) for t, v in pts) / denom

    # ------------------------------------------------------------- events

    def _sync_link(self, view: _ReplicaView) -> None:
        """Mirror the transport's link counters into the registry and
        refresh the degradation verdict.  Duck-typed: transports
        without the attributes (mp queues, hermetic fakes) read as
        healthy links.  Runs even when poll raised — a poll that died
        ON a corrupt frame already counted it client-side."""
        client = view.client
        rec = int(getattr(client, "reconnects", 0) or 0)
        if rec > view.tx_reconnects:
            self.registry.counter("fleet/reconnects").inc(
                rec - view.tx_reconnects)
            view.tx_reconnects = rec
        corrupt = int(getattr(client, "frames_corrupt", 0) or 0)
        if corrupt > view.tx_frames_corrupt:
            self.registry.counter("fleet/frames_corrupt").inc(
                corrupt - view.tx_frames_corrupt)
            view.tx_frames_corrupt = corrupt
        # batched mp-relay mirror: how many events
        # crossed in batches vs one-per-put — the in-proc leg of the
        # wire_vs_inproc story, now visible
        batches = int(getattr(client, "relay_batches", 0) or 0)
        if batches > view.tx_relay_batches:
            self.registry.counter("fleet/relay_batch").inc(
                batches - view.tx_relay_batches)
            view.tx_relay_batches = batches
        revents = int(getattr(client, "relay_batched_events", 0) or 0)
        if revents > view.tx_relay_events:
            self.registry.counter("fleet/relay_batch_events").inc(
                revents - view.tx_relay_events)
            view.tx_relay_events = revents
        # link RTT: every round trip becomes a sample in the per-replica
        # windowed histogram, and each sample's clock-offset estimate is spilled as
        # a link_clock event for cross-host trace stitching
        take = getattr(client, "take_rtt_samples", None)
        if take is not None:
            for rtt_s, offset_s, remote_mono in take():
                self._slo_hist(
                    f"fleet/link_rtt_ms/{view.name}").observe(
                        rtt_s * 1e3)
                timeline.emit("link_clock", replica=view.name,
                              rtt_s=round(rtt_s, 6),
                              offset_s=round(offset_s, 6),
                              remote_mono=round(remote_mono, 6))
        rtt = getattr(client, "link_rtt_s", None)
        view.link_rtt_s = rtt
        degraded = rtt is not None and rtt > self.link_degraded_rtt_s
        if degraded and not view.link_degraded:
            self.registry.counter("fleet/link_degraded").inc()
            logger.warning(
                "fleet: replica %s link degraded (rtt %.3fs > %.3fs); "
                "demoting in placement", view.name, rtt,
                self.link_degraded_rtt_s)
        view.link_degraded = degraded

    def _poll_view(self, view: _ReplicaView) -> None:
        try:
            events = view.client.poll()
        except Exception as e:  # dead pipe mid-read
            self._sync_link(view)
            logger.warning("fleet: replica %s poll failed: %r",
                           view.name, e)
            self._mark_down(view, f"dead pipe: {e!r}")
            return
        self._sync_link(view)
        if events:
            view.last_event_t = self._clock()
            view.probes = 0
            view.next_probe_t = None
        for ev in events:
            self._handle_event(view, ev)

    def _handle_event(self, view: _ReplicaView, ev: tuple) -> None:
        kind = ev[0]
        if kind == "ready":
            view.ready = True
            view.meta = ev[1]
        elif kind == "state":
            # a history-armed replica attaches its compacted
            # delta to the ordinary heartbeat — popped here so the raw
            # buckets never sit in view.state, merged only when this
            # router keeps a history of its own (prefixed per replica,
            # bucket stamps rebased onto the router clock at ingest)
            delta = ev[1].pop("history", None)
            view.state = ev[1]
            view.draining = bool(ev[1].get("draining"))
            if delta and self.history is not None:
                self.history.ingest_delta(
                    delta, prefix=f"replica/{view.name}/")
        elif kind == "token":
            _, frid, token = ev
            req = self.requests.get(frid)
            if req is None or req.done:
                return
            now = time.monotonic()
            tkey, pkey, akey = req.slo_keys
            if req.t_first_token is None:
                req.t_first_token = now
                ttft_ms = (now - req.t_submit) * 1e3
                self.registry.histogram(
                    "fleet/ttft_ms", keep_samples=4096).observe(ttft_ms)
                # per-tenant / per-priority SLO windows: the
                # same router-observed latency, keyed so /fleet/statusz
                # can answer "whose p99 blew up" instead of "the fleet's"
                self._slo_hist(
                    f"fleet/tenant/{tkey}/ttft_ms").observe(ttft_ms)
                self._slo_hist(
                    f"fleet/priority/{pkey}/ttft_ms").observe(ttft_ms)
                # per-role SLO split: the same latency keyed
                # by the EMITTING replica's role, so /fleet/statusz can
                # answer "is the decode pool's p99 clean" directly
                self._slo_hist(
                    f"fleet/role/{view.role}/ttft_ms").observe(ttft_ms)
                if akey is not None:
                    # per-adapter SLO window: whose tenant-
                    # model's p99 blew up, not just whose tenant's
                    self._slo_hist(
                        f"fleet/adapter/{akey}/ttft_ms").observe(ttft_ms)
            else:
                tpot_ms = (now - req.t_last_token) * 1e3
                self.registry.histogram(
                    "fleet/tpot_ms", keep_samples=65536).observe(tpot_ms)
                self._slo_hist(
                    f"fleet/tenant/{tkey}/tpot_ms").observe(tpot_ms)
                self._slo_hist(
                    f"fleet/priority/{pkey}/tpot_ms").observe(tpot_ms)
                if akey is not None:
                    self._slo_hist(
                        f"fleet/adapter/{akey}/tpot_ms").observe(tpot_ms)
                if req.migrated_gap:
                    # the gap spanning the handoff is kv_migrate cost,
                    # not the decode pool's steady-state TPOT
                    req.migrated_gap = False
                else:
                    self._slo_hist(
                        f"fleet/role/{view.role}/tpot_ms").observe(
                        tpot_ms)
                if self.per_replica_slo:
                    # canary judging: per-replica TPOT
                    # windows exist only while an autopilot is attached
                    self._slo_hist(
                        f"fleet/replica/{view.name}/tpot_ms").observe(
                        tpot_ms)
            req.t_last_token = now
            req.output_tokens.append(int(token))
        elif kind == "finished":
            req = self.requests.get(ev[1])
            if req is not None and not req.done:
                self._finish(req, view)
        elif kind in ("cancelled", "rejected"):
            # cancelled: drained out of the replica's queue (rollout /
            # preemption); rejected: refused at the replica door (drain
            # window race, or a pool-shape mismatch).  Either way a
            # fleet-level request is NOT lost — it goes back in the
            # pool for another replica, until the attempt cap parks it
            req = self.requests.get(ev[1])
            view.assigned.pop(ev[1], None)
            if req is not None and not req.done:
                req.reschedules += 1
                self.registry.counter("fleet/reschedules").inc()
                self._requeue_or_park(
                    req, f"replica {view.name} {kind}",
                    replica=view.name)
        elif kind == "drained":
            view.drained = True
            view.draining = True
        elif kind in ("adapter_loaded", "adapter_unloaded"):
            # broadcast/hot-swap verdict: recorded for the
            # load_adapter/swap_adapter pump-waits; failures are loud
            # (a replica that cannot host the adapter would REJECT every
            # request routed there naming it)
            _, aid, ok, info = ev
            self._adapter_acks[(view.name, aid)] = (bool(ok), info)
            if kind == "adapter_loaded":
                self.registry.counter("fleet/adapter_loads").inc()
            if not ok:
                logger.warning("fleet: replica %s %s %r failed: %r",
                               view.name, kind, aid, info)
        elif kind == "knobs_set":
            # live-retune verdict: recorded for the
            # set_knobs pump-wait (the adapter-ack discipline); a
            # refused payload is loud — the autopilot's canary treats
            # a failed ack as a failed action, never a silent no-op
            _, token, ok, info = ev
            self._knob_acks[(view.name, token)] = (bool(ok), info)
            if not ok:
                logger.warning("fleet: replica %s set_knobs failed: %r",
                               view.name, info)
        elif kind in ("kv_meta", "kv_block", "kv_export_done",
                      "kv_export_failed", "kv_imported"):
            self._handle_migration_event(view, ev)
        elif kind == "error":
            logger.warning("fleet: replica %s relayed error: %r",
                           view.name, ev[1])
            self._mark_down(view, f"relayed error: {ev[1]!r}")

    def _finish(self, req: FleetRequest, view: Optional[_ReplicaView],
                ) -> None:
        req.state = RequestState.FINISHED
        if view is not None:
            view.assigned.pop(req.rid, None)
        self.registry.counter("fleet/requests_finished").inc()
        tkey, pkey, akey = req.slo_keys
        self.registry.counter(f"fleet/tenant/{tkey}/finished").inc()
        self.registry.counter(f"fleet/priority/{pkey}/finished").inc()
        if akey is not None:
            self.registry.counter(f"fleet/adapter/{akey}/finished").inc()
        if req.trace_id is not None:
            timeline.emit("fleet_finish", rid=req.rid,
                          trace_id=req.trace_id,
                          tokens=len(req.output_tokens))
        self._note_done(req)

    def _requeue_or_park(self, req: FleetRequest, why: str, *,
                         replica: Optional[str] = None) -> None:
        """Put a bounced request back in the pool — unless it has burnt
        ``max_attempts`` re-routes, in which case it is parked in the
        typed REJECTED terminal state (a poison request every replica
        refuses must converge, not livelock the dispatch loop)."""
        if req.replays + req.reschedules >= self.max_attempts:
            logger.warning(
                "fleet: request %d exhausted %d attempts (%s); parking "
                "it REJECTED", req.rid, self.max_attempts, why)
            self._reject(req)
            return
        if req.trace_id is not None:
            # the trace walk's failover_replay boundary: from the dead
            # replica's last flushed event up to the NEXT fleet_dispatch
            # is replay cost, not decode (observability/trace.py)
            timeline.emit("fleet_replay", rid=req.rid,
                          trace_id=req.trace_id, replica=replica,
                          reason=why)
        self._enqueue(req, front=True)

    # ------------------------------------------------- failure detection

    def _detect_failure(self, view: _ReplicaView) -> None:
        if not view.client.alive():
            # dead process: consume any events that flushed before
            # death (tokens generated pre-kill are real), then verdict
            self._poll_view(view)
            if view.down:
                return
            if view.drained and not view.assigned:
                # clean rollout exit, not a failure: retire quietly
                self._mark_down(view, "drained and exited", clean=True)
            else:
                self._mark_down(view, "process died")
            return
        if not view.ready:
            return  # startup (engine build) is wait_ready's business
        silent_for = self._clock() - view.last_event_t
        if silent_for <= self.heartbeat_timeout_s:
            return
        # missed heartbeat: probe with backoff before the down verdict
        # (a GC pause or one slow decode step must not trigger a replay
        # storm — the retry ladder is the difference between failover
        # and flapping)
        now = self._clock()
        if view.next_probe_t is None:
            view.next_probe_t = now + self.probe_backoff_s
            return
        if now < view.next_probe_t:
            return
        view.probes += 1
        view.next_probe_t = now + self.probe_backoff_s
        logger.warning(
            "fleet: replica %s silent for %.2fs (probe %d/%d)",
            view.name, silent_for, view.probes, self.probe_retries)
        if view.probes >= self.probe_retries:
            self._mark_down(
                view, f"missed heartbeat for {silent_for:.2f}s "
                f"after {view.probes} probes")

    def _mark_down(self, view: _ReplicaView, reason: str,
                   *, clean: bool = False) -> None:
        view.down = True
        view.down_reason = reason
        if not clean:
            logger.warning("fleet: replica %s DOWN (%s); replaying %d "
                           "in-flight request(s)", view.name, reason,
                           len(view.assigned))
            self.registry.counter("fleet/failovers").inc()
        self._abort_migrations_for(view)
        self._replay(view)

    def _replay(self, view: _ReplicaView) -> None:
        """Failover replay: every request the dead replica held goes
        back in the pool with its emitted prefix intact; dispatch
        re-submits ``prompt + prefix`` with the remaining budget."""
        # reverse rid order + appendleft == oldest request ends up at
        # the very front: replays keep their original relative order
        for frid, req in sorted(view.assigned.items(), reverse=True):
            if req.done:
                continue
            if self._stream_complete(req):
                self._finish(req, None)
                continue
            req.replays += 1
            self.registry.counter("fleet/replays").inc()
            self.registry.counter(
                f"fleet/tenant/{req.slo_keys[0]}/replays").inc()
            self._requeue_or_park(req, f"replica {view.name} down",
                                  replica=view.name)
        view.assigned.clear()

    def _context_limits(self) -> tuple:
        """Smallest ``(max_seq, prefill_len)`` any known replica
        advertised in its ready handshake — ``(None, None)`` when the
        transport does not say (hermetic fakes need not)."""
        max_seq = prefill = None
        for v in self._views.values():
            m = v.meta or {}
            if m.get("max_seq") is not None:
                max_seq = (m["max_seq"] if max_seq is None
                           else min(max_seq, m["max_seq"]))
            if m.get("prefill_len") is not None:
                prefill = (m["prefill_len"] if prefill is None
                           else min(prefill, m["prefill_len"]))
        return max_seq, prefill

    def _stream_complete(self, req: FleetRequest) -> bool:
        """True when the stream needs no more decoding and only the
        ``finished`` event was lost to the kill: budget exhausted, eos
        emitted, or the engine's third finish condition — the context
        cap.  A stream at ``max_seq`` was FINISHED by the engine
        ("truncation is a response"); and a replay prefix that no
        longer fits a packed prefill row on any replica cannot be
        continued anywhere — deliver the truncated stream instead of
        bouncing the request into REJECTED."""
        if req.remaining <= 0:
            return True
        if (req.eos_id is not None and req.output_tokens
                and req.output_tokens[-1] == req.eos_id):
            return True
        max_seq, prefill = self._context_limits()
        wire = len(req.prompt) + len(req.output_tokens)
        if max_seq is not None and wire >= max_seq:
            return True
        if prefill is not None and wire > prefill:
            return True
        return False

    # ----------------------------------------------------------- dispatch

    def _pick_tenant(self, priority: int) -> Optional[tuple]:
        keys = [k for k, q in self._pending.items()
                if k[0] == priority and q]
        if not keys:
            return None
        return min(keys, key=lambda k: (
            self._tenant_pass.get(k[1], 0.0), k[1]))

    def _pick_replica(self, tenant: Optional[str] = None,
                      adapter_id: Optional[str] = None
                      ) -> Optional[_ReplicaView]:
        candidates = [v for v in self._views.values()
                      if v.dispatchable()
                      and v.in_flight() < self.replica_queue_limit]
        if not candidates:
            return None
        # Role axis: initial dispatch is the admission +
        # chunked-prefill phase, so prefill-eligible replicas
        # ("prefill"/"both") win it; decode specialists take requests
        # through KV migration instead.  Graceful degradation over
        # starvation: when every candidate is a decode specialist, use
        # them anyway — a "decode" replica is a full engine and
        # prefills correctly, just not at its best placement.
        prefill_ok = [v for v in candidates if v.role != "decode"]
        if prefill_ok:
            candidates = prefill_ok
        # Prefix-cache affinity: the replica that
        # last served this tenant plausibly still holds the tenant's
        # template blocks in its PrefixCache, so landing there turns
        # the prefill into block shares (`serving/prefix_cache_hits`
        # climbing on the state heartbeats is the visible effect).
        # Strictly a TIE-BREAK: free blocks and queue depth dominate,
        # and a replica whose reported kv_occupancy is past the cap is
        # under pool pressure — affinity yields rather than force
        # evictions of hotter blocks.
        warm = self._tenant_affinity.get(tenant)

        def score(v: _ReplicaView):
            state = v.state or {}
            free = int(state.get("free_blocks", 0))
            occ = float(state.get("kv_occupancy") or 0.0)
            affine = (v.name == warm
                      and occ < self.affinity_occupancy_cap)
            # Adapter affinity: a replica whose heartbeat
            # says the request's adapter is already RESIDENT wins ties
            # — landing there costs zero adapter loads/evictions, while
            # a cold replica would churn its arena.  Same discipline as
            # prefix affinity: a tie-break only (free blocks and queue
            # depth dominate), standing down past the same occupancy
            # cap so affinity never forces an overloaded pool.
            resident = (state.get("adapters_resident") or ())
            adapter_affine = (adapter_id is not None
                              and adapter_id in resident
                              and occ < self.affinity_occupancy_cap)
            # link degradation leads the key: a slow link is
            # DEMOTED — any healthy-link candidate wins regardless of
            # pool shape — but never excluded, so a fleet whose every
            # link degraded still serves instead of starving
            return (1 if v.link_degraded else 0, -free,
                    len(v.assigned), 0 if affine else 1,
                    0 if adapter_affine else 1, v.name)

        return min(candidates, key=score)

    def _dispatch(self) -> None:
        # Selection stays per-request (priority, stride fairness and
        # placement all update as each request is seated), but the
        # transport writes are BATCHED: everything routed to one
        # replica this pump goes out as a single ``submit_many``
        # command when the client supports it — at fleet arrival rates
        # the per-command queue/pickle overhead was the router's
        # dominant cost (ROADMAP fleet follow-on).
        batches: Dict[str, tuple] = {}   # name -> (view, [items])
        while True:
            priorities = sorted({k[0] for k, q in self._pending.items()
                                 if q})
            if not priorities:
                break
            key = self._pick_tenant(priorities[0])
            if key is None:
                break
            # peek the queue head's adapter so placement can
            # prefer a replica already holding it resident — the head
            # is exactly the request popped below
            head = self._pending[key][0]
            head_aid = getattr(head.sampling, "adapter_id", None) \
                if head.sampling is not None else None
            view = self._pick_replica(key[1], head_aid)
            if view is None:
                break  # no capacity anywhere: stays in the router pool
            req = self._pending[key].popleft()
            if req.done:
                continue
            self._charge(req.tenant)
            # replay prefix: the engine prefills prompt+emitted tokens
            # through the ordinary chunked-prefill admission path —
            # recovery needs no special-case decode state
            wire_prompt = list(map(int, req.prompt)) + req.output_tokens
            # the replayed prefix consumed draw counters 0..len(emitted)
            # on the dead replica; rebase the survivor's counter so the
            # sampled stream CONTINUES instead of restarting
            sampling = req.sampling
            if sampling is not None and req.output_tokens:
                sampling = dataclasses.replace(
                    sampling, step_offset=sampling.step_offset
                    + len(req.output_tokens))
            req.state = RequestState.RUNNING
            req.replica = view.name
            req.dispatches += 1
            view.assigned[req.rid] = req
            self._tenant_affinity.pop(req.tenant, None)   # refresh LRU
            self._tenant_affinity[req.tenant] = view.name
            if len(self._tenant_affinity) > self._tenant_affinity_cap:
                self._tenant_affinity.pop(
                    next(iter(self._tenant_affinity)))
            if req.dispatches == 1 and req.t_first_token is None:
                # router-side queue wait, observed once per request
                wait_ms = (time.monotonic() - req.t_submit) * 1e3
                tkey, pkey = req.slo_keys[:2]
                self._slo_hist(
                    f"fleet/tenant/{tkey}/queue_wait_ms").observe(
                        wait_ms)
                self._slo_hist(
                    f"fleet/priority/{pkey}/queue_wait_ms").observe(
                        wait_ms)
            trace = None
            if req.trace_id is not None:
                # the hop stamp: replica + attempt ride the wire so the
                # replica-side events of a re-dispatched request are
                # distinguishable from its first incarnation's
                trace = {"trace_id": req.trace_id,
                         "attempt": req.dispatches}
                timeline.emit("fleet_dispatch", rid=req.rid,
                              trace_id=req.trace_id,
                              attempt=req.dispatches,
                              replica=view.name,
                              prior_tokens=len(req.output_tokens))
            batches.setdefault(view.name, (view, []))[1].append(
                (req.rid, wire_prompt, req.remaining, req.eos_id,
                 sampling, trace))
        for view, items in batches.values():
            try:
                if len(items) > 1 and hasattr(view.client, "submit_many"):
                    view.client.submit_many(items)
                    self.registry.counter("fleet/batched_submits").inc()
                else:
                    for item in items:
                        view.client.submit(*item)
            except Exception as e:  # dead pipe on write
                logger.warning("fleet: submit to %s failed: %r",
                               view.name, e)
                self._mark_down(view, f"dead pipe on submit: {e!r}")
        self._shed_if_unreachable()

    def _shed_if_unreachable(self) -> None:
        """Graceful degradation when the whole fleet is out of reach
        (every replica down/draining/rolling — the full-partition
        shape): pending requests wait a bounded ``dispatch_deadline_s``
        from the moment the last replica became undispatchable, then
        shed in the typed REJECTED terminal state.  Any replica coming
        back (probe reset, rollout rejoin) resets the window."""
        pending = sum(len(q) for q in self._pending.values())
        if pending == 0 or any(v.dispatchable()
                               for v in self._views.values()):
            self._no_dispatch_since = None
            return
        now = self._clock()
        if self._no_dispatch_since is None:
            self._no_dispatch_since = now
            return
        if now - self._no_dispatch_since <= self.dispatch_deadline_s:
            return
        logger.warning(
            "fleet: no replica dispatchable for %.1fs; shedding %d "
            "pending request(s) REJECTED", now - self._no_dispatch_since,
            pending)
        for q in self._pending.values():
            while q:
                req = q.popleft()
                if not req.done:
                    self._reject(req)
        self._no_dispatch_since = None

    # ------------------------------------------------- KV migration (16)

    def _view_if_up(self, name: Optional[str]) -> Optional[_ReplicaView]:
        view = self._views.get(name) if name is not None else None
        if view is None or view.down or not view.client.alive():
            return None
        return view

    def _pick_migration_dst(self, src: _ReplicaView
                            ) -> Optional[_ReplicaView]:
        """A decode-eligible landing replica: decode specialists first
        (the whole point of the split), ``both`` as fallback, never the
        source, never past the per-replica ceiling."""
        candidates = [v for v in self._views.values()
                      if v is not src and v.dispatchable()
                      and v.role != "prefill"
                      and v.in_flight() < self.replica_queue_limit]
        if not candidates:
            return None

        def score(v: _ReplicaView):
            state = v.state or {}
            return (1 if v.link_degraded else 0,
                    0 if v.role == "decode" else 1,
                    -int(state.get("free_blocks", 0)),
                    len(v.assigned), v.name)

        return min(candidates, key=score)

    def _pump_migrations(self) -> None:
        """The handoff trigger: any first-tokened request sitting on a
        ``role="prefill"`` replica with enough budget left ships its KV
        to a decode replica.  One ``export_kv`` command starts it; the
        rest of the state machine runs on the source's event stream
        (:meth:`_handle_migration_event`)."""
        if len(self._migrations) >= self.migrate_max_inflight:
            return
        for view in list(self._views.values()):
            if view.role != "prefill" or not view.dispatchable():
                continue
            for rid, req in list(view.assigned.items()):
                if len(self._migrations) >= self.migrate_max_inflight:
                    return
                if (rid in self._migrations or req.done
                        or req.t_first_token is None
                        or not req.output_tokens
                        or req.remaining < self.migrate_min_remaining
                        or self._stream_complete(req)):
                    continue
                dst = self._pick_migration_dst(view)
                if dst is None:
                    return      # nowhere to land; keep decoding here
                try:
                    view.client.export_kv(rid)
                except Exception as e:
                    logger.warning(
                        "fleet: export_kv to %s failed: %r",
                        view.name, e)
                    self._mark_down(
                        view, f"dead pipe on export_kv: {e!r}")
                    return
                self._migrations[rid] = {
                    "src": view.name, "dst": dst.name,
                    "phase": "export", "meta": None, "n_sent": 0,
                    "t_start": time.monotonic()}
                self.registry.counter("fleet/kv_migrate_started").inc()
                if req.trace_id is not None:
                    # opens the trace plane's kv_migrate hop; the
                    # dispatch-onto-decode at commit closes it
                    timeline.emit("fleet_migrate_start", rid=rid,
                                  trace_id=req.trace_id,
                                  attempt=req.dispatches,
                                  src=view.name, dst=dst.name,
                                  prior_tokens=len(req.output_tokens))

    def _resolve_migration(self, rid: int, rec: dict, why: str, *,
                           requeue: bool = True) -> None:
        """Common failure epilogue: un-pin the source (``kv_ack`` False
        — the exported run still indexes into its prefix cache, so the
        re-prefill that follows is usually a block-share, not a
        recompute), drop any pending destination import, and put the
        request back in the pool.  The degraded path IS the proven
        replay path — token identity needs no new argument."""
        self._migrations.pop(rid, None)
        self.registry.counter("fleet/kv_migrate_failed").inc()
        src = self._view_if_up(rec["src"])
        dst = self._view_if_up(rec["dst"])
        if dst is not None:
            try:
                dst.client.kv_abort(rid)
            except Exception:       # dying pipe: poll() will verdict it
                pass
        if src is not None:
            try:
                src.client.kv_ack(rid, False)
            except Exception:
                pass
        req = self.requests.get(rid)
        if req is None or req.done:
            return
        if not requeue:
            return                  # still decoding on the source
        for name in (rec["src"], rec["dst"]):
            v = self._views.get(name)
            if v is not None:       # down views too: a later _replay
                v.assigned.pop(rid, None)   # must not double-enqueue
        if self._stream_complete(req):
            self._finish(req, None)
            return
        logger.warning("fleet: KV migration of request %d failed (%s); "
                       "degrading to re-prefill", rid, why)
        self._requeue_or_park(req, f"kv migration failed: {why}",
                              replica=rec["src"])

    def _abort_migrations_for(self, view: _ReplicaView) -> None:
        """A replica going down mid-handoff (either side).  Source
        down: the request is still in its ``assigned`` map, so the
        ordinary :meth:`_replay` that follows covers it — only the
        destination's pending import needs dropping.  Destination
        down: the source's export may still be streaming, so the
        record flips to "aborted" and the source's own
        ``kv_export_done`` resolves it (its events are swallowed in
        between); a handoff already past export resolves immediately."""
        for rid, rec in list(self._migrations.items()):
            if rec["src"] == view.name:
                if rec["phase"] == "commit":
                    # the commit already raced toward the decode
                    # replica — it may be admitted there any moment, so
                    # it must NOT also replay (double execution).  Move
                    # it optimistically; the kv_imported verdict (or
                    # the destination's own death) resolves the handoff
                    req = self.requests.get(rid)
                    dst = self._view_if_up(rec["dst"])
                    view.assigned.pop(rid, None)
                    if req is not None and not req.done \
                            and dst is not None:
                        req.replica = dst.name
                        dst.assigned[rid] = req
                    else:
                        self._resolve_migration(
                            rid, rec, "source died at commit")
                    continue
                self._migrations.pop(rid, None)
                self.registry.counter("fleet/kv_migrate_failed").inc()
                dst = self._view_if_up(rec["dst"])
                if dst is not None:
                    try:
                        dst.client.kv_abort(rid)
                    except Exception:
                        pass
            elif rec["dst"] == view.name:
                if rec["phase"] in ("export", "transfer"):
                    rec["phase"] = "aborted"
                else:
                    self._resolve_migration(
                        rid, rec, f"decode replica {view.name} died")

    def _handle_migration_event(self, view: _ReplicaView,
                                ev: tuple) -> None:
        kind, rid = ev[0], ev[1]
        rec = self._migrations.get(rid)
        if rec is None:
            return      # stale event of an already-resolved handoff
        req = self.requests.get(rid)
        if kind == "kv_export_failed" and view.name == rec["src"]:
            # nothing left the source engine — the request just keeps
            # decoding there; only the destination's pending import
            # (if the meta ever went out) needs dropping
            self._resolve_migration(rid, rec, str(ev[2]), requeue=False)
        elif kind == "kv_meta" and view.name == rec["src"]:
            if rec["phase"] == "aborted":
                return
            rec["meta"] = ev[2]
            rec["phase"] = "transfer"
            if req is None or req.done or \
                    int(ev[2].get("n_out", -1)) != len(req.output_tokens):
                # token stream and export are out of phase — never
                # commit a cache that disagrees with the stream
                self._resolve_migration(
                    rid, rec, "token/export phase mismatch")
                return
            dst = self._view_if_up(rec["dst"])
            if dst is None:
                self._resolve_migration(rid, rec, "destination gone")
                return
            try:
                dst.client.import_kv(rid, ev[2])
            except Exception as e:
                self._resolve_migration(rid, rec, f"import_kv: {e!r}")
        elif kind == "kv_block" and view.name == rec["src"]:
            if rec["phase"] != "transfer":
                return      # aborted mid-stream: swallow the tail
            payload = ev[3]
            rec["n_sent"] += 1
            self.registry.counter("fleet/kv_migrate_blocks").inc()
            self.registry.counter("fleet/kv_migrate_bytes").inc(
                int(sum(getattr(s, "nbytes", 0) for s in payload)))
            dst = self._view_if_up(rec["dst"])
            if dst is None:
                self._resolve_migration(rid, rec, "destination gone")
                return
            try:
                dst.client.kv_block(rid, int(ev[2]), payload)
            except Exception as e:
                self._resolve_migration(rid, rec, f"kv_block: {e!r}")
        elif kind == "kv_export_done" and view.name == rec["src"]:
            if rec["phase"] == "aborted":
                # the destination died while the source streamed; the
                # export is complete source-side, so resolve NOW (the
                # late un-pin path of the refcount story)
                self._resolve_migration(
                    rid, rec, "destination died mid-transfer")
                return
            n = int(ev[2])
            meta = rec["meta"] or {}
            if rec["phase"] != "transfer" or rec["n_sent"] != n or \
                    int(meta.get("n_blocks", -1)) != n:
                self._resolve_migration(rid, rec, "block count mismatch")
                return
            if req is None or req.done or self._stream_complete(req):
                # the stream finished while its KV was in flight —
                # deliver it, don't bounce it through an import that
                # would refuse a zero budget
                self._resolve_migration(rid, rec, "stream complete")
                return
            dst = self._view_if_up(rec["dst"])
            if dst is None:
                self._resolve_migration(rid, rec, "destination gone")
                return
            # the commit is a dispatch onto the decode replica: same
            # wire item as failover replay (full stream as the prompt,
            # remaining budget, step_offset rebased by the emitted
            # prefix) — the imported KV just makes the re-prefill a
            # one-token recompute instead of a full one
            sampling = req.sampling
            if sampling is not None and req.output_tokens:
                sampling = dataclasses.replace(
                    sampling, step_offset=sampling.step_offset
                    + len(req.output_tokens))
            wire_prompt = list(map(int, req.prompt)) + req.output_tokens
            req.dispatches += 1
            trace = None
            if req.trace_id is not None:
                trace = {"trace_id": req.trace_id,
                         "attempt": req.dispatches}
                timeline.emit("fleet_dispatch", rid=rid,
                              trace_id=req.trace_id,
                              attempt=req.dispatches,
                              replica=dst.name, migrated=True,
                              prior_tokens=len(req.output_tokens))
            item = (rid, wire_prompt, req.remaining, req.eos_id,
                    sampling, trace)
            try:
                dst.client.import_commit(rid, item, n)
            except Exception as e:
                self._resolve_migration(rid, rec, f"import_commit: {e!r}")
                return
            rec["phase"] = "commit"
        elif kind == "kv_imported" and view.name == rec["dst"]:
            ok, why = bool(ev[2]), ev[3]
            if not ok or req is None or req.done:
                self._resolve_migration(
                    rid, rec, f"import refused: {why}")
                return
            # handoff complete: the request now lives on the decode
            # replica; the source un-pins into its prefix cache
            self._migrations.pop(rid, None)
            raw_src = self._views.get(rec["src"])
            if raw_src is not None:
                # pop from the raw view even when it is down — a source
                # that died AFTER flushing its export completes the
                # handoff, and a stale assigned entry here would make
                # the death-time _replay double-execute the request
                raw_src.assigned.pop(rid, None)
            src = self._view_if_up(rec["src"])
            if src is not None:
                try:
                    src.client.kv_ack(rid, True)
                except Exception:
                    pass
            req.replica = view.name
            req.migrated_gap = True
            view.assigned[rid] = req
            self.registry.counter("fleet/kv_migrate_completed").inc()
            self._slo_hist("fleet/kv_migrate_ms").observe(
                (time.monotonic() - rec["t_start"]) * 1e3)

    # ------------------------------------------------------------ rollout

    def rollout(self, factory: Callable[[str], object], *,
                names: Optional[Sequence[str]] = None,
                drain_timeout_s: float = 120.0,
                ready_timeout_s: float = 300.0,
                poll_s: float = 0.002,
                on_tick: Optional[Callable[[], None]] = None) -> List[str]:
        """Zero-downtime weight rollout, one replica at a time.

        For each name: SIGTERM-drain (in-flight requests deliver on the
        old weights, queued ones reschedule onto the rest of the
        fleet), wait for the clean exit, spawn ``factory(name)`` (which
        restores the newest VERIFIED checkpoint), wait for its ready
        handshake, rejoin.  The router keeps pumping throughout —
        ``on_tick`` (called every iteration) is where a load generator
        keeps traffic flowing so the smoke can prove the fleet never
        went dark.  Returns the rolled replica names.

        A replica that dies mid-drain is handled by the ordinary
        failover path (its remaining requests replay) and is still
        replaced — a rollout must converge even through a crash.
        """
        rolled = []
        for name in list(names if names is not None else self._views):
            view = self._views[name]
            self.registry.counter("fleet/rollouts").inc()
            view.rolling = True
            view.client.begin_drain()
            # deadlines run on the injected clock (one control-flow
            # clock domain with failure detection — the timeout paths
            # are drivable in deterministic tests)
            deadline = self._clock() + drain_timeout_s
            while not view.down:
                self.pump()
                if on_tick is not None:
                    on_tick()
                if view.drained and not view.client.alive():
                    break
                if self._clock() > deadline:
                    logger.warning(
                        "fleet: %s did not drain in %.0fs; escalating",
                        name, drain_timeout_s)
                    self._mark_down(view, "drain timeout")
                    break
                time.sleep(poll_s)
            # retire the old client (reap the exited process) and seat
            # the replacement under the same name
            try:
                view.client.close()
            except Exception as e:
                logger.warning("fleet: closing old %s failed: %r",
                               name, e)
            if not view.down:
                self._mark_down(view, "rolled out", clean=True)
            new_client = factory(name)
            if new_client.name != name:
                raise ValueError(
                    f"rollout factory returned client named "
                    f"{new_client.name!r} for slot {name!r}")
            new_view = _ReplicaView(new_client, self._clock())
            self._views[name] = new_view
            deadline = self._clock() + ready_timeout_s
            while not new_view.ready:
                self.pump()
                if on_tick is not None:
                    on_tick()
                if not new_client.alive() and not new_view.ready:
                    raise RuntimeError(
                        f"fleet: replacement replica {name} died before "
                        f"ready (exitcode "
                        f"{getattr(new_client, 'exitcode', None)})")
                if self._clock() > deadline:
                    raise RuntimeError(
                        f"fleet: replacement replica {name} not ready "
                        f"in {ready_timeout_s:.0f}s")
                time.sleep(poll_s)
            rolled.append(name)
        return rolled

    # ------------------------------------------------- adapters

    def _await_acks(self, acks: Dict[tuple, tuple],
                    pairs: Sequence[tuple], *,
                    timeout_s: float, poll_s: float = 0.002,
                    on_tick: Optional[Callable[[], None]] = None
                    ) -> Dict[str, tuple]:
        """Pump until every ``(replica_name, key)`` pair has an ack in
        ``acks`` (or the deadline passes); a replica that dies mid-wait
        reads as a failed ack, never a hang.  Shared by the adapter
        broadcasts and the live-retune broadcast."""
        deadline = self._clock() + timeout_s
        while any(p not in acks for p in pairs):
            self.pump()
            if on_tick is not None:
                on_tick()
            if all(self._view_if_up(p[0]) is None or
                   p in acks for p in pairs):
                break
            if self._clock() > deadline:
                break
            time.sleep(poll_s)
        out = {}
        for name, key in pairs:
            out[name] = acks.pop(
                (name, key), (False, "no ack (replica down or timeout)"))
        return out

    def _await_adapter_acks(self, pairs: Sequence[tuple], *,
                            timeout_s: float, poll_s: float = 0.002,
                            on_tick: Optional[Callable[[], None]] = None
                            ) -> Dict[str, tuple]:
        return self._await_acks(self._adapter_acks, pairs,
                                timeout_s=timeout_s, poll_s=poll_s,
                                on_tick=on_tick)

    def load_adapter(self, adapter_id, *, weights=None, seed=None,
                     names: Optional[Sequence[str]] = None,
                     timeout_s: float = 60.0,
                     on_tick: Optional[Callable[[], None]] = None
                     ) -> Dict[str, tuple]:
        """Register (or hot-swap) a LoRA adapter across the fleet: the
        ``load_adapter`` wire command broadcast to every live replica
        (or ``names``), then a pump-wait on the ``adapter_loaded``
        acks.  Returns ``{replica_name: (ok, info)}`` — ``info`` is
        ``{"slot", "evicted"}`` on success, the repr'd refusal
        otherwise.  Failover replay depends on this being a broadcast:
        an adapter-tagged request can only replay onto a survivor that
        has the adapter resident."""
        payload: dict = {}
        if weights is not None:
            payload["weights"] = weights
        if seed is not None:
            payload["seed"] = seed
        results: Dict[str, tuple] = {}
        pairs = []
        for name in list(names if names is not None else self._views):
            view = self._view_if_up(name)
            if view is None:
                results[name] = (False, "replica down")
                continue
            send = getattr(view.client, "load_adapter", None)
            if send is None:
                results[name] = (False, "transport has no load_adapter")
                continue
            try:
                send(adapter_id, payload)
            except Exception as e:    # dead pipe on write
                logger.warning("fleet: load_adapter to %s failed: %r",
                               name, e)
                self._mark_down(view, f"dead pipe on load_adapter: {e!r}")
                results[name] = (False, repr(e))
                continue
            pairs.append((name, adapter_id))
        results.update(self._await_adapter_acks(
            pairs, timeout_s=timeout_s, on_tick=on_tick))
        return results

    def unload_adapter(self, adapter_id, *,
                       names: Optional[Sequence[str]] = None,
                       timeout_s: float = 60.0,
                       on_tick: Optional[Callable[[], None]] = None
                       ) -> Dict[str, tuple]:
        """Drop an adapter's registry reference fleet-wide: new submits
        naming it are REJECTED at every replica door; in-flight pinners
        finish on the weights they started with (slot frees on last
        unpin — the engine's refcount contract)."""
        results: Dict[str, tuple] = {}
        pairs = []
        for name in list(names if names is not None else self._views):
            view = self._view_if_up(name)
            if view is None:
                results[name] = (False, "replica down")
                continue
            send = getattr(view.client, "unload_adapter", None)
            if send is None:
                results[name] = (False,
                                 "transport has no unload_adapter")
                continue
            try:
                send(adapter_id)
            except Exception as e:
                logger.warning("fleet: unload_adapter to %s failed: %r",
                               name, e)
                self._mark_down(view,
                                f"dead pipe on unload_adapter: {e!r}")
                results[name] = (False, repr(e))
                continue
            pairs.append((name, adapter_id))
        results.update(self._await_adapter_acks(
            pairs, timeout_s=timeout_s, on_tick=on_tick))
        return results

    def swap_adapter(self, adapter_id, *, weights=None, seed=None,
                     names: Optional[Sequence[str]] = None,
                     quiesce_timeout_s: float = 120.0,
                     ack_timeout_s: float = 60.0, poll_s: float = 0.002,
                     on_tick: Optional[Callable[[], None]] = None
                     ) -> Dict[str, tuple]:
        """Zero-downtime adapter hot-swap — the rollout discipline
        without the process replacement.  One replica at a time: take
        it out of dispatch (``rolling``, exactly the rollout gate),
        pump until its in-flight requests naming this adapter have
        delivered (a stream must never change weights mid-decode —
        that is the whole difference between a swap and a corruption),
        push the new weights through :meth:`load_adapter` (an in-place
        slot overwrite on the replica: the arena's hot-swap path), await the ack, rejoin.  The rest of the fleet keeps
        serving throughout — under a live request drip the swap
        completes with ZERO failed requests (pinned in
        ``tests/test_fleet.py``).  ``on_tick`` is the load generator's
        hook, same as :meth:`rollout`."""
        results: Dict[str, tuple] = {}
        for name in list(names if names is not None else self._views):
            view = self._view_if_up(name)
            if view is None:
                results[name] = (False, "replica down")
                continue
            self.registry.counter("fleet/adapter_swaps").inc()
            view.rolling = True
            try:
                deadline = self._clock() + quiesce_timeout_s
                while any(
                        not r.done and r.sampling is not None
                        and getattr(r.sampling, "adapter_id", None)
                        == adapter_id
                        for r in list(view.assigned.values())):
                    self.pump()
                    if on_tick is not None:
                        on_tick()
                    if view.down or self._clock() > deadline:
                        break
                    time.sleep(poll_s)
                results[name] = self.load_adapter(
                    adapter_id, weights=weights, seed=seed,
                    names=[name], timeout_s=ack_timeout_s,
                    on_tick=on_tick).get(name, (False, "replica down"))
            finally:
                view.rolling = False
        return results

    # --------------------------------------------- live knobs

    def set_knobs(self, payload: dict, *,
                  names: Optional[Sequence[str]] = None,
                  timeout_s: float = 60.0,
                  on_tick: Optional[Callable[[], None]] = None
                  ) -> Dict[str, tuple]:
        """Live-retune broadcast — the adapter-ack discipline applied
        to serving knobs.  ``payload`` is what
        :meth:`~apex_tpu_torch.serving.engine.ServingEngine.set_knobs`
        accepts (``prefill_chunk`` / ``spec_k``; ``None`` values reset
        to engine defaults).  Each named replica (default: all) gets
        one ``set_knobs`` wire command stamped with a per-call token;
        the router pump-waits the ``knobs_set`` acks.  Returns
        ``{replica_name: (ok, info)}`` — ``info`` is the replica's
        applied knob state on success (the engine echo), the repr'd
        refusal otherwise.  This is the autopilot's retune actuator:
        canary first (``names=[one]``), fleet-wide only after the
        canary verdict."""
        token = next(self._knob_tokens)
        wire = dict(payload)
        wire["token"] = token
        results: Dict[str, tuple] = {}
        pairs = []
        for name in list(names if names is not None else self._views):
            view = self._view_if_up(name)
            if view is None:
                results[name] = (False, "replica down")
                continue
            send = getattr(view.client, "set_knobs", None)
            if send is None:
                results[name] = (False, "transport has no set_knobs")
                continue
            try:
                send(wire)
            except Exception as e:    # dead pipe on write
                logger.warning("fleet: set_knobs to %s failed: %r",
                               name, e)
                self._mark_down(view, f"dead pipe on set_knobs: {e!r}")
                results[name] = (False, repr(e))
                continue
            pairs.append((name, token))
        results.update(self._await_acks(
            self._knob_acks, pairs, timeout_s=timeout_s,
            on_tick=on_tick))
        return results

    # ----------------------------------------- fleet membership

    def add_replica(self, client) -> None:
        """Seat a new replica — the autopilot's scale-up actuator.  The
        client joins through the ordinary ready handshake (``pump``
        flips the view ready on its first event); until then it is not
        dispatchable, so a half-born replica never receives work.  A
        live name collision raises (the rollout path retires the old
        holder first); a DOWN holder is retired in place — respawning
        under the same name is how a dead replica is replaced."""
        old = self._views.get(client.name)
        if old is not None:
            if not old.down:
                raise ValueError(
                    f"replica {client.name!r} is already live")
            try:
                old.client.close()
            except Exception as e:  # noqa: BLE001 — already dead
                logger.warning("fleet: closing retired %s failed: %r",
                               client.name, e)
        self._views[client.name] = _ReplicaView(client, self._clock())

    def remove_replica(self, name: str) -> None:
        """Retire a replica from the routing table (scale-down
        completion, or reaping a half-born join).  A still-live holder
        is marked down first so its in-flight requests replay through
        the ordinary failover path — removal never strands a request.
        Unknown names are a no-op (reap paths race with failure
        detection)."""
        view = self._views.pop(name, None)
        if view is None:
            return
        if not view.down:
            self._mark_down(view, "removed by controller",
                            clean=not view.assigned)
        try:
            view.client.close()
        except Exception as e:  # noqa: BLE001 — already dead
            logger.warning("fleet: closing removed %s failed: %r",
                           name, e)

    # ------------------------------------------------------- introspection

    def introspect(self) -> dict:
        """Live fleet state — duck-types the engine slot of
        :class:`~apex_tpu_torch.observability.debug_server.DebugServer`, so
        ``DebugServer(engine=router)`` serves the fleet at /statusz."""
        replicas = {}
        for name, v in self._views.items():
            rtt_hist = self._slo_hist(f"fleet/link_rtt_ms/{name}")
            replicas[name] = {
                "ready": v.ready, "down": v.down,
                "role": v.role,
                "down_reason": v.down_reason,
                "draining": v.draining, "rolling": v.rolling,
                "assigned": len(v.assigned),
                "in_flight": v.in_flight(),
                # link state: RTT on the router host's
                # monotonic clock — never a cross-host wall compare.
                # p50/p99 answer over the windowed histogram: link *jitter* tails next to the latest
                # point value the degradation verdict reads
                "link_rtt_ms": (round(v.link_rtt_s * 1e3, 3)
                                if v.link_rtt_s is not None else None),
                "link_rtt_p50_ms": rtt_hist.percentile(50),
                "link_rtt_p99_ms": rtt_hist.percentile(99),
                "link_degraded": v.link_degraded,
                "reconnects": v.tx_reconnects,
                "frames_corrupt": v.tx_frames_corrupt,
                "relay_batches": v.tx_relay_batches,
                "relay_batched_events": v.tx_relay_events,
                "free_blocks": (v.state or {}).get("free_blocks"),
                "kv_occupancy": (v.state or {}).get("kv_occupancy"),
                "prefix_cache_hits": (v.state or {}).get(
                    "prefix_cache_hits"),
                # migration backlog, replica side: imports
                # pending commit + exports pinned awaiting ack
                "kv_pending_imports": (v.state or {}).get(
                    "kv_pending_imports"),
                "kv_exports_pinned": (v.state or {}).get(
                    "kv_exports_pinned"),
                # adapter residency, read off the state
                # heartbeat — the same signal placement's adapter
                # affinity keys on
                "adapters_resident": (v.state or {}).get(
                    "adapters_resident"),
                "adapter_active": (v.state or {}).get("adapter_active"),
                "ckpt_step": (v.meta or {}).get("ckpt_step"),
            }
        states = collections.Counter(
            r.state.value for r in self.requests.values())
        return {
            "replicas": replicas,
            "tenant_affinity": dict(self._tenant_affinity),
            "queue_depth": self.total_queue_depth(),
            "pending": sum(len(q) for q in self._pending.values()),
            # controller-readable signals:
            # dispatched-but-not-yet-decoding backlog and the windowed
            # p99 slope, first-class — the autopilot and external
            # probes read the same numbers the scrape shows
            "backlog": sum(v.backlog() for v in self._views.values()
                           if not v.down),
            "p99_trend": {
                "ttft_ms_per_s": round(self.p99_trend("ttft_ms"), 4),
                "tpot_ms_per_s": round(self.p99_trend("tpot_ms"), 4),
                "windows": {m: len(d) for m, d in self._trend.items()},
                "window_s": self.trend_window_s,
            },
            "requests": dict(states),
            # the fleet is "draining" only when every replica is —
            # /healthz on the router stays ok through a staggered roll
            "draining": bool(self._views) and all(
                v.draining or v.down for v in self._views.values()),
        }

    def fleet_statusz(self) -> dict:
        """The fleet aggregation plane: merged replica
        heartbeats + transport counters + per-tenant / per-priority SLO
        accounting, served by the debug server at ``/fleet/statusz``
        (the engine-slot duck type grew one optional method).

        Per tenant and per priority class: windowed p50/p99 TTFT, TPOT
        and router queue-wait (the existing :class:`~apex_tpu_torch.
        observability.metrics.Histogram` bounded-ring semantics — the
        percentiles describe the recent window, the counts are
        lifetime), plus finished / rejected (shed) / replay (failover)
        counts.  Everything is a read-only locked snapshot — the
        free-telemetry discipline applied to the scrape path."""
        def hist_row(name: str, keep: int = 4096) -> dict:
            # keep matches the observe sites' windows — keep_samples
            # binds at first creation, and a scrape racing the first
            # observation must not shrink a window
            h = self.registry.histogram(name, keep_samples=keep)
            return {"count": h.count,
                    "p50": h.percentile(50), "p99": h.percentile(99)}

        def counter(name: str) -> int:
            return int(self.registry.counter(name).value)

        def slo_rows(kind: str, keys) -> dict:
            rows = {}
            for key in sorted(keys, key=str):
                rows[str(key)] = {
                    "ttft_ms": hist_row(f"fleet/{kind}/{key}/ttft_ms"),
                    "tpot_ms": hist_row(f"fleet/{kind}/{key}/tpot_ms"),
                    "queue_wait_ms": hist_row(
                        f"fleet/{kind}/{key}/queue_wait_ms"),
                    "finished": counter(f"fleet/{kind}/{key}/finished"),
                    "rejected": counter(f"fleet/{kind}/{key}/rejected"),
                }
                if kind == "tenant":
                    rows[str(key)]["replays"] = counter(
                        f"fleet/{kind}/{key}/replays")
            return rows

        base = self.introspect()
        # per-role SLO split + migration backlog: a
        # saturated migration link shows up HERE (backlog climbing,
        # decode-role tpot widening) before it becomes tail latency
        roles: Dict[str, dict] = {}
        for name, v in self._views.items():
            row = roles.setdefault(v.role, {
                "replicas": [], "assigned": 0, "backlog": 0,
                "ttft_ms": hist_row(f"fleet/role/{v.role}/ttft_ms"),
                "tpot_ms": hist_row(f"fleet/role/{v.role}/tpot_ms"),
            })
            row["replicas"].append(name)
            if not v.down:
                row["assigned"] += len(v.assigned)
                row["backlog"] += v.backlog()
        # per-adapter speculative acceptance:
        # summed across the live replicas' state heartbeats so the
        # template-poor tenant is visible fleet-wide, not hidden in
        # one replica's introspect
        spec_acc: Dict[str, List[int]] = {}
        for v in self._views.values():
            if v.down:
                continue
            rows = (v.state or {}).get("spec_by_adapter") or {}
            for aid, row in rows.items():
                agg = spec_acc.setdefault(str(aid), [0, 0])
                agg[0] += int(row.get("proposed") or 0)
                agg[1] += int(row.get("accepted") or 0)
        out = {
            "replicas": base["replicas"],
            "queue_depth": base["queue_depth"],
            "pending": base["pending"],
            "backlog": base["backlog"],
            "p99_trend": base["p99_trend"],
            "requests": base["requests"],
            "draining": base["draining"],
            "spec_acceptance": {
                aid: {"proposed": p, "accepted": a,
                      "acceptance": round(a / p, 4) if p else None}
                for aid, (p, a) in sorted(spec_acc.items())},
            "roles": roles,
            "migrations": {
                "inflight": len(self._migrations),
                "backlog": len(self._migrations) + sum(
                    int((v.state or {}).get("kv_pending_imports") or 0)
                    + int((v.state or {}).get("kv_exports_pinned") or 0)
                    for v in self._views.values() if not v.down),
                "started": counter("fleet/kv_migrate_started"),
                "completed": counter("fleet/kv_migrate_completed"),
                "failed": counter("fleet/kv_migrate_failed"),
                "blocks": counter("fleet/kv_migrate_blocks"),
                "bytes": counter("fleet/kv_migrate_bytes"),
                "migrate_ms": hist_row("fleet/kv_migrate_ms"),
            },
            "slo": {
                "tenants": slo_rows("tenant", self._slo_tenants),
                "priorities": slo_rows("priority",
                                       self._slo_priorities),
                # per-adapter SLO windows: same row shape as
                # tenants/priorities so scrapers need no new parser
                "adapters": slo_rows("adapter", self._slo_adapters),
            },
            "totals": {
                "submitted": counter("fleet/requests_submitted"),
                "finished": counter("fleet/requests_finished"),
                "rejected": counter("serving/requests_rejected"),
                "failovers": counter("fleet/failovers"),
                "replays": counter("fleet/replays"),
                "reschedules": counter("fleet/reschedules"),
                "reconnects": counter("fleet/reconnects"),
                "frames_corrupt": counter("fleet/frames_corrupt"),
                "relay_batch": counter("fleet/relay_batch"),
                "relay_batch_events": counter(
                    "fleet/relay_batch_events"),
                "adapter_loads": counter("fleet/adapter_loads"),
                "adapter_swaps": counter("fleet/adapter_swaps"),
            },
            "fleet_ttft_ms": hist_row("fleet/ttft_ms"),
            "fleet_tpot_ms": hist_row("fleet/tpot_ms", keep=65536),
        }
        # longitudinal history + burn-rate blocks appear ONLY
        # when the history plane is armed
        if self.history is not None:
            out["history"] = self.history.introspect()
            if self.slo is not None:
                out["slo"]["burn"] = {
                    "rows": self.slo.last_rows,
                    "worst": self.slo.worst(),
                    **self.slo.introspect(),
                }
        return out

    # ---------------------------------------------------------- lifecycle

    def stream(self, req, *, poll_s: float = 0.002,
               timeout_s: float = 300.0):
        """Iterate a request's tokens as router events surface them —
        the streaming client API (ROADMAP fleet follow-on): callers
        stop polling result buffers and consume the stream.

        ``req``: a :class:`FleetRequest` or its rid.  Each iteration
        **pumps the router** (the single-threaded driving model —
        consuming a stream keeps the whole fleet moving, exactly like
        :meth:`run_until_idle`), yields any newly-surfaced tokens, and
        closes when the request reaches a terminal state.  Tokens
        survive failover transparently: a replay appends to the same
        ``output_tokens``, so the iterator just keeps yielding the
        stitched (bitwise-identical) stream.  A shed/parked REJECTED
        request yields nothing and closes immediately — the terminal
        state is the caller's signal, same as the non-streaming path.
        ``timeout_s`` is an **inactivity** bound — it resets on every
        surfaced token, so a long healthy stream never trips it; only a
        stream that goes silent (and that failover/attempt-parking has
        not already driven to a terminal state) raises.
        """
        if not hasattr(req, "output_tokens"):
            found = self.requests.get(req)
            if found is None:
                raise KeyError(f"unknown or evicted fleet request {req!r}")
            req = found
        sent = 0
        deadline = self._clock() + timeout_s
        while True:
            progressed = sent < len(req.output_tokens)
            while sent < len(req.output_tokens):
                yield req.output_tokens[sent]
                sent += 1
            if req.done:
                return
            self.pump()
            if progressed:
                deadline = self._clock() + timeout_s
            elif self._clock() > deadline:
                raise RuntimeError(
                    f"stream of request {req.rid} surfaced no token and "
                    f"no terminal state for {timeout_s:.0f}s")
            if poll_s and not progressed:
                time.sleep(poll_s)

    def idle(self) -> bool:
        """True when every submitted request reached a terminal state."""
        return all(r.done for r in self.requests.values())

    def run_until_idle(self, *, timeout_s: float = 300.0,
                       poll_s: float = 0.002) -> None:
        deadline = self._clock() + timeout_s
        while not self.idle():
            self.pump()
            if self._clock() > deadline:
                open_reqs = [r.rid for r in self.requests.values()
                             if not r.done]
                raise RuntimeError(
                    f"fleet not idle after {timeout_s:.0f}s; open "
                    f"requests: {open_reqs[:16]}")
            time.sleep(poll_s)

    def close(self) -> None:
        """Tear the fleet down (idempotent per client)."""
        for view in self._views.values():
            try:
                view.client.close()
            except Exception as e:
                logger.warning("fleet: closing %s failed: %r",
                               view.name, e)
