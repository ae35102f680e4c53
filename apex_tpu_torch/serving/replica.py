"""One serving replica = one spawned process hosting a ServingEngine
(port of :mod:`apex_tpu.serving.replica`).

Each replica is a **separate process** with its own CUDA context, KV
arenas and :class:`~apex_tpu_torch.serving.engine.ServingEngine`, so a
replica death is a process death (the failure the router is built to
survive) and a weight rollout is a process replacement.  The lifecycle:
a startup handshake carrying replica metadata, error relay with a
picklability pre-test, a ppid orphan watchdog so a SIGKILLed router
never leaks replicas, and an escalating join→terminate→kill teardown
through :func:`~apex_tpu_torch.data._producer.reap_process`.  Children
are spawned, never forked: a forked child of a parent that has touched
CUDA cannot use the card, so ``fork`` with a ``cuda`` spec raises.

Wire protocol (multiprocessing queues; every payload is plain
picklable data: numpy arrays and Python values, never a torch tensor —
over ``mp.Queue`` a torch tensor would travel as a shared-memory file
descriptor, over the socket as bytes, and the two transports would not
carry the same thing):

parent → child commands
    ``("submit", frid, prompt, max_new_tokens, eos_id, sampling,
       trace)``
                        — ``sampling`` is the request's per-request
                          :class:`~apex_tpu_torch.serving.sampling.
                          SamplingParams` (or None for greedy), the
                          engine's sampling API over the wire.  Replay
                          stays
                          deterministic by the seeded-counter
                          construction — the router rebases
                          ``step_offset`` by the emitted prefix it
                          re-prefills, so a survivor redraws the SAME
                          stochastic stream.  ``trace`` is
                          the router-minted trace context
                          (``{"trace_id", "attempt"}``, or None when
                          tracing is unarmed): the engine stamps it
                          onto every timeline event of the request, so
                          one fleet-wide id spans every process's
                          spill — including re-dispatches after
                          failover (``attempt`` increments per
                          dispatch).
    ``("submit_many", [(frid, prompt, max_new_tokens, eos_id,
                        sampling, trace), ...])``
                        — batched admission: N requests in ONE queue
                          put/pickle round trip (the router batches a
                          pump's dispatches per replica; at fleet
                          arrival rates the per-command transport
                          overhead was the router's dominant cost)
    ``("drain",)``      — programmatic drain (tests); production
                          rollouts send a real **SIGTERM** instead,
                          through the engine's ``PreemptionGuard``
    ``("stop",)``       — immediate cooperative exit
    ``("load_adapter", adapter_id, payload)``
                        — register a LoRA adapter into the
                          engine's paged adapter arena; ``payload`` may
                          carry ``weights`` (raw per-projection A/B
                          pairs) or a ``seed`` for the deterministic
                          test fixture.  Acked by ``adapter_loaded``.
                          Re-loading a resident id hot-swaps the slot
                          in place — the zero-downtime adapter rollout
                          is this command, per replica, staggered.
    ``("unload_adapter", adapter_id)``
                        — drop the registry reference (the slot frees
                          once the last active request unpins it);
                          acked by ``adapter_unloaded``
    ``("set_knobs", payload)``
                        — live-retune: apply data-only
                          engine knob caps (``prefill_chunk`` /
                          ``spec_k`` — never a shape); ``payload`` also carries the
                          router's ack ``token``.  Acked by
                          ``knobs_set``.

KV-block migration.  The
router relays a request's paged KV from a prefill replica to a decode
replica; each side speaks a handful of extra commands/events, and every
``kv_block`` payload rides its OWN frame on the socket transport so the
session layer's per-frame seq makes the stream resumable at any block
boundary:

parent → child (source / prefill side)
    ``("export_kv", frid)``      — extract the request's block run and
                                   stream it up as events; the request
                                   leaves this engine (its stream
                                   continues on the decode side)
    ``("kv_ack", frid, ok)``     — the migration's outcome: either way
                                   the pinned run releases (full blocks
                                   index into the local prefix cache —
                                   valid KV regardless, and the failed
                                   case's re-prefill then hits it)

parent → child (destination / decode side)
    ``("import_kv", frid, meta)``           — open a pending import
    ``("kv_block", frid, idx, payload)``    — one block's slabs, numpy
                                              (bf16 as its ``uint16``
                                              view; ``meta["slab_dtypes"]``
                                              names each slab's dtype)
    ``("import_commit", frid, item, n)``    — all blocks sent: admit
                                              ``item`` (a
                                              ``wire_submit_item``
                                              whose prompt is the full
                                              stream so far) with the
                                              imported KV; ONE batched
                                              device scatter lands the
                                              payload
    ``("kv_abort", frid)``                  — drop a pending import

child → parent (source side)
    ``("kv_meta", frid, meta)``          — export opened; ``meta`` has
                                           ``cache_len``/``n_blocks``/
                                           ``n_out``/``bytes``/shape
    ``("kv_block", frid, idx, payload)`` — one block, in order
    ``("kv_export_done", frid, n)``      — run fully streamed
    ``("kv_export_failed", frid, why)``  — not exportable (router lets
                                           the request keep decoding
                                           here)

child → parent (destination side)
    ``("kv_imported", frid, ok, why)``   — commit verdict; ``ok`` means
                                           the request is RUNNING here
                                           as if prefilled locally

child → parent events
    ``("ready", meta)``        — engine built; ``meta`` has ``pid``,
                                 ``ckpt_step`` (None for seed init),
                                 ``max_batch``, ``n_blocks``,
                                 ``debug_port`` (``/healthz`` etc.)
    ``("state", snapshot)``    — rate-limited heartbeat: the engine's
                                 ``introspect()`` dict + ``hb`` stamp
                                 (**monotonic**, replica-local — one
                                 clock domain with the worker loop; an
                                 NTP wall-clock step can never skew a
                                 heartbeat age, and the router never
                                 compares it cross-host: liveness runs
                                 on event *arrival* times);
                                 the router's liveness AND admission
                                 signal (free blocks, queue depth,
                                 draining)
    ``("token", frid, token)`` — one generated token, in order
    ``("batch", [event, ...])``— one relay turn's whole event backlog
                                 in ONE queue put
    ``("finished", frid)`` / ``("cancelled", frid)`` /
    ``("rejected", frid, why)`` — terminal transitions; ``cancelled``
                                 means drained-out-of-queue (the router
                                 reschedules it), ``rejected`` means
                                 refused at submit
    ``("drained", delivered)`` — the SIGTERM drain completed: every
                                 in-flight request delivered; the child
                                 exits 0 right after
    ``("adapter_loaded", adapter_id, ok, info)`` /
    ``("adapter_unloaded", adapter_id, ok, info)``
                               — adapter command verdicts:
                                 ``info`` is ``{"slot": int,
                                 "evicted": id-or-None}`` on success,
                                 the repr'd error otherwise.  The
                                 router's ``load_adapter`` broadcast
                                 and staggered ``swap_adapter`` both
                                 pump on these acks.
    ``("knobs_set", token, ok, info)``
                               — retune verdict: ``info``
                                 is the engine's applied knob dict on
                                 success, the repr'd error otherwise;
                                 the router's ``set_knobs`` broadcast
                                 pumps on these, keyed by ``token``.
    ``("error", exc)``         — relayed fatal; the child exits

A SIGKILLed child never sends ``drained`` — the router sees the dead
process/pipe, drains whatever events DID flush (tokens generated before
the kill are real and kept), and replays the remainder elsewhere
(``fleet.py``).  Token events are emitted strictly in generation order,
so the router-side stitched stream is a prefix of the true greedy
stream at every instant.
"""

from __future__ import annotations

import dataclasses
import logging
import queue as queue_mod
from typing import Any, List, Optional, Sequence, Tuple

__all__ = ["ReplicaSpec", "ReplicaProcess", "wire_submit_item"]

logger = logging.getLogger(__name__)


def wire_submit_item(item: Sequence) -> tuple:
    """Normalize one ``submit_many`` entry to the wire tuple ``(frid,
    prompt, max_new_tokens, eos_id, sampling, trace)`` — the ONE
    definition both transports encode with (a 5-tuple gets
    ``trace=None``), so the mp-queue and socket wires can
    never drift apart on the format."""
    frid, prompt, max_new, eos, samp = item[:5]
    trace = item[5] if len(item) > 5 else None
    return (frid, [int(t) for t in prompt], int(max_new), eos,
            samp, trace)


def _state_snapshot(engine) -> dict:
    """One state-heartbeat payload: ``introspect()`` + an ``hb`` stamp
    on the **monotonic** clock.  The worker loop's cadence and the
    router's probe ladder both run on monotonic time; stamping the
    snapshot from the wall clock would let an NTP step make heartbeat
    ages jump by the slew, so no clock domain mixes wall time into
    liveness."""
    import time

    snap = engine.introspect()
    snap["hb"] = time.monotonic()
    return snap


@dataclasses.dataclass(frozen=True)
class ReplicaSpec:
    """Everything a child needs to stand up one engine (picklable —
    crosses the spawn boundary; configs and dtypes only, never a CUDA
    tensor).

    ``ckpt_dir`` None: deterministic seed init through ``build_gpt_3d``'s
    ``init_fn(seed=seed)`` — two replicas with the same spec serve the
    same bits.  ``ckpt_dir`` set: the newest intact checkpoint of that
    :class:`~apex_tpu_torch.resilience.CheckpointManager` directory
    (``restore_gpt_for_serving``), its step reported in the ready
    handshake's ``ckpt_step``.  ``device`` is the engine's device in
    the child: None means ``cuda`` (a child that finds no card raises,
    and the router sees its ``error`` event), ``"cpu"`` the CPU.
    """

    config: Any                      # TransformerConfig
    serving: Any                     # ServingConfig
    tp: int = 1
    ckpt_dir: Optional[str] = None
    seed: int = 0
    # fleet role: "prefill" replicas take admission +
    # chunked prefill and hand their KV off; "decode" replicas receive
    # migrated KV and run the paged-decode step undisturbed; "both"
    # (the default) is the pre-disaggregation behavior, byte-for-byte.
    # The role is ROUTER policy — the engine underneath is identical;
    # a "prefill" replica that never migrates still decodes correctly.
    role: str = "both"               # "prefill" | "decode" | "both"
    heartbeat_every_s: float = 0.05  # state-event rate limit
    idle_sleep_s: float = 0.005      # loop sleep when no work is queued
    debug_server: bool = True        # /metrics /statusz /healthz
    warmup: bool = True              # pay the first prefill/decode
    #                                  BEFORE the ready handshake, so the
    #                                  router's heartbeat timeout never
    #                                  has to cover the first launches
    # distributed tracing: when set, the child arms its own
    # FlightRecorder spilling to
    # ``<timeline_dir>/timeline.replica.<name>.<pid>.jsonl`` (process
    # identity in the filename AND the run_begin meta), so a fleet's N
    # processes leave N stitchable spills.  None = unarmed (the
    # zero-cost default — every instrumentation point is a None check).
    timeline_dir: Optional[str] = None
    timeline_tick_every: int = 8     # decode_tick sampling (1 = every
    #                                  token: the trace smoke's precise
    #                                  hop boundaries)
    # longitudinal history: > 0 arms a child-side
    # MetricHistory sampled every this-many seconds; each completed
    # ring bucket ships to the router as a compacted delta riding the
    # EXISTING state heartbeat (no new command, no new wire frame —
    # ``snap["history"]``), where it merges under ``replica/<name>/``.
    # 0.0 (the default) = disarmed: the heartbeat payload carries no
    # history.
    history_every_s: float = 0.0
    device: Optional[str] = None

    def __post_init__(self):
        if self.role not in ("prefill", "decode", "both"):
            raise ValueError(
                f"role must be 'prefill' | 'decode' | 'both', "
                f"got {self.role!r}")


def _build_engine(spec: ReplicaSpec, registry, guard):
    """Child-side engine construction; returns (engine, ckpt_step)."""
    from apex_tpu_torch._device import resolve_device
    from apex_tpu_torch.serving.engine import ServingEngine
    from apex_tpu_torch.transformer.testing.gpt_parallel_train import (
        build_gpt_3d,
    )

    if spec.tp != 1:
        raise NotImplementedError(
            f"tp={spec.tp}: a replica of several ranks needs a process "
            "group inside the replica (ROADMAP.md §A); replicas serve at "
            "tp = 1")
    device = resolve_device(spec.device)
    step = None
    if spec.ckpt_dir is not None:
        from apex_tpu_torch.serving.loader import restore_gpt_for_serving

        params, _, step = restore_gpt_for_serving(
            spec.ckpt_dir, spec.config, with_step=True, device=device)
    else:
        init_fn, _, _ = build_gpt_3d(
            spec.config, num_chunks=spec.config.num_layers,
            num_microbatches=1, device=device)
        params, _ = init_fn(seed=spec.seed)
    engine = ServingEngine(spec.config, spec.serving, params,
                           registry=registry, guard=guard,
                           timeline_tick_every=spec.timeline_tick_every,
                           device=device)
    return engine, step


def _kv_pool_bytes(spec: ReplicaSpec) -> int:
    """The bytes of the engine's whole KV arena (every slab of every
    block): what exporting every request at once puts on the wire."""
    import torch

    from apex_tpu_torch.serving.kv_cache import KVCacheConfig

    cfg, serving = spec.config, spec.serving
    dtype = (serving.cache_dtype if serving.cache_dtype is not None
             else cfg.param_dtype)
    probe = KVCacheConfig(
        n_layers=cfg.num_layers, n_blocks=1, block_size=serving.block_size,
        kv_heads=cfg.query_groups, head_dim=cfg.head_dim,
        max_seq=serving.max_seq, dtype=dtype)
    n_blocks = serving.resolve_n_blocks(probe.max_blocks_per_request)
    size = torch.empty((), dtype=dtype).element_size()
    per_slot = 2 * cfg.head_dim * size          # k and v
    if dtype == torch.int8:
        per_slot += 2 * 4                       # their fp32 scales
    return (cfg.num_layers * n_blocks * serving.block_size
            * cfg.query_groups * per_slot)


def _needs_spawn(spec: ReplicaSpec, start_method: str) -> None:
    """A forked child of a parent that has touched CUDA cannot use the
    card: refuse ``fork`` for a replica bound to it."""
    if start_method == "fork" and (spec.device is None
                                   or spec.device.startswith("cuda")):
        raise ValueError(
            "start_method='fork' cannot serve on cuda: a forked child "
            "cannot use a CUDA context; use 'spawn'")


def _kv_to_wire(payload) -> Tuple[tuple, List[str]]:
    """One exported block (a tuple of CPU tensors) as numpy slabs: bf16
    as its ``uint16`` view, since numpy has no bf16.  Returns the slabs
    and their torch dtype names."""
    import torch

    slabs, names = [], []
    for t in payload:
        names.append(str(t.dtype).replace("torch.", ""))
        if t.dtype == torch.bfloat16:
            t = t.view(torch.uint16)
        slabs.append(t.contiguous().numpy())
    return tuple(slabs), names


def _kv_from_wire(slabs, names: Sequence[str]) -> tuple:
    """The inverse of :func:`_kv_to_wire`: CPU tensors of the
    named dtypes over the received numpy slabs (no copy)."""
    import torch

    out = []
    for a, name in zip(slabs, names):
        t = torch.from_numpy(a)
        if name == "bfloat16":
            t = t.view(torch.bfloat16)
        out.append(t)
    return tuple(out)


def _replica_worker(spec: ReplicaSpec, name: str, cmd_q, evt_q,
                    parent_pid: int, on_ready=None) -> None:
    """Replica-process main: build the engine, serve the command stream,
    relay tokens/state; drain-and-exit on SIGTERM; die on orphanhood.
    ``on_ready(engine)`` runs once the warm-up is done, just before the
    ready event goes out (where a harness starts counting)."""
    import os
    import time

    from apex_tpu_torch.resilience import PreemptionGuard

    def orphaned() -> bool:
        return os.getppid() != parent_pid

    if spec.device == "cpu":
        # a CPU replica shares its host's cores with its siblings
        import torch

        torch.set_num_threads(1)
    # the guard installs the real SIGTERM handler (child main thread):
    # the rollout path is the engine's drain, not a new mechanism
    guard = PreemptionGuard()
    server = None
    recorder = None
    try:
        from apex_tpu_torch.observability.metrics import MetricRegistry

        if spec.timeline_dir is not None:
            # per-process spill, armed BEFORE the engine builds so the
            # whole request lifecycle lands in it; the filename and the
            # run_begin meta both carry the process identity the trace
            # merger keys on (observability/trace.py)
            from apex_tpu_torch.observability.trace import arm_process

            recorder = arm_process(spec.timeline_dir, "replica", name)
        registry = MetricRegistry(rank=0, world=1)
        engine, ckpt_step = _build_engine(spec, registry, guard)
        if spec.warmup:
            # throwaway tokens: CUDA initialises, the kernel library
            # loads (built by now, or built here) and the first prefill
            # and decode launches run HERE, inside the wait_ready
            # window, so once this replica reports ready its step time
            # is steady state and the router's missed-heartbeat detector
            # sees no start-up stall it could mistake for a wedge.
            # max_new=3, not 1: the first token comes out of PREFILL — a
            # 1-token warmup never runs the decode step
            engine.submit([1], 3)
            for _ in range(64):
                if engine.scheduler.idle:
                    break
                engine.step()
        if on_ready is not None:
            on_ready(engine)
        debug_port = None
        if spec.debug_server:
            from apex_tpu_torch.observability.debug_server import DebugServer

            server = DebugServer(registry=registry, engine=engine).start()
            debug_port = server.port
        evt_q.put(("ready", {
            "pid": os.getpid(), "name": name, "ckpt_step": ckpt_step,
            "max_batch": spec.serving.max_batch,
            "n_blocks": engine.cache.n_blocks,
            # context limit: the router needs this to recognize a
            # stream the engine finished at the context cap during
            # failover replay.  prefill_len is None since chunked
            # prefill: any prefix short of max_seq can be
            # re-prefilled — the chunk width is a tick-latency knob,
            # not an admission limit
            "max_seq": engine.cache.max_seq,
            "prefill_len": None,
            "debug_port": debug_port,
            "role": spec.role,
            # whether this engine has a LoRA adapter arena —
            # the router refuses to broadcast adapters at a bare fleet
            # instead of failing one replica at a time mid-load
            "lora": engine.lora is not None,
        }))

        reqs = {}          # frid -> engine Request
        reported = {}      # frid -> tokens already relayed
        exported = {}      # frid -> engine rid, pinned until kv_ack
        imports = {}       # frid -> {"meta", "blocks": {idx: payload}}
        last_state = 0.0
        history = None
        last_hist = [0.0]
        if spec.history_every_s > 0:
            from apex_tpu_torch.observability.timeseries import MetricHistory

            history = MetricHistory(registry)

        def flush() -> None:
            # one queue put per relay turn: the
            # socket server batches a whole event backlog into each
            # send, while mp.Queue's feeder thread pickles one payload
            # per wakeup — batching here closes that gap for the
            # in-process transport (the wire_vs_inproc lesson).  A
            # single event skips the wrapper; order is preserved (one
            # producer thread, one queue).
            out = []
            for frid in list(reqs):
                req = reqs[frid]
                toks = req.output_tokens
                for tok in toks[reported[frid]:]:
                    out.append(("token", frid, int(tok)))
                reported[frid] = len(toks)
                if req.done:
                    state = req.state.value
                    if state == "finished":
                        out.append(("finished", frid))
                    elif state == "cancelled":
                        out.append(("cancelled", frid))
                    else:
                        out.append(("rejected", frid, state))
                    del reqs[frid], reported[frid]
            if len(out) == 1:
                evt_q.put(out[0])
            elif out:
                evt_q.put(("batch", out))

        def heartbeat(now: float, force: bool = False) -> float:
            if force or now - last_state >= spec.heartbeat_every_s:
                snap = _state_snapshot(engine)
                # migration backlog: pending imports not yet
                # committed + exports pinned awaiting ack — the
                # /fleet/statusz backlog signal
                snap["kv_pending_imports"] = len(imports)
                snap["kv_exports_pinned"] = len(exported)
                # history delta: sample the local registry on
                # its own cadence and piggyback completed ring buckets on
                # this very heartbeat — the router rebases the bucket
                # stamps onto its own clock at ingest, so the two hosts'
                # monotonic epochs never have to agree
                if history is not None and (
                        now - last_hist[0] >= spec.history_every_s):
                    last_hist[0] = now
                    history.sample(now)
                    delta = history.export_delta(now)
                    if delta is not None:
                        snap["history"] = delta
                evt_q.put(("state", snap))
                return now
            return last_state

        def admit_one(frid, prompt, max_new, eos, sampling=None,
                      trace=None) -> None:
            try:
                req = engine.submit(prompt, max_new, eos,
                                    sampling=sampling, trace=trace)
            except ValueError as e:
                # unserviceable here (too long for this replica's
                # pool) — typed refusal, the router decides what to
                # do with it
                evt_q.put(("rejected", frid, repr(e)))
            else:
                if req.done:   # rejected in the drain window
                    evt_q.put(("rejected", frid, req.state.value))
                else:
                    reqs[frid] = req
                    reported[frid] = 0

        def export_one(frid) -> None:
            """Source side of a migration: relay any still-unreported
            tokens FIRST (so every token of the stream precedes its
            kv_meta on the wire), then stream the block run up as
            one-frame-per-block events.  The pinned run is released by
            the router's later ``kv_ack``."""
            req = reqs.get(frid)
            if req is None or req.done:
                evt_q.put(("kv_export_failed", frid, "not running here"))
                return
            for tok in req.output_tokens[reported[frid]:]:
                evt_q.put(("token", frid, int(tok)))
            reported[frid] = len(req.output_tokens)
            t0 = time.perf_counter()
            try:
                meta, payloads = engine.export_request(req)
            except ValueError as e:
                evt_q.put(("kv_export_failed", frid, repr(e)))
                return
            del reqs[frid], reported[frid]
            exported[frid] = req.rid
            wire = [_kv_to_wire(p) for p in payloads]
            meta = dict(meta, slab_dtypes=wire[0][1] if wire else [])
            registry.histogram("serving/kv_export_ms").observe(
                (time.perf_counter() - t0) * 1e3)
            evt_q.put(("kv_meta", frid, meta))
            for idx, (slabs, _) in enumerate(wire):
                evt_q.put(("kv_block", frid, idx, slabs))
            evt_q.put(("kv_export_done", frid, len(payloads)))

        def import_commit(frid, item, n_blocks) -> None:
            """Destination side: every block landed — admit the request
            with the imported KV through ONE batched scatter.  Any
            failure is a typed verdict; the router degrades to
            re-prefill and this engine's arena is untouched."""
            pending = imports.pop(frid, None)
            if pending is None:
                evt_q.put(("kv_imported", frid, False, "no pending import"))
                return
            blocks = pending["blocks"]
            missing = [i for i in range(n_blocks) if i not in blocks]
            if missing:
                evt_q.put(("kv_imported", frid, False,
                           f"missing blocks {missing[:4]}"))
                return
            _, prompt, max_new, eos, sampling, trace = \
                wire_submit_item(item)
            names = pending["meta"].get("slab_dtypes", [])
            t0 = time.perf_counter()
            try:
                import numpy as _np

                req = engine.import_request(
                    _np.asarray(prompt, _np.int32), max_new, eos,
                    sampling, trace,
                    cache_len=int(pending["meta"]["cache_len"]),
                    payloads=[_kv_from_wire(blocks[i], names)
                              for i in range(n_blocks)])
            except ValueError as e:
                evt_q.put(("kv_imported", frid, False, repr(e)))
                return
            if req.done:
                evt_q.put(("kv_imported", frid, False, req.state.value))
                return
            # the engine's scatter is queued on the device: time it done
            if engine.device.type == "cuda":
                import torch

                torch.cuda.synchronize(engine.device)
            registry.histogram("serving/kv_import_ms").observe(
                (time.perf_counter() - t0) * 1e3)
            reqs[frid] = req
            reported[frid] = 0
            evt_q.put(("kv_imported", frid, True, None))

        while not orphaned():
            try:
                while True:
                    cmd = cmd_q.get_nowait()
                    if cmd[0] == "submit":
                        admit_one(*cmd[1:])
                    elif cmd[0] == "submit_many":
                        for item in cmd[1]:
                            admit_one(*item)
                    elif cmd[0] == "export_kv":
                        export_one(cmd[1])
                    elif cmd[0] == "kv_ack":
                        rid = exported.pop(cmd[1], None)
                        if rid is not None:
                            engine.release_export(rid, ok=bool(cmd[2]))
                    elif cmd[0] == "import_kv":
                        imports[cmd[1]] = {"meta": cmd[2], "blocks": {}}
                    elif cmd[0] == "kv_block":
                        pend = imports.get(cmd[1])
                        if pend is not None:
                            pend["blocks"][int(cmd[2])] = cmd[3]
                    elif cmd[0] == "import_commit":
                        import_commit(cmd[1], cmd[2], cmd[3])
                    elif cmd[0] == "kv_abort":
                        imports.pop(cmd[1], None)
                    elif cmd[0] == "load_adapter":
                        aid, payload = cmd[1], (cmd[2] or {})
                        try:
                            evicted = engine.adapter_arena.residents() \
                                if engine.adapter_arena else []
                            slot = engine.register_adapter(
                                aid, weights=payload.get("weights"),
                                seed=payload.get("seed"))
                        except Exception as e:  # noqa: BLE001 — verdict
                            evt_q.put(("adapter_loaded", aid, False,
                                       repr(e)))
                        else:
                            gone = [a for a in evicted
                                    if a != aid and
                                    not engine.adapter_arena.resident(a)]
                            evt_q.put(("adapter_loaded", aid, True,
                                       {"slot": int(slot),
                                        "evicted": gone[0] if gone
                                        else None}))
                    elif cmd[0] == "unload_adapter":
                        aid = cmd[1]
                        try:
                            engine.unregister_adapter(aid)
                        except Exception as e:  # noqa: BLE001 — verdict
                            evt_q.put(("adapter_unloaded", aid, False,
                                       repr(e)))
                        else:
                            evt_q.put(("adapter_unloaded", aid, True,
                                       None))
                    elif cmd[0] == "set_knobs":
                        # live retune: apply and ack with the
                        # engine's resulting knob state — the router
                        # pump-waits this verdict (adapter-ack
                        # discipline); a refused payload acks False
                        payload = dict(cmd[1] or {})
                        token = payload.pop("token", None)
                        try:
                            applied = engine.set_knobs(payload)
                        except Exception as e:  # noqa: BLE001 — verdict
                            evt_q.put(("knobs_set", token, False,
                                       repr(e)))
                        else:
                            evt_q.put(("knobs_set", token, True,
                                       applied))
                    elif cmd[0] == "drain":
                        guard.trigger()
                    elif cmd[0] == "stop":
                        flush()
                        return
            except queue_mod.Empty:
                pass
            if not engine.scheduler.idle:
                engine.step()      # drains itself once guard trips
            elif guard.triggered:
                # drain complete: everything delivered, queue empty
                if not engine.draining:
                    engine.drain()
                flush()
                heartbeat(time.monotonic(), force=True)
                evt_q.put(("drained", None))
                return
            else:
                time.sleep(spec.idle_sleep_s)
            flush()
            last_state = heartbeat(time.monotonic())
    except BaseException as e:  # noqa: BLE001 — relayed, not eaten
        import pickle

        try:
            pickle.dumps(e)
        except Exception:
            e = RuntimeError(repr(e))
        try:
            evt_q.put(("error", e))
        except Exception:
            pass
    finally:
        if recorder is not None:
            from apex_tpu_torch.observability import timeline as _tl

            _tl.disarm()
            try:
                recorder.flush()      # run_end on the clean-exit paths
            except Exception:         # a SIGKILL never reaches here —
                pass                  # its spill ends at the torn tail
        if server is not None:
            server.close()
        guard.uninstall()


def _shutdown_replica(cmd_q, proc) -> None:
    """GC/exit finalizer teardown (the data-service pattern: the child
    is non-daemonic, so an unreaped replica would deadlock interpreter
    exit under multiprocessing's own atexit join)."""
    from apex_tpu_torch.data._producer import reap_process

    try:
        cmd_q.put_nowait(("stop",))
    except Exception:
        pass
    reap_process(proc, 10.0, what="serving replica")


class ReplicaProcess:
    """Router-side handle on one replica child — the process transport
    behind the :mod:`~apex_tpu_torch.serving.fleet` client duck-type.

    The router talks to this through five methods (``alive``, ``poll``,
    ``submit``, ``begin_drain``, ``close``) plus ``kill`` for fault
    injection; an in-memory fake with the same surface keeps the
    router's policy logic testable without a single process spawn.
    ``start_method="fork"`` raises for a replica on ``cuda``.
    """

    def __init__(self, spec: ReplicaSpec, name: str, *,
                 start_method: str = "spawn"):
        import multiprocessing as mp
        import os
        import weakref

        _needs_spawn(spec, start_method)
        self.name = name
        self.meta: Optional[dict] = None
        # batched-relay accounting: how many
        # ("batch", ...) payloads poll() unpacked and how many events
        # rode them — the router mirrors these into fleet/relay_batch*
        self.relay_batches = 0
        self.relay_batched_events = 0
        self._ctx = mp.get_context(start_method)
        self._cmd = self._ctx.Queue()
        self._evt = self._ctx.Queue()
        self._closed = False
        # NON-daemonic + ppid watchdog: the child owns a CUDA context
        # and a debug server thread; a
        # daemonic child could not be debugged by spawning helpers, and
        # orphan safety comes from the watchdog, not daemonism.
        self._proc = self._ctx.Process(
            target=_replica_worker,
            args=(spec, name, self._cmd, self._evt, os.getpid()),
            daemon=False, name=f"apex-replica-{name}")
        self._proc.start()
        self._finalizer = weakref.finalize(
            self, _shutdown_replica, self._cmd, self._proc)

    # ------------------------------------------------------------ liveness

    def alive(self) -> bool:
        return self._proc.is_alive()

    @property
    def pid(self) -> Optional[int]:
        return self._proc.pid

    @property
    def exitcode(self) -> Optional[int]:
        return self._proc.exitcode

    # ------------------------------------------------------------ commands

    def submit(self, frid, prompt: Sequence[int], max_new_tokens: int,
               eos_id: Optional[int] = None, sampling=None,
               trace=None) -> None:
        """``sampling``: the request's
        :class:`~apex_tpu_torch.serving.sampling.SamplingParams` (picklable,
        crosses the wire as data) or None for greedy.  ``trace``: the
        router-minted trace context dict, or None when unarmed."""
        self._cmd.put(("submit", frid, [int(t) for t in prompt],
                       int(max_new_tokens), eos_id, sampling, trace))

    def submit_many(self, items: Sequence[tuple]) -> None:
        """Batched admission: ``items`` of ``(frid, prompt,
        max_new_tokens, eos_id, sampling[, trace])`` cross the
        transport as ONE command (one queue put, one pickle) instead of
        N — the router batches each pump's dispatches per replica
        through this."""
        self._cmd.put(("submit_many",
                       [wire_submit_item(it) for it in items]))

    # ------------------------------------------------- KV migration cmds
    # Thin wire wrappers; the router drives the handoff state
    # machine.  On the socket transport each of these is its own frame —
    # which is what makes a torn migration resumable at block
    # granularity via the session layer's per-frame seq.

    def export_kv(self, frid) -> None:
        self._cmd.put(("export_kv", frid))

    def kv_ack(self, frid, ok: bool) -> None:
        self._cmd.put(("kv_ack", frid, bool(ok)))

    def import_kv(self, frid, meta: dict) -> None:
        self._cmd.put(("import_kv", frid, meta))

    def kv_block(self, frid, idx: int, payload) -> None:
        self._cmd.put(("kv_block", frid, int(idx), payload))

    def import_commit(self, frid, item, n_blocks: int) -> None:
        self._cmd.put(("import_commit", frid, wire_submit_item(item),
                       int(n_blocks)))

    def kv_abort(self, frid) -> None:
        self._cmd.put(("kv_abort", frid))

    # ------------------------------------------------- adapter cmds
    # Thin wire wrappers over the engine's adapter registry;
    # the router's broadcast/hot-swap drives these and pumps on the
    # ``adapter_loaded`` / ``adapter_unloaded`` ack events.

    def load_adapter(self, adapter_id, payload: Optional[dict] = None
                     ) -> None:
        self._cmd.put(("load_adapter", adapter_id, dict(payload or {})))

    def unload_adapter(self, adapter_id) -> None:
        self._cmd.put(("unload_adapter", adapter_id))

    def set_knobs(self, payload: dict) -> None:
        """ Live-retune: ship the knob payload (plus the
        router's ack token) to the worker; the ``knobs_set`` verdict
        rides the ordinary event stream like the adapter acks."""
        self._cmd.put(("set_knobs", dict(payload or {})))

    def begin_drain(self, *, sigterm: bool = True) -> None:
        """Start the drain: a real SIGTERM (the production rollout
        path — same signal a preempted host gets) or the programmatic
        command when signals are unavailable."""
        import os
        import signal as _signal

        if sigterm and self._proc.pid is not None and self.alive():
            try:
                os.kill(self._proc.pid, _signal.SIGTERM)
                return
            except ProcessLookupError:
                pass
        self._cmd.put(("drain",))

    def kill(self) -> None:
        """SIGKILL — fault injection only (the smoke's dead-replica
        leg).  No drain, no goodbye: the router must cope."""
        import os
        import signal as _signal

        if self._proc.pid is not None:
            try:
                os.kill(self._proc.pid, _signal.SIGKILL)
            except ProcessLookupError:
                pass

    # -------------------------------------------------------------- events

    def poll(self) -> list:
        """Drain every event the child has flushed (non-blocking).
        Readable even after a SIGKILL — whatever reached the pipe
        before death is real and must be consumed before failover."""
        events = []
        while True:
            try:
                ev = self._evt.get_nowait()
            except queue_mod.Empty:
                break
            except (EOFError, OSError):
                break
            if ev and ev[0] == "batch":
                # the worker's one-put-per-relay-turn payload: unpack
                # transparently (order preserved) and count it, so the
                # router can surface fleet/relay_batch without touching
                # the wire format
                self.relay_batches += 1
                self.relay_batched_events += len(ev[1])
                events.extend(ev[1])
            else:
                events.append(ev)
        return events

    def wait_ready(self, timeout: float = 300.0) -> dict:
        """Block until the startup handshake (engine built); relays a
        child-side construction error.  Returns (and caches) ``meta``;
        any events read past the handshake are re-deliverable via
        :meth:`poll` order — ready is always the FIRST event, so
        nothing can precede it."""
        if self.meta is not None:
            return self.meta
        try:
            kind, payload = self._evt.get(timeout=timeout)
        except queue_mod.Empty:
            alive = self.alive()
            raise RuntimeError(
                f"replica {self.name}: no ready handshake in "
                f"{timeout:.0f}s (alive={alive}, "
                f"exitcode={self.exitcode})") from None
        if kind == "error":
            raise payload
        if kind != "ready":
            raise RuntimeError(
                f"replica {self.name}: handshake got {kind!r} before "
                "ready")
        self.meta = payload
        return payload

    # ------------------------------------------------------------ teardown

    def close(self, timeout: float = 10.0) -> None:
        """Cooperative stop + escalating reap (idempotent)."""
        if self._closed:
            return
        self._closed = True
        self._finalizer.detach()
        try:
            self._cmd.put_nowait(("stop",))
        except Exception:
            pass
        # drain events so a child blocked on a full pipe can exit
        self.poll()
        from apex_tpu_torch.data._producer import reap_process

        reap_process(self._proc, timeout, what="serving replica")
        for q in (self._cmd, self._evt):
            try:
                # the child is gone: a command its reader never took must
                # not hold the interpreter's exit on the feeder's flush
                q.cancel_join_thread()
                q.close()
            except Exception:
                pass

    def __enter__(self) -> "ReplicaProcess":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
