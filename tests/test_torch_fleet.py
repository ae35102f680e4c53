"""The port's fleet router against the JAX package's, and real replicas.

Every scenario of ``tests/test_fleet.py`` (round trip, batched submit,
eos, failover kill-at-k, missed heartbeat backoff then DOWN, shed on
overload, replica-level reject, context-capped replay, poison-request
cap, priority and tenant fairness, free-block dispatch, rollout,
sampling over the wire, sampled failover, affinity, the stream iterator,
the disaggregated handoff, adapters) runs through
``apex_tpu.serving.fleet.FleetRouter`` and through
``apex_tpu_torch.serving.fleet.FleetRouter`` over the same fakes, with
its own asserts on each side, and the two give equal outcomes: each
request's state, tokens, replays, reschedules and replica, the dispatch
order on every fake, and the router's counters (``fleet_twins.py``).

Then the port's fleet with real processes on the CPU, once per module:
two ``ReplicaProcess`` children over ``mp.Queue`` and one prefill/decode
pair of ``start_replica_server`` daemons over ``SocketTransport``, a
2-layer hidden-64 GPT from seeded weights.  A wave, a kill at k = 2 with
replay, and a KV migration in fp32 (over the queues) and in bf16 (over
the socket, the slabs as ``uint16`` views) each give the streams of an
in-process engine on the same weights; no torch tensor crosses either
transport.  The wire form itself round-trips an exported run bit for bit
in bf16, fp32 and int8 (with its scales).
"""

import contextlib
import pathlib
import re
import time

import numpy as np
import pytest
import torch

import fleet_twins as tw
from apex_tpu_torch.observability.metrics import MetricRegistry
from apex_tpu_torch.serving import (
    FleetRouter,
    ReplicaProcess,
    ReplicaSpec,
    ServingConfig,
    SocketTransport,
    start_replica_server,
)
from apex_tpu_torch.serving.replica import _build_engine, wire_submit_item
from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
    TransformerConfig,
)
from torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("case", tw.cases("test_fleet"))
def test_router_scenario_matches_reference(case, tmp_path):
    tw.assert_same("test_fleet", case, tmp_path)


def test_fleet_modules_import_no_jax():
    """The fleet's modules (and every module of the port) name neither
    ``jax`` nor the JAX package in an import."""
    bad = []
    pat = re.compile(r"^\s*(?:import|from)\s+(jax|apex_tpu)\b(?!_torch)")
    for path in sorted((REPO / "apex_tpu_torch").rglob("*.py")):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if pat.match(line):
                bad.append(f"{path.relative_to(REPO)}:{i}: {line.strip()}")
    assert not bad, bad
    for name in ("serving/replica.py", "serving/transport.py",
                 "serving/fleet.py", "serving/autopilot.py",
                 "observability/writers.py", "observability/timeseries.py",
                 "observability/slo.py", "observability/trace.py",
                 "observability/debug_server.py", "testing/faults.py",
                 "data/_producer.py"):
        assert (REPO / "apex_tpu_torch" / name).is_file(), name


# ------------------------------------------------------- real processes

GPT = dict(hidden_size=64, num_layers=2, num_attention_heads=4,
           padded_vocab_size=128, max_position_embeddings=64)
SHAPE = dict(max_batch=4, block_size=4, max_seq=48, prefill_len=8)
SEED = 7
# (prompt, new tokens): every replica batches a different subset
WAVE = [([5, 9, 2, 7], 10), ([3, 3, 8], 10), ([1, 4, 1, 5, 9, 2, 6], 10),
        ([11, 12], 10), ([7, 7, 7, 7, 7], 10), ([2, 71, 82, 81, 8], 10)]


def _spec(cache_dtype=None, role="both", device="cpu"):
    return ReplicaSpec(
        config=TransformerConfig(**GPT),
        serving=ServingConfig(**SHAPE, cache_dtype=cache_dtype),
        seed=SEED, role=role, device=device, debug_server=False,
        heartbeat_every_s=0.02, idle_sleep_s=0.002)


@contextlib.contextmanager
def _one_thread():
    """One torch thread, as the CPU replicas run (their GEMMs then sum in
    the same order), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _reference(cache_dtype, items):
    """The streams of an in-process engine on the replicas' weights."""
    with _one_thread():
        engine, _ = _build_engine(_spec(cache_dtype), MetricRegistry(), None)
        reqs = [engine.submit(p, n) for p, n in items]
        engine.run_until_drained()
    return [r.output_tokens for r in reqs]


def _tensors(x):
    """Every torch tensor inside a nested event."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _tee(client, log):
    """Record every event the router polls from ``client``."""
    poll = client.poll

    def tee():
        events = poll()
        log.extend(events)
        return events
    client.poll = tee
    return client


def _pump(router, until, *, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not until():
        router.pump()
        assert time.monotonic() < deadline, "fleet did not settle"
        time.sleep(0.002)


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "float32", "int8"])
def test_kv_wire_form_round_trips_bit_for_bit(cache_dtype):
    """An exported run through the replica's wire form (numpy slabs, bf16
    as ``uint16``, int8 with its fp32 scales) and a pickle, back into
    another engine: the slabs bit for bit, and the continued stream the
    uninterrupted engine's."""
    import pickle

    from apex_tpu_torch.serving.replica import _kv_from_wire, _kv_to_wire

    dtype = getattr(torch, cache_dtype)
    prompt, n_new = [4, 8, 15, 16, 23, 42, 7, 1, 2], 10
    want = _reference(dtype, [(prompt, n_new)])[0]
    with _one_thread():
        src, _ = _build_engine(_spec(dtype), MetricRegistry(), None)
        dst, _ = _build_engine(_spec(dtype), MetricRegistry(), None)
        req = src.submit(prompt, n_new)
        while len(req.output_tokens) < 3:
            src.step()
        meta, payloads = src.export_request(req)
    wire = pickle.loads(pickle.dumps([_kv_to_wire(p) for p in payloads]))
    names = wire[0][1]
    assert names == [cache_dtype] * 2 + (["float32"] * 2
                                         if cache_dtype == "int8" else [])
    assert all(isinstance(a, np.ndarray) and a.dtype == np.dtype(
        "uint16" if cache_dtype == "bfloat16" else cache_dtype if i < 2
        else "float32") for slabs, _ in wire for i, a in enumerate(slabs))
    back = [_kv_from_wire(slabs, names) for slabs, _ in wire]
    for got, sent in zip(back, payloads):
        assert all(g.dtype == t.dtype and torch.equal(g, t)
                   for g, t in zip(got, sent))
    with _one_thread():
        moved = dst.import_request(prompt + req.output_tokens,
                                   n_new - meta["n_out"],
                                   cache_len=meta["cache_len"], payloads=back)
        dst.run_until_drained()
    assert req.output_tokens + moved.output_tokens == want


@pytest.fixture(scope="module")
def fleet():
    """Two queue replicas (fp32), a prefill/decode socket pair (bf16
    cache) and, without a card, a replica whose spec asks for ``cuda``;
    started together, reaped at the end."""
    events = []
    procs = [ReplicaProcess(_spec(), f"q{i}") for i in range(2)]
    nocard = (ReplicaProcess(_spec(device=None), "nocard")
              if not torch.cuda.is_available() else None)
    servers = [start_replica_server(_spec(torch.bfloat16, role=role), role)
               for role in ("prefill", "decode")]
    try:
        for p in procs:
            p.wait_ready(timeout=120)
            _tee(p, events)
        clients = [_tee(SocketTransport(role, addr, backoff_initial_s=0.01,
                                        ping_every_s=0.05), events)
                   for role, (_, addr) in zip(("prefill", "decode"),
                                              servers)]
        for c in clients:
            c.wait_ready(timeout=120)
        yield dict(procs=procs, nocard=nocard, clients=clients,
                   events=events)
    finally:
        for p in procs + ([nocard] if nocard else []):
            p.close(timeout=5.0)
        for proc, _ in servers:
            proc.terminate()
            proc.join(5.0)
            if proc.is_alive():
                proc.kill()
                proc.join(5.0)


def test_wave_over_replica_processes_matches_engine(fleet):
    """A staggered-free wave through ``FleetRouter`` over two spawned
    replicas: every request finishes with the in-process engine's fp32
    stream, and both replicas took work."""
    want = _reference(None, WAVE)
    router = FleetRouter(fleet["procs"], registry=MetricRegistry())
    reqs = [router.submit(p, n) for p, n in WAVE]
    _pump(router, router.idle)
    assert [r.state.value for r in reqs] == ["finished"] * len(WAVE)
    assert [r.output_tokens for r in reqs] == want
    assert {r.replica for r in reqs} == {"q0", "q1"}
    assert router.registry.snapshot()["fleet/requests_finished"] == len(WAVE)


def test_fp32_kv_migration_over_queues_continues_the_stream(fleet):
    """The replica protocol's migration between the two queue replicas:
    ``export_kv`` on one, its ``kv_meta`` and numpy ``kv_block``s into
    ``import_kv`` → ``kv_block`` × N → ``import_commit`` on the other,
    which continues the stream bit for bit."""
    src, dst = fleet["procs"]
    prompt, n_new = [4, 8, 15, 16, 23, 42, 7, 1, 2], 12
    want = _reference(None, [(prompt, n_new)])[0]
    got, blocks, meta = [], {}, {}
    src.submit("m", prompt, n_new)

    def drain(client, stop):
        deadline = time.monotonic() + 60
        while not stop():
            for ev in client.poll():
                if ev[0] == "token":
                    got.append(ev[2])
                elif ev[0] == "kv_meta":
                    meta.update(ev[2])
                elif ev[0] == "kv_block":
                    blocks[ev[2]] = ev[3]
                elif ev[0] in ("kv_export_done", "kv_imported", "finished",
                               "kv_export_failed"):
                    meta[ev[0]] = ev
                assert ev[0] != "error", ev
            assert time.monotonic() < deadline
            time.sleep(0.002)

    drain(src, lambda: len(got) >= 3)
    src.export_kv("m")
    drain(src, lambda: "kv_export_done" in meta or "kv_export_failed" in meta)
    assert "kv_export_done" in meta, meta
    assert meta["slab_dtypes"] == ["float32", "float32"]
    assert len(blocks) == meta["n_blocks"]
    assert all(isinstance(a, np.ndarray) and a.dtype == np.float32
               for b in blocks.values() for a in b)
    emitted = list(got)
    dst.import_kv("m", meta)
    for i in range(meta["n_blocks"]):
        dst.kv_block("m", i, blocks[i])
    dst.import_commit("m", ("m", prompt + emitted, n_new - len(emitted),
                            None, None), meta["n_blocks"])
    drain(dst, lambda: "finished" in meta)
    assert meta["kv_imported"][2] is True
    src.kv_ack("m", True)
    assert got == want
    assert wire_submit_item(("m", prompt, 3, None, None))[5] is None


def test_kill_at_k_replays_on_the_survivor(fleet):
    """SIGKILL the replica serving a request after its second relayed
    token: the router marks it down and replays the rest on the
    survivor, and the stitched stream is the uninterrupted one."""
    prompt, n_new = [9, 1, 4, 12, 30], 12
    want = _reference(None, [(prompt, n_new)])[0]
    router = FleetRouter(fleet["procs"], registry=MetricRegistry(),
                         heartbeat_timeout_s=5.0)
    req = router.submit(prompt, n_new)
    _pump(router, lambda: len(req.output_tokens) >= 2)
    victim = next(p for p in fleet["procs"] if p.name == req.replica)
    victim.kill()
    _pump(router, router.idle)
    assert req.state.value == "finished"
    assert req.output_tokens == want
    assert req.replays == 1 and req.replica != victim.name
    assert router._views[victim.name].down


def test_bf16_kv_migration_over_the_socket(fleet):
    """A prefill/decode pair over ``SocketTransport``: each request's KV
    migrates (``kv_meta``, ``kv_block`` × N, commit) and the decode
    replica continues its stream as the in-process engine with a bf16
    cache serves it; the bf16 slabs cross as ``uint16`` views."""
    items = WAVE[:3]
    want = _reference(torch.bfloat16, items)
    seen = len(fleet["events"])
    router = FleetRouter(fleet["clients"], registry=MetricRegistry())
    reqs = [router.submit(p, n) for p, n in items]
    _pump(router, router.idle)
    assert [r.state.value for r in reqs] == ["finished"] * len(items)
    assert [r.output_tokens for r in reqs] == want
    snap = router.registry.snapshot()
    assert snap["fleet/kv_migrate_completed"] == len(items)
    assert snap.get("fleet/kv_migrate_failed", 0) == 0
    assert all(r.replica == "decode" for r in reqs)
    new = fleet["events"][seen:]
    metas = [ev[2] for ev in new if ev[0] == "kv_meta"]
    slabs = [a for ev in new if ev[0] == "kv_block" for a in ev[3]]
    assert len(metas) == len(items) and slabs
    assert all(m["slab_dtypes"] == ["bfloat16", "bfloat16"] for m in metas)
    assert all(a.dtype == np.uint16 for a in slabs)
    router.close()


def test_no_torch_tensor_crosses_either_transport(fleet):
    """Every event the routers polled from the queue replicas and the
    socket pair, KV blocks and heartbeats included, is numpy and plain
    Python."""
    events = fleet["events"]
    kinds = {ev[0] for ev in events}
    assert {"state", "token", "kv_block", "kv_meta"} <= kinds
    assert not [ev[0] for ev in events if _tensors(ev)]


def test_replica_asking_for_cuda_without_a_card_raises(fleet):
    """A spec whose device is ``cuda`` (``None``) on a machine without a
    card: the child raises instead of serving on the CPU, and the
    handshake relays the error."""
    if fleet["nocard"] is None:
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet["nocard"].wait_ready(timeout=120)


def test_fork_with_a_cuda_spec_raises():
    """``fork`` cannot give a child a usable CUDA context: both spawners
    refuse it for a ``cuda`` spec before starting anything."""
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(ValueError, match="fork"):
            ReplicaProcess(_spec(device=device), "f", start_method="fork")
        with pytest.raises(ValueError, match="fork"):
            start_replica_server(_spec(device=device), "f",
                                 start_method="fork")
