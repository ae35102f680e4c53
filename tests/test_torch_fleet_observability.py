"""The port's fleet observability against the JAX package's.

The same inputs go through both packages and the outputs are equal: the
JSONL writer and reader (a torn tail included), ``MetricHistory`` over a
fake clock (``export_delta`` and its rebased ingest), ``SLOEvaluator``'s
burn-rate verdicts, ``merge_dir`` (stitch and summary) over spills that
each package's ``FlightRecorder`` wrote from one event script, the
Prometheus and OpenMetrics renderings of equal registries, and a
``DebugServer`` ``/healthz`` GET.  Then every scenario of
``tests/test_slo.py`` and ``tests/test_trace.py`` runs through both
packages with its own asserts, with equal outcomes
(``fleet_twins.py``); the trace report's ``--check`` gate is left out:
it runs the JAX package's ``scripts/trace_report.py``, which the port
has no copy of.
"""

import json
import time
import urllib.request

import pytest

import fleet_twins as tw
from apex_tpu import observability as ref_obs
from apex_tpu.observability import debug_server as ref_debug
from apex_tpu.observability import metrics as ref_metrics
from apex_tpu.observability import timeline as ref_timeline
from apex_tpu_torch import observability as port_obs
from apex_tpu_torch.observability import debug_server as port_debug
from apex_tpu_torch.observability import metrics as port_metrics
from apex_tpu_torch.observability import timeline as port_timeline
from torch_threads import one_torch_thread  # noqa: F401

SIDES = {"ref": (ref_obs, ref_metrics, ref_timeline, ref_debug),
         "port": (port_obs, port_metrics, port_timeline, port_debug)}
RECORDS = [{"step": 1, "loss": 2.5}, {"step": 2, "loss": 2.25, "tag": "x"},
           {"step": 3, "nested": {"a": [1, 2]}}]


def test_jsonl_writer_and_reader_match_with_a_torn_tail(tmp_path):
    """Each package's writer leaves the same bytes; a torn last line is
    dropped by both readers (under ``strict`` too), and a torn interior
    line is skipped by both (refused under ``strict``)."""
    texts = {}
    for side, (obs, *_) in SIDES.items():
        path = tmp_path / f"{side}.jsonl"
        w = obs.JsonlWriter(str(path), fsync=False)
        for r in RECORDS:
            w.write(r)
        texts[side] = path.read_bytes()
        with open(path, "ab") as f:
            f.write(b'{"step": 4, "lo')               # killed mid-write
    assert texts["ref"] == texts["port"]
    for path in (tmp_path / "ref.jsonl", tmp_path / "port.jsonl"):
        assert (port_obs.read_jsonl(str(path))
                == ref_obs.read_jsonl(str(path)) == RECORDS)
        assert (list(port_obs.iter_jsonl(str(path)))
                == list(ref_obs.iter_jsonl(str(path))))
    mid = tmp_path / "mid.jsonl"
    mid.write_bytes(texts["ref"].replace(b'"tag"', b'"ta', 1))
    assert port_obs.read_jsonl(str(mid)) == ref_obs.read_jsonl(str(mid))
    for obs in (ref_obs, port_obs):
        assert obs.read_jsonl(str(tmp_path / "ref.jsonl"),
                              strict=True) == RECORDS
        with pytest.raises(ValueError):
            obs.read_jsonl(str(mid), strict=True)


def _history(side, clock):
    obs, metrics, *_ = SIDES[side]
    reg = metrics.MetricRegistry(rank=0, world=1)
    hist = obs.MetricHistory(reg, clock=clock)
    for i in range(40):
        clock.t = 100.0 + 0.5 * i
        reg.counter("fleet/requests_finished").inc(1 + i % 3)
        reg.gauge("fleet/queue_depth").set(float(i % 7) if i < 30 else 9.0)
        reg.histogram("fleet/ttft_ms").observe(10.0 + (i * 37) % 90)
        hist.record("raw/x", float((i * 13) % 11), now=clock.t)
        hist.sample(clock.t)
    return reg, hist


class _Clock:
    t = 0.0

    def __call__(self):
        return self.t


def test_metric_history_delta_ingest_and_slo_verdicts_match():
    """One scripted registry on a fake clock, sampled by each package's
    ``MetricHistory``: the same series, windows, slopes and compacted
    delta; the delta ingested (rebased) by the other package's history
    reads the same; ``SLOEvaluator`` over both gives the same rows,
    alerts and clears."""
    outs = {}
    for side in SIDES:
        obs = SIDES[side][0]
        clock = _Clock()
        _, hist = _history(side, clock)
        delta = hist.export_delta(clock.t + 5.0)
        sink = obs.MetricHistory(clock=clock)
        merged = sink.ingest_delta(delta, prefix="replica/a/",
                                   now=clock.t + 7.0)
        policies = [obs.SLOPolicy("x", "raw/x", 6.0,
                                  target=0.9, compliance_window_s=20.0,
                                  fast_window_s=2.0, slow_window_s=5.0,
                                  fast_burn=1.5, slow_burn=1.2,
                                  clear_after_s=1.0),
                    obs.SLOPolicy("depth", "fleet/queue_depth", 4.0,
                                  target=0.8, compliance_window_s=20.0,
                                  fast_window_s=1.0, slow_window_s=4.0,
                                  field="max")]
        ev = obs.SLOEvaluator(hist, policies)
        rows = [ev.evaluate(clock.t + dt) for dt in (0.0, 0.5, 3.0, 30.0)]
        outs[side] = {
            "names": hist.series_names(),
            "window": [hist.window(n, 10.0, now=clock.t)
                       for n in hist.series_names()],
            "latest": [hist.latest(n) for n in hist.series_names()],
            "slope": hist.slope("fleet/queue_depth", 10.0, now=clock.t),
            "delta": delta, "merged": merged,
            "sink": [sink.window(n, 30.0, now=clock.t + 7.0)
                     for n in sink.series_names()],
            "rows": rows, "alerts": ev.alerts, "clears": ev.clears,
            "match": [obs.match_series("fleet/*", n)
                      for n in hist.series_names()],
        }
    assert outs["port"] == outs["ref"]
    assert outs["ref"]["merged"] > 0 and outs["ref"]["delta"]["series"]
    assert any(r["alerting"] for rows in outs["ref"]["rows"] for r in rows)


# one request failing over from r0 to r1, on one host clock
SCRIPT = [
    (0.000, "router", "fleet_submit", dict(rid=3, tenant="acme", priority=0,
                                           prompt_tokens=4,
                                           max_new_tokens=8)),
    (0.020, "router", "fleet_dispatch", dict(rid=3, attempt=1, replica="r0",
                                             prior_tokens=0)),
    (0.030, "r0", "request_submit", dict(rid=0, attempt=1)),
    (0.050, "r0", "request_admit", dict(rid=0, attempt=1)),
    (0.100, "r0", "prefill", dict(rids=[0], tokens=4, dur_s=0.04)),
    (0.100, "r0", "request_prefilled", dict(rid=0, attempt=1)),
    (0.300, "r0", "decode_tick", dict(rid=0, tokens=3)),
    (0.550, "router", "fleet_replay", dict(rid=3, replica="r0",
                                           reason="down")),
    (0.600, "router", "fleet_dispatch", dict(rid=3, attempt=2, replica="r1",
                                             prior_tokens=3)),
    (0.620, "r1", "request_submit", dict(rid=0, attempt=2)),
    (0.630, "r1", "request_admit", dict(rid=0, attempt=2)),
    (0.700, "r1", "prefill", dict(rids=[0], tokens=7, dur_s=0.06)),
    (0.700, "r1", "request_prefilled", dict(rid=0, attempt=2)),
    (0.900, "r1", "request_finish", dict(rid=0, tokens=8)),
    (0.920, "router", "fleet_finish", dict(rid=3, tokens=8)),
    (0.950, "router", "slo_burn_alert", dict(policy="ttft",
                                             metric="fleet/ttft_ms:p99",
                                             burn_fast=20.0)),
    (0.960, "router", "slo_state", dict(rows=1)),
]


def _write_spills(side, root, monkeypatch):
    """The script through ``side``'s ``FlightRecorder``s, one a process,
    on a scripted monotonic clock."""
    timeline = SIDES[side][2]
    clock = _Clock()
    clock.t = 1000.0
    monkeypatch.setattr(time, "monotonic", clock)
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    recs = {}
    for pid, (name, role) in enumerate([("router", "router"),
                                        ("r0", "replica"),
                                        ("r1", "replica")], 1):
        recs[name] = timeline.FlightRecorder(
            str(root / f"timeline.{role}.{name}.{pid}.jsonl"),
            meta={"role": role, "name": name, "pid": pid})
    for t, who, kind, fields in SCRIPT:
        clock.t = 1000.0 + t
        fields = dict(fields)
        dur = fields.pop("dur_s", None)
        if "rid" in fields:
            fields["trace_id"] = "feedc0de"
        recs[who].emit(kind, dur_s=dur, **fields)
    monkeypatch.undo()


def test_merge_dir_over_each_packages_spills_matches(tmp_path, monkeypatch):
    """Spills of one event script written by each package's recorder
    are the same bytes, and both packages' ``merge_dir`` (stitch +
    summary) and ``format_trace_report`` read the same attributed
    trace from either."""
    for side in SIDES:
        (tmp_path / side).mkdir()
        _write_spills(side, tmp_path / side, monkeypatch)
    for f in sorted((tmp_path / "ref").iterdir()):
        assert f.read_bytes() == (tmp_path / "port" / f.name).read_bytes()
    reports = [obs.merge_dir(str(tmp_path / d))
               for obs in (ref_obs, port_obs) for d in SIDES]
    assert all(r == reports[0] for r in reports)
    rec = reports[0]["traces"]["feedc0de"]
    assert rec["state"] == "finished" and rec["replicas"] == ["r0", "r1"]
    assert rec["hops"]["failover_replay"] == pytest.approx(0.30)
    assert set(rec["hops"]) == set(port_obs.TRACE_HOP_BUCKETS)
    assert (port_obs.format_trace_report(reports[0])
            == ref_obs.format_trace_report(reports[0]))
    spill = str(tmp_path / "port" / "timeline.router.router.1.jsonl")
    slo = port_obs.collect_slo_events(port_obs.read_jsonl(spill))
    assert slo == ref_obs.collect_slo_events(ref_obs.read_jsonl(spill))
    assert slo["open"] == [("ttft", "fleet/ttft_ms:p99")]
    assert (port_obs.estimate_offset(1.0, 1.5, 7.0)
            == ref_obs.estimate_offset(1.0, 1.5, 7.0))


def _registry(side):
    metrics = SIDES[side][1]
    reg = metrics.MetricRegistry(rank=0, world=1)
    reg.counter("serving/requests_finished").inc(7)
    reg.counter("fleet/kv_migrate_blocks").inc(30)
    reg.gauge("fleet/replicas_live").set(2)
    for v in (3.0, 9.5, 1.25, 40.0, 12.0):
        reg.histogram("fleet/ttft_ms").observe(v)
    return reg


def test_prometheus_and_openmetrics_renderings_match():
    ref, port = _registry("ref"), _registry("port")
    assert (port_obs.render_openmetrics(port)
            == ref_obs.render_openmetrics(ref))
    assert (port_debug.render_prometheus(port)
            == ref_debug.render_prometheus(ref))
    assert port_obs.render_openmetrics(port).endswith("# EOF\n")


class _Engine:
    def __init__(self, draining):
        self.draining = draining

    def introspect(self):
        return {"draining": self.draining, "steps": 3}


@pytest.mark.parametrize("draining", [False, True])
def test_debug_server_healthz_get_matches(draining):
    """``GET /healthz`` of each package's server over the same engine:
    the same status and body (200 ``ok``, or 503 ``draining``)."""
    got = []
    for side in SIDES:
        server = SIDES[side][3].DebugServer(
            registry=_registry(side), engine=_Engine(draining)).start()
        try:
            url = f"http://127.0.0.1:{server.port}/healthz"
            try:
                with urllib.request.urlopen(url, timeout=10) as r:
                    got.append((r.status, json.loads(r.read())))
            except urllib.error.HTTPError as e:
                got.append((e.code, json.loads(e.read())))
        finally:
            server.close()
    assert got[0] == got[1]
    assert got[0][0] == (503 if draining else 200)


@pytest.mark.parametrize("case", tw.cases("test_slo"))
def test_slo_scenario_matches_reference(case, tmp_path):
    tw.assert_same("test_slo", case, tmp_path)


@pytest.mark.parametrize("case", tw.cases(
    "test_trace", skip={"test_trace_report_check_gate":
                        "runs the JAX package's scripts/trace_report.py"}))
def test_trace_scenario_matches_reference(case, tmp_path):
    tw.assert_same("test_trace", case, tmp_path)
