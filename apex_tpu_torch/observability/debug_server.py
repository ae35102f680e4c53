"""Live introspection endpoint — ``/metrics`` + ``/statusz`` + ``/healthz``
(port of :mod:`apex_tpu.observability.debug_server`).

Opt-in, stdlib-only (``http.server`` on a daemon thread): a long
training or serving process answers two questions over plain HTTP
without any agent, sidecar, or dependency the container doesn't have:

- ``GET /metrics`` — the :class:`~apex_tpu_torch.observability.metrics.
  MetricRegistry` snapshot in Prometheus text exposition format
  (counters, gauges, histograms as ``_count``/``_sum``/``_min``/
  ``_max``/``quantile`` series), so any standard scraper ingests the
  whole catalog.  Names are sanitized (``serving/ttft_ms`` →
  ``apex_serving_ttft_ms``); every series carries a ``rank`` label so
  multi-host scrapes stay distinguishable (the host-local/global split,
  docs/observability.md).
- ``GET /metrics.prom`` — the same snapshot in strict OpenMetrics 1.0
  text: paired ``# HELP``/``# TYPE`` per family, counter
  samples suffixed ``_total``, terminated by ``# EOF`` — for scrapers
  that negotiate the OpenMetrics content type and reject the laxer
  Prometheus 0.0.4 body.
- ``GET /statusz`` — JSON for a human mid-incident: the flight
  recorder's timeline tail and goodput-so-far, plus the serving
  engine's live state (active slots, free blocks, queue depth,
  draining, MFU or the reason it is undefined) when one is attached.
- ``GET /healthz`` — the ONE health contract the fleet router and any
  external probe share: liveness is answering at all;
  readiness is the body's ``status`` — ``ok`` (HTTP 200) vs
  ``draining``/``down`` (HTTP 503, so a stock HTTP prober needs no
  JSON parsing).  ``draining`` comes from the attached engine's
  ``introspect()``; ``down`` means the engine is attached but its
  introspection raises — the process answers, the runtime inside it is
  broken.

Security model: binds ``127.0.0.1`` by default and serves read-only
snapshots — exposing it beyond the host is the operator's deliberate
choice (``host="0.0.0.0"``).

The server thread only ever *reads* locked snapshots
(``registry.snapshot_typed()``, ``recorder.tail()``/``report()``,
``engine.introspect()``); it can never block or mutate the training
loop — the free-telemetry discipline applied to introspection.
"""

from __future__ import annotations

import json
import logging
import re
import threading
from typing import Optional

__all__ = ["DebugServer", "render_prometheus", "render_openmetrics"]

logger = logging.getLogger(__name__)

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return "apex_" + _NAME_RE.sub("_", name)


def _prom_value(v) -> str:
    if v is None:
        return "NaN"
    return repr(float(v))


def render_prometheus(registry) -> str:
    """Prometheus text exposition of one registry snapshot (the typed
    form — the ``# TYPE`` lines need each metric's kind, which the flat
    ``snapshot()`` erases)."""
    lines = []
    label = f'{{rank="{registry.rank}"}}'
    typed = registry.snapshot_typed()
    counters, gauges, hists = (typed["counters"], typed["gauges"],
                               typed["histograms"])
    for name, value in sorted(counters.items()):
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} counter")
        lines.append(f"{pn}{label} {_prom_value(value)}")
    for name, value in sorted(gauges.items()):
        if value is None:
            continue
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn}{label} {_prom_value(value)}")
    for name, s in sorted(hists.items()):
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} summary")
        lines.append(f"{pn}_count{label} {_prom_value(s['count'])}")
        lines.append(f"{pn}_sum{label} {_prom_value(s['total'])}")
        for key, q in (("p50", "0.5"), ("p99", "0.99")):
            if s.get(key) is not None:
                lines.append(
                    f'{pn}{{rank="{registry.rank}",quantile="{q}"}} '
                    f"{_prom_value(s[key])}")
        for key in ("min", "max", "last"):
            if s.get(key) is not None:
                lines.append(f"{pn}_{key}{label} {_prom_value(s[key])}")
    return "\n".join(lines) + "\n"


def render_openmetrics(registry) -> str:
    """OpenMetrics 1.0 text exposition of one registry snapshot
    — the stricter sibling of
    :func:`render_prometheus` for scrapers that negotiate the
    OpenMetrics content type: every metric family carries a paired
    ``# HELP``/``# TYPE`` preamble, counter *samples* take the
    mandatory ``_total`` suffix (the family name stays suffix-free),
    histograms expose as summaries (``_count``/``_sum`` + ``quantile``
    labels), and the body terminates with the required ``# EOF``.  The
    format-lint test in ``tests/test_slo.py`` parses this line by line
    so the scrape surface cannot silently drift."""
    lines = []
    label = f'{{rank="{registry.rank}"}}'
    typed = registry.snapshot_typed()

    def meta(pn: str, mtype: str, name: str) -> None:
        lines.append(f"# HELP {pn} apex_tpu metric {name}")
        lines.append(f"# TYPE {pn} {mtype}")

    for name, value in sorted(typed["counters"].items()):
        pn = _prom_name(name)
        meta(pn, "counter", name)
        lines.append(f"{pn}_total{label} {_prom_value(value)}")
    for name, value in sorted(typed["gauges"].items()):
        if value is None:
            continue
        pn = _prom_name(name)
        meta(pn, "gauge", name)
        lines.append(f"{pn}{label} {_prom_value(value)}")
    for name, s in sorted(typed["histograms"].items()):
        pn = _prom_name(name)
        meta(pn, "summary", name)
        lines.append(f"{pn}_count{label} {_prom_value(s['count'])}")
        lines.append(f"{pn}_sum{label} {_prom_value(s['total'])}")
        for key, q in (("p50", "0.5"), ("p99", "0.99")):
            if s.get(key) is not None:
                lines.append(
                    f'{pn}{{rank="{registry.rank}",quantile="{q}"}} '
                    f"{_prom_value(s[key])}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


class DebugServer:
    """Background HTTP thread serving ``/metrics`` and ``/statusz``.

    ``port=0`` binds an ephemeral port (resolved on :meth:`start` —
    read ``.port``).  ``recorder``/``engine`` are optional; absent
    sections render as ``null`` in ``/statusz``.  ``engine`` duck-types
    anything with ``introspect() -> dict`` (the serving engine)."""

    def __init__(self, *, registry=None, recorder=None, engine=None,
                 host: str = "127.0.0.1", port: int = 0,
                 tail_events: int = 64):
        if registry is None:
            from apex_tpu_torch.observability.metrics import default_registry

            registry = default_registry()
        self.registry = registry
        self.recorder = recorder
        self.engine = engine
        self.host = host
        self.port = port
        self.tail_events = tail_events
        self._httpd = None
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ payloads

    def metrics_text(self) -> str:
        return render_prometheus(self.registry)

    def metrics_prom_text(self) -> str:
        return render_openmetrics(self.registry)

    def statusz(self) -> dict:
        rec = self.recorder
        if rec is None:
            from apex_tpu_torch.observability import timeline

            rec = timeline.active()
        out = {
            "rank": self.registry.rank,
            "world": self.registry.world,
            "timeline": None,
            "goodput": None,
            "serving": None,
        }
        if rec is not None:
            out["timeline"] = rec.tail(self.tail_events)
            out["goodput"] = rec.report()
        engine = self.engine
        if engine is not None:
            try:
                out["serving"] = engine.introspect()
            except Exception as e:  # introspection must never 500 a scrape
                out["serving"] = {"error": repr(e)}
        return out

    def fleet_statusz(self) -> Optional[dict]:
        """The fleet aggregation plane: when the attached
        engine duck-types ``fleet_statusz()`` (a
        :class:`~apex_tpu_torch.serving.fleet.FleetRouter`), its merged
        heartbeats + per-tenant/per-priority SLO view; ``None`` (a 404)
        otherwise — a plain engine has no fleet to aggregate."""
        engine = self.engine
        fn = getattr(engine, "fleet_statusz", None)
        if fn is None:
            return None
        try:
            return fn()
        except Exception as e:  # aggregation must never 500 a scrape
            return {"error": repr(e)}

    def healthz(self) -> tuple:
        """``(http_code, payload)`` for ``/healthz``: 200 ``ok`` / 503
        ``draining`` / 503 ``down`` — the readiness half of the health
        contract (liveness is the connection succeeding at all; a dead
        process refuses it)."""
        engine = self.engine
        if engine is None:
            # nothing attached: the server answering IS the health fact
            return 200, {"status": "ok", "engine": False}
        try:
            draining = bool(engine.introspect().get("draining"))
        except Exception as e:  # the runtime behind the probe is broken
            return 503, {"status": "down", "engine": True,
                         "error": repr(e)}
        if draining:
            return 503, {"status": "draining", "engine": True}
        return 200, {"status": "ok", "engine": True}

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "DebugServer":
        if self._httpd is not None:
            return self
        import http.server

        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 (stdlib API name)
                try:
                    if self.path.split("?")[0] == "/metrics":
                        self._send(200, server.metrics_text().encode(),
                                   "text/plain; version=0.0.4")
                    elif self.path.split("?")[0] == "/metrics.prom":
                        self._send(200,
                                   server.metrics_prom_text().encode(),
                                   "application/openmetrics-text; "
                                   "version=1.0.0; charset=utf-8")
                    elif self.path.split("?")[0] == "/statusz":
                        self._send(200,
                                   json.dumps(server.statusz(),
                                              default=str).encode(),
                                   "application/json")
                    elif self.path.split("?")[0] == "/fleet/statusz":
                        payload = server.fleet_statusz()
                        if payload is None:
                            self._send(404, b"no fleet attached\n",
                                       "text/plain")
                        else:
                            self._send(200,
                                       json.dumps(payload,
                                                  default=str).encode(),
                                       "application/json")
                    elif self.path.split("?")[0] == "/healthz":
                        code, payload = server.healthz()
                        self._send(code, json.dumps(payload).encode(),
                                   "application/json")
                    elif self.path.split("?")[0] == "/":
                        self._send(200, b"apex_tpu debug server: "
                                   b"/metrics /metrics.prom /statusz "
                                   b"/healthz /fleet/statusz\n",
                                   "text/plain")
                    else:
                        self._send(404, b"not found\n", "text/plain")
                except Exception as e:  # a broken scrape never kills us
                    logger.warning("debug server GET %s failed: %r",
                                   self.path, e)
                    try:
                        self._send(500, repr(e).encode(), "text/plain")
                    except Exception:
                        pass

            def log_message(self, fmt, *args):
                logger.debug("debug server: " + fmt, *args)

        self._httpd = http.server.ThreadingHTTPServer(
            (self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="apex-debug-server",
            daemon=True)
        self._thread.start()
        logger.info("debug server listening on http://%s:%d "
                    "(/metrics, /statusz, /healthz)", self.host, self.port)
        return self

    def url(self, path: str = "/") -> str:
        return f"http://{self.host}:{self.port}{path}"

    def close(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "DebugServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
