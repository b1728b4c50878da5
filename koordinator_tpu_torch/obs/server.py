"""Shared /metrics + /traces + /healthz (+ koordexplain) surface.

The koordlet API server (`koordlet/server.py`) established the pattern:
a socket-free routing core `handle(path, query) -> (status, content_type,
body)` that tests drive directly, wrapped by `serve()` in a
ThreadingHTTPServer for live use. This module extracts that pattern so the
scheduler and descheduler expose the exact same Prometheus exposition
format (and JSONL trace dumps) as the node agent — one scrape config for
the whole deployment.

A copy of the JAX package's obs/server.py, which imports no JAX.

koordexplain adds the decision surfaces: ``/explain?pod=<key>``
answers "why this node / why not at all" from the scheduler's latest
attribution, and ``/debug/flightrecorder`` serves the cycle flight
recorder (GET = status, POST = dump the ring as a JSONL bundle).
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse


def serve_handler(handle, port: int = 0):
    """Wrap a `(path, query[, method]) -> (status, content_type, body)`
    routing core in a ThreadingHTTPServer on 127.0.0.1; returns
    (server, thread). The one HTTP wrapper every handler-pattern server
    shares (ObsServer, KoordletServer) — fix transport behavior here, not
    per server. Handlers that accept a ``method`` parameter also receive
    POSTs; two-argument handlers stay GET-only (POST returns 405)."""
    import inspect
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    try:
        accepts_method = "method" in inspect.signature(handle).parameters
    except (TypeError, ValueError):
        accepts_method = False

    class Handler(BaseHTTPRequestHandler):
        def _route(self, method: str):
            url = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(url.query).items()}
            if accepts_method:
                status, ctype, body = handle(url.path, q, method)
            elif method == "GET":
                status, ctype, body = handle(url.path, q)
            else:
                status, ctype, body = 405, "text/plain", "method not allowed"
            payload = body.encode()
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):  # noqa: N802 (stdlib API)
            self._route("GET")

        def do_POST(self):  # noqa: N802 (stdlib API)
            self._route("POST")

        def log_message(self, fmt, *args):  # silence
            pass

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


class ObsServer:
    """Routing core for the observability endpoints.

    * ``/healthz`` — liveness; with a ``health_provider`` the body is its
      JSON payload (the scheduler reports last-completed-cycle age + wave
      count — a stale-cycle signal instead of a bare 200), else "ok"
    * ``/metrics`` — Prometheus text exposition from the given Registry
    * ``/traces``  — the tracer ring as JSONL (``?limit=N`` newest roots),
      replayable with ``python -m koordinator_tpu_torch.obs``
    * ``/explain?pod=<key>`` — the pod's latest decision attribution
      (``explain_provider``: pod key -> record dict or None)
    * ``/debug/flightrecorder`` — GET: ring status; POST: dump the ring as
      a JSONL bundle (``flight``: an obs.flight.FlightRecorder)
    * ``/debug/timeline`` — the koordwatch device-window ring as a JSONL
      bundle (``timeline``: an obs.timeline.DeviceTimeline), replayable
      with ``python -m koordinator_tpu_torch.obs timeline``
    * ``/debug/slo`` — the koordwatch SLO registry as a JSONL bundle
      (``slo``: an obs.slo.SloRegistry)
    """

    def __init__(self, metrics_registry=None, tracer=None,
                 health_provider=None, explain_provider=None, flight=None,
                 timeline=None, slo=None):
        self.metrics_registry = metrics_registry
        self.tracer = tracer
        self.health_provider = health_provider
        self.explain_provider = explain_provider
        self.flight = flight
        self.timeline = timeline
        self.slo = slo

    def handle(self, path: str, query: Optional[Dict[str, str]] = None,
               method: str = "GET") -> Tuple[int, str, str]:
        """(status, content_type, body)."""
        query = query or {}
        parts = [p for p in path.split("/") if p]
        if parts == ["healthz"]:
            if self.health_provider is not None:
                return (200, "application/json",
                        json.dumps(self.health_provider(), sort_keys=True))
            return 200, "text/plain", "ok"
        if parts == ["metrics"] and self.metrics_registry is not None:
            return (200, "text/plain; version=0.0.4",
                    self.metrics_registry.expose())
        if parts == ["traces"] and self.tracer is not None:
            raw = query.get("limit")
            if raw is None or raw == "":
                limit = None  # absent: the whole ring
            else:
                try:
                    limit = int(raw)
                except ValueError:
                    return 400, "text/plain", "limit must be an integer"
                if limit < 0:
                    return 400, "text/plain", "limit must be non-negative"
            body = self.tracer.export_jsonl(limit=limit)
            return 200, "application/x-ndjson", body
        if parts == ["explain"] and self.explain_provider is not None:
            pod = query.get("pod")
            if not pod:
                return (400, "text/plain",
                        "missing ?pod=<namespace/name> parameter")
            record = self.explain_provider(pod)
            if record is None:
                return (404, "application/json", json.dumps({
                    "pod": pod,
                    "error": "no decision recorded for this pod (not "
                             "scheduled since explain was enabled, or "
                             "KOORD_TPU_EXPLAIN is off)",
                }, sort_keys=True))
            return (200, "application/json",
                    json.dumps({"pod": pod, **record}, sort_keys=True))
        if parts == ["debug", "timeline"] and self.timeline is not None:
            return (200, "application/x-ndjson",
                    self.timeline.export_jsonl())
        if parts == ["debug", "slo"] and self.slo is not None:
            return (200, "application/x-ndjson", self.slo.export_jsonl())
        if parts == ["debug", "flightrecorder"] and self.flight is not None:
            if method == "POST":
                return (200, "application/x-ndjson",
                        self.flight.dump("http"))
            return (200, "application/json",
                    json.dumps(self.flight.status(), sort_keys=True))
        return 404, "text/plain", f"unknown path {path!r}"

    def serve(self, port: int = 0):
        """Start the HTTP server; returns (server, thread)."""
        return serve_handler(self.handle, port)
