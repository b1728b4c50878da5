"""Koordlet node API server: audit query + metrics + health.

Analog of reference `pkg/koordlet/audit/auditor.go:130-246` (HTTP query with
opaque-token paging, ?size= page control) plus the agent's metrics/healthz
endpoints. Routing core is `handle(path, query)` so tests drive it without
sockets; `serve()` wraps it in a ThreadingHTTPServer.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional, Tuple

from koordinator_tpu_torch.koordlet.audit import Auditor
from koordinator_tpu_torch.obs.server import ObsServer


class KoordletServer:
    def __init__(self, auditor: Auditor, metrics_registry=None, tracer=None):
        self.auditor = auditor
        # /metrics and /traces live on the shared observability routing
        # core (single copy of the registry/tracer state — it already
        # 404s routes whose backend is absent), so all binaries expose
        # the identical formats
        self.obs = ObsServer(metrics_registry, tracer)

    # -- routing core ---------------------------------------------------
    def handle(self, path: str, query: Optional[Dict[str, str]] = None
               ) -> Tuple[int, str, str]:
        """(status, content_type, body)."""
        query = query or {}
        parts = [p for p in path.split("/") if p]
        if parts == ["healthz"]:
            return 200, "text/plain", "ok"
        if parts == ["apis", "v1", "audit"]:
            return self._audit(query)
        if parts == ["metrics"] or parts == ["traces"]:
            return self.obs.handle(path, query)
        return 404, "text/plain", f"unknown path {path!r}"

    def _audit(self, query: Dict[str, str]) -> Tuple[int, str, str]:
        """Token-paged audit events (auditor.go:130-246): ?token=&size=.
        The response carries next_token; an empty page returns the same token
        so pollers can resume."""
        try:
            token = int(query.get("token", "0") or "0")
            size = max(0, min(int(query.get("size", "100") or "100"), 1000))
        except ValueError:
            return 400, "text/plain", "token/size must be integers"
        events, next_token = self.auditor.query(token=token, limit=size)
        body = json.dumps({
            "events": [
                {
                    "seq": e.seq,
                    "timestamp": e.timestamp,
                    "level": e.level,
                    "group": e.group,
                    "operation": e.operation,
                    "detail": e.detail,
                }
                for e in events
            ],
            "next_token": next_token,
        })
        return 200, "application/json", body

    # -- live server ----------------------------------------------------
    def serve(self, port: int = 0):
        """Start the HTTP server; returns (server, thread)."""
        from koordinator_tpu_torch.obs.server import serve_handler

        return serve_handler(self.handle, port)
