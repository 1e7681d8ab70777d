"""Live introspection: a loopback HTTP JSON endpoint on QueryService
(port of ``spark_rapids_tpu/service/introspect.py``).

The reference plugin surfaces its metrics into the Spark UI; this
engine has no UI process, so the serving layer exposes the same live
surface as machine-readable JSON on a 127.0.0.1-only socket
(``spark.rapids.service.introspect.enabled`` / ``.port`` — port 0
binds an ephemeral port, reported as ``QueryService.introspect_port``).
``python -m spark_rapids_tpu_torch.tools top`` polls and renders it.

Routes (all GET, all JSON):

* ``/health``     — ``QueryService.health()`` (the device's state, the
  ladder counters, the quarantine; the mesh and host sections idle);
* ``/topology``   — the consistent topology snapshot (health, memory
  and quarantine under their locks at once, runtime/health.py);
* ``/stats``      — ``QueryService.stats()`` (lifecycle counters, WFQ
  clocks, result-cache stats);
* ``/slo``        — rolling per-pool / per-tenant p50/p95 latency and
  run-time percentiles over recently FINISHED handles;
* ``/queries``    — the live query table (running + queued handles);
* ``/streams``    — the recurring streams (none until [12b] streaming);
* ``/telemetry``  — the telemetry ring tail (``?n=`` bounds it);
* ``/top``        — all of the above in one document (what the CLI
  polls — one round trip per refresh).

Every handler reads a snapshot surface that bounds its own lock hold;
the server thread can therefore never wedge a query. Loopback-only by
construction (the bind address is hardcoded): this is an operator
surface, not a network service."""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse


def _routes(service, path: str, query: dict) -> Optional[dict]:
    """Resolve one GET path to its JSON document (None = 404)."""
    from spark_rapids_tpu_torch.obs.telemetry import TELEMETRY
    if path in ("/", "/top"):
        return {
            "health": service.health(),
            "stats": service.stats(),
            "slo": service.slo_snapshot(),
            "queries": service.query_table(),
            "streams": service.streams(),
            "telemetry": {
                "sampler": TELEMETRY.stats(),
                "tail": TELEMETRY.tail(
                    int(query.get("n", ["5"])[0])),
            },
        }
    if path == "/health":
        return service.health()
    if path == "/topology":
        return service.topology_snapshot()
    if path == "/stats":
        return service.stats()
    if path == "/slo":
        return service.slo_snapshot()
    if path == "/queries":
        return {"queries": service.query_table()}
    if path == "/streams":
        return {"streams": service.streams()}
    if path == "/telemetry":
        n = query.get("n")
        return {
            "sampler": TELEMETRY.stats(),
            "tail": TELEMETRY.tail(int(n[0]) if n else None),
        }
    return None


class IntrospectionServer:
    """Daemon HTTP server bound to 127.0.0.1 serving one
    QueryService's live surface. Constructed by the service when
    ``spark.rapids.service.introspect.enabled`` is set; ``port`` is
    the bound port (useful with the ephemeral default of 0)."""

    def __init__(self, service, port: int = 0):
        svc = service

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # silence per-request stderr
                pass

            def do_GET(self):
                parsed = urlparse(self.path)
                try:
                    doc = _routes(svc, parsed.path,
                                  parse_qs(parsed.query))
                    status = 200 if doc is not None else 404
                    if doc is None:
                        doc = {"error": f"no route {parsed.path!r}",
                               "routes": ["/top", "/health",
                                          "/topology", "/stats",
                                          "/slo", "/queries",
                                          "/streams", "/telemetry"]}
                except Exception as exc:  # surface, never crash the srv
                    status, doc = 500, {
                        "error": f"{type(exc).__name__}: {exc}"}
                body = json.dumps(doc, sort_keys=True).encode("utf-8")
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", int(port)),
                                          _Handler)
        self._httpd.daemon_threads = True
        self.port: int = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="rapids-svc-introspect", daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def shutdown(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except OSError:
            pass
        self._thread.join(timeout=5)
