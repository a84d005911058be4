"""Prometheus /metrics + /healthz + /slowlog HTTP endpoint (copy of
``jubatus_tpu/utils/metrics_http.py``).

A tiny stdlib ``http.server`` thread each engine server starts when
``--metrics-port`` is given (off by default; ``0`` binds an ephemeral
port — the actual port lands in get_status). Serves:

- ``GET /metrics``  — Prometheus text exposition (0.0.4) of the node's
  tracing Registry (span latency histograms + event counters + runtime
  gauges), with static identity labels (engine, cluster, node). Buckets
  holding a slow-request capture carry an OpenMetrics-style exemplar
  (``# {trace_id="..."} value ts``) linking the spike to a trace.
- ``GET /healthz``  — JSON liveness document from a caller-supplied
  callable (uptime, rpc port, mixer counters, runtime telemetry
  summary, ...). Always 200 while the process serves.
- ``GET /slowlog``  — JSON dump of the registry's slow-request ring
  (utils/slowlog.py): the curl-able twin of the ``get_slow_log`` RPC /
  ``jubadump --slow-log``.

Read-only and unauthenticated, like every Prometheus exporter: bind it to
an internal interface.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

from jubatus_tpu_torch.utils.tracing import Registry

log = logging.getLogger(__name__)

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsServer:
    """Background exposition endpoint over one tracing Registry."""

    def __init__(self, registry: Registry, *,
                 labels: Optional[Dict[str, str]] = None,
                 health_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 host: str = "0.0.0.0", port: int = 0) -> None:
        self.registry = registry
        self.labels = dict(labels or {})
        self.health_fn = health_fn
        self.host = host
        self.port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        """Bind + serve in a daemon thread; returns the bound port."""
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 — stdlib contract
                try:
                    if self.path.split("?", 1)[0] == "/metrics":
                        body = outer.registry.prometheus_text(
                            outer.labels).encode()
                        ctype = PROM_CONTENT_TYPE
                    elif self.path.split("?", 1)[0] == "/healthz":
                        doc: Dict[str, Any] = {"status": "ok"}
                        if outer.health_fn is not None:
                            doc.update(outer.health_fn())
                        body = (json.dumps(doc) + "\n").encode()
                        ctype = "application/json"
                    elif self.path.split("?", 1)[0] == "/slowlog":
                        body = (json.dumps({
                            "stats": outer.registry.slowlog.stats(),
                            "records": outer.registry.slowlog.snapshot(),
                        }) + "\n").encode()
                        ctype = "application/json"
                    else:
                        self.send_error(404)
                        return
                except Exception:  # noqa: BLE001 — a scrape must not 500-loop
                    log.exception("metrics request failed")
                    self.send_error(500)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *_a: Any) -> None:
                pass  # scrapes every few seconds must not spam the log

        # 0.0.0.0 rpc default maps cleanly; the handler threads are daemons
        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.5},
            daemon=True, name="metrics-http")
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
