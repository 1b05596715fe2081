"""Minimal Prometheus scrape endpoint for the process registry
(counterpart of ``repro.obs.http``).

:func:`serve_metrics_http` starts a daemon ``ThreadingHTTPServer`` whose
``/metrics`` route returns ``registry().prometheus_text()``; everything
else is 404. The thread never blocks process exit.
"""
from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from repro_torch.obs.registry import MetricsRegistry, registry

_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def serve_metrics_http(port: int, host: str = "127.0.0.1",
                       reg: Optional[MetricsRegistry] = None
                       ) -> ThreadingHTTPServer:
    """Serve ``/metrics`` on ``host:port`` from a daemon thread.

    Returns the server object (``.server_address`` carries the bound
    port — useful with ``port=0``; call ``.shutdown()`` to stop it).
    """
    the_reg = reg if reg is not None else registry()

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 — http.server API
            if self.path.split("?")[0] not in ("/metrics", "/"):
                self.send_error(404)
                return
            body = the_reg.prometheus_text().encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type", _CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # silence per-request stderr noise
            pass

    server = ThreadingHTTPServer((host, port), _Handler)
    thread = threading.Thread(target=server.serve_forever,
                              name="repro-torch-metrics-http", daemon=True)
    thread.start()
    return server
