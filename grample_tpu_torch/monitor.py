"""Live run monitor: an HTTP endpoint exposing run state as JSON.

The expvar-equivalent of the reference's ``cmd/monitor.go``: a tiny
embedded HTTP server (default ``:8000``) whose ``/debug/vars`` endpoint
returns the live counters — burn-in, window, chain counts, iterations,
runtime, and the last mean/max Hellinger & JSD scores.  The root path
redirects there, matching the reference behavior.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional


class Monitor:
    def __init__(self, addr: str = ":8000"):
        host, _, port = addr.rpartition(":")
        self.host = host or "0.0.0.0"
        self.port = int(port)
        self._lock = threading.Lock()
        self._vars = {
            "burnin": 0,
            "cwin": 0,
            "chains": 0,
            "variants": 0,
            "iterations": 0,
            "runtime": 0.0,
            "maxsecs": 0.0,
            "mean_hellinger": None,
            "max_hellinger": None,
            "mean_js": None,
            "max_js": None,
        }
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def update(self, **kwargs):
        with self._lock:
            self._vars.update(kwargs)

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._vars)

    def start(self):
        monitor = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                if self.path == "/debug/vars":
                    body = json.dumps(monitor.snapshot(), indent=2).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_response(307)
                    self.send_header("Location", "/debug/vars")
                    self.end_headers()

            def log_message(self, *args):  # silence request logging
                pass

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def stop(self, grace: float = 2.0):
        if self._server:
            self._server.shutdown()
            self._thread.join(timeout=grace)
            self._server.server_close()
            self._server = None
