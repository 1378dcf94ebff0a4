"""HTTP metrics exporter: a stdlib ``http.server`` running in a
daemon thread so any process — the serving daemon, a benchmark, a notebook —
can expose its registry to a Prometheus scraper with two lines:

    exporter = MetricsExporter(port=9100)   # port=0 → ephemeral
    port = exporter.start()

Endpoints:
  GET /metrics          Prometheus text exposition (registry.to_prometheus())
  GET /metrics.json     registry snapshot as JSON
  GET /healthz          200 {"status": "ok", "uptime_s": ...}
  GET /debug/telemetry  latest RollingWindow snapshot (404 without a window)
  POST /reload          invoke the attached ``reload_hook`` (the serving
                        daemon wires its predictor hot-reload here);
                        404 without a hook, 500 with the error if it raises

No third-party dependencies: ``ThreadingHTTPServer`` + daemon threads means
scrapes never block search, and a hung scraper can't wedge shutdown.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from repro_torch.obs.registry import MetricsRegistry, get_registry
from repro_torch.obs.window import RollingWindow

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsExporter:
    """Serve a registry (and optionally a rolling window) over HTTP."""

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        *,
        window: Optional[RollingWindow] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        reload_hook: Optional[Callable[[], object]] = None,
    ):
        self.registry = registry if registry is not None else get_registry()
        self.window = window
        # POST /reload target: a zero-arg callable whose (json-able) return
        # value is echoed in the response body — e.g. the daemon's
        # reload_predictor().  Settable after construction too.
        self.reload_hook = reload_hook
        self.host = host
        self.port = port
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._t_start = 0.0

    # ------------------------------------------------------------- lifecycle
    def start(self) -> int:
        """Bind and serve in a daemon thread; returns the bound port."""
        if self._server is not None:
            return self.port
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            # scrapes are high-frequency; keep stderr quiet
            def log_message(self, fmt, *args):
                pass

            def do_GET(self):
                try:
                    exporter._route(self)
                except BrokenPipeError:
                    pass  # scraper went away mid-response

            def do_POST(self):
                try:
                    exporter._route_post(self)
                except BrokenPipeError:
                    pass

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._t_start = time.time()
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name=f"metrics-exporter:{self.port}",
            daemon=True,
        )
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._server is None:
            return
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._server = None
        self._thread = None

    @property
    def running(self) -> bool:
        return self._server is not None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def __enter__(self) -> "MetricsExporter":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # --------------------------------------------------------------- routing
    def _route(self, h: BaseHTTPRequestHandler) -> None:
        path = h.path.split("?", 1)[0]
        if path == "/metrics":
            _reply(h, 200, self.registry.to_prometheus(), PROM_CONTENT_TYPE)
        elif path == "/metrics.json":
            _reply(h, 200, self.registry.to_json(indent=1),
                   "application/json")
        elif path == "/healthz":
            body = json.dumps(
                {"status": "ok", "uptime_s": time.time() - self._t_start}
            )
            _reply(h, 200, body, "application/json")
        elif path == "/debug/telemetry":
            if self.window is None:
                _reply(h, 404, '{"error": "no rolling window attached"}',
                       "application/json")
            else:
                _reply(h, 200, json.dumps(self.window.snapshot(), indent=1),
                       "application/json")
        else:
            _reply(h, 404, '{"error": "not found", "endpoints": '
                   '["/metrics", "/metrics.json", "/healthz", '
                   '"/debug/telemetry", "POST /reload"]}', "application/json")

    def _route_post(self, h: BaseHTTPRequestHandler) -> None:
        path = h.path.split("?", 1)[0]
        if path != "/reload":
            _reply(h, 404, '{"error": "not found", "endpoints": '
                   '["POST /reload"]}', "application/json")
            return
        hook = self.reload_hook
        if hook is None:
            _reply(h, 404, '{"error": "no reload hook attached"}',
                   "application/json")
            return
        try:
            result = hook()
        except Exception as e:  # hook failure must not kill the server
            _reply(h, 500, json.dumps(
                {"status": "error", "error": f"{type(e).__name__}: {e}"}
            ), "application/json")
            return
        try:
            body = json.dumps({"status": "ok", "result": result})
        except TypeError:
            body = json.dumps({"status": "ok", "result": str(result)})
        _reply(h, 200, body, "application/json")


def _reply(h: BaseHTTPRequestHandler, code: int, body: str,
           content_type: str) -> None:
    data = body.encode("utf-8")
    h.send_response(code)
    h.send_header("Content-Type", content_type)
    h.send_header("Content-Length", str(len(data)))
    h.end_headers()
    h.wfile.write(data)
