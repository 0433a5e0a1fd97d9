"""Dashboard: a web page over the evaluation history (the port of
``predictionio_tpu/server/dashboard.py``).

``GET /`` lists the EVALCOMPLETED evaluation instances, newest first,
with links to each one's
``/engine_instances/{id}/evaluator_results.{txt,html,json}`` (the
one-liner, HTML and JSON that ``pio eval`` recorded); the JSON is also
served CORS-enabled as ``local_evaluator_results.json``. With an
``accesskey`` the first request authenticates with it and gets an
HttpOnly session cookie, so the page's links never carry the key. The
page ends with the request-latency percentiles of this server's own
``pio_http_request_duration_seconds``; the telemetry mount
(``server/http.py::mount_metrics``) adds ``GET /metrics``,
``/metrics.json``, ``/trace.json`` and ``/status.json``.
"""

from __future__ import annotations

import html as _html
from typing import Optional

from ..data.event import utcnow
from ..data.storage.registry import Storage, get_storage
from ..obs import MetricsRegistry
from .http import (
    AppServer,
    HTTPApp,
    Request,
    Response,
    SessionAuth,
    mount_metrics,
)


def build_app(storage: Optional[Storage] = None,
              accesskey: Optional[str] = None,
              secure: bool = False) -> HTTPApp:
    app = HTTPApp("dashboard")
    start_time = utcnow()
    registry = MetricsRegistry()
    mount_metrics(app, registry, server_name="dashboard",
                  status=lambda: {"status": "alive"})
    app.metrics_registry = registry  # type: ignore[attr-defined]

    def st() -> Storage:
        return storage if storage is not None else get_storage()

    _session = SessionAuth(accesskey, secure=secure)

    def _auth(req: Request) -> dict:
        """Authorize; the response headers (``Set-Cookie`` on the first
        key-authenticated request) every outcome carries, 404s too."""
        set_cookie = _session(req)
        return {"Set-Cookie": set_cookie} if set_cookie else {}

    def _latency_table() -> str:
        """Request-latency percentiles by route, from this server's own
        registry."""
        hist = registry.snapshot().get(
            "pio_http_request_duration_seconds") or {}
        if isinstance(hist, dict) and "count" in hist:
            hist = {"(all)": hist}
        rows = [f"<tr><td>{_html.escape(str(route))}</td>"
                f"<td>{s['count']}</td>"
                f"<td>{s['p50'] * 1000:.3f}</td>"
                f"<td>{s['p90'] * 1000:.3f}</td>"
                f"<td>{s['p99'] * 1000:.3f}</td></tr>"
                for route, s in sorted(hist.items())
                if isinstance(s, dict) and s.get("count")]
        if not rows:
            return ""
        return ("<h2>Request latency percentiles</h2>"
                "<table border='1'><tr><th>route</th><th>count</th>"
                "<th>p50 (ms)</th><th>p90 (ms)</th><th>p99 (ms)</th></tr>"
                + "".join(rows) + "</table>"
                "<p><a href='/metrics'>Prometheus metrics</a></p>")

    @app.route("GET", "/")
    def index(req: Request) -> Response:
        headers = _auth(req)
        esc = _html.escape
        rows = []
        for i in st().evaluation_instances().get_completed():
            rows.append(
                f"<tr><td>{esc(i.id)}</td>"
                f"<td>{esc(str(i.start_time))}</td>"
                f"<td>{esc(str(i.end_time))}</td>"
                f"<td>{esc(i.evaluation_class)}</td>"
                f"<td>{esc(i.evaluator_results)}</td>"
                f"<td><a href='/engine_instances/{esc(i.id)}/"
                f"evaluator_results.html'>HTML</a> "
                f"<a href='/engine_instances/{esc(i.id)}/"
                f"evaluator_results.json'>JSON</a> "
                f"<a href='/engine_instances/{esc(i.id)}/"
                f"evaluator_results.txt'>TXT</a></td></tr>")
        body = (
            "<html><head><title>PredictionIO-TPU Dashboard</title></head>"
            f"<body><h1>Evaluation history</h1>"
            f"<p>Dashboard up since {start_time}</p>"
            "<table border='1'><tr><th>ID</th><th>Start</th><th>End</th>"
            "<th>Evaluation</th><th>Result</th><th>Details</th></tr>"
            + "".join(rows) + "</table>" + _latency_table()
            + "</body></html>")
        return Response(status=200, body=body,
                        content_type="text/html; charset=utf-8",
                        headers=headers)

    def _instance(req: Request):
        return st().evaluation_instances().get(req.path_params["iid"])

    def _result(req: Request, field: str, content_type: str) -> Response:
        headers = _auth(req)
        i = _instance(req)
        if i is None:
            return Response(status=404, body={"message": "Not Found"},
                            headers=headers)
        return Response(status=200, body=getattr(i, field),
                        content_type=content_type, headers=headers)

    @app.route("GET", r"/engine_instances/(?P<iid>[^/]+)/"
                      r"evaluator_results\.txt")
    def results_txt(req: Request) -> Response:
        return _result(req, "evaluator_results",
                       "text/plain; charset=utf-8")

    @app.route("GET", r"/engine_instances/(?P<iid>[^/]+)/"
                      r"evaluator_results\.html")
    def results_html(req: Request) -> Response:
        return _result(req, "evaluator_results_html",
                       "text/html; charset=utf-8")

    @app.route("GET", r"/engine_instances/(?P<iid>[^/]+)/"
                      r"evaluator_results\.json")
    def results_json(req: Request) -> Response:
        return _result(req, "evaluator_results_json", "application/json")

    @app.route("GET", r"/engine_instances/(?P<iid>[^/]+)/"
                      r"local_evaluator_results\.json")
    def results_json_cors(req: Request) -> Response:
        resp = results_json(req)
        resp.headers["Access-Control-Allow-Origin"] = "*"
        return resp

    return app


def create_dashboard(storage: Optional[Storage] = None,
                     host: str = "127.0.0.1", port: int = 9000,
                     accesskey: Optional[str] = None,
                     ssl_context=None) -> AppServer:
    """Bind the dashboard (default port 9000), not yet serving."""
    return AppServer(build_app(storage, accesskey=accesskey,
                               secure=ssl_context is not None),
                     host=host, port=port, ssl_context=ssl_context)
