"""A small threaded HTTP app framework: the port's own copy of
``predictionio_tpu/server/http.py`` (routing with named path groups,
query strings and headers, JSON responses, a 503 with ``Retry-After``
when the backing store is unavailable, a server that starts in the
background and closes cleanly, HTTPS from PEM files, the ``accessKey``
guard and the dashboard's cookie session).

:func:`mount_metrics` is the telemetry mount every server goes through:
per-route latency and status series, an ``X-Request-ID`` on every
response, a W3C ``traceparent`` continued or minted (with
``X-Trace-Retained`` when the tail sampler kept the trace), the sampled
JSON access log (logger ``predictionio_tpu_torch.access``), ``GET
/metrics`` (text 0.0.4, or OpenMetrics with exemplars), ``GET
/metrics.json`` and ``GET /trace.json``.
"""

from __future__ import annotations

import hmac
import json
import logging
import os
import random
import re
import secrets
import ssl
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ..concurrency import new_lock
from ..data.storage.base import StorageError

__all__ = ["Request", "Response", "HTTPError", "HTTPApp", "AppServer",
           "SessionAuth", "json_response", "make_key_auth",
           "mount_metrics", "mount_trace_routes", "ssl_context_from"]

#: what a 503 from an unavailable backing store asks the client to wait
RETRY_AFTER_SECONDS = 1

#: the structured JSON access log: one line a request with its id and the
#: per-phase timings the handler attached (``Request.obs``); quiet unless
#: INFO is enabled on this logger
access_log = logging.getLogger("predictionio_tpu_torch.access")


@dataclass
class Request:
    method: str
    path: str
    body: bytes
    #: first value of each query parameter
    query: Dict[str, str] = field(default_factory=dict)
    headers: Dict[str, str] = field(default_factory=dict)
    #: named groups of the matched route pattern
    path_params: Dict[str, str] = field(default_factory=dict)
    #: the ``X-Request-ID`` header, or one minted here: on the access-log
    #: line and the response
    request_id: str = ""
    #: what the handler attaches for the access-log line (per-phase
    #: timings); keys starting with ``_`` carry in-process objects (the
    #: live trace) and never reach the log
    obs: Dict[str, Any] = field(default_factory=dict)
    #: the live :class:`~predictionio_tpu_torch.obs.trace.Trace` where
    #: the app has a tracer (also ``obs["_trace"]``, for the batch paths
    #: that see only the obs dict)
    trace: Any = None

    def header(self, name: str, default: Optional[str] = None
               ) -> Optional[str]:
        """Case-insensitive header lookup (``traceparent``,
        ``Traceparent``, ...)."""
        v = self.headers.get(name)
        if v is not None:
            return v
        lower = name.lower()
        for k, val in self.headers.items():
            if k.lower() == lower:
                return val
        return default

    def json(self) -> Any:
        if not self.body:
            return None
        return json.loads(self.body.decode("utf-8"))

    def form(self) -> Dict[str, str]:
        """An ``application/x-www-form-urlencoded`` body, first value a
        key."""
        parsed = parse_qs(self.body.decode("utf-8"), keep_blank_values=True)
        return {k: v[0] for k, v in parsed.items()}


@dataclass
class Response:
    status: int = 200
    body: Any = None
    content_type: str = "application/json"
    headers: Dict[str, str] = field(default_factory=dict)

    def encoded(self) -> bytes:
        if self.body is None:
            return b""
        if isinstance(self.body, bytes):
            return self.body
        if isinstance(self.body, str):
            return self.body.encode("utf-8")
        return json.dumps(self.body).encode("utf-8")


def json_response(body: Any, status: int = 200) -> Response:
    return Response(status=status, body=body)


class HTTPError(Exception):
    """Raise inside a handler to produce a JSON error response."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


def make_key_auth(accesskey: Optional[str]) -> Callable[[Request], None]:
    """The ``?accessKey=`` guard: a no-op where no key is configured, a
    constant-time comparison otherwise (401 on a mismatch)."""

    def _auth(req: Request) -> None:
        if accesskey and not hmac.compare_digest(
                req.query.get("accessKey") or "", accesskey):
            raise HTTPError(401, "Invalid accessKey.")

    return _auth


class SessionAuth:
    """Cookie-session guard for a browser-facing server (the dashboard):
    the accessKey is accepted once, as ``?accessKey=`` or an
    ``Authorization: Bearer`` header, and mints an HttpOnly session
    cookie, so generated links never carry the key. Calling the instance
    authorizes a request and returns a ``Set-Cookie`` value when it
    minted a session (else None); raises :class:`HTTPError` 401."""

    MAX_SESSIONS = 4096
    #: a session expires after a day
    TTL_SECONDS = 24 * 3600.0

    def __init__(self, accesskey: Optional[str],
                 cookie_name: str = "pio_dashboard_session",
                 secure: bool = False):
        self.accesskey = accesskey
        self.cookie_name = cookie_name
        self.secure = secure
        #: token -> monotonic expiry, insertion-ordered so overflow
        #: evicts the oldest session only
        self._tokens: Dict[str, float] = {}
        self._lock = new_lock("SessionAuth._lock")

    def _cookie_token(self, req: Request) -> Optional[str]:
        for part in (req.headers.get("Cookie") or "").split(";"):
            name, _, value = part.strip().partition("=")
            if name == self.cookie_name and value:
                return value
        return None

    def __call__(self, req: Request) -> Optional[str]:
        if not self.accesskey:
            return None
        now = time.monotonic()
        tok = self._cookie_token(req)
        if tok is not None:
            with self._lock:
                for t, expiry in self._tokens.items():
                    if hmac.compare_digest(tok, t):
                        if now <= expiry:
                            return None
                        break  # expired: fall through to the key
        supplied = req.query.get("accessKey") or ""
        if not supplied:
            auth = req.headers.get("Authorization") or ""
            if auth.startswith("Bearer "):
                supplied = auth[len("Bearer "):]
        if supplied and hmac.compare_digest(supplied, self.accesskey):
            tok = secrets.token_urlsafe(32)
            with self._lock:
                for t in [t for t, exp in self._tokens.items()
                          if now > exp]:
                    del self._tokens[t]
                while len(self._tokens) >= self.MAX_SESSIONS:
                    self._tokens.pop(next(iter(self._tokens)))
                self._tokens[tok] = now + self.TTL_SECONDS
            attrs = "; HttpOnly; SameSite=Strict; Path=/"
            if self.secure:
                attrs += "; Secure"
            return f"{self.cookie_name}={tok}{attrs}"
        raise HTTPError(401, "Invalid accessKey.")


def ssl_context_from(cert_path: Optional[str] = None,
                     key_path: Optional[str] = None
                     ) -> Optional[ssl.SSLContext]:
    """A server TLS context from PEM files, else from ``PIO_SSL_CERT``
    and ``PIO_SSL_KEY``; None where neither names a certificate."""
    cert = cert_path or os.environ.get("PIO_SSL_CERT")
    key = key_path or os.environ.get("PIO_SSL_KEY")
    if not cert:
        if key:
            raise ValueError("SSL key configured without a certificate; "
                             "set both or neither")
        return None
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert, key or None)
    return ctx


Handler = Callable[[Request], Response]


class HTTPApp:
    """Routes ``(method, path-regex) -> handler``; first match wins.

    With a registry mounted (:func:`mount_metrics`) every request is timed
    into a per-route latency histogram, counted by status, given a
    request id and a trace, and logged as one JSON access-log line."""

    def __init__(self, name: str = "app"):
        self.name = name
        self._routes: List[Tuple[str, re.Pattern, str, Handler]] = []
        self.metrics = None  # set by mount_metrics
        self._http_hist = None
        self._http_count = None
        self.tracer = None  # set by mount_metrics (obs.trace.Tracer)
        #: the share of successful requests the access log writes; errors
        #: and 503s always log
        self.access_log_sample = 1.0

    def route(self, method: str, pattern: str) -> Callable[[Handler], Handler]:
        compiled = re.compile(f"^{pattern}$")

        def deco(fn: Handler) -> Handler:
            self._routes.append((method.upper(), compiled, pattern, fn))
            return fn
        return deco

    def enable_metrics(self, registry) -> None:
        """Record per-route request latency and status into
        ``registry``."""
        self.metrics = registry
        self._http_hist = registry.histogram(
            "pio_http_request_duration_seconds",
            "HTTP request wall time by route")
        self._http_count = registry.counter(
            "pio_http_requests_total",
            "HTTP requests by route, method, and status code")

    def _dispatch(self, req: Request) -> Tuple[Response, str]:
        """Route and run the handler: ``(response, route pattern)``, the
        pattern being the bounded-cardinality label, never the raw
        path."""
        path_matched = False
        for method, pattern, raw, fn in self._routes:
            m = pattern.match(req.path)
            if not m:
                continue
            path_matched = True
            if method != req.method:
                continue
            req.path_params = m.groupdict()
            try:
                return fn(req), raw
            except HTTPError as e:
                return json_response({"message": e.message}, e.status), raw
            except StorageError as e:
                # an unavailable store is a retryable outage, not a bug
                resp = json_response(
                    {"message": f"backing store unavailable: {e}"}, 503)
                resp.headers["Retry-After"] = str(RETRY_AFTER_SECONDS)
                return resp, raw
            except Exception as e:  # noqa: BLE001 — the server boundary
                return json_response({"message": str(e)}, 500), raw
        if path_matched:
            return json_response({"message": "Method Not Allowed"},
                                 405), "(method-not-allowed)"
        return json_response({"message": "Not Found"}, 404), "(unmatched)"

    def handle(self, req: Request) -> Response:
        req.request_id = (req.headers.get("X-Request-ID")
                          or secrets.token_hex(8))
        tracer = self.tracer
        if tracer is not None:
            # W3C context: continue the caller's trace when a valid
            # traceparent rides in, else mint one
            req.trace = tracer.begin(
                f"{req.method} {req.path}",
                traceparent=req.header("traceparent"),
                request_id=req.request_id, server=self.name)
            req.obs["_trace"] = req.trace
        t0 = time.monotonic()
        resp, route = self._dispatch(req)
        dt = time.monotonic() - t0
        resp.headers.setdefault("X-Request-ID", req.request_id)
        if self.metrics is not None:
            hist = self._http_hist.labels(route=route)
            hist.observe(dt)
            self._http_count.labels(route=route, method=req.method,
                                    status=str(resp.status)).inc()
            if req.trace is not None:
                req.trace.exemplar(hist, dt)
        if req.trace is not None:
            req.trace.set_attr("route", route)
            resp.headers.setdefault("traceparent", req.trace.traceparent())
            retained, reason = tracer.finish(req.trace, status=resp.status,
                                             duration=dt)
            if retained:
                resp.headers.setdefault("X-Trace-Retained", reason)
        if access_log.isEnabledFor(logging.INFO) \
                and self._log_this(resp.status):
            line = {"server": self.name, "requestId": req.request_id,
                    "method": req.method, "path": req.path,
                    "status": resp.status,
                    "durationMs": round(dt * 1000, 3)}
            if req.trace is not None:
                line["traceId"] = req.trace.trace_id
            line.update((k, v) for k, v in req.obs.items()
                        if not k.startswith("_"))
            access_log.info(json.dumps(line))
        return resp

    def _log_this(self, status: int) -> bool:
        """Access-log admission: errors and 503s always; successes at the
        configured sample rate."""
        if status >= 400:
            return True
        sample = self.access_log_sample
        if sample >= 1.0:
            return True
        if sample <= 0.0:
            return False
        return random.random() < sample


#: content type of the OpenMetrics exposition (the one that carries
#: exemplars), negotiated through the Accept header on /metrics
OPENMETRICS_CONTENT_TYPE = \
    "application/openmetrics-text; version=1.0.0; charset=utf-8"


def mount_metrics(app: HTTPApp, registry, server_name: Optional[str] = None,
                  status: Optional[Callable[[], Dict[str, Any]]] = None,
                  runtime: bool = True, tracer=None) -> None:
    """The telemetry mount every server goes through:

    - instruments the app's request path (:meth:`HTTPApp.enable_metrics`:
      latency histogram, status counters, request ids, access log);
    - registers the runtime series (build info, the card's memory,
      process resources) and the process-wide ``timed(name)`` spans;
    - ``GET /metrics``: Prometheus text 0.0.4, or OpenMetrics 1.0 with
      bucket exemplars under ``Accept: application/openmetrics-text``;
    - ``GET /metrics.json``: :meth:`MetricsRegistry.export`;
    - with ``status``, ``GET /status.json``: its dict with the registry
      snapshot under ``metrics`` (the engine server serves its own);
    - a request :class:`~predictionio_tpu_torch.obs.trace.Tracer` and
      ``GET /trace.json``: ``tracer=None`` builds one, ``tracer=False``
      traces nothing.
    """
    from ..obs import Tracer, mount_span_metrics, register_runtime_metrics

    if runtime:
        register_runtime_metrics(registry, server_name or app.name)
        mount_span_metrics(registry)
    app.enable_metrics(registry)
    if tracer is None:
        tracer = Tracer()
    if tracer is not False:
        app.tracer = tracer
        tracer.register_metrics(registry)
        mount_trace_routes(app, tracer)

    # what a scrape costs the server, per scraper: sub-ms bounds (a
    # render of a few hundred series is tens of microseconds)
    render_hist = registry.histogram(
        "pio_metrics_render_seconds",
        "Wall time to render one /metrics(.json) exposition, by format",
        bounds=[0.0001 * (2.0 ** i) for i in range(16)])

    @app.route("GET", "/metrics")
    def metrics(req: Request) -> Response:
        openmetrics = "application/openmetrics-text" in (
            req.header("Accept") or "")
        t0 = time.perf_counter()
        body = registry.render(openmetrics=openmetrics)
        render_hist.labels(
            format="openmetrics" if openmetrics else "text"
        ).observe(time.perf_counter() - t0)
        if openmetrics:
            return Response(body=body,
                            content_type=OPENMETRICS_CONTENT_TYPE)
        return Response(
            body=body,
            content_type="text/plain; version=0.0.4; charset=utf-8")

    @app.route("GET", "/metrics.json")
    def metrics_json(req: Request) -> Response:
        t0 = time.perf_counter()
        resp = json_response(registry.export())
        render_hist.labels(format="json").observe(
            time.perf_counter() - t0)
        return resp

    if status is not None:
        @app.route("GET", "/status.json")
        def status_json(req: Request) -> Response:
            return json_response(dict(status(),
                                      metrics=registry.snapshot()))


def mount_trace_routes(app: HTTPApp, tracer) -> None:
    """``GET /trace.json``, the flight recorder's read side: ``?id=`` a
    retained trace as Chrome/Perfetto trace-event JSON, ``?slowest=N``
    the N slowest retained traces' summaries, and with neither the
    recorder's status."""

    @app.route("GET", "/trace.json")
    def trace_json(req: Request) -> Response:
        trace_id = req.query.get("id")
        if trace_id:
            trace = tracer.recorder.get(trace_id)
            if trace is None:
                raise HTTPError(
                    404, f"trace {trace_id!r} is not retained (it was "
                         f"fast and healthy, or has aged out of the "
                         f"ring)")
            return json_response(trace.to_trace_events())
        if "slowest" in req.query:
            try:
                n = int(req.query["slowest"])
            except ValueError:
                raise HTTPError(400, "slowest must be an integer")
            return json_response({
                "traces": [t.summary()
                           for t in tracer.recorder.slowest(n)]})
        return json_response(tracer.status())


class _Handler(BaseHTTPRequestHandler):
    app: HTTPApp  # bound by AppServer
    protocol_version = "HTTP/1.1"
    # header and body go out in separate writes; without TCP_NODELAY,
    # Nagle and the peer's delayed ACK stall each keep-alive response
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _dispatch(self) -> None:
        parsed = urlparse(self.path)
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        req = Request(method=self.command, path=parsed.path, body=body,
                      query={k: v[0] for k, v in
                             parse_qs(parsed.query).items()},
                      headers=dict(self.headers.items()))
        resp = self.app.handle(req)
        payload = resp.encoded()
        self.send_response(resp.status)
        self.send_header("Content-Type", resp.content_type)
        self.send_header("Content-Length", str(len(payload)))
        for k, v in resp.headers.items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(payload)

    do_GET = do_POST = do_DELETE = do_PUT = _dispatch


class _AppHTTPServer(ThreadingHTTPServer):
    # the stdlib's listen backlog (5) resets connections when a burst of
    # concurrent clients lands; the micro-batcher exists for such bursts
    request_queue_size = 256
    daemon_threads = True


class AppServer:
    """Owns a ``ThreadingHTTPServer`` for one :class:`HTTPApp`: serve in a
    background thread (``start_background``, tests and embedding) or on
    the calling thread (``serve_forever``, the CLI). ``port=0`` picks a
    free port; read it back from :attr:`port`. With ``ssl_context``
    (:func:`ssl_context_from`) it serves HTTPS."""

    def __init__(self, app: HTTPApp, host: str = "0.0.0.0", port: int = 0,
                 ssl_context: Optional[ssl.SSLContext] = None):
        handler = type("BoundHandler", (_Handler,), {"app": app})
        self.httpd = _AppHTTPServer((host, port), handler)
        if ssl_context is not None:
            self.httpd.socket = ssl_context.wrap_socket(
                self.httpd.socket, server_side=True)
        self.scheme = "https" if ssl_context is not None else "http"
        self.app = app
        self._thread: Optional[threading.Thread] = None
        self._on_close: List[Callable[[], None]] = []
        self._close_lock = threading.Lock()
        self._closed = False
        self._serving = False

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def on_close(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` once the listener is down (releases what the app
        owns, such as batcher threads)."""
        self._on_close.append(fn)

    def start_background(self) -> "AppServer":
        self._serving = True
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name=f"{self.app.name}-http",
            daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._serving = True
        self.httpd.serve_forever()

    def close(self) -> None:
        """Stop accepting, close the socket, join the serving thread and
        release what the app owns. Idempotent."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        if self._serving:  # shutdown() waits for a serve loop to exit
            self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        for fn in self._on_close:
            fn()

    def shutdown(self) -> None:
        """The JAX package's name for :meth:`close`."""
        self.close()
