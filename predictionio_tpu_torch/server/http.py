"""A small threaded HTTP app framework: the port's own copy of the core of
``predictionio_tpu/server/http.py`` (routing with named path groups,
query strings and headers, JSON responses, a 503 with ``Retry-After``
when the backing store is unavailable, a server that starts in the
background and closes cleanly, HTTPS from PEM files, the ``accessKey``
guard and the dashboard's cookie session).
"""

from __future__ import annotations

import hmac
import json
import os
import re
import secrets
import ssl
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ..data.storage.base import StorageError

__all__ = ["Request", "Response", "HTTPError", "HTTPApp", "AppServer",
           "SessionAuth", "json_response", "make_key_auth",
           "ssl_context_from"]

#: what a 503 from an unavailable backing store asks the client to wait
RETRY_AFTER_SECONDS = 1


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

    def json(self) -> Any:
        if not self.body:
            return None
        return json.loads(self.body.decode("utf-8"))


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
        self._lock = threading.Lock()

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
    """Routes ``(method, path-regex) -> handler``; first match wins."""

    def __init__(self, name: str = "app"):
        self.name = name
        self._routes: List[Tuple[str, re.Pattern, Handler]] = []

    def route(self, method: str, pattern: str) -> Callable[[Handler], Handler]:
        compiled = re.compile(f"^{pattern}$")

        def deco(fn: Handler) -> Handler:
            self._routes.append((method.upper(), compiled, fn))
            return fn
        return deco

    def handle(self, req: Request) -> Response:
        path_matched = False
        for method, pattern, fn in self._routes:
            m = pattern.match(req.path)
            if not m:
                continue
            path_matched = True
            if method != req.method:
                continue
            req.path_params = m.groupdict()
            try:
                return fn(req)
            except HTTPError as e:
                return json_response({"message": e.message}, e.status)
            except StorageError as e:
                # an unavailable store is a retryable outage, not a bug
                resp = json_response(
                    {"message": f"backing store unavailable: {e}"}, 503)
                resp.headers["Retry-After"] = str(RETRY_AFTER_SECONDS)
                return resp
            except Exception as e:  # noqa: BLE001 — the server boundary
                return json_response({"message": str(e)}, 500)
        if path_matched:
            return json_response({"message": "Method Not Allowed"}, 405)
        return json_response({"message": "Not Found"}, 404)


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

    do_GET = do_POST = do_DELETE = _dispatch


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
