"""Entity-affinity query router (the port's own copy of
``predictionio_tpu/router/router.py``).

One HTTP proxy in front of N engine-server replicas. Placement is the
:class:`~predictionio_tpu_torch.router.ring.HashRing`'s consistent-hash
entity affinity: the same entity id lands on the same replica while
membership holds, so each replica's serving cache and pinned hot tier
see a concentrated, cacheable key stream instead of ``1/N``-diluted
round-robin traffic. Three mechanisms bend pure affinity where it would
hurt:

- **spill-on-hot-spot**: every routed entity feeds a Space-Saving sketch
  (:class:`~predictionio_tpu_torch.obs.hotkeys.SpaceSaving`); a key the
  sketch CONFIRMS is hotter than ``spill_share`` of traffic may spread
  over the first ``spill_fanout`` replicas of its preference list
  (least-loaded first), so one viral entity loads ``spill_fanout``
  replicas instead of melting one, and the ring-stable preference list
  keeps the spill set cache-warm;
- **health ejection**: a replica that fails ``eject_failures``
  consecutive transport attempts is ejected from candidate lists for
  ``eject_sec`` (then re-probed by live traffic); an external health
  source (the fleet aggregator's ``pio_fleet_replica_up`` view) can veto
  a replica the same way;
- **bounded retry**: ``/queries.json`` is an idempotent read, so a
  transport failure (or an upstream 503 shed) retries on the next
  replica of the preference list, at most ``retries`` times a request.
  A 500 is the replica's answer and is passed through, never retried:
  a failed kernel launch is never hidden by a retry.

Draining replicas (:class:`~predictionio_tpu_torch.router.lifecycle.
ReplicaLifecycle`) stop receiving NEW assignments the moment
:meth:`QueryRouter.drain` removes them from the ring, while their
in-flight requests (tracked here, per backend) finish. The
``router.forward`` fault point fires before every attempt.
"""

from __future__ import annotations

import http.client
import json
import socket
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..concurrency import new_lock
from ..faults import FaultError, declare, fire
from ..obs import MetricsRegistry, SpaceSaving
from ..server.http import (
    HTTPApp,
    HTTPError,
    Request,
    Response,
    json_response,
    make_key_auth,
    mount_metrics,
)
from .ring import DEFAULT_VNODES, HashRing

__all__ = ["RouterConfig", "QueryRouter", "build_router_app",
           "create_router_server"]

#: fault point: fired with ``replica=`` before every forward attempt,
#: so chaos drills kill exactly one replica's traffic
#: (``router.forward=error,replica=host:port`` — the autoscale smoke's
#: mid-ramp corpse)
F_FORWARD = declare("router.forward",
                    "entry of one proxy attempt to a replica")


@dataclass
class RouterConfig:
    """Knobs of the query router."""

    #: virtual nodes per replica on the hash ring
    vnodes: int = DEFAULT_VNODES
    #: extra replicas tried after the first choice fails (transport
    #: error or 503 shed); 0 disables retry
    retries: int = 1
    #: Space-Saving sketch capacity for hot-key confirmation
    hot_keys_k: int = 128
    #: a key must carry at least this share of routed traffic —
    #: sketch-confirmed via the error-adjusted lower bound — to spill
    spill_share: float = 0.10
    #: sketch observations before any spill verdict (a 3-query burst
    #: at boot is not a hot spot)
    spill_min_total: float = 50.0
    #: replicas a confirmed-hot key may spread over
    spill_fanout: int = 2
    #: consecutive transport failures before a replica is ejected
    eject_failures: int = 3
    #: how long an ejected replica sits out before traffic re-probes it
    eject_sec: float = 5.0
    #: per-attempt upstream timeout
    timeout_sec: float = 30.0
    #: ?accessKey= guard on the router's control routes
    accesskey: Optional[str] = None

    def __post_init__(self) -> None:
        if not (0.0 < self.spill_share <= 1.0):
            raise ValueError(
                f"spill_share must be in (0,1]: {self.spill_share}")
        if self.spill_fanout < 1:
            raise ValueError("spill_fanout must be >= 1")


def _default_entity_key(query_json: Any) -> Optional[str]:
    """Entity extraction matching ``QueryServer._entity_of``: every
    bundled template keys queries by ``user``."""
    if isinstance(query_json, dict) and query_json.get("user") is not None:
        return str(query_json["user"])
    return None


class _Backend:
    """Per-replica proxy state. Mutable fields are guarded by the
    router's lock; the HTTP connection cache is per-thread."""

    def __init__(self, name: str, base: str) -> None:
        self.name = name
        self.base = base
        scheme, rest = base.split("://", 1)
        self.scheme = scheme
        hostport = rest.split("/", 1)[0]
        host, _, port = hostport.rpartition(":")
        self.host = host or hostport
        self.port = int(port) if port else (443 if scheme == "https"
                                            else 80)
        self.inflight = 0
        self.consecutive_failures = 0
        self.ejected_until = 0.0
        self.draining = False
        self.requests = 0

    def state(self, now: float) -> str:
        if self.draining:
            return "draining"
        if now < self.ejected_until:
            return "ejected"
        return "ready"


class QueryRouter:
    """The routing brain + forwarding engine; transport-agnostic reads
    (``route_key``) are separable from the HTTP proxy (``forward``) so
    tests exercise placement without sockets."""

    def __init__(self, config: Optional[RouterConfig] = None,
                 registry: Optional[MetricsRegistry] = None,
                 entity_key: Callable[[Any], Optional[str]] = None,
                 health: Callable[[str], Optional[bool]] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.config = config or RouterConfig()
        self.registry = registry or MetricsRegistry()
        self._entity_key = entity_key or _default_entity_key
        #: external health veto (the aggregator's replica-up view);
        #: None means "no opinion" and the replica stays eligible
        self._health = health
        self._clock = clock
        self._lock = new_lock("QueryRouter._lock")
        self._ring = HashRing(vnodes=self.config.vnodes)
        self._backends: Dict[str, _Backend] = {}
        self._rr = 0  # fallback rotation for keyless queries
        self.hot = SpaceSaving(capacity=self.config.hot_keys_k)
        self._conns = threading.local()

        reg = self.registry
        self._req_total = reg.counter(
            "pio_router_requests_total",
            "Requests forwarded by replica and outcome "
            "(ok|shed|upstream_error|transport_error)")
        self._req_hist = reg.histogram(
            "pio_router_request_seconds",
            "End-to-end proxy time of one routed request (all "
            "attempts, upstream included)")
        self._retries_total = reg.counter(
            "pio_router_retries_total",
            "Retries AWAY from a replica after a failed attempt on it")
        self._spill_total = reg.counter(
            "pio_router_spill_total",
            "Requests a sketch-confirmed hot key placed off its "
            "affinity replica")
        self._ejections_total = reg.counter(
            "pio_router_ejections_total",
            "Replica ejections after consecutive transport failures")
        self._no_backend_total = reg.counter(
            "pio_router_no_backend_total",
            "Requests dropped (503) because no eligible replica "
            "existed")
        self._inflight_gauge = reg.gauge(
            "pio_router_inflight",
            "In-flight proxied requests per replica (the drain gate "
            "reads this)")
        replicas_fam = reg.gauge(
            "pio_router_replicas",
            "Router view of the backend set by state "
            "(ready|draining|ejected)")
        for state in ("ready", "draining", "ejected"):
            replicas_fam.labels(state=state).set_fn(
                (lambda s: lambda: self._count_state(s))(state))

    # -- membership ---------------------------------------------------------
    def add(self, replica: str) -> str:
        """Add a replica (``host:port`` or full URL) to the ring;
        returns its ring name. Idempotent; a draining replica re-added
        resumes taking assignments."""
        name, base = _normalize(replica)
        with self._lock:
            b = self._backends.get(name)
            if b is None:
                b = _Backend(name, base)
                self._backends[name] = b
                self._inflight_gauge.labels(replica=name).set_fn(
                    (lambda bk: lambda: float(bk.inflight))(b))
            b.draining = False
            b.consecutive_failures = 0
            b.ejected_until = 0.0
            if name not in self._ring:
                self._ring.add(name)
        return name

    def drain(self, name: str) -> bool:
        """Stop NEW assignments to ``name``; in-flight requests keep
        their backend (the lifecycle manager polls :meth:`inflight`
        before terminating it)."""
        with self._lock:
            b = self._backends.get(name)
            if b is None:
                return False
            b.draining = True
            self._ring.remove(name)
        return True

    def remove(self, name: str) -> bool:
        """Forget the replica entirely (post-terminate)."""
        with self._lock:
            b = self._backends.pop(name, None)
            self._ring.remove(name)
        return b is not None

    def members(self) -> List[str]:
        with self._lock:
            return self._ring.members()

    def inflight(self, name: str) -> int:
        with self._lock:
            b = self._backends.get(name)
            return b.inflight if b is not None else 0

    def set_health(self, fn: Optional[Callable[[str],
                                               Optional[bool]]]) -> None:
        """Attach/replace the external health veto after construction
        (deploy builds the router before the aggregator exists)."""
        self._health = fn

    def _count_state(self, state: str) -> float:
        now = self._clock()
        with self._lock:
            return float(sum(1 for b in self._backends.values()
                             if b.state(now) == state))

    # -- placement ----------------------------------------------------------
    def _is_hot(self, key: str) -> bool:
        hot = self.hot
        if hot.total < self.config.spill_min_total:
            return False
        for item in hot.top(self.config.hot_keys_k):
            if item["key"] == key:
                # sketch-CONFIRMED: even the pessimistic true count
                # (count - error) clears the share bar
                low = item["count"] - item["error"]
                return low >= self.config.spill_share * hot.total
        return False

    def candidates(self, key: Optional[str]) -> Tuple[List[str], bool]:
        """Ordered replica attempt list for one request, and whether
        hot-key spill widened it. Ejected/draining/veto'd replicas are
        filtered; if that empties the list, every ready replica is
        eligible again (an outage must degrade to round-robin, not to
        0 capacity)."""
        now = self._clock()
        cfg = self.config
        spilled = False
        with self._lock:
            members = self._ring.members()
            if key is not None and members:
                if self._is_hot(key):
                    pref = self._ring.preference(key, cfg.spill_fanout)
                    # least-loaded first among the spill set: the
                    # cheapest of the "power of d choices" placements
                    pref.sort(key=lambda n: self._backends[n].inflight)
                    spilled = True
                    # retry fallbacks beyond the spill set
                    for extra in self._ring.preference(
                            key, cfg.spill_fanout + cfg.retries):
                        if extra not in pref:
                            pref.append(extra)
                else:
                    pref = self._ring.preference(key, 1 + cfg.retries)
            else:
                # keyless query: rotate over the ring
                self._rr += 1
                pref = (members[self._rr % len(members):]
                        + members[:self._rr % len(members)]
                        )[:1 + cfg.retries] if members else []
            eligible = []
            for name in pref:
                b = self._backends.get(name)
                if b is None or b.draining or now < b.ejected_until:
                    continue
                eligible.append(name)
        if not eligible:
            # every preferred replica is ejected: re-admit them rather
            # than fail — live traffic is the re-probe
            with self._lock:
                eligible = [n for n in pref
                            if (b := self._backends.get(n)) is not None
                            and not b.draining]
        if self._health is not None and eligible:
            kept = [n for n in eligible if self._health(n) is not False]
            if kept:
                eligible = kept
        return eligible, spilled

    def route_key(self, key: Optional[str]) -> Optional[str]:
        """Where one entity would land right now (diagnostics +
        tests); records nothing."""
        cand, _ = self.candidates(key)
        return cand[0] if cand else None

    def preference(self, key: str, n: int) -> List[str]:
        """The raw ring preference list (no health filtering) —
        the ``fleet route --key`` diagnostic."""
        with self._lock:
            return self._ring.preference(key, n)

    # -- forwarding ---------------------------------------------------------
    def forward(self, path: str, body: bytes,
                headers: Dict[str, str]) -> Response:
        """Proxy one request: place, attempt, retry, account."""
        t0 = self._clock()
        key = None
        try:
            key = self._entity_key(json.loads(body.decode("utf-8")))
        except Exception:  # noqa: BLE001 — unparseable body still routes
            pass
        if key is not None:
            self.hot.record(key)
        candidates, spilled = self.candidates(key)
        if not candidates:
            self._no_backend_total.inc()
            raise HTTPError(503, "no live replica to route to")
        affinity = candidates[0] if not spilled else None
        last_err: Optional[str] = None
        resp: Optional[Response] = None
        for attempt, name in enumerate(
                candidates[:1 + self.config.retries]):
            with self._lock:
                b = self._backends.get(name)
                if b is None:
                    continue
                b.inflight += 1
                b.requests += 1
            try:
                status, rbody, rheaders = self._attempt(b, path, body,
                                                        headers)
                transport_err = None
            except (FaultError, OSError, http.client.HTTPException,
                    socket.timeout) as e:
                transport_err = str(e) or type(e).__name__
            finally:
                with self._lock:
                    if b is not None:
                        b.inflight -= 1
            if transport_err is not None:
                last_err = transport_err
                self._note_failure(b)
                self._req_total.labels(
                    replica=name, outcome="transport_error").inc()
                self._retries_total.labels(replica=name).inc()
                continue
            self._note_success(b)
            if status == 503 and attempt < self.config.retries:
                # an idempotent read shed by one replica can still be
                # answered by the next — bounded, like everything here
                self._req_total.labels(replica=name,
                                       outcome="shed").inc()
                self._retries_total.labels(replica=name).inc()
                last_err = "503 shed"
                continue
            outcome = ("ok" if status < 400
                       else "shed" if status == 503
                       else "upstream_error")
            self._req_total.labels(replica=name, outcome=outcome).inc()
            if spilled and key is not None:
                self._spill_total.labels(replica=name).inc()
            resp = Response(status=status, body=rbody,
                            content_type=rheaders.get(
                                "Content-Type", "application/json"))
            for h in ("X-Request-ID", "traceparent",
                      "X-Trace-Retained", "Retry-After"):
                if h in rheaders:
                    resp.headers[h] = rheaders[h]
            resp.headers["X-Routed-To"] = name
            if affinity is not None and name != affinity:
                resp.headers["X-Routed-Retry"] = str(attempt)
            break
        self._req_hist.observe(self._clock() - t0)
        if resp is None:
            raise HTTPError(
                503, f"every candidate replica failed "
                     f"({last_err or 'no attempt made'})")
        return resp

    def _attempt(self, b: _Backend, path: str, body: bytes,
                 headers: Dict[str, str]
                 ) -> Tuple[int, bytes, Dict[str, str]]:
        """One keep-alive HTTP attempt against a backend; raises on
        transport failure. The fault point fires FIRST so a chaos
        spec matched to this replica kills the attempt exactly like a
        dead socket."""
        fire(F_FORWARD, replica=b.name)
        conn = self._conn(b)
        try:
            conn.request("POST", path, body=body, headers={
                "Content-Type": headers.get("Content-Type",
                                            "application/json"),
                **{k: v for k, v in headers.items()
                   if k.lower() in ("traceparent", "x-request-id",
                                    "accept")},
            })
            r = conn.getresponse()
            data = r.read()
            return r.status, data, dict(r.getheaders())
        except Exception:
            self._drop_conn(b)
            raise

    def _conn(self, b: _Backend) -> http.client.HTTPConnection:
        cache = getattr(self._conns, "by_base", None)
        if cache is None:
            cache = {}
            self._conns.by_base = cache
        conn = cache.get(b.base)
        if conn is None:
            cls = (http.client.HTTPSConnection
                   if b.scheme == "https"
                   else http.client.HTTPConnection)
            conn = cls(b.host, b.port,
                       timeout=self.config.timeout_sec)
            cache[b.base] = conn
        return conn

    def _drop_conn(self, b: _Backend) -> None:
        cache = getattr(self._conns, "by_base", None)
        if cache is not None:
            conn = cache.pop(b.base, None)
            if conn is not None:
                try:
                    conn.close()
                except Exception:  # noqa: BLE001
                    pass

    def _note_failure(self, b: _Backend) -> None:
        ejected = False
        with self._lock:
            b.consecutive_failures += 1
            if (b.consecutive_failures >= self.config.eject_failures
                    and self._clock() >= b.ejected_until):
                b.ejected_until = self._clock() + self.config.eject_sec
                ejected = True
        if ejected:
            self._ejections_total.labels(replica=b.name).inc()

    def _note_success(self, b: _Backend) -> None:
        with self._lock:
            b.consecutive_failures = 0
            b.ejected_until = 0.0

    # -- read side ----------------------------------------------------------
    def status(self) -> Dict[str, Any]:
        now = self._clock()
        with self._lock:
            backends = [{
                "replica": b.name,
                "url": b.base,
                "state": b.state(now),
                "inflight": b.inflight,
                "requests": b.requests,
                "consecutiveFailures": b.consecutive_failures,
                "ejectedForSec": (round(b.ejected_until - now, 3)
                                  if now < b.ejected_until else 0.0),
            } for b in self._backends.values()]
            vnodes = self._ring.describe()
        return {
            "server": "router",
            "replicas": backends,
            "ring": {"vnodes": self.config.vnodes,
                     "points": vnodes},
            "retries": self.config.retries,
            "spill": {"share": self.config.spill_share,
                      "fanout": self.config.spill_fanout,
                      "minTotal": self.config.spill_min_total},
            "hotKeys": self.hot.snapshot(),
        }


def _normalize(replica: str) -> Tuple[str, str]:
    r = replica.strip().rstrip("/")
    if "://" in r:
        return r.split("://", 1)[1], r
    return r, "http://" + r


def build_router_app(router: QueryRouter) -> HTTPApp:
    """The router's HTTP surface: the proxied query route plus its own
    telemetry (its registry is NOT scraped by the fleet aggregator —
    the replicas' merged series stay the source of serving truth; the
    ``pio_router_*`` families describe the routing tier itself)."""
    app = HTTPApp(name="router")
    mount_metrics(app, router.registry, server_name="router",
                  status=router.status, runtime=False, tracer=False)
    _auth = make_key_auth(router.config.accesskey)

    @app.route("POST", "/queries.json")
    def queries(req: Request) -> Response:
        return router.forward("/queries.json", req.body, req.headers)

    @app.route("GET", "/route.json")
    def route_json(req: Request) -> Response:
        payload = router.status()
        key = req.query.get("key")
        if key is not None:
            payload["key"] = key
            payload["affinity"] = router.route_key(key)
            payload["preference"] = router.preference(
                key, 1 + router.config.retries)
        return json_response(payload)

    @app.route("POST", "/drain")
    def drain(req: Request) -> Response:
        _auth(req)
        name = req.query.get("replica") or ""
        if not router.drain(name):
            raise HTTPError(404, f"unknown replica {name!r}")
        return json_response({"draining": name})

    return app


def create_router_server(router: QueryRouter, host: str = "0.0.0.0",
                         port: int = 8100, ssl_context=None):
    """Bind the router's server (caller starts it)."""
    from ..server.http import AppServer

    return AppServer(build_router_app(router), host=host, port=port,
                     ssl_context=ssl_context)
