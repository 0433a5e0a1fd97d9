"""Fleet aggregator: N replica registries merged into one, exactly (the
port's own copy of ``predictionio_tpu/fleet/aggregator.py``).

The scrape loop pulls every replica's ``GET /metrics.json`` (the
full-fidelity JSON exposition: raw cumulative histogram buckets, not
percentile summaries) and ``GET /status.json``, and folds them into ONE
local :class:`~predictionio_tpu_torch.obs.MetricsRegistry`:

- **counters sum**: each replica contributes the DELTA since its last
  scrape, reset-compensated: a replica restart (raw value regressed)
  contributes its whole new value instead of a negative delta, so the
  merged series stays monotone and equals the sum of the replicas'
  lifetimes (``pio_fleet_counter_resets_total`` counts the splices);
- **gauges get per-replica labels** (``replica="host:port"``) plus
  ``agg="min"|"max"|"sum"`` rollup children recomputed over the replicas
  serving now, each cycle;
- **histograms merge losslessly** at bucket resolution: per-bucket
  cumulative-count deltas are themselves histograms (the identity
  :func:`~predictionio_tpu_torch.obs.histogram.window_quantile` reads),
  rebuilt with ``StreamingHistogram.from_buckets`` and added into the
  fleet child with ``StreamingHistogram.merge``. A quantile of the merged
  child is the POOLED population's quantile, never an average of
  per-replica percentiles, which has no statistical meaning. The bucket
  bounds are the JAX package's, so a merge of either package's replicas
  means the same.

On top ride the fleet services: a fleet-scoped
:class:`~predictionio_tpu_torch.slo.SLOEngine` over the merged series,
``GET /fleet.json`` (liveness, staleness, degraded and nonfinite flags,
capacity headroom against a capacity model's knee), cross-replica ``GET
/trace.json?id=``, the fleet-wide hot-key top-K (per-replica Space-Saving
sketches merged each cycle), ``POST /scrape``, ``POST /scale`` and
``POST /stop``. :meth:`FleetAggregator.stop` joins the scrape thread and
the SLO engine's.
"""

from __future__ import annotations

import json
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..concurrency import new_lock
from ..obs import MetricsRegistry, SpaceSaving, StreamingHistogram
from ..obs.hotkeys import mount_hot_key_metrics
from ..obs.runtime import register_process_metrics
from ..server.http import (
    AppServer,
    HTTPApp,
    HTTPError,
    Request,
    Response,
    json_response,
    make_key_auth,
    mount_metrics,
)

__all__ = ["FleetConfig", "FleetAggregator", "build_fleet_app",
           "create_fleet_server"]

#: Families NEVER merged from replicas: the pio_slo_* series on the
#: fleet registry belong to the fleet's OWN SLOEngine (evaluated over
#: the merged series — THE fleet verdict); a replica's local verdicts
#: would collide with it child-for-child and mean something else
#: entirely. Per-replica SLO state still surfaces through /fleet.json.
_MERGE_SKIP = frozenset({
    "pio_slo_burn_rate",
    "pio_slo_budget_remaining",
    "pio_slo_breach",
    "pio_slo_violations_total",
})


@dataclass
class FleetConfig:
    """Knobs of the fleet observability plane (``fleet serve``)."""

    #: replica base addresses: ``host:port`` or full ``http://`` URLs
    replicas: List[str] = field(default_factory=list)
    scrape_interval_sec: float = 5.0
    #: a replica with no successful scrape for this long is DOWN
    #: (drops out of gauge rollups, hot-key merge, and headroom
    #: denominators); None = 3x the scrape interval
    stale_after_sec: Optional[float] = None
    #: SLO spec file evaluated against the MERGED registry
    #: (``slo/specs/*.json``); None = the built-in default specs
    slo_specs: Optional[str] = None
    #: fleet SLO evaluation tick; 0 disables the fleet SLO engine
    slo_interval_sec: float = 1.0
    #: a measured capacity model (``CAPACITY.json``); its knee qps
    #: feeds the fleet headroom gauge. None: no knee, no headroom
    capacity_path: Optional[str] = None
    #: capacity of the fleet-wide merged hot-key sketch
    hot_keys_k: int = 128
    #: per-request timeout for replica scrapes/fan-outs
    timeout_sec: float = 5.0
    #: ?accessKey= guard on the control routes (POST /scrape, /stop)
    accesskey: Optional[str] = None

    @property
    def stale_after(self) -> float:
        if self.stale_after_sec is not None:
            return self.stale_after_sec
        return 3.0 * max(self.scrape_interval_sec, 0.25)


def _normalize(replica: str) -> Tuple[str, str]:
    """``(name, base_url)`` for a replica spec: the label keeps the
    compact host:port form, the base URL gains a scheme if absent."""
    r = replica.strip().rstrip("/")
    if "://" in r:
        name = r.split("://", 1)[1]
        return name, r
    return r, "http://" + r


def _default_fetch(url: str, timeout: float) -> Tuple[int, Any]:
    """``(status, parsed-json)`` for a GET; non-2xx returns its code
    with whatever body parsed (the trace fan-out needs clean 404s)."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.getcode(), json.loads(
                resp.read().decode("utf-8"))
    except urllib.error.HTTPError as e:  # non-2xx, NOT a dead replica
        try:
            body = json.loads(e.read().decode("utf-8"))
        except Exception:  # noqa: BLE001 — non-JSON error body
            body = None
        return e.code, body


class _ReplicaState:
    """Per-replica scrape bookkeeping: last raw counter/histogram
    readings (the reset-compensation anchors), last gauge values (the
    rollup inputs), and the last /status.json body."""

    def __init__(self, name: str, base: str) -> None:
        self.name = name
        self.base = base
        self.last_ok: Optional[float] = None     # monotonic
        self.last_err: Optional[str] = None
        self.scrape_sec = 0.0
        self.status: Dict[str, Any] = {}
        # (family, label items) → last raw reading
        self.counters: Dict[Tuple[str, Tuple], float] = {}
        # (family, label items) → (per-bucket counts, sum)
        self.hists: Dict[Tuple[str, Tuple], Tuple[List[int], float]] = {}
        self.gauges: Dict[Tuple[str, Tuple], float] = {}

    def up(self, now: float, stale_after: float) -> bool:
        return (self.last_ok is not None
                and now - self.last_ok <= stale_after)

    @property
    def draining(self) -> bool:
        """The replica announced lifecycle=draining in /status.json:
        it is finishing in-flight work and will exit — alive, but no
        longer part of the fleet's capacity."""
        return (self.status or {}).get("lifecycle") == "draining"

    def serving(self, now: float, stale_after: float) -> bool:
        """Up AND not draining — the population gauge rollups, the
        hot-key union, and the headroom denominator are computed
        over."""
        return self.up(now, stale_after) and not self.draining


class FleetAggregator:
    """Owns the merged registry, the scrape loop, and the fleet SLO
    engine. ``fetch(url, timeout) -> (status, json)`` is injectable so
    tests drive merges without sockets."""

    def __init__(self, config: FleetConfig,
                 fetch: Optional[Callable[[str, float],
                                          Tuple[int, Any]]] = None
                 ) -> None:
        if not config.replicas:
            raise ValueError("FleetConfig needs at least one replica")
        self.config = config
        self.fetch = fetch or _default_fetch
        self.registry = MetricsRegistry()
        self._states = {}
        for r in config.replicas:
            name, base = _normalize(r)
            self._states[name] = _ReplicaState(name, base)
        # merge anchors of replicas that left (scale-in): if the same
        # name rejoins — a restart on the same port — its counters
        # resume from the last raw reading instead of re-contributing
        # their whole lifetime to the merged series
        self._anchor_tombstones: Dict[str, Tuple[Dict, Dict]] = {}
        # attached control plane (deploy --autoscale wires these)
        self.autoscaler = None
        self.router = None
        # one cycle at a time: the interval loop and POST /scrape must
        # not interleave half-applied deltas
        self._cycle_lock = new_lock("FleetAggregator._cycle_lock")
        self._cycles = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # fleet qps estimate: merged /queries.json request total
        # deltas between cycles
        self._last_queries: Optional[Tuple[float, float]] = None
        self._knee_qps = self._load_knee(config.capacity_path)

        reg = self.registry
        self._scrapes = reg.counter(
            "pio_fleet_scrapes_total",
            "Replica scrape attempts by outcome (ok|error)")
        self._scrape_hist = reg.histogram(
            "pio_fleet_scrape_seconds",
            "Wall time of one replica scrape (fetch + merge)",
            bounds=[0.001 * (2.0 ** i) for i in range(14)])
        self._cycles_total = reg.counter(
            "pio_fleet_scrape_cycles_total",
            "Completed scrape cycles over the whole fleet")
        self._resets = reg.counter(
            "pio_fleet_counter_resets_total",
            "Counter/histogram regressions absorbed by reset "
            "compensation (a replica restarted; merged series stayed "
            "monotone)")
        self._merge_errors = reg.counter(
            "pio_fleet_merge_errors_total",
            "Families that could not be merged (kind or bucket-layout "
            "conflict across replicas)")
        self._up_gauge = reg.gauge(
            "pio_fleet_replica_up",
            "1 while the replica's last successful scrape is fresher "
            "than the staleness bound")
        self._age_fam = reg.gauge(
            "pio_fleet_last_scrape_age_seconds",
            "Seconds since the replica last answered a scrape "
            "(monotone-clock read at render time)")
        for st in self._states.values():
            self._register_replica_gauges(st)
        replicas_fam = reg.gauge(
            "pio_fleet_replicas",
            "Replicas by state (configured|up|draining); membership "
            "is dynamic under autoscaling, so every child is "
            "recomputed at render time")
        replicas_fam.labels(state="configured").set_fn(
            lambda: float(len(self._states)))
        replicas_fam.labels(state="up").set_fn(
            lambda: float(sum(
                1 for s in list(self._states.values())
                if s.up(time.monotonic(), self.config.stale_after))))
        replicas_fam.labels(state="draining").set_fn(
            lambda: float(sum(
                1 for s in list(self._states.values())
                if s.draining)))
        self._qps_gauge = reg.gauge(
            "pio_fleet_qps",
            "Fleet-wide /queries.json request rate estimated from "
            "merged counter deltas between scrape cycles")
        self._headroom_gauge = reg.gauge(
            "pio_fleet_capacity_headroom",
            "1 - qps / (knee_qps x replicas up) against the committed "
            "CAPACITY.json knee; negative = over capacity, -1 when no "
            "capacity model is loaded")
        self._headroom_gauge.set(-1.0)
        # fleet-wide hot keys: REBUILT from the per-replica cumulative
        # sketches every cycle (accumulating them each cycle would
        # double-count), swapped atomically for the collector
        self.hot = SpaceSaving(capacity=config.hot_keys_k)
        mount_hot_key_metrics(reg, _HotProxy(self), top_n=10)
        register_process_metrics(reg)

        self.slo = None
        if config.slo_interval_sec > 0:
            from ..slo import SLOEngine, default_specs, load_specs

            if config.slo_specs:
                specs, _ = load_specs(config.slo_specs)
            else:
                specs = default_specs()
            self.slo = SLOEngine(reg, specs)
            self.slo.register_metrics(reg)

    @staticmethod
    def _load_knee(path: Optional[str]) -> Optional[float]:
        """Best knee qps in the committed capacity model (the
        single-replica ceiling the headroom gauge scales by fleet
        size); None without a model."""
        if not path:
            return None
        with open(path, encoding="utf-8") as f:
            capacity = json.load(f)
        knees = [c.get("knee_qps")
                 for c in (capacity.get("configs") or {}).values()
                 if isinstance(c, dict) and c.get("knee_qps")]
        return max(knees) if knees else None

    # -- membership ---------------------------------------------------------
    def _register_replica_gauges(self, st: _ReplicaState) -> None:
        self._up_gauge.labels(replica=st.name).set(0.0)
        self._age_fam.labels(replica=st.name).set_fn(
            (lambda s: lambda: (time.monotonic() - s.last_ok)
             if s.last_ok is not None else -1.0)(st))

    def add_replica(self, replica: str) -> str:
        """Join a replica to the scrape set (idempotent); the replica
        lifecycle manager calls this once a spawn reports warm. A
        rejoining name reclaims its tombstoned merge anchors so the
        merged counters don't double-count its pre-restart lifetime."""
        name, base = _normalize(replica)
        with self._cycle_lock:
            if name in self._states:
                return name
            st = _ReplicaState(name, base)
            st.counters, st.hists = self._anchor_tombstones.pop(
                name, ({}, {}))
            self._states[name] = st
            self._register_replica_gauges(st)
        return name

    def remove_replica(self, replica: str) -> bool:
        """Remove a replica from the scrape set (scale-in terminate or
        corpse removal). Its gauge children leave the exposition; its
        merged counter/histogram contributions stay — monotone
        history — and its anchors are tombstoned for a possible
        rejoin."""
        name = _normalize(replica)[0]
        with self._cycle_lock:
            return self._remove_locked(name)

    def _remove_locked(self, name: str) -> bool:
        st = self._states.pop(name, None)
        if st is None:
            return False
        self._anchor_tombstones[name] = (st.counters, st.hists)
        for fam in self.registry.families():
            if fam.kind == "gauge":
                fam.remove_matching(replica=name)
        return True

    # -- control-plane signals ----------------------------------------------
    def capacity_signals(self) -> Dict[str, Any]:
        """The merged signals one autoscaler tick consumes. Headroom
        is ``None`` (not the -1 gauge sentinel) when no capacity model
        is loaded, so the policy can tell "plenty of room" from "no
        model to reason with"."""
        headroom = self._headroom_gauge.labels().value
        return {
            "qps": self._qps_gauge.labels().value,
            "kneeQps": self._knee_qps,
            "headroom": headroom if self._knee_qps else None,
        }

    def replica_health(self, replica: str) -> str:
        """``up`` | ``down`` | ``unknown`` | ``absent`` for the heal
        pass. A member that has never answered a scrape is
        ``unknown`` — a fresh join mid-warmup, not a corpse — so the
        autoscaler won't kill what it just spawned."""
        name = _normalize(replica)[0]
        st = self._states.get(name)
        if st is None:
            return "absent"
        if st.last_ok is None:
            return "unknown"
        return ("up"
                if st.up(time.monotonic(), self.config.stale_after)
                else "down")

    def attach_autoscaler(self, autoscaler) -> None:
        """Surface an autoscaler's decision log on ``/fleet.json`` and
        accept ``POST /scale`` requests for it."""
        self.autoscaler = autoscaler

    def attach_router(self, router) -> None:
        """Surface a query router's ring/backends on the fleet's
        ``GET /route.json``."""
        self.router = router

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "FleetAggregator":
        if self.slo is not None:
            self.slo.start(self.config.slo_interval_sec)
        self._thread = threading.Thread(
            target=self._loop, name="fleet-scraper", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self.slo is not None:
            self.slo.stop()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.scrape_cycle()
            except Exception:  # noqa: BLE001 — the loop must survive
                pass           # any single bad cycle
            self._stop.wait(self.config.scrape_interval_sec)

    # -- scraping -----------------------------------------------------------
    def scrape_cycle(self) -> Dict[str, Any]:
        """One full pass over the fleet: scrape + merge every replica,
        then recompute the cross-replica derivations (gauge rollups,
        hot-key union, qps/headroom). Serialized; also the handler of
        ``POST /scrape`` so tests/smokes get quiescent exact state."""
        with self._cycle_lock:
            outcomes: Dict[str, Any] = {}
            departed: List[str] = []
            for st in list(self._states.values()):
                outcomes[st.name] = self._scrape_replica(st)
                if outcomes[st.name] == "departed":
                    departed.append(st.name)
            # a draining replica that stopped answering finished its
            # drain and exited: expected departure, so it leaves the
            # membership instead of flapping pio_fleet_replica_up
            for name in departed:
                self._remove_locked(name)
            self._rollup_gauges()
            self._merge_hot_keys()
            self._update_capacity()
            self._cycles += 1
            self._cycles_total.inc()
            return outcomes

    def _scrape_replica(self, st: _ReplicaState) -> str:
        t0 = time.monotonic()
        try:
            code, families = self.fetch(st.base + "/metrics.json",
                                        self.config.timeout_sec)
            if code != 200 or not isinstance(families, dict):
                raise RuntimeError(
                    f"/metrics.json answered {code}")
            self._merge_families(st, families)
            # status is best-effort enrichment: a replica whose
            # metrics merged but whose status route hiccuped is
            # still UP
            try:
                s_code, status = self.fetch(st.base + "/status.json",
                                            self.config.timeout_sec)
                if s_code == 200 and isinstance(status, dict):
                    st.status = status
            except Exception:  # noqa: BLE001
                pass
            st.last_ok = time.monotonic()
            st.last_err = None
            outcome = "ok"
        except Exception as e:  # noqa: BLE001 — a dead replica is a
            if st.draining:       # data point, not a crash
                # drain completed between scrapes — the silence is the
                # expected exit, not a failure: no error outcome, no
                # up-gauge flap, no counter-reset noise when a
                # successor reuses the port (anchors are tombstoned)
                st.scrape_sec = time.monotonic() - t0
                return "departed"
            st.last_err = str(e)
            outcome = "error"
        st.scrape_sec = time.monotonic() - t0
        self._scrape_hist.labels(replica=st.name).observe(st.scrape_sec)
        self._scrapes.labels(replica=st.name, outcome=outcome).inc()
        self._up_gauge.labels(replica=st.name).set(
            1.0 if st.up(time.monotonic(), self.config.stale_after)
            else 0.0)
        return outcome

    def _merge_families(self, st: _ReplicaState,
                        families: Dict[str, Any]) -> None:
        for name, fam in sorted(families.items()):
            if name in _MERGE_SKIP or not isinstance(fam, dict):
                continue
            kind = fam.get("kind")
            help_ = str(fam.get("help") or "")
            try:
                if kind == "counter":
                    self._merge_counter(st, name, help_, fam)
                elif kind == "histogram":
                    self._merge_histogram(st, name, help_, fam)
                elif kind == "gauge":
                    self._merge_gauge(st, name, help_, fam)
            except ValueError:
                # kind conflict across replicas or a bucket-layout
                # mismatch: count it, keep scraping — one bad family
                # must not sever the whole replica
                self._merge_errors.labels(replica=st.name,
                                          family=name).inc()

    def _merge_counter(self, st: _ReplicaState, name: str,
                       help_: str, fam: Dict[str, Any]) -> None:
        fleet_fam = self.registry.counter(name, help_)
        for child in fam.get("children") or []:
            labels = dict(child.get("labels") or {})
            raw = float(child.get("value") or 0.0)
            key = (name, tuple(sorted(labels.items())))
            last = st.counters.get(key)
            delta = raw if last is None else raw - last
            if delta < 0:
                # replica restarted: its counter began again from 0,
                # so the ENTIRE current value is new observations
                self._resets.labels(replica=st.name).inc()
                delta = raw
            st.counters[key] = raw
            if delta > 0:
                fleet_fam.labels(**labels).inc(delta)

    def _merge_histogram(self, st: _ReplicaState, name: str,
                         help_: str, fam: Dict[str, Any]) -> None:
        for child in fam.get("children") or []:
            labels = dict(child.get("labels") or {})
            buckets = child.get("buckets") or []
            if len(buckets) < 2:
                continue
            rebuilt = StreamingHistogram.from_buckets(
                buckets,
                sum=child.get("sum"),
                minimum=child.get("min"),
                maximum=child.get("max"))
            counts = list(rebuilt._counts)
            total_sum = float(child.get("sum") or 0.0)
            key = (name, tuple(sorted(labels.items())))
            last = st.hists.get(key)
            if last is not None and len(last[0]) == len(counts):
                deltas = [n - p for n, p in zip(counts, last[0])]
                dsum = total_sum - last[1]
                if any(d < 0 for d in deltas) or dsum < -1e-9:
                    # reset: the current histogram is all-new
                    self._resets.labels(replica=st.name).inc()
                    deltas, dsum = counts, total_sum
            else:
                deltas, dsum = counts, total_sum
            st.hists[key] = (counts, total_sum)
            n = sum(deltas)
            if n == 0:
                continue
            fleet_fam = self.registry.histogram(
                name, help_, bounds=rebuilt.bounds)
            fleet_child = fleet_fam.labels(**labels)
            # the delta vector is itself a valid histogram of the
            # observations that landed since the last scrape; the
            # replica's lifetime min/max bound them (bucket-resolution
            # truth — same resolution every quantile here has)
            cum: List[Tuple[float, int]] = []
            acc = 0
            for le, d in zip(list(rebuilt.bounds) + [math.inf], deltas):
                acc += d
                cum.append((le, acc))
            fleet_child.merge(StreamingHistogram.from_buckets(
                cum, sum=max(dsum, 0.0),
                minimum=child.get("min"), maximum=child.get("max")))

    def _merge_gauge(self, st: _ReplicaState, name: str,
                     help_: str, fam: Dict[str, Any]) -> None:
        fleet_fam = self.registry.gauge(name, help_)
        for child in fam.get("children") or []:
            labels = dict(child.get("labels") or {})
            value = float(child.get("value") or 0.0)
            st.gauges[(name, tuple(sorted(labels.items())))] = value
            fleet_fam.labels(replica=st.name, **labels).set(value)

    def _rollup_gauges(self) -> None:
        """``agg="min"|"max"|"sum"`` children recomputed over the
        replicas that are currently SERVING — a down replica's last
        reading must not pin a rollup forever, and a draining one is
        winding down outside the fleet's capacity (its
        ``replica=``-labeled child DOES keep its last value; check
        pio_fleet_replica_up / the lifecycle field)."""
        now = time.monotonic()
        stale = self.config.stale_after
        pools: Dict[Tuple[str, Tuple], List[float]] = {}
        for st in self._states.values():
            if not st.serving(now, stale):
                continue
            for key, v in st.gauges.items():
                pools.setdefault(key, []).append(v)
        for (name, items), vals in pools.items():
            fam = self.registry.get(name)
            if fam is None or not vals:
                continue
            labels = dict(items)
            fam.labels(agg="min", **labels).set(min(vals))
            fam.labels(agg="max", **labels).set(max(vals))
            fam.labels(agg="sum", **labels).set(sum(vals))

    def _merge_hot_keys(self) -> None:
        now = time.monotonic()
        fresh = SpaceSaving(capacity=self.config.hot_keys_k)
        for st in self._states.values():
            if not st.serving(now, self.config.stale_after):
                continue
            block = st.status.get("hotKeys") or {}
            fresh.merge_items(block.get("top") or [],
                              total=float(block.get("total") or 0.0))
        self.hot = fresh

    def _update_capacity(self) -> None:
        fam = self.registry.get("pio_http_requests_total")
        total = 0.0
        if fam is not None:
            for items, child in fam.children():
                if dict(items).get("route") == "/queries.json":
                    total += float(child.value)
        now = time.monotonic()
        qps = 0.0
        if self._last_queries is not None:
            last_t, last_total = self._last_queries
            dt = now - last_t
            if dt > 0:
                qps = max(0.0, (total - last_total) / dt)
        self._last_queries = (now, total)
        self._qps_gauge.set(qps)
        # the denominator is SERVING replicas: a draining replica's
        # capacity is leaving, and counting it would overstate
        # headroom exactly when the autoscaler most needs it honest
        n_serving = sum(1 for s in self._states.values()
                        if s.serving(now, self.config.stale_after))
        if self._knee_qps and n_serving:
            self._headroom_gauge.set(
                1.0 - qps / (self._knee_qps * n_serving))
        else:
            self._headroom_gauge.set(-1.0)

    # -- read side ----------------------------------------------------------
    def replica_summaries(self) -> List[Dict[str, Any]]:
        now = time.monotonic()
        stale = self.config.stale_after
        out = []
        for st in list(self._states.values()):
            status = st.status or {}
            degraded = status.get("degraded") or {}
            slo = status.get("slo") or {}
            out.append({
                "replica": st.name,
                "url": st.base,
                "up": st.up(now, stale),
                "lifecycle": status.get("lifecycle"),
                "lastScrapeAgeSec": (
                    round(now - st.last_ok, 3)
                    if st.last_ok is not None else None),
                "lastError": st.last_err,
                "scrapeSec": round(st.scrape_sec, 6),
                "servingWarm": status.get("servingWarm"),
                "requestCount": status.get("requestCount"),
                "degraded": degraded.get("active"),
                "nonfinite": degraded.get("nonfinite"),
                "sloBurning": slo.get("burning"),
                "hotKeys": (status.get("hotKeys") or {}).get("top"),
            })
        return out

    def fleet_status(self) -> Dict[str, Any]:
        now = time.monotonic()
        stale = self.config.stale_after
        states = list(self._states.values())
        n_up = sum(1 for s in states if s.up(now, stale))
        n_draining = sum(1 for s in states if s.draining)
        return {
            "server": "fleet",
            "replicasConfigured": len(states),
            "replicasUp": n_up,
            "replicasDraining": n_draining,
            "staleAfterSec": stale,
            "scrapeIntervalSec": self.config.scrape_interval_sec,
            # ptpu: allow[unguarded-shared-state] — a display-only read
            # of a monotone int: taking _cycle_lock here would park
            # every status request behind a cycle
            "cycles": self._cycles,
            "qps": self._qps_gauge.labels().value,
            "kneeQps": self._knee_qps,
            "capacityHeadroom": self._headroom_gauge.labels().value,
            "replicas": self.replica_summaries(),
            "slo": (self.slo.status() if self.slo is not None
                    else {"enabled": False}),
            "hotKeys": self.hot.snapshot(),
            "autoscale": (self.autoscaler.status()
                          if self.autoscaler is not None
                          else {"enabled": False}),
        }

    # -- trace fan-out ------------------------------------------------------
    def trace_lookup(self, trace_id: str) -> Dict[str, Any]:
        """Ask every replica's flight recorder for ``trace_id``;
        return the first hit annotated with the replica that held it.
        404s mean "not retained HERE" and fall through; only when no
        replica holds it does the fleet answer 404."""
        errors: Dict[str, str] = {}
        for st in list(self._states.values()):
            try:
                code, body = self.fetch(
                    st.base + "/trace.json?id=" + trace_id,
                    self.config.timeout_sec)
            except Exception as e:  # noqa: BLE001 — a dead replica
                errors[st.name] = str(e)  # can't veto the lookup
                continue
            if code == 200 and body is not None:
                return {"replica": st.name, "trace": body}
            errors[st.name] = f"status {code}"
        raise HTTPError(
            404, f"trace {trace_id!r} is not retained on any of "
                 f"{len(self._states)} replicas ({errors})")

    def trace_slowest(self, n: int) -> Dict[str, Any]:
        """The fleet's N slowest retained traces: every replica's
        ``?slowest=`` summaries merged and re-sorted by duration."""
        merged: List[Dict[str, Any]] = []
        for st in list(self._states.values()):
            try:
                code, body = self.fetch(
                    st.base + f"/trace.json?slowest={n}",
                    self.config.timeout_sec)
            except Exception:  # noqa: BLE001
                continue
            if code != 200 or not isinstance(body, dict):
                continue
            for t in body.get("traces") or []:
                t = dict(t)
                t["replica"] = st.name
                merged.append(t)
        merged.sort(key=lambda t: float(t.get("durationMs") or 0.0),
                    reverse=True)
        return {"traces": merged[:n]}

    def trace_status(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for st in list(self._states.values()):
            try:
                code, body = self.fetch(st.base + "/trace.json",
                                        self.config.timeout_sec)
                out[st.name] = body if code == 200 \
                    else {"error": f"status {code}"}
            except Exception as e:  # noqa: BLE001
                out[st.name] = {"error": str(e)}
        return out


class _HotProxy:
    """Indirection so the pio_hot_keys collector always reads the
    CURRENT merged sketch (the aggregator swaps a fresh one in every
    cycle; a collector bound to one instance would go stale)."""

    def __init__(self, agg: FleetAggregator) -> None:
        self._agg = agg

    def top(self, n: Optional[int] = None):
        return self._agg.hot.top(n)


def build_fleet_app(agg: FleetAggregator) -> HTTPApp:
    """The aggregator's HTTP surface, through the same
    :func:`mount_metrics` machinery every server in the repo uses:
    ``/metrics`` + ``/metrics.json`` + ``/status.json`` serve the
    MERGED registry (a fleet aggregator is itself scrapeable — fleets
    of fleets compose), plus the fleet-only routes."""
    app = HTTPApp(name="fleet")
    # runtime=False: pio_build_info / HBM / span collectors describe
    # ONE process — the aggregator's own would shadow nothing useful,
    # and the merged pio_span_seconds from replicas must stay the only
    # source of that family. tracer=False: the aggregator's requests
    # are not the traffic worth flight-recording.
    mount_metrics(app, agg.registry, server_name="fleet",
                  status=agg.fleet_status, runtime=False, tracer=False)
    _auth = make_key_auth(agg.config.accesskey)

    @app.route("GET", "/fleet.json")
    def fleet_json(req: Request) -> Response:
        return json_response(agg.fleet_status())

    @app.route("GET", "/slo.json")
    def slo_json(req: Request) -> Response:
        return json_response(
            agg.slo.status() if agg.slo is not None
            else {"enabled": False})

    @app.route("GET", "/hotkeys.json")
    def hotkeys_json(req: Request) -> Response:
        try:
            n = int(req.query.get("n", "16"))
        except ValueError:
            raise HTTPError(400, "n must be an integer")
        return json_response({
            "fleet": agg.hot.top(n),
            "replicas": {
                r["replica"]: r["hotKeys"]
                for r in agg.replica_summaries()},
        })

    @app.route("GET", "/trace.json")
    def trace_json(req: Request) -> Response:
        trace_id = req.query.get("id")
        if trace_id:
            return json_response(agg.trace_lookup(trace_id))
        if "slowest" in req.query:
            try:
                n = int(req.query["slowest"])
            except ValueError:
                raise HTTPError(400, "slowest must be an integer")
            return json_response(agg.trace_slowest(n))
        return json_response(agg.trace_status())

    @app.route("POST", "/scrape")
    def scrape(req: Request) -> Response:
        _auth(req)
        return json_response({"outcomes": agg.scrape_cycle(),
                              "cycles": agg._cycles})

    @app.route("POST", "/scale")
    def scale(req: Request) -> Response:
        _auth(req)
        if agg.autoscaler is None:
            raise HTTPError(
                404, "no autoscaler is attached to this fleet "
                     "(deploy with --autoscale)")
        to = req.query.get("to")
        reason = req.query.get("reason", "")
        if to is None and req.body:
            body = req.json()
            if isinstance(body, dict):
                to = body.get("to")
                reason = body.get("reason", reason)
        if to is None:
            raise HTTPError(400, "need ?to=N or a {\"to\": N} body")
        try:
            n = int(to)
        except (TypeError, ValueError):
            raise HTTPError(400, "to must be an integer")
        granted = agg.autoscaler.request_target(
            n, reason or "POST /scale")
        return json_response({"requested": n, "target": granted,
                              "autoscale": agg.autoscaler.status()})

    @app.route("GET", "/route.json")
    def route_json(req: Request) -> Response:
        if agg.router is None:
            raise HTTPError(
                404, "no query router is attached to this fleet "
                     "(deploy with --autoscale / router enabled)")
        out = agg.router.status()
        key = req.query.get("key")
        if key is not None:
            out["key"] = key
            out["affinity"] = agg.router.route_key(key)
            out["preference"] = agg.router.preference(
                key, agg.router.config.spill_fanout
                + agg.router.config.retries)
        return json_response(out)

    @app.route("GET", "/")
    def index(req: Request) -> Response:
        import html

        status = agg.fleet_status()
        rows = []
        for r in status["replicas"]:
            rows.append(
                "<tr><td>%s</td><td>%s</td><td>%s</td><td>%s</td>"
                "<td>%s</td></tr>" % (
                    html.escape(str(r["replica"])),
                    "up" if r["up"] else "DOWN",
                    html.escape(str(r["lastScrapeAgeSec"])),
                    html.escape(str(r["requestCount"])),
                    html.escape(str(r["sloBurning"] or []))))
        hot_rows = "".join(
            f"<li>{html.escape(str(k['key']))}: {k['count']:.0f} "
            f"(&plusmn;{k['error']:.0f})</li>"
            for k in status["hotKeys"]["top"][:10])
        body = f"""<html><head><title>predictionio_tpu_torch fleet</title>
</head><body><h1>Fleet: {status['replicasUp']}/{
            status['replicasConfigured']} replicas up</h1>
<ul>
<li>scrape cycles: {status['cycles']} (every {
            status['scrapeIntervalSec']}s)</li>
<li>fleet qps: {status['qps']:.2f}</li>
<li>capacity headroom: {status['capacityHeadroom']:.3f} (knee {
            status['kneeQps']})</li>
<li>fleet SLO burning: {html.escape(str(
            (status['slo'] or {}).get('burning', [])))}</li>
</ul>
<table border='1'><tr><th>replica</th><th>state</th>
<th>scrape age (s)</th><th>requests</th><th>burning</th></tr>
{''.join(rows)}</table>
<h2>Hot keys (fleet-wide)</h2><ul>{hot_rows}</ul>
<p><a href='/fleet.json'>fleet.json</a> ·
<a href='/metrics'>merged metrics</a> ·
<a href='/slo.json'>slo.json</a> ·
<a href='/hotkeys.json'>hotkeys.json</a> ·
<a href='/trace.json?slowest=10'>slowest traces</a></p>
</body></html>"""
        return Response(body=body, content_type="text/html")

    @app.route("POST", "/stop")
    def stop(req: Request) -> Response:
        _auth(req)

        def _later() -> None:
            time.sleep(0.25)  # let the response flush first
            agg.stop()
            srv = app_server_ref[0]
            if srv is not None:
                srv.close()

        threading.Thread(target=_later, daemon=True,
                         name="fleet-stop").start()
        return json_response({"stopping": True})

    app_server_ref: List[Optional[AppServer]] = [None]
    app.server_ref = app_server_ref  # type: ignore[attr-defined]
    return app


def create_fleet_server(config: FleetConfig, host: str = "0.0.0.0",
                        port: int = 8200, fetch=None,
                        ssl_context=None
                        ) -> Tuple[FleetAggregator, AppServer]:
    """Aggregator + its HTTP server, started (scrape loop + SLO
    engine running; caller picks ``serve_forever`` vs
    ``start_background``). Closing the server stops the aggregator."""
    agg = FleetAggregator(config, fetch=fetch)
    app = build_fleet_app(agg)
    server = AppServer(app, host=host, port=port,
                       ssl_context=ssl_context)
    app.server_ref[0] = server  # type: ignore[attr-defined]
    server.on_close(agg.stop)
    agg.start()
    return agg, server
