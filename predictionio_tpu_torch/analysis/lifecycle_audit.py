"""``audit-lifecycle`` — the runtime resource-leak audit (the port of
``predictionio_tpu/analysis/lifecycle_audit.py``).

The static lifecycle rules (:mod:`.lifecycle`) catch the leaks the AST
can see — a spawned thread with no join path, a queue with no bound.
This module catches the ones only a running process shows: it BOOTS
each of the port's subsystems (event / storage / engine servers, the
stream trainer, the fleet aggregator, the router autoscaler + replica
lifecycle), drives full start→serve→stop cycles, and snapshots the
process before and after:

- ``threads`` — entries under ``/proc/self/task``;
- ``fds``     — entries under ``/proc/self/fd``;
- ``sockets`` — fds whose readlink target is a socket.

Each entry runs one un-measured warm-up cycle first (lazy imports,
logging handlers, interpreter pools, and on the card the CUDA context,
its runtime's threads and ``/dev/nvidia*`` fds and the kernel libraries'
load — one-time costs are not leaks), then ``cycles`` measured cycles.
Anything still held after a gc+settle loop is the per-entry leak
census. A subsystem that leaks one thread per cycle shows ``threads >=
cycles`` here — exactly the daemon the static ``leaked-thread`` rule
points at.

The census gates against a committed golden manifest
(``analysis/lifecycle_baseline.json``, all zeros) with ratchet
semantics:

- a leak count above the recorded one FAILS, naming the entry and the
  resource (the recorded value is the *allowed* leak — ideally 0);
- an entry the baseline never recorded FAILS (record deliberately
  with ``--baseline-grow``);
- counts below the record print as shrinkable, and
  ``--write-baseline`` only ever ratchets the file down.

The entries run on the CUDA card unless ``device="cpu"`` is passed (the
engine and stream entries train, serve and fold in through the kernels
there); without CUDA and without ``device="cpu"`` :func:`run_audit`
raises :class:`AuditError`. Each entry's setup is called with the resolved
``torch.device``. Everything servers-flavored (torch included) imports
lazily inside the entries' setup functions. Entries bind HTTP listeners to
``127.0.0.1:0`` (ephemeral ports).
"""

from __future__ import annotations

import gc
import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple



class AuditError(RuntimeError):
    """Environment/usage errors (no card, unknown entry, a broken
    fixture)."""


MANIFEST_VERSION = 1

#: measured start→serve→stop cycles per entry (after one warmup)
DEFAULT_CYCLES = 3

#: how long the settle loop waits for lazily-released resources
#: (executor reaper threads, GC-driven socket closes) to drain before
#: the after-snapshot is final
SETTLE_SEC = 5.0

DEFAULT_BASELINE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "lifecycle_baseline.json")

RESOURCES = ("threads", "fds", "sockets")


# ---------------------------------------------------------------------------
# process snapshots
# ---------------------------------------------------------------------------

def snapshot() -> Dict[str, int]:
    """Count this process's threads / fds / socket-fds via ``/proc``.
    Off Linux (no ``/proc/self``) threads fall back to
    ``threading.active_count()`` and fd counts read as 0 — the thread
    gate still works everywhere the CI runs."""
    task_dir = "/proc/self/task"
    fd_dir = "/proc/self/fd"
    if not os.path.isdir(task_dir):
        import threading

        return {"threads": threading.active_count(),
                "fds": 0, "sockets": 0}
    threads = len(os.listdir(task_dir))
    fds = 0
    sockets = 0
    for fd in os.listdir(fd_dir):
        fds += 1
        try:
            if os.readlink(os.path.join(fd_dir, fd)).startswith(
                    "socket:"):
                sockets += 1
        except OSError:
            pass  # the fd closed between listdir and readlink
    return {"threads": threads, "fds": fds, "sockets": sockets}


def _leak(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    return {k: max(0, after.get(k, 0) - before.get(k, 0))
            for k in RESOURCES}


def _settle(before: Dict[str, int],
            settle_sec: float = SETTLE_SEC) -> Dict[str, int]:
    """Re-snapshot until the census returns to ``before`` (or the
    budget runs out): a thread mid-exit or a socket awaiting GC is
    lag, not a leak — but anything still held past ``settle_sec`` is
    charged."""
    deadline = time.monotonic() + max(settle_sec, 0.0)
    while True:
        gc.collect()
        now = snapshot()
        if not any(_leak(before, now).values()) \
                or time.monotonic() >= deadline:
            return now
        time.sleep(0.05)


# ---------------------------------------------------------------------------
# entry points
#
# Each setup function runs the one-time work (training a model, seeding a
# storage) and returns the ``cycle()`` callable the harness measures.
# One cycle = start the subsystem, exercise it, stop it — everything
# the subsystem allocated for the cycle must be released by the stop.
# ---------------------------------------------------------------------------

def _http_get(port: int, path: str) -> int:
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}")
    with urllib.request.urlopen(req, timeout=10) as resp:
        resp.read()
        return resp.status


def _http_post(port: int, path: str, body: dict) -> int:
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            resp.read()
            return resp.status
    except urllib.error.HTTPError as e:
        e.read()
        return e.code


def _mem_storage():
    from ..data.storage.registry import Storage

    return Storage(env={"PIO_STORAGE_SOURCES_MEM_TYPE": "memory"})


def _entry_event_server(device) -> Callable[[], None]:
    from ..data.storage.base import AccessKey, App
    from ..server.eventserver import create_event_server

    storage = _mem_storage()
    app_id = storage.apps().insert(App(0, "auditapp"))
    storage.events().init(app_id)
    storage.access_keys().insert(
        AccessKey(key="AUDITKEY", app_id=app_id, events=[]))

    def cycle() -> None:
        srv = create_event_server(storage, "127.0.0.1", 0)
        srv.start_background()
        try:
            _http_post(
                srv.port, "/events.json?accessKey=AUDITKEY",
                {"event": "rate", "entityType": "user", "entityId": "u0",
                 "targetEntityType": "item", "targetEntityId": "i0",
                 "properties": {"rating": 5}})
        finally:
            srv.close()

    return cycle


def _entry_storage_server(device) -> Callable[[], None]:
    from ..server.storageserver import create_storage_server

    storage = _mem_storage()

    def cycle() -> None:
        srv = create_storage_server(storage, "127.0.0.1", 0)
        srv.start_background()
        try:
            _http_get(srv.port, "/v1/status")
        finally:
            srv.close()

    return cycle


def _trained_recommender(device):
    """Seed + train the small recommendation fixture once on ``device``;
    returns everything a cycle needs to bind a QueryServer."""
    import numpy as np

    from ..controller.context import Context
    from ..data.datamap import DataMap
    from ..data.event import Event
    from ..data.storage.base import App
    from ..templates.recommendation import (
        default_engine_params,
        recommendation_engine,
    )
    from ..workflow.core import run_train

    storage = _mem_storage()
    app_id = storage.apps().insert(App(0, "auditapp"))
    es = storage.events()
    es.init(app_id)
    rng = np.random.default_rng(11)
    events = []
    for u in range(16):
        for i in rng.choice(16, size=5, replace=False):
            events.append(Event(
                event="rate", entity_type="user", entity_id=f"u{u}",
                target_entity_type="item", target_entity_id=f"i{i}",
                properties=DataMap(
                    {"rating": float(rng.integers(1, 6))})))
    es.insert_batch(events, app_id)
    ctx = Context(device=str(device), app_name="auditapp", _storage=storage)
    engine = recommendation_engine()
    ep = default_engine_params("auditapp", rank=4, num_iterations=2,
                               seed=5)
    run_train(ctx, engine, ep, engine_id="audit", engine_version="1")
    return ctx, engine, ep


def _bind_query_server(ctx, engine, ep, **cfg):
    """One served binding without the deploy() registry ceremony:
    latest COMPLETED instance → models → QueryServer on the context's
    device."""
    from ..server.engineserver import QueryServer, ServerConfig
    from ..workflow import core as wf

    instance = ctx.storage.engine_instances().get_latest_completed(
        "audit", "1", "engine.json")
    if instance is None:
        raise AuditError("engine fixture did not train")
    models = wf.load_models_for_deploy(ctx, engine, instance, ep)
    return QueryServer(engine, ep, models,
                       ServerConfig(device=ctx.device, warm_start=False,
                                    **cfg),
                       instance=instance, ctx=ctx)


def _entry_engine_server(device) -> Callable[[], None]:
    from ..server.engineserver import create_engine_server

    ctx, engine, ep = _trained_recommender(device)

    def cycle() -> None:
        qs = _bind_query_server(ctx, engine, ep)
        srv = create_engine_server(qs, "127.0.0.1", 0)
        srv.start_background()
        try:
            _http_post(srv.port, "/queries.json",
                       {"user": "u1", "num": 3})
        finally:
            srv.close()  # closes the QueryServer too

    return cycle


def _entry_stream_trainer(device) -> Callable[[], None]:
    from ..cache.bus import InvalidationBus
    from ..streaming.trainer import StreamConfig, StreamTrainer

    ctx, engine, ep = _trained_recommender(device)

    def cycle() -> None:
        qs = _bind_query_server(ctx, engine, ep)
        trainer = StreamTrainer(
            qs, StreamConfig(app_name="auditapp", interval_ms=20,
                             consumer="audit-lifecycle"),
            bus=InvalidationBus())
        trainer.start()
        try:
            trainer.consume_once()
        finally:
            trainer.stop()
            qs.close()

    return cycle


def _entry_fleet(device) -> Callable[[], None]:
    """Fleet aggregator over two fake replicas behind an injected
    fetch (socket-free): start the scrape loop, let it merge a few
    cycles, stop."""
    from ..fleet.aggregator import FleetAggregator, FleetConfig
    from ..obs import MetricsRegistry

    reg = MetricsRegistry()
    # ptpu: allow[metric-catalog-drift] — fixture registry local to
    # the audit cycle; the family mimics a replica export and never
    # lands on a real /metrics surface
    reg.counter("pio_queries_total", "served queries").inc(7)
    export = reg.export()

    def fetch(url: str, timeout: float) -> Tuple[int, dict]:
        if url.endswith("/metrics.json"):
            return 200, export
        return 200, {"servingWarm": True}

    def cycle() -> None:
        agg = FleetAggregator(
            FleetConfig(replicas=["r0:1", "r1:1"],
                        scrape_interval_sec=0.02,
                        slo_interval_sec=0.0),
            fetch=fetch)
        agg.start()
        try:
            agg.scrape_cycle()
        finally:
            agg.stop()

    return cycle


def _entry_router_autoscaler(device) -> Callable[[], None]:
    """Replica lifecycle (worker threads per managed replica) + the
    autoscaler control loop, with injected spawn/probe — no sockets,
    no real replicas."""
    from ..router.autoscaler import AutoscalePolicy, Autoscaler
    from ..router.lifecycle import ReplicaLifecycle
    from ..router.router import QueryRouter

    class _Signals:
        slo = None

        def capacity_signals(self):
            return {"qps": 0.0, "kneeQps": 100.0, "headroom": 0.9}

        def replica_health(self, name):
            return "up"

        def add_replica(self, base):
            pass

        def remove_replica(self, name):
            pass

    def cycle() -> None:
        ports = iter(range(9800, 9900))

        def spawn():
            return f"127.0.0.1:{next(ports)}", lambda: None

        signals = _Signals()
        router = QueryRouter()
        lc = ReplicaLifecycle(
            spawn, router=router, aggregator=signals,
            probe=lambda base, t: {"servingWarm": True},
            notify_drain=lambda base, t: None,
            poll_interval_sec=0.01, drain_deadline_sec=0.1)
        asc = Autoscaler(signals, lc,
                         AutoscalePolicy(min_replicas=1, max_replicas=2,
                                         interval_sec=0.02))
        asc.start()
        try:
            lc.scale_out(reason="audit cycle")
            lc.scale_out(reason="audit cycle")
            lc.await_ready(2, timeout_sec=5.0)
        finally:
            asc.stop()
            lc.close(stop_replicas=True)

    return cycle


#: name → (setup, one-line description); ordered — the manifest and
#: the CI artifact list entries in this order
ENTRY_POINTS: Dict[str, Tuple[Callable[..., Callable[[], None]], str]] = {
    "event_server": (
        _entry_event_server,
        "event server bind → ingest one event → shutdown"),
    "storage_server": (
        _entry_storage_server,
        "storage server bind → healthz → shutdown"),
    "engine_server": (
        _entry_engine_server,
        "engine server bind → one query → shutdown + close"),
    "stream_trainer": (
        _entry_stream_trainer,
        "stream trainer start → one consume pass → stop"),
    "fleet": (
        _entry_fleet,
        "fleet aggregator (2 fake replicas) scrape loop start → stop"),
    "router_autoscaler": (
        _entry_router_autoscaler,
        "replica lifecycle scale-out + autoscaler loop start → close"),
}


def run_audit(names: Optional[Sequence[str]] = None,
              cycles: int = DEFAULT_CYCLES,
              settle_sec: float = SETTLE_SEC,
              entry_points: Optional[dict] = None,
              device=None) -> dict:
    """Boot + cycle every (selected) entry point on ``device`` (the card
    unless ``"cpu"``); returns the manifest dict. ``entry_points``
    overrides the registry (tests inject deliberately-leaky fixtures);
    each setup is called with the resolved ``torch.device``."""
    registry = ENTRY_POINTS if entry_points is None else entry_points
    unknown = set(names or ()) - set(registry)
    if unknown:
        raise AuditError(f"unknown entry point(s): {sorted(unknown)} "
                         f"(have: {sorted(registry)})")
    from ..utils.device import resolve_device

    try:
        dev = resolve_device(device)
    except (RuntimeError, ValueError) as e:
        raise AuditError(str(e)) from e
    entries: Dict[str, Dict[str, int]] = {}
    for name, (setup, _desc) in registry.items():
        if names and name not in names:
            continue
        try:
            cycle = setup(dev)
        except AuditError:
            raise
        except Exception as e:  # noqa: BLE001 — a broken fixture is an
            raise AuditError(    # environment error, not a leak
                f"{name}: entry setup failed: {e}") from e
        cycle()  # warm-up: lazy imports, the CUDA context, the kernels
        before = _settle(snapshot(), settle_sec)
        for _ in range(max(cycles, 1)):
            cycle()
        after = _settle(before, settle_sec)
        entries[name] = _leak(before, after)
    return {"version": MANIFEST_VERSION, "cycles": max(cycles, 1),
            "entries": entries}


# ---------------------------------------------------------------------------
# manifest I/O + ratchet diff
# ---------------------------------------------------------------------------

def load_manifest(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as fh:
        doc = json.load(fh)
    if not isinstance(doc, dict) \
            or doc.get("version") != MANIFEST_VERSION:
        raise ValueError(f"{path}: not an audit-lifecycle manifest "
                         f"(expected version {MANIFEST_VERSION})")
    return doc


def write_manifest(path: str, manifest: dict,
                   cap: Optional[dict] = None) -> None:
    """Persist the manifest. With ``cap`` (the previously committed
    baseline) the write RATCHETS: entries the old baseline never held
    are dropped and every leak count clamps to the recorded value —
    the allowed leak only ever shrinks (``--baseline-grow`` writes
    as-is)."""
    doc = manifest
    if cap is not None:
        old = cap.get("entries", {})
        entries: Dict[str, Dict[str, int]] = {}
        for name, rec in manifest.get("entries", {}).items():
            if name not in old:
                continue
            orec = old[name]
            entries[name] = {k: min(rec.get(k, 0), orec.get(k, 0))
                             for k in RESOURCES}
        doc = {"version": MANIFEST_VERSION,
               "cycles": manifest.get("cycles", DEFAULT_CYCLES),
               "entries": entries}
    from .baseline import atomic_write_text

    atomic_write_text(
        path, json.dumps(doc, indent=2, sort_keys=True) + "\n")


def diff_manifests(current: dict, baseline: dict
                   ) -> Tuple[List[str], List[str]]:
    """(violations, shrinkable) between a fresh census and the golden
    baseline. Violations name the entry, the resource and both counts
    — the line an operator greps for."""
    violations: List[str] = []
    shrinkable: List[str] = []
    cur = current.get("entries", {})
    base = baseline.get("entries", {})
    cycles = current.get("cycles", DEFAULT_CYCLES)
    for name, rec in cur.items():
        brec = base.get(name)
        if brec is None:
            violations.append(
                f"{name}: entry point not in the baseline — record it "
                f"deliberately with --write-baseline --baseline-grow")
            continue
        for res in RESOURCES:
            c = rec.get(res, 0)
            b = brec.get(res, 0)
            if c > b:
                per_cycle = (f" (~{c / cycles:.1f} per cycle over "
                             f"{cycles} cycles)" if cycles else "")
                violations.append(
                    f"{name}: leaked {c} {res} across the measured "
                    f"cycles, baseline allows {b}{per_cycle} — a "
                    f"start→stop cycle is not releasing everything it "
                    f"started. Find the owner with the static rules "
                    f"(ptpu check: leaked-thread) or py-spy dump, fix "
                    f"its stop/close, or record deliberately with "
                    f"--baseline-grow")
            elif c < b:
                shrinkable.append(
                    f"{name}: {res} leak recorded {b}, found {c}")
    for name in base:
        if name not in cur:
            shrinkable.append(f"{name}: entry point no longer audited")
    return violations, shrinkable


def format_text(manifest: dict) -> str:
    lines: List[str] = []
    cycles = manifest.get("cycles", DEFAULT_CYCLES)
    for name, rec in manifest.get("entries", {}).items():
        leaks = {k: v for k, v in rec.items() if v}
        if leaks:
            detail = ", ".join(f"{k} +{v}"
                               for k, v in sorted(leaks.items()))
            lines.append(f"{name}: LEAKING over {cycles} cycles — "
                         f"{detail}")
        else:
            lines.append(f"{name}: clean over {cycles} cycles")
    return "\n".join(lines)


__all__ = (
    "AuditError",
    "DEFAULT_BASELINE",
    "DEFAULT_CYCLES",
    "ENTRY_POINTS",
    "MANIFEST_VERSION",
    "RESOURCES",
    "SETTLE_SEC",
    "diff_manifests",
    "format_text",
    "load_manifest",
    "run_audit",
    "snapshot",
    "write_manifest",
)
