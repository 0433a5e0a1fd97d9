"""Storage server: the event log and the metadata DAOs over HTTP (the
port's own copy of ``predictionio_tpu/server/storageserver.py``, with its
protocol, so the REMOTE client of either package talks to it).

A host with no shared filesystem reaches its event store through this
server, which fronts any local backend (SQLite by default, SEGMENTFS on a
pod's shared mount). The REMOTE backend (``data/storage/remote.py``)
speaks its protocol behind the ``EventStore`` and DAO contracts. JSON
unless noted; with a secret, every route wants it in the
``X-PIO-Storage-Secret`` header:

- ``POST /v1/events/<app>/init|remove|batch|delete|find|aggregate``
- ``POST /v1/events/<app>/import_jsonl``: a block of JSON lines, through
  the backing store's own bulk lane, all or nothing
- ``GET  /v1/events/<app>/get?id=``
- ``GET  /v1/events/<app>/columnar``: the ``.npz`` training read, with
  an ``ETag`` (a matching ``If-None-Match`` answers 304)
- ``POST /v1/events/<app>/columnar``: an ``.npz`` block, ingested all or
  nothing
- ``POST /v1/meta/<dao>/<method>``: the DAO methods listed below
- ``GET  /v1/status``

It mounts ``/metrics`` (``server/http.py::mount_metrics``): request ids,
latency by route, and the columnar reads by outcome (hit = 304) and the
bytes they served. Sharded reads (``shard_i``/``shard_n``) answer 501
(``ROADMAP.md`` queue 1, item 13).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import logging
import threading
import time
import weakref
from datetime import datetime
from typing import Optional

import numpy as np

from ..data.event import Event
from ..data.storage.base import EventFilter, JsonlImportError, Model
from ..data.storage.registry import Storage
from ..data.storage.wire import (
    batch_from_npz,
    batch_to_npz,
    entity_from_doc,
    entity_to_doc,
    filter_from_doc,
)
from ..obs import MetricsRegistry
from .http import AppServer, HTTPApp, HTTPError, Request, Response, \
    json_response, mount_metrics

log = logging.getLogger(__name__)

#: DAO → RPC methods exposed (exactly the DAO contracts in base.py)
_META_METHODS = {
    "apps": {"insert", "get", "get_by_name", "get_all", "update",
             "delete"},
    "access_keys": {"insert", "get", "get_all", "get_by_app_id",
                    "update", "delete"},
    "channels": {"insert", "get", "get_by_app_id", "delete"},
    "engine_instances": {"insert", "get", "get_all", "update", "delete",
                         "get_completed"},
    "evaluation_instances": {"insert", "get", "get_all",
                             "get_completed", "update", "delete"},
    "models": {"insert", "get", "delete"},
}


#: (app_id, channel, with_props, float_props) -> (weakref(event column),
#: version). The training read gets a fresh view a select, but
#: every view shares its parent's ``event`` array, which the backend's
#: cache keeps alive (and replaces) exactly when the log changes.
_VER_MEMO: dict = {}
_VER_LOCK = threading.Lock()


def _batch_version(batch, memo_key) -> str:
    """Content stamp of a batch for its ETag: a sha256 over every byte of
    every column, memoized by request identity and anchored (by weakref)
    to the root buffer of the batch's ``event`` column, which survives
    zero-copy selects and is replaced exactly when the backend
    re-encodes."""
    anchor = batch.event
    while getattr(anchor, "base", None) is not None:
        anchor = anchor.base
    with _VER_LOCK:
        ent = _VER_MEMO.get(memo_key)
    if ent is not None and ent[0]() is anchor:
        return ent[1]
    h = hashlib.sha256()
    h.update(str(batch.n).encode())
    cols = [batch.event, batch.entity_type, batch.entity_id,
            batch.target_type, batch.target_id, batch.event_time,
            batch.props_offsets, batch.props_blob]
    cols += [batch.float_props[k] for k in sorted(batch.float_props)]
    for arr in cols:
        # ptpu: allow[host-sync-in-hot-path] — the batch's columns are
        # host numpy: the storage server never holds a tensor
        a = np.asarray(arr, order="C")
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    version = h.hexdigest()[:32]
    try:
        ref = weakref.ref(anchor)
    except TypeError:
        ref = lambda: None  # noqa: E731 — an anchor without weakrefs
    with _VER_LOCK:
        if len(_VER_MEMO) >= 4096:
            # keys carry client-chosen params: bound the table, dead
            # anchors first
            for k in [k for k, (r, _) in _VER_MEMO.items() if r() is None]:
                del _VER_MEMO[k]
            if len(_VER_MEMO) >= 4096:
                _VER_MEMO.clear()
        _VER_MEMO[memo_key] = (ref, version)
    return version


def build_app(storage: Storage, secret: Optional[str] = None) -> HTTPApp:
    """The storage server's routes over ``storage``."""
    app = HTTPApp("storageserver")

    # the columnar reads' ETag hits and bytes ride beside the per-route
    # latency: steady-state training reads should be nearly all hits
    registry = MetricsRegistry()
    columnar_reqs = registry.counter(
        "pio_columnar_requests_total",
        "Columnar bulk reads by outcome (hit = 304 ETag match)")
    columnar_bytes = registry.counter(
        "pio_columnar_bytes_total",
        "npz payload bytes served by columnar bulk reads")
    ingest_block_events = registry.counter(
        "pio_ingest_block_events_total",
        "events written via columnar block ingest")
    ingest_block_bytes = registry.counter(
        "pio_ingest_block_bytes_total",
        "npz payload bytes received by columnar block ingest")
    ingest_block_seconds = registry.histogram(
        "pio_ingest_block_seconds",
        "wall time of one columnar block decode+insert",
        bounds=[0.001, 0.005, 0.025, 0.1, 0.5, 2.0])
    mount_metrics(app, registry, server_name="storageserver",
                  status=lambda: {"status": "alive"})
    app.metrics_registry = registry  # type: ignore[attr-defined]

    def hdr(req: Request, name: str) -> str:
        # Request.headers preserves as-sent case; match insensitively
        for k, v in req.headers.items():
            if k.lower() == name:
                return v
        return ""

    def auth(req: Request) -> None:
        if secret and not hmac.compare_digest(
                hdr(req, "x-pio-storage-secret"), secret):
            raise HTTPError(401, "Invalid storage secret.")

    def chan(req: Request) -> Optional[int]:
        c = req.query.get("channel")
        return int(c) if c else None

    @app.route("GET", r"/v1/status")
    def status(req: Request) -> Response:
        auth(req)
        return json_response({"status": "alive"})

    # -- events ------------------------------------------------------------
    @app.route("POST", r"/v1/events/(?P<app_id>\d+)/init")
    def ev_init(req: Request) -> Response:
        auth(req)
        ok = storage.events().init(int(req.path_params["app_id"]),
                                   chan(req))
        return json_response({"ok": bool(ok)})

    @app.route("POST", r"/v1/events/(?P<app_id>\d+)/remove")
    def ev_remove(req: Request) -> Response:
        auth(req)
        ok = storage.events().remove(int(req.path_params["app_id"]),
                                     chan(req))
        return json_response({"ok": bool(ok)})

    @app.route("POST", r"/v1/events/(?P<app_id>\d+)/batch")
    def ev_batch(req: Request) -> Response:
        auth(req)
        events = [Event.from_json(d) for d in req.json()]
        ids = storage.events().insert_batch(
            events, int(req.path_params["app_id"]), chan(req))
        return json_response({"ids": ids})

    @app.route("POST", r"/v1/events/(?P<app_id>\d+)/import_jsonl")
    def ev_import(req: Request) -> Response:
        """Bulk import of a block of API-format JSON lines through the
        backing store's ``import_jsonl`` (SEGMENTFS: the native codec).
        An error comes back as a 200 with an ``error`` document holding
        the block's durable prefix, which the client re-anchors to the
        file's line numbers."""
        auth(req)
        try:
            # a chunk larger than any block: the whole POST commits all
            # or nothing, so the client's count of acknowledged lines is
            # exact
            n = storage.events().import_jsonl(
                req.body, int(req.path_params["app_id"]), chan(req),
                chunk=1 << 62)
        except JsonlImportError as e:
            return json_response({"error": {
                "lineno": e.lineno,
                "committed_lines": e.committed_lines,
                "committed_events": e.committed_events,
                "message": str(e.cause)}})
        return json_response({"imported": n})

    @app.route("GET", r"/v1/events/(?P<app_id>\d+)/get")
    def ev_get(req: Request) -> Response:
        auth(req)
        e = storage.events().get(req.query.get("id", ""),
                                 int(req.path_params["app_id"]),
                                 chan(req))
        return json_response({"event": e.to_json() if e else None})

    @app.route("POST", r"/v1/events/(?P<app_id>\d+)/delete")
    def ev_delete(req: Request) -> Response:
        auth(req)
        ok = storage.events().delete(req.json()["id"],
                                     int(req.path_params["app_id"]),
                                     chan(req))
        return json_response({"ok": bool(ok)})

    @app.route("POST", r"/v1/events/(?P<app_id>\d+)/find")
    def ev_find(req: Request) -> Response:
        auth(req)
        f = filter_from_doc(req.json())
        out = [e.to_json() for e in storage.events().find(
            int(req.path_params["app_id"]), chan(req), f)]
        return json_response({"events": out})

    @app.route("POST", r"/v1/events/(?P<app_id>\d+)/aggregate")
    def ev_aggregate(req: Request) -> Response:
        auth(req)
        d = req.json() or {}

        def dt(s):
            return datetime.fromisoformat(s) if s else None

        props = storage.events().aggregate_properties(
            int(req.path_params["app_id"]), chan(req),
            entity_type=d["entity_type"],
            start_time=dt(d.get("start_time")),
            until_time=dt(d.get("until_time")),
            required=d.get("required"))
        return json_response({"properties": {
            k: {"fields": v.to_dict(),
                "first_updated": v.first_updated.isoformat(),
                "last_updated": v.last_updated.isoformat()}
            for k, v in props.items()}})

    @app.route("GET", r"/v1/events/(?P<app_id>\d+)/columnar")
    def ev_columnar(req: Request) -> Response:
        auth(req)
        with_props = req.query.get("props", "1") != "0"
        fp = tuple(p for p in
                   (req.query.get("float_props") or "rating").split(",")
                   if p)
        if req.query.get("shard_n"):
            raise HTTPError(501, "sharded columnar reads are not ported "
                                 "yet (ROADMAP.md queue 1, item 13)")
        batch = storage.events().find_columnar(
            int(req.path_params["app_id"]), chan(req), EventFilter(),
            float_props=fp, ordered=False, with_props=with_props)
        version = _batch_version(
            batch, (int(req.path_params["app_id"]), chan(req), with_props,
                    fp))
        headers = {"ETag": version}
        if hdr(req, "if-none-match") == version:
            columnar_reqs.labels(outcome="hit").inc()
            return Response(status=304, body=b"", headers=headers)
        payload = batch_to_npz(batch)
        columnar_reqs.labels(outcome="miss").inc()
        columnar_bytes.inc(len(payload))
        return Response(status=200, body=payload,
                        content_type="application/octet-stream",
                        headers=headers)

    @app.route("POST", r"/v1/events/(?P<app_id>\d+)/columnar")
    def ev_columnar_ingest(req: Request) -> Response:
        """Block ingest in the npz format the bulk read serves: the
        backend's ``insert_columnar`` writes it all or nothing."""
        auth(req)
        try:
            batch = batch_from_npz(req.body)
        except Exception as e:
            raise HTTPError(400, f"bad columnar block: {e}")
        t0 = time.perf_counter()
        n = storage.events().insert_columnar(
            batch, int(req.path_params["app_id"]), chan(req))
        ingest_block_seconds.observe(time.perf_counter() - t0)
        ingest_block_events.inc(n)
        ingest_block_bytes.inc(len(req.body))
        return json_response({"accepted": n})

    # -- metadata ----------------------------------------------------------
    @app.route("POST", r"/v1/meta/(?P<dao>[a-z_]+)/(?P<method>[a-z_]+)")
    def meta_rpc(req: Request) -> Response:
        auth(req)
        dao_name = req.path_params["dao"]
        method = req.path_params["method"]
        allowed = _META_METHODS.get(dao_name)
        if allowed is None or method not in allowed:
            raise HTTPError(404, f"unknown RPC {dao_name}/{method}")
        dao = getattr(storage, dao_name)()
        body = req.json() or {}
        args = body.get("args", [])
        if dao_name == "models":
            if method == "insert":
                m = body["model"]
                dao.insert(Model(id=m["id"],
                                 models=base64.b64decode(m["models"])))
                return json_response({"ok": True})
            if method == "get":
                m = dao.get(*args)
                return json_response({"model": None if m is None else {
                    "id": m.id,
                    "models": base64.b64encode(m.models).decode()}})
            dao.delete(*args)
            return json_response({"ok": True})
        if "entity" in body:
            args = [entity_from_doc(dao_name, body["entity"])] + args
        result = getattr(dao, method)(*args)
        if result is None or isinstance(result, (int, str)):
            return json_response({"result": result})
        if isinstance(result, list):
            return json_response(
                {"entities": [entity_to_doc(e) for e in result]})
        return json_response({"entity": entity_to_doc(result)})

    return app


def create_storage_server(storage: Optional[Storage] = None,
                          host: str = "0.0.0.0", port: int = 7077,
                          secret: Optional[str] = None,
                          ssl_context=None) -> AppServer:
    """Bind the storage server (default port 7077), not yet serving: call
    ``start_background()`` or ``serve_forever()``; ``close()`` joins its
    serving thread."""
    return AppServer(build_app(storage or Storage(), secret=secret),
                     host, port, ssl_context=ssl_context)
