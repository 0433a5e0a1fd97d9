"""S3 object-store storage backend (the port's own copy of
``predictionio_tpu/data/storage/objectstore.py``, whose bucket layout it
keeps: both packages' clients share one bucket).

It speaks the S3 REST subset every object store has: ``PUT/GET/DELETE
/bucket/key`` and ``GET /bucket?prefix&marker`` (ListObjects V1 XML,
lexicographic keys, marker pagination, ETags).
``PIO_STORAGE_SOURCES_<N>_ENDPOINT`` names any S3-compatible endpoint
with its bucket (MinIO, a GCS XML-API bucket, a proxy that signs for
AWS); ``..._HEADERS`` adds headers as a JSON object.
:class:`FakeObjectStoreServer` is an in-process server of the same
subset over a local directory.

Layout in the bucket:

- ``events/{app}[_{channel}]/{seq}-{uuid}``: immutable JSON-lines
  objects, one an ``insert_batch`` (the LOCALFS records put, putb, del).
  One batch is one PUT, so a batch commits whole or not at all. A replay
  lists the prefix and fetches the keys it has not applied.
- ``meta/{table}.json``: one document a metadata table, replaced on
  write (last PUT wins: one writer a table).
- ``models/{id}``: model blobs, byte for byte.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import os
import threading
import time
import uuid
from typing import Dict, Iterator, List, Optional, Sequence
from urllib.parse import quote, unquote, urlsplit
from xml.etree import ElementTree

from ..event import Event, new_event_id
from .base import (
    AccessKey,
    AccessKeysDAO,
    App,
    AppsDAO,
    Channel,
    ChannelsDAO,
    EngineInstance,
    EngineInstancesDAO,
    EvaluationInstance,
    EvaluationInstancesDAO,
    EventFilter,
    EventStore,
    Model,
    ModelsDAO,
    STATUS_COMPLETED,
    STATUS_EVALCOMPLETED,
)
from .wire import entity_from_doc, entity_to_doc


# ---------------------------------------------------------------------------
# client


class ObjectStoreClient:
    """An S3-subset client over HTTP(S): put, get, delete, list.
    ``endpoint`` includes the bucket: ``http://host:port/bucket``. One
    keep-alive connection a thread; :meth:`close` closes every one."""

    def __init__(self, endpoint: str, headers: Optional[dict] = None,
                 timeout: float = 30.0):
        self.endpoint = endpoint.rstrip("/")
        parts = urlsplit(self.endpoint)
        self.host = parts.hostname or "127.0.0.1"
        self.port = parts.port or (443 if parts.scheme == "https" else 80)
        self.tls = parts.scheme == "https"
        self.bucket_path = parts.path.rstrip("/")
        if not self.bucket_path:
            raise ValueError(
                f"object-store endpoint {endpoint!r} must include the "
                f"bucket: http://host:port/bucket")
        self.headers = dict(headers or {})
        self.timeout = timeout
        self._local = threading.local()
        #: every connection a thread opened, so close() reaches them all
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self.lock = threading.RLock()

    @staticmethod
    def from_config(cfg: dict) -> "ObjectStoreClient":
        endpoint = cfg.get("ENDPOINT") or cfg.get("URL") or cfg.get("PATH")
        if not endpoint:
            raise ValueError("object-store backend needs "
                             "PIO_STORAGE_SOURCES_<N>_ENDPOINT "
                             "(http://host:port/bucket)")
        headers = {}
        raw = cfg.get("HEADERS")
        if raw:
            headers = json.loads(raw)
        return ObjectStoreClient(endpoint, headers=headers)

    def _drop(self) -> None:
        """Close this thread's connection."""
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None
            with self._conns_lock:
                self._conns.discard(conn)

    def close(self) -> None:
        """Close every thread's connection."""
        with self._conns_lock:
            conns, self._conns = self._conns, set()
        for conn in conns:
            conn.close()
        self._local = threading.local()

    # -- raw REST ----------------------------------------------------------
    def _conn(self):
        conn = getattr(self._local, "conn", None)
        if conn is None:
            cls = (http.client.HTTPSConnection if self.tls
                   else http.client.HTTPConnection)
            conn = cls(self.host, self.port, timeout=self.timeout)
            self._local.conn = conn
            with self._conns_lock:
                self._conns.add(conn)
        return conn

    def _request(self, method: str, path: str, body: bytes = b"",
                 retry: bool = True):
        conn = self._conn()
        try:
            conn.request(method, path, body=body or None,
                         headers=self.headers)
            resp = conn.getresponse()
            data = resp.read()
            return resp.status, data, dict(resp.getheaders())
        except Exception:
            self._drop()
            if retry:  # one reconnect: keep-alive sockets go stale
                return self._request(method, path, body, retry=False)
            raise

    def _key_path(self, key: str) -> str:
        return f"{self.bucket_path}/{quote(key, safe='/')}"

    def put(self, key: str, data: bytes) -> str:
        status, body, headers = self._request("PUT", self._key_path(key),
                                              data)
        if status not in (200, 201):
            raise IOError(f"PUT {key}: HTTP {status} "
                          f"{body[:200].decode('utf-8', 'replace')}")
        return headers.get("ETag", "")

    def get(self, key: str) -> Optional[bytes]:
        status, body, _ = self._request("GET", self._key_path(key))
        if status == 404:
            return None
        if status != 200:
            raise IOError(f"GET {key}: HTTP {status}")
        return body

    def delete(self, key: str) -> None:
        status, _, _ = self._request("DELETE", self._key_path(key))
        if status not in (200, 204, 404):
            raise IOError(f"DELETE {key}: HTTP {status}")

    def list(self, prefix: str = "") -> Iterator[str]:
        """All keys under ``prefix`` in lexicographic order (ListObjects
        V1 marker pagination)."""
        marker = ""
        while True:
            q = f"?prefix={quote(prefix, safe='')}"
            if marker:
                q += f"&marker={quote(marker, safe='')}"
            status, body, _ = self._request(
                "GET", f"{self.bucket_path}{q}")
            if status != 200:
                raise IOError(f"LIST {prefix}: HTTP {status}")
            root = ElementTree.fromstring(body)
            ns = ""
            if root.tag.startswith("{"):  # real S3 namespaces the doc
                ns = root.tag[: root.tag.index("}") + 1]
            keys = [el.findtext(f"{ns}Key") or ""
                    for el in root.iter(f"{ns}Contents")]
            yield from keys
            truncated = (root.findtext(f"{ns}IsTruncated") or
                         "false").lower() == "true"
            if not truncated or not keys:
                return
            marker = root.findtext(f"{ns}NextMarker") or keys[-1]

    # -- document helpers (metadata tables) --------------------------------
    def read_doc(self, name: str, default):
        raw = self.get(f"meta/{name}.json")
        if raw is None:
            return default
        return json.loads(raw.decode("utf-8"))

    def write_doc(self, name: str, value) -> None:
        self.put(f"meta/{name}.json",
                 json.dumps(value).encode("utf-8"))

    def next_seq(self, name: str) -> int:
        doc = f"{name}_seq"
        n = int(self.read_doc(doc, 0)) + 1
        self.write_doc(doc, n)
        return n


# ---------------------------------------------------------------------------
# event store


def _events_prefix(app_id: int, channel_id: Optional[int]) -> str:
    suffix = f"_{channel_id}" if channel_id is not None else ""
    return f"events/{app_id}{suffix}/"


class ObjectStoreEventStore(EventStore):
    """Append-only event log as immutable batch objects (see module
    docstring). Live state is replayed from the listing; objects cache
    by key (immutable), so an incremental read fetches only new keys."""

    def __init__(self, client: ObjectStoreClient):
        self.c = client
        #: prefix → (sorted applied keys tuple, live {id: Event})
        self._state_cache: Dict[str, tuple] = {}

    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        return True

    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        prefix = _events_prefix(app_id, channel_id)
        with self.c.lock:
            self._state_cache.pop(prefix, None)
            found = False
            for key in list(self.c.list(prefix)):
                self.c.delete(key)
                found = True
        return found

    def close(self) -> None:
        self.c.close()

    def _seg_key(self, prefix: str) -> str:
        # time-ordered unique keys: lexicographic listing == append
        # order for a single writer; concurrent writers interleave by
        # wall clock (documented out-of-order window, like any log on
        # an object store)
        return f"{prefix}{time.time_ns():020d}-{uuid.uuid4().hex[:8]}"

    def insert(self, event: Event, app_id: int,
               channel_id: Optional[int] = None) -> str:
        return self.insert_batch([event], app_id, channel_id)[0]

    def insert_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: Optional[int] = None) -> List[str]:
        if not events:
            return []
        prefix = _events_prefix(app_id, channel_id)
        stored = [e.copy(event_id=e.event_id or new_event_id())
                  for e in events]
        if len(stored) > 1:
            records = [{"op": "putb",
                        "events": [s.to_json() for s in stored]}]
        else:
            records = [{"op": "put", "event": stored[0].to_json()}]
        payload = "".join(json.dumps(r) + "\n" for r in records) \
            .encode("utf-8")
        with self.c.lock:
            # one PUT a batch: the store's per-object atomicity is the
            # all-or-nothing contract of insert_batch under crashes
            key = self._seg_key(prefix)
            self.c.put(key, payload)
            # extend the cached state in place (our time-ordered key
            # sorts after everything applied) rather than dropping it,
            # which would make every read after a write replay the whole
            # log; a concurrent writer's key is caught by _replay's
            # listing-prefix check
            cached = self._state_cache.get(prefix)
            if cached is not None:
                live = cached[1]
                for s in stored:
                    live[s.event_id] = s
                self._state_cache[prefix] = (cached[0] + (key,), live)
        return [s.event_id for s in stored]

    def _replay(self, app_id: int, channel_id: Optional[int],
                deadline: Optional[float] = None) -> Dict[str, Event]:
        prefix = _events_prefix(app_id, channel_id)
        with self.c.lock:
            keys = tuple(self.c.list(prefix))
            cached = self._state_cache.get(prefix)
            if cached is not None and cached[0] == keys:
                return cached[1]
            live: Dict[str, Event] = {}
            if cached is not None and keys[: len(cached[0])] == cached[0]:
                live = dict(cached[1])  # pure append since last replay
                new_keys = keys[len(cached[0]):]
            else:
                new_keys = keys
            for n, key in enumerate(new_keys):
                if deadline is not None and n % 64 == 0 \
                        and time.monotonic() > deadline:
                    raise TimeoutError(
                        "event replay exceeded its deadline")
                # no blob cache: each object is fetched once, folded
                # into the live dict and dropped, so the log never lives
                # in memory twice
                blob = self.c.get(key)
                if blob is None:  # deleted under us (remove race)
                    continue
                for line in blob.splitlines():
                    if not line.strip():
                        continue
                    rec = json.loads(line)
                    if rec["op"] == "put":
                        e = Event.from_json(rec["event"])
                        live[e.event_id] = e
                    elif rec["op"] == "putb":
                        for doc in rec["events"]:
                            e = Event.from_json(doc)
                            live[e.event_id] = e
                    elif rec["op"] == "del":
                        live.pop(rec["eventId"], None)
            self._state_cache[prefix] = (keys, live)
            return live

    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]:
        return self._replay(app_id, channel_id).get(event_id)

    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool:
        prefix = _events_prefix(app_id, channel_id)
        with self.c.lock:
            if event_id not in self._replay(app_id, channel_id):
                return False
            payload = (json.dumps({"op": "del", "eventId": event_id})
                       + "\n").encode("utf-8")
            key = self._seg_key(prefix)
            self.c.put(key, payload)
            cached = self._state_cache.get(prefix)
            if cached is not None:  # in-place, like insert_batch
                cached[1].pop(event_id, None)
                self._state_cache[prefix] = (cached[0] + (key,),
                                             cached[1])
            return True

    def find(self, app_id: int, channel_id: Optional[int] = None,
             filter: EventFilter = EventFilter()) -> Iterator[Event]:
        with self.c.lock:  # snapshot: inserts mutate the live dict
            events = list(self._replay(app_id, channel_id,
                                       filter.deadline).values())
        events = list(filter.apply(events))
        events.sort(key=lambda e: e.event_time_millis,
                    reverse=filter.reversed)
        if filter.limit is not None and filter.limit >= 0:
            events = events[: filter.limit]
        return iter(events)


# ---------------------------------------------------------------------------
# metadata DAOs (single-document tables, like localfs but on the bucket)


class ObjectStoreApps(AppsDAO):
    DOC = "apps"

    def __init__(self, client: ObjectStoreClient):
        self.c = client

    def _load(self) -> List[App]:
        return [App(**a) for a in self.c.read_doc(self.DOC, [])]

    def _store(self, apps: List[App]) -> None:
        self.c.write_doc(self.DOC, [
            {"id": a.id, "name": a.name, "description": a.description}
            for a in apps])

    def insert(self, app: App) -> Optional[int]:
        with self.c.lock:
            apps = self._load()
            if any(a.name == app.name for a in apps):
                return None
            app_id = app.id if app.id > 0 else self.c.next_seq("app")
            if any(a.id == app_id for a in apps):
                return None
            apps.append(App(id=app_id, name=app.name,
                            description=app.description))
            self._store(apps)
            return app_id

    def get(self, app_id: int) -> Optional[App]:
        return next((a for a in self._load() if a.id == app_id), None)

    def get_by_name(self, name: str) -> Optional[App]:
        return next((a for a in self._load() if a.name == name), None)

    def get_all(self) -> List[App]:
        return self._load()

    def update(self, app: App) -> None:
        with self.c.lock:
            apps = [app if a.id == app.id else a for a in self._load()]
            self._store(apps)

    def delete(self, app_id: int) -> None:
        with self.c.lock:
            self._store([a for a in self._load() if a.id != app_id])


class ObjectStoreAccessKeys(AccessKeysDAO):
    DOC = "access_keys"

    def __init__(self, client: ObjectStoreClient):
        self.c = client

    def _load(self) -> List[AccessKey]:
        return [AccessKey(**a) for a in self.c.read_doc(self.DOC, [])]

    def _store(self, keys: List[AccessKey]) -> None:
        self.c.write_doc(self.DOC, [
            {"key": k.key, "app_id": k.app_id, "events": list(k.events)}
            for k in keys])

    def insert(self, access_key: AccessKey) -> Optional[str]:
        with self.c.lock:
            keys = self._load()
            key = access_key.key or self.generate_key()
            if any(k.key == key for k in keys):
                return None
            keys.append(AccessKey(key=key, app_id=access_key.app_id,
                                  events=access_key.events))
            self._store(keys)
            return key

    def get(self, key: str) -> Optional[AccessKey]:
        return next((k for k in self._load() if k.key == key), None)

    def get_all(self) -> List[AccessKey]:
        return self._load()

    def get_by_app_id(self, app_id: int) -> List[AccessKey]:
        return [k for k in self._load() if k.app_id == app_id]

    def update(self, access_key: AccessKey) -> None:
        with self.c.lock:
            self._store([access_key if k.key == access_key.key else k
                         for k in self._load()])

    def delete(self, key: str) -> None:
        with self.c.lock:
            self._store([k for k in self._load() if k.key != key])


class ObjectStoreChannels(ChannelsDAO):
    DOC = "channels"

    def __init__(self, client: ObjectStoreClient):
        self.c = client

    def _load(self) -> List[Channel]:
        return [Channel(**a) for a in self.c.read_doc(self.DOC, [])]

    def _store(self, chans: List[Channel]) -> None:
        self.c.write_doc(self.DOC, [
            {"id": c.id, "name": c.name, "app_id": c.app_id}
            for c in chans])

    def insert(self, channel: Channel) -> Optional[int]:
        if not Channel.is_valid_name(channel.name):
            return None
        with self.c.lock:
            chans = self._load()
            cid = channel.id if channel.id > 0 \
                else self.c.next_seq("channel")
            if any(c.id == cid for c in chans):
                return None
            chans.append(Channel(id=cid, name=channel.name,
                                 app_id=channel.app_id))
            self._store(chans)
            return cid

    def get(self, channel_id: int) -> Optional[Channel]:
        return next((c for c in self._load() if c.id == channel_id),
                    None)

    def get_by_app_id(self, app_id: int) -> List[Channel]:
        return [c for c in self._load() if c.app_id == app_id]

    def delete(self, channel_id: int) -> None:
        with self.c.lock:
            self._store([c for c in self._load() if c.id != channel_id])


class ObjectStoreEngineInstances(EngineInstancesDAO):
    DOC = "engine_instances"

    def __init__(self, client: ObjectStoreClient):
        self.c = client

    def _load(self) -> List[EngineInstance]:
        return [entity_from_doc(self.DOC, d)
                for d in self.c.read_doc(self.DOC, [])]

    def _store(self, rows) -> None:
        self.c.write_doc(self.DOC, [entity_to_doc(r) for r in rows])

    def insert(self, instance) -> str:
        with self.c.lock:
            rows = self._load()
            iid = instance.id or uuid.uuid4().hex
            rows.append(instance.copy(id=iid))
            self._store(rows)
            return iid

    def get(self, instance_id: str):
        return next((r for r in self._load() if r.id == instance_id),
                    None)

    def get_all(self):
        return self._load()

    def update(self, instance) -> None:
        with self.c.lock:
            self._store([instance if r.id == instance.id else r
                         for r in self._load()])

    def delete(self, instance_id: str) -> None:
        with self.c.lock:
            self._store([r for r in self._load() if r.id != instance_id])

    def get_completed(self, engine_id: str, engine_version: str,
                      engine_variant: str):
        rows = [r for r in self._load()
                if r.status == STATUS_COMPLETED
                and r.engine_id == engine_id
                and r.engine_version == engine_version
                and r.engine_variant == engine_variant]
        rows.sort(key=lambda r: r.start_time, reverse=True)
        return rows

    def get_latest_completed(self, engine_id: str, engine_version: str,
                             engine_variant: str):
        rows = self.get_completed(engine_id, engine_version,
                                  engine_variant)
        return rows[0] if rows else None


class ObjectStoreEvaluationInstances(EvaluationInstancesDAO):
    DOC = "evaluation_instances"

    def __init__(self, client: ObjectStoreClient):
        self.c = client

    def _load(self) -> List[EvaluationInstance]:
        return [entity_from_doc(self.DOC, d)
                for d in self.c.read_doc(self.DOC, [])]

    def _store(self, rows) -> None:
        self.c.write_doc(self.DOC, [entity_to_doc(r) for r in rows])

    def insert(self, instance) -> str:
        with self.c.lock:
            rows = self._load()
            iid = instance.id or uuid.uuid4().hex
            rows.append(instance.copy(id=iid))
            self._store(rows)
            return iid

    def get(self, instance_id: str):
        return next((r for r in self._load() if r.id == instance_id),
                    None)

    def get_all(self):
        return self._load()

    def get_completed(self):
        rows = [r for r in self._load()
                if r.status == STATUS_EVALCOMPLETED]
        rows.sort(key=lambda r: r.start_time, reverse=True)
        return rows

    def update(self, instance) -> None:
        with self.c.lock:
            self._store([instance if r.id == instance.id else r
                         for r in self._load()])

    def delete(self, instance_id: str) -> None:
        with self.c.lock:
            self._store([r for r in self._load() if r.id != instance_id])


class ObjectStoreModels(ModelsDAO):
    """Model blobs at ``models/{id}``, byte for byte."""

    def __init__(self, client: ObjectStoreClient):
        self.c = client

    def insert(self, model: Model) -> None:
        self.c.put(f"models/{quote(model.id, safe='')}", model.models)

    def get(self, model_id: str) -> Optional[Model]:
        blob = self.c.get(f"models/{quote(model_id, safe='')}")
        if blob is None:
            return None
        return Model(id=model_id, models=blob)

    def delete(self, model_id: str) -> None:
        self.c.delete(f"models/{quote(model_id, safe='')}")


# ---------------------------------------------------------------------------
# in-process server of the same REST subset (tests, local runs)


def build_fake_server_app(root: str):
    """S3-subset REST app over a local directory: PUT, GET and DELETE of
    an object and ListObjects V1 with prefix, marker and max-keys. Keys
    map to url-quoted file names (a flat namespace: no path traversal);
    a PUT is atomic (temp and rename), which the crash contract needs."""
    from ...server.http import HTTPApp, Request, Response

    os.makedirs(root, exist_ok=True)
    app = HTTPApp("fake-object-store")

    def _fname(key: str) -> str:
        return os.path.join(root, quote(key, safe=""))

    @app.route("PUT", r"/(?P<bucket>[^/?]+)/(?P<key>.+)")
    def put_object(req: Request) -> Response:
        path = _fname(unquote(req.path_params["key"]))
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(req.body)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        etag = hashlib.md5(req.body).hexdigest()
        return Response(status=200, body=b"",
                        headers={"ETag": f'"{etag}"'})

    @app.route("GET", r"/(?P<bucket>[^/?]+)/(?P<key>.+)")
    def get_object(req: Request) -> Response:
        path = _fname(unquote(req.path_params["key"]))
        if not os.path.exists(path):
            return Response(status=404, body=b"NoSuchKey",
                            content_type="application/xml")
        with open(path, "rb") as f:
            return Response(status=200, body=f.read(),
                            content_type="application/octet-stream")

    @app.route("DELETE", r"/(?P<bucket>[^/?]+)/(?P<key>.+)")
    def delete_object(req: Request) -> Response:
        path = _fname(unquote(req.path_params["key"]))
        try:
            os.remove(path)
        except FileNotFoundError:
            return Response(status=404, body=b"")
        return Response(status=204, body=b"")

    @app.route("GET", r"/(?P<bucket>[^/?]+)/?")
    def list_objects(req: Request) -> Response:
        prefix = req.query.get("prefix", "")
        marker = req.query.get("marker", "")
        max_keys = int(req.query.get("max-keys", "1000"))
        keys = sorted(unquote(f) for f in os.listdir(root)
                      if ".tmp." not in f)
        keys = [k for k in keys if k.startswith(prefix) and k > marker]
        page, truncated = keys[:max_keys], len(keys) > max_keys
        items = "".join(
            f"<Contents><Key>{_xml(k)}</Key>"
            f"<Size>{os.path.getsize(_fname(k))}</Size></Contents>"
            for k in page)
        nxt = (f"<NextMarker>{_xml(page[-1])}</NextMarker>"
               if truncated and page else "")
        body = (f'<?xml version="1.0" encoding="UTF-8"?>'
                f"<ListBucketResult>"
                f"<IsTruncated>{str(truncated).lower()}</IsTruncated>"
                f"{nxt}{items}</ListBucketResult>")
        return Response(status=200, body=body.encode("utf-8"),
                        content_type="application/xml")

    return app


def _xml(s: str) -> str:
    return (s.replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;"))


class FakeObjectStoreServer:
    """A directory-backed S3-subset server for tests and local runs;
    its endpoint is ``http://host:port/<any bucket name>``.
    :meth:`shutdown` joins its serving thread."""

    def __init__(self, root: str, host: str = "127.0.0.1",
                 port: int = 0):
        from ...server.http import AppServer

        self.app = build_fake_server_app(root)
        self.server = AppServer(self.app, host, port)

    @property
    def port(self) -> int:
        return self.server.port

    def start_background(self):
        self.server.start_background()
        return self

    def shutdown(self) -> None:
        self.server.close()
