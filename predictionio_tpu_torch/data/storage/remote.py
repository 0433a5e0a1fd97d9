"""REMOTE storage backend: the event store and the metadata DAOs over
HTTP (the port's own copy of ``predictionio_tpu/data/storage/remote.py``;
it speaks the JAX package's storage-server protocol, so either package's
client talks to either package's server, :mod:`..server.storageserver`).
A host with no shared filesystem reaches its event store this way::

    PIO_STORAGE_SOURCES_NET_TYPE=remote
    PIO_STORAGE_SOURCES_NET_URL=http://storage-host:7077
    PIO_STORAGE_SOURCES_NET_SECRET=...            # optional
    PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE=NET

The training read (:meth:`RemoteEventStore.find_columnar`) pulls the
server's columnar sidecar as one ``.npz`` and caches it by ``ETag``: a
read of an unchanged log costs one 304 round trip, and the filters then
run locally over the cached columns. Every request passes the
``storage.remote`` fault point and retries transport errors (and a 503)
with bounded backoff when it is idempotent. The client holds no
connection between requests, so :meth:`RemoteClient.close` has nothing
to join. A ``find_columnar(shard=(i, n))`` read is pushed down as an
HTTP row-range request (``shard_i``/``shard_n``): the server ships only
that shard's bytes, under an ETag of the shard's own.
"""

from __future__ import annotations

import base64
import json
import os
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from datetime import datetime
from typing import Iterator, List, Optional, Sequence

from ...faults import declare, fire
from ...utils.retrying import RetryPolicy, retry_call
from ..datamap import PropertyMap
from ..event import Event, new_event_id
from .base import (
    AccessKeysDAO,
    AppsDAO,
    ChannelsDAO,
    EngineInstancesDAO,
    EvaluationInstancesDAO,
    EventFilter,
    EventStore,
    JsonlImportError,
    Model,
    ModelsDAO,
    StorageError,
    _open_jsonl,
    iter_jsonl_blocks,
)
from .wire import (
    batch_from_npz,
    batch_to_npz,
    entity_from_doc,
    entity_to_doc,
    filter_to_doc,
)


F_REMOTE = declare("storage.remote",
                   "one HTTP round trip of the remote-storage client "
                   "(op=/path= label the request)")


class _Transient(Exception):
    """Internal retry marker wrapping a retryable StorageError."""

    def __init__(self, error: StorageError):
        super().__init__(str(error))
        self.error = error


class RemoteClient:
    """One storage-server endpoint and its connection policy, shared by
    the DAOs of a source."""

    def __init__(self, url: str, secret: Optional[str] = None,
                 timeout: float = 60.0, retries: int = 2):
        self.url = url.rstrip("/")
        self.secret = secret
        self.timeout = timeout
        self.retries = retries
        #: (app_id, channel, props, float_props, shard) -> (etag, batch)
        self.columnar_cache: dict = {}
        #: the last columnar read: {"status": 200 or 304, "bytes": n}
        self.last_columnar: dict = {}
        self.lock = threading.Lock()

    @staticmethod
    def from_config(cfg: dict) -> "RemoteClient":
        url = cfg.get("URL") or cfg.get("url")
        if not url:
            raise ValueError("REMOTE source needs a URL property "
                             "(PIO_STORAGE_SOURCES_<NAME>_URL)")
        return RemoteClient(
            url, secret=cfg.get("SECRET"),
            timeout=float(cfg.get("TIMEOUT", 60.0)))

    def request(self, method: str, path: str, body: Optional[bytes] = None,
                headers: Optional[dict] = None,
                timeout: Optional[float] = None,
                idempotent: bool = True):
        """``(status, headers, body)``. Connection errors retry with
        bounded exponential backoff only for ``idempotent`` requests: a
        lost response means the server may have committed, so replaying
        a call that assigns ids server-side (a metadata insert) would
        duplicate it. Event inserts stay retryable because the client
        assigns event ids first (a replay is an id-keyed upsert). A 503
        (the server's backing store is down) retries the same way."""
        fire(F_REMOTE, op=method, path=path)
        hdrs = {"Content-Type": "application/json"}
        if self.secret:
            hdrs["X-PIO-Storage-Secret"] = self.secret
        hdrs.update(headers or {})

        def attempt():
            req = urllib.request.Request(
                self.url + path, data=body, method=method, headers=hdrs)
            try:
                with urllib.request.urlopen(
                        req, timeout=timeout or self.timeout) as resp:
                    return resp.status, dict(resp.headers), resp.read()
            except urllib.error.HTTPError as e:
                if e.code == 304:
                    return 304, dict(e.headers), b""
                detail = ""
                try:
                    detail = json.loads(e.read().decode()).get("message", "")
                except Exception:  # noqa: BLE001
                    pass
                err = StorageError(
                    f"storage server {e.code} on {path}: {detail}")
                err.status = e.code  # callers branch on 404 (version skew)
                if e.code == 503 and idempotent:
                    raise _Transient(err) from e
                raise err from e
            except (urllib.error.URLError, ConnectionError, OSError) as e:
                raise _Transient(StorageError(
                    f"storage server unreachable at {self.url}: {e}")) \
                    from e

        policy = RetryPolicy(
            max_attempts=(self.retries + 1) if idempotent else 1,
            base_ms=200.0, cap_ms=2000.0)
        try:
            return retry_call(attempt, policy=policy,
                              retry_on=(_Transient,))
        except _Transient as t:
            raise t.error from t

    def rpc(self, path: str, doc: Optional[dict] = None,
            idempotent: bool = True) -> dict:
        _, _, body = self.request(
            "POST", path, json.dumps(doc or {}).encode(),
            idempotent=idempotent)
        return json.loads(body.decode()) if body else {}

    def close(self) -> None:
        pass


class RemoteEventStore(EventStore):
    def __init__(self, client: RemoteClient):
        self.c = client

    def _base(self, app_id: int,
              channel_id: Optional[int]) -> "tuple[str, str]":
        # `is not None`: channel 0 must reach the server, not alias the
        # default channel
        q = (f"?channel={channel_id}" if channel_id is not None else "")
        return f"/v1/events/{app_id}", q

    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        base, q = self._base(app_id, channel_id)
        return bool(self.c.rpc(f"{base}/init{q}").get("ok"))

    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        base, q = self._base(app_id, channel_id)
        ok = bool(self.c.rpc(f"{base}/remove{q}").get("ok"))
        with self.c.lock:
            self.c.columnar_cache = {
                k: v for k, v in self.c.columnar_cache.items()
                if k[0] != app_id or k[1] != channel_id}
        return ok

    def close(self) -> None:
        pass

    def insert(self, event: Event, app_id: int,
               channel_id: Optional[int] = None) -> str:
        return self.insert_batch([event], app_id, channel_id)[0]

    def insert_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: Optional[int] = None) -> List[str]:
        base, q = self._base(app_id, channel_id)
        # assign event ids CLIENT-side: a retried batch whose first
        # attempt committed but lost its response then replays as an
        # id-keyed upsert instead of duplicating every event
        events = [e if e.event_id else e.copy(event_id=new_event_id())
                  for e in events]
        doc = [e.to_json() for e in events]
        return self.c.rpc(f"{base}/batch{q}", doc).get("ids", [])

    def insert_columnar(self, batch, app_id: int,
                        channel_id: Optional[int] = None) -> int:
        """Block ingest: the batch as one npz POST, which the server's
        backend writes all or nothing. Not retried: block rows get
        server-assigned ids, so a replay after a lost response would
        duplicate the block; the caller decides on redelivery."""
        base, q = self._base(app_id, channel_id)
        _, _, body = self.c.request(
            "POST", f"{base}/columnar{q}", batch_to_npz(batch),
            headers={"Content-Type": "application/octet-stream"},
            idempotent=False)
        return int(json.loads(body.decode()).get("accepted", 0))

    def import_jsonl(self, source, app_id: int,
                     channel_id: Optional[int] = None,
                     chunk: int = 100_000) -> int:
        """Bulk import by forwarding raw JSON-lines blocks to the server
        (one POST a ``PIO_IMPORT_BLOCK``, 8 MB, of whole lines), where the
        backing store's own lane (SEGMENTFS: the native codec) parses and
        encodes them. The server commits each POST all or nothing, so the
        durable prefix is exactly the acknowledged blocks.

        Every object line gets an ``eventId`` spliced in first position
        (JSON's duplicate keys parse last-wins, so a line's own id still
        wins): a retried block whose first attempt committed replays as
        id-keyed upserts. If the server commits, the response is lost and
        the server stays down past the retries, the durable prefix counts
        one block too many; the error names the transport failure."""
        base, q = self._base(app_id, channel_id)
        block_size = int(os.environ.get("PIO_IMPORT_BLOCK",
                                        str(8 << 20)))
        total = 0
        lineno = 0  # lines fully consumed == committed (block commits)
        f = _open_jsonl(source)  # missing file: clean OSError
        try:
            with f:
                for buf, nlines in iter_jsonl_blocks(f, block_size):
                    spliced = bytearray()
                    # split on \n only, as the local lanes count lines;
                    # blank lines stay, so the server's line numbers
                    # stay relative to the block
                    pieces = buf.split(b"\n")
                    if pieces and pieces[-1] == b"":
                        pieces.pop()  # trailing \n, not a blank line
                    for raw in pieces:
                        s = raw.strip()
                        if s.startswith(b"{"):
                            if b'"eventId"' in s:
                                # an explicit "eventId": null would win
                                # over the spliced id and make a replay
                                # mint fresh ids: drop the null key (only
                                # lines holding the substring pay the
                                # parse)
                                try:
                                    obj = json.loads(s)
                                    if isinstance(obj, dict) and \
                                            obj.get("eventId",
                                                    "") is None:
                                        del obj["eventId"]
                                        s = json.dumps(
                                            obj, ensure_ascii=False
                                        ).encode("utf-8")
                                except ValueError:
                                    pass  # malformed: server reports
                            rest = s[1:].lstrip()
                            eid = new_event_id().encode()
                            sep = b'"' if rest.startswith(b"}") \
                                else b'", '
                            spliced += (b'{"eventId": "' + eid + sep +
                                        s[1:])
                        else:
                            spliced += s
                        spliced += b"\n"
                    try:
                        _, _, body = self.c.request(
                            "POST", f"{base}/import_jsonl{q}",
                            bytes(spliced),
                            headers={"Content-Type":
                                     "application/x-ndjson"})
                    except StorageError as se:
                        if getattr(se, "status", None) == 404 \
                                and lineno == 0:
                            # a server without the bulk route: nothing
                            # is committed yet, so the per-event lane
                            # runs the whole file
                            return super().import_jsonl(
                                source, app_id, channel_id, chunk)
                        raise
                    doc = json.loads(body.decode())
                    err = doc.get("error")
                    if err is not None:
                        raise JsonlImportError(
                            lineno + err["lineno"],
                            lineno + err["committed_lines"],
                            total + err["committed_events"],
                            StorageError(err["message"]))
                    total += doc["imported"]
                    lineno += nlines
        except JsonlImportError:
            raise
        except Exception as e:  # noqa: BLE001 — durable-prefix report
            # (request() replayed its retries with the same spliced ids,
            # so the prefix is `lineno` lines)
            raise JsonlImportError(lineno, lineno, total, e) from e
        return total

    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]:
        base, q = self._base(app_id, channel_id)
        sep = "&" if q else "?"
        _, _, body = self.c.request(
            "GET", f"{base}/get{q}{sep}id={urllib.parse.quote(event_id)}")
        d = json.loads(body.decode()).get("event")
        return Event.from_json(d) if d else None

    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool:
        base, q = self._base(app_id, channel_id)
        return bool(self.c.rpc(f"{base}/delete{q}",
                               {"id": event_id}).get("ok"))

    def find(self, app_id: int, channel_id: Optional[int] = None,
             filter: EventFilter = EventFilter()) -> Iterator[Event]:
        base, q = self._base(app_id, channel_id)
        timeout = None
        if filter.deadline is not None:
            timeout = max(filter.deadline - time.monotonic(), 0.001)
        _, _, body = self.c.request(
            "POST", f"{base}/find{q}",
            json.dumps(filter_to_doc(filter)).encode(), timeout=timeout)
        return iter([Event.from_json(d)
                     for d in json.loads(body.decode())["events"]])

    def find_columnar(self, app_id: int, channel_id: Optional[int] = None,
                      filter: EventFilter = EventFilter(),
                      float_props: Sequence[str] = ("rating",),
                      ordered: bool = True, with_props: bool = True,
                      shard=None):
        """The training read: the server's sidecar as one ``.npz``,
        cached by its ETag (a read of an unchanged log is one 304 round
        trip), then the filter runs here. ``shard=(i, n)`` asks the
        server for that row range alone (``shard_i``/``shard_n``) and
        stamps the batch with the ``X-Shard-Offset``/``X-Shard-Total``
        it answers; a server that ignores the request (no
        ``X-Shard-Total``) is an error, never the whole log read as one
        shard. ``last_columnar`` records the last read's status and
        payload bytes."""
        base, q = self._base(app_id, channel_id)
        sep = "&" if q else "?"
        # the wire is comma-separated, so ',' in a name cannot be sent;
        # quote() guards '&', '=' and spaces
        for p in float_props:
            if "," in p:
                raise ValueError(
                    f"float prop name may not contain ',': {p!r}")
        key = (app_id, channel_id, with_props, tuple(float_props),
               None if shard is None else tuple(shard))
        with self.c.lock:
            etag, cached = self.c.columnar_cache.get(key, (None, None))
        headers = {"If-None-Match": etag} if etag else {}
        fp_q = ",".join(urllib.parse.quote(p, safe="")
                        for p in float_props)
        path = (f"{base}/columnar{q}{sep}props="
                f"{'1' if with_props else '0'}"
                f"&float_props={fp_q}")
        if shard is not None:
            if not 0 <= int(shard[0]) < int(shard[1]):
                raise ValueError(f"shard {shard[0]} of {shard[1]}")
            path += f"&shard_i={int(shard[0])}&shard_n={int(shard[1])}"
        status, resp_headers, body = self.c.request(
            "GET", path, headers=headers)
        lower = {k.lower(): v for k, v in resp_headers.items()}
        if status == 304 and cached is not None:
            batch = cached
        else:
            batch = batch_from_npz(body)
            if shard is not None:
                if "x-shard-total" not in lower:
                    raise StorageError(
                        "the storage server ignored the shard request (no "
                        "X-Shard-Total header): it serves no sharded reads;"
                        " upgrade it or read unsharded")
                batch.shard_offset = int(lower["x-shard-offset"])
                batch.shard_total = int(lower["x-shard-total"])
            with self.c.lock:
                self.c.columnar_cache[key] = (lower.get("etag"), batch)
        self.c.last_columnar = {"status": status, "bytes": len(body)}
        out = batch.select(filter, ordered=ordered, with_props=with_props)
        if shard is not None and out is not batch:
            out.shard_offset = batch.shard_offset
            out.shard_total = batch.shard_total
        return out

    def aggregate_properties(self, app_id: int,
                             channel_id: Optional[int] = None, *,
                             entity_type: str, start_time=None,
                             until_time=None, required=None):
        base, q = self._base(app_id, channel_id)
        doc = {
            "entity_type": entity_type,
            "start_time": start_time.isoformat() if start_time else None,
            "until_time": until_time.isoformat() if until_time else None,
            "required": list(required) if required else None,
        }
        props = self.c.rpc(f"{base}/aggregate{q}", doc)["properties"]
        return {k: PropertyMap(
            v["fields"],
            first_updated=datetime.fromisoformat(v["first_updated"]),
            last_updated=datetime.fromisoformat(v["last_updated"]))
            for k, v in props.items()}


class _RemoteDAO:
    DAO = ""

    def __init__(self, client: RemoteClient):
        self.c = client

    def _rpc(self, method: str, *args, entity=None):
        doc: dict = {"args": list(args)}
        if entity is not None:
            doc["entity"] = entity_to_doc(entity)
        # metadata inserts assign ids server-side, so a replay after a
        # lost response would duplicate them; the rest is idempotent
        return self.c.rpc(f"/v1/meta/{self.DAO}/{method}", doc,
                          idempotent=(method != "insert"))

    def _one(self, method: str, *args, entity=None):
        out = self._rpc(method, *args, entity=entity)
        if "entity" in out:
            return entity_from_doc(self.DAO, out["entity"])
        return out.get("result")

    def _many(self, method: str, *args):
        return [entity_from_doc(self.DAO, d)
                for d in self._rpc(method, *args).get("entities", [])]


class RemoteApps(_RemoteDAO, AppsDAO):
    DAO = "apps"

    def insert(self, app):
        return self._one("insert", entity=app)

    def get(self, app_id):
        return self._one("get", app_id)

    def get_by_name(self, name):
        return self._one("get_by_name", name)

    def get_all(self):
        return self._many("get_all")

    def update(self, app):
        self._one("update", entity=app)

    def delete(self, app_id):
        self._one("delete", app_id)


class RemoteAccessKeys(_RemoteDAO, AccessKeysDAO):
    DAO = "access_keys"

    def insert(self, access_key):
        return self._one("insert", entity=access_key)

    def get(self, key):
        return self._one("get", key)

    def get_all(self):
        return self._many("get_all")

    def get_by_app_id(self, app_id):
        return self._many("get_by_app_id", app_id)

    def update(self, access_key):
        self._one("update", entity=access_key)

    def delete(self, key):
        self._one("delete", key)


class RemoteChannels(_RemoteDAO, ChannelsDAO):
    DAO = "channels"

    def insert(self, channel):
        return self._one("insert", entity=channel)

    def get(self, channel_id):
        return self._one("get", channel_id)

    def get_by_app_id(self, app_id):
        return self._many("get_by_app_id", app_id)

    def delete(self, channel_id):
        self._one("delete", channel_id)


class RemoteEngineInstances(_RemoteDAO, EngineInstancesDAO):
    DAO = "engine_instances"

    def insert(self, instance):
        return self._one("insert", entity=instance)

    def get(self, instance_id):
        return self._one("get", instance_id)

    def get_all(self):
        return self._many("get_all")

    def update(self, instance):
        self._one("update", entity=instance)

    def delete(self, instance_id):
        self._one("delete", instance_id)

    def get_completed(self, engine_id, engine_version, engine_variant):
        return self._many("get_completed", engine_id, engine_version,
                          engine_variant)


class RemoteEvaluationInstances(_RemoteDAO, EvaluationInstancesDAO):
    DAO = "evaluation_instances"

    def insert(self, instance):
        return self._one("insert", entity=instance)

    def get(self, instance_id):
        return self._one("get", instance_id)

    def get_all(self):
        return self._many("get_all")

    def get_completed(self):
        return self._many("get_completed")

    def update(self, instance):
        self._one("update", entity=instance)

    def delete(self, instance_id):
        self._one("delete", instance_id)


class RemoteModels(_RemoteDAO, ModelsDAO):
    DAO = "models"

    def insert(self, model: Model) -> None:
        self.c.rpc("/v1/meta/models/insert", {"model": {
            "id": model.id,
            "models": base64.b64encode(model.models).decode()}})

    def get(self, model_id: str) -> Optional[Model]:
        out = self.c.rpc("/v1/meta/models/get", {"args": [model_id]})
        m = out.get("model")
        return None if m is None else Model(
            id=m["id"], models=base64.b64decode(m["models"]))

    def delete(self, model_id: str) -> None:
        self.c.rpc("/v1/meta/models/delete", {"args": [model_id]})
