"""LOCALFS storage backend: JSON-lines event logs and JSON metadata files
(the port's own copy of ``predictionio_tpu/data/storage/localfs.py``,
whose on-disk format it keeps, so either package reads the other's
directory).

The event log is an append-only JSON-lines file a (app, channel): ``put``
records, one ``putb`` record a batch (one line, one write: a killed
writer leaves the batch whole or a torn tail that replay truncates) and
``del`` tombstones. Metadata repositories are small JSON documents
replaced atomically, model blobs plain files. Readers replay the log;
events are immutable, so a replay is exact. Suited to one host; SEGMENTFS
(:mod:`.segmentfs`) builds on it for shared mounts.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import uuid
from datetime import datetime
from typing import Dict, Iterator, List, Optional, Sequence

from ..event import Event
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


try:
    import fcntl
except ImportError:  # non-POSIX: the per-process lock only
    fcntl = None  # type: ignore[assignment]


@contextlib.contextmanager
def _flock(path: str):
    """OS-level exclusive lock on ``path``'s sidecar lockfile, covering
    the writers of other processes (a separately running event server)
    that the per-process lock cannot see."""
    if fcntl is None:
        yield
        return
    with open(f"{path}.lock", "a") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lf, fcntl.LOCK_UN)


def atomic_write(path: str, data, fsync: bool = True) -> None:
    """Write-temp + rename publish: readers (on any host) see either the
    old content or the new, never a torn file. ``data`` is str or bytes."""
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    mode = "wb" if isinstance(data, (bytes, bytearray)) else "w"
    kwargs = {} if "b" in mode else {"encoding": "utf-8"}
    with open(tmp, mode, **kwargs) as f:
        f.write(data)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, path)


class LocalFSClient:
    """Owns the root directory + a process-wide mutation lock."""

    def __init__(self, path: str):
        self.root = path
        os.makedirs(path, exist_ok=True)
        os.makedirs(os.path.join(path, "models"), exist_ok=True)
        self.lock = threading.RLock()
        #: per-log replay cache: path → (file size at replay, live events,
        #: dead-record count). Size mismatch (another process appended)
        #: invalidates the entry.
        self.event_cache: Dict[str, tuple] = {}

    @staticmethod
    def from_config(cfg: dict) -> "LocalFSClient":
        path = cfg.get("PATH") or os.path.join(
            os.environ.get("PIO_HOME", "."), "localfs")
        return LocalFSClient(path)

    def close(self) -> None:
        pass

    # -- small-document helpers (metadata repositories) --------------------
    def doc_path(self, name: str) -> str:
        return os.path.join(self.root, f"{name}.json")

    def read_doc(self, name: str, default):
        path = self.doc_path(name)
        if not os.path.exists(path):
            return default
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)

    def write_doc(self, name: str, value) -> None:
        atomic_write(self.doc_path(name), json.dumps(value))

    def next_seq(self, name: str) -> int:
        """Monotonic id sequence a kind of entity: deleted rows never free
        their ids, so a new app never inherits a dead app's event log."""
        doc = f"{name}_seq"
        n = int(self.read_doc(doc, 0)) + 1
        self.write_doc(doc, n)
        return n


def _log_name(app_id: int, channel_id: Optional[int]) -> str:
    suffix = f"_{channel_id}" if channel_id is not None else ""
    return f"events_{app_id}{suffix}.jsonl"


class LocalFSEventStore(EventStore):
    def __init__(self, client: LocalFSClient):
        self.c = client

    def _path(self, app_id: int, channel_id: Optional[int]) -> str:
        return os.path.join(self.c.root, _log_name(app_id, channel_id))

    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        with self.c.lock:
            path = self._path(app_id, channel_id)
            if not os.path.exists(path):
                open(path, "a", encoding="utf-8").close()
        return True

    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        with self.c.lock:
            path = self._path(app_id, channel_id)
            self.c.event_cache.pop(path, None)
            if os.path.exists(path):
                # the .lock sidecar is deliberately left in place: unlinking
                # it would let a process blocked on the old inode and a new
                # process that re-creates the file both hold an "exclusive"
                # lock at once
                with _flock(path):
                    os.remove(path)
                return True
        return False

    def close(self) -> None:
        pass

    def _append(self, path: str, records: List[dict],
                expected_size: Optional[int] = None) -> Optional[int]:
        """Append records under the cross-process lock. When
        ``expected_size`` is given (the size our replay cache is based on)
        and another process appended in between, returns None — the caller
        must invalidate its cache instead of publishing a live-set that
        silently misses the other process's events.

        The whole payload goes through ONE ``write`` call: a crashed
        writer leaves at most one torn trailing line (which replay
        detects and truncates), never a valid prefix of a multi-record
        append."""
        with _flock(path):
            clean = True
            if expected_size is not None:
                current = os.path.getsize(path) if os.path.exists(path) \
                    else -1
                if current < 0:
                    current = 0  # about to be created by the append
                clean = current == max(expected_size, 0)
            with open(path, "a", encoding="utf-8") as f:
                f.write("".join(json.dumps(r) + "\n" for r in records))
                f.flush()
                return f.tell() if clean else None

    def insert(self, event: Event, app_id: int,
               channel_id: Optional[int] = None) -> str:
        return self.insert_batch([event], app_id, channel_id)[0]

    def insert_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: Optional[int] = None) -> List[str]:
        with self.c.lock:
            path = self._path(app_id, channel_id)
            live, dead = self._state(path)
            cached = self.c.event_cache.get(path)
            prior_size = cached[0] if cached is not None else -1
            ids, stored_events = [], []
            for e in events:
                eid = e.event_id or uuid.uuid4().hex
                stored = e.copy(event_id=eid)
                stored_events.append(stored)
                ids.append(eid)
            # one "putb" record a batch, one line, one write call: a
            # process killed mid-insert leaves the batch whole or (as a
            # torn tail, truncated on replay) absent, never a committed
            # prefix of fresh ids
            records = [{"op": "putb",
                        "events": [s.to_json() for s in stored_events]}] \
                if len(stored_events) > 1 else \
                [{"op": "put", "event": stored_events[0].to_json()}] \
                if stored_events else []
            # disk first: a failed append must not leave ghost events in
            # the cache
            size = self._append(path, records, expected_size=prior_size)
            if size is None:
                # another process appended between our replay and this
                # append: drop the cache so the next read replays the file
                # instead of serving a live-set missing their events
                self.c.event_cache.pop(path, None)
            else:
                for stored in stored_events:
                    live[stored.event_id] = stored
                self.c.event_cache[path] = (size, live, dead)
            return ids

    def _state(self, path: str, deadline: Optional[float] = None):
        """(live events by id, dead-record count), replayed at most once
        per on-disk file state. Compacts the log when tombstoned/overwritten
        records outnumber live ones. ``deadline`` (monotonic) bounds a
        serving-time replay; insert/delete paths never pass one."""
        cached = self.c.event_cache.get(path)
        size = os.path.getsize(path) if os.path.exists(path) else -1
        if cached is not None and cached[0] == size:
            return cached[1], cached[2]
        out: Dict[str, Event] = {}
        dead = 0

        def apply(rec: dict) -> int:
            """Replay one record; returns dead-record delta."""
            d = 0
            if rec["op"] == "put":
                e = Event.from_json(rec["event"])
                if e.event_id in out:
                    d += 1
                out[e.event_id] = e
            elif rec["op"] == "putb":  # atomic batch (one line)
                for doc in rec["events"]:
                    e = Event.from_json(doc)
                    if e.event_id in out:
                        d += 1
                    out[e.event_id] = e
            elif rec["op"] == "del":
                if out.pop(rec["eventId"], None) is not None:
                    d += 2  # the put and the tombstone
                else:
                    d += 1
            return d

        if size >= 0:
            # flock against cross-process writers: without it a reader can
            # see a torn trailing record mid-flush and crash on json.loads
            with _flock(path), open(path, "rb") as f:
                size = os.path.getsize(path)  # re-stat now that we hold it
                offset = 0
                truncate_to = None
                needs_newline = False
                ln = 0
                while True:
                    line = f.readline()  # streamed, never the whole file
                    if not line:
                        break
                    ln += 1
                    if deadline is not None and ln % 4096 == 0 \
                            and time.monotonic() > deadline:
                        raise TimeoutError(
                            "event-log replay exceeded its deadline")
                    has_nl = line.endswith(b"\n")
                    s = line.strip()
                    if s:
                        try:
                            rec = json.loads(s)
                        except (json.JSONDecodeError,
                                UnicodeDecodeError):
                            # UnicodeDecodeError: the tear landed inside
                            # a multi-byte UTF-8 character — same torn-
                            # writer residue, different exception
                            if not has_nl:
                                # newline-less torn trailing line — the
                                # residue of a writer killed mid-append
                                # (the newline is the LAST byte of every
                                # committed append, so a record whose
                                # newline landed can never be torn-
                                # writer residue). Drop it AND truncate,
                                # or the next append would concatenate
                                # onto the partial line and corrupt the
                                # log permanently.
                                truncate_to = offset
                                break
                            raise  # committed-line corruption: surface
                        dead += apply(rec)
                        if not has_nl:
                            # parsed fine but the newline never landed:
                            # patch it so the next append starts fresh
                            needs_newline = True
                    offset += len(line)
                if truncate_to is not None:
                    with open(path, "r+b") as wf:
                        wf.truncate(truncate_to)
                    size = truncate_to
                elif needs_newline:
                    with open(path, "ab") as wf:
                        wf.write(b"\n")
                    size += 1
        if dead > max(len(out), 16):
            compacted = self._compact(path, out, size)
            if compacted is not None:
                size, dead = compacted
        self.c.event_cache[path] = (size, out, dead)
        return out, dead

    def _compact(self, path: str, live: Dict[str, Event],
                 replayed_size: int) -> Optional[tuple]:
        """Rewrite the log with only live records (atomic replace). Holds
        the cross-process lock and re-stats the log first: if another
        process appended since our replay, skip — replacing from a stale
        snapshot would silently drop their events."""
        with _flock(path):
            current = os.path.getsize(path) if os.path.exists(path) else -1
            if current != replayed_size:
                return None
            tmp = f"{path}.compact.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                for e in live.values():
                    f.write(json.dumps({"op": "put", "event": e.to_json()})
                            + "\n")
                f.flush()
                size = f.tell()
            os.replace(tmp, path)
            return size, 0

    def _replay(self, app_id: int, channel_id: Optional[int],
                deadline: Optional[float] = None) -> Dict[str, Event]:
        return self._state(self._path(app_id, channel_id), deadline)[0]

    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]:
        with self.c.lock:
            return self._replay(app_id, channel_id).get(event_id)

    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool:
        with self.c.lock:
            path = self._path(app_id, channel_id)
            live, dead = self._state(path)
            if event_id not in live:
                return False
            cached = self.c.event_cache.get(path)
            prior_size = cached[0] if cached is not None else -1
            size = self._append(path, [{"op": "del", "eventId": event_id}],
                                expected_size=prior_size)
            if size is None:
                self.c.event_cache.pop(path, None)
            else:
                live.pop(event_id)
                self.c.event_cache[path] = (size, live, dead + 2)
            return True

    def find(self, app_id: int, channel_id: Optional[int] = None,
             filter: EventFilter = EventFilter()) -> Iterator[Event]:
        with self.c.lock:
            events = list(self._replay(app_id, channel_id,
                                       filter.deadline).values())
        events = list(filter.apply(events))
        events.sort(key=lambda e: e.event_time_millis,
                    reverse=filter.reversed)
        if filter.limit is not None and filter.limit >= 0:
            events = events[: filter.limit]
        return iter(events)


class LocalFSApps(AppsDAO):
    DOC = "apps"

    def __init__(self, client: LocalFSClient):
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
            app_id = app.id
            if app_id == 0:
                app_id = self.c.next_seq("apps")
            elif any(a.id == app_id for a in apps):
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
            self._store([app if a.id == app.id else a
                         for a in self._load()])

    def delete(self, app_id: int) -> None:
        with self.c.lock:
            self._store([a for a in self._load() if a.id != app_id])


class LocalFSAccessKeys(AccessKeysDAO):
    DOC = "access_keys"

    def __init__(self, client: LocalFSClient):
        self.c = client

    def _load(self) -> List[AccessKey]:
        return [AccessKey(key=k["key"], app_id=k["appId"],
                          events=tuple(k["events"]))
                for k in self.c.read_doc(self.DOC, [])]

    def _store(self, keys: List[AccessKey]) -> None:
        self.c.write_doc(self.DOC, [
            {"key": k.key, "appId": k.app_id, "events": list(k.events)}
            for k in keys])

    def insert(self, access_key: AccessKey) -> Optional[str]:
        with self.c.lock:
            keys = self._load()
            key = access_key.key or self.generate_key()
            if any(k.key == key for k in keys):
                return None
            keys.append(AccessKey(key=key, app_id=access_key.app_id,
                                  events=tuple(access_key.events)))
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


class LocalFSChannels(ChannelsDAO):
    DOC = "channels"

    def __init__(self, client: LocalFSClient):
        self.c = client

    def _load(self) -> List[Channel]:
        return [Channel(id=ch["id"], name=ch["name"], app_id=ch["appId"])
                for ch in self.c.read_doc(self.DOC, [])]

    def _store(self, chans: List[Channel]) -> None:
        self.c.write_doc(self.DOC, [
            {"id": ch.id, "name": ch.name, "appId": ch.app_id}
            for ch in chans])

    def insert(self, channel: Channel) -> Optional[int]:
        if not Channel.is_valid_name(channel.name):
            return None
        with self.c.lock:
            chans = self._load()
            cid = channel.id or self.c.next_seq("channels")
            if any(c.id == cid for c in chans):
                return None
            chans.append(Channel(id=cid, name=channel.name,
                                 app_id=channel.app_id))
            self._store(chans)
            return cid

    def get(self, channel_id: int) -> Optional[Channel]:
        return next((c for c in self._load() if c.id == channel_id), None)

    def get_by_app_id(self, app_id: int) -> List[Channel]:
        return [c for c in self._load() if c.app_id == app_id]

    def delete(self, channel_id: int) -> None:
        with self.c.lock:
            self._store([c for c in self._load() if c.id != channel_id])


def _dt(s: str) -> datetime:
    return datetime.fromisoformat(s)


class LocalFSEngineInstances(EngineInstancesDAO):
    DOC = "engine_instances"

    def __init__(self, client: LocalFSClient):
        self.c = client

    def _load(self) -> List[EngineInstance]:
        out = []
        for d in self.c.read_doc(self.DOC, []):
            d = dict(d)
            d["start_time"] = _dt(d["start_time"])
            d["end_time"] = _dt(d["end_time"])
            out.append(EngineInstance(**d))
        return out

    def _store(self, instances: List[EngineInstance]) -> None:
        docs = []
        for i in instances:
            d = {
                "id": i.id, "status": i.status,
                "start_time": i.start_time.isoformat(),
                "end_time": i.end_time.isoformat(),
                "engine_id": i.engine_id,
                "engine_version": i.engine_version,
                "engine_variant": i.engine_variant,
                "engine_factory": i.engine_factory, "batch": i.batch,
                "env": dict(i.env), "spark_conf": dict(i.spark_conf),
                "data_source_params": i.data_source_params,
                "preparator_params": i.preparator_params,
                "algorithms_params": i.algorithms_params,
                "serving_params": i.serving_params,
            }
            docs.append(d)
        self.c.write_doc(self.DOC, docs)

    def insert(self, instance: EngineInstance) -> str:
        with self.c.lock:
            instances = self._load()
            iid = instance.id or uuid.uuid4().hex
            instances.append(instance.copy(id=iid))
            self._store(instances)
            return iid

    def get(self, instance_id: str) -> Optional[EngineInstance]:
        return next((i for i in self._load() if i.id == instance_id), None)

    def get_all(self) -> List[EngineInstance]:
        return self._load()

    def get_completed(self, engine_id: str, engine_version: str,
                      engine_variant: str) -> List[EngineInstance]:
        return sorted(
            (i for i in self._load()
             if i.status == STATUS_COMPLETED and i.engine_id == engine_id
             and i.engine_version == engine_version
             and i.engine_variant == engine_variant),
            key=lambda i: i.start_time, reverse=True)

    def update(self, instance: EngineInstance) -> None:
        with self.c.lock:
            self._store([instance if i.id == instance.id else i
                         for i in self._load()])

    def delete(self, instance_id: str) -> None:
        with self.c.lock:
            self._store([i for i in self._load() if i.id != instance_id])


class LocalFSEvaluationInstances(EvaluationInstancesDAO):
    DOC = "evaluation_instances"

    def __init__(self, client: LocalFSClient):
        self.c = client

    def _load(self) -> List[EvaluationInstance]:
        out = []
        for d in self.c.read_doc(self.DOC, []):
            d = dict(d)
            d["start_time"] = _dt(d["start_time"])
            d["end_time"] = _dt(d["end_time"])
            out.append(EvaluationInstance(**d))
        return out

    def _store(self, instances: List[EvaluationInstance]) -> None:
        self.c.write_doc(self.DOC, [
            {"id": i.id, "status": i.status,
             "start_time": i.start_time.isoformat(),
             "end_time": i.end_time.isoformat(),
             "evaluation_class": i.evaluation_class,
             "engine_params_generator_class":
                 i.engine_params_generator_class,
             "batch": i.batch, "env": dict(i.env),
             "spark_conf": dict(i.spark_conf),
             "evaluator_results": i.evaluator_results,
             "evaluator_results_html": i.evaluator_results_html,
             "evaluator_results_json": i.evaluator_results_json}
            for i in instances])

    def insert(self, instance: EvaluationInstance) -> str:
        with self.c.lock:
            instances = self._load()
            iid = instance.id or uuid.uuid4().hex
            instances.append(instance.copy(id=iid))
            self._store(instances)
            return iid

    def get(self, instance_id: str) -> Optional[EvaluationInstance]:
        return next((i for i in self._load() if i.id == instance_id), None)

    def get_all(self) -> List[EvaluationInstance]:
        return self._load()

    def get_completed(self) -> List[EvaluationInstance]:
        return sorted((i for i in self._load()
                       if i.status == STATUS_EVALCOMPLETED),
                      key=lambda i: i.start_time, reverse=True)

    def update(self, instance: EvaluationInstance) -> None:
        with self.c.lock:
            self._store([instance if i.id == instance.id else i
                         for i in self._load()])

    def delete(self, instance_id: str) -> None:
        with self.c.lock:
            self._store([i for i in self._load() if i.id != instance_id])


class LocalFSModels(ModelsDAO):
    def __init__(self, client: LocalFSClient):
        self.c = client

    def _path(self, model_id: str) -> str:
        return os.path.join(self.c.root, "models", f"{model_id}.bin")

    def insert(self, model: Model) -> None:
        with self.c.lock:
            # a reader on another host/process must never see a
            # truncated model blob mid-write
            atomic_write(self._path(model.id), model.models)

    def get(self, model_id: str) -> Optional[Model]:
        path = self._path(model_id)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return Model(id=model_id, models=f.read())

    def delete(self, model_id: str) -> None:
        with self.c.lock:
            path = self._path(model_id)
            if os.path.exists(path):
                os.remove(path)
