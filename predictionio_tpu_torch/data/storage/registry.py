"""Storage registry: the ``PIO_STORAGE_*`` bootstrap (the port's own copy
of ``predictionio_tpu/data/storage/registry.py``).

Sources come from ``PIO_STORAGE_SOURCES_<NAME>_TYPE`` (plus per-source
keys such as ``..._PATH``) and repositories from
``PIO_STORAGE_REPOSITORIES_{METADATA,EVENTDATA,MODELDATA}_SOURCE``. With
no such variable set, all three repositories are one SQLite file at
``$PIO_HOME/pio.db`` (or ``$PIO_SQLITE_PATH``), as in the JAX package.

Every type the JAX package registers is registered: MEMORY, SQLITE,
LOCALFS (``..._PATH``), SEGMENTFS (``..._PATH``, a shared mount), REMOTE
(``..._URL`` of a storage server, ``..._SECRET``) and S3, GCS or
OBJECTSTORE (``..._ENDPOINT`` ``http://host:port/bucket``,
``..._HEADERS``), each reading and writing the JAX package's formats. An
unknown type raises :class:`StorageError`; :func:`register_backend` adds
a type of the caller's own.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, Mapping, Optional

from . import localfs, memory, objectstore, remote, segmentfs, sqlite
from .base import (
    AccessKeysDAO,
    AppsDAO,
    ChannelsDAO,
    EngineInstancesDAO,
    EvaluationInstancesDAO,
    EventStore,
    ModelsDAO,
    StorageError,
)

REPOSITORIES = ("METADATA", "EVENTDATA", "MODELDATA")

_DAO_NAMES = ("events", "apps", "access_keys", "channels",
              "engine_instances", "evaluation_instances", "models")


@dataclass
class Backend:
    """Factory bundle for one storage source type."""

    make_client: Callable[[dict], object]
    daos: Dict[str, Callable[[object], object]] = field(default_factory=dict)
    close: Callable[[object], None] = lambda c: None


def register_backend(type_name: str, backend: Backend) -> None:
    """Make ``PIO_STORAGE_SOURCES_<NAME>_TYPE=<type_name>`` open
    ``backend`` (case-insensitive; a later call replaces an earlier
    one)."""
    _BACKENDS[type_name.upper()] = backend


#: source type -> its backend; :func:`register_backend` adds to it
_BACKENDS: Dict[str, Backend] = {
    "MEMORY": Backend(
        make_client=lambda cfg: None,
        daos={
            "events": lambda c: memory.MemoryEventStore(),
            "apps": lambda c: memory.MemoryApps(),
            "access_keys": lambda c: memory.MemoryAccessKeys(),
            "channels": lambda c: memory.MemoryChannels(),
            "engine_instances": lambda c: memory.MemoryEngineInstances(),
            "evaluation_instances":
                lambda c: memory.MemoryEvaluationInstances(),
            "models": lambda c: memory.MemoryModels(),
        }),
    "SQLITE": Backend(
        make_client=lambda cfg: sqlite.SQLiteClient.from_config(cfg),
        daos={
            "events": lambda c: sqlite.SQLiteEventStore(c),
            "apps": lambda c: sqlite.SQLiteApps(c),
            "access_keys": lambda c: sqlite.SQLiteAccessKeys(c),
            "channels": lambda c: sqlite.SQLiteChannels(c),
            "engine_instances": lambda c: sqlite.SQLiteEngineInstances(c),
            "evaluation_instances":
                lambda c: sqlite.SQLiteEvaluationInstances(c),
            "models": lambda c: sqlite.SQLiteModels(c),
        },
        close=lambda c: c.close()),
    "LOCALFS": Backend(
        make_client=lambda cfg: localfs.LocalFSClient.from_config(cfg),
        daos={
            "events": lambda c: localfs.LocalFSEventStore(c),
            "apps": lambda c: localfs.LocalFSApps(c),
            "access_keys": lambda c: localfs.LocalFSAccessKeys(c),
            "channels": lambda c: localfs.LocalFSChannels(c),
            "engine_instances": lambda c: localfs.LocalFSEngineInstances(c),
            "evaluation_instances":
                lambda c: localfs.LocalFSEvaluationInstances(c),
            "models": lambda c: localfs.LocalFSModels(c),
        },
        close=lambda c: c.close()),
    "SEGMENTFS": Backend(
        make_client=lambda cfg: segmentfs.SegmentFSClient.from_config(cfg),
        daos={
            "events": lambda c: segmentfs.SegmentFSEventStore(c),
            "apps": lambda c: segmentfs.SegmentFSApps(c),
            "access_keys": lambda c: segmentfs.SegmentFSAccessKeys(c),
            "channels": lambda c: segmentfs.SegmentFSChannels(c),
            "engine_instances":
                lambda c: segmentfs.SegmentFSEngineInstances(c),
            "evaluation_instances":
                lambda c: segmentfs.SegmentFSEvaluationInstances(c),
            "models": lambda c: segmentfs.SegmentFSModels(c),
        },
        close=lambda c: c.close()),
    "REMOTE": Backend(
        make_client=lambda cfg: remote.RemoteClient.from_config(cfg),
        daos={
            "events": lambda c: remote.RemoteEventStore(c),
            "apps": lambda c: remote.RemoteApps(c),
            "access_keys": lambda c: remote.RemoteAccessKeys(c),
            "channels": lambda c: remote.RemoteChannels(c),
            "engine_instances": lambda c: remote.RemoteEngineInstances(c),
            "evaluation_instances":
                lambda c: remote.RemoteEvaluationInstances(c),
            "models": lambda c: remote.RemoteModels(c),
        },
        close=lambda c: c.close()),
}

# S3 and GCS are one backend: both stores speak the same REST subset (the
# GCS XML API is S3-compatible)
for _name in ("S3", "GCS", "OBJECTSTORE"):
    register_backend(_name, Backend(
        make_client=lambda cfg: objectstore.ObjectStoreClient.from_config(
            cfg),
        daos={
            "events": lambda c: objectstore.ObjectStoreEventStore(c),
            "apps": lambda c: objectstore.ObjectStoreApps(c),
            "access_keys": lambda c: objectstore.ObjectStoreAccessKeys(c),
            "channels": lambda c: objectstore.ObjectStoreChannels(c),
            "engine_instances":
                lambda c: objectstore.ObjectStoreEngineInstances(c),
            "evaluation_instances":
                lambda c: objectstore.ObjectStoreEvaluationInstances(c),
            "models": lambda c: objectstore.ObjectStoreModels(c),
        },
        close=lambda c: c.close()))


@dataclass
class SourceConfig:
    name: str
    type: str
    properties: Dict[str, str] = field(default_factory=dict)


class Storage:
    """One configured storage environment: sources and the repositories
    bound to them. Unbound repositories fall back to the alphabetically
    first source name."""

    def __init__(self, env: Optional[Mapping[str, str]] = None):
        self.env = dict(env if env is not None else os.environ)
        self._sources: Dict[str, SourceConfig] = {}
        self._repos: Dict[str, str] = {}
        self._clients: Dict[str, object] = {}
        self._dao_cache: Dict[tuple, object] = {}
        self._lock = threading.RLock()
        self._parse_env()

    def _parse_env(self) -> None:
        prefix = "PIO_STORAGE_SOURCES_"
        names = sorted({k[len(prefix):-len("_TYPE")] for k in self.env
                        if k.startswith(prefix) and k.endswith("_TYPE")})
        for name in names:
            p = f"{prefix}{name}_"
            props = {k[len(p):]: v for k, v in self.env.items()
                     if k.startswith(p) and k != f"{p}TYPE"}
            self._sources[name] = SourceConfig(
                name=name, type=self.env[f"{p}TYPE"].upper(), properties=props)
        for repo in REPOSITORIES:
            src = self.env.get(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE")
            if src is not None:
                if src not in self._sources:
                    raise StorageError(
                        f"repository {repo} references undefined source {src}")
                self._repos[repo] = src
        if not self._sources:
            # the default: one SQLite file for everything
            home = self.env.get("PIO_HOME",
                                os.path.join(os.getcwd(), "pio_data"))
            path = self.env.get("PIO_SQLITE_PATH",
                                os.path.join(home, "pio.db"))
            self._sources["DEFAULT"] = SourceConfig(
                name="DEFAULT", type="SQLITE", properties={"PATH": path})
        default = next(iter(self._sources))
        for repo in REPOSITORIES:
            self._repos.setdefault(repo, default)

    def _backend(self, cfg: SourceConfig) -> Backend:
        backend = _BACKENDS.get(cfg.type)
        if backend is None:
            raise StorageError(f"unknown storage type {cfg.type!r} "
                               f"(registered: {sorted(_BACKENDS)})")
        return backend

    def _client(self, source_name: str) -> object:
        with self._lock:
            if source_name not in self._clients:
                cfg = self._sources[source_name]
                self._clients[source_name] = \
                    self._backend(cfg).make_client(cfg.properties)
            return self._clients[source_name]

    def _dao(self, repo: str, dao: str):
        source_name = self._repos[repo]
        key = (source_name, dao)
        with self._lock:
            if key not in self._dao_cache:
                backend = self._backend(self._sources[source_name])
                self._dao_cache[key] = backend.daos[dao](
                    self._client(source_name))
            return self._dao_cache[key]

    def events(self) -> EventStore:
        return self._dao("EVENTDATA", "events")

    def apps(self) -> AppsDAO:
        return self._dao("METADATA", "apps")

    def access_keys(self) -> AccessKeysDAO:
        return self._dao("METADATA", "access_keys")

    def channels(self) -> ChannelsDAO:
        return self._dao("METADATA", "channels")

    def engine_instances(self) -> EngineInstancesDAO:
        return self._dao("METADATA", "engine_instances")

    def evaluation_instances(self) -> EvaluationInstancesDAO:
        return self._dao("METADATA", "evaluation_instances")

    def models(self) -> ModelsDAO:
        return self._dao("MODELDATA", "models")

    def verify_all_data_objects(self) -> None:
        """Instantiate every repository DAO of whatever backend and
        smoke-test the event store (the JAX package's check, ``pio
        status``)."""
        for dao in _DAO_NAMES:
            repo = ("EVENTDATA" if dao == "events"
                    else "MODELDATA" if dao == "models" else "METADATA")
            self._dao(repo, dao)
        ev = self.events()
        ev.init(0)
        ev.remove(0)

    def close(self) -> None:
        with self._lock:
            for name, client in self._clients.items():
                self._backend(self._sources[name]).close(client)
            self._clients.clear()
            self._dao_cache.clear()


_global: Optional[Storage] = None
_global_lock = threading.Lock()


def get_storage(refresh: bool = False) -> Storage:
    """Process-wide storage environment (built from ``os.environ`` at
    first use)."""
    global _global
    with _global_lock:
        if _global is None or refresh:
            _global = Storage()
        return _global


def set_storage(storage: Optional[Storage]) -> None:
    """Override the process-wide storage (``pio run``, embedded use)."""
    global _global
    with _global_lock:
        _global = storage
