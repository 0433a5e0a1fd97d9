"""Storage registry: the ``PIO_STORAGE_*`` bootstrap (the port's own copy
of ``predictionio_tpu/data/storage/registry.py``).

Sources come from ``PIO_STORAGE_SOURCES_<NAME>_TYPE`` (plus per-source
keys such as ``..._PATH``) and repositories from
``PIO_STORAGE_REPOSITORIES_{METADATA,EVENTDATA,MODELDATA}_SOURCE``. With
no such variable set, all three repositories are one SQLite file at
``$PIO_HOME/pio.db`` (or ``$PIO_SQLITE_PATH``), as in the JAX package.

Only the MEMORY and SQLITE types are registered; any other type (LOCALFS,
SEGMENTFS, REMOTE, S3, GCS) raises :class:`StorageError` naming the
queue item that lists it.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, Mapping, Optional

from . import memory, sqlite
from .base import (
    LEFT_OUT,
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

#: the JAX package's other backends, not in the port yet
_NOT_PORTED = ("LOCALFS", "SEGMENTFS", "REMOTE", "S3", "GCS", "OBJECTSTORE")


@dataclass
class Backend:
    """Factory bundle for one storage source type."""

    make_client: Callable[[dict], object]
    daos: Dict[str, Callable[[object], object]] = field(default_factory=dict)
    close: Callable[[object], None] = lambda c: None


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
}


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
            if cfg.type in _NOT_PORTED:
                raise StorageError(f"storage type {cfg.type!r} is "
                                   f"{LEFT_OUT}")
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
        """Instantiate every repository DAO and smoke-test the event
        store (the JAX package's check, ``pio status``)."""
        for dao in ("events", "apps", "access_keys", "channels",
                    "engine_instances", "evaluation_instances", "models"):
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
