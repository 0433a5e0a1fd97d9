"""In-memory storage backend: the port's own copy of
``predictionio_tpu/data/storage/memory.py``, the tests' backend.

Implements the event-log and metadata DAO contracts; thread-safe, so the
HTTP servers can call it from their worker threads. Its event-log reads
and writes fire the ``storage.io`` fault point, as the JAX package's do.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Optional, Tuple

from ...faults import declare, fire
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

_Key = Tuple[int, Optional[int]]


#: fired by the in-process backends on the event-log reads and writes the
#: servers depend on; an injection simulates a failing storage backend
F_STORAGE_IO = declare("storage.io",
                       "an event-log read or write of the MEMORY or SQLite "
                       "backend (op=insert|insert_columnar|find, "
                       "backend=memory|sqlite)")


class MemoryEventStore(EventStore):
    def __init__(self, config: Optional[dict] = None):
        self._log: Dict[_Key, Dict[str, Event]] = {}
        self._lock = threading.RLock()

    def _bucket(self, app_id: int, channel_id: Optional[int]) -> Dict[str, Event]:
        return self._log.setdefault((app_id, channel_id), {})

    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        with self._lock:
            self._bucket(app_id, channel_id)
        return True

    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        with self._lock:
            return self._log.pop((app_id, channel_id), None) is not None

    def close(self) -> None:
        pass

    def insert(self, event: Event, app_id: int,
               channel_id: Optional[int] = None) -> str:
        fire(F_STORAGE_IO, op="insert", backend="memory")
        with self._lock:
            eid = event.event_id or new_event_id()
            self._bucket(app_id, channel_id)[eid] = event.copy(event_id=eid)
            return eid

    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]:
        with self._lock:
            return self._bucket(app_id, channel_id).get(event_id)

    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool:
        with self._lock:
            return self._bucket(app_id, channel_id).pop(event_id, None) is not None

    def find(self, app_id: int, channel_id: Optional[int] = None,
             filter: EventFilter = EventFilter()) -> Iterator[Event]:
        fire(F_STORAGE_IO, op="find", backend="memory")
        with self._lock:
            events = list(self._bucket(app_id, channel_id).values())
        events = list(filter.apply(events))
        events.sort(key=lambda e: e.event_time_millis, reverse=filter.reversed)
        if filter.limit is not None and filter.limit >= 0:
            events = events[: filter.limit]
        return iter(events)


class MemoryApps(AppsDAO):
    def __init__(self, config: Optional[dict] = None):
        self._apps: Dict[int, App] = {}
        self._next_id = 1
        self._lock = threading.RLock()

    def insert(self, app: App) -> Optional[int]:
        with self._lock:
            app_id = app.id if app.id > 0 else self._next_id
            if app_id in self._apps or self.get_by_name(app.name):
                return None
            self._next_id = max(self._next_id, app_id) + 1
            self._apps[app_id] = App(app_id, app.name, app.description)
            return app_id

    def get(self, app_id: int) -> Optional[App]:
        return self._apps.get(app_id)

    def get_by_name(self, name: str) -> Optional[App]:
        return next((a for a in self._apps.values() if a.name == name), None)

    def get_all(self) -> List[App]:
        return sorted(self._apps.values(), key=lambda a: a.id)

    def update(self, app: App) -> None:
        with self._lock:
            self._apps[app.id] = app

    def delete(self, app_id: int) -> None:
        with self._lock:
            self._apps.pop(app_id, None)


class MemoryAccessKeys(AccessKeysDAO):
    def __init__(self, config: Optional[dict] = None):
        self._keys: Dict[str, AccessKey] = {}
        self._lock = threading.RLock()

    def insert(self, access_key: AccessKey) -> Optional[str]:
        with self._lock:
            key = access_key.key or self.generate_key()
            if key in self._keys:
                return None
            self._keys[key] = AccessKey(key, access_key.app_id,
                                        tuple(access_key.events))
            return key

    def get(self, key: str) -> Optional[AccessKey]:
        return self._keys.get(key)

    def get_all(self) -> List[AccessKey]:
        return list(self._keys.values())

    def get_by_app_id(self, app_id: int) -> List[AccessKey]:
        return [k for k in self._keys.values() if k.app_id == app_id]

    def update(self, access_key: AccessKey) -> None:
        with self._lock:
            self._keys[access_key.key] = access_key

    def delete(self, key: str) -> None:
        with self._lock:
            self._keys.pop(key, None)


class MemoryChannels(ChannelsDAO):
    def __init__(self, config: Optional[dict] = None):
        self._channels: Dict[int, Channel] = {}
        self._next_id = 1
        self._lock = threading.RLock()

    def insert(self, channel: Channel) -> Optional[int]:
        if not Channel.is_valid_name(channel.name):
            return None
        with self._lock:
            chan_id = channel.id if channel.id > 0 else self._next_id
            if chan_id in self._channels:
                return None
            self._next_id = max(self._next_id, chan_id) + 1
            self._channels[chan_id] = Channel(chan_id, channel.name,
                                              channel.app_id)
            return chan_id

    def get(self, channel_id: int) -> Optional[Channel]:
        return self._channels.get(channel_id)

    def get_by_app_id(self, app_id: int) -> List[Channel]:
        return [c for c in self._channels.values() if c.app_id == app_id]

    def delete(self, channel_id: int) -> None:
        with self._lock:
            self._channels.pop(channel_id, None)


class MemoryEngineInstances(EngineInstancesDAO):
    def __init__(self, config: Optional[dict] = None):
        self._instances: Dict[str, EngineInstance] = {}
        self._next = 1
        self._lock = threading.RLock()

    def insert(self, instance: EngineInstance) -> str:
        with self._lock:
            iid = instance.id or str(self._next)
            self._next += 1
            self._instances[iid] = instance.copy(id=iid)
            return iid

    def get(self, instance_id: str) -> Optional[EngineInstance]:
        return self._instances.get(instance_id)

    def get_all(self) -> List[EngineInstance]:
        return list(self._instances.values())

    def get_completed(self, engine_id: str, engine_version: str,
                      engine_variant: str) -> List[EngineInstance]:
        out = [i for i in self._instances.values()
               if i.status == STATUS_COMPLETED
               and i.engine_id == engine_id
               and i.engine_version == engine_version
               and i.engine_variant == engine_variant]
        return sorted(out, key=lambda i: i.start_time, reverse=True)

    def update(self, instance: EngineInstance) -> None:
        with self._lock:
            self._instances[instance.id] = instance

    def delete(self, instance_id: str) -> None:
        with self._lock:
            self._instances.pop(instance_id, None)


class MemoryEvaluationInstances(EvaluationInstancesDAO):
    def __init__(self, config: Optional[dict] = None):
        self._instances: Dict[str, EvaluationInstance] = {}
        self._next = 1
        self._lock = threading.RLock()

    def insert(self, instance: EvaluationInstance) -> str:
        with self._lock:
            iid = instance.id or str(self._next)
            self._next += 1
            self._instances[iid] = instance.copy(id=iid)
            return iid

    def get(self, instance_id: str) -> Optional[EvaluationInstance]:
        return self._instances.get(instance_id)

    def get_all(self) -> List[EvaluationInstance]:
        return list(self._instances.values())

    def get_completed(self) -> List[EvaluationInstance]:
        out = [i for i in self._instances.values()
               if i.status == STATUS_EVALCOMPLETED]
        return sorted(out, key=lambda i: i.start_time, reverse=True)

    def update(self, instance: EvaluationInstance) -> None:
        with self._lock:
            self._instances[instance.id] = instance

    def delete(self, instance_id: str) -> None:
        with self._lock:
            self._instances.pop(instance_id, None)


class MemoryModels(ModelsDAO):
    def __init__(self, config: Optional[dict] = None):
        self._models: Dict[str, Model] = {}
        self._lock = threading.RLock()

    def insert(self, model: Model) -> None:
        with self._lock:
            self._models[model.id] = model

    def get(self, model_id: str) -> Optional[Model]:
        return self._models.get(model_id)

    def delete(self, model_id: str) -> None:
        with self._lock:
            self._models.pop(model_id, None)
