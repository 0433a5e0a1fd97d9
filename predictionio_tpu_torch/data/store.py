"""The event store as templates address it: by app name and optional
channel name (the port's own copy of ``predictionio_tpu/data/store.py``).

:class:`EventStoreFacade` resolves names to ids through the metadata
DAOs and serves the bulk reads (``find``, ``find_columnar``), property
aggregation (``aggregate_properties``) and the serving-time point reads
(``find_by_entity``, bounded by a deadline). The port runs in one
process, so ``host_sharded`` is the identity, as it is in the JAX
package at ``jax.process_count() == 1``. :data:`event_store` is the
facade over the process-wide storage that templates fall back to.
"""

from __future__ import annotations

import time
from datetime import datetime
from typing import Dict, Iterator, List, Optional, Sequence

from .datamap import PropertyMap
from .event import Event
from .storage.base import ANY, EventFilter, StorageError
from .storage.registry import Storage, get_storage


class EventStoreFacade:
    def __init__(self, storage: Optional[Storage] = None):
        self._storage = storage

    @property
    def storage(self) -> Storage:
        return self._storage if self._storage is not None else get_storage()

    def resolve(self, app_name: str,
                channel_name: Optional[str] = None) -> tuple:
        """``(app_id, channel_id)`` of an app name and channel name."""
        app = self.storage.apps().get_by_name(app_name)
        if app is None:
            raise StorageError(f"App {app_name!r} does not exist; create it "
                               f"first (pio app new {app_name})")
        channel_id = None
        if channel_name is not None:
            chans = self.storage.channels().get_by_app_id(app.id)
            match = next((c for c in chans if c.name == channel_name), None)
            if match is None:
                raise StorageError(f"Channel {channel_name!r} does not exist "
                                   f"in app {app_name!r}")
            channel_id = match.id
        return app.id, channel_id

    def find(self, app_name: str, channel_name: Optional[str] = None,
             start_time: Optional[datetime] = None,
             until_time: Optional[datetime] = None,
             entity_type: Optional[str] = None,
             entity_id: Optional[str] = None,
             event_names: Optional[Sequence[str]] = None,
             target_entity_type=ANY, target_entity_id=ANY,
             limit: Optional[int] = None,
             reversed: bool = False) -> Iterator[Event]:
        app_id, channel_id = self.resolve(app_name, channel_name)
        return self.storage.events().find(app_id, channel_id, EventFilter(
            start_time=start_time, until_time=until_time,
            entity_type=entity_type, entity_id=entity_id,
            event_names=event_names, target_entity_type=target_entity_type,
            target_entity_id=target_entity_id, limit=limit,
            reversed=reversed))

    def find_columnar(self, app_name: str,
                      channel_name: Optional[str] = None,
                      start_time: Optional[datetime] = None,
                      until_time: Optional[datetime] = None,
                      entity_type: Optional[str] = None,
                      entity_id: Optional[str] = None,
                      event_names: Optional[Sequence[str]] = None,
                      target_entity_type=ANY, target_entity_id=ANY,
                      float_props: Sequence[str] = ("rating",),
                      ordered: bool = True, with_props: bool = True,
                      host_sharded: bool = False):
        """The training read: the matching events as a
        :class:`~predictionio_tpu_torch.data.columnar.ColumnarBatch`.
        ``host_sharded=True`` in a process group of several processes
        reads only this process's shard (``shard=(rank, world)``, pushed
        down to the backend); alone it is the whole read."""
        app_id, channel_id = self.resolve(app_name, channel_name)
        filt = EventFilter(
            start_time=start_time, until_time=until_time,
            entity_type=entity_type, entity_id=entity_id,
            event_names=event_names,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id)
        shard = None
        if host_sharded:
            from ..parallel.multihost import process_count, process_index

            if process_count() > 1:
                shard = (process_index(), process_count())
        return self.storage.events().find_columnar(
            app_id, channel_id, filt, float_props=float_props,
            ordered=ordered, with_props=with_props, shard=shard)

    def aggregate_properties(
            self, app_name: str, entity_type: str,
            channel_name: Optional[str] = None,
            start_time: Optional[datetime] = None,
            until_time: Optional[datetime] = None,
            required: Optional[Sequence[str]] = None
    ) -> Dict[str, PropertyMap]:
        """Each ``entity_type`` entity's current properties, replayed
        from its ``$set/$unset/$delete`` events."""
        app_id, channel_id = self.resolve(app_name, channel_name)
        return self.storage.events().aggregate_properties(
            app_id, channel_id, entity_type=entity_type,
            start_time=start_time, until_time=until_time, required=required)

    def find_by_entity(self, app_name: str, entity_type: str, entity_id: str,
                       channel_name: Optional[str] = None,
                       event_names: Optional[Sequence[str]] = None,
                       target_entity_type=ANY, target_entity_id=ANY,
                       start_time: Optional[datetime] = None,
                       until_time: Optional[datetime] = None,
                       limit: Optional[int] = None,
                       latest: bool = True,
                       timeout_ms: Optional[int] = None) -> List[Event]:
        """The blocking point read of serving-time filters: one entity's
        events, the latest first when ``latest``. ``timeout_ms`` bounds the
        wall clock: the deadline goes into the backend's scan (checked
        inside it) and is checked again while the result drains, so a
        heavy entity raises ``TimeoutError`` near the deadline rather
        than after materializing everything."""
        deadline = (time.monotonic() + timeout_ms / 1000.0
                    if timeout_ms is not None else None)
        app_id, channel_id = self.resolve(app_name, channel_name)
        it = self.storage.events().find(app_id, channel_id, EventFilter(
            start_time=start_time, until_time=until_time,
            entity_type=entity_type, entity_id=entity_id,
            event_names=event_names, target_entity_type=target_entity_type,
            target_entity_id=target_entity_id, limit=limit,
            reversed=latest, deadline=deadline))
        drain = EventFilter(deadline=deadline)  # matches all; bounds drain
        return list(drain.apply(it))


#: the facade over the process-wide storage: what a template reads
#: through when no serving context was bound
event_store = EventStoreFacade()
