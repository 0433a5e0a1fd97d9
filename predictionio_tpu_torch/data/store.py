"""The event store as templates address it: by app name and optional
channel name (the port's own copy of ``predictionio_tpu/data/store.py``).

:class:`EventStoreFacade` resolves names to ids through the metadata
DAOs and serves the bulk reads (``find``, ``find_columnar``). The port runs
in one process, so ``host_sharded`` is the identity, as it is in the JAX
package at ``jax.process_count() == 1``. Left out (``ROADMAP.md`` queue
1): ``aggregate_properties`` and the serving-time ``find_by_entity``.
"""

from __future__ import annotations

from datetime import datetime
from typing import Iterator, Optional, Sequence

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
        One process holds the whole log, so ``host_sharded`` changes
        nothing."""
        app_id, channel_id = self.resolve(app_name, channel_name)
        filt = EventFilter(
            start_time=start_time, until_time=until_time,
            entity_type=entity_type, entity_id=entity_id,
            event_names=event_names,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id)
        return self.storage.events().find_columnar(
            app_id, channel_id, filt, float_props=float_props,
            ordered=ordered, with_props=with_props)
