"""pypio-compatible surface for users migrating from the reference (the
port of ``predictionio_tpu/pypio.py``): the names of
``pypio.data.PEventStore`` over :class:`~.data.store.EventStoreFacade`,
events back as host rows::

    from predictionio_tpu_torch.pypio import p_event_store
    rows = p_event_store.find(app_name="myapp")
    props = p_event_store.aggregate_properties("myapp", "user")

``find`` returns a list of ``Event``s; :func:`events_to_columns` turns
them into columnar numpy arrays (the DataFrame's role).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .data.event import Event
from .data.store import EventStoreFacade, event_store


class PEventStore:
    """Name-compatible with ``pypio.data.PEventStore``."""

    def __init__(self, facade: Optional[EventStoreFacade] = None):
        self._facade = facade or event_store

    def find(self, app_name: str, channel_name: Optional[str] = None,
             **filters) -> List[Event]:
        return list(self._facade.find(app_name, channel_name=channel_name,
                                      **filters))

    def aggregate_properties(self, app_name: str, entity_type: str,
                             channel_name: Optional[str] = None,
                             **filters):
        return self._facade.aggregate_properties(
            app_name, entity_type, channel_name=channel_name, **filters)


def events_to_columns(events: Sequence[Event]) -> Dict[str, np.ndarray]:
    """Columnar view of an event list: object arrays for ids and names,
    int64 milliseconds for times."""
    return {
        "event": np.array([e.event for e in events], dtype=object),
        "entityType": np.array([e.entity_type for e in events],
                               dtype=object),
        "entityId": np.array([e.entity_id for e in events], dtype=object),
        "targetEntityType": np.array(
            [e.target_entity_type for e in events], dtype=object),
        "targetEntityId": np.array(
            [e.target_entity_id for e in events], dtype=object),
        "eventTime": np.array([e.event_time_millis for e in events],
                              dtype=np.int64),
    }


#: module-level instance, mirroring ``pypio``'s usage style
p_event_store = PEventStore()
