"""Wire formats of the storage server, the REMOTE backend and the event
server's bulk route (the port's own copy of
``predictionio_tpu/data/storage/wire.py``), byte for byte the JAX
package's:

- metadata entities <-> JSON documents, datetimes as ISO strings;
- :class:`EventFilter` <-> JSON, the ``ANY`` sentinel spelled
  ``{"any": true}`` beside ``{"value": ...}``;
- a ``ColumnarBatch`` <-> one ``.npz`` payload: its columns, its
  dictionaries as numpy unicode arrays and its numeric property columns,
  no pickle.
"""

from __future__ import annotations

import dataclasses
import io
from datetime import datetime
from typing import Any, Dict, Optional

import numpy as np

from .base import (
    ANY,
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EvaluationInstance,
    EventFilter,
)

# -- metadata entities ------------------------------------------------------

_DT_FIELDS = ("start_time", "end_time")


def entity_to_doc(e) -> dict:
    d = dataclasses.asdict(e)
    for k in _DT_FIELDS:
        if isinstance(d.get(k), datetime):
            d[k] = d[k].isoformat()
    if "events" in d:
        d["events"] = list(d["events"])
    return d


_ENTITY_TYPES = {
    "apps": App,
    "access_keys": AccessKey,
    "channels": Channel,
    "engine_instances": EngineInstance,
    "evaluation_instances": EvaluationInstance,
}


def entity_from_doc(dao: str, d: dict):
    d = dict(d)
    for k in _DT_FIELDS:
        if isinstance(d.get(k), str):
            d[k] = datetime.fromisoformat(d[k])
    if "events" in d and d["events"] is not None:
        d["events"] = tuple(d["events"])
    return _ENTITY_TYPES[dao](**d)


# -- EventFilter ------------------------------------------------------------

def filter_to_doc(f: EventFilter) -> dict:
    """The filter as JSON; its ``deadline`` is a local monotonic time and
    does not cross the wire (the client turns it into a timeout)."""
    def tri(v) -> Dict[str, Any]:
        return {"any": True} if v is ANY else {"value": v}

    return {
        "start_time": f.start_time.isoformat() if f.start_time else None,
        "until_time": f.until_time.isoformat() if f.until_time else None,
        "entity_type": f.entity_type,
        "entity_id": f.entity_id,
        "event_names": (list(f.event_names)
                        if f.event_names is not None else None),
        "target_entity_type": tri(f.target_entity_type),
        "target_entity_id": tri(f.target_entity_id),
        "limit": f.limit,
        "reversed": f.reversed,
    }


def filter_from_doc(d: Optional[dict]) -> EventFilter:
    if not d:
        return EventFilter()

    def tri(v):
        if not isinstance(v, dict) or v.get("any"):
            return ANY
        return v.get("value")

    def dt(s):
        return datetime.fromisoformat(s) if s else None

    return EventFilter(
        start_time=dt(d.get("start_time")),
        until_time=dt(d.get("until_time")),
        entity_type=d.get("entity_type"),
        entity_id=d.get("entity_id"),
        event_names=d.get("event_names"),
        target_entity_type=tri(d.get("target_entity_type", {"any": True})),
        target_entity_id=tri(d.get("target_entity_id", {"any": True})),
        limit=d.get("limit"),
        reversed=bool(d.get("reversed")),
    )


# -- ColumnarBatch ----------------------------------------------------------

_BATCH_COLS = ("event", "entity_type", "entity_id", "target_type",
               "target_id", "event_time", "props_offsets", "props_blob")
_DICT_NAMES = ("event_names", "entity_types", "entity_ids",
               "target_types", "target_ids")


def batch_to_npz(batch) -> bytes:
    """Serialize a ColumnarBatch."""
    arrays = {c: np.asarray(getattr(batch, c)) for c in _BATCH_COLS}
    for name in _DICT_NAMES:
        vals = getattr(batch.dicts, name).values
        arrays[f"dict_{name}"] = np.asarray(vals, dtype="U") if vals \
            else np.empty(0, dtype="U1")
    for name, arr in batch.float_props.items():
        arrays[f"prop_{name}"] = np.asarray(arr)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def batch_from_npz(data: bytes):
    from ..columnar import ColumnarBatch, ColumnarDicts, StringDict

    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        dicts = ColumnarDicts(**{
            name: StringDict([str(v) for v in z[f"dict_{name}"]])
            for name in _DICT_NAMES})
        return ColumnarBatch(
            **{c: z[c] for c in _BATCH_COLS},
            float_props={k[len("prop_"):]: z[k] for k in z.files
                         if k.startswith("prop_")},
            dicts=dicts)
