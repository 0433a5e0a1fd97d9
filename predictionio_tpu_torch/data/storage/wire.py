"""The npz column-block wire of the event server's bulk route (the port's
own copy of the ``ColumnarBatch`` part of
``predictionio_tpu/data/storage/wire.py``).

One ``.npz`` payload holds the batch's columns, its dictionaries as numpy
unicode arrays and its numeric property columns: no pickle. Left out
(``ROADMAP.md`` queue 1): the metadata and ``EventFilter`` JSON docs of
the storage server and the REMOTE backend.
"""

from __future__ import annotations

import io

import numpy as np

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
