"""Columnar bulk event reads: the port's own copy of
``predictionio_tpu/data/columnar.py``.

A :class:`ColumnarBatch` is one projection of an event log as
dictionary-encoded numpy columns: int32 codes for the event name, entity
type and id, target type and id (-1 where the target is absent), int64
event-time millis, float64 numeric properties (NaN where missing) and the
raw property JSON as offset-indexed bytes. Filters run as vectorized
masks. :class:`SegmentLog` is the persistent sidecar SQLite keeps beside
its file; its on-disk format (manifest, dictionaries, ``.npy`` columns)
is the JAX package's, so a sidecar either package wrote reads the same in
the other.

The port imports no pandas: every bulk helper is the numpy and standard
library path, with the JAX package's semantics (codes in first-seen
order, None -> -1, only real JSON numbers become floats). So the id-hash
helper of the SEGMENTFS backend is always blake2b (:func:`hash_impl`),
and a sidecar the JAX package hashed with pandas is rebuilt, not
dup-checked. Segments retire with a grace period
(``invalidate(grace_s)``, :meth:`SegmentLog.sweep`), since another host
of a shared mount may still map them.

Host sharding (the partitioned training read of several processes) is
row slicing: :meth:`ColumnarBatch.shard` cuts the unfiltered storage
order into :meth:`ColumnarBatch.shard_bounds`' contiguous ranges, zero
copy (:meth:`ColumnarBatch.slice_rows`), and stamps the shard with its
global first row (``shard_offset``) and the log's row count
(``shard_total``).
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import queue
import shutil
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import (TYPE_CHECKING, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple)

try:
    import fcntl
except ImportError:  # non-POSIX
    fcntl = None  # type: ignore[assignment]

import numpy as np

from .event import Event, from_millis, to_millis

if TYPE_CHECKING:  # the storage package imports this module on its own
    from .storage.base import EventFilter

__all__ = [
    "StringDict",
    "ColumnarBatch",
    "ColumnarDicts",
    "SegmentLog",
    "columnar_from_events",
    "columnar_from_columns",
    "bulk_hash64",
    "bulk_iso_to_millis",
    "hash_impl",
]


# -- bulk helpers (the backends' encode paths) -----------------------------

def bulk_factorize(values) -> Tuple[np.ndarray, np.ndarray]:
    """``(codes int64 [n], uniques object ndarray)``: codes in first-seen
    order, None -> -1."""
    index: Dict[object, int] = dict.fromkeys(values)  # first-seen order
    has_none = None in index
    index.pop(None, None)
    order = list(index)
    for code, v in enumerate(order):
        index[v] = code
    if has_none:
        index[None] = -1
    codes = np.fromiter(map(index.__getitem__, values), dtype=np.int64,
                        count=len(values))
    uniques = np.empty(len(order), dtype=object)
    uniques[:] = order
    return codes, uniques


def bulk_to_float64(values, assume_numeric: bool = False) -> np.ndarray:
    """Numbers -> float64, anything else (None, str, bool) -> NaN. With
    ``assume_numeric`` the caller guarantees numbers or None (SQLite's
    ``json_type`` gate) and the type pass is skipped."""
    if assume_numeric:
        return np.array(values, dtype=np.float64)
    return np.array([v if isinstance(v, (int, float))
                     and not isinstance(v, bool) else np.nan
                     for v in values], dtype=np.float64)


def hash_impl() -> str:
    """Which :func:`bulk_hash64` this process uses. The JAX package's is
    pandas' siphash where pandas is installed ("pd"); the port's is
    always blake2b. The two never match, so a SEGMENTFS sidecar records
    its writer's implementation and a reader of the other rebuilds it
    instead of running a duplicate check that can never fire."""
    return "blake2b"


def bulk_hash64(strings) -> np.ndarray:
    """Deterministic 64-bit blake2b hashes of strings (uint64), the same
    on every host and in every process."""
    return np.fromiter(
        (int.from_bytes(hashlib.blake2b(
            s.encode("utf-8"), digest_size=8).digest(), "little")
         for s in strings), dtype=np.uint64, count=len(strings))


def bulk_iso_to_millis(strings) -> np.ndarray:
    """ISO-8601 timestamps -> epoch millis int64. ``timedelta`` floor
    division floors exactly, as pandas' millisecond truncation does for
    sub-millisecond times before the epoch."""
    from datetime import datetime, timedelta, timezone

    from .event import parse_iso

    epoch = datetime(1970, 1, 1, tzinfo=timezone.utc)
    one_ms = timedelta(milliseconds=1)
    return np.fromiter(((parse_iso(s) - epoch) // one_ms for s in strings),
                       dtype=np.int64, count=len(strings))


class StringDict:
    """Append-only string -> dense int32 code dictionary. Codes are given
    in first-seen order and never change, so segments encoded at
    different times against one dictionary concatenate as they are."""

    __slots__ = ("values", "index")

    def __init__(self, values: Optional[List[str]] = None):
        self.values: List[str] = list(values or [])
        self.index: Dict[str, int] = {v: i for i, v in enumerate(self.values)}

    def __len__(self) -> int:
        return len(self.values)

    def encode_one(self, s: str) -> int:
        code = self.index.get(s)
        if code is None:
            code = len(self.values)
            self.index[s] = code
            self.values.append(s)
        return code

    def _bulk_lookup(self, uniques) -> np.ndarray:
        """Codes for a sequence of unique strings, appending unseen ones."""
        return np.fromiter((self.encode_one(u) for u in uniques),
                           dtype=np.int32, count=len(uniques))

    def encode(self, strings: Sequence[Optional[str]],
               missing: int = -1) -> np.ndarray:
        """Bulk-encode (appending unseen strings); None -> ``missing``.
        ``bytes`` values are UTF-8; only the uniques are decoded."""
        n = len(strings)
        if n == 0:
            return np.empty(0, dtype=np.int32)
        codes, uniques = bulk_factorize(strings)
        if len(uniques) == 0:  # every value None
            return np.full(n, missing, dtype=np.int32)
        remap = self._bulk_lookup([u.decode("utf-8") if isinstance(u, bytes)
                                   else u for u in uniques.tolist()])
        return np.where(codes >= 0, remap[np.maximum(codes, 0)],
                        np.int32(missing)).astype(np.int32)

    def decode(self, codes: np.ndarray) -> List[Optional[str]]:
        vals = self.values
        return [vals[c] if c >= 0 else None for c in codes.tolist()]

    def as_array(self) -> np.ndarray:
        return np.asarray(self.values, dtype=object)


@dataclass
class ColumnarDicts:
    """The five per-log dictionaries all of a log's segments share."""

    event_names: StringDict = field(default_factory=StringDict)
    entity_types: StringDict = field(default_factory=StringDict)
    entity_ids: StringDict = field(default_factory=StringDict)
    target_types: StringDict = field(default_factory=StringDict)
    target_ids: StringDict = field(default_factory=StringDict)

    def counts(self) -> Dict[str, int]:
        return {k: len(getattr(self, k)) for k in (
            "event_names", "entity_types", "entity_ids",
            "target_types", "target_ids")}


def _empty_f64(n: int) -> np.ndarray:
    return np.full(n, np.nan, dtype=np.float64)


@dataclass
class ColumnarBatch:
    """A projection of one event log as dictionary-encoded columns."""

    event: np.ndarray          # int32 [n]
    entity_type: np.ndarray    # int32 [n]
    entity_id: np.ndarray      # int32 [n]
    target_type: np.ndarray    # int32 [n], -1 = None
    target_id: np.ndarray      # int32 [n], -1 = None
    event_time: np.ndarray     # int64 [n] epoch ms
    props_offsets: np.ndarray  # int64 [n+1]
    props_blob: np.ndarray     # uint8 [total]
    float_props: Dict[str, np.ndarray]  # name -> float64 [n], NaN missing
    dicts: ColumnarDicts

    def __len__(self) -> int:
        return len(self.event)

    @property
    def n(self) -> int:
        return len(self.event)

    # -- filter pushdown (a vectorized EventFilter) ------------------------
    def mask(self, f: EventFilter) -> np.ndarray:
        m = np.ones(self.n, dtype=bool)
        if f.start_time is not None:
            m &= self.event_time >= to_millis(f.start_time)
        if f.until_time is not None:
            m &= self.event_time < to_millis(f.until_time)
        if f.event_names is not None:
            codes = [self.dicts.event_names.index.get(nm, -2)
                     for nm in f.event_names]
            m &= np.isin(self.event, np.asarray(codes, dtype=np.int32))
        if f.entity_type is not None:
            c = self.dicts.entity_types.index.get(f.entity_type, -2)
            m &= self.entity_type == c
        if f.entity_id is not None:
            c = self.dicts.entity_ids.index.get(f.entity_id, -2)
            m &= self.entity_id == c
        for attr, col, sd in (
                ("target_entity_type", self.target_type,
                 self.dicts.target_types),
                ("target_entity_id", self.target_id, self.dicts.target_ids)):
            want = getattr(f, attr)
            if want is ...:  # ``storage.base.ANY``: no filter
                continue
            m &= col == (-1 if want is None else sd.index.get(want, -2))
        return m

    def take(self, idx: np.ndarray,
             with_props: bool = True) -> "ColumnarBatch":
        """Row subset (indices or bool mask). ``with_props=False`` skips
        the property bytes, which the training read never touches."""
        if idx.dtype == bool:
            idx = np.flatnonzero(idx)
        offs = np.zeros(len(idx) + 1, dtype=np.int64)
        blob = np.empty(0, dtype=np.uint8)
        if with_props:
            lens = self.props_offsets[1:] - self.props_offsets[:-1]
            sel_lens = lens[idx]
            np.cumsum(sel_lens, out=offs[1:])
            total = int(offs[-1])
            if total:
                # each output byte's source: its row's start plus its
                # offset within the row
                ramp = np.arange(total, dtype=np.int64) \
                    - np.repeat(offs[:-1], sel_lens)
                src = np.repeat(self.props_offsets[:-1][idx],
                                sel_lens) + ramp
                blob = np.asarray(self.props_blob)[src]
        return ColumnarBatch(
            event=self.event[idx], entity_type=self.entity_type[idx],
            entity_id=self.entity_id[idx], target_type=self.target_type[idx],
            target_id=self.target_id[idx], event_time=self.event_time[idx],
            props_offsets=offs, props_blob=blob,
            float_props={k: v[idx] for k, v in self.float_props.items()},
            dicts=self.dicts)

    def select(self, f: EventFilter, ordered: bool = True,
               with_props: bool = True) -> "ColumnarBatch":
        """Apply an :class:`EventFilter`. ``ordered=False`` skips the
        event-time sort; ``limit`` and ``reversed`` force ordering."""
        m = self.mask(f)
        need_order = ordered or f.reversed \
            or (f.limit is not None and f.limit >= 0)
        if not need_order and m.all():
            if with_props:
                return self
            # the bulk training read's common case: a view without the
            # property bytes
            return ColumnarBatch(
                event=self.event, entity_type=self.entity_type,
                entity_id=self.entity_id, target_type=self.target_type,
                target_id=self.target_id, event_time=self.event_time,
                props_offsets=np.zeros(self.n + 1, dtype=np.int64),
                props_blob=np.empty(0, dtype=np.uint8),
                float_props=self.float_props, dicts=self.dicts)
        idx = np.flatnonzero(m)
        if need_order:
            order = np.argsort(self.event_time[idx], kind="stable")
            if f.reversed:
                order = order[::-1]
            idx = idx[order]
        if f.limit is not None and f.limit >= 0:
            idx = idx[: f.limit]
        return self.take(idx, with_props=with_props)

    # -- property access ---------------------------------------------------
    def props_json(self, i: int) -> dict:
        s, e = int(self.props_offsets[i]), int(self.props_offsets[i + 1])
        if e == s:
            return {}
        return json.loads(self.props_blob[s:e].tobytes().decode("utf-8"))

    def float_prop(self, name: str) -> np.ndarray:
        """Numeric property column, parsed from the raw JSON bytes (and
        cached) when it was not extracted at encode time."""
        col = self.float_props.get(name)
        if col is not None:
            return col
        out = _empty_f64(self.n)
        offs = self.props_offsets
        for i in np.flatnonzero(offs[1:] > offs[:-1]):
            v = self.props_json(int(i)).get(name)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                out[i] = float(v)
        self.float_props[name] = out
        return out

    def to_events(self) -> Iterator[Event]:
        """Rebuild :class:`Event` objects from the projected fields (no
        event ids, tags or prId: a bulk projection does not carry
        them)."""
        d = self.dicts
        ev, et, ei = d.event_names.values, d.entity_types.values, \
            d.entity_ids.values
        tt, ti = d.target_types.values, d.target_ids.values
        for i in range(self.n):
            tc = int(self.target_type[i])
            tic = int(self.target_id[i])
            yield Event(
                event=ev[self.event[i]],
                entity_type=et[self.entity_type[i]],
                entity_id=ei[self.entity_id[i]],
                target_entity_type=tt[tc] if tc >= 0 else None,
                target_entity_id=ti[tic] if tic >= 0 else None,
                properties=self.props_json(i),
                event_time=from_millis(int(self.event_time[i])))

    def slice_rows(self, lo: int, hi: int,
                   with_props: bool = True) -> "ColumnarBatch":
        """The contiguous row range ``[lo, hi)`` by basic slicing: columns
        over mapped files touch no pages outside it. The property bytes
        stay a view (their offsets are rebased, an O(rows) copy)."""
        if not 0 <= lo <= hi <= self.n:
            raise ValueError(f"slice [{lo}, {hi}) of {self.n} rows")
        if with_props:
            offs = self.props_offsets[lo:hi + 1] - self.props_offsets[lo]
            blob = self.props_blob[self.props_offsets[lo]:
                                   self.props_offsets[hi]]
        else:
            offs = np.zeros(hi - lo + 1, dtype=np.int64)
            blob = np.empty(0, dtype=np.uint8)
        return ColumnarBatch(
            event=self.event[lo:hi], entity_type=self.entity_type[lo:hi],
            entity_id=self.entity_id[lo:hi],
            target_type=self.target_type[lo:hi],
            target_id=self.target_id[lo:hi],
            event_time=self.event_time[lo:hi],
            props_offsets=offs, props_blob=blob,
            float_props={k: v[lo:hi]
                         for k, v in self.float_props.items()},
            dicts=self.dicts)

    @staticmethod
    def shard_bounds(n: int, count: int) -> np.ndarray:
        """The ``count + 1`` split points every backend's ``shard=`` read
        uses over ``n`` storage-order rows, so shards cut by different
        backends or processes tile alike."""
        return np.linspace(0, n, count + 1).astype(np.int64)

    def shard(self, index: int, count: int,
              with_props: bool = True) -> "ColumnarBatch":
        """Contiguous host shard ``index`` of ``count``, zero copy
        (:meth:`slice_rows`), stamped with ``shard_offset`` and
        ``shard_total``."""
        if not 0 <= index < count:
            raise ValueError(f"shard {index} of {count}")
        bounds = self.shard_bounds(self.n, count)
        sub = self.slice_rows(int(bounds[index]), int(bounds[index + 1]),
                              with_props=with_props)
        sub.shard_offset = int(bounds[index])
        sub.shard_total = self.n
        return sub

    @staticmethod
    def empty(dicts: Optional[ColumnarDicts] = None,
              float_props: Sequence[str] = ()) -> "ColumnarBatch":
        return ColumnarBatch(
            event=np.empty(0, np.int32), entity_type=np.empty(0, np.int32),
            entity_id=np.empty(0, np.int32),
            target_type=np.empty(0, np.int32),
            target_id=np.empty(0, np.int32),
            event_time=np.empty(0, np.int64),
            props_offsets=np.zeros(1, np.int64),
            props_blob=np.empty(0, np.uint8),
            float_props={k: _empty_f64(0) for k in float_props},
            dicts=dicts or ColumnarDicts())

    @staticmethod
    def concat(batches: Sequence["ColumnarBatch"]) -> "ColumnarBatch":
        """Concatenate batches of one log (one set of dictionaries)."""
        batches = [b for b in batches if b.n > 0]
        if not batches:
            return ColumnarBatch.empty()
        if len(batches) == 1:
            return batches[0]
        prop_names = set()
        for b in batches:
            prop_names |= set(b.float_props)
        offs = [np.zeros(1, dtype=np.int64)]
        total = 0
        for b in batches:
            offs.append(b.props_offsets[1:] + total)
            total += int(b.props_offsets[-1])
        return ColumnarBatch(
            event=np.concatenate([b.event for b in batches]),
            entity_type=np.concatenate([b.entity_type for b in batches]),
            entity_id=np.concatenate([b.entity_id for b in batches]),
            target_type=np.concatenate([b.target_type for b in batches]),
            target_id=np.concatenate([b.target_id for b in batches]),
            event_time=np.concatenate([b.event_time for b in batches]),
            props_offsets=np.concatenate(offs),
            props_blob=np.concatenate([b.props_blob for b in batches]),
            float_props={k: np.concatenate([
                b.float_props.get(k, _empty_f64(b.n)) for b in batches])
                for k in sorted(prop_names)},
            dicts=batches[0].dicts)


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------

def columnar_from_columns(
        dicts: ColumnarDicts,
        event: Sequence[str],
        entity_type: Sequence[str],
        entity_id: Sequence[str],
        target_type: Sequence[Optional[str]],
        target_id: Sequence[Optional[str]],
        event_time_ms: np.ndarray,
        props_json: Optional[Sequence[Optional[str]]] = None,
        float_props: Sequence[str] = ("rating",),
        float_prop_values: Optional[Dict[str, np.ndarray]] = None,
) -> ColumnarBatch:
    """Encode host data that is already columnar: one bulk dictionary
    encode per column, no per-event objects. ``float_prop_values`` gives
    numeric property columns extracted already; the other
    ``float_props`` columns are parsed from ``props_json``."""
    n = len(event)
    if props_json is None:
        offsets = np.zeros(n + 1, dtype=np.int64)
        blob = np.empty(0, dtype=np.uint8)
    else:
        encoded = [(b"" if not p or p == "{}" or p == b"{}"
                    else p if isinstance(p, bytes)
                    else p.encode("utf-8")) for p in props_json]
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.fromiter(map(len, encoded), dtype=np.int64, count=n),
                  out=offsets[1:])
        blob = (np.frombuffer(b"".join(encoded), dtype=np.uint8).copy()
                if int(offsets[-1]) else np.empty(0, dtype=np.uint8))
    batch = ColumnarBatch(
        event=dicts.event_names.encode(event),
        entity_type=dicts.entity_types.encode(entity_type),
        entity_id=dicts.entity_ids.encode(entity_id),
        target_type=dicts.target_types.encode(target_type),
        target_id=dicts.target_ids.encode(target_id),
        event_time=np.ascontiguousarray(event_time_ms, dtype=np.int64),
        props_offsets=offsets, props_blob=blob,
        float_props={k: np.ascontiguousarray(v, dtype=np.float64)
                     for k, v in (float_prop_values or {}).items()
                     if k in float_props},
        dicts=dicts)
    for name in float_props:
        batch.float_prop(name)  # parse from the blob once, cached
    return batch


def columnar_from_events(events: Iterable[Event],
                         dicts: Optional[ColumnarDicts] = None,
                         float_props: Sequence[str] = ("rating",),
                         ) -> ColumnarBatch:
    """Encode an event iterator (the path that is right everywhere)."""
    cols: Tuple[list, ...] = ([], [], [], [], [], [], [])
    ev, et, ei, tt, ti, tms, pj = cols
    for e in events:
        ev.append(e.event)
        et.append(e.entity_type)
        ei.append(e.entity_id)
        tt.append(e.target_entity_type)
        ti.append(e.target_entity_id)
        tms.append(e.event_time_millis)
        pj.append(e.properties.to_json() if len(e.properties) else None)
    return columnar_from_columns(
        dicts or ColumnarDicts(), ev, et, ei, tt, ti,
        np.asarray(tms, dtype=np.int64), pj, float_props=float_props)


# ---------------------------------------------------------------------------
# On-disk segment log (the persistent sidecar)
# ---------------------------------------------------------------------------

_COLS = ("event", "entity_type", "entity_id", "target_type", "target_id",
         "event_time", "props_offsets", "props_blob")
_DICTS = ("event_names", "entity_types", "entity_ids", "target_types",
          "target_ids")


def batch_digest(batch: ColumnarBatch) -> str:
    """sha256 over every column's bytes: one link of the segment log's
    chained content stamp."""
    h = hashlib.sha256()
    h.update(str(batch.n).encode())
    cols = [getattr(batch, c) for c in _COLS]
    cols += [batch.float_props[k] for k in sorted(batch.float_props)]
    for arr in cols:
        a = np.asarray(arr, order="C")
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()


class SegmentLog:
    """Immutable columnar segments and a manifest for one event log::

        <dir>/manifest.json        {"watermark", "count", "float_props",
                                    "segments", "format", "stamp"}
        <dir>/dict_<name>.txt      one JSON string per line
        <dir>/seg-<k>/<col>.npy    one numpy file per column (mmap-read)

    Appends are atomic: the segment and dictionaries are written first,
    the manifest (the commit point) replaced last. ``FORMAT`` versions
    the encoded content; an older manifest is re-encoded."""

    FORMAT = 2

    def __init__(self, path: str):
        self.path = path

    def format_stale(self, manifest: Optional[dict]) -> bool:
        return manifest is not None \
            and int(manifest.get("format", 1)) < self.FORMAT

    @contextlib.contextmanager
    def lock(self):
        """Cross-process exclusive lock over sidecar changes."""
        os.makedirs(self.path, exist_ok=True)
        if fcntl is None:
            yield
            return
        with open(os.path.join(self.path, ".lock"), "a") as lf:
            fcntl.flock(lf, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(lf, fcntl.LOCK_UN)

    # -- manifest ----------------------------------------------------------
    def _manifest_path(self) -> str:
        return os.path.join(self.path, "manifest.json")

    def read_manifest(self) -> Optional[dict]:
        try:
            with open(self._manifest_path(), "r", encoding="utf-8") as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    def _write_manifest(self, manifest: dict) -> None:
        tmp = self._manifest_path() + f".tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(manifest, f)
        os.replace(tmp, self._manifest_path())

    # -- dicts -------------------------------------------------------------
    def _read_dicts(self) -> ColumnarDicts:
        d = ColumnarDicts()
        for name in _DICTS:
            p = os.path.join(self.path, f"dict_{name}.txt")
            if os.path.exists(p):
                with open(p, "r", encoding="utf-8") as f:
                    raw = f.read()
                values = raw.split("\n")[:-1] if raw else []
                setattr(d, name, StringDict([json.loads(v)
                                             for v in values]))
        return d

    def _write_dicts(self, dicts: ColumnarDicts,
                     prev_counts: Dict[str, int]) -> None:
        """Append-only: only the values new since ``prev_counts``."""
        for name in _DICTS:
            sd: StringDict = getattr(dicts, name)
            start = prev_counts.get(name, 0)
            if len(sd) == start:
                continue
            p = os.path.join(self.path, f"dict_{name}.txt")
            with open(p, "a", encoding="utf-8") as f:
                for v in sd.values[start:]:
                    f.write(json.dumps(v) + "\n")

    def dicts_and_counts(self) -> Tuple[ColumnarDicts, Dict[str, int]]:
        d = self._read_dicts()
        return d, d.counts()

    # -- segments ----------------------------------------------------------
    def append(self, batch: ColumnarBatch, watermark,
               prev_dict_counts: Dict[str, int],
               seq_range: Optional[Tuple[int, int]] = None,
               has_props: bool = True,
               hash_impl: Optional[str] = None) -> None:
        """Write ``batch`` as a new segment and commit the manifest.
        ``has_props=False`` defers the property-byte columns;
        :meth:`ensure_props` adds them later from the recorded source
        range ``seq_range`` (half-open ``(lo, hi]``). A writer that keeps
        id-hash columns beside its segments names its ``hash_impl``."""
        os.makedirs(self.path, exist_ok=True)
        manifest = self.read_manifest() or {
            "count": 0, "segments": [], "float_props": [],
            "watermark": None, "format": self.FORMAT}
        seg_name = (f"seg-{len(manifest['segments']):06d}-"
                    f"{uuid.uuid4().hex[:8]}")
        seg_dir = os.path.join(self.path, seg_name)
        os.makedirs(seg_dir, exist_ok=True)
        cols = _COLS if has_props else tuple(
            c for c in _COLS if not c.startswith("props_"))
        for col in cols:
            np.save(os.path.join(seg_dir, f"{col}.npy"),
                    getattr(batch, col), allow_pickle=False)
        for name, arr in batch.float_props.items():
            np.save(os.path.join(seg_dir, f"prop_{name}.npy"), arr,
                    allow_pickle=False)
        self._write_dicts(batch.dicts, prev_dict_counts)
        entry = {"name": seg_name, "n": batch.n, "props": bool(has_props)}
        if seq_range is not None:
            entry["seq"] = [int(seq_range[0]), int(seq_range[1])]
        manifest["segments"].append(entry)
        manifest["count"] += batch.n
        manifest["watermark"] = watermark
        # chained content stamp: O(delta) per append
        manifest["stamp"] = hashlib.sha256(
            (manifest.get("stamp", "") + batch_digest(batch))
            .encode()).hexdigest()[:32]
        manifest["float_props"] = sorted(
            set(manifest["float_props"]) | set(batch.float_props))
        if hash_impl is not None:
            manifest["hash_impl"] = hash_impl
        self._write_manifest(manifest)

    def ensure_props(self, fetch) -> None:
        """Add the property columns to props-deferred segments:
        ``fetch(lo, hi, n)`` returns ``(props_offsets [n+1] int64,
        props_blob uint8)`` of a segment's source range. Call under
        :meth:`lock`."""
        manifest = self.read_manifest()
        if manifest is None:
            return
        changed = False
        for seg in manifest["segments"]:
            if seg.get("props", True):
                continue
            lo, hi = seg["seq"]
            offs, blob = fetch(lo, hi, seg["n"])
            seg_dir = os.path.join(self.path, seg["name"])
            np.save(os.path.join(seg_dir, "props_offsets.npy"), offs,
                    allow_pickle=False)
            np.save(os.path.join(seg_dir, "props_blob.npy"), blob,
                    allow_pickle=False)
            seg["props"] = True
            changed = True
        if changed:
            self._write_manifest(manifest)

    #: canonical dtypes of the core columns, whatever a writer stored
    _CORE_DTYPES = (("event", np.int32), ("entity_type", np.int32),
                    ("entity_id", np.int32), ("target_type", np.int32),
                    ("target_id", np.int32), ("event_time", np.int64))

    def load(self, with_props: bool = True
             ) -> Tuple[Optional[ColumnarBatch], Optional[dict]]:
        """``(batch, manifest)``: a one-segment log mmaps its files in
        place; more segments are read into one buffer a column, the next
        segment read by a thread while the current one is copied.
        ``with_props=True`` needs every segment's property columns."""
        manifest = self.read_manifest()
        if manifest is None:
            return None, None
        dicts = self._read_dicts()
        segs = manifest["segments"]
        if with_props and not all(s.get("props", True) for s in segs):
            raise RuntimeError("a segment is props-deferred; call "
                               "ensure_props() before load(with_props=True)")
        if not segs:
            return ColumnarBatch.empty(dicts), manifest
        if len(segs) == 1:
            seg_dir = os.path.join(self.path, segs[0]["name"])

            def col(name: str) -> np.ndarray:
                return np.load(os.path.join(seg_dir, f"{name}.npy"),
                               mmap_mode="r", allow_pickle=False)

            return ColumnarBatch(
                event=col("event"), entity_type=col("entity_type"),
                entity_id=col("entity_id"), target_type=col("target_type"),
                target_id=col("target_id"), event_time=col("event_time"),
                props_offsets=(col("props_offsets") if with_props
                               else np.zeros(segs[0]["n"] + 1, np.int64)),
                props_blob=(col("props_blob") if with_props
                            else np.empty(0, np.uint8)),
                float_props={name: col(f"prop_{name}")
                             for name in manifest["float_props"]
                             if os.path.exists(os.path.join(
                                 seg_dir, f"prop_{name}.npy"))},
                dicts=dicts), manifest
        return self._load_contiguous(manifest, dicts, with_props), manifest

    def _load_contiguous(self, manifest: dict, dicts: ColumnarDicts,
                         with_props: bool) -> ColumnarBatch:
        segs = manifest["segments"]
        fp_names = list(manifest["float_props"])
        total = int(sum(s["n"] for s in segs))
        dest = {name: np.empty(total, dt) for name, dt in self._CORE_DTYPES}
        props_offsets = np.zeros(total + 1, np.int64)
        props_blob = np.empty(0, np.uint8)
        if with_props:
            blob_total = sum(
                int(np.load(os.path.join(self.path, s["name"],
                                         "props_blob.npy"),
                            mmap_mode="r", allow_pickle=False).shape[0])
                for s in segs)
            props_blob = np.empty(blob_total, np.uint8)
        fp = {k: _empty_f64(total) for k in fp_names}

        def read_segment(seg: dict) -> dict:
            seg_dir = os.path.join(self.path, seg["name"])
            names = [n for n, _ in self._CORE_DTYPES]
            if with_props:
                names += ["props_offsets", "props_blob"]
            names += [f"prop_{k}" for k in fp_names if os.path.exists(
                os.path.join(seg_dir, f"prop_{k}.npy"))]
            return {n: np.load(os.path.join(seg_dir, f"{n}.npy"),
                               allow_pickle=False) for n in names}

        # maxsize=2 bounds the read-ahead to the next segment
        q: queue.Queue = queue.Queue(maxsize=2)

        def producer() -> None:
            try:
                for i, seg in enumerate(segs):
                    q.put((i, read_segment(seg)))
            except BaseException as e:  # surfaced on the consumer side
                q.put((-1, e))

        t = threading.Thread(target=producer, daemon=True,
                             name="segmentlog-prefetch")
        t.start()
        row = blob_base = 0
        for _ in range(len(segs)):
            i, arrs = q.get()
            if i < 0:
                t.join()
                raise arrs
            n = int(segs[i]["n"])
            for name, _ in self._CORE_DTYPES:
                dest[name][row:row + n] = arrs[name]
            if with_props:
                offs = arrs["props_offsets"]
                props_offsets[row:row + n + 1] = offs + blob_base
                blen = int(offs[-1])
                props_blob[blob_base:blob_base + blen] = arrs["props_blob"]
                blob_base += blen
            for name in fp_names:
                a = arrs.get(f"prop_{name}")
                if a is not None:
                    fp[name][row:row + n] = a
            row += n
        t.join()
        return ColumnarBatch(
            event=dest["event"], entity_type=dest["entity_type"],
            entity_id=dest["entity_id"], target_type=dest["target_type"],
            target_id=dest["target_id"], event_time=dest["event_time"],
            props_offsets=props_offsets, props_blob=props_blob,
            float_props=fp, dicts=dicts)

    def invalidate(self, grace_s: float = 0.0) -> None:
        """Drop the sidecar's contents (deletes changed history): the
        manifest, the commit point, goes first; the ``.lock`` file stays
        so waiters keep a valid inode. With ``grace_s > 0`` segment
        directories are retired, not deleted: another host of a shared
        mount may still map them, so :meth:`sweep` removes them once
        idle that long."""
        if not os.path.isdir(self.path):
            return
        with contextlib.suppress(OSError):
            os.remove(self._manifest_path())
        now = time.time()
        for name in os.listdir(self.path):
            if name == ".lock":
                continue
            p = os.path.join(self.path, name)
            if grace_s > 0 and name.startswith("seg-") and os.path.isdir(p):
                # the grace clock runs from retirement, not creation
                with contextlib.suppress(OSError):
                    os.utime(p, (now, now))
                continue
            with contextlib.suppress(OSError):
                shutil.rmtree(p) if os.path.isdir(p) else os.remove(p)

    def sweep(self, grace_s: float) -> int:
        """Delete the retired (unreferenced) segment directories idle for
        ``grace_s`` seconds; the count removed. Call under :meth:`lock`."""
        if not os.path.isdir(self.path):
            return 0
        referenced = {s["name"] for s in
                      (self.read_manifest() or {}).get("segments", ())}
        n = 0
        now = time.time()
        for name in os.listdir(self.path):
            if not name.startswith("seg-") or name in referenced:
                continue
            p = os.path.join(self.path, name)
            try:
                if os.path.isdir(p) and now - os.path.getmtime(p) >= grace_s:
                    shutil.rmtree(p)
                    n += 1
            except OSError:
                pass
        return n
