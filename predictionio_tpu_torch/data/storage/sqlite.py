"""SQLite storage backend, the default: the port's own copy of
``predictionio_tpu/data/storage/sqlite.py``.

One database file holds the event log (tables ``events_<appId>[_<channelId>]``),
the metadata and the model blobs, with the JAX package's schema, so one
``pio.db`` reads the same from both packages. WAL mode and a
process-wide lock make it safe for the HTTP servers' worker threads; the
shared connection keeps a 256 MB page cache (the JAX package keeps
SQLite's 2 MB default), which holds the random-id index of a bulk
ingest. The columnar sidecar ``<db>.columnar/<table>/`` has the JAX
package's format too.

A table from before the ``seq`` column (SQLite reuses the implicit rowid
after deletes, which would falsify the sidecar's watermark) is rebuilt
around ``seq`` the first time it is opened (:meth:`SQLiteEventStore.
_migrate_legacy`). A large first encode of the sidecar runs its seq
ranges in forked worker processes, which touch only ``sqlite3`` and
numpy, never torch or the card; it forks only while the process runs a
single thread, and encodes in-process otherwise.

Inserts, column-block writes and finds fire the ``storage.io`` fault
point (``memory.F_STORAGE_IO``), as MEMORY's do.
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
from collections import deque
from concurrent.futures import ProcessPoolExecutor
from itertools import repeat
from typing import Iterator, List, Optional

import numpy as np

from ...faults import fire
from ..columnar import (
    ColumnarBatch,
    SegmentLog,
    bulk_factorize,
    bulk_to_float64,
)
from ..datamap import DataMap
from ..event import (
    Event,
    from_millis,
    new_event_id,
    new_event_ids,
    to_millis,
    utcnow,
)
from .base import (
    ANY,
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
    keep_required,
)
from .memory import F_STORAGE_IO


#: page cache of the shared connection, in KiB (SQLite's default is 2 MB)
CACHE_KIB = 256 * 1024


class SQLiteClient:
    """Shared connection + write lock for one database file."""

    def __init__(self, path: str = ":memory:"):
        self.path = path
        if path != ":memory:":
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.conn = sqlite3.connect(path, check_same_thread=False)
        self.conn.execute("PRAGMA journal_mode=WAL")
        # WAL + NORMAL: commits are durable against app crashes and only
        # lose the tail on OS/power failure — the standard WAL trade, and
        # ~10× fewer fsyncs on the per-event REST ingest path
        self.conn.execute("PRAGMA synchronous=NORMAL")
        # every event carries a random id under a UNIQUE index, so bulk
        # inserts touch random index pages; past the default 2 MB page
        # cache each miss is a read system call, and the insert rate
        # falls as the log grows (PERF.md, the lifecycle cell). A
        # connection setting: schema and durability unchanged
        self.conn.execute(f"PRAGMA cache_size=-{CACHE_KIB}")
        self.lock = threading.RLock()
        #: in-process columnar sidecar cache: table → (batch, watermark,
        #: count) — revalidated against the row store on every bulk read
        self.columnar_cache: dict = {}

    def close(self) -> None:
        with self.lock:
            self.conn.close()

    @staticmethod
    def from_config(config: Optional[dict]) -> "SQLiteClient":
        path = (config or {}).get("PATH", ":memory:")
        return SQLiteClient(path)


def _table(app_id: int, channel_id: Optional[int]) -> str:
    # `is not None`, never falsy: channel 0 must not alias the default
    # channel (memory/localfs/segmentfs already keep it distinct)
    return f"events_{app_id}" + (f"_{channel_id}"
                                 if channel_id is not None else "")


def _fork_context():
    """The fork multiprocessing context, or None where there is none.
    Fork, not spawn: a worker skips re-importing numpy and touches only
    its own sqlite connection and numpy, so the parent's state (torch, a
    CUDA context) is inert in it."""
    import multiprocessing

    try:
        return multiprocessing.get_context("fork")
    except ValueError:  # pragma: no cover — non-POSIX
        return None


def _encode_range(path: str, sql: str, rng: tuple,
                  n_props: int) -> Optional[dict]:
    """One seq range of the columnar encode, self-contained so that a
    worker process can run it: fetch (bytes ``text_factory``, so only
    dictionary uniques are decoded), factorize each column locally and
    build the numeric property columns. The raw property JSON is not
    fetched (props-deferred segments). The caller remaps the local codes
    onto the persistent dictionaries."""
    conn = sqlite3.connect(path)
    conn.text_factory = bytes
    try:
        rows = conn.execute(sql, rng).fetchall()
    finally:
        conn.close()
    if not rows:
        return None
    cols = list(zip(*rows))
    n = len(rows)
    codes_out = {}
    uniq_out = {}
    for name, j in (("event", 0), ("entity_type", 1), ("entity_id", 2),
                    ("target_type", 3), ("target_id", 4)):
        codes, uniques = bulk_factorize(cols[j])
        codes_out[name] = codes.astype(np.int32)
        uniq_out[name] = [u.decode("utf-8") if isinstance(u, bytes)
                          else u for u in uniques.tolist()]
    # json_extract yields float/int/None only (json_type gated in SQL)
    fpv = [bulk_to_float64(cols[6 + j], assume_numeric=True)
           for j in range(n_props)]
    return dict(codes=codes_out, uniq=uniq_out,
                times=np.asarray(cols[5], dtype=np.int64), fpv=fpv,
                lo=int(rng[0]), last_seq=int(rng[1]), n=n)


class SQLiteEventStore(EventStore):
    def __init__(self, client: SQLiteClient):
        self.client = client
        #: the last sidecar encode: {"path": "forked" or "in-process",
        #: "workers", "ranges"}
        self.last_encode: dict = {}

    @property
    def _conn(self) -> sqlite3.Connection:
        return self.client.conn

    #: the event columns in canonical order (queries never SELECT * — the
    #: leading ``seq`` column is bookkeeping, not event data)
    EVENT_COLS = ("id, event, entity_type, entity_id, target_entity_type, "
                  "target_entity_id, properties, event_time, tags, pr_id, "
                  "creation_time")

    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        with self.client.lock:
            table = _table(app_id, channel_id)
            self._migrate_legacy(table)
            self._conn.execute(f"""
                CREATE TABLE IF NOT EXISTS {table} (
                    seq INTEGER PRIMARY KEY AUTOINCREMENT,
                    id TEXT UNIQUE NOT NULL,
                    event TEXT NOT NULL,
                    entity_type TEXT NOT NULL,
                    entity_id TEXT NOT NULL,
                    target_entity_type TEXT,
                    target_entity_id TEXT,
                    properties TEXT,
                    event_time INTEGER NOT NULL,
                    tags TEXT,
                    pr_id TEXT,
                    creation_time INTEGER NOT NULL
                )""")
            self._conn.execute(
                f"CREATE INDEX IF NOT EXISTS idx_{table}_t "
                f"ON {table} (event_time)")
            self._conn.commit()
        return True

    def _migrate_legacy(self, table: str) -> None:
        """Rebuild a table from before the ``seq`` column around an
        AUTOINCREMENT ``seq``, which is never reused (the implicit rowid
        is, after deletes, and a reused rowid can make a changed prefix
        look unchanged to the sidecar's watermark). One explicit
        transaction: a crash mid-migration never strands events in the
        ``_legacy`` table, and a ``_legacy`` table left by an older,
        non-atomic migration is finished."""
        tmp = f"{table}_legacy"
        names = {r[0] for r in self._conn.execute(
            "SELECT name FROM sqlite_master WHERE type='table' "
            "AND name IN (?, ?)", (table, tmp))}
        if not names:
            return
        cols = [r[1] for r in
                self._conn.execute(f"PRAGMA table_info({table})")] \
            if table in names else []
        if "seq" in cols and tmp not in names:
            return  # already migrated
        self._conn.commit()
        self._conn.execute("BEGIN IMMEDIATE")
        try:
            if table in names and "seq" not in cols:
                self._conn.execute(f"ALTER TABLE {table} RENAME TO {tmp}")
            self._conn.execute(f"""
                CREATE TABLE IF NOT EXISTS {table} (
                    seq INTEGER PRIMARY KEY AUTOINCREMENT,
                    id TEXT UNIQUE NOT NULL,
                    event TEXT NOT NULL,
                    entity_type TEXT NOT NULL,
                    entity_id TEXT NOT NULL,
                    target_entity_type TEXT,
                    target_entity_id TEXT,
                    properties TEXT,
                    event_time INTEGER NOT NULL,
                    tags TEXT,
                    pr_id TEXT,
                    creation_time INTEGER NOT NULL
                )""")
            self._conn.execute(
                f"INSERT OR IGNORE INTO {table} ({self.EVENT_COLS}) "
                f"SELECT {self.EVENT_COLS} FROM {tmp} ORDER BY rowid")
            self._conn.execute(f"DROP TABLE {tmp}")
            self._conn.execute(
                f"CREATE INDEX IF NOT EXISTS idx_{table}_t "
                f"ON {table} (event_time)")
            self._conn.commit()
        except BaseException:
            self._conn.rollback()
            raise

    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        with self.client.lock:
            self._conn.execute(
                f"DROP TABLE IF EXISTS {_table(app_id, channel_id)}")
            self._conn.commit()
            for wp in (False, True):
                self.client.columnar_cache.pop(
                    (_table(app_id, channel_id), wp), None)
        d = self._columnar_dir(app_id, channel_id)
        if d is not None:
            log = SegmentLog(d)
            with log.lock():
                log.invalidate()
        return True

    def close(self) -> None:
        pass  # client is shared; closed by the registry

    def insert(self, event: Event, app_id: int,
               channel_id: Optional[int] = None) -> str:
        return self.insert_batch([event], app_id, channel_id)[0]

    def insert_batch(self, events, app_id: int,
                     channel_id: Optional[int] = None) -> List[str]:
        fire(F_STORAGE_IO, op="insert", backend="sqlite")
        rows, ids = [], []
        for e in events:
            eid = e.event_id or new_event_id()
            ids.append(eid)
            rows.append((
                eid, e.event, e.entity_type, e.entity_id,
                e.target_entity_type, e.target_entity_id,
                e.properties.to_json(), to_millis(e.event_time),
                json.dumps(list(e.tags)), e.pr_id,
                to_millis(e.creation_time)))
        sql = (f"INSERT OR REPLACE INTO {_table(app_id, channel_id)} "
               f"({self.EVENT_COLS}) VALUES (?,?,?,?,?,?,?,?,?,?,?)")
        with self.client.lock:
            try:
                try:
                    self._conn.executemany(sql, rows)
                except sqlite3.OperationalError as e:
                    if "no such table" not in str(e):
                        raise
                    self.init(app_id, channel_id)
                    self._conn.executemany(sql, rows)
                self._conn.commit()
            except BaseException:
                # a failed executemany may have applied a prefix of the
                # rows; roll it back so a caller's per-event retry (the
                # event server's poison-batch fallback) cannot commit
                # those rows alongside fresh duplicates
                self._conn.rollback()
                raise
        return ids

    def insert_columnar(self, batch, app_id: int,
                        channel_id: Optional[int] = None) -> int:
        """Vectorized block write: each dictionary-coded column is decoded
        once, the event ids are drawn in one call, and the rows go down in
        a single ``executemany`` transaction: no per-event ``Event``
        object and no per-event system call."""
        fire(F_STORAGE_IO, op="insert_columnar", backend="sqlite")
        n = batch.n
        if n == 0:
            return 0
        d = batch.dicts
        offs = batch.props_offsets.tolist()
        blob = batch.props_blob.tobytes()
        props = [blob[s:e].decode("utf-8") if e > s else "{}"
                 for s, e in zip(offs[:-1], offs[1:])]
        now_ms = to_millis(utcnow())
        rows = list(zip(
            new_event_ids(n), d.event_names.decode(batch.event),
            d.entity_types.decode(batch.entity_type),
            d.entity_ids.decode(batch.entity_id),
            d.target_types.decode(batch.target_type),
            d.target_ids.decode(batch.target_id), props,
            batch.event_time.tolist(), repeat("[]", n), repeat(None, n),
            repeat(now_ms, n)))
        sql = (f"INSERT OR REPLACE INTO {_table(app_id, channel_id)} "
               f"({self.EVENT_COLS}) VALUES (?,?,?,?,?,?,?,?,?,?,?)")
        with self.client.lock:
            try:
                try:
                    self._conn.executemany(sql, rows)
                except sqlite3.OperationalError as e:
                    if "no such table" not in str(e):
                        raise
                    self.init(app_id, channel_id)
                    self._conn.executemany(sql, rows)
                self._conn.commit()
            except BaseException:
                self._conn.rollback()
                raise
        return n

    # -- columnar bulk reads (PEvents role) --------------------------------
    #: rows per columnar segment during sidecar sync
    COLUMNAR_CHUNK = 2_000_000

    def _columnar_dir(self, app_id: int,
                      channel_id: Optional[int]) -> Optional[str]:
        if self.client.path == ":memory:":
            return None
        return os.path.join(f"{self.client.path}.columnar",
                            _table(app_id, channel_id))

    def _scalar(self, sql: str, *params) -> Optional[int]:
        with self.client.lock:
            try:
                row = self._conn.execute(sql, params).fetchone()
            except sqlite3.OperationalError as e:
                if "no such table" in str(e):
                    return None
                raise
        return row[0] if row else None

    def warm_columnar(self, app_id: int,
                      channel_id: Optional[int] = None) -> bool:
        d = self._columnar_dir(app_id, channel_id)
        if d is None:  # :memory: database — nothing persistent to warm
            return False
        self._sync_columnar(d, app_id, channel_id, ("rating",),
                            want_props=False)
        return True

    def find_columnar(self, app_id: int, channel_id: Optional[int] = None,
                      filter: EventFilter = EventFilter(),
                      float_props=("rating",),
                      ordered: bool = True, with_props: bool = True,
                      shard=None):
        """Columnar bulk read backed by a persistent segment sidecar
        (``<db>.columnar/<table>/``): the row store stays authoritative;
        immutable numpy segments are synced forward by ``seq`` watermark
        and mmap-loaded, so a training-scale scan runs no per-row
        Python. ``shard=(i, n)`` slices the mapped projection by row
        range: pages outside the shard stay untouched."""
        d = self._columnar_dir(app_id, channel_id)
        if d is None:  # :memory: database — encode per call
            return super().find_columnar(app_id, channel_id, filter,
                                         float_props, ordered=ordered,
                                         with_props=with_props, shard=shard)
        batch = self._sync_columnar(d, app_id, channel_id,
                                    tuple(float_props),
                                    want_props=with_props)
        if shard is not None:
            return self._shard_and_select(batch, shard, filter,
                                          ordered=ordered,
                                          with_props=with_props)
        return batch.select(filter, ordered=ordered, with_props=with_props)

    def aggregate_properties(self, app_id: int,
                             channel_id: Optional[int] = None, *,
                             entity_type: str, start_time=None,
                             until_time=None, required=None):
        """Aggregation over the sidecar: the filters run as numpy masks
        and only the surviving ``$set/$unset/$delete`` rows pay a JSON
        parse. A ``:memory:`` database has no sidecar and replays
        :meth:`find`."""
        d = self._columnar_dir(app_id, channel_id)
        if d is None:
            return super().aggregate_properties(
                app_id, channel_id, entity_type=entity_type,
                start_time=start_time, until_time=until_time,
                required=required)
        from ..aggregation import AGGREGATION_EVENTS, aggregate_from_columnar
        batch = self._sync_columnar(d, app_id, channel_id, ("rating",),
                                    want_props=True)
        sub = batch.select(EventFilter(
            entity_type=entity_type, start_time=start_time,
            until_time=until_time,
            event_names=list(AGGREGATION_EVENTS)), ordered=False)
        return keep_required(aggregate_from_columnar(sub), required)

    def _change_stamp(self) -> tuple:
        """(data_version, total_changes): moves whenever this connection —
        or any other process — writes the database. Stable stamp ⇒ the
        cached columnar view is provably current without paying the O(n)
        prefix-count validity query per read."""
        with self.client.lock:
            dv = self._conn.execute("PRAGMA data_version").fetchone()[0]
            return dv, self._conn.total_changes

    def _sync_columnar(self, sidecar_dir: str, app_id: int,
                       channel_id: Optional[int], float_props: tuple,
                       want_props: bool = True):
        table = _table(app_id, channel_id)
        stamp = self._change_stamp()
        ck = (table, bool(want_props))
        cached = self.client.columnar_cache.get(ck)
        if cached is not None and cached[2] == stamp:
            return cached[1]
        with self.client.lock:
            self._migrate_legacy(table)  # the watermark needs seq
        log = SegmentLog(sidecar_dir)
        with log.lock():
            manifest = log.read_manifest()
            if log.format_stale(manifest):
                if int(manifest.get("format", 1)) == 1:
                    # format 1 differed only in how ISO strings became
                    # millis, which SQLite's INTEGER column never used:
                    # stamp in place instead of re-encoding
                    manifest["format"] = 2
                    log._write_manifest(manifest)
                if log.format_stale(manifest):
                    log.invalidate()
                    manifest = None
            wm = int((manifest or {}).get("watermark") or 0)
            count = int((manifest or {}).get("count") or 0)
            if manifest is not None:
                # deletes / REPLACEd rows below the watermark falsify the
                # segments; rebuild from scratch when the prefix changed
                # (seq is AUTOINCREMENT: never reused, so this check is
                # sound against delete-then-reinsert races)
                prefix = self._scalar(
                    f"SELECT COUNT(*) FROM {table} WHERE seq<=?", wm)
                if prefix != count:
                    log.invalidate()
                    manifest, wm, count = None, 0, 0
            max_seq = self._scalar(
                f"SELECT COALESCE(MAX(seq),0) FROM {table}")
            if max_seq is None:  # table never created
                return ColumnarBatch.empty()
            if max_seq > wm:
                self._encode_delta(log, table, wm, float_props)
            if want_props:
                try:
                    log.ensure_props(self._fetch_props_range(table))
                except RuntimeError:
                    # a delete raced the sync inside a deferred segment's
                    # range: self-heal in-call instead of surfacing a
                    # transient error to the reader
                    log.invalidate()
                    self._encode_delta(log, table, 0, float_props)
                    log.ensure_props(self._fetch_props_range(table))
                    cached = None
            manifest = log.read_manifest()
            key = ((manifest or {}).get("watermark"),
                   (manifest or {}).get("count"),
                   len((manifest or {}).get("segments") or ()))
            # stamp taken BEFORE the validity queries: a write racing the
            # sync makes the stamp stale, forcing revalidation next call
            if cached is not None and cached[0] == key:
                batch = cached[1]
            else:
                batch, _ = log.load(with_props=want_props)
                if batch is None:
                    batch = ColumnarBatch.empty()
            self.client.columnar_cache[ck] = (key, batch, stamp)
            return batch

    def _fetch_props_range(self, table: str):
        """Fetch-callback factory for :meth:`SegmentLog.ensure_props`:
        builds one segment's ``(props_offsets, props_blob)`` from the
        row store by seq range."""
        def fetch(lo: int, hi: int, n: int):
            with self.client.lock:
                rows = self._conn.execute(
                    f"SELECT CAST(properties AS BLOB) FROM {table} "
                    f"WHERE seq>? AND seq<=? ORDER BY seq",
                    (lo, hi)).fetchall()
            if len(rows) != n:
                # a delete raced the sync inside this range; the prefix
                # check will invalidate and rebuild on the next call
                raise RuntimeError(
                    f"props upgrade: {table} range ({lo},{hi}] has "
                    f"{len(rows)} rows, segment expects {n}")
            encoded = [b"" if not p or p == b"{}" else p
                       for (p,) in rows]
            lens = np.fromiter(map(len, encoded), dtype=np.int64,
                               count=n)
            offs = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(lens, out=offs[1:])
            blob = (np.frombuffer(b"".join(encoded), dtype=np.uint8)
                    .copy() if int(offs[-1]) else
                    np.empty(0, dtype=np.uint8))
            return offs, blob

        return fetch

    #: rows per fetch unit (several make up one segment)
    ENCODE_SUBCHUNK = 250_000
    #: worker processes of a forked first encode
    ENCODE_PROCS = 4
    #: deltas below this many (estimated) rows encode in-process: the
    #: pool's start would cost more
    ENCODE_PARALLEL_MIN = 600_000

    def _chunk_bounds(self, table: str, watermark: int,
                      step: int) -> List[int]:
        """Ascending seq upper bounds splitting ``seq > watermark`` into
        ~``step``-row ranges. ``seq`` aliases the rowid, so each OFFSET
        probe is an index-only B-tree walk (C speed)."""
        bounds: List[int] = []
        lo = watermark
        while True:
            with self.client.lock:
                row = self._conn.execute(
                    f"SELECT MAX(seq) FROM (SELECT seq FROM {table} "
                    f"WHERE seq>? ORDER BY seq LIMIT ?)",
                    (lo, step)).fetchone()
            if row is None or row[0] is None or row[0] <= lo:
                return bounds
            bounds.append(int(row[0]))
            lo = int(row[0])

    def _encode_delta(self, log, table: str, watermark: int,
                      float_props: tuple) -> None:
        """Encode the rows above ``watermark`` into new segments, numeric
        property extraction pushed into SQL (``json_extract``). A large
        delta is split into ``ENCODE_SUBCHUNK``-row seq ranges run by
        ``ENCODE_PROCS`` forked worker processes, each fetching its range
        on its own connection and doing the per-row work (threads would
        serialize on the interpreter lock for exactly that work); the
        parent remaps only each range's uniques onto the persistent
        dictionaries and stitches segments in order. A small delta, one
        core or a process running more than one thread encodes the
        ranges in-process. ``last_encode`` records the last call's
        path, workers and ranges."""
        safe_props = [p for p in float_props
                      if p.replace("_", "").isalnum()]
        # json_type gate: only real JSON numbers become ratings — a string
        # "N/A" or a bool must come back NULL (matching the lazy-parse
        # path's isinstance check), never be CAST-coerced to 0.0/1.0
        prop_sql = "".join(
            f", CASE WHEN json_type(properties, '$.{p}') IN "
            f"('integer','real') THEN "
            f"json_extract(properties, '$.{p}') END"
            for p in safe_props)
        # properties JSON is NOT fetched — the training read never touches
        # it; props-needing readers upgrade segments via ensure_props().
        # seq itself isn't fetched either: the range bounds are actual
        # seq values, so each range's last seq is its upper bound.
        sql = (f"SELECT event, entity_type, entity_id, "
               f"target_entity_type, target_entity_id, "
               f"event_time{prop_sql} FROM {table} "
               f"WHERE seq>? AND seq<=? ORDER BY seq")
        bounds = self._chunk_bounds(table, watermark,
                                    self.ENCODE_SUBCHUNK)
        if not bounds:
            return
        dicts, prev_counts = log.dicts_and_counts()
        ranges = list(zip([watermark] + bounds[:-1], bounds))
        path = os.path.abspath(self.client.path)
        n_props = len(safe_props)
        per_seg = max(1, self.COLUMNAR_CHUNK // self.ENCODE_SUBCHUNK)

        def emit(parts: list) -> None:
            """Remap worker-local dictionary codes onto the persistent
            dicts (uniques only — C-bulk via StringDict.encode) and
            commit one segment."""
            nonlocal prev_counts
            cols = {}
            for name, sd in (("event", dicts.event_names),
                             ("entity_type", dicts.entity_types),
                             ("entity_id", dicts.entity_ids),
                             ("target_type", dicts.target_types),
                             ("target_id", dicts.target_ids)):
                chunks = []
                for p in parts:
                    codes = p["codes"][name]
                    uniq = p["uniq"][name]
                    if len(uniq) == 0:
                        chunks.append(np.full(p["n"], -1, np.int32))
                        continue
                    # worker uniques are already unique: skip encode()'s
                    # re-factorize, go straight to the C-bulk lookup
                    remap = sd._bulk_lookup(uniq)
                    chunks.append(np.where(
                        codes >= 0, remap[np.maximum(codes, 0)],
                        np.int32(-1)).astype(np.int32))
                cols[name] = np.concatenate(chunks)
            n_seg = sum(p["n"] for p in parts)
            batch = ColumnarBatch(
                event=cols["event"], entity_type=cols["entity_type"],
                entity_id=cols["entity_id"],
                target_type=cols["target_type"],
                target_id=cols["target_id"],
                event_time=np.concatenate([p["times"] for p in parts]),
                props_offsets=np.zeros(n_seg + 1, np.int64),
                props_blob=np.empty(0, np.uint8),
                float_props={nm: np.concatenate(
                    [p["fpv"][j] for p in parts])
                    for j, nm in enumerate(safe_props)},
                dicts=dicts)
            log.append(batch, watermark=int(parts[-1]["last_seq"]),
                       prev_dict_counts=prev_counts,
                       seq_range=(int(parts[0]["lo"]),
                                  int(parts[-1]["last_seq"])),
                       has_props=False)
            prev_counts = dicts.counts()

        est_rows = len(ranges) * self.ENCODE_SUBCHUNK
        n_cpu = os.cpu_count() or 1
        # fork only while single-threaded: a child forked from a process
        # with other threads can inherit a held lock and deadlock (the
        # servers' worker threads call this path too)
        ctx = _fork_context() if threading.active_count() == 1 else None
        if len(ranges) == 1 or est_rows < self.ENCODE_PARALLEL_MIN \
                or n_cpu == 1 or ctx is None:
            self.last_encode = {"path": "in-process", "workers": 0,
                                "ranges": len(ranges)}
            for seg_start in range(0, len(ranges), per_seg):
                parts = [p for rng in ranges[seg_start:seg_start + per_seg]
                         if (p := _encode_range(
                             path, sql, rng, n_props)) is not None]
                if parts:
                    emit(parts)
            return
        workers = max(1, min(self.ENCODE_PROCS, n_cpu, len(ranges)))
        self.last_encode = {"path": "forked", "workers": workers,
                            "ranges": len(ranges)}
        with ProcessPoolExecutor(max_workers=workers,
                                 mp_context=ctx) as pool:
            futs: deque = deque()
            ri = 0
            pending: list = []
            while ri < len(ranges) or futs:
                while ri < len(ranges) and len(futs) < workers + 2:
                    futs.append(pool.submit(_encode_range, path, sql,
                                            ranges[ri], n_props))
                    ri += 1
                p = futs.popleft().result()
                if p is not None:
                    pending.append(p)
                if len(pending) >= per_seg or (not futs
                                               and ri >= len(ranges)):
                    if pending:
                        emit(pending)
                        pending = []

    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]:
        with self.client.lock:
            try:
                cur = self._conn.execute(
                    f"SELECT {self.EVENT_COLS} FROM "
                    f"{_table(app_id, channel_id)} WHERE id=?",
                    (event_id,))
                row = cur.fetchone()
            except sqlite3.OperationalError as e:
                if "no such table" in str(e):
                    return None
                raise
        return _row_to_event(row) if row else None

    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool:
        with self.client.lock:
            try:
                cur = self._conn.execute(
                    f"DELETE FROM {_table(app_id, channel_id)} WHERE id=?",
                    (event_id,))
            except sqlite3.OperationalError as e:
                if "no such table" in str(e):
                    return False
                raise
            self._conn.commit()
            return cur.rowcount > 0

    def find(self, app_id: int, channel_id: Optional[int] = None,
             filter: EventFilter = EventFilter()) -> Iterator[Event]:
        fire(F_STORAGE_IO, op="find", backend="sqlite")
        clauses, params = [], []
        if filter.start_time is not None:
            clauses.append("event_time >= ?")
            params.append(to_millis(filter.start_time))
        if filter.until_time is not None:
            clauses.append("event_time < ?")
            params.append(to_millis(filter.until_time))
        if filter.entity_type is not None:
            clauses.append("entity_type = ?")
            params.append(filter.entity_type)
        if filter.entity_id is not None:
            clauses.append("entity_id = ?")
            params.append(filter.entity_id)
        if filter.event_names is not None:
            qs = ",".join("?" * len(filter.event_names))
            clauses.append(f"event IN ({qs})")
            params.extend(filter.event_names)
        for col, val in (("target_entity_type", filter.target_entity_type),
                         ("target_entity_id", filter.target_entity_id)):
            if val is ANY:
                continue
            if val is None:
                clauses.append(f"{col} IS NULL")
            else:
                clauses.append(f"{col} = ?")
                params.append(val)
        where = (" WHERE " + " AND ".join(clauses)) if clauses else ""
        order = " ORDER BY event_time " + ("DESC" if filter.reversed else "ASC")
        lim = ""
        if filter.limit is not None and filter.limit >= 0:
            lim = " LIMIT ?"
            params.append(filter.limit)
        sql = (f"SELECT {self.EVENT_COLS} FROM "
               f"{_table(app_id, channel_id)}{where}{order}{lim}")
        with self.client.lock:
            try:
                cur = self._conn.execute(sql, params)
                rows: list = []
                while True:
                    # fetched in chunks, so a heavy scan honours
                    # filter.deadline instead of materializing it all
                    filter.check_deadline()
                    chunk = cur.fetchmany(4096)
                    if not chunk:
                        break
                    rows.extend(chunk)
            except sqlite3.OperationalError as e:
                if "no such table" in str(e):
                    return iter(())
                raise
        return (_row_to_event(r) for r in rows)


def _row_to_event(row) -> Event:
    (eid, event, etype, eidd, tetype, teid, props, t, tags, pr_id, ct) = row
    return Event(
        event=event, entity_type=etype, entity_id=eidd,
        target_entity_type=tetype, target_entity_id=teid,
        properties=DataMap.from_json(props) if props else DataMap(),
        event_time=from_millis(t), tags=tuple(json.loads(tags or "[]")),
        pr_id=pr_id, creation_time=from_millis(ct), event_id=eid)


class _SQLiteMeta:
    """Shared setup for metadata DAOs."""

    DDL = """
        CREATE TABLE IF NOT EXISTS apps (
            id INTEGER PRIMARY KEY AUTOINCREMENT, name TEXT UNIQUE NOT NULL,
            description TEXT);
        CREATE TABLE IF NOT EXISTS access_keys (
            key TEXT PRIMARY KEY, app_id INTEGER NOT NULL, events TEXT);
        CREATE TABLE IF NOT EXISTS channels (
            id INTEGER PRIMARY KEY AUTOINCREMENT, name TEXT NOT NULL,
            app_id INTEGER NOT NULL);
        CREATE TABLE IF NOT EXISTS engine_instances (
            id TEXT PRIMARY KEY, status TEXT, start_time INT,
            end_time INT, engine_id TEXT, engine_version TEXT,
            engine_variant TEXT, engine_factory TEXT, batch TEXT,
            env TEXT, spark_conf TEXT, data_source_params TEXT,
            preparator_params TEXT, algorithms_params TEXT,
            serving_params TEXT);
        CREATE TABLE IF NOT EXISTS evaluation_instances (
            id TEXT PRIMARY KEY, status TEXT, start_time INT,
            end_time INT, evaluation_class TEXT,
            engine_params_generator_class TEXT, batch TEXT, env TEXT,
            spark_conf TEXT, evaluator_results TEXT,
            evaluator_results_html TEXT, evaluator_results_json TEXT);
        CREATE TABLE IF NOT EXISTS models (
            id TEXT PRIMARY KEY, models BLOB NOT NULL);
    """

    def __init__(self, client: SQLiteClient):
        self.client = client
        with client.lock:
            client.conn.executescript(self.DDL)
            client.conn.commit()

    def _exec(self, sql, params=()):
        with self.client.lock:
            cur = self.client.conn.execute(sql, params)
            self.client.conn.commit()
            return cur

    def _query(self, sql, params=()):
        with self.client.lock:
            return self.client.conn.execute(sql, params).fetchall()


class SQLiteApps(_SQLiteMeta, AppsDAO):
    def insert(self, app: App) -> Optional[int]:
        try:
            if app.id > 0:
                cur = self._exec(
                    "INSERT INTO apps (id, name, description) VALUES (?,?,?)",
                    (app.id, app.name, app.description))
            else:
                cur = self._exec(
                    "INSERT INTO apps (name, description) VALUES (?,?)",
                    (app.name, app.description))
            return cur.lastrowid
        except sqlite3.IntegrityError:
            return None

    def get(self, app_id: int) -> Optional[App]:
        rows = self._query("SELECT id,name,description FROM apps WHERE id=?",
                           (app_id,))
        return App(*rows[0]) if rows else None

    def get_by_name(self, name: str) -> Optional[App]:
        rows = self._query("SELECT id,name,description FROM apps WHERE name=?",
                           (name,))
        return App(*rows[0]) if rows else None

    def get_all(self) -> List[App]:
        return [App(*r) for r in
                self._query("SELECT id,name,description FROM apps ORDER BY id")]

    def update(self, app: App) -> None:
        self._exec("UPDATE apps SET name=?, description=? WHERE id=?",
                   (app.name, app.description, app.id))

    def delete(self, app_id: int) -> None:
        self._exec("DELETE FROM apps WHERE id=?", (app_id,))


class SQLiteAccessKeys(_SQLiteMeta, AccessKeysDAO):
    def insert(self, access_key: AccessKey) -> Optional[str]:
        key = access_key.key or self.generate_key()
        try:
            self._exec("INSERT INTO access_keys VALUES (?,?,?)",
                       (key, access_key.app_id,
                        json.dumps(list(access_key.events))))
            return key
        except sqlite3.IntegrityError:
            return None

    def get(self, key: str) -> Optional[AccessKey]:
        rows = self._query("SELECT * FROM access_keys WHERE key=?", (key,))
        if not rows:
            return None
        k, app_id, events = rows[0]
        return AccessKey(k, app_id, tuple(json.loads(events or "[]")))

    def get_all(self) -> List[AccessKey]:
        return [AccessKey(k, a, tuple(json.loads(ev or "[]")))
                for k, a, ev in self._query("SELECT * FROM access_keys")]

    def get_by_app_id(self, app_id: int) -> List[AccessKey]:
        return [AccessKey(k, a, tuple(json.loads(ev or "[]")))
                for k, a, ev in self._query(
                    "SELECT * FROM access_keys WHERE app_id=?", (app_id,))]

    def update(self, access_key: AccessKey) -> None:
        self._exec("UPDATE access_keys SET app_id=?, events=? WHERE key=?",
                   (access_key.app_id, json.dumps(list(access_key.events)),
                    access_key.key))

    def delete(self, key: str) -> None:
        self._exec("DELETE FROM access_keys WHERE key=?", (key,))


class SQLiteChannels(_SQLiteMeta, ChannelsDAO):
    def insert(self, channel: Channel) -> Optional[int]:
        if not Channel.is_valid_name(channel.name):
            return None
        cur = self._exec("INSERT INTO channels (name, app_id) VALUES (?,?)",
                         (channel.name, channel.app_id))
        return cur.lastrowid

    def get(self, channel_id: int) -> Optional[Channel]:
        rows = self._query("SELECT id,name,app_id FROM channels WHERE id=?",
                           (channel_id,))
        return Channel(*rows[0]) if rows else None

    def get_by_app_id(self, app_id: int) -> List[Channel]:
        return [Channel(*r) for r in self._query(
            "SELECT id,name,app_id FROM channels WHERE app_id=?", (app_id,))]

    def delete(self, channel_id: int) -> None:
        self._exec("DELETE FROM channels WHERE id=?", (channel_id,))


_EI_COLS = ("id,status,start_time,end_time,engine_id,engine_version,"
            "engine_variant,engine_factory,batch,env,spark_conf,"
            "data_source_params,preparator_params,algorithms_params,"
            "serving_params")


def _ei_from_row(r) -> EngineInstance:
    return EngineInstance(
        id=str(r[0]), status=r[1], start_time=from_millis(r[2]),
        end_time=from_millis(r[3]), engine_id=r[4], engine_version=r[5],
        engine_variant=r[6], engine_factory=r[7], batch=r[8],
        env=json.loads(r[9] or "{}"), spark_conf=json.loads(r[10] or "{}"),
        data_source_params=r[11], preparator_params=r[12],
        algorithms_params=r[13], serving_params=r[14])


class SQLiteEngineInstances(_SQLiteMeta, EngineInstancesDAO):
    def insert(self, i: EngineInstance) -> str:
        iid = i.id or new_event_id()
        self._exec(
            f"INSERT INTO engine_instances ({_EI_COLS}) "
            "VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
            (iid, i.status, to_millis(i.start_time), to_millis(i.end_time),
             i.engine_id, i.engine_version, i.engine_variant,
             i.engine_factory, i.batch, json.dumps(i.env),
             json.dumps(i.spark_conf), i.data_source_params,
             i.preparator_params, i.algorithms_params, i.serving_params))
        return iid

    def get(self, instance_id: str) -> Optional[EngineInstance]:
        rows = self._query(
            f"SELECT {_EI_COLS} FROM engine_instances WHERE id=?",
            (instance_id,))
        return _ei_from_row(rows[0]) if rows else None

    def get_all(self) -> List[EngineInstance]:
        return [_ei_from_row(r) for r in
                self._query(f"SELECT {_EI_COLS} FROM engine_instances")]

    def get_completed(self, engine_id, engine_version, engine_variant):
        rows = self._query(
            f"SELECT {_EI_COLS} FROM engine_instances WHERE status=? AND "
            "engine_id=? AND engine_version=? AND engine_variant=? "
            "ORDER BY start_time DESC",
            (STATUS_COMPLETED, engine_id, engine_version, engine_variant))
        return [_ei_from_row(r) for r in rows]

    def update(self, i: EngineInstance) -> None:
        self._exec(
            "UPDATE engine_instances SET status=?, start_time=?, end_time=?, "
            "engine_id=?, engine_version=?, engine_variant=?, "
            "engine_factory=?, batch=?, env=?, spark_conf=?, "
            "data_source_params=?, preparator_params=?, algorithms_params=?, "
            "serving_params=? WHERE id=?",
            (i.status, to_millis(i.start_time), to_millis(i.end_time),
             i.engine_id, i.engine_version, i.engine_variant,
             i.engine_factory, i.batch, json.dumps(i.env),
             json.dumps(i.spark_conf), i.data_source_params,
             i.preparator_params, i.algorithms_params, i.serving_params,
             i.id))

    def delete(self, instance_id: str) -> None:
        self._exec("DELETE FROM engine_instances WHERE id=?", (instance_id,))


_EV_COLS = ("id,status,start_time,end_time,evaluation_class,"
            "engine_params_generator_class,batch,env,spark_conf,"
            "evaluator_results,evaluator_results_html,evaluator_results_json")


def _ev_from_row(r) -> EvaluationInstance:
    return EvaluationInstance(
        id=str(r[0]), status=r[1], start_time=from_millis(r[2]),
        end_time=from_millis(r[3]), evaluation_class=r[4],
        engine_params_generator_class=r[5], batch=r[6],
        env=json.loads(r[7] or "{}"), spark_conf=json.loads(r[8] or "{}"),
        evaluator_results=r[9], evaluator_results_html=r[10],
        evaluator_results_json=r[11])


class SQLiteEvaluationInstances(_SQLiteMeta, EvaluationInstancesDAO):
    def insert(self, i: EvaluationInstance) -> str:
        iid = i.id or new_event_id()
        self._exec(
            f"INSERT INTO evaluation_instances ({_EV_COLS}) "
            "VALUES (?,?,?,?,?,?,?,?,?,?,?,?)",
            (iid, i.status, to_millis(i.start_time), to_millis(i.end_time),
             i.evaluation_class, i.engine_params_generator_class, i.batch,
             json.dumps(i.env), json.dumps(i.spark_conf),
             i.evaluator_results, i.evaluator_results_html,
             i.evaluator_results_json))
        return iid

    def get(self, instance_id: str) -> Optional[EvaluationInstance]:
        rows = self._query(
            f"SELECT {_EV_COLS} FROM evaluation_instances WHERE id=?",
            (instance_id,))
        return _ev_from_row(rows[0]) if rows else None

    def get_all(self) -> List[EvaluationInstance]:
        return [_ev_from_row(r) for r in
                self._query(f"SELECT {_EV_COLS} FROM evaluation_instances")]

    def get_completed(self) -> List[EvaluationInstance]:
        rows = self._query(
            f"SELECT {_EV_COLS} FROM evaluation_instances WHERE status=? "
            "ORDER BY start_time DESC", (STATUS_EVALCOMPLETED,))
        return [_ev_from_row(r) for r in rows]

    def update(self, i: EvaluationInstance) -> None:
        self._exec(
            "UPDATE evaluation_instances SET status=?, start_time=?, "
            "end_time=?, evaluation_class=?, engine_params_generator_class=?, "
            "batch=?, env=?, spark_conf=?, evaluator_results=?, "
            "evaluator_results_html=?, evaluator_results_json=? WHERE id=?",
            (i.status, to_millis(i.start_time), to_millis(i.end_time),
             i.evaluation_class, i.engine_params_generator_class, i.batch,
             json.dumps(i.env), json.dumps(i.spark_conf),
             i.evaluator_results, i.evaluator_results_html,
             i.evaluator_results_json, i.id))

    def delete(self, instance_id: str) -> None:
        self._exec("DELETE FROM evaluation_instances WHERE id=?",
                   (instance_id,))


class SQLiteModels(_SQLiteMeta, ModelsDAO):
    def insert(self, model: Model) -> None:
        self._exec("INSERT OR REPLACE INTO models VALUES (?,?)",
                   (model.id, model.models))

    def get(self, model_id: str) -> Optional[Model]:
        rows = self._query("SELECT id, models FROM models WHERE id=?",
                           (model_id,))
        return Model(rows[0][0], bytes(rows[0][1])) if rows else None

    def delete(self, model_id: str) -> None:
        self._exec("DELETE FROM models WHERE id=?", (model_id,))
