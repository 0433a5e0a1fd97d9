"""SEGMENTFS storage backend: content-addressed immutable segments and a
manifest, laid out for shared filesystems (NFS, Lustre, bucket mounts)
where the hosts of a pod read one event log at once (the port's own copy
of ``predictionio_tpu/data/storage/segmentfs.py``, whose directory
format it keeps: either package reads what the other wrote).

- Segments are immutable and content-addressed (the name carries a
  sha256 of the bytes): once published they never change, so any number
  of hosts read them without a lock and a per-process parse cache needs
  no invalidation.
- The manifest is the only mutable object: an ordered list of segment
  names, replaced atomically under an OS ``flock``. Readers never lock.
- Deletes append tombstone segments; when tombstones outnumber live
  events, writers compact into one segment. Replaced segments are
  removed by :meth:`SegmentFSEventStore.gc` only after a grace period, so
  a reader holding the previous manifest still finds its files.
- ``import_jsonl`` runs through the native codec's one-pass bulk lane
  (:mod:`predictionio_tpu_torch.native`); a block the codec declines
  takes the Python lane, and the lane of every block is counted.
- The training read (``find_columnar``) is a columnar sidecar on the
  shared mount (``<log>/columnar/``): one host pays the encode and the
  others map its ``.npy`` segments read-only. Its id-hash columns record
  their ``hash_impl``; the port's is blake2b and the JAX package's is
  pandas' where pandas is installed, so a sidecar the other package
  hashed is rebuilt (loudly), never dup-checked against hashes that
  cannot match.

Metadata DAOs are the LOCALFS documents under the same cross-process
lock; model blobs are plain files. ``flock`` across hosts needs a mount
with POSIX locks (NFSv4 has them; most bucket mounts do not): without
them, run one writer a (app, channel). Readers are always safe. A
``find_columnar(shard=(i, n))`` read slices the mapped sidecar by row
range, so each host's shard touches only its own segment pages.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import logging
import os
import threading
import time
import uuid
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ... import native
from ..columnar import (
    ColumnarBatch,
    SegmentLog,
    bulk_hash64,
    bulk_iso_to_millis,
    bulk_to_float64,
    columnar_from_columns,
    columnar_from_events,
    hash_impl,
)
from ..event import Event, isoformat_millis, utcnow
from . import localfs
from .base import (
    EventFilter,
    EventStore,
    JsonlImportError,
    _open_jsonl,
    iter_jsonl_blocks,
    keep_required,
)
from .localfs import _flock, atomic_write

log_ = logging.getLogger(__name__)

#: compact when tombstoned/overwritten records outnumber live events
_COMPACT_RATIO = 1.0
#: watermark sentinel committed by intermediate rebuild chunks — can
#: never equal a jsonl segment name, so a crash mid-rebuild reads as
#: "history changed → invalidate + re-encode", never as complete
_REBUILD_WM = "__rebuild-incomplete__"
#: seconds an unreferenced segment survives before gc (reader grace)
_GC_GRACE_S = 300.0


class SegmentFSClient(localfs.LocalFSClient):
    """Root-directory handle + cross-process document locking.

    Extends the LOCALFS client with (a) a per-process cache of PARSED
    immutable segments and (b) a sequence allocator that holds the OS
    lock across its read-modify-write (LOCALFS only held the in-process
    lock — fine for one process, lost updates across many).
    """

    def __init__(self, path: str):
        super().__init__(path)
        os.makedirs(os.path.join(path, "events"), exist_ok=True)
        #: abs segment path → parsed records; immutable ⇒ never invalidated
        self.segment_cache: Dict[str, List[dict]] = {}
        #: log dir → (manifest segment tuple, live events, dead count) —
        #: the manifest version fully determines the replay result, so a
        #: serving-path get() must not rebuild 1M Event objects per call
        self.replay_cache: Dict[str, tuple] = {}
        self._seg_lock = threading.Lock()

    @staticmethod
    def from_config(cfg: dict) -> "SegmentFSClient":
        path = cfg.get("PATH") or cfg.get("path")
        if not path:
            raise ValueError("SEGMENTFS source needs a PATH property "
                             "(PIO_STORAGE_SOURCES_<NAME>_PATH)")
        return SegmentFSClient(path)

    def next_seq(self, name: str) -> int:
        with self.lock, _flock(self.doc_path(f"{name}_seq")):
            n = int(self.read_doc(f"{name}_seq", 0)) + 1
            self.write_doc(f"{name}_seq", n)
            return n

    def parsed_segment(self, path: str,
                       deadline: Optional[float] = None) -> List[dict]:
        with self._seg_lock:
            recs = self.segment_cache.get(path)
        if recs is not None:
            return recs
        recs = []
        with open(path, "r", encoding="utf-8") as f:
            for ln, line in enumerate(f):
                # a compacted log is ONE big segment: the serving-path
                # deadline must bound the parse itself, not just the
                # replay loop over already-parsed records
                if deadline is not None and ln % 4096 == 0 \
                        and time.monotonic() > deadline:
                    raise TimeoutError(
                        "segment parse exceeded its deadline")
                if line.strip():
                    recs.append(json.loads(line))
        with self._seg_lock:
            self.segment_cache[path] = recs
        return recs


def _log_dir(app_id: int, channel_id: Optional[int]) -> str:
    return f"app_{app_id}" if channel_id is None \
        else f"app_{app_id}_c{channel_id}"


class SegmentFSEventStore(EventStore):
    def __init__(self, client: SegmentFSClient):
        self.c = client

    # -- layout ------------------------------------------------------------
    def _dir(self, app_id: int, channel_id: Optional[int]) -> str:
        return os.path.join(self.c.root, "events",
                            _log_dir(app_id, channel_id))

    def _manifest_path(self, d: str) -> str:
        return os.path.join(d, "manifest.json")

    def _read_manifest(self, d: str) -> List[str]:
        try:
            with open(self._manifest_path(d), "r", encoding="utf-8") as f:
                return json.load(f)["segments"]
        except FileNotFoundError:
            return []

    def _write_manifest(self, d: str, segments: List[str]) -> None:
        atomic_write(self._manifest_path(d),
                     json.dumps({"segments": segments,
                                 "updated": time.time()}))

    def _write_segment(self, d: str, records: List[dict]) -> str:
        payload = "".join(json.dumps(r) + "\n" for r in records)
        return self._write_segment_bytes(d, payload.encode("utf-8"),
                                         len(records))

    def _write_segment_bytes(self, d: str, data: bytes, n: int) -> str:
        digest = hashlib.sha256(data).hexdigest()[:20]
        name = f"seg-{n}-{digest}.jsonl"
        path = os.path.join(d, name)
        if not os.path.exists(path):  # content-addressed: idempotent
            atomic_write(path, data)
        return name

    def _publish(self, d: str, records: List[dict]) -> None:
        payload = "".join(json.dumps(r) + "\n" for r in records)
        self._publish_payload(d, payload.encode("utf-8"), len(records))

    def _publish_payload(self, d: str, payload: bytes, n: int) -> None:
        """Write one immutable segment and link it into the manifest, both
        under the cross-process lock — writing inside the critical section
        closes the window where :meth:`gc` (which takes the same lock)
        could collect a written-but-not-yet-linked segment. A crash before
        the manifest write leaves an unreferenced file for gc, never a
        torn log."""
        with _flock(self._manifest_path(d)):
            name = self._write_segment_bytes(d, payload, n)
            segments = self._read_manifest(d)
            if name not in segments:
                self._write_manifest(d, segments + [name])

    # -- EventStore contract ----------------------------------------------
    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        d = self._dir(app_id, channel_id)
        os.makedirs(d, exist_ok=True)
        if not os.path.exists(self._manifest_path(d)):
            with _flock(self._manifest_path(d)):
                if not os.path.exists(self._manifest_path(d)):
                    self._write_manifest(d, [])
        return True

    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        d = self._dir(app_id, channel_id)
        if not os.path.isdir(d):
            return False
        # the lock sidecar (and the directory) must survive: unlinking a
        # lockfile lets a process blocked on the old inode and one that
        # re-creates it each hold an "exclusive" flock simultaneously
        # (same invariant as localfs.remove)
        with _flock(self._manifest_path(d)):
            for name in os.listdir(d):
                if name.startswith("seg-") or name == "manifest.json":
                    p = os.path.join(d, name)
                    with self.c._seg_lock:
                        self.c.segment_cache.pop(p, None)
                    if os.path.isfile(p):
                        os.unlink(p)
            cdir = self._columnar_dir(d)
            if os.path.isdir(cdir):
                log = SegmentLog(cdir)
                with log.lock():
                    # same reader grace as rebuilds: another pod host may
                    # still mmap these segments (NFS gives no
                    # unlink-keeps-inode guarantee)
                    log.invalidate(grace_s=_GC_GRACE_S)
                    log.sweep(_GC_GRACE_S)
        with self.c._seg_lock:
            self.c.replay_cache.pop(d, None)
            for wp in (False, True):
                self.c.replay_cache.pop(("columnar", d, wp), None)
        return True

    def close(self) -> None:
        pass

    def insert(self, event: Event, app_id: int,
               channel_id: Optional[int] = None) -> str:
        return self.insert_batch([event], app_id, channel_id)[0]

    def insert_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: Optional[int] = None) -> List[str]:
        if not events:
            return []
        d = self._dir(app_id, channel_id)
        os.makedirs(d, exist_ok=True)
        records, ids = [], []
        for e in events:
            eid = e.event_id or uuid.uuid4().hex
            records.append({"op": "put", "event": e.copy(event_id=eid).to_json()})
            ids.append(eid)
        self._publish(d, records)
        return ids

    def import_jsonl(self, source, app_id: int,
                     channel_id: Optional[int] = None,
                     chunk: int = 100_000) -> int:
        """Bulk import through the native codec's one-pass lane (parse,
        validate, normalize and encode in C++): the commit unit is a
        block of whole lines (``PIO_IMPORT_BLOCK``, 32 MB) published as
        one segment. A block the strict lane declines (unusual ISO forms,
        non-string optional fields, a validation failure that must raise
        the canonical message) runs through the Python lane, in order and
        with the same errors. One difference, the JAX package's too: the
        native lane stamps one ``utcnow()`` a block as the default event
        and creation time of events without one, the Python lane one an
        event. Without the codec the whole import is the base class's
        Python lane. :func:`predictionio_tpu_torch.native.lane_counts`
        counts the blocks of each lane under ``import_jsonl``."""
        mod = native.codec()
        if mod is None or not hasattr(mod, "import_jsonl"):
            native.count_lane("import_jsonl", "python")
            return super().import_jsonl(source, app_id, channel_id,
                                        chunk)

        d = self._dir(app_id, channel_id)
        os.makedirs(d, exist_ok=True)
        block_size = int(os.environ.get("PIO_IMPORT_BLOCK",
                                        str(32 << 20)))
        total = 0
        lineno = 0  # lines fully consumed (== committed: block commits)
        f = _open_jsonl(source)  # missing file: clean OSError
        try:
            with f:
                for buf, nlines in iter_jsonl_blocks(f, block_size):
                    payload, n, _bad = mod.import_jsonl(
                        buf, os.urandom(16 * nlines),
                        isoformat_millis(utcnow()))
                    if payload is None:
                        native.count_lane("import_jsonl", "python")
                        n = self._import_block_py(buf, lineno, total,
                                                  app_id, channel_id,
                                                  chunk)
                    else:
                        native.count_lane("import_jsonl", "native")
                        if n:
                            self._publish_payload(d, payload, n)
                    total += n
                    lineno += nlines
        except JsonlImportError:
            raise
        except Exception as e:  # noqa: BLE001 — e.g. ENOSPC mid-import:
            # the durable prefix (every fully-consumed block) must be
            # reported, or a re-run after freeing space duplicates it
            raise JsonlImportError(lineno, lineno, total, e) from e
        return total

    def _import_block_py(self, buf: bytes, lines_before: int,
                         events_before: int, app_id: int,
                         channel_id: Optional[int],
                         chunk: int) -> int:
        """The Python lane for one block the codec declined. Unlike the
        native lane (whose commit unit is the whole block), it keeps at
        most ``chunk`` events alive, each batch committed all or nothing,
        and a failure reports exactly the committed prefix."""
        events: List[Event] = []
        rel = 0            # lines consumed within this block
        committed_rel = 0  # lines fully committed within this block
        total_rel = 0
        # split on \n only: splitlines() also cuts on a lone \r, \x0b,
        # \x1c..., which would import one line as two events and shift
        # the line numbers a resume counts by
        pieces = buf.split(b"\n")
        if pieces and pieces[-1] == b"":
            pieces.pop()  # trailing newline, not a blank line
        try:
            for raw in pieces:
                rel += 1
                s = raw.decode("utf-8").strip()
                if s:
                    events.append(Event.from_json(json.loads(s)))
                if len(events) >= chunk:
                    self.insert_batch(events, app_id, channel_id)
                    total_rel += len(events)
                    committed_rel = rel
                    events = []
            if events:
                self.insert_batch(events, app_id, channel_id)
                total_rel += len(events)
        except Exception as e:  # noqa: BLE001 — durable-progress report
            raise JsonlImportError(lines_before + rel,
                                   lines_before + committed_rel,
                                   events_before + total_rel, e) from e
        return total_rel

    def _replay(self, app_id: int, channel_id: Optional[int],
                deadline: Optional[float] = None,
                segments: Optional[Sequence[str]] = None
                ) -> Tuple[Dict[str, Event], int]:
        """live events (insertion-ordered) + dead-record count, from the
        current manifest's immutable segments — or from an explicitly
        pinned ``segments`` list (the columnar rebuild must replay
        exactly the manifest version its watermark records, not a fresh
        read that may have advanced). Cached per segment tuple (which
        fully determines the result); ``deadline`` bounds a cold replay
        on the serving path (``EventFilter.deadline`` contract,
        ``base.py``)."""
        d = self._dir(app_id, channel_id)
        segments = tuple(self._read_manifest(d)) if segments is None \
            else tuple(segments)
        with self.c._seg_lock:
            cached = self.c.replay_cache.get(d)
        if cached is not None and cached[0] == segments:
            return cached[1], cached[2]
        live: Dict[str, Event] = {}
        dead = 0
        n = 0
        for name in segments:
            for r in self.c.parsed_segment(os.path.join(d, name),
                                           deadline=deadline):
                n += 1
                if deadline is not None and n % 4096 == 0 \
                        and time.monotonic() > deadline:
                    raise TimeoutError(
                        "segment replay exceeded its deadline")
                if r["op"] == "put":
                    e = Event.from_json(r["event"])
                    if e.event_id in live:
                        dead += 1
                    live[e.event_id] = e
                elif r["op"] == "del":
                    if live.pop(r["id"], None) is not None:
                        dead += 1
                    dead += 1
        with self.c._seg_lock:
            self.c.replay_cache[d] = (segments, live, dead)
        return live, dead

    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]:
        live, _ = self._replay(app_id, channel_id)
        return live.get(event_id)

    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool:
        live, dead = self._replay(app_id, channel_id)
        if event_id not in live:
            return False
        d = self._dir(app_id, channel_id)
        self._publish(d, [{"op": "del", "id": event_id}])
        if dead + 2 > _COMPACT_RATIO * len(live):
            self._compact(app_id, channel_id)
        return True

    def _compact(self, app_id: int, channel_id: Optional[int]) -> None:
        """Merge the log into one segment. Old segments stay on disk for
        a grace period (readers holding the previous manifest), then
        :meth:`gc` removes them."""
        d = self._dir(app_id, channel_id)
        with _flock(self._manifest_path(d)):
            old = self._read_manifest(d)
            live, dead = self._replay(app_id, channel_id)
            if dead == 0:
                return
            records = [{"op": "put", "event": e.to_json()}
                       for e in live.values()]
            name = self._write_segment(d, records) if records else None
            self._write_manifest(d, [name] if name else [])
            # restart the gc grace clock from the moment a segment became
            # UNREFERENCED (not from its creation): a reader holding the
            # pre-compaction manifest must keep finding these files
            now = time.time()
            for n in old:
                if n != name:
                    try:
                        os.utime(os.path.join(d, n), (now, now))
                    except OSError:
                        pass

    def gc(self, app_id: int, channel_id: Optional[int] = None,
           grace_s: float = _GC_GRACE_S) -> int:
        """Delete unreferenced segment files older than ``grace_s``.

        Holds the manifest lock: publishing writes the segment and links
        it under the same lock, so gc can never collect a file between
        its write and its manifest entry (and the referenced-set it reads
        is the current one)."""
        d = self._dir(app_id, channel_id)
        if not os.path.isdir(d):
            return 0
        n = 0
        now = time.time()
        with _flock(self._manifest_path(d)):
            referenced = set(self._read_manifest(d))
            for name in os.listdir(d):
                # unreferenced segments AND crashed-writer temp files
                sweepable = (name.startswith("seg-")
                             and name not in referenced) \
                    or ".tmp." in name
                if not sweepable:
                    continue
                p = os.path.join(d, name)
                try:
                    if now - os.path.getmtime(p) >= grace_s:
                        os.unlink(p)
                        with self.c._seg_lock:
                            self.c.segment_cache.pop(p, None)
                        n += 1
                except OSError:
                    pass
        return n

    # -- columnar bulk reads ---------------------------------------------
    #
    # The jsonl log is the authoritative store; a ``SegmentLog`` sidecar
    # on the shared mount (``<log>/columnar/``) holds the dictionary-
    # encoded numpy segments the SQLite backend builds, so one host pays
    # the encode and the others map the published segments. The
    # sidecar's watermark is the list of jsonl segments consumed: appends
    # encode only the delta, while deletes, replacements and compaction
    # force a rebuild (detected with a per-segment 64-bit id-hash
    # column).

    def _columnar_dir(self, d: str) -> str:
        return os.path.join(d, "columnar")

    def warm_columnar(self, app_id: int,
                      channel_id: Optional[int] = None) -> bool:
        # encode persists ALL columns; want_props=False just skips
        # loading the property bytes into this process
        self._sync_columnar(app_id, channel_id, ("rating",),
                            want_props=False)
        return True

    def find_columnar(self, app_id: int, channel_id: Optional[int] = None,
                      filter: EventFilter = EventFilter(),
                      float_props: Sequence[str] = ("rating",),
                      ordered: bool = True, with_props: bool = True,
                      shard=None):
        """The training read over the shared sidecar (built or extended
        first when the log moved past it). A sidecar of one segment comes
        back as read-only maps of its files; a shard is a row range of
        those maps."""
        batch = self._sync_columnar(app_id, channel_id,
                                    tuple(float_props),
                                    want_props=with_props)
        if shard is not None:
            return self._shard_and_select(batch, shard, filter,
                                          ordered=ordered,
                                          with_props=with_props)
        return batch.select(filter, ordered=ordered,
                            with_props=with_props)

    def aggregate_properties(self, app_id: int,
                             channel_id: Optional[int] = None, *,
                             entity_type: str, start_time=None,
                             until_time=None, required=None):
        from ..aggregation import AGGREGATION_EVENTS, aggregate_from_columnar

        batch = self._sync_columnar(app_id, channel_id, ("rating",),
                                    want_props=True)
        sub = batch.select(EventFilter(
            entity_type=entity_type, start_time=start_time,
            until_time=until_time,
            event_names=list(AGGREGATION_EVENTS)), ordered=False)
        return keep_required(aggregate_from_columnar(sub), required)

    def _sync_columnar(self, app_id: int, channel_id: Optional[int],
                       float_props: tuple, want_props: bool = True):
        """``want_props=False`` (the training read) skips loading the
        property-byte columns, a large part of a cold read on a shared
        mount that no trainer touches."""
        d = self._dir(app_id, channel_id)
        src = tuple(self._read_manifest(d))
        ck = ("columnar", d, bool(want_props))
        with self.c._seg_lock:
            cached = self.c.replay_cache.get(ck)
        if cached is not None and cached[0] == src:
            return cached[1]
        if not src:
            return ColumnarBatch.empty(float_props=float_props)
        log = SegmentLog(self._columnar_dir(d))
        with log.lock():
            # re-read the jsonl manifest INSIDE the sidecar lock: another
            # host may have appended (and synced the sidecar) since the
            # lock-free read above — a stale view must not be mistaken
            # for changed history
            src = tuple(self._read_manifest(d))
            man = log.read_manifest()
            if log.format_stale(man):
                # an older encoded format: rebuild from the source log
                log.invalidate(grace_s=_GC_GRACE_S)
                man = None
            if man is not None and man.get("hash_impl") != hash_impl():
                # the writer's bulk_hash64 differs from ours (pandas'
                # siphash vs blake2b): its id_hash columns can never
                # match, so the crash-replay dup check would fail open
                # and append duplicate rows; rebuild instead. Loud: hosts
                # of mixed stacks on one mount rebuild on every switch
                log_.warning(
                    "segmentfs sidecar %s was hashed with %r but this "
                    "host uses %r: rebuilding; hosts of mixed stacks on "
                    "one mount rebuild it at every switch",
                    self._columnar_dir(d),
                    (man or {}).get("hash_impl"), hash_impl())
                log.invalidate(grace_s=_GC_GRACE_S)
                man = None
            done: tuple = tuple((man or {}).get("watermark") or ())
            if man is not None and done != src[:len(done)]:
                if done[:len(src)] == src:
                    # the sidecar is AHEAD of this host's (attribute-
                    # cache-lagged) manifest view: it reflects a newer
                    # log version, which an append-only reader may use —
                    # never destroy the shared encode for being fresh
                    src = done
                else:
                    # compaction / manifest rewrite: history changed
                    log.invalidate(grace_s=_GC_GRACE_S)
                    man, done = None, ()
            delta = src[len(done):]
            if delta:
                self._encode_columnar_delta(log, d, src, done, delta,
                                            float_props, app_id,
                                            channel_id)
            batch, _ = log.load(with_props=want_props)
            if batch is None:
                batch = ColumnarBatch.empty(float_props=float_props)
            log.sweep(_GC_GRACE_S)
        with self.c._seg_lock:
            self.c.replay_cache[ck] = (src, batch)
        return batch

    def _stored_id_hashes(self, log) -> Optional[np.ndarray]:
        """Concatenated per-segment id-hash columns (uint64), or None if
        any segment is missing its hash file (crash window → rebuild)."""
        man = log.read_manifest()
        if man is None:
            return np.empty(0, np.uint64)
        parts = []
        for seg in man["segments"]:
            p = os.path.join(log.path, seg["name"], "id_hash.npy")
            if not os.path.exists(p):
                return None
            parts.append(np.load(p, mmap_mode="r", allow_pickle=False))
        return np.concatenate(parts) if parts else np.empty(0, np.uint64)

    #: delta records per sidecar segment append (bounds host memory —
    #: a compacted jsonl log can be ONE multi-million-line segment)
    COLUMNAR_CHUNK = 500_000
    #: bytes per native-codec parse call (plus the current line's tail)
    CODEC_BLOCK = 64 << 20

    @staticmethod
    def _iter_records(path: str) -> Iterator[dict]:
        """Stream-parse a jsonl segment WITHOUT the replay cache: the
        encode touches each segment once, and caching would pin the
        whole parsed log as Python dicts for the process lifetime."""
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                if line.strip():
                    yield json.loads(line)

    #: encode-chunk column names (parallel lists)
    _CCOLS = ("event", "entity_type", "entity_id", "target_type",
              "target_id", "time_iso", "event_id", "props_raw")

    def _iter_segment_columns(self, path: str, float_props: tuple):
        """Yield column-dict blocks for one jsonl segment: the native codec
        when it is built, else the Python lane, with the same output;
        each block's lane is counted under ``parse_segment``. Yields
        ``None`` (then stops) on the first non-"put" record: the caller
        rebuilds (deletes falsify an incremental encode)."""
        m = native.codec()
        if m is not None:
            yielded = False
            try:
                with open(path, "rb") as f:
                    while True:
                        data = f.read(self.CODEC_BLOCK)
                        if not data:
                            return
                        tail = f.readline()  # finish the cut line
                        if tail:
                            data += tail
                        out = m.parse_segment(data, tuple(float_props))
                        if out is None:
                            yield None
                            return
                        ev, et, ei, tt, ti, times, ids, praw, fps = out
                        if not ev:
                            continue  # blank-only block
                        native.count_lane("parse_segment", "native")
                        yielded = True
                        yield {"event": ev, "entity_type": et,
                               "entity_id": ei, "target_type": tt,
                               "target_id": ti, "time_iso": times,
                               "event_id": ids, "props_raw": praw,
                               "fprops": fps}
                return
            except (ValueError, UnicodeDecodeError):
                # content the strict tokenizer refuses (a lone surrogate
                # escape, which Python's json round-trips). Only a clean
                # restart may redo the segment on the Python lane: if
                # blocks already went downstream, a re-read would
                # duplicate them, so signal a rebuild instead
                if yielded:
                    yield None
                    return

        def fresh():
            c = {k: [] for k in self._CCOLS}
            c["fprops"] = [[] for _ in float_props]
            return c

        def finish(c):
            # one numbers-only gate for both lanes (the codec applies the
            # same gate in C++)
            c["fprops"] = [bulk_to_float64(raw).tolist()
                           for raw in c["fprops"]]
            native.count_lane("parse_segment", "python")
            return c

        cols = fresh()
        n = 0
        for r in self._iter_records(path):
            if r["op"] != "put":
                yield None
                return
            e = r["event"]
            props = e.get("properties")
            cols["event"].append(e["event"])
            cols["entity_type"].append(e["entityType"])
            cols["entity_id"].append(e["entityId"])
            cols["target_type"].append(e.get("targetEntityType"))
            cols["target_id"].append(e.get("targetEntityId"))
            cols["time_iso"].append(e["eventTime"])
            cols["event_id"].append(e.get("eventId") or "")
            cols["props_raw"].append(
                json.dumps(props).encode("utf-8") if props else None)
            for w, nm in enumerate(float_props):
                cols["fprops"][w].append((props or {}).get(nm))
            n += 1
            if n >= self.COLUMNAR_CHUNK:
                yield finish(cols)
                cols = fresh()
                n = 0
        if n:
            yield finish(cols)

    def _encode_columnar_delta(self, log, d: str, src: tuple, done: tuple,
                               delta: tuple, float_props: tuple,
                               app_id: int,
                               channel_id: Optional[int]) -> None:
        def rebuild() -> None:
            # deletes/replacements: rebuild the projection of LIVE
            # events, replaying EXACTLY the src manifest version the
            # watermark will record (a fresh manifest read could have
            # advanced past it). Retired segments keep the reader grace.
            live, _ = self._replay(app_id, channel_id, segments=src)
            log.invalidate(grace_s=_GC_GRACE_S)
            if not live:
                log.append(ColumnarBatch.empty(float_props=float_props),
                           watermark=list(src), prev_dict_counts={},
                           hash_impl=hash_impl())
                self._write_id_hashes(log, np.empty(0, np.uint64))
                return
            events = list(live.values())
            ids = np.asarray(list(live.keys()), dtype=object)
            prev_counts: dict = {}
            for s in range(0, len(events), self.COLUMNAR_CHUNK):
                dicts, prev_counts = log.dicts_and_counts()
                batch = columnar_from_events(
                    events[s:s + self.COLUMNAR_CHUNK], dicts=dicts,
                    float_props=float_props)
                # only the FINAL chunk's manifest commit may claim the
                # src watermark: a crash between chunk appends must
                # leave a sidecar the next reader detects as stale
                # (sentinel ⇒ invalidate+rebuild), not serve a
                # truncated batch as the complete training read
                final = s + self.COLUMNAR_CHUNK >= len(events)
                log.append(batch,
                           watermark=list(src) if final
                           else [_REBUILD_WM],
                           prev_dict_counts=prev_counts,
                           hash_impl=hash_impl())
                self._write_id_hashes(
                    log, bulk_hash64(ids[s:s + self.COLUMNAR_CHUNK]))

        stored = self._stored_id_hashes(log)
        if stored is None:
            rebuild()  # hash-file crash window: can't dup-check
            return
        stored = np.asarray(stored)
        consumed = list(done)
        chunk: Optional[dict] = None

        def extend(acc, cols):
            if acc is None:
                return cols
            for k in self._CCOLS:
                acc[k].extend(cols[k])
            for w in range(len(acc["fprops"])):
                acc["fprops"][w].extend(cols["fprops"][w])
            return acc

        def flush(chunk, consumed_after) -> bool:
            """Encode one chunk; False → dup detected, caller rebuilds."""
            nonlocal stored
            new_h = bulk_hash64(
                np.asarray(chunk["event_id"], dtype=object))
            if len(np.unique(new_h)) != len(new_h) \
                    or (len(stored) and np.isin(new_h, stored).any()):
                return False
            self._append_put_chunk(log, chunk, consumed_after,
                                   float_props, new_h)
            stored = np.concatenate([stored, new_h])
            return True

        def split(c, n):
            """First n rows of a column chunk, and the remainder."""
            head = {k: c[k][:n] for k in self._CCOLS}
            head["fprops"] = [f[:n] for f in c["fprops"]]
            rest = {k: c[k][n:] for k in self._CCOLS}
            rest["fprops"] = [f[n:] for f in c["fprops"]]
            return head, (rest if rest["event"] else None)

        for name in delta:
            for cols in self._iter_segment_columns(
                    os.path.join(d, name), float_props):
                if cols is None:
                    rebuild()
                    return
                chunk = extend(chunk, cols)
                while chunk is not None \
                        and len(chunk["event"]) >= self.COLUMNAR_CHUNK:
                    # mid-segment flush in CHUNK-row slices (a codec
                    # block can carry several chunks' worth): watermark
                    # only advances at segment boundaries (crash ⇒
                    # re-encode of this segment is caught by the dup
                    # check → rebuild)
                    head, chunk = split(chunk, self.COLUMNAR_CHUNK)
                    if not flush(head, consumed):
                        rebuild()
                        return
            consumed.append(name)
            if chunk is not None \
                    and len(chunk["event"]) >= self.COLUMNAR_CHUNK // 2:
                if not flush(chunk, consumed):
                    rebuild()
                    return
                chunk = None
        if chunk is not None and chunk["event"]:
            if not flush(chunk, consumed):
                rebuild()
                return
        elif consumed != list(done):
            man = log.read_manifest()
            if man is not None:
                man["watermark"] = consumed
                log._write_manifest(man)

    def _append_put_chunk(self, log, cols: dict, consumed: list,
                          float_props: tuple, new_h) -> None:
        """Commit one column chunk (``_CCOLS`` and a float list a
        property, NaN where missing: both lanes apply the numbers-only
        gate first) as a sidecar segment."""
        dicts, prev_counts = log.dicts_and_counts()
        times = bulk_iso_to_millis(cols["time_iso"])
        fpv = {nm: np.asarray(cols["fprops"][w], dtype=np.float64)
               for w, nm in enumerate(float_props)}
        batch = columnar_from_columns(
            dicts, cols["event"], cols["entity_type"],
            cols["entity_id"], cols["target_type"], cols["target_id"],
            np.asarray(times, dtype=np.int64), cols["props_raw"],
            float_props=float_props, float_prop_values=fpv)
        log.append(batch, watermark=list(consumed),
                   prev_dict_counts=prev_counts,
                   hash_impl=hash_impl())
        self._write_id_hashes(log, new_h)

    def _write_id_hashes(self, log, hashes) -> None:
        """Persist the id-hash column beside the newest segment (written
        after the manifest commit; a crash in between leaves a missing
        hash file, which the dup check treats as 'rebuild')."""
        man = log.read_manifest()
        seg = man["segments"][-1]["name"]
        np.save(os.path.join(log.path, seg, "id_hash.npy"),
                np.asarray(hashes, dtype=np.uint64),
                allow_pickle=False)

    def find(self, app_id: int, channel_id: Optional[int] = None,
             filter: EventFilter = EventFilter()) -> Iterator[Event]:
        live, _ = self._replay(app_id, channel_id,
                               deadline=filter.deadline)
        # sort by epoch millis, not raw datetimes: naive and tz-aware
        # event times must not TypeError against each other
        events = sorted(live.values(), key=lambda e: e.event_time_millis,
                        reverse=filter.reversed)
        it = filter.apply(events)
        if filter.limit is not None and filter.limit >= 0:
            it = itertools.islice(it, filter.limit)
        return it


def _locked(method_names):
    """Class decorator: wrap mutating DAO methods in the cross-process
    document lock (the LOCALFS implementations they inherit only hold
    the in-process lock — lost updates across pod hosts otherwise)."""
    def deco(cls):
        for mname in method_names:
            base = getattr(cls.__mro__[1], mname)

            def wrapper(self, *a, __base=base, **kw):
                with _flock(self.c.doc_path(self.DOC)):
                    return __base(self, *a, **kw)
            wrapper.__name__ = mname
            setattr(cls, mname, wrapper)
        return cls
    return deco


@_locked(["insert", "update", "delete"])
class SegmentFSApps(localfs.LocalFSApps):
    DOC = "apps"


@_locked(["insert", "update", "delete"])
class SegmentFSAccessKeys(localfs.LocalFSAccessKeys):
    DOC = "access_keys"


@_locked(["insert", "delete"])
class SegmentFSChannels(localfs.LocalFSChannels):
    DOC = "channels"


@_locked(["insert", "update", "delete"])
class SegmentFSEngineInstances(localfs.LocalFSEngineInstances):
    DOC = "engine_instances"


@_locked(["insert", "update", "delete"])
class SegmentFSEvaluationInstances(localfs.LocalFSEvaluationInstances):
    DOC = "evaluation_instances"


class SegmentFSModels(localfs.LocalFSModels):
    pass  # inherits the temp+rename atomic blob writes
