"""Storage contracts: the event-log DAO and the metadata DAOs (the port's
own copy of ``predictionio_tpu/data/storage/base.py``).

``EventStore`` is the event log: init/remove, all-or-nothing batch
inserts, the columnar block insert, get/delete, filtered ``find`` and the
bulk ``find_columnar`` training read. The metadata entities (``App``,
``AccessKey``, ``Channel``, ``EngineInstance``, ``EvaluationInstance``,
``Model``) and their DAOs match the JAX package's field for field, so one
SQLite file serves both.

``aggregate_properties`` replays ``$set/$unset/$delete`` into each
entity's current properties; ``EventFilter.deadline`` bounds a scan's
wall clock for serving-time point reads (every backend checks it inside
its scan loop).

:func:`iter_jsonl_blocks` cuts a JSON-lines stream into blocks of whole
lines, the unit the bulk import lanes of SEGMENTFS and REMOTE commit.

``find_columnar(shard=(i, n))`` is the partitioned training read of
several processes: shard ``i`` of the unfiltered storage order
(``ColumnarBatch.shard_bounds``), the filter applied within it, so the
union of the shards of a filtered read is the unsharded read.
"""

from __future__ import annotations

import abc
import base64
import json
import re
import time
import uuid
from dataclasses import dataclass, field, replace
from datetime import datetime
from typing import Any, Dict, Iterable, Iterator, List, Optional, \
    Sequence, Tuple

from ..datamap import PropertyMap
from ..event import Event

#: Sentinel for "no filter" on nullable fields, distinguishing "match any"
#: from "match None".
ANY: Any = ...

@dataclass(frozen=True)
class EventFilter:
    """The filter set of an event-log scan."""

    start_time: Optional[datetime] = None
    until_time: Optional[datetime] = None
    entity_type: Optional[str] = None
    entity_id: Optional[str] = None
    event_names: Optional[Sequence[str]] = None
    target_entity_type: Any = ANY  # ANY | None | str
    target_entity_id: Any = ANY
    limit: Optional[int] = None
    reversed: bool = False
    #: optional ``time.monotonic()`` deadline: backends check it inside
    #: their scan loops and raise :class:`TimeoutError`, so a serving-time
    #: read fails within its budget instead of after a heavy scan
    deadline: Optional[float] = None

    def check_deadline(self) -> None:
        if self.deadline is not None and time.monotonic() > self.deadline:
            raise TimeoutError("event scan exceeded its deadline")

    def apply(self, events: Iterable[Event]) -> Iterator[Event]:
        """Yield the matching events, checking the deadline every 4,096:
        the scan loop every in-process backend shares."""
        for i, e in enumerate(events):
            if i % 4096 == 0:
                self.check_deadline()
            if self.matches(e):
                yield e

    def matches(self, e: Event) -> bool:
        if self.start_time is not None and e.event_time < self.start_time:
            return False
        if self.until_time is not None and e.event_time >= self.until_time:
            return False
        if self.entity_type is not None and e.entity_type != self.entity_type:
            return False
        if self.entity_id is not None and e.entity_id != self.entity_id:
            return False
        if self.event_names is not None and e.event not in self.event_names:
            return False
        if self.target_entity_type is not ANY \
                and e.target_entity_type != self.target_entity_type:
            return False
        if self.target_entity_id is not ANY \
                and e.target_entity_id != self.target_entity_id:
            return False
        return True


class StorageError(RuntimeError):
    pass


def _open_jsonl(source) -> Any:
    """An ``import_jsonl`` source as a binary stream: a path opens (a
    missing file raises OSError before anything is written), bytes (the
    storage server's forwarded blocks) become an in-memory stream."""
    import io
    if isinstance(source, (bytes, bytearray)):
        return io.BytesIO(bytes(source))
    return open(source, "rb")


def iter_jsonl_blocks(f, block_size: int) -> Iterator[Tuple[bytes, int]]:
    """Cut a binary stream into blocks of whole lines: ``(buf, nlines)``,
    ``buf`` ending at a line boundary and ``nlines`` the lines it holds,
    blank ones included, so a durable prefix counts as the file does. A
    line longer than ``block_size`` is carried until its newline; a last
    line without one still counts as one."""
    carry = b""
    while True:
        block = f.read(block_size)
        if not block and not carry:
            return
        buf = carry + block
        if block:
            cut = buf.rfind(b"\n")
            if cut < 0:  # a line longer than the block
                carry = buf
                continue
            buf, carry = buf[:cut + 1], buf[cut + 1:]
        else:
            carry = b""
        yield buf, (buf.count(b"\n") or 1)


class JsonlImportError(Exception):
    """A bulk JSON-lines import failed partway. ``lineno`` is where it
    failed, ``committed_lines``/``committed_events`` how far the durable
    prefix reaches (re-importing the whole file would duplicate it)."""

    def __init__(self, lineno: int, committed_lines: int,
                 committed_events: int, cause: BaseException):
        super().__init__(f"import failed near line {lineno}: {cause}")
        self.lineno = lineno
        self.committed_lines = committed_lines
        self.committed_events = committed_events
        self.cause = cause


class EventStore(abc.ABC):
    """Append-only event log, partitioned by (app_id, channel_id)."""

    @abc.abstractmethod
    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        """Initialize storage for an app/channel (create tables etc.)."""

    @abc.abstractmethod
    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        """Remove all events of an app/channel."""

    @abc.abstractmethod
    def close(self) -> None:
        """Release client resources."""

    @abc.abstractmethod
    def insert(self, event: Event, app_id: int,
               channel_id: Optional[int] = None) -> str:
        """Insert one event, returning its event id."""

    def insert_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: Optional[int] = None) -> List[str]:
        """Insert many events, **all or nothing**: the event server
        retries per event after a failed batch, so a partial commit would
        duplicate the committed prefix under fresh ids. This default
        compensates before re-raising: fresh inserts are deleted, and an
        insert that replaced an existing event (same explicit id) gets
        its prior version back."""
        done: list = []
        priors: dict = {}
        try:
            for e in events:
                if e.event_id and e.event_id not in priors:
                    priors[e.event_id] = self.get(e.event_id, app_id,
                                                  channel_id)
                done.append(self.insert(e, app_id, channel_id))
        except Exception:
            for eid in reversed(done):
                try:
                    prior = priors.get(eid)
                    if prior is not None:
                        self.insert(prior, app_id, channel_id)
                    else:
                        self.delete(eid, app_id, channel_id)
                except Exception:  # noqa: BLE001 — best-effort rollback
                    pass
            raise
        return done

    def insert_columnar(self, batch, app_id: int,
                        channel_id: Optional[int] = None) -> int:
        """Write a :class:`~predictionio_tpu_torch.data.columnar.
        ColumnarBatch` block; all or nothing, fresh ids for every row.
        Returns the rows written. This default decodes to events and
        rides :meth:`insert_batch`; SQLite overrides it with one
        transaction that builds no ``Event`` objects."""
        events = list(batch.to_events())
        self.insert_batch(events, app_id, channel_id)
        return len(events)

    def import_jsonl(self, source, app_id: int,
                     channel_id: Optional[int] = None,
                     chunk: int = 100_000) -> int:
        """Load API-format JSON lines from a file path (or a bytes block),
        committing every ``chunk`` events through :meth:`insert_batch`.
        Returns the events imported; on failure raises
        :class:`JsonlImportError` with how far the durable prefix
        reaches."""
        total = 0
        lineno = 0
        committed = 0  # last line number fully committed
        events: List[Event] = []
        f = _open_jsonl(source)
        try:
            with f:
                for raw in f:
                    lineno += 1
                    line = raw.decode("utf-8").strip()
                    if line:
                        events.append(Event.from_json(json.loads(line)))
                    if len(events) >= chunk:
                        self.insert_batch(events, app_id, channel_id)
                        total += len(events)
                        committed = lineno
                        events = []
            if events:
                self.insert_batch(events, app_id, channel_id)
                total += len(events)
        except Exception as e:  # noqa: BLE001 — report durable progress
            raise JsonlImportError(lineno, committed, total, e) from e
        return total

    @abc.abstractmethod
    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]:
        """Get an event by id."""

    @abc.abstractmethod
    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool:
        """Delete an event by id; True if it existed."""

    @abc.abstractmethod
    def find(self, app_id: int, channel_id: Optional[int] = None,
             filter: EventFilter = EventFilter()) -> Iterator[Event]:
        """Stream events matching the filter, in event-time order
        (reversed when ``filter.reversed``)."""

    def warm_columnar(self, app_id: int,
                      channel_id: Optional[int] = None) -> bool:
        """Build or refresh a persistent columnar sidecar now; False for
        backends that have none."""
        return False

    def find_columnar(self, app_id: int, channel_id: Optional[int] = None,
                      filter: EventFilter = EventFilter(),
                      float_props: Sequence[str] = ("rating",),
                      ordered: bool = True, with_props: bool = True,
                      shard: Optional[Tuple[int, int]] = None):
        """The bulk training read: the matching log as dictionary-encoded
        numpy columns. This default encodes from :meth:`find`; SQLite
        and SEGMENTFS override it with a persistent sidecar, REMOTE with
        the server's.

        ``shard=(i, n)``: the unfiltered storage-order projection cut
        into ``n`` contiguous ranges by ``ColumnarBatch.shard_bounds``,
        range ``i`` returned with the filter (and ordering) applied
        within it and stamped with ``shard_offset`` (its first row's
        global index) and ``shard_total`` (the log's rows). This default
        slices after a whole encode: right everywhere, saving no reads;
        the sidecar backends slice their mapped columns and REMOTE asks
        the server for the range."""
        from ..columnar import columnar_from_events
        batch = columnar_from_events(
            self.find(app_id, channel_id,
                      EventFilter() if shard is not None else filter),
            float_props=float_props)
        if shard is None:
            return batch
        return self._shard_and_select(batch, shard, filter,
                                      ordered=ordered,
                                      with_props=with_props)

    @staticmethod
    def _shard_and_select(batch, shard: Tuple[int, int],
                          filter: EventFilter, *,
                          ordered: bool, with_props: bool):
        """The shared tail of every backend's ``shard=`` read: shard
        ``i`` of ``n`` sliced off the whole unfiltered projection (zero
        copy), the filter applied within it, the shard stamped with
        ``shard_offset`` / ``shard_total``."""
        from ..columnar import ColumnarBatch
        i, n = shard
        if not 0 <= i < n:
            raise ValueError(f"shard {i} of {n}")
        bounds = ColumnarBatch.shard_bounds(batch.n, n)
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        sub = batch.slice_rows(lo, hi, with_props=with_props)
        sub = sub.select(filter, ordered=ordered, with_props=with_props)
        sub.shard_offset = lo
        sub.shard_total = batch.n
        return sub

    def aggregate_properties(
            self, app_id: int, channel_id: Optional[int] = None,
            *, entity_type: str, start_time: Optional[datetime] = None,
            until_time: Optional[datetime] = None,
            required: Optional[Sequence[str]] = None,
    ) -> Dict[str, PropertyMap]:
        """Replay ``$set/$unset/$delete`` into each entity's current
        properties; ``required`` keeps only entities holding every one of
        those fields. This default replays :meth:`find`; SQLite overrides
        it over its sidecar."""
        from ..aggregation import AGGREGATION_EVENTS, aggregate_properties
        events = self.find(app_id, channel_id, EventFilter(
            start_time=start_time, until_time=until_time,
            entity_type=entity_type, event_names=list(AGGREGATION_EVENTS)))
        return keep_required(aggregate_properties(events), required)

    def write(self, events: Iterable[Event], app_id: int,
              channel_id: Optional[int] = None) -> None:
        """Bulk write: ``events`` in batches of 1,000 through
        :meth:`insert_batch`, each batch all or nothing."""
        batch: List[Event] = []
        for e in events:
            batch.append(e)
            if len(batch) >= 1000:
                self.insert_batch(batch, app_id, channel_id)
                batch = []
        if batch:
            self.insert_batch(batch, app_id, channel_id)


def keep_required(result: Dict[str, PropertyMap],
                  required: Optional[Sequence[str]]
                  ) -> Dict[str, PropertyMap]:
    """The entities of an aggregation that hold every ``required``
    field (all of them when none is required)."""
    if not required:
        return result
    req = set(required)
    return {k: v for k, v in result.items() if req <= set(v.keys())}


# ---------------------------------------------------------------------------
# Metadata entities
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class App:
    id: int
    name: str
    description: Optional[str] = None


@dataclass(frozen=True)
class AccessKey:
    """An access key of one app; empty ``events`` allows every event
    name."""
    key: str
    app_id: int
    events: Sequence[str] = ()


@dataclass(frozen=True)
class Channel:
    """A named event channel of an app: 1-16 alphanumerics and dashes."""
    id: int
    name: str
    app_id: int

    @staticmethod
    def is_valid_name(s: str) -> bool:
        return bool(re.fullmatch(r"[a-zA-Z0-9-]{1,16}", s))


#: EngineInstance lifecycle states: INIT -> COMPLETED; an
#: EvaluationInstance goes INIT -> EVALCOMPLETED
STATUS_INIT = "INIT"
STATUS_COMPLETED = "COMPLETED"
STATUS_EVALCOMPLETED = "EVALCOMPLETED"


@dataclass(frozen=True)
class EngineInstance:
    """A training run."""
    id: str
    status: str
    start_time: datetime
    end_time: datetime
    engine_id: str
    engine_version: str
    engine_variant: str
    engine_factory: str
    batch: str = ""
    env: Dict[str, str] = field(default_factory=dict)
    spark_conf: Dict[str, str] = field(default_factory=dict)
    data_source_params: str = ""
    preparator_params: str = ""
    algorithms_params: str = ""
    serving_params: str = ""

    def copy(self, **changes: Any) -> "EngineInstance":
        return replace(self, **changes)


@dataclass(frozen=True)
class EvaluationInstance:
    """An evaluation run: the grid's evaluation and params-generator
    names, and the evaluator's one-liner, HTML and JSON results."""
    id: str
    status: str
    start_time: datetime
    end_time: datetime
    evaluation_class: str = ""
    engine_params_generator_class: str = ""
    batch: str = ""
    env: Dict[str, str] = field(default_factory=dict)
    spark_conf: Dict[str, str] = field(default_factory=dict)
    evaluator_results: str = ""
    evaluator_results_html: str = ""
    evaluator_results_json: str = ""

    def copy(self, **changes: Any) -> "EvaluationInstance":
        return replace(self, **changes)


#: Model-blob ids starting with this prefix are RESERVED for framework
#: metadata riding the MODELDATA repository: the release registry's state
#: documents (:mod:`predictionio_tpu_torch.rollout.registry`), the same
#: keys the JAX package writes. Engine-instance ids never collide with it,
#: and tooling that enumerates or garbage-collects model blobs must skip
#: reserved keys.
RESERVED_MODEL_KEY_PREFIX = "__release__"


@dataclass(frozen=True)
class Model:
    """A persisted model blob keyed by engine-instance id."""
    id: str
    models: bytes


# ---------------------------------------------------------------------------
# Metadata DAO contracts
# ---------------------------------------------------------------------------

class AppsDAO(abc.ABC):
    @abc.abstractmethod
    def insert(self, app: App) -> Optional[int]: ...
    @abc.abstractmethod
    def get(self, app_id: int) -> Optional[App]: ...
    @abc.abstractmethod
    def get_by_name(self, name: str) -> Optional[App]: ...
    @abc.abstractmethod
    def get_all(self) -> List[App]: ...
    @abc.abstractmethod
    def update(self, app: App) -> None: ...
    @abc.abstractmethod
    def delete(self, app_id: int) -> None: ...


class AccessKeysDAO(abc.ABC):
    @abc.abstractmethod
    def insert(self, access_key: AccessKey) -> Optional[str]:
        """Insert; an empty ``key`` gets a generated one."""
    @abc.abstractmethod
    def get(self, key: str) -> Optional[AccessKey]: ...
    @abc.abstractmethod
    def get_all(self) -> List[AccessKey]: ...
    @abc.abstractmethod
    def get_by_app_id(self, app_id: int) -> List[AccessKey]: ...
    @abc.abstractmethod
    def update(self, access_key: AccessKey) -> None: ...
    @abc.abstractmethod
    def delete(self, key: str) -> None: ...

    @staticmethod
    def generate_key() -> str:
        return base64.urlsafe_b64encode(uuid.uuid4().bytes).decode().rstrip("=")


class ChannelsDAO(abc.ABC):
    @abc.abstractmethod
    def insert(self, channel: Channel) -> Optional[int]: ...
    @abc.abstractmethod
    def get(self, channel_id: int) -> Optional[Channel]: ...
    @abc.abstractmethod
    def get_by_app_id(self, app_id: int) -> List[Channel]: ...
    @abc.abstractmethod
    def delete(self, channel_id: int) -> None: ...


class EngineInstancesDAO(abc.ABC):
    @abc.abstractmethod
    def insert(self, instance: EngineInstance) -> str: ...
    @abc.abstractmethod
    def get(self, instance_id: str) -> Optional[EngineInstance]: ...
    @abc.abstractmethod
    def get_all(self) -> List[EngineInstance]: ...
    @abc.abstractmethod
    def update(self, instance: EngineInstance) -> None: ...
    @abc.abstractmethod
    def delete(self, instance_id: str) -> None: ...

    @abc.abstractmethod
    def get_completed(self, engine_id: str, engine_version: str,
                      engine_variant: str) -> List[EngineInstance]:
        """COMPLETED instances, latest start time first."""

    def get_latest_completed(self, engine_id: str, engine_version: str,
                             engine_variant: str) -> Optional[EngineInstance]:
        completed = self.get_completed(engine_id, engine_version,
                                       engine_variant)
        return completed[0] if completed else None


class EvaluationInstancesDAO(abc.ABC):
    @abc.abstractmethod
    def insert(self, instance: EvaluationInstance) -> str: ...
    @abc.abstractmethod
    def get(self, instance_id: str) -> Optional[EvaluationInstance]: ...
    @abc.abstractmethod
    def get_all(self) -> List[EvaluationInstance]: ...
    @abc.abstractmethod
    def get_completed(self) -> List[EvaluationInstance]:
        """EVALCOMPLETED instances, latest start time first."""
    @abc.abstractmethod
    def update(self, instance: EvaluationInstance) -> None: ...
    @abc.abstractmethod
    def delete(self, instance_id: str) -> None: ...


class ModelsDAO(abc.ABC):
    @abc.abstractmethod
    def insert(self, model: Model) -> None: ...
    @abc.abstractmethod
    def get(self, model_id: str) -> Optional[Model]: ...
    @abc.abstractmethod
    def delete(self, model_id: str) -> None: ...
