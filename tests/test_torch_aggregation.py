"""Property aggregation and serving-time point reads on the port, held
to the JAX package on the CPU.

The same seeded ``$set/$unset/$delete`` streams, shuffled, go into both
packages' MEMORY stores and into one SQLite file that both packages
read (the SQLite read aggregates over the columnar sidecar): every
entity's properties and first/last update times must be equal exactly.
``find_by_entity`` must return the JAX package's events for the same
filters, honour ``limit`` and ``latest``, and raise ``TimeoutError``
once its deadline has passed.
"""

from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

import predictionio_tpu.data.aggregation as jagg
from predictionio_tpu.data.datamap import DataMap as JDataMap
from predictionio_tpu.data.event import Event as JEvent
from predictionio_tpu.data.storage.base import App as JApp
from predictionio_tpu.data.storage.registry import Storage as JStorage
from predictionio_tpu.data.store import EventStoreFacade as JFacade
from predictionio_tpu_torch.data import aggregation as pagg
from predictionio_tpu_torch.data import store as pstore
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.base import (
    App,
    EventFilter,
    EventStore,
)
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.data.store import EventStoreFacade

T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
APP = "aggapp"
MEM_ENV = {"PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"}
FIELDS = ("a", "b", "c", "categories")


def property_stream(seed: int, n_entities: int = 12, n: int = 240):
    """A shuffled stream of special events plus some ordinary ones, as
    (event, entity type, entity id, properties, seconds after T0). Times
    repeat, so equal-time ties between set, unset and delete occur."""
    rng = np.random.default_rng(seed)
    names = ["$set"] * 6 + ["$unset"] * 2 + ["$delete", "view"]
    out = []
    for _ in range(n):
        name = names[int(rng.integers(len(names)))]
        etype = "item" if rng.random() < 0.75 else "user"
        eid = f"{etype[0]}{int(rng.integers(n_entities))}"
        keys = [f for f in FIELDS if rng.random() < 0.4]
        if name == "$set":
            props = {k: ([f"c{int(rng.integers(3))}"] if k == "categories"
                         else int(rng.integers(100))) for k in keys}
        elif name == "$unset":
            props = {k: None for k in keys or ["a"]}
        else:
            props = {}
        out.append((name, etype, eid, props, int(rng.integers(60))))
    order = rng.permutation(len(out))
    return [out[k] for k in order]


def to_events(stream, event_cls, datamap_cls):
    return [event_cls(
        event=name, entity_type=etype, entity_id=eid,
        target_entity_type="item" if name == "view" else None,
        target_entity_id="i0" if name == "view" else None,
        properties=datamap_cls(props),
        event_time=T0 + timedelta(seconds=t))
        for name, etype, eid, props, t in stream]


def as_plain(result):
    return {k: (v.to_dict(), v.first_updated, v.last_updated)
            for k, v in result.items()}


def memory_pair(events_stream):
    store = Storage(env=MEM_ENV)
    app_id = store.apps().insert(App(0, APP))
    store.events().init(app_id)
    store.events().insert_batch(to_events(events_stream, Event, DataMap),
                                app_id)
    jstore = JStorage(env={
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"})
    japp_id = jstore.apps().insert(JApp(0, APP))
    jstore.events().init(japp_id)
    jstore.events().insert_batch(
        to_events(events_stream, JEvent, JDataMap), japp_id)
    return store, jstore


@pytest.fixture
def sqlite_pair(tmp_path):
    """One SQLite store written by the port, opened by both packages."""
    home = str(tmp_path / "home")
    store = Storage(env={"PIO_HOME": home})
    app_id = store.apps().insert(App(0, APP))
    store.events().init(app_id)
    store.events().insert_batch(
        to_events(property_stream(5), Event, DataMap), app_id)
    jstore = JStorage(env={"PIO_HOME": home})
    yield store, jstore
    jstore.close()
    store.close()


# -- the aggregators, event streams in ----------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_monoid_aggregation_is_the_jax_packages(seed):
    stream = property_stream(seed)
    mine = pagg.aggregate_properties(to_events(stream, Event, DataMap))
    theirs = jagg.aggregate_properties(to_events(stream, JEvent, JDataMap))
    assert mine and as_plain(mine) == as_plain(theirs)


@pytest.mark.parametrize("seed", range(3))
def test_ordered_fold_is_the_jax_packages(seed):
    stream = property_stream(seed)
    mine = pagg.aggregate_properties_ordered(to_events(stream, Event,
                                                       DataMap))
    theirs = jagg.aggregate_properties_ordered(
        to_events(stream, JEvent, JDataMap))
    assert mine and as_plain(mine) == as_plain(theirs)


@pytest.mark.parametrize("seed", range(3))
def test_shards_merge_to_the_whole(seed):
    events = to_events(property_stream(seed), Event, DataMap)
    cut = len(events) // 3
    ops = pagg.merge_aggregates(pagg.partial_aggregate(events[cut:]),
                                pagg.partial_aggregate(events[:cut]))
    merged = {k: pm for k, op in ops.items()
              if (pm := op.to_property_map()) is not None}
    assert as_plain(merged) == as_plain(pagg.aggregate_properties(events))


def test_set_then_delete_then_set():
    def ev(name, t, props=None):
        return Event(event=name, entity_type="item", entity_id="x",
                     properties=DataMap(props or {}),
                     event_time=T0 + timedelta(seconds=t))

    events = [ev("$set", 0, {"a": 1, "b": 2}), ev("$delete", 5),
              ev("$set", 9, {"b": 3}), ev("$unset", 9, {"b": None})]
    (pm,) = pagg.aggregate_properties(events).values()
    assert pm.to_dict() == {}  # unset at the set's own time wins
    assert pm.first_updated == T0 and pm.last_updated == events[2].event_time
    assert pagg.aggregate_properties(events[:2]) == {}


# -- the stores ---------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("entity_type", ["item", "user"])
def test_memory_store_aggregation_is_the_jax_packages(seed, entity_type):
    store, jstore = memory_pair(property_stream(seed))
    mine = EventStoreFacade(store).aggregate_properties(APP, entity_type)
    theirs = JFacade(jstore).aggregate_properties(APP, entity_type)
    assert mine and as_plain(mine) == as_plain(theirs)


@pytest.mark.parametrize("required", [None, ["a"], ["a", "categories"]])
def test_sqlite_store_aggregation_is_the_jax_packages(sqlite_pair, required):
    store, jstore = sqlite_pair
    mine = EventStoreFacade(store).aggregate_properties(
        APP, "item", required=required)
    theirs = JFacade(jstore).aggregate_properties(APP, "item",
                                                  required=required)
    assert mine and as_plain(mine) == as_plain(theirs)
    # the sidecar read equals the generic replay of find()
    app_id = store.apps().get_by_name(APP).id
    replay = EventStore.aggregate_properties(
        store.events(), app_id, entity_type="item", required=required)
    assert as_plain(replay) == as_plain(mine)


def test_sqlite_aggregation_sees_later_writes(sqlite_pair):
    store, _ = sqlite_pair
    facade = EventStoreFacade(store)
    before = facade.aggregate_properties(APP, "item")
    app_id = store.apps().get_by_name(APP).id
    store.events().insert(Event(
        event="$set", entity_type="item", entity_id="fresh",
        properties=DataMap({"a": 7}), event_time=T0 + timedelta(days=1)),
        app_id)
    after = facade.aggregate_properties(APP, "item")
    assert "fresh" not in before and after["fresh"].to_dict() == {"a": 7}


def test_time_window_is_the_jax_packages(sqlite_pair):
    store, jstore = sqlite_pair
    kw = dict(start_time=T0 + timedelta(seconds=10),
              until_time=T0 + timedelta(seconds=40))
    mine = EventStoreFacade(store).aggregate_properties(APP, "item", **kw)
    theirs = JFacade(jstore).aggregate_properties(APP, "item", **kw)
    assert as_plain(mine) == as_plain(theirs)


# -- serving-time point reads -------------------------------------------------

def read_stream():
    """Views of one user at distinct times, plus other users' events."""
    out = [("view", "user", "u1", {}, t) for t in range(0, 50, 2)]
    out += [("buy", "user", "u1", {}, 51), ("view", "user", "u2", {}, 3)]
    return out


@pytest.fixture(params=["memory", "sqlite"])
def read_pair(request, tmp_path):
    if request.param == "memory":
        store, jstore = memory_pair(read_stream())
        yield store, jstore
        return
    home = str(tmp_path / "home")
    store = Storage(env={"PIO_HOME": home})
    app_id = store.apps().insert(App(0, APP))
    store.events().init(app_id)
    store.events().insert_batch(to_events(read_stream(), Event, DataMap),
                                app_id)
    jstore = JStorage(env={"PIO_HOME": home})
    yield store, jstore
    jstore.close()
    store.close()


def _key(events):
    return [(e.event, e.entity_id, e.target_entity_id, e.event_time)
            for e in events]


@pytest.mark.parametrize("kw", [
    dict(limit=1, latest=True, event_names=["view"]),
    dict(limit=10, latest=True, event_names=["view"],
         target_entity_type="item"),
    dict(limit=3, latest=False),
    dict(latest=True, event_names=["view", "buy"]),
    dict(limit=-1, latest=False, event_names=["buy"]),
])
def test_find_by_entity_is_the_jax_packages(read_pair, kw):
    store, jstore = read_pair
    mine = EventStoreFacade(store).find_by_entity(APP, "user", "u1",
                                                  timeout_ms=5000, **kw)
    theirs = JFacade(jstore).find_by_entity(APP, "user", "u1",
                                            timeout_ms=5000, **kw)
    assert mine and _key(mine) == _key(theirs)


def test_find_by_entity_limit_and_latest(read_pair):
    store, _ = read_pair
    facade = EventStoreFacade(store)
    latest = facade.find_by_entity(APP, "user", "u1", event_names=["view"],
                                   limit=4, latest=True)
    assert [e.event_time for e in latest] == [
        T0 + timedelta(seconds=t) for t in (48, 46, 44, 42)]
    earliest = facade.find_by_entity(APP, "user", "u1",
                                     event_names=["view"], limit=2,
                                     latest=False)
    assert [e.event_time for e in earliest] == [T0, T0 + timedelta(seconds=2)]
    assert len(facade.find_by_entity(APP, "user", "u1")) == 26


def test_find_by_entity_raises_past_its_deadline(read_pair):
    store, _ = read_pair
    with pytest.raises(TimeoutError):
        EventStoreFacade(store).find_by_entity(APP, "user", "u1",
                                               timeout_ms=-1)


def test_the_scan_checks_the_deadline(read_pair):
    store, _ = read_pair
    app_id = store.apps().get_by_name(APP).id
    with pytest.raises(TimeoutError):
        list(store.events().find(app_id, filter=EventFilter(deadline=0.0)))
    assert len(list(store.events().find(
        app_id, filter=EventFilter(deadline=None)))) == len(read_stream())


def test_the_drain_checks_the_deadline(monkeypatch):
    """A scan that returns in time but drains past the deadline raises
    too: the drain is bounded by its own check."""
    store, _ = memory_pair(read_stream())
    calls = []

    def clock():
        # the deadline's start and the scan's one check read 0 s; the
        # drain's check reads 10 s
        calls.append(1)
        return 0.0 if len(calls) <= 2 else 10.0

    monkeypatch.setattr(pstore.time, "monotonic", clock)
    with pytest.raises(TimeoutError):
        EventStoreFacade(store).find_by_entity(APP, "user", "u1",
                                               timeout_ms=1000)


def test_the_default_facade_reads_the_process_wide_storage(monkeypatch):
    from predictionio_tpu_torch.data.storage import registry

    store, _ = memory_pair(read_stream())
    monkeypatch.setattr(registry, "_global", store)
    got = pstore.event_store.find_by_entity(APP, "user", "u2")
    assert [e.entity_id for e in got] == ["u2"]
