"""The port's LOCALFS, SEGMENTFS, REMOTE and S3 backends held to the JAX
package's.

Cross-package formats: one package writes a LOCALFS or SEGMENTFS
directory (events with a delete, metadata, a model blob) and the other
reads it, both ways: the events, the ``find_columnar`` columns and the
metadata are equal. A SEGMENTFS sidecar hashed by the other package is
rebuilt (the manifest's ``hash_impl`` moves, with a warning) when the two
packages hash ids differently, as the JAX package's pandas siphash and
the port's blake2b do. Both packages' object-store clients share one
bucket, whichever package runs the fake server; each package's REMOTE
client talks to the other's storage server (the secret, the ETag and 304,
the columnar ingest).

Then the port alone: the JAX package's conformance scenarios
(``tests/test_storage.py``) over every port backend, its seeded operation
fuzz with the JAX package's SQLite store as the oracle
(``tests/test_storage_fuzz.py``) and its kill-the-writer-mid-batch fuzz
at the same seeds (``tests/test_crash_fuzz.py``).
"""

import json
import logging
import os
import re
import signal
import subprocess
import sys
import textwrap
import time
import urllib.request
import zlib
from datetime import datetime, timedelta, timezone
from pathlib import Path

import numpy as np
import pytest

import predictionio_tpu.data.columnar as jcol
import predictionio_tpu.data.event as jev
import predictionio_tpu.data.storage.base as jbase
from predictionio_tpu.data.datamap import DataMap as JDataMap
from predictionio_tpu.data.storage.objectstore import (
    FakeObjectStoreServer as JFakeObjectStoreServer,
)
from predictionio_tpu.data.storage.registry import Storage as JStorage
from predictionio_tpu.data.storage.sqlite import (
    SQLiteClient as JSQLiteClient,
    SQLiteEventStore as JSQLiteEventStore,
)
from predictionio_tpu.server.storageserver import (
    create_storage_server as j_create_storage_server,
)
from predictionio_tpu_torch.data import columnar as pcol
from predictionio_tpu_torch.data import event as pev
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.storage import base as pbase
from predictionio_tpu_torch.data.storage.base import (
    ANY,
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EvaluationInstance,
    EventFilter,
    Model,
    StorageError,
    STATUS_COMPLETED,
    STATUS_EVALCOMPLETED,
)
from predictionio_tpu_torch.data.storage.objectstore import (
    FakeObjectStoreServer,
)
from predictionio_tpu_torch.data.storage.registry import Storage as PStorage
from predictionio_tpu_torch.data.storage.wire import entity_to_doc
from predictionio_tpu_torch.server.storageserver import (
    create_storage_server,
)

ROOT = Path(__file__).resolve().parent.parent
T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
HOUR = timedelta(hours=1)
APP = 7
PKG = {"jax": (jev, jcol, jbase, JStorage),
       "port": (pev, pcol, pbase, PStorage)}

#: loopback only: no proxy from the environment may carry these requests
_LOCAL = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def env_of(kind: str, where: str, secret: str = "") -> dict:
    """One source ``X`` of ``kind`` for every repository."""
    key = {"LOCALFS": "PATH", "SEGMENTFS": "PATH", "REMOTE": "URL",
           "S3": "ENDPOINT"}[kind]
    env = {"PIO_STORAGE_SOURCES_X_TYPE": kind,
           f"PIO_STORAGE_SOURCES_X_{key}": where}
    if secret:
        env["PIO_STORAGE_SOURCES_X_SECRET"] = secret
    return env


def event_dicts(n=90, seed=0):
    """API-format events: rates with a rating, buys, $set without a
    target, at distinct times."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        kind = ("rate", "rate", "buy", "$set")[k % 4]
        e = {"event": kind, "entityType": "user",
             "entityId": f"u{int(rng.integers(0, 11))}",
             "eventTime": (T0 + timedelta(seconds=k)).isoformat(),
             "creationTime": T0.isoformat()}
        if kind != "$set":
            e.update(targetEntityType="item",
                     targetEntityId=f"i{int(rng.integers(0, 9))}")
        if kind == "rate":
            e["properties"] = {"rating": float(rng.integers(1, 11)) / 2}
        elif kind == "$set":
            e["properties"] = {"age": int(rng.integers(18, 80))}
        out.append(e)
    return out


def write_store(pkg: str, storage, dicts, with_model=True) -> int:
    """Events in three batches, one delete, and one of each metadata
    entity and a model blob."""
    ev, _, base, _ = PKG[pkg]
    app_id = storage.apps().insert(base.App(0, "crossapp", "d"))
    storage.access_keys().insert(base.AccessKey("k-1", app_id,
                                                ("rate", "buy")))
    storage.channels().insert(base.Channel(0, "side", app_id))
    storage.engine_instances().insert(base.EngineInstance(
        id="i-1", status="COMPLETED", start_time=T0, end_time=T0 + HOUR,
        engine_id="e", engine_version="1", engine_variant="v",
        engine_factory="f", algorithms_params='[{"als": {}}]'))
    storage.evaluation_instances().insert(base.EvaluationInstance(
        id="x-1", status="EVALCOMPLETED", start_time=T0, end_time=T0,
        evaluation_class="my.Eval", evaluator_results="m=0.5"))
    if with_model:
        storage.models().insert(base.Model("i-1", b"\x00\x01blob\xff"))
    store = storage.events()
    store.init(app_id)
    events = [ev.Event.from_json(d) for d in dicts]
    ids = []
    for s in range(0, len(events), 30):
        ids += store.insert_batch(events[s:s + 30], app_id)
    assert store.delete(ids[4], app_id)
    return app_id


def metadata(storage) -> dict:
    return {
        "apps": [entity_to_doc(a) for a in storage.apps().get_all()],
        "keys": sorted(json.dumps(entity_to_doc(k), sort_keys=True)
                       for k in storage.access_keys().get_all()),
        "channels": [entity_to_doc(c)
                     for c in storage.channels().get_by_app_id(1)],
        "engine": [entity_to_doc(i)
                   for i in storage.engine_instances().get_all()],
        "eval": [entity_to_doc(i)
                 for i in storage.evaluation_instances().get_all()],
    }


def event_rows(store, app_id) -> list:
    return sorted(json.dumps(e.to_json(), sort_keys=True)
                  for e in store.find(app_id))


def assert_same_batch(a, b):
    for col in ("event", "entity_type", "entity_id", "target_type",
                "target_id", "event_time"):
        np.testing.assert_array_equal(np.asarray(getattr(a, col)),
                                      np.asarray(getattr(b, col)), col)
    for name in ("event_names", "entity_types", "entity_ids",
                 "target_types", "target_ids"):
        assert list(getattr(a.dicts, name).values) == \
            list(getattr(b.dicts, name).values), name
    np.testing.assert_array_equal(a.float_prop("rating"),
                                  b.float_prop("rating"))


def read_both_ways(writer: str, reader: str, env: dict, tmp_path,
                   caplog) -> tuple:
    """The writer package writes (and builds its columnar read), the
    reader package reads: events, columns and metadata must be equal."""
    wst = PKG[writer][3](env=env)
    app_id = write_store(writer, wst, event_dicts())
    w_rows = event_rows(wst.events(), app_id)
    w_batch = wst.events().find_columnar(app_id, ordered=False,
                                         with_props=False)
    w_meta = metadata(wst)
    wst.close()
    rst = PKG[reader][3](env=env)
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        r_batch = rst.events().find_columnar(app_id, ordered=False,
                                             with_props=False)
    assert event_rows(rst.events(), app_id) == w_rows
    assert len(w_rows) == 89
    assert_same_batch(w_batch, r_batch)
    assert metadata(rst) == w_meta
    assert rst.models().get("i-1").models == b"\x00\x01blob\xff"
    rst.close()
    return app_id


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_localfs_directory_reads_in_the_other_package(writer, reader,
                                                      tmp_path, caplog):
    read_both_ways(writer, reader, env_of("LOCALFS", str(tmp_path / "fs")),
                   tmp_path, caplog)


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_segmentfs_directory_reads_in_the_other_package(writer, reader,
                                                        tmp_path, caplog):
    root = tmp_path / "seg"
    app_id = read_both_ways(writer, reader, env_of("SEGMENTFS", str(root)),
                            tmp_path, caplog)
    manifest = json.loads((root / "events" / f"app_{app_id}" / "columnar" /
                           "manifest.json").read_text())
    hashes = {p: PKG[p][1].hash_impl() for p in PKG}
    assert hashes["port"] == "blake2b"
    # the sidecar now carries the reader's hashes
    assert manifest["hash_impl"] == hashes[reader]
    rebuilt = [r for r in caplog.records if "rebuilding" in r.getMessage()]
    assert bool(rebuilt) == (hashes["jax"] != hashes["port"])


def test_segmentfs_native_import_reads_in_the_jax_package(tmp_path):
    """A SEGMENTFS log the port imported through its native lane reads
    the same in the JAX package, events and columns."""
    from predictionio_tpu_torch import native

    env = env_of("SEGMENTFS", str(tmp_path / "seg"))
    f = tmp_path / "ev.jsonl"
    f.write_text("".join(json.dumps(d) + "\n" for d in event_dicts(200)))
    pst = PStorage(env=env)
    app_id = pst.apps().insert(App(0, "imp"))
    pst.events().init(app_id)
    native.reset_lane_counts()
    assert pst.events().import_jsonl(str(f), app_id) == 200
    assert native.lane_counts()["import_jsonl"] == {"native": 1,
                                                    "python": 0}
    p_batch = pst.events().find_columnar(app_id, ordered=False,
                                         with_props=False)
    rows = event_rows(pst.events(), app_id)
    pst.close()
    jst = JStorage(env=env)
    assert event_rows(jst.events(), app_id) == rows
    assert_same_batch(p_batch, jst.events().find_columnar(
        app_id, ordered=False, with_props=False))
    jst.close()


@pytest.mark.parametrize("server", ["jax", "port"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_one_bucket_serves_both_packages(server, writer, reader, tmp_path,
                                         caplog):
    cls = {"jax": JFakeObjectStoreServer,
           "port": FakeObjectStoreServer}[server]
    srv = cls(str(tmp_path / "bucket")).start_background()
    try:
        read_both_ways(writer, reader, env_of(
            "S3", f"http://127.0.0.1:{srv.port}/bucket"), tmp_path, caplog)
    finally:
        srv.shutdown()


def scrape_hits(port: int) -> float:
    with _LOCAL.open(f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
        text = r.read().decode()
    m = re.search(r'pio_columnar_requests_total\{outcome="hit"\} (\S+)',
                  text)
    return float(m.group(1)) if m else 0.0


@pytest.mark.parametrize("client,server", [("port", "jax"),
                                           ("jax", "port")])
def test_remote_client_and_server_across_packages(client, server,
                                                  tmp_path):
    backing = PKG[server][3](env={"PIO_HOME": str(tmp_path / "backing")})
    make = {"jax": j_create_storage_server,
            "port": create_storage_server}[server]
    srv = make(backing, host="127.0.0.1", port=0, secret="s3cret")
    srv.start_background()
    url = f"http://127.0.0.1:{srv.port}"
    try:
        bad = PKG[client][3](env=env_of("REMOTE", url, secret="wrong"))
        with pytest.raises(PKG[client][2].StorageError, match="401"):
            bad.apps().get_all()
        bad.close()
        st = PKG[client][3](env=env_of("REMOTE", url, secret="s3cret"))
        app_id = write_store(client, st, event_dicts())
        rows = event_rows(st.events(), app_id)
        assert rows == event_rows(backing.events(), app_id)
        assert metadata(st) == metadata(backing)
        assert st.models().get("i-1").models == b"\x00\x01blob\xff"
        first = st.events().find_columnar(app_id, ordered=False,
                                          with_props=False)
        hits = scrape_hits(srv.port)
        again = st.events().find_columnar(app_id, ordered=False,
                                          with_props=False)
        assert scrape_hits(srv.port) == hits + 1  # a 304
        assert_same_batch(first, again)
        assert_same_batch(first, backing.events().find_columnar(
            app_id, ordered=False, with_props=False))
        # the columnar ingest: one npz block, all of it written
        col, ev = PKG[client][1], PKG[client][0]
        block = col.columnar_from_events(
            ev.Event.from_json(d) for d in event_dicts(20, seed=5))
        assert st.events().insert_columnar(block, app_id) == 20
        assert len(event_rows(backing.events(), app_id)) == 89 + 20
        grown = st.events().find_columnar(app_id, ordered=False,
                                          with_props=False)
        assert grown.n == first.n + 20
        st.close()
    finally:
        srv.close() if server == "port" else srv.shutdown()
        backing.close()


# -- the port alone: conformance ---------------------------------------------

def ev(name, eid, t, etype="user", **kw):
    return pev.Event(event=name, entity_type=etype, entity_id=eid,
                     event_time=t, **kw)


class Served:
    """A storage server of the port over a SQLite store, on a free
    port, closed with the fixture."""

    def __init__(self, tmp_path, secret=""):
        self.backing = PStorage(env={"PIO_HOME": str(tmp_path / "srv")})
        self.srv = create_storage_server(
            self.backing, host="127.0.0.1", port=0,
            secret=secret or None).start_background()
        self.url = f"http://127.0.0.1:{self.srv.port}"

    def close(self):
        self.srv.close()
        self.backing.close()


def open_backend(kind: str, tmp_path):
    """(port Storage, what to call after closing it) for one backend."""
    if kind == "memory":
        return PStorage(env={"PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"}), []
    if kind == "sqlite":
        return PStorage(env={"PIO_HOME": str(tmp_path / "sq")}), []
    if kind in ("localfs", "segmentfs"):
        return PStorage(env=env_of(kind.upper(), str(tmp_path / kind))), []
    if kind == "remote":
        served = Served(tmp_path, secret="testsecret")
        return PStorage(env=env_of("REMOTE", served.url,
                                   secret="testsecret")), [served.close]
    bucket = FakeObjectStoreServer(str(tmp_path / "bucket"))
    bucket.start_background()
    return PStorage(env=env_of(
        "S3", f"http://127.0.0.1:{bucket.port}/bucket")), [bucket.shutdown]


BACKENDS = ["memory", "sqlite", "localfs", "segmentfs", "remote", "s3"]


@pytest.fixture(params=BACKENDS)
def backend(request, tmp_path):
    st, closers = open_backend(request.param, tmp_path)
    yield st
    st.close()
    for close in closers:
        close()


class TestEventStoreConformance:
    def test_insert_get_delete(self, backend):
        es = backend.events()
        es.init(APP)
        e = ev("view", "u1", T0, target_entity_type="item",
               target_entity_id="i1", properties=DataMap({"x": 1}))
        eid = es.insert(e, APP)
        got = es.get(eid, APP)
        assert got is not None and got.event_id == eid
        assert got.entity_id == "u1" and got.target_entity_id == "i1"
        assert got.properties == DataMap({"x": 1})
        assert got.event_time == T0
        assert es.delete(eid, APP) is True
        assert es.get(eid, APP) is None
        assert es.delete(eid, APP) is False

    def test_find_time_ordering_and_filters(self, backend):
        es = backend.events()
        es.init(APP)
        es.insert_batch([
            ev("view", "u1", T0 + 2 * HOUR, target_entity_type="item",
               target_entity_id="i2"),
            ev("rate", "u1", T0, target_entity_type="item",
               target_entity_id="i1", properties=DataMap({"rating": 4})),
            ev("view", "u2", T0 + HOUR, target_entity_type="item",
               target_entity_id="i1"),
            ev("$set", "u1", T0 + 3 * HOUR, properties=DataMap({"a": 1})),
        ], APP)
        allv = list(es.find(APP))
        assert [e.event_time for e in allv] == \
            sorted(e.event_time for e in allv)
        assert len(allv) == 4
        rev = list(es.find(APP, filter=EventFilter(reversed=True, limit=2)))
        assert len(rev) == 2 and rev[0].event_time == T0 + 3 * HOUR
        assert len(list(es.find(APP, filter=EventFilter(
            entity_id="u1")))) == 3
        assert len(list(es.find(APP, filter=EventFilter(
            event_names=["view"])))) == 2
        assert len(list(es.find(APP, filter=EventFilter(
            start_time=T0 + HOUR, until_time=T0 + 3 * HOUR)))) == 2
        assert len(list(es.find(APP, filter=EventFilter(
            target_entity_id="i1")))) == 2
        no_tgt = list(es.find(APP, filter=EventFilter(target_entity_id=None)))
        assert len(no_tgt) == 1 and no_tgt[0].event == "$set"
        assert len(list(es.find(APP, filter=EventFilter(
            target_entity_id=ANY)))) == 4

    def test_find_columnar_matches_find_and_refuses_shards(self, backend):
        es = backend.events()
        es.init(APP)
        es.insert_batch(
            [ev("rate" if k % 3 else "buy", f"u{k % 7}", T0 + k * HOUR,
                target_entity_type="item", target_entity_id=f"i{k % 5}",
                properties=DataMap({"rating": float(k % 5 + 1)}))
             for k in range(53)], APP)

        def rows(events):
            return sorted((e.event, e.entity_id, e.target_entity_id,
                           e.event_time.isoformat()) for e in events)

        full = es.find_columnar(APP, ordered=False)
        assert full.n == 53 and rows(full.to_events()) == rows(es.find(APP))
        rates = es.find_columnar(APP, filter=EventFilter(
            event_names=["rate"]), ordered=True)
        assert rates.n == 35 and np.all(np.diff(rates.event_time) >= 0)
        # shards: the JAX package's cut of the same storage order, row
        # for row, covering the filtered read together
        jfull = jcol.ColumnarBatch(
            **{f: getattr(full, f) for f in (
                "event", "entity_type", "entity_id", "target_type",
                "target_id", "event_time", "props_offsets", "props_blob",
                "float_props")}, dicts=jcol.ColumnarDicts(**{
                    k: jcol.StringDict(list(getattr(full.dicts, k).values))
                    for k in full.dicts.counts()}))
        total = 0
        for i in range(4):
            got = es.find_columnar(APP, filter=EventFilter(
                event_names=["rate"]), ordered=False, shard=(i, 4))
            want = jbase.EventStore._shard_and_select(
                jfull, (i, 4), jbase.EventFilter(event_names=["rate"]),
                ordered=False, with_props=True)
            for col in ("event", "entity_id", "target_id", "event_time",
                        "props_offsets", "props_blob"):
                np.testing.assert_array_equal(getattr(got, col),
                                              getattr(want, col), col)
            assert (got.shard_offset, got.shard_total) == \
                (want.shard_offset, want.shard_total) == \
                (int(jcol.ColumnarBatch.shard_bounds(53, 4)[i]), 53)
            total += got.n
        assert total == rates.n

    def test_channel_isolation(self, backend):
        es = backend.events()
        es.init(APP)
        es.init(APP, 3)
        es.insert(ev("view", "u1", T0), APP)
        es.insert(ev("buy", "u1", T0), APP, 3)
        assert [e.event for e in es.find(APP)] == ["view"]
        assert [e.event for e in es.find(APP, 3)] == ["buy"]

    def test_app_isolation_and_remove(self, backend):
        es = backend.events()
        es.init(APP)
        es.init(APP + 1)
        es.insert(ev("view", "u1", T0), APP)
        assert list(es.find(APP + 1)) == []
        assert es.remove(APP)
        assert list(es.find(APP)) == []

    def test_aggregate_properties_through_store(self, backend):
        es = backend.events()
        es.init(APP)
        es.insert_batch([
            ev("$set", "u1", T0, properties=DataMap({"a": 1, "b": 2})),
            ev("$unset", "u1", T0 + HOUR, properties=DataMap({"b": None})),
            ev("$set", "u2", T0, properties=DataMap({"a": 9})),
            ev("$delete", "u2", T0 + HOUR),
            ev("view", "u1", T0 + 2 * HOUR, target_entity_type="item",
               target_entity_id="i1"),
        ], APP)
        props = es.aggregate_properties(APP, entity_type="user")
        assert set(props) == {"u1"} and props["u1"].to_dict() == {"a": 1}

    def test_aggregate_required_keys(self, backend):
        es = backend.events()
        es.init(APP)
        es.insert_batch([
            ev("$set", "u1", T0, properties=DataMap({"a": 1})),
            ev("$set", "u2", T0, properties=DataMap({"a": 1, "b": 2})),
        ], APP)
        assert set(es.aggregate_properties(
            APP, entity_type="user", required=["b"])) == {"u2"}


class TestMetadataConformance:
    def test_apps(self, backend):
        apps = backend.apps()
        app_id = apps.insert(App(0, "myapp", "desc"))
        assert app_id is not None and app_id > 0
        assert apps.get(app_id).name == "myapp"
        assert apps.get_by_name("myapp").id == app_id
        assert apps.insert(App(0, "myapp")) is None  # duplicate name
        apps.update(App(app_id, "myapp", "newdesc"))
        assert apps.get(app_id).description == "newdesc"
        id2 = apps.insert(App(0, "app2"))
        assert {a.name for a in apps.get_all()} == {"myapp", "app2"}
        apps.delete(app_id)
        assert apps.get(app_id) is None and apps.get(id2) is not None

    def test_access_keys(self, backend):
        keys = backend.access_keys()
        k = keys.insert(AccessKey("", 1, ["view", "rate"]))
        assert k and keys.get(k).app_id == 1
        assert tuple(keys.get(k).events) == ("view", "rate")
        assert keys.insert(AccessKey("explicit-key", 2, [])) == \
            "explicit-key"
        assert {a.key for a in keys.get_by_app_id(1)} == {k}
        keys.delete(k)
        assert keys.get(k) is None

    def test_channels(self, backend):
        ch = backend.channels()
        cid = ch.insert(Channel(0, "mychan", 1))
        assert cid is not None and ch.get(cid).name == "mychan"
        assert ch.insert(Channel(0, "bad name!", 1)) is None
        assert ch.insert(Channel(0, "x" * 17, 1)) is None
        assert [c.id for c in ch.get_by_app_id(1)] == [cid]
        ch.delete(cid)
        assert ch.get(cid) is None

    def test_engine_instances_lifecycle(self, backend):
        eis = backend.engine_instances()
        base = EngineInstance(
            id="", status="INIT", start_time=T0, end_time=T0,
            engine_id="eng", engine_version="1", engine_variant="default",
            engine_factory="my.Factory", algorithms_params='[{"als":{}}]')
        i1 = eis.insert(base)
        i2 = eis.insert(base.copy(start_time=T0 + HOUR))
        assert eis.get_latest_completed("eng", "1", "default") is None
        eis.update(eis.get(i1).copy(status=STATUS_COMPLETED))
        eis.update(eis.get(i2).copy(status=STATUS_COMPLETED))
        latest = eis.get_latest_completed("eng", "1", "default")
        assert latest.id == i2
        assert latest.algorithms_params == '[{"als":{}}]'
        assert eis.get_latest_completed("eng", "2", "default") is None
        eis.delete(i1)
        assert eis.get(i1) is None

    def test_evaluation_instances(self, backend):
        evs = backend.evaluation_instances()
        i = evs.insert(EvaluationInstance(
            id="", status="INIT", start_time=T0, end_time=T0,
            evaluation_class="my.Eval"))
        evs.update(evs.get(i).copy(status=STATUS_EVALCOMPLETED,
                                   evaluator_results="metric=0.5"))
        done = evs.get_completed()
        assert [x.id for x in done] == [i]
        assert done[0].evaluator_results == "metric=0.5"

    def test_models(self, backend):
        models = backend.models()
        models.insert(Model("inst-1", b"\x00\x01binary"))
        assert models.get("inst-1").models == b"\x00\x01binary"
        models.insert(Model("inst-1", b"replaced"))
        assert models.get("inst-1").models == b"replaced"
        models.delete("inst-1")
        assert models.get("inst-1") is None

    def test_verify_all_data_objects(self, backend):
        backend.verify_all_data_objects()


# -- the port alone: the seeded fuzz, the JAX package's SQLite the oracle ----

FUZZ_APP = 3
DURABLE = ["sqlite", "localfs", "segmentfs", "remote", "s3"]


def proj(e):
    return (e.event, e.entity_type, e.entity_id, e.target_entity_type,
            e.target_entity_id, e.event_time_millis,
            tuple(sorted(e.properties.to_dict().items())))


def rand_event(rng, k, with_id=None):
    """A JAX-package event from the JAX fuzz's recipe (unique millisecond
    times: ordering ties are out of contract)."""
    etype = "user" if rng.random() < 0.7 else "item"
    name = rng.choice(["rate", "view", "$set", "buy"])
    props = {}
    if name == "rate":
        props["rating"] = float(rng.integers(1, 6))
    if name == "$set":
        props["cat"] = f"c{int(rng.integers(0, 3))}"
        if rng.random() < 0.3:
            props["score"] = float(rng.integers(0, 100))
    has_target = name in ("rate", "view", "buy")
    return jev.Event(
        event=str(name), entity_type=etype,
        entity_id=f"{etype[0]}{int(rng.integers(0, 12))}",
        target_entity_type="item" if has_target else None,
        target_entity_id=(f"i{int(rng.integers(0, 8))}"
                          if has_target else None),
        properties=JDataMap(props),
        event_time=T0 + timedelta(milliseconds=int(k)),
        event_id=with_id)


def to_port(e) -> pev.Event:
    return pev.Event.from_json(e.to_json())


def jfilter(f: EventFilter):
    return jbase.EventFilter(
        start_time=f.start_time, until_time=f.until_time,
        entity_type=f.entity_type, event_names=f.event_names,
        target_entity_type=(jbase.ANY if f.target_entity_type is ANY
                            else f.target_entity_type),
        limit=f.limit, reversed=f.reversed)


def compare(oracle, dut, channel=None):
    a = sorted(proj(e) for e in oracle.find(FUZZ_APP, channel))
    assert a == sorted(proj(e) for e in dut.find(FUZZ_APP, channel))
    assert a == sorted(proj(e) for e in
                       dut.find_columnar(FUZZ_APP, channel).to_events())
    for f in (EventFilter(event_names=["rate", "$set"],
                          start_time=T0 + timedelta(milliseconds=40),
                          target_entity_type=ANY),
              EventFilter(entity_type="user", target_entity_type=None)):
        assert sorted(proj(e) for e in oracle.find(FUZZ_APP, channel,
                                                   jfilter(f))) == \
            sorted(proj(e) for e in dut.find(FUZZ_APP, channel, f))
    f3 = EventFilter(reversed=True, limit=7)
    ra = [proj(e) for e in oracle.find(FUZZ_APP, channel, jfilter(f3))]
    assert ra == [proj(e) for e in dut.find(FUZZ_APP, channel, f3)]
    assert ra == [proj(e) for e in dut.find_columnar(
        FUZZ_APP, channel, f3).to_events()]
    for etype in ("user", "item"):
        pa = oracle.aggregate_properties(FUZZ_APP, channel,
                                         entity_type=etype)
        pb = dut.aggregate_properties(FUZZ_APP, channel, entity_type=etype)
        assert {k: dict(v.to_dict()) for k, v in pa.items()} == \
            {k: dict(v.to_dict()) for k, v in pb.items()}


@pytest.fixture()
def oracle(tmp_path):
    client = JSQLiteClient(str(tmp_path / "oracle.db"))
    yield JSQLiteEventStore(client)
    client.close()


@pytest.fixture(params=DURABLE)
def dut(request, tmp_path):
    st, closers = open_backend(request.param, tmp_path)
    yield st.events()
    st.close()
    for close in closers:
        close()


@pytest.mark.parametrize("seed", [1, 2])
def test_random_op_sequence_matches_the_jax_sqlite_oracle(oracle, dut,
                                                          seed):
    rng = np.random.default_rng(seed)
    oracle.init(FUZZ_APP)
    dut.init(FUZZ_APP)
    known: list = []
    k = 0
    for _ in range(4):
        ops = []
        for _ in range(40):
            r = rng.random()
            if r < 0.55 or not known:
                ops.append(("insert", None))
            elif r < 0.7:
                ops.append(("replace", known[int(rng.integers(0,
                                                              len(known)))]))
            else:
                ops.append(("delete", known[int(rng.integers(0,
                                                             len(known)))]))
        for op, eid in ops:
            if op == "insert":
                batch = [rand_event(rng, k + j)
                         for j in range(int(rng.integers(1, 4)))]
                k += len(batch)
                ids = oracle.insert_batch([e.copy() for e in batch],
                                          FUZZ_APP)
                for e, i in zip(batch, ids):
                    dut.insert(to_port(e.copy(event_id=i)), FUZZ_APP)
                known.extend(ids)
            elif op == "replace":
                e = rand_event(rng, k, with_id=eid)
                k += 1
                oracle.insert(e.copy(), FUZZ_APP)
                dut.insert(to_port(e), FUZZ_APP)
            else:
                ra = oracle.delete(eid, FUZZ_APP)
                assert dut.delete(eid, FUZZ_APP) == ra
                if ra and eid in known:
                    known.remove(eid)
        compare(oracle, dut)


def test_channel_partitions_stay_isolated(oracle, dut):
    rng = np.random.default_rng(11)
    chans = [None, 0, 1, 2]
    for c in chans:
        oracle.init(FUZZ_APP, c)
        dut.init(FUZZ_APP, c)
    for k in range(90):
        c = chans[int(rng.integers(0, 3))]
        e = rand_event(rng, k)
        i = oracle.insert(e.copy(), FUZZ_APP, c)
        dut.insert(to_port(e.copy(event_id=i)), FUZZ_APP, c)
    for c in chans:
        compare(oracle, dut, c)


# -- the port alone: kill the writer mid-batch --------------------------------

BATCH = 40
ROUNDS = 6

WRITER = textwrap.dedent("""
    import json, os, sys

    kind, where, ack_path = sys.argv[1], sys.argv[2], sys.argv[3]
    start_batch, BATCH = int(sys.argv[4]), int(sys.argv[5])

    from predictionio_tpu_torch.data.datamap import DataMap
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage.registry import Storage

    key = "ENDPOINT" if kind == "S3" else "PATH"
    es = Storage(env={"PIO_STORAGE_SOURCES_X_TYPE": kind,
                      f"PIO_STORAGE_SOURCES_X_{key}": where}).events()
    es.init(1)
    ack = open(ack_path, "a")
    k = start_batch
    print("READY", flush=True)
    while True:
        evs = [Event(event="rate", entity_type="user",
                     entity_id=f"b{k}e{j}",
                     target_entity_type="item", target_entity_id=f"i{j}",
                     properties=DataMap({"rating": float(j % 5 + 1)}))
               for j in range(BATCH)]
        es.insert_batch(evs, 1)
        ack.write(f"{k}\\n")
        ack.flush()
        os.fsync(ack.fileno())
        k += 1
""")


def oracle_check(events, acked: set) -> None:
    """Every acknowledged batch whole, any other batch whole or absent,
    no duplicates."""
    per_batch: dict = {}
    seen = set()
    for e in events:
        assert e.entity_id not in seen, f"duplicate {e.entity_id}"
        seen.add(e.entity_id)
        b, j = e.entity_id[1:].split("e")
        per_batch.setdefault(int(b), set()).add(int(j))
    for k in acked:
        assert len(per_batch.get(k, ())) == BATCH, f"acked batch {k} torn"
    for k, got in per_batch.items():
        assert len(got) in (0, BATCH), f"unacked batch {k} torn"


def kill_rounds(kind: str, where: str, tmp_path, seed: int) -> None:
    rng = np.random.default_rng(seed)
    ack_path = tmp_path / "acks.log"
    ack_path.touch()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + env.get("PYTHONPATH", "").split(os.pathsep))
    writer_py = tmp_path / "writer.py"
    writer_py.write_text(WRITER)
    key = "ENDPOINT" if kind == "S3" else "PATH"
    next_batch = 0
    for rnd in range(ROUNDS):
        p = subprocess.Popen(
            [sys.executable, str(writer_py), kind, where, str(ack_path),
             str(next_batch), str(BATCH)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        assert p.stdout.readline().strip() == "READY"
        time.sleep(float(rng.uniform(0.02, 0.4)))
        p.send_signal(signal.SIGKILL)
        p.wait(timeout=30)
        p.stdout.close()
        acked = {int(x) for x in ack_path.read_text().split() if x.strip()}
        st = PStorage(env={"PIO_STORAGE_SOURCES_X_TYPE": kind,
                           f"PIO_STORAGE_SOURCES_X_{key}": where})
        oracle_check(list(st.events().find(1)), acked)
        # the store takes writes after the crash (probe ids apart)
        probe = 10_000_000 + rnd
        st.events().insert_batch(
            [pev.Event(event="rate", entity_type="user",
                       entity_id=f"b{probe}e{j}", target_entity_type="item",
                       target_entity_id=f"i{j}",
                       properties=DataMap({"rating": 1.0}))
             for j in range(BATCH)], 1)
        with open(ack_path, "a") as f:
            f.write(f"{probe}\n")
        next_batch = max((b for b in acked if b < 10_000_000),
                         default=0) + 1000
        st.close()


@pytest.mark.parametrize("backend", ["localfs", "segmentfs"])
def test_kill_writer_midbatch(backend, tmp_path):
    kill_rounds(backend.upper(), str(tmp_path / "store"), tmp_path,
                seed=zlib.crc32(backend.encode()))


def test_kill_writer_midbatch_objectstore(tmp_path):
    srv = FakeObjectStoreServer(str(tmp_path / "bucket")).start_background()
    try:
        kill_rounds("S3", f"http://127.0.0.1:{srv.port}/bucket", tmp_path,
                    seed=zlib.crc32(b"s3"))
    finally:
        srv.shutdown()
