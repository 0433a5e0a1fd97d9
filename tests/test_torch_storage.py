"""The port's storage against the JAX package's, on one SQLite file.

One package writes events (``insert_batch`` and the columnar block lane
``insert_columnar``) and metadata into ``$PIO_HOME/pio.db``; the other
reads the same file. ``find``, ``find_columnar`` (whichever package built
the columnar sidecar) and ``ratings_from_columnar`` must give identical
events, arrays and ``BiMap``s, in both directions. Then the port alone:
all-or-nothing batches and the metadata DAOs on every backend of its
registry (MEMORY, SQLITE, LOCALFS, SEGMENTFS, REMOTE in front of a
storage server, S3 on an in-process bucket), and the registry's refusal
of an unknown type.
"""

from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

import predictionio_tpu.data.columnar as jcol
import predictionio_tpu.data.event as jev
import predictionio_tpu.data.storage.base as jbase
import predictionio_tpu.data.storage.wire as jwire
import predictionio_tpu.models.data as jdata
from predictionio_tpu.data.storage.registry import Storage as JStorage
from predictionio_tpu_torch.data import columnar as pcol
from predictionio_tpu_torch.data import event as pev
from predictionio_tpu_torch.data.storage import base as pbase
from predictionio_tpu_torch.data.storage import wire as pwire
from predictionio_tpu_torch.data.storage.registry import Storage as PStorage
from predictionio_tpu_torch.models import data as pdata

T0 = datetime(2024, 1, 1, tzinfo=timezone.utc)
PKG = {"jax": (jev, jcol, jbase, JStorage, jdata, jwire),
       "port": (pev, pcol, pbase, PStorage, pdata, pwire)}


def event_dicts(n=120, seed=0, offset=0):
    """API-format events: rate with a rating, buy, a rate without a
    rating, a $set without a target, and a view the reads skip."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        kind = ("rate", "rate", "buy", "view", "$set", "rate-bare")[k % 6]
        e = {"event": kind.split("-")[0], "entityType": "user",
             "entityId": f"u{int(rng.integers(0, 15))}",
             "eventTime": (T0 + timedelta(seconds=offset + k)).isoformat(),
             "creationTime": T0.isoformat()}
        if kind != "$set":
            e.update(targetEntityType="item",
                     targetEntityId=f"i{int(rng.integers(0, 12))}")
        if kind == "rate":
            e["properties"] = {"rating": float(rng.integers(1, 11)) / 2}
        elif kind == "$set":
            e["properties"] = {"age": int(rng.integers(18, 80))}
        out.append(e)
    return out


def write(pkg, storage, dicts, app_id):
    """First half through insert_batch, second through insert_columnar."""
    ev, col = PKG[pkg][0], PKG[pkg][1]
    events = [ev.Event.from_json(d) for d in dicts]
    half = len(events) // 2
    store = storage.events()
    store.init(app_id)
    store.insert_batch(events[:half], app_id)
    assert store.insert_columnar(col.columnar_from_events(events[half:]),
                                 app_id) == len(events) - half


def storages(tmp_path):
    env = {"PIO_HOME": str(tmp_path)}
    return {"jax": JStorage(env=env), "port": PStorage(env=env)}


def assert_same_batch(a, b):
    for col in ("event", "entity_type", "entity_id", "target_type",
                "target_id", "event_time", "props_offsets", "props_blob"):
        np.testing.assert_array_equal(np.asarray(getattr(a, col)),
                                      np.asarray(getattr(b, col)), col)
    for name in ("event_names", "entity_types", "entity_ids",
                 "target_types", "target_ids"):
        assert getattr(a.dicts, name).values == getattr(b.dicts, name).values
    np.testing.assert_array_equal(a.float_prop("rating"),
                                  b.float_prop("rating"))


def assert_same_ratings(a, b):
    (ra, ua, ia), (rb, ub, ib) = a, b
    for f in ("users", "items", "ratings"):
        x, y = getattr(ra, f), getattr(rb, f)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert (ra.n_users, ra.n_items) == (rb.n_users, rb.n_items)
    assert ua.to_dict() == ub.to_dict() and ia.to_dict() == ib.to_dict()


def columnar(pkg, storage, app_id, ordered, with_props):
    base = PKG[pkg][2]
    filt = base.EventFilter(entity_type="user", target_entity_type="item",
                            event_names=["rate", "buy"]) \
        if not with_props else base.EventFilter()
    return storage.events().find_columnar(app_id, None, filt,
                                          ordered=ordered,
                                          with_props=with_props)


@pytest.mark.parametrize("writer,first_reader", [
    ("jax", "jax"), ("jax", "port"), ("port", "port"), ("port", "jax")],
    ids=["jax-writes-jax-sidecar", "jax-writes-port-sidecar",
         "port-writes-port-sidecar", "port-writes-jax-sidecar"])
def test_one_file_reads_alike(tmp_path, writer, first_reader):
    st = storages(tmp_path)
    write(writer, st[writer], event_dicts(), app_id=1)
    other = "port" if first_reader == "jax" else "jax"
    try:
        for ordered, with_props in ((False, False), (True, True)):
            got = {}
            for pkg in (first_reader, other):
                got[pkg] = columnar(pkg, st[pkg], 1, ordered, with_props)
            assert got["jax"].n > 0
            assert_same_batch(got["jax"], got["port"])
        # the other package appends; the sidecar syncs the delta
        write(other, st[other], event_dicts(30, seed=1, offset=500),
              app_id=1)
        batches = {pkg: columnar(pkg, st[pkg], 1, False, False)
                   for pkg in (first_reader, other)}
        assert_same_batch(batches["jax"], batches["port"])
        ratings = {pkg: PKG[pkg][4].ratings_from_columnar(batches[pkg])
                   for pkg in batches}
        assert ratings["port"][0].users.size > 0
        assert_same_ratings(ratings["jax"], ratings["port"])
        finds = {pkg: [e.to_json() for e in st[pkg].events().find(1)]
                 for pkg in st}
        assert len(finds["jax"]) == 150 and finds["jax"] == finds["port"]
        filt = {pkg: PKG[pkg][2].EventFilter(
            entity_id="u3", event_names=["rate"], limit=4, reversed=True)
            for pkg in st}
        assert ([e.to_json() for e in st["jax"].events().find(
            1, None, filt["jax"])] == [e.to_json() for e in st[
                "port"].events().find(1, None, filt["port"])])
    finally:
        for s in st.values():
            s.close()


def test_ratings_equal_the_row_path(tmp_path):
    """``ratings_from_events`` and ``ratings_from_columnar`` agree, as in
    the JAX package, and equal the JAX package's row path."""
    st = storages(tmp_path)
    write("port", st["port"], event_dicts(), app_id=1)
    try:
        p_rows = pdata.ratings_from_events(st["port"].events().find(1))
        j_rows = jdata.ratings_from_events(st["jax"].events().find(1))
        assert_same_ratings(j_rows, p_rows)
        assert p_rows[0].users.size == pdata.ratings_from_columnar(
            columnar("port", st["port"], 1, False, False))[0].users.size
    finally:
        for s in st.values():
            s.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_metadata_reads_alike(tmp_path, writer):
    st = storages(tmp_path)
    reader = "port" if writer == "jax" else "jax"
    b = PKG[writer][2]
    w = st[writer]
    try:
        app_id = w.apps().insert(b.App(0, "shop", "a shop"))
        key = w.access_keys().insert(b.AccessKey("", app_id, ("rate",)))
        for k, status in enumerate(("COMPLETED", "COMPLETED", "INIT")):
            w.engine_instances().insert(b.EngineInstance(
                id=f"ei{k}", status=status,
                start_time=T0 + timedelta(minutes=k), end_time=T0,
                engine_id="rec", engine_version="1",
                engine_variant="engine.json", engine_factory="f",
                algorithms_params='[{"als": {}}]'))
        w.models().insert(b.Model("ei1", b"blob"))
        r = st[reader]
        assert r.apps().get_by_name("shop").id == app_id
        assert r.apps().get(app_id).description == "a shop"
        got = r.access_keys().get(key)
        assert (got.app_id, tuple(got.events)) == (app_id, ("rate",))
        latest = r.engine_instances().get_latest_completed(
            "rec", "1", "engine.json")
        assert latest.id == "ei1" and latest.status == "COMPLETED"
        assert latest.algorithms_params == '[{"als": {}}]'
        assert r.models().get("ei1").models == b"blob"
    finally:
        for s in st.values():
            s.close()


@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_npz_wire_round_trips_between_packages(direction):
    src, dst = direction.split("-to-")
    ev, col, *_ = PKG[src]
    batch = col.columnar_from_events(
        [ev.Event.from_json(d) for d in event_dicts(24)])
    back = PKG[dst][5].batch_from_npz(PKG[src][5].batch_to_npz(batch))
    assert_same_batch(batch, back)


def test_bulk_factorize_matches_the_jax_package():
    values = [b"a", None, b"c", b"a", None, b"b", b"c"]
    jc, ju = jcol.bulk_factorize(values)
    pc, pu = pcol.bulk_factorize(values)
    np.testing.assert_array_equal(jc, pc)
    assert list(ju) == list(pu)
    vals = [1, 2.5, None, "4", True]
    np.testing.assert_array_equal(jcol.bulk_to_float64(vals),
                                  pcol.bulk_to_float64(vals))


# -- the port alone ---------------------------------------------------------

@pytest.fixture(params=["MEMORY", "SQLITE", "LOCALFS", "SEGMENTFS",
                        "REMOTE", "S3"])
def store(request, tmp_path):
    from predictionio_tpu_torch.data.storage.objectstore import (
        FakeObjectStoreServer,
    )
    from predictionio_tpu_torch.server.storageserver import (
        create_storage_server,
    )

    kind, closers = request.param, []
    if kind == "MEMORY":
        env = {"PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"}
    elif kind == "SQLITE":
        env = {"PIO_HOME": str(tmp_path)}
    elif kind in ("LOCALFS", "SEGMENTFS"):
        env = {"PIO_STORAGE_SOURCES_X_TYPE": kind,
               "PIO_STORAGE_SOURCES_X_PATH": str(tmp_path / "fs")}
    elif kind == "REMOTE":
        backing = PStorage(env={"PIO_HOME": str(tmp_path / "backing")})
        srv = create_storage_server(backing, host="127.0.0.1", port=0)
        srv.start_background()
        closers = [srv.close, backing.close]
        env = {"PIO_STORAGE_SOURCES_X_TYPE": "REMOTE",
               "PIO_STORAGE_SOURCES_X_URL": f"http://127.0.0.1:{srv.port}"}
    else:
        bucket = FakeObjectStoreServer(str(tmp_path / "bucket"))
        bucket.start_background()
        closers = [bucket.shutdown]
        env = {"PIO_STORAGE_SOURCES_X_TYPE": "S3",
               "PIO_STORAGE_SOURCES_X_ENDPOINT":
                   f"http://127.0.0.1:{bucket.port}/bucket"}
    s = PStorage(env=env)
    s.kind = kind
    yield s
    s.close()
    for close in closers:
        close()


def port_events(n, seed=0):
    return [pev.Event.from_json(d) for d in event_dicts(n, seed)]


def poison(store, monkeypatch, events):
    """Make the batch fail on its last event: SQLite (and REMOTE, whose
    server writes to SQLite) on a NOT NULL column inside its one
    transaction, the file and bucket backends on a property JSON cannot
    encode before their one write, the memory backend on the third
    insert of the default (compensating) ``insert_batch``."""
    if store.kind in ("SQLITE", "REMOTE"):
        object.__setattr__(events[-1], "event", None)
        return
    if store.kind in ("LOCALFS", "SEGMENTFS", "S3"):
        object.__setattr__(events[-1], "properties",
                           pev.DataMap({"x": object()}))
        return
    ev = store.events()
    real, calls = ev.insert, []

    def insert(e, app_id, channel_id=None):
        calls.append(e)
        if len(calls) == len(events):
            raise RuntimeError("poison")
        return real(e, app_id, channel_id)

    monkeypatch.setattr(ev, "insert", insert)


def test_insert_batch_is_all_or_nothing(store, monkeypatch):
    ev = store.events()
    ev.init(1)
    kept = port_events(4)
    ids = ev.insert_batch(kept, 1)
    before = sorted((e.event_id, e.to_json()["eventTime"])
                    for e in ev.find(1))
    # the batch replaces an existing event, adds one, then fails
    replaced = kept[0].copy(event_id=ids[0], entity_id="u-replaced")
    batch = [replaced, port_events(1, seed=3)[0], port_events(1, seed=4)[0]]
    poison(store, monkeypatch, batch)
    with pytest.raises(Exception):
        ev.insert_batch(batch, 1)
    monkeypatch.undo()
    after = sorted((e.event_id, e.to_json()["eventTime"])
                   for e in ev.find(1))
    assert after == before
    assert ev.get(ids[0], 1).entity_id == kept[0].entity_id


def test_insert_columnar_writes_fresh_ids(store):
    ev = store.events()
    events = port_events(12)
    assert ev.insert_columnar(pcol.columnar_from_events(events), 1) == 12
    got = list(ev.find(1))
    assert len({e.event_id for e in got}) == 12
    strip = [{k: v for k, v in e.to_json().items()
              if k not in ("eventId", "creationTime")} for e in got]
    want = [{k: v for k, v in e.to_json().items() if k != "creationTime"}
            for e in events]
    assert strip == want
    assert ev.delete(got[0].event_id, 1) and ev.get(got[0].event_id, 1) is None


def test_metadata_daos(store):
    apps, keys = store.apps(), store.access_keys()
    app_id = apps.insert(pbase.App(0, "a"))
    assert apps.insert(pbase.App(0, "a")) is None
    key = keys.insert(pbase.AccessKey("", app_id))
    assert key and keys.get(key).app_id == app_id
    assert [k.key for k in keys.get_by_app_id(app_id)] == [key]
    inst = store.engine_instances()
    assert inst.get_latest_completed("e", "1", "v") is None
    for k in range(3):
        inst.insert(pbase.EngineInstance(
            id=f"i{k}", status="COMPLETED" if k < 2 else "INIT",
            start_time=T0 + timedelta(hours=k), end_time=T0,
            engine_id="e", engine_version="1", engine_variant="v",
            engine_factory=""))
    assert inst.get_latest_completed("e", "1", "v").id == "i1"
    store.models().insert(pbase.Model("i1", b"\x00\x01"))
    assert store.models().get("i1").models == b"\x00\x01"


def test_columnar_read_of_the_port_alone(store):
    ev = store.events()
    ev.init(1)
    ev.insert_batch(port_events(60), 1)
    b = ev.find_columnar(1, None, pbase.EventFilter(event_names=["rate"]),
                         ordered=True)
    assert b.n == 30 and np.all(np.diff(b.event_time) >= 0)
    ratings, users, items = pdata.ratings_from_columnar(
        ev.find_columnar(1, ordered=False, with_props=False))
    # 20 rates with a rating and 10 buys; the 10 bare rates drop out
    assert ratings.users.size == 30
    # a sharded read is the JAX package's shard of the same projection
    # (row ranges of the unfiltered storage order, the filter within),
    # row for row, and the shards together are the filtered read
    jfull = jwire.batch_from_npz(pwire.batch_to_npz(
        ev.find_columnar(1, ordered=False)))
    rates = ev.find_columnar(
        1, filter=pbase.EventFilter(event_names=["rate"]), ordered=False)
    parts = []
    for i in range(3):
        got = ev.find_columnar(
            1, filter=pbase.EventFilter(event_names=["rate"]),
            ordered=False, shard=(i, 3))
        want = jbase.EventStore._shard_and_select(
            jfull, (i, 3), jbase.EventFilter(event_names=["rate"]),
            ordered=False, with_props=True)
        assert_same_batch(got, want)
        assert (got.shard_offset, got.shard_total) == \
            (want.shard_offset, want.shard_total)
        parts.append(got)
    def decoded(b):
        d = b.dicts
        return list(zip(d.event_names.decode(b.event),
                        d.entity_ids.decode(b.entity_id),
                        d.target_ids.decode(b.target_id),
                        b.event_time.tolist()))

    assert sum((decoded(b) for b in parts), []) == decoded(rates)
    with pytest.raises(ValueError, match="shard 2 of 2"):
        ev.find_columnar(1, shard=(2, 2))


def test_an_unknown_backend_type_raises():
    s = PStorage(env={"PIO_STORAGE_SOURCES_X_TYPE": "CASSANDRA"})
    with pytest.raises(pbase.StorageError, match="unknown storage type"):
        s.events()


def test_registry_default_is_sqlite_under_pio_home(tmp_path):
    s = PStorage(env={"PIO_HOME": str(tmp_path)})
    s.events().init(1)
    assert s.events().client.path == str(tmp_path / "pio.db")
    assert (tmp_path / "pio.db").exists()
    s.close()
    with pytest.raises(pbase.StorageError, match="undefined source"):
        PStorage(env={"PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "NOPE"})
