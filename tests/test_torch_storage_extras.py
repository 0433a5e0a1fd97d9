"""The SQLite extras, the cleaning data source, the entity map and the
batch views of the port, held to the JAX package's.

A legacy table from before the ``seq`` column, made with raw SQL,
migrates to the same rows in both packages. The sidecar's first encode,
forked into worker processes by a process that has imported torch, gives
the columns the in-process encode gives. ``SelfCleaningDataSource`` and
``EventWindow`` clean as the JAX package's does (the cleaning half of
``tests/test_fast_eval_cleaning.py``); ``EntityIdIxMap``, ``EntityMap``,
``extract_entity_map``, ``EventSeq`` and ``BatchView`` answer as the JAX
package's do.
"""

import json
import os
import shutil
import sqlite3
import subprocess
import sys
import textwrap
import warnings
from datetime import datetime, timedelta, timezone
from pathlib import Path

import numpy as np
import pytest

import predictionio_tpu.controller as jctl
import predictionio_tpu.data.entitymap as jem
import predictionio_tpu.data.view as jview
from predictionio_tpu.controller.context import Context as JContext
from predictionio_tpu.data.datamap import DataMap as JDataMap
from predictionio_tpu.data.event import Event as JEvent
from predictionio_tpu.data.storage.base import App as JApp
from predictionio_tpu.data.storage.registry import Storage as JStorage
from predictionio_tpu_torch import controller as pctl
from predictionio_tpu_torch.controller.context import Context
from predictionio_tpu_torch.data import entitymap as pem
from predictionio_tpu_torch.data import view as pview
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.data.storage.registry import Storage

ROOT = Path(__file__).resolve().parent.parent
T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
MEM = {"PIO_STORAGE_SOURCES_MEM_TYPE": "memory"}


def sqlite_env(db: str) -> dict:
    return {"PIO_STORAGE_SOURCES_SQ_TYPE": "sqlite",
            "PIO_STORAGE_SOURCES_SQ_PATH": db}


def legacy_db(path: Path, n: int = 40) -> None:
    """A rowid table from before the ``seq`` column, with a deleted row
    (whose rowid SQLite would reuse)."""
    conn = sqlite3.connect(path)
    conn.execute("""
        CREATE TABLE events_1 (
            id TEXT PRIMARY KEY, event TEXT NOT NULL,
            entity_type TEXT NOT NULL, entity_id TEXT NOT NULL,
            target_entity_type TEXT, target_entity_id TEXT,
            properties TEXT, event_time INTEGER NOT NULL,
            tags TEXT, pr_id TEXT, creation_time INTEGER NOT NULL)""")
    rng = np.random.default_rng(2)
    for k in range(n):
        conn.execute(
            "INSERT INTO events_1 VALUES (?,?,?,?,?,?,?,?,?,?,?)",
            (f"e{k}", "rate", "user", f"u{int(rng.integers(0, 6))}", "item",
             f"i{int(rng.integers(0, 5))}",
             json.dumps({"rating": float(rng.integers(1, 6))}),
             1760000000000 + k, "[]", None, 1760000000000))
    conn.execute("DELETE FROM events_1 WHERE id='e39'")
    conn.commit()
    conn.close()


def table_rows(db: Path) -> list:
    conn = sqlite3.connect(db)
    try:
        cols = [r[1] for r in conn.execute("PRAGMA table_info(events_1)")]
        rows = conn.execute(
            "SELECT seq, id, event, entity_id, target_entity_id, "
            "properties, event_time FROM events_1 ORDER BY seq").fetchall()
        names = {r[0] for r in conn.execute(
            "SELECT name FROM sqlite_master WHERE type='table'")}
    finally:
        conn.close()
    return cols, rows, names


def test_a_legacy_table_migrates_alike_in_both_packages(tmp_path):
    out = {}
    for pkg, cls in (("jax", JStorage), ("port", Storage)):
        db = tmp_path / f"{pkg}.db"
        legacy_db(db)
        st = cls(env=sqlite_env(str(db)))
        batch = st.events().find_columnar(1, ordered=True)  # migrates
        assert batch.n == 39
        out[pkg] = (table_rows(db), [e.entity_id for e in batch.to_events()])
        st.close()
    assert out["port"] == out["jax"]
    (cols, rows, names), _ = out["port"]
    assert cols[0] == "seq" and "events_1_legacy" not in names
    assert [r[1] for r in rows] == [f"e{k}" for k in range(39)]
    # init on a legacy table migrates too, and new writes follow
    db = tmp_path / "init.db"
    legacy_db(db, n=5)
    st = Storage(env=sqlite_env(str(db)))
    st.events().init(1)
    st.events().insert(Event(event="buy", entity_type="user",
                             entity_id="u9", target_entity_type="item",
                             target_entity_id="i9", event_time=T0), 1)
    assert len(list(st.events().find(1))) == 6
    st.close()


FORKED = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch  # the parent of the fork has imported torch
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.data.storage.sqlite import SQLiteEventStore

    SQLiteEventStore.ENCODE_SUBCHUNK = 200
    SQLiteEventStore.ENCODE_PARALLEL_MIN = 0
    st = Storage(env={"PIO_STORAGE_SOURCES_SQ_TYPE": "sqlite",
                      "PIO_STORAGE_SOURCES_SQ_PATH": sys.argv[1]})
    es = st.events()
    b = es.find_columnar(1, ordered=False, with_props=False)
    np.savez(sys.argv[2], event=b.event, entity_id=b.entity_id,
             target_id=b.target_id, event_time=b.event_time,
             rating=b.float_prop("rating"),
             users=np.array(b.dicts.entity_ids.values),
             items=np.array(b.dicts.target_ids.values))
    print(json.dumps(dict(es.last_encode, torch="torch" in sys.modules)))
""")


def test_the_forked_first_encode_after_torch_equals_the_in_process(
        tmp_path):
    db = tmp_path / "pio.db"
    st = Storage(env=sqlite_env(str(db)))
    st.events().init(1)
    rng = np.random.default_rng(4)
    st.events().insert_batch([
        Event(event="rate", entity_type="user",
              entity_id=f"u{int(rng.integers(0, 300))}",
              target_entity_type="item",
              target_entity_id=f"i{int(rng.integers(0, 80))}",
              properties=DataMap({"rating": float(rng.integers(1, 11)) / 2}),
              event_time=T0 + timedelta(seconds=k)) for k in range(2300)], 1)
    st.close()
    fork_db = tmp_path / "fork.db"
    shutil.copy(db, fork_db)
    script = tmp_path / "forked.py"
    script.write_text(FORKED)
    proc = subprocess.run(
        [sys.executable, str(script), str(fork_db), str(tmp_path / "f.npz")],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report == {"path": "forked", "workers": min(4, os.cpu_count()),
                      "ranges": 12, "torch": True}
    forked = np.load(tmp_path / "f.npz")

    from predictionio_tpu_torch.data.storage.sqlite import SQLiteEventStore
    st = Storage(env=sqlite_env(str(db)))
    es = st.events()
    es.ENCODE_SUBCHUNK = 200
    es.ENCODE_PARALLEL_MIN = 1 << 40  # in-process
    assert SQLiteEventStore.ENCODE_PARALLEL_MIN == 600_000
    b = es.find_columnar(1, ordered=False, with_props=False)
    assert es.last_encode == {"path": "in-process", "workers": 0,
                              "ranges": 12}
    for col in ("event", "entity_id", "target_id", "event_time"):
        np.testing.assert_array_equal(forked[col], getattr(b, col), col)
    np.testing.assert_array_equal(forked["rating"], b.float_prop("rating"))
    assert list(forked["users"]) == list(b.dicts.entity_ids.values)
    assert list(forked["items"]) == list(b.dicts.target_ids.values)
    st.close()


def test_isoformat_millis_matches_the_jax_package():
    """The port formats event times field by field; the text is the JAX
    package's ``strftime`` text, at every year and offset."""
    import random

    from predictionio_tpu.data.event import isoformat_millis as jiso
    from predictionio_tpu_torch.data.event import isoformat_millis

    rng = random.Random(3)
    zones = [None, timezone.utc, timezone(timedelta(hours=5, minutes=30)),
             timezone(timedelta(hours=-8))]
    for _ in range(5000):
        t = datetime(rng.randint(1, 9998), rng.randint(1, 12),
                     rng.randint(1, 28), rng.randint(0, 23),
                     rng.randint(0, 59), rng.randint(0, 59),
                     rng.randint(0, 999_999), tzinfo=rng.choice(zones))
        assert isoformat_millis(t) == jiso(t), t


RULE_CASES = [
    dict(event=""), dict(entity_type=""), dict(entity_id=""),
    dict(target_entity_type="item"), dict(target_entity_id="i1"),
    dict(target_entity_type="", target_entity_id="i1"),
    dict(event="$foo"), dict(event="$unset"), dict(event="$set"),
    dict(event="$set", target_entity_type="item", target_entity_id="i1"),
    dict(entity_type="pio_x"), dict(entity_type="pio_pr"),
    dict(target_entity_type="pio_y", target_entity_id="i1"),
    dict(target_entity_type="pio_stream", target_entity_id="i1"),
    dict(properties={"pio_z": 1}), dict(properties={"$p": 1}),
    dict(properties={"pio_traceparent": "x", "ok": 2}),
    dict(event="$unset", properties={"a": None}), dict()]


@pytest.mark.parametrize("case", range(len(RULE_CASES)))
def test_event_rules_match_the_jax_package(case):
    """Each validation rule rejects, or accepts, an event alike in both
    packages, with the same message."""
    kw = dict(dict(event="rate", entity_type="user", entity_id="u1"),
              **RULE_CASES[case])
    out = {}
    for pkg, ev, dm in (("jax", JEvent, JDataMap), ("port", Event, DataMap)):
        args = dict(kw, properties=dm(kw.get("properties", {})),
                    event_time=T0)
        try:
            ev(**args)
            out[pkg] = "ok"
        except ValueError as e:
            out[pkg] = (type(e).__name__, str(e))
    assert out["port"] == out["jax"]


# -- cleaning -----------------------------------------------------------------

def pair_events(specs):
    """The same events in each package."""
    out = {"jax": [], "port": []}
    for event, eid, t, props, kw in specs:
        out["jax"].append(JEvent(event=event, entity_type="user",
                                 entity_id=eid,
                                 properties=JDataMap(props or {}),
                                 event_time=t, **kw))
        out["port"].append(Event(event=event, entity_type="user",
                                 entity_id=eid,
                                 properties=DataMap(props or {}),
                                 event_time=t, **kw))
    return out


def cleaner(pkg, window):
    ctl = jctl if pkg == "jax" else pctl

    class CleaningDS(ctl.SelfCleaningDataSource):
        app_name = "cleanapp"

        @property
        def event_window(self):
            return window

    return CleaningDS()


def proj(events):
    return [(e.event, e.entity_id, e.event_id, e.event_time.isoformat(),
             e.properties.to_dict()) for e in events]


NOW = T0 + timedelta(days=10)
CASES = {
    "window": (dict(duration="2 days"), [
        ("view", "u1", T0, None, {}),
        ("$set", "u1", T0, {"a": 1}, {}),
        ("view", "u2", NOW - timedelta(hours=1), None, {})]),
    "compress": (dict(compress_properties=True), [
        ("$set", "u1", T0, {"a": 1, "b": 2}, {}),
        ("$set", "u1", T0 + timedelta(minutes=1), {"b": 3}, {}),
        ("$unset", "u1", T0 + timedelta(minutes=2), {"a": 0}, {}),
        ("view", "u1", T0 + timedelta(minutes=3), None, {}),
        ("$set", "u2", T0, {"z": 9}, {})]),
    "dedup": (dict(remove_duplicates=True), [
        ("view", "u1", T0 + timedelta(minutes=5), None,
         {"event_id": "late"}),
        ("view", "u1", T0, None, {"event_id": "early"}),
        ("view", "u2", T0, None, {})]),
    "all": (dict(duration="3 days", compress_properties=True,
                 remove_duplicates=True), [
        ("$set", "u1", T0, {"a": 1}, {}),
        ("$set", "u1", NOW - timedelta(days=1), {"a": 2}, {}),
        ("view", "u1", NOW - timedelta(hours=5), None, {"event_id": "v1"}),
        ("view", "u1", NOW - timedelta(hours=4), None, {"event_id": "v2"}),
        ("buy", "u3", T0, None, {})]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cleaning_matches_the_jax_package(case):
    kw, specs = CASES[case]
    events = pair_events(specs)
    got = {pkg: proj(cleaner(pkg, (jctl if pkg == "jax" else pctl)
                             .EventWindow(**kw)).clean_events(events[pkg],
                                                              now=NOW))
           for pkg in events}
    assert got["port"] == got["jax"]
    assert got["port"]


def test_parse_duration_matches():
    from predictionio_tpu.controller.cleaning import parse_duration as jpd
    from predictionio_tpu_torch.controller.cleaning import parse_duration

    for s in ("2 days", "1 week", "90", "3.5 hours", "1 minute"):
        assert parse_duration(s) == jpd(s)
    with pytest.raises(ValueError):
        parse_duration("3 fortnights")


def test_clean_persisted_events_rewrites_alike():
    specs = [("$set", "u1", T0, {"a": 1}, {}),
             ("$set", "u1", T0 + timedelta(minutes=1), {"a": 2}, {}),
             ("view", "u1", T0 + timedelta(minutes=2), None, {}),
             ("view", "u1", T0 + timedelta(minutes=2), None, {})]
    events = pair_events(specs)
    left = {}
    for pkg, st_cls, app_cls, ctx_cls in (
            ("jax", JStorage, JApp, JContext),
            ("port", Storage, App, Context)):
        st = st_cls(env=MEM)
        app_id = st.apps().insert(app_cls(0, "cleanapp"))
        st.events().init(app_id)
        st.events().insert_batch(events[pkg], app_id)
        ctx = ctx_cls(app_name="cleanapp", _storage=st)
        ctl = jctl if pkg == "jax" else pctl
        removed = cleaner(pkg, ctl.EventWindow(
            remove_duplicates=True,
            compress_properties=True)).clean_persisted_events(ctx)
        rest = sorted((e.event, e.entity_id, e.event_time.isoformat(),
                       json.dumps(e.properties.to_dict()))
                      for e in ctx.event_store.find("cleanapp"))
        left[pkg] = (removed, rest)
    assert left["port"] == left["jax"]
    assert left["port"][0] >= 2 and len(left["port"][1]) == 2


# -- the entity map and the batch views ---------------------------------------

def test_entity_id_ix_map_matches():
    keys = ["a", "b", "c"]
    p, j = pem.EntityIdIxMap.from_keys(keys), jem.EntityIdIxMap.from_keys(keys)
    for k in ("a", "c", 0, 2):
        assert p[k] == j[k]
    assert ("b" in p, 1 in p, "zz" in p) == ("b" in j, 1 in j, "zz" in j)
    assert p.get("zz") is None and len(p) == len(j) == 3
    assert p.take(2).to_map() == j.take(2).to_map() == {"a": 0, "b": 1}
    em, jm = (m.EntityMap({"u1": {"age": 30}, "u2": {"age": 40},
                           "u3": {"age": 9}}) for m in (pem, jem))
    assert em.data("u1") == jm.data("u1") and em.data(1) == jm.data(1)
    sub = em.take(2)
    assert isinstance(sub, pem.EntityMap)
    assert sub.id_to_data == jm.take(2).id_to_data


def seeded(pkg):
    st_cls, app_cls, ctx_cls, ev, dm = (
        (JStorage, JApp, JContext, JEvent, JDataMap) if pkg == "jax"
        else (Storage, App, Context, Event, DataMap))
    st = st_cls(env=MEM)
    app_id = st.apps().insert(app_cls(0, "viewapp"))
    st.events().init(app_id)
    st.events().insert_batch([
        ev(event="$set", entity_type="user", entity_id="u1",
           properties=dm({"a": 1, "b": 2}), event_time=T0),
        ev(event="$unset", entity_type="user", entity_id="u1",
           properties=dm({"b": None}), event_time=T0 + timedelta(hours=1)),
        ev(event="$set", entity_type="user", entity_id="u2",
           properties=dm({"a": 5}), event_time=T0),
        ev(event="$delete", entity_type="user", entity_id="u2",
           event_time=T0 + timedelta(hours=2)),
        ev(event="view", entity_type="user", entity_id="u1",
           target_entity_type="item", target_entity_id="i1",
           event_time=T0 + timedelta(hours=3)),
        ev(event="$set", entity_type="item", entity_id="i1",
           properties=dm({"price": 9.5}), event_time=T0),
        ev(event="$set", entity_type="item", entity_id="i2",
           properties=dm({"price": 3.0}), event_time=T0),
    ], app_id)
    return ctx_cls(app_name="viewapp", _storage=st)


def test_extract_entity_map_matches():
    got = {}
    for pkg, m in (("jax", jem), ("port", pem)):
        em = m.extract_entity_map(seeded(pkg).event_store, "viewapp",
                                  "item", lambda pm: float(pm.get("price")))
        got[pkg] = (em.to_map(), em.id_to_data, em.data(em["i2"]))
    assert got["port"] == got["jax"]
    assert got["port"][2] == 3.0


def test_views_match():
    got = {}
    for pkg, m in (("jax", jview), ("port", pview)):
        ctx = seeded(pkg)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            view = m.BatchView(ctx, "viewapp")
        seq = m.EventSeq(ctx.event_store.find("viewapp"))
        got[pkg] = (
            {k: v.to_dict() for k, v in
             view.aggregate_properties("user").items()},
            len(seq.filter(event="view")),
            len(seq.filter(entity_type="user")),
            len(seq.filter(start_time=T0 + timedelta(hours=1))),
            seq.aggregate_by_entity_ordered(0, lambda acc, e: acc + 1))
    assert got["port"] == got["jax"]
    assert got["port"][0] == {"u1": {"a": 1}}
    with pytest.warns(DeprecationWarning):
        pview.BatchView(seeded("port"), "viewapp")
