"""Streaming fold-in of the port held to the JAX package's, on the CPU.

Each primitive runs in both packages on the same numpy inputs (the JAX
package under ``JAX_PLATFORMS=cpu``, the port's plain versions on torch
CPU tensors): ``dedupe_pairs`` gives equal arrays; ``fold_in_rows`` rows
agree within rtol 1e-4, atol 1e-5 (f32 sums in another order);
``apply_row_updates`` re-quantizes int8 rows bit for bit;
``extend_factor_rows`` claims and grows alike; ``fold_in_events`` on one
SQLite ``pio.db`` that both packages read gives the same report and
rows; the cursor and the drift monitor behave alike. Then the port's
:class:`StreamTrainer` on a storage-backed ``deploy(..., device="cpu")``,
its HTTP routes and its shutdown.
"""

import json
import threading
import time
import urllib.error
import urllib.request
from datetime import datetime, timedelta, timezone

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import predictionio_tpu.models.als as jals
import predictionio_tpu.streaming as jstream
from predictionio_tpu.data.bimap import BiMap as JBiMap
from predictionio_tpu.data.datamap import DataMap as JDataMap
from predictionio_tpu.data.event import Event as JEvent
from predictionio_tpu.data.storage.registry import Storage as JStorage
from predictionio_tpu_torch import cli
from predictionio_tpu_torch.cache.bus import InvalidationBus
from predictionio_tpu_torch.controller.context import Context
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.base import AccessKey, App
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.models import als
from predictionio_tpu_torch.models.convert import als_model_from_numpy
from predictionio_tpu_torch.ops.fused_gram import gram_plan
from predictionio_tpu_torch.ops.fused_topk import topk_plan
from predictionio_tpu_torch.ops.solve import solve_plan
from predictionio_tpu_torch.server import engineserver as es
from predictionio_tpu_torch.server.eventserver import create_event_server
from predictionio_tpu_torch.streaming import (
    CURSOR_ENTITY_TYPE,
    DriftMonitor,
    EventCursor,
    StreamConfig,
    StreamTrainer,
    fold_in_events,
    project_ratings,
)
from predictionio_tpu_torch.streaming import foldin as pfoldin
from predictionio_tpu_torch.templates.recommendation import (
    recommendation_engine,
)
from predictionio_tpu_torch.workflow.core import run_train

T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
RANK = 8
APP = "mlapp"
#: the port's rows against the JAX package's: f32 sums in another order
RTOL, ATOL = 1e-4, 1e-5

_LOCAL = urllib.request.build_opener(urllib.request.ProxyHandler({}))


# -- models in both packages from one set of numpy arrays ------------------

def tables(n_users=10, n_items=20, pad_users=3, pad_items=4, seed=0):
    """Factor tables with zero padding rows past the real counts, as
    training pads them."""
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(n_users + pad_users, RANK)).astype(np.float32)
    V = rng.normal(size=(n_items + pad_items, RANK)).astype(np.float32)
    U[n_users:] = 0
    V[n_items:] = 0
    return U, V


def params_kw(implicit=False, **kw):
    return {**dict(rank=RANK, reg=0.1, implicit_prefs=implicit, alpha=2.0,
                   scale_reg_by_count=False), **kw}


def both_models(n_users=10, n_items=20, implicit=False, quant="off",
                seed=0, **kw):
    """(JAX model, port model) over the same numbers: f32 tables, or int8
    tables quantized once with the JAX package's arithmetic."""
    U, V = tables(n_users, n_items, seed=seed)
    uids = {f"u{i}": i for i in range(n_users)}
    iids = {f"i{i}": i for i in range(n_items)}
    jp = jals.ALSParams(**params_kw(implicit, **kw))
    if quant == "int8":
        (ud, us), (vd, vs) = (jals._quantize_rows(U, "int8"),
                              jals._quantize_rows(V, "int8"))
        jU = jals.QuantizedFactors(ud, us, "int8")
        jV = jals.QuantizedFactors(vd, vs, "int8")
        pm = als_model_from_numpy(ud, vd, n_users, n_items, uids, iids,
                                  params_kw(implicit, **kw), user_scale=us,
                                  item_scale=vs, quant="int8", device="cpu")
    else:
        jU, jV = U, V
        pm = als_model_from_numpy(U, V, n_users, n_items, uids, iids,
                                  params_kw(implicit, **kw), device="cpu")
    jm = jals.ALSModel(user_factors=jU, item_factors=jV, n_users=n_users,
                       n_items=n_items, user_ids=JBiMap(uids),
                       item_ids=JBiMap(iids), params=jp)
    return jm, pm


def host(t):
    return als.table_host_f32(t)


def n_rows(t):
    """Rows of a factor table, plain or quantized, in either package."""
    return (t.data if hasattr(t, "data") and hasattr(t, "quant")
            else t).shape[0]


def jhost(t):
    return jals.table_host_f32(t)


def histories(B, L, n_cols, seed=1):
    """A ``[B, L]`` block: varied counts (one row empty), padding slots
    holding index 0 and value 0."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n_cols, size=(B, L)).astype(np.int32)
    val = rng.integers(1, 11, size=(B, L)).astype(np.float32) / 2
    cnt = rng.integers(1, L + 1, size=B).astype(np.int32)
    if B > 2:
        cnt[2] = 0
    for b in range(B):
        idx[b, cnt[b]:] = 0
        val[b, cnt[b]:] = 0
    return idx, val, cnt


# -- dedupe and fold_in_rows -------------------------------------------------

@pytest.mark.parametrize("case", ["last-write-wins", "empty", "random"])
def test_dedupe_pairs_matches_jax(case):
    if case == "last-write-wins":
        r, c, v = (np.array([0, 0, 1, 0]), np.array([5, 5, 2, 5]),
                   np.array([1.0, 2.0, 3.0, 4.0]))
    elif case == "empty":
        r = c = v = np.array([])
    else:
        rng = np.random.default_rng(3)
        r, c = rng.integers(0, 4, 200), rng.integers(0, 6, 200)
        v = rng.normal(size=200).astype(np.float32)
    got = als.dedupe_pairs(r, c, v)
    want = jals.dedupe_pairs(r, c, v)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if case == "last-write-wins":
        assert {(int(a), int(b)): float(x) for a, b, x in zip(*got)} == \
            {(0, 5): 4.0, (1, 2): 3.0}


FOLD_CASES = [(False, "off", False), (False, "int8", False),
              (True, "off", False), (True, "off", True),
              (True, "int8", False), (True, "int8", True)]


@pytest.mark.parametrize("implicit,quant,pre_g", FOLD_CASES,
                         ids=[f"{'implicit' if i else 'explicit'}-{q}"
                              f"{'-G' if g else ''}"
                              for i, q, g in FOLD_CASES])
def test_fold_in_rows_matches_jax(implicit, quant, pre_g):
    """Rows of a block with padding slots and an empty row, against a
    fixed table with padding rows past ``n_items``; with a precomputed
    ``G`` where asked (equal to the one computed inside)."""
    jm, pm = both_models(implicit=implicit, quant=quant)
    idx, val, cnt = histories(7, 9, 20)
    jG = jals.fixed_gramian(jm.item_factors, jm.params) if pre_g else None
    pG = als.fixed_gramian(pm.item_factors, pm.params) if pre_g else None
    want = np.asarray(jals.fold_in_rows(jm.item_factors, idx, val, cnt,
                                        jm.params, G=jG))
    got = als.fold_in_rows(pm.item_factors, idx, val, cnt, pm.params, G=pG)
    assert got.dtype == np.float32 and got.shape == (7, RANK)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if pre_g:
        np.testing.assert_allclose(
            got, als.fold_in_rows(pm.item_factors, idx, val, cnt,
                                  pm.params), rtol=1e-6, atol=1e-6)
    if not implicit:
        assert als.fixed_gramian(pm.item_factors, pm.params) is None


@pytest.mark.parametrize("implicit", [False, True],
                         ids=["explicit", "implicit"])
def test_fold_in_one_row(implicit):
    """B = 1 and an L that is no power of two, as a single touched user
    gives it."""
    jm, pm = both_models(implicit=implicit)
    idx, val, cnt = histories(1, 5, 20, seed=4)
    want = np.asarray(jals.fold_in_rows(jm.item_factors, idx, val, cnt,
                                        jm.params))
    got = als.fold_in_rows(pm.item_factors, idx, val, cnt, pm.params)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the explicit closed form, in float64
    if not implicit:
        F = host(pm.item_factors)[idx[0, :cnt[0]]].astype(np.float64)
        ref = np.linalg.solve(F.T @ F + 0.1 * np.eye(RANK),
                              F.T @ val[0, :cnt[0]])
        np.testing.assert_allclose(got[0], ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("implicit", [False, True],
                         ids=["explicit", "implicit"])
def test_unpadded_fold_in_equals_padded(implicit):
    """The JAX package pads B and L to powers of two to reuse
    compilations; the port sends the block as it is. Padding rows and
    slots are inert: the rows agree within the tolerance against the JAX
    package (a longer L sums in another order)."""
    _, pm = both_models(implicit=implicit)
    idx, val, cnt = histories(5, 6, 20, seed=5)
    got = als.fold_in_rows(pm.item_factors, idx, val, cnt, pm.params)
    Bp, Lp = 8, 8
    idx2 = np.zeros((Bp, Lp), np.int32)
    val2 = np.zeros((Bp, Lp), np.float32)
    cnt2 = np.zeros(Bp, np.int32)
    idx2[:5, :6], val2[:5, :6], cnt2[:5] = idx, val, cnt
    padded = als.fold_in_rows(pm.item_factors, idx2, val2, cnt2, pm.params)
    np.testing.assert_allclose(padded[:5], got, rtol=RTOL, atol=ATOL)


def test_fold_in_bf16_gather_matches_jax():
    """The bf16 gather shadow and bf16 products reach the fold-in as they
    reach training."""
    jm, pm = both_models(gather_dtype="bfloat16", matmul_dtype="bfloat16")
    idx, val, cnt = histories(6, 8, 20, seed=6)
    want = np.asarray(jals.fold_in_rows(jm.item_factors, idx, val, cnt,
                                        jm.params))
    got = als.fold_in_rows(pm.item_factors, idx, val, cnt, pm.params)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-3)


def test_fold_in_empty_batch_and_numpy_table():
    _, pm = both_models()
    out = als.fold_in_rows(pm.item_factors, np.zeros((0, 1), np.int32),
                           np.zeros((0, 1), np.float32),
                           np.zeros(0, np.int32), pm.params)
    assert out.shape == (0, RANK)
    with pytest.raises(TypeError, match="torch tensor"):
        als.fold_in_rows(host(pm.item_factors), np.zeros((1, 1), np.int32),
                         np.ones((1, 1), np.float32),
                         np.ones(1, np.int32), pm.params)


def test_burst_does_not_multiply_implicit_weight():
    """Five identical events dedupe to one pair; without the dedupe the
    row really differs."""
    _, pm = both_models(implicit=True, alpha=4.0)

    def solve(items, vals):
        return als.fold_in_rows(
            pm.item_factors, np.asarray(items, np.int32)[None, :],
            np.asarray(vals, np.float32)[None, :],
            np.array([len(items)], np.int32), pm.params)[0]

    once = solve([3], [1.0])
    _, cols, vals = als.dedupe_pairs(np.zeros(5, np.int64),
                                     np.full(5, 3, np.int64),
                                     np.ones(5, np.float32))
    np.testing.assert_allclose(solve(cols, vals), once, rtol=1e-6)
    assert np.abs(solve([3] * 5, [1.0] * 5) - once).max() > 1e-4


# -- functional row updates and cold-start rows ------------------------------

@pytest.mark.parametrize("quant", ["off", "int8"])
def test_apply_row_updates_matches_jax(quant):
    jm, pm = both_models(quant=quant)
    before = host(pm.user_factors).copy()
    before_data = pm.user_factors.data.clone() if quant == "int8" else None
    rows = np.random.default_rng(7).normal(size=(3, RANK)).astype(np.float32)
    at = np.array([1, 4, 9])
    jout = jals.apply_row_updates(jm, "user", at, rows)
    pout = als.apply_row_updates(pm, "user", at, rows)
    if quant == "int8":
        # the same f32 rows re-quantize to the same bytes and scales
        np.testing.assert_array_equal(pout.user_factors.data.numpy(),
                                      np.asarray(jout.user_factors.data))
        np.testing.assert_array_equal(pout.user_factors.scale.numpy(),
                                      np.asarray(jout.user_factors.scale))
        assert torch.equal(pm.user_factors.data, before_data)
    else:
        np.testing.assert_array_equal(host(pout.user_factors)[at], rows)
    np.testing.assert_array_equal(host(pout.user_factors),
                                  jhost(jout.user_factors))
    # the input model (possibly still serving) is untouched
    np.testing.assert_array_equal(host(pm.user_factors), before)
    assert pout.item_factors is pm.item_factors
    assert als.apply_row_updates(pm, "user", np.array([], np.int64),
                                 rows[:0]) is pm


@pytest.mark.parametrize("quant", ["off", "int8"])
def test_extend_factor_rows_claims_padding_then_grows_like_jax(quant):
    jm, pm = both_models(quant=quant)
    rows = np.full((2, RANK), 0.5, np.float32)
    jout = jals.extend_factor_rows(jm, "user", ["ua", "ub"], rows)
    pout = als.extend_factor_rows(pm, "user", ["ua", "ub"], rows)
    # padding rows claimed: no reallocation
    assert n_rows(pout.user_factors) == n_rows(jout.user_factors) == 13
    many = [f"x{i}" for i in range(8)]
    ones = np.ones((8, RANK), np.float32)
    jout = jals.extend_factor_rows(jout, "user", many, ones)
    pout = als.extend_factor_rows(pout, "user", many, ones)
    assert pout.n_users == jout.n_users == 20
    assert n_rows(pout.user_factors) == n_rows(jout.user_factors) \
        == 13 + als.COLD_START_GROW_MIN
    assert dict(pout.user_ids.items()) == dict(jout.user_ids.items())
    np.testing.assert_array_equal(host(pout.user_factors),
                                  jhost(jout.user_factors))
    if quant == "int8":  # fresh capacity: zero rows with scale 1
        np.testing.assert_array_equal(
            pout.user_factors.scale.numpy()[20:], 1.0)
    assert pm.n_users == 10 and "ua" not in pm.user_ids


def test_extend_rejects_known_key():
    _, pm = both_models()
    with pytest.raises(ValueError, match="already indexed"):
        als.extend_factor_rows(pm, "user", ["u3"],
                               np.ones((1, RANK), np.float32))


# -- projection ----------------------------------------------------------------

def _rate(user, item, rating, t, cls=Event, dm=DataMap):
    return cls(event="rate", entity_type="user", entity_id=user,
               target_entity_type="item", target_entity_id=item,
               properties=dm({"rating": float(rating)}), event_time=t)


def _junk_events(cls, dm):
    return [
        _rate("u1", "i1", 4.0, T0, cls, dm),
        cls(event="buy", entity_type="user", entity_id="u1",
            target_entity_type="item", target_entity_id="i2", event_time=T0),
        cls(event="view", entity_type="user", entity_id="u1",
            target_entity_type="item", target_entity_id="i3", event_time=T0),
        cls(event="rate", entity_type="user", entity_id="u1",
            event_time=T0),
        cls(event="rate", entity_type="user", entity_id="u1",
            target_entity_type="item", target_entity_id="i4",
            properties=dm({"rating": "junk"}), event_time=T0),
    ]


def test_project_ratings_matches_jax():
    got = project_ratings(_junk_events(Event, DataMap))
    assert got == jstream.project_ratings(_junk_events(JEvent, JDataMap))
    assert got == [("u1", "i1", 4.0), ("u1", "i2", 4.0)]


def test_project_ratings_custom_weights():
    ev = [_junk_events(Event, DataMap)[2]]
    jev = [_junk_events(JEvent, JDataMap)[2]]
    w = {"view": 1.5}
    assert project_ratings(ev, w) == jstream.project_ratings(jev, w) == \
        [("u1", "i3", 1.5)]


# -- fold_in_events on one pio.db ------------------------------------------------

def _seed_events(n_users=30):
    """Group A (even users) likes items 0-14, group B items 15-29."""
    rng = np.random.default_rng(42)
    events, t = [], T0
    for u in range(n_users):
        group = range(0, 15) if u % 2 == 0 else range(15, 30)
        for i in rng.choice(list(group), size=8, replace=False):
            events.append(_rate(f"u{u}", f"i{i}", 5.0, t))
            t += timedelta(minutes=1)
    return events, t


@pytest.fixture
def shared_db(tmp_path):
    """One SQLite ``pio.db`` holding the seed log, opened by both
    packages."""
    st = Storage(env={"PIO_HOME": str(tmp_path)})
    app_id = st.apps().insert(App(0, APP))
    st.events().init(app_id)
    events, t = _seed_events()
    st.events().insert_batch(events, app_id)
    jst = JStorage(env={"PIO_HOME": str(tmp_path)})
    yield st, jst, app_id, t
    st.close()
    jst.close()


def _to_jax_events(events):
    return [JEvent(event=e.event, entity_type=e.entity_type,
                   entity_id=e.entity_id,
                   target_entity_type=e.target_entity_type,
                   target_entity_id=e.target_entity_id,
                   properties=JDataMap(e.properties.to_dict()),
                   event_time=e.event_time) for e in events]


def _fold_both(shared_db, events, quant="off", implicit=False):
    st, jst, app_id, _ = shared_db
    st.events().insert_batch(events, app_id)
    jm, pm = both_models(n_users=30, n_items=30, quant=quant,
                         implicit=implicit)
    jout, jrep = jstream.fold_in_events(jm, _to_jax_events(events), jst,
                                        app_id)
    pout, prep = fold_in_events(pm, events, st, app_id)
    return jout, jrep, pout, prep, pm


@pytest.mark.parametrize("quant,implicit", [("off", False), ("int8", True)],
                         ids=["f32-explicit", "int8-implicit"])
def test_fold_in_events_matches_jax(shared_db, quant, implicit):
    t = shared_db[3]
    events = [_rate("u0", "i1", 5.0, t), _rate("u3", "i20", 2.0, t),
              _rate("u0", "i2", 4.0, t + timedelta(seconds=1)),
              _rate("u0", "i1", 3.0, t + timedelta(seconds=2))]
    jout, jrep, pout, prep, pm = _fold_both(shared_db, events, quant,
                                            implicit)
    for f in ("events_relevant", "users_updated", "users_inserted",
              "items_inserted"):
        assert getattr(prep, f) == getattr(jrep, f), f
    assert prep.users_updated == 2 and prep.values == jrep.values
    np.testing.assert_allclose(host(pout.user_factors),
                               jhost(jout.user_factors), rtol=RTOL,
                               atol=ATOL)
    assert prep.residual == pytest.approx(jrep.residual, rel=1e-4)
    untouched = [u for u in range(30) if u not in (0, 3)]
    np.testing.assert_array_equal(host(pout.user_factors)[untouched],
                                  host(pm.user_factors)[untouched])


def test_two_stream_sessions_on_one_store_match_jax(shared_db):
    """Two stream sessions on one store, each on a fresh bind of the same
    instance: an item the first session inserted is unknown to the
    second session's model, so both packages fold a later rating of its
    user from the KNOWN items of the history alone, alike. A float64
    check of that row must look up only the items the bound model knows
    (``chip_smoke.py::f64_fold_check``); looking up every history item
    raised KeyError on the new one."""
    import chip_smoke

    st, jst, app_id, t = shared_db
    first = [_rate("u0", "i_new", 5.0, t),
             _rate("u1", "i_new", 4.0, t + timedelta(seconds=1))]
    second = [_rate("u0", "i3", 2.0, t + timedelta(seconds=2))]
    outs = {}
    for name, batch in (("first", first), ("second", second)):
        st.events().insert_batch(batch, app_id)
        jm, pm = both_models(n_users=30, n_items=30)  # a fresh bind
        jout, jrep = jstream.fold_in_events(jm, _to_jax_events(batch),
                                            jst, app_id)
        pout, prep = fold_in_events(pm, batch, st, app_id)
        assert (prep.items_inserted, prep.users_updated) \
            == (jrep.items_inserted, jrep.users_updated)
        np.testing.assert_allclose(host(pout.user_factors),
                                   jhost(jout.user_factors), rtol=RTOL,
                                   atol=ATOL)
        outs[name] = pout
    assert "i_new" in outs["first"].item_ids
    assert "i_new" not in outs["second"].item_ids
    worst = chip_smoke.f64_fold_check(st, app_id, outs["second"], ["u0"])
    assert worst <= 1e-5


def test_fold_in_events_idempotent_under_replay(shared_db):
    st, _, app_id, t = shared_db
    _, pm = both_models(n_users=30, n_items=30)
    evs = [_rate("u0", "i1", 5.0, t),
           _rate("u0", "i2", 4.0, t + timedelta(seconds=1))]
    st.events().insert_batch(evs, app_id)
    m1, r1 = fold_in_events(pm, evs, st, app_id)
    m2, r2 = fold_in_events(m1, evs, st, app_id)
    assert r1.users_updated == r2.users_updated == 1
    np.testing.assert_array_equal(host(m1.user_factors),
                                  host(m2.user_factors))


def test_cold_user_and_cold_item_in_one_pass_match_jax(shared_db):
    t = shared_db[3]
    events = [_rate("brand_new_user", "brand_new_item", 5.0, t),
              _rate("u4", "brand_new_item", 4.0, t),
              _rate("brand_new_user", "i3", 2.0, t + timedelta(seconds=1))]
    jout, jrep, pout, prep, _ = _fold_both(shared_db, events)
    assert prep.users_inserted == jrep.users_inserted == 1
    assert prep.items_inserted == jrep.items_inserted == 1
    assert pout.n_users == jout.n_users == 31
    assert pout.n_items == jout.n_items == 31
    assert pout.item_ids["brand_new_item"] == 30
    np.testing.assert_allclose(host(pout.item_factors),
                               jhost(jout.item_factors), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(host(pout.user_factors)[:31],
                               jhost(jout.user_factors)[:31], rtol=RTOL,
                               atol=ATOL)


def test_irrelevant_events_fold_nothing(shared_db):
    st, _, app_id, t = shared_db
    _, pm = both_models(n_users=30, n_items=30)
    ev = Event(event="view", entity_type="user", entity_id="u0",
               target_entity_type="item", target_entity_id="i1",
               event_time=t)
    m, rep = fold_in_events(pm, [ev], st, app_id)
    assert rep.events_relevant == 0 and m is pm


# -- the durable cursor ------------------------------------------------------------

@pytest.fixture
def mem_store():
    st = Storage(env={"PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"})
    app_id = st.apps().insert(App(0, APP))
    st.events().init(app_id)
    return st, app_id


def test_cursor_restart_replays_exactly_the_unconsumed_suffix(mem_store):
    st, app_id = mem_store
    st.events().insert_batch(_seed_events(4)[0], app_id)
    cur = EventCursor(st, app_id, "c1")
    assert len(cur.pending(event_names=["rate"], entity_type="user")) == 32
    first = cur.pending(event_names=["rate"], entity_type="user", limit=20)
    times = [e.event_time for e in first]
    assert times == sorted(times)
    cur.advance(first)
    cur.save()
    cur2 = EventCursor(st, app_id, "c1")  # crash, then restart
    assert cur2.consumed_total == 20
    rest = cur2.pending(event_names=["rate"], entity_type="user")
    assert len(rest) == 12
    assert not {e.event_id for e in first} & {e.event_id for e in rest}


def test_cursor_timestamp_ties(mem_store):
    st, app_id = mem_store
    for j in range(3):
        st.events().insert(_rate(f"u{j}", "i0", 3.0, T0), app_id)
    cur = EventCursor(st, app_id, "c1")
    seen = []
    for _ in range(3):
        batch = cur.pending(event_names=["rate"], entity_type="user",
                            limit=1)
        assert len(batch) == 1
        seen.append(batch[0].entity_id)
        cur.advance(batch)
        cur.save()
        cur = EventCursor(st, app_id, "c1")
    assert sorted(seen) == ["u0", "u1", "u2"]
    assert cur.pending(event_names=["rate"], entity_type="user") == []


def test_cursor_records_never_consumed_and_corrupt_cursor(mem_store):
    st, app_id = mem_store
    st.events().insert(_rate("u0", "i0", 3.0, T0), app_id)
    cur = EventCursor(st, app_id, "c1")
    cur.advance(cur.pending(limit=10))
    cur.save()
    pend = EventCursor(st, app_id, "other").pending(limit=100)
    assert len(pend) == 1
    assert all(e.entity_type != CURSOR_ENTITY_TYPE for e in pend)
    st.events().insert(
        Event(event="$set", entity_type=CURSOR_ENTITY_TYPE, entity_id="c1",
              properties=DataMap({"garbage": True}),
              event_time=datetime(1970, 1, 1, tzinfo=timezone.utc),
              event_id=cur.cursor_event_id), app_id)
    assert len(EventCursor(st, app_id, "c1").pending(limit=10)) == 1


def test_cursor_record_is_shared_with_the_jax_package(shared_db):
    """The cursor is an event of the shared schema: a consumer either
    package saved resumes in the other at the same place."""
    st, jst, app_id, _ = shared_db
    jcur = jstream.EventCursor(jst, app_id, "shared")
    jcur.advance(jcur.pending(event_names=["rate"], entity_type="user",
                              limit=100))
    jcur.save()
    cur = EventCursor(st, app_id, "shared")
    assert cur.consumed_total == 100
    assert cur.position == jcur.position and cur.seen == jcur.seen
    assert len(cur.pending(event_names=["rate"], entity_type="user")) == \
        len(jcur.pending(event_names=["rate"], entity_type="user")) == 140


def test_cursor_block_reads_match_jax(shared_db):
    st, jst, app_id, _ = shared_db
    cur, jcur = (EventCursor(st, app_id, "b"),
                 jstream.EventCursor(jst, app_id, "b"))
    blk, jblk = cur.pending_block(), jcur.pending_block()
    assert blk.n == jblk.n == 240
    cur.advance_block(100)
    jcur.advance_block(100)
    assert cur.pending_block().n == jcur.pending_block().n == 140


# -- drift -------------------------------------------------------------------------

def test_drift_monitor_scores_match_jax():
    rng = np.random.default_rng(0)
    d, jd = (DriftMonitor(threshold=1.0, baseline_min_samples=32, window=64,
                          residual_halflife=4),
             jstream.DriftMonitor(threshold=1.0, baseline_min_samples=32,
                                  window=64, residual_halflife=4))
    for k in range(30):
        vals = list(rng.normal(4.0 if k < 10 else 1.5, 0.5, size=16))
        res = float(rng.uniform(0.0, 0.4 + 0.05 * k))
        d.observe(vals, res)
        jd.observe(vals, res)
        assert d.status() == jd.status()
    assert d.retrain_due
    d.reset()
    assert d.score() == 0.0 and not d.retrain_due


# -- the copies the trainer needs ----------------------------------------------------

def test_retry_schedule_and_budget_match_jax():
    from predictionio_tpu.utils import retrying as jretry
    from predictionio_tpu_torch.utils import retrying

    pol = dict(max_attempts=5, base_ms=1.0, cap_ms=3.0, jitter=0.0)
    assert list(retrying.backoff_delays(retrying.RetryPolicy(**pol))) == \
        list(jretry.backoff_delays(jretry.RetryPolicy(**pol)))
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("blip")
        return "ok"

    fast = retrying.RetryPolicy(max_attempts=3, base_ms=0.1, cap_ms=0.1)
    assert retrying.retry_call(flaky, policy=fast,
                               retry_on=(OSError,)) == "ok"
    calls.clear()
    with pytest.raises(OSError):
        retrying.retry_call(flaky, policy=retrying.RetryPolicy(
            max_attempts=2, base_ms=0.1), retry_on=(OSError,))
    assert len(calls) == 2
    with pytest.raises(ValueError):
        retrying.RetryPolicy(max_attempts=0)


@pytest.mark.parametrize("stable,cand", [
    ((0, 0, None), (0, 0, None)), ((10, 0, 0.01), (1, 0, 0.01)),
    ((10, 0, 0.01), (1, 1, 0.01)), ((30, 0, 0.01), (30, 1, 0.01)),
    ((30, 0, 0.01), (30, 0, 0.03)), ((30, 3, 0.01), (30, 0, 0.01))])
def test_health_policy_verdicts_match_jax(stable, cand):
    from predictionio_tpu.rollout import policy as jpol
    from predictionio_tpu_torch.rollout import policy

    for min_q in (1, 20):
        got = policy.HealthPolicy(min_queries=min_q).evaluate(
            policy.ArmWindow(*stable), policy.ArmWindow(*cand))
        want = jpol.HealthPolicy(min_queries=min_q).evaluate(
            jpol.ArmWindow(*stable), jpol.ArmWindow(*cand))
        assert (got.action, got.reason) == (want.action, want.reason)


def test_fault_specs_parse_like_jax_and_fire_on_the_stream_pass():
    from predictionio_tpu.faults import parse_specs as jparse
    from predictionio_tpu_torch import faults

    raw = "stream.pass=error,after=1,times=1;stream.*=latency,delay_ms=5," \
          "consumer=a"
    assert [vars(f) for f in faults.parse_specs(raw)] == \
        [vars(f) for f in jparse(raw)]
    assert "stream.pass" in faults.POINTS
    faults.inject("stream.pass", "error", times=1,
                  match={"consumer": "drill"})
    try:
        faults.fire("stream.pass", consumer="other")  # label mismatch
        with pytest.raises(faults.FaultError):
            faults.fire("stream.pass", consumer="drill")
        faults.fire("stream.pass", consumer="drill")  # times=1 spent
    finally:
        assert faults.clear() == 1
    with pytest.raises(ValueError):
        faults.parse_specs("stream.pass")


# -- the trainer on a storage-backed deploy ------------------------------------------

def _variant():
    return {"datasource": {"params": {"app_name": APP}},
            "algorithms": [{"name": "als", "params": {
                "rank": RANK, "num_iterations": 6, "lambda": 0.05,
                "seed": 11}}]}


def _deployed(storage, config=None):
    """``deploy(...)`` of a model trained on the CPU from ``storage``;
    returns the engine server (not serving) and its QueryServer."""
    engine = recommendation_engine()
    ep = engine.params_from_variant(_variant())
    ctx = Context(device="cpu", _storage=storage)
    run_train(ctx, engine, ep, engine_id="reco")
    srv = es.deploy(ctx, engine, ep, engine_id="reco",
                    config=config or es.ServerConfig(device="cpu"),
                    host="127.0.0.1", port=0)
    return srv, srv.query_server


@pytest.fixture
def deployed():
    st = Storage(env={"PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"})
    app_id = st.apps().insert(App(0, APP))
    st.events().init(app_id)
    events, t = _seed_events()
    st.events().insert_batch(events, app_id)
    srv, qs = _deployed(st)
    yield st, app_id, qs, t
    srv.close()


def _trainer(qs, **kw):
    kw.setdefault("canary_probes", 2)
    kw.setdefault("interval_ms", 50)
    return StreamTrainer(qs, StreamConfig(app_name=APP, **kw),
                         bus=InvalidationBus())


def test_event_to_servable_matches_jax_fold(deployed):
    """A new user's events become servable through one pass; the rows
    the server then holds are the JAX package's fold of the same events
    over the same bound tables."""
    st, app_id, qs, t = deployed
    tr = _trainer(qs, consumer="t-servable")
    assert tr.consume_once() == 240  # the seed log: every user re-solved
    _, base = qs.stream_snapshot(0)
    gen0 = qs.stream_lineage()["incrementalGeneration"]
    fresh = [_rate("u_fresh", f"i{i}", 5.0, t + timedelta(seconds=k))
             for k, i in enumerate((0, 1, 2, 3, 4))]
    st.events().insert_batch(fresh, app_id)
    jst = JStorage(env={"PIO_STORAGE_SOURCES_M_TYPE": "memory"})
    jid = jst.apps().insert(App(0, APP))
    jst.events().init(jid)
    jst.events().insert_batch(_to_jax_events(
        list(st.events().find(app_id))), jid)
    assert tr.consume_once() == 5
    lin = qs.stream_lineage()
    assert lin["incrementalGeneration"] == gen0 + 1
    assert lin["baseInstanceId"] == qs.instance.id
    assert tr.status()["lastBatch"]["usersInserted"] == 1
    _, model = qs.stream_snapshot(0)
    jm = jals.ALSModel(
        user_factors=host(base.user_factors),
        item_factors=host(base.item_factors), n_users=base.n_users,
        n_items=base.n_items, user_ids=JBiMap(dict(base.user_ids.items())),
        item_ids=JBiMap(dict(base.item_ids.items())),
        params=jals.ALSParams(rank=RANK, reg=0.05, seed=11))
    jout, _ = jstream.fold_in_events(jm, _to_jax_events(fresh), jst, jid)
    row = model.user_ids["u_fresh"]
    np.testing.assert_allclose(host(model.user_factors)[row],
                               jhost(jout.user_factors)[row], rtol=RTOL,
                               atol=ATOL)
    got = qs.query({"user": "u_fresh", "num": 5})
    tops = [int(s["item"][1:]) for s in got["itemScores"]]
    assert len(tops) == 5 and sum(i < 15 for i in tops) >= 4, tops
    jst.close()


def test_rebind_race_aborts_the_apply(deployed):
    st, app_id, qs, t = deployed
    _, model = qs.stream_snapshot(0)
    assert qs.apply_stream_delta(0, model, ["u0"], "stale") is False
    assert qs.apply_stream_delta(0, model, ["u0"], qs.instance.id) is True
    # a rebind while a pass is in flight: the pass applies nothing and
    # leaves the cursor where it was; the next pass applies
    tr = _trainer(qs, consumer="t-race")
    tr.consume_once()
    applies0 = tr.applies
    st.events().insert(_rate("u2", "i3", 1.0, t + timedelta(hours=1)),
                       app_id)
    real = pfoldin.fold_in_events

    def racing(*a, **k):
        out = real(*a, **k)
        qs.instance = qs.instance.copy(id="reloaded")
        qs._bind(qs.engine_params, [model])
        return out

    pfoldin_trainer = __import__(
        "predictionio_tpu_torch.streaming.trainer", fromlist=["x"])
    orig = pfoldin_trainer.fold_in_events
    pfoldin_trainer.fold_in_events = racing
    try:
        assert tr.consume_once() == 0
    finally:
        pfoldin_trainer.fold_in_events = orig
    assert tr.applies == applies0 and tr.cursor.consumed_total == 240
    assert tr.consume_once() == 1 and tr.applies == applies0 + 1
    # with models handed in, a per-bind token stands in for the id
    ms = es.QueryServer(qs.engine, qs.engine_params, [model],
                        es.ServerConfig(device="cpu"))
    first, _ = ms.stream_snapshot(0)
    ms._bind(ms.engine_params, [model])
    assert ms.apply_stream_delta(0, model, [], first) is False
    with pytest.raises(ValueError, match="storage"):
        ms.start_stream(StreamConfig(app_name=APP))


def test_canary_rejects_a_nan_delta(deployed, monkeypatch):
    """A fold that produces NaN rows is refused by the probe gate: the
    binding keeps its model, the reject counts, the cursor moves on."""
    st, app_id, qs, t = deployed
    tr = _trainer(qs, consumer="t-reject")
    tr.consume_once()
    gen0 = qs.stream_lineage()["incrementalGeneration"]
    _, before = qs.stream_snapshot(0)
    monkeypatch.setattr(pfoldin, "fold_in_rows",
                        lambda fixed, idx, *a, **k: np.full(
                            (idx.shape[0], RANK), np.nan, np.float32))
    st.events().insert(_rate("u2", "i3", 1.0, t + timedelta(hours=2)),
                       app_id)
    assert tr.consume_once() == 1
    assert tr.rejects == 1 and tr.applies == 1
    assert qs.stream_lineage()["incrementalGeneration"] == gen0
    assert qs.stream_snapshot(0)[1] is before
    assert tr.consume_once() == 0


def test_drift_fires_the_retrain_hook_once(deployed):
    st, app_id, qs, t = deployed
    fired = []
    tr = StreamTrainer(qs, StreamConfig(app_name=APP, consumer="t-drift",
                                        canary_probes=0,
                                        drift_threshold=0.5),
                       bus=InvalidationBus(), on_retrain=fired.append)
    tr.consume_once()
    for _ in range(12):
        tr.drift.observe([4.0], 5.0)
    st.events().insert(_rate("u8", "i1", 4.0, t + timedelta(hours=3)),
                       app_id)
    tr.consume_once()
    assert len(fired) == 1 and fired[0]["retrainDue"]
    st.events().insert(_rate("u8", "i2", 4.0, t + timedelta(hours=4)),
                       app_id)
    tr.consume_once()
    assert len(fired) == 1


def test_a_failing_pass_backs_off_and_the_loop_survives(deployed):
    """An injected fault at the pass's entry fails it: the loop records
    the error, backs off, and the next pass folds the events."""
    from predictionio_tpu_torch import faults

    st, app_id, qs, t = deployed
    bus = InvalidationBus()
    tr = StreamTrainer(qs, StreamConfig(app_name=APP, consumer="t-fault",
                                        canary_probes=0, interval_ms=10),
                       bus=bus)
    faults.inject("stream.pass", "error", times=1,
                  match={"consumer": "t-fault"})
    try:
        tr.start()
        deadline = time.monotonic() + 30
        while tr.applies == 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert tr.applies == 1 and tr.events_consumed == 240
        assert "injected fault at stream.pass" in tr.status()["lastError"]
    finally:
        tr.stop()
        faults.clear()
    assert not tr.running


def test_bus_wake_and_the_threaded_loop(deployed):
    """The loop thread: a bus publish wakes it long before its 10 s poll,
    and stop() joins it."""
    st, app_id, qs, t = deployed
    bus = InvalidationBus()
    tr = StreamTrainer(qs, StreamConfig(app_name=APP, consumer="t-loop",
                                        canary_probes=0,
                                        interval_ms=10_000), bus=bus)
    try:
        tr.start()
        bus.publish(app_id, "user", "u0", "rate")  # the catch-up drain
        deadline = time.monotonic() + 30
        while tr.applies == 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        applies0 = tr.applies
        assert applies0 == 1
        st.events().insert(_rate("u_woken", "i1", 5.0,
                                 t + timedelta(hours=5)), app_id)
        bus.publish(app_id, "user", "u_woken", "view")  # not a weight
        bus.publish(app_id + 1, "user", "u_woken", "rate")  # another app
        time.sleep(0.3)
        assert tr.applies == applies0
        t_pub = time.monotonic()
        bus.publish(app_id, "user", "u_woken", "rate")
        while tr.applies == applies0 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert tr.applies == applies0 + 1
        assert time.monotonic() - t_pub < 5
        assert "u_woken" in qs.stream_snapshot(0)[1].user_ids
    finally:
        tr.stop()
    assert not tr.running


# -- the event server publishes, the HTTP routes, the CLI -----------------------------

def _call(port, method, path, body=None, raw=None):
    data = raw if raw is not None else (
        json.dumps(body).encode() if body is not None
        else (b"" if method == "POST" else None))
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method=method)
    try:
        with _LOCAL.open(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def test_event_server_publishes_every_accepted_ingest(mem_store):
    from predictionio_tpu_torch.data.columnar import columnar_from_events
    from predictionio_tpu_torch.data.storage.wire import batch_to_npz

    st, app_id = mem_store
    st.access_keys().insert(AccessKey(key="k1", app_id=app_id, events=()))
    bus = InvalidationBus()
    got = []

    class Sub:
        def on_event(self, app, et, eid, name=""):
            got.append((app, et, eid, name))

    sub = Sub()
    bus.subscribe(sub)
    srv = create_event_server(st, "127.0.0.1", 0, bus=bus)
    srv.start_background()
    try:
        one = {"event": "rate", "entityType": "user", "entityId": "u1",
               "targetEntityType": "item", "targetEntityId": "i1",
               "properties": {"rating": 5}}
        assert _call(srv.port, "POST", "/events.json?accessKey=k1",
                     one)[0] == 201
        assert got == [(app_id, "user", "u1", "rate")]
        two = [dict(one, entityId="u2"), dict(one, event="$bad"),
               dict(one, entityId="u3", event="buy")]
        status, res = _call(srv.port, "POST",
                            "/batch/events.json?accessKey=k1", two)
        assert [r["status"] for r in res] == [201, 400, 201]
        assert got[1:] == [(app_id, "user", "u2", "rate"),
                           (app_id, "user", "u3", "buy")]
        assert bus.stats()["published"] == 3
        block = columnar_from_events(
            [_rate("u4", "i1", 2.0, T0), _rate("u4", "i2", 3.0, T0),
             _rate("u5", "i1", 1.0, T0)])
        status, body = _call(srv.port, "POST",
                             "/columnar/events.npz?accessKey=k1",
                             raw=batch_to_npz(block))
        assert status == 201 and body["accepted"] == 3
        assert sorted(got[3:]) == [(app_id, "user", "u4", "rate"),
                                   (app_id, "user", "u5", "rate")]
    finally:
        srv.close()


def test_a_failing_subscriber_never_fails_ingest(mem_store):
    st, app_id = mem_store
    st.access_keys().insert(AccessKey(key="k1", app_id=app_id, events=()))
    bus = InvalidationBus()

    class Bad:
        def on_event(self, *a):
            raise RuntimeError("subscriber down")

    bad = Bad()
    bus.subscribe(bad)
    srv = create_event_server(st, "127.0.0.1", 0, bus=bus)
    srv.start_background()
    try:
        ev = {"event": "rate", "entityType": "user", "entityId": "u1",
              "targetEntityType": "item", "targetEntityId": "i1",
              "properties": {"rating": 5}}
        assert _call(srv.port, "POST", "/events.json?accessKey=k1",
                     ev)[0] == 201
        assert len(list(st.events().find(app_id))) == 1
    finally:
        srv.close()


def test_http_stream_lifecycle(deployed):
    """``/stream.json`` off, ``/stream/start`` (a second one answers 409),
    events become servable through the loop, ``/status.json`` carries
    lineage and stream, ``/stream/stop`` (409 with none running), and a
    restart with the same consumer consumes nothing."""
    st, app_id, qs, t = deployed
    srv = es.create_engine_server(qs, "127.0.0.1", 0).start_background()
    try:
        status, body = _call(srv.port, "GET", "/stream.json")
        assert status == 200 and body["running"] is False
        assert body["lineage"]["incrementalGeneration"] == 0
        status, body = _call(srv.port, "POST", "/stream/start",
                             {"appName": APP, "intervalMs": 20,
                              "canaryProbes": 2, "consumer": "http"})
        assert status == 200 and "started" in body["message"].lower()
        assert _call(srv.port, "POST", "/stream/start",
                     {"appName": APP})[0] == 409
        for k, i in enumerate((0, 1, 2, 3, 4)):
            st.events().insert(_rate("u_http", f"i{i}", 5.0,
                                     t + timedelta(seconds=k)), app_id)
        deadline = time.monotonic() + 30
        tops = []
        while time.monotonic() < deadline:
            _, got = _call(srv.port, "POST", "/queries.json",
                           {"user": "u_http", "num": 5})
            tops = [int(s["item"][1:]) for s in got["itemScores"]]
            if tops:
                break
            time.sleep(0.05)
        assert len(tops) == 5 and sum(i < 15 for i in tops) >= 4, tops
        _, status_json = _call(srv.port, "GET", "/status.json")
        assert status_json["lineage"]["incrementalGeneration"] >= 1
        assert status_json["stream"]["running"] is True
        assert status_json["stream"]["appName"] == APP
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            _, body = _call(srv.port, "GET", "/stream.json")
            if body["cursorLag"] == 0 and body["eventsConsumed"] == 245:
                break
            time.sleep(0.05)
        assert body["eventsConsumed"] == 245 and body["cursorLag"] == 0
        assert body["canaryRejects"] == 0
        assert _call(srv.port, "POST", "/stream/stop")[0] == 200
        assert _call(srv.port, "GET", "/stream.json")[1]["running"] is False
        assert _call(srv.port, "POST", "/stream/stop")[0] == 409
        assert _call(srv.port, "POST", "/stream/start",
                     {"appName": "nope"})[0] == 400
        tr = StreamTrainer(qs, StreamConfig(app_name=APP, consumer="http"),
                           bus=InvalidationBus())
        assert tr.consume_once() == 0
    finally:
        srv.close()


def test_streaming_deploy_fails_fast_without_an_app(mem_store, tmp_path):
    st, app_id = mem_store
    st.events().insert_batch(_seed_events(6)[0], app_id)
    before = {t.name for t in threading.enumerate()}
    with pytest.raises(ValueError, match="app name"):
        _deployed(st, es.ServerConfig(device="cpu", streaming=True,
                                      batching=True))
    # the batcher started before the refusal is joined again
    leaked = {t.name for t in threading.enumerate()} - before
    assert not leaked, leaked
    (tmp_path / "engine.json").write_text(json.dumps(_variant()))
    engine_json = str(tmp_path / "engine.json")
    assert cli.main(["train", "--engine-json", engine_json, "--engine-id",
                     "reco", "--device", "cpu"], storage=st) == 0
    args = cli._parser().parse_args([
        "deploy", "--engine-json", engine_json, "--engine-id", "reco",
        "--device", "cpu", "--port", "0", "--ip", "127.0.0.1", "--stream"])
    with pytest.raises(ValueError, match="app name"):
        cli.build_deploy(args, st)


def test_cli_deploy_stream_and_stream_commands(mem_store, tmp_path, capsys):
    st, app_id = mem_store
    st.events().insert_batch(_seed_events(6)[0], app_id)
    (tmp_path / "engine.json").write_text(json.dumps(_variant()))
    engine_json = str(tmp_path / "engine.json")
    assert cli.main(["train", "--engine-json", engine_json, "--engine-id",
                     "reco", "--device", "cpu"], storage=st) == 0
    args = cli._parser().parse_args([
        "deploy", "--engine-json", engine_json, "--engine-id", "reco",
        "--device", "cpu", "--port", "0", "--ip", "127.0.0.1", "--stream",
        "--stream-app", APP, "--stream-interval-ms", "20",
        "--stream-max-events", "16", "--stream-consumer", "cli"])
    srv = cli.build_deploy(args, st).start_background()
    try:
        qs = srv.query_server
        assert qs.stream.running and qs.stream.config.max_events == 16
        port = ["--port", str(srv.port)]
        capsys.readouterr()
        assert cli.main(["stream", "status"] + port) == 0
        assert '"consumer": "cli"' in capsys.readouterr().out
        assert cli.main(["stream", "stop"] + port) == 0
        assert not qs.stream
        assert cli.main(["stream", "stop"] + port) == 1
        assert cli.main(["stream", "start", "--app", APP, "--consumer",
                         "cli", "--canary-probes", "0"] + port) == 0
        assert qs.stream.config.canary_probes == 0
    finally:
        srv.close()
    assert qs.stream is None


def test_close_joins_every_thread(deployed):
    st, app_id, qs, t = deployed
    cfg = es.ServerConfig(device="cpu", batching=True, streaming=True,
                          stream_app_name=APP, stream_interval_ms=20)
    before = {t for t in threading.enumerate()}
    srv = es.deploy(Context(device="cpu", _storage=st),
                    qs.engine, qs.engine_params, engine_id="reco",
                    config=cfg, host="127.0.0.1", port=0)
    srv.start_background()
    trainer = srv.query_server.stream
    assert trainer.running
    assert _call(srv.port, "POST", "/queries.json",
                 {"user": "u0", "num": 3})[0] == 200
    srv.close()
    assert not trainer.running
    alive = [t for t in threading.enumerate()
             if t not in before and t.is_alive()]
    assert not alive, [t.name for t in alive]


# -- the kernels' launch plans at fold-in shapes ----------------------------------------

@pytest.mark.parametrize("B,L", [(1, 1), (1, 7), (1, 512), (36, 300),
                                 (64, 512), (2048, 512)])
def test_plans_take_fold_in_shapes(B, L):
    """``gram_plan`` and ``solve_plan`` were tuned on training buckets;
    the fold-in gives them B = 1 and an L that is no bucket length. A
    split never reaches past the row's chunks, and every system gets a
    lane."""
    p = gram_plan(B, L, 64, 4)
    n_chunks = -(-L // 32)
    assert 1 <= p.splits <= max(1, n_chunks)
    assert p.scratch_bytes == (B * p.splits * (64 * 64 + 64) * 4
                               if p.splits > 1 else 0)
    s = solve_plan(64, B)
    assert s.blocks * s.warps_per_block * s.systems_per_warp >= B
    assert s.blocks >= 1


def test_topk_plan_after_the_catalogue_grows():
    """A grown item table (pow2 growth past the trained rows) keeps a
    plan whose tiles cover every row; the item mask is ``n_items``."""
    for rows in (21_134, 21_134 + 64, 26_744 + 128):
        p = topk_plan(1, rows, 64, 4, 16)
        assert p.chunk * -(-rows // p.chunk) >= rows
        assert 1 <= p.splits <= -(-rows // p.chunk)
    assert als._compiled_k(10, 21_140) == 16
    assert als._compiled_k(10, 6) == 6
