"""The port's serving caches against the JAX package's.

The same scripted operation sequences go through both packages'
``ShardedTTLCache``, ``SingleFlight``, ``HotEntityTier`` (a stub pin) and
``ServingCache``, and the resulting answers and stats must be equal (the
port's hot tier adds ``refreshErrors``, ``lastError`` and ``pinnedStale``
to its stats; every shared key is compared). ``pin_user_rows`` and
``recommend_pinned`` are held to the JAX package's on f32 and int8
tables (ids equal, int8 pinned data and scales bit for bit, scores within
rtol 1e-5 on f32, 1e-4 on int8); the JAX side takes its device path
(``HOST_SERVE_WORK = 0``, test-side only). Both packages' ``QueryServer``s
with the cache on, from the same factors, answer the same query sequence
(hits, pinned serves, an ingest, a fold-in delta, a candidate and its
promotion) alike, with equal ``/cache.json`` keys and hit, miss and
invalidation counts. Then the port's own contracts: the routes, the
stale-handle check, no fallback from a failing pinned serve, the joined
refresh thread, and the ``cache`` and ``deploy --cache`` commands.

Small sizes: 24 users x 300 items at rank 4 (k = 200 takes the plain
route past the kernel's limit of 128), on the CPU.
"""

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request
from datetime import datetime, timezone

import numpy as np
import pytest
import torch

import predictionio_tpu.cache as jcache
import predictionio_tpu.models.als as jals
from predictionio_tpu.controller import Context as JContext
from predictionio_tpu.data.bimap import BiMap as JaxBiMap
from predictionio_tpu.data.storage import Storage as JStorage
from predictionio_tpu.data.storage.base import (
    EngineInstance as JEngineInstance,
)
from predictionio_tpu.server.engineserver import QueryServer as JQueryServer
from predictionio_tpu.server.engineserver import ServerConfig as JServerConfig
from predictionio_tpu.templates.recommendation import (
    default_engine_params as jax_default_params,
)
from predictionio_tpu.templates.recommendation import (
    recommendation_engine as jax_recommendation_engine,
)
from predictionio_tpu_torch import cache as pcache
from predictionio_tpu_torch import cli
from predictionio_tpu_torch.controller.context import Context
from predictionio_tpu_torch.data.storage.base import (
    STATUS_COMPLETED,
    AccessKey,
    App,
    EngineInstance,
    Model,
)
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.models import als as pals
from predictionio_tpu_torch.models.convert import als_model_from_numpy
from predictionio_tpu_torch.server.engineserver import (
    HTTPError,
    QueryServer,
    ServerConfig,
    deploy,
    deploy_models,
)
from predictionio_tpu_torch.templates.recommendation import (
    recommendation_engine,
)
from predictionio_tpu_torch.utils.jsonutil import from_jsonable
from predictionio_tpu_torch.workflow.persistence import dumps_models

N_USERS, N_ITEMS, RANK = 24, 300, 4
T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
VARIANT = {"id": "cache",
           "algorithms": [{"name": "als", "params": {"rank": RANK}}]}
#: the stats keys the port's hot tier adds to the JAX package's
PORT_HOT_KEYS = {"refreshErrors", "lastError", "pinnedStale"}
#: a hot tier that never re-pins on its own: the tests refresh by hand
NEVER = 10 ** 9

LOCAL = urllib.request.build_opener(urllib.request.ProxyHandler({}))


@pytest.fixture(autouse=True)
def _jax_device_path(monkeypatch):
    monkeypatch.setattr(jals, "HOST_SERVE_WORK", 0)


def factors(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N_USERS, RANK)).astype(np.float32),
            rng.normal(size=(N_ITEMS, RANK)).astype(np.float32))


def ids(prefix, n):
    return {f"{prefix}{i}": i for i in range(n)}


def port_model(U, V):
    return als_model_from_numpy(U, V, N_USERS, N_ITEMS, ids("u", N_USERS),
                                ids("i", N_ITEMS), {"rank": RANK},
                                device="cpu")


def jax_model(U, V):
    return jals.ALSModel(
        user_factors=U, item_factors=V, n_users=N_USERS, n_items=N_ITEMS,
        user_ids=JaxBiMap(ids("u", N_USERS)),
        item_ids=JaxBiMap(ids("i", N_ITEMS)),
        params=jals.ALSParams(rank=RANK))


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def shared_stats(port: dict, jax: dict) -> None:
    """Port stats equal the JAX package's on every JAX key; the port adds
    only its documented hot-tier keys."""
    extra = set(port) - set(jax)
    assert extra <= PORT_HOT_KEYS, extra
    assert set(jax) <= set(port)
    assert {k: port[k] for k in jax} == jax


# ---------------------------------------------------------------------------
# the tiers, op for op
# ---------------------------------------------------------------------------

#: scripted ShardedTTLCache sequences: (op, args...) run on both packages
LRU_SEQUENCES = {
    "put-lookup": (dict(max_entries=16, ttl_sec=30.0, shards=4), [
        ("put", ("ns", "a"), 1, ()), ("put", ("ns", "b"), [1, 2], ()),
        ("lookup", ("ns", "a")), ("lookup", ("ns", "zz")),
        ("put", ("ns", "a"), {"x": 2}, ()), ("lookup", ("ns", "a")),
        ("lookup", ("ns", "b"))]),
    "ttl-expiry": (dict(max_entries=16, ttl_sec=5.0, shards=2), [
        ("put", ("ns", "a"), 1, ()), ("tick", 4.0), ("lookup", ("ns", "a")),
        ("tick", 2.0), ("lookup", ("ns", "a")), ("lookup", ("ns", "a")),
        ("put_ttl", ("ns", "b"), 2, 1.0), ("tick", 0.5),
        ("lookup", ("ns", "b")), ("tick", 1.0), ("lookup", ("ns", "b"))]),
    "lru-eviction": (dict(max_entries=3, ttl_sec=30.0, shards=1), [
        ("put", ("ns", "a"), 1, ()), ("put", ("ns", "b"), 2, ()),
        ("put", ("ns", "c"), 3, ()), ("lookup", ("ns", "a")),
        ("put", ("ns", "d"), 4, ()), ("lookup", ("ns", "b")),
        ("lookup", ("ns", "a")), ("put", ("ns", "e"), 5, ()),
        ("lookup", ("ns", "c")), ("lookup", ("ns", "d"))]),
    "tags": (dict(max_entries=64, ttl_sec=30.0, shards=4), [
        ("put", ("ns", "q1"), 1, ("user:u1",)),
        ("put", ("ns", "q2"), 2, ("user:u1", "item:i3")),
        ("put", ("ns", "q3"), 3, ("user:u2",)),
        ("invalidate_tag", "user:u1"), ("lookup", ("ns", "q1")),
        ("lookup", ("ns", "q2")), ("lookup", ("ns", "q3")),
        ("invalidate_tag", "item:i3"), ("invalidate_key", ("ns", "q3")),
        ("invalidate_key", ("ns", "q3")), ("lookup", ("ns", "q3"))]),
    "namespaces": (dict(max_entries=64, ttl_sec=30.0, shards=4), [
        ("put", ("stable", "q"), 1, ()), ("put", ("cand", "q"), 2, ()),
        ("put", ("stable", "r"), 3, ()), ("put", "bare-key", 4, ()),
        ("flush", "cand"), ("lookup", ("cand", "q")),
        ("lookup", ("stable", "q")), ("flush", None),
        ("lookup", ("stable", "r")), ("lookup", "bare-key")]),
}


def run_lru(mod, kwargs, ops):
    clock = Clock()
    c = mod.ShardedTTLCache(clock=clock, **kwargs)
    out = []
    for op, *a in ops:
        if op == "put":
            c.put(a[0], a[1], tags=a[2])
        elif op == "put_ttl":
            c.put(a[0], a[1], ttl_sec=a[2])
        elif op == "tick":
            clock.t += a[0]
        else:
            out.append(getattr(c, op)(*a))
    return out, c.stats(), len(c), c.bytes


@pytest.mark.parametrize("name", sorted(LRU_SEQUENCES))
def test_sharded_ttl_cache_sequences(name):
    kwargs, ops = LRU_SEQUENCES[name]
    port = run_lru(pcache, kwargs, ops)
    jax = run_lru(jcache, kwargs, ops)
    assert port[0] == jax[0]
    shared_stats(port[1], jax[1])
    assert port[2:] == jax[2:]


@pytest.mark.parametrize("value", [1, "text", [1, 2, 3], {"a": [1, {2}]},
                                   ({"itemScores": [{"item": "i1",
                                                     "score": 0.5}]},)])
def test_approx_bytes_is_the_jax_package_s(value):
    assert pcache.approx_bytes(value) == jcache.approx_bytes(value)


@pytest.mark.parametrize("outcome", ["value", "error"])
def test_singleflight_coalesces_like_the_jax_package(outcome):
    def run(mod):
        sf = mod.SingleFlight()
        release = threading.Event()
        calls, results = [], []

        def fn():
            calls.append(1)
            release.wait(10)
            if outcome == "error":
                raise KeyError("boom")
            return 42

        def caller():
            try:
                results.append(sf.do("k", fn))
            except KeyError as e:
                results.append(("raised", str(e)))

        leader = threading.Thread(target=caller)
        leader.start()
        while sf.in_flight() == 0:
            time.sleep(0.001)
        followers = [threading.Thread(target=caller) for _ in range(5)]
        for t in followers:
            t.start()
        while sf.coalesced < 5:
            time.sleep(0.001)
        release.set()
        for t in [leader] + followers:
            t.join()
        return (len(calls), sf.coalesced, sf.in_flight(),
                sorted(map(repr, results)))

    assert run(pcache) == run(jcache)
    assert run(pcache)[:3] == (1, 5, 0)


#: scripted HotEntityTier sequences over a stub pin (handle = the key)
HOT_SEQUENCES = {
    "record-refresh-lookup": [
        ("record", "u1"), ("record", "u1"), ("record", "u2"),
        ("record", "u3"), ("refresh",), ("lookup", "u1"),
        ("lookup", "u3"), ("lookup", "u9")],
    "capacity-and-invalidate": [
        *[("record", f"u{i % 5}") for i in range(23)], ("refresh",),
        ("lookup", "u0"), ("lookup", "u4"), ("invalidate", ["u0", "u7"]),
        ("lookup", "u0"), ("refresh",), ("lookup", "u0")],
    "flush": [
        ("record", "u1"), ("refresh",), ("lookup", "u1"), ("flush",),
        ("lookup", "u1"), ("refresh",), ("lookup", "u1"),
        ("record", "u2"), ("refresh",), ("lookup", "u2")],
    "bounded-counts": [
        *[("record", f"u{i}") for i in range(40)], ("record", "u3"),
        ("refresh",), ("lookup", "u3"), ("lookup", "u39")],
}


def run_hot(mod, ops):
    def pin(keys):
        return {k: f"handle-{k}" for k in keys}, 8 * len(keys)

    tier = mod.HotEntityTier(pin, capacity=3, refresh_every=NEVER)
    out = []
    for op, *a in ops:
        if op == "refresh":
            tier.refresh(wait=True)
        else:
            out.append(getattr(tier, op)(*a))
    return out, tier.stats()


@pytest.mark.parametrize("name", sorted(HOT_SEQUENCES))
def test_hot_tier_sequences(name):
    port, jax = run_hot(pcache, HOT_SEQUENCES[name]), \
        run_hot(jcache, HOT_SEQUENCES[name])
    assert port[0] == jax[0]
    shared_stats(port[1], jax[1])
    assert port[1]["refreshErrors"] == 0 and port[1]["pinnedStale"] == 0


def test_hot_tier_counts_a_failed_refresh():
    """The JAX tier swallows a failed pin with a warning; the port's
    counts it and names it."""
    def pin(keys):
        raise RuntimeError("fused_topk kernel launch failed: CUDA error 7")

    tier = pcache.HotEntityTier(pin, capacity=2, refresh_every=NEVER)
    tier.record("u1")
    tier.refresh(wait=True)
    st = tier.stats()
    assert st["refreshErrors"] == 1 and st["refreshes"] == 0
    assert "CUDA error 7" in st["lastError"]
    assert st["entries"] == 0


def test_hot_tier_drops_keys_invalidated_during_a_refresh():
    """A refresh in flight gathered its rows before a fold-in changed
    them: it must not pin the invalidated keys."""
    started, go = threading.Event(), threading.Event()

    def pin(keys):
        started.set()
        go.wait(10)
        return {k: k for k in keys}, 0

    tier = pcache.HotEntityTier(pin, capacity=4, refresh_every=NEVER)
    for k in ("u1", "u2"):
        tier.record(k)
    tier.refresh(wait=False)
    assert started.wait(10)
    tier.invalidate(["u1"])
    go.set()
    tier.refresh(wait=True)  # waits for the one in flight
    assert tier.lookup("u1") is None and tier.lookup("u2") == "u2"
    tier.close()


def test_hot_tier_close_joins_and_refuses_new_refreshes():
    go = threading.Event()

    def pin(keys):
        go.wait(10)
        return {k: k for k in keys}, 0

    tier = pcache.HotEntityTier(pin, capacity=2, refresh_every=1)
    tier.record("u1")  # due at once: a refresh thread starts
    (refresh,) = tier._threads
    assert refresh.name == "hot-tier-refresh" and refresh.is_alive()
    timer = threading.Timer(0.1, go.set)
    timer.start()
    tier.close()
    timer.join()
    assert not refresh.is_alive()
    tier.record("u1")
    tier.refresh(wait=False)
    assert tier._threads == []


#: scripted ServingCache sequences
SERVING_SEQUENCES = {
    "bus-and-constraint": [
        ("qput", ("ns", "q-u1"), 1, ("user:u1",)),
        ("qput", ("ns", "q-u2"), 2, ("user:u2",)),
        ("fput", ("seen", "u1"), ["i1"], ("user:u1",)),
        ("publish", "user", "u1"), ("qlookup", ("ns", "q-u1")),
        ("qlookup", ("ns", "q-u2")), ("flookup", ("seen", "u1")),
        ("publish", "constraint", "unavailableItems"),
        ("qlookup", ("ns", "q-u2"))],
    "epoch-moved-by-invalidation": [
        ("token", "user:u1"), ("publish", "user", "u1"),
        ("fresh", ("ns", "q-u1"), 1, ("user:u1",)),
        ("qlookup", ("ns", "q-u1")), ("token", "user:u1"),
        ("fresh", ("ns", "q-u1"), 2, ("user:u1",)),
        ("qlookup", ("ns", "q-u1")), ("token", "user:u2"),
        ("flush_all",), ("fresh", ("ns", "q-u2"), 3, ("user:u2",))],
    "entities-and-namespaces": [
        ("qput", ("stable", "q1"), 1, ("user:u1",)),
        ("qput", ("cand", "q1"), 2, ("user:u1",)),
        ("qput", ("stable", "q2"), 3, ("user:u2",)),
        ("invalidate_entities", "user", ["u2", "u9"]),
        ("qlookup", ("stable", "q2")), ("flush_namespace", "cand"),
        ("qlookup", ("cand", "q1")), ("qlookup", ("stable", "q1")),
        ("flush_all",), ("qlookup", ("stable", "q1"))],
}


def run_serving(mod, ops):
    bus = mod.InvalidationBus()

    def pin(keys):
        return {k: k for k in keys}, 0

    sc = mod.ServingCache(bus=bus, pin_fn=pin, hot_refresh_every=NEVER)
    out, token = [], None
    for op, *a in ops:
        if op == "qput":
            sc.query.put(a[0], a[1], tags=a[2])
        elif op == "fput":
            sc.features.put(a[0], a[1], tags=a[2])
        elif op == "qlookup":
            out.append(sc.query.lookup(a[0]))
        elif op == "flookup":
            out.append(sc.features.lookup(a[0]))
        elif op == "publish":
            out.append(bus.publish(0, a[0], a[1], "view"))
        elif op == "token":
            token = sc.epoch_token(a[0])
        elif op == "fresh":
            out.append(sc.put_query_fresh(a[0], a[1], a[2], token))
        else:
            out.append(getattr(sc, op)(*a))
    return out, sc.stats()


@pytest.mark.parametrize("name", sorted(SERVING_SEQUENCES))
def test_serving_cache_sequences(name):
    port = run_serving(pcache, SERVING_SEQUENCES[name])
    jax = run_serving(jcache, SERVING_SEQUENCES[name])
    assert port[0] == jax[0]
    p, j = port[1], jax[1]
    assert set(p) == set(j) and set(p["tiers"]) == set(j["tiers"])
    for tier in j["tiers"]:
        shared_stats(p["tiers"][tier], j["tiers"][tier])
    assert {k: v for k, v in p.items() if k != "tiers"} \
        == {k: v for k, v in j.items() if k != "tiers"}


def test_serving_cache_metrics_families():
    from predictionio_tpu_torch.obs import MetricsRegistry

    sc = pcache.ServingCache(bus=pcache.InvalidationBus())
    reg = MetricsRegistry()
    sc.register_metrics(reg)
    sc.query.put(("ns", "a"), 1)
    sc.query.lookup(("ns", "a"))
    text = reg.render()
    for name in ("pio_cache_hits", "pio_cache_misses",
                 "pio_cache_evictions", "pio_cache_invalidations",
                 "pio_cache_entries", "pio_cache_bytes",
                 "pio_cache_hit_ratio", "pio_cache_singleflight_coalesced",
                 "pio_cache_flushes"):
        assert name in text, name
    assert 'tier="query"' in text and 'tier="feature"' in text


def test_closed_serving_cache_leaves_the_bus():
    bus = pcache.InvalidationBus()
    sc = pcache.ServingCache(bus=bus)
    assert bus.stats()["subscribers"] == 1
    sc.close()
    assert bus.stats()["subscribers"] == 0


# ---------------------------------------------------------------------------
# the pinned rows and the pinned serve
# ---------------------------------------------------------------------------

PIN_USERS = [5, 0, 17, 3, 22]


@pytest.mark.parametrize("quant", ["off", "int8"])
def test_pin_user_rows_matches_the_jax_package(quant):
    U, V = factors(1)
    jm, pm = jax_model(U, V), port_model(U, V)
    if quant == "int8":
        jm = jals.quantize_serving_model(jm, "int8")
        pm = pals.quantize_serving_model(pm, "int8")
    jt, jn = jals.pin_user_rows(jm, PIN_USERS, 8)
    pt, pn = pals.pin_user_rows(pm, PIN_USERS, 8)
    assert pn == jn
    if quant == "int8":
        assert isinstance(pt, pals.QuantizedFactors)
        assert pt.data.dtype == torch.int8 and pt.data.shape == (8, RANK)
        np.testing.assert_array_equal(pt.data.numpy(),
                                      np.asarray(jt.data))
        np.testing.assert_array_equal(pt.scale.numpy(),
                                      np.asarray(jt.scale))
        # the pinned rows are the source rows, bit for bit
        rows = [*PIN_USERS, 0, 0, 0]
        assert torch.equal(pt.data, pm.user_factors.data[rows])
        assert torch.equal(pt.scale, pm.user_factors.scale[rows])
    else:
        np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    assert pals.pin_user_rows(pm, [], 8) == (None, 0)


@pytest.mark.parametrize("k", [8, 10, 128, 200])
@pytest.mark.parametrize("quant", ["off", "int8"])
def test_recommend_pinned_matches_the_jax_package(quant, k):
    U, V = factors(2)
    jm, pm = jax_model(U, V), port_model(U, V)
    if quant == "int8":
        jm = jals.quantize_serving_model(jm, "int8")
        pm = pals.quantize_serving_model(pm, "int8")
    jt, _ = jals.pin_user_rows(jm, PIN_USERS, 8)
    pt, _ = pals.pin_user_rows(pm, PIN_USERS, 8)
    rtol = 1e-5 if quant == "off" else 1e-4
    for slot, user in enumerate(PIN_USERS):
        ji, js = jals.recommend_pinned(jm, jt, slot, k)
        pi, ps = pals.recommend_pinned(pm, pt, slot, k)
        assert pi.shape == (min(k, N_ITEMS),)
        np.testing.assert_array_equal(pi, np.asarray(ji))
        np.testing.assert_allclose(ps, np.asarray(js), rtol=rtol,
                                   atol=rtol)
        # and the full table's answer for the same user, exactly
        fi, fs = pals.recommend_products(pm, user, k)
        np.testing.assert_array_equal(pi, fi)
        np.testing.assert_array_equal(ps, fs)


def test_recommend_pinned_launches_fused_topk_on_the_pinned_table(
        monkeypatch):
    """The pinned serve is one ``fused_topk`` call with the pinned table
    as its user table and ``idx = [slot]`` (the CPU takes its plain
    version inside the wrapper)."""
    U, V = factors(3)
    pm = pals.quantize_serving_model(port_model(U, V), "int8")
    pt, _ = pals.pin_user_rows(pm, PIN_USERS, 8)
    seen = []
    real = pals.fused_topk

    def spy(ut, idx, vt, us=None, vs=None, **kw):
        seen.append((ut, idx.tolist(), vt, us, kw["k"]))
        return real(ut, idx, vt, us, vs, **kw)

    monkeypatch.setattr(pals, "fused_topk", spy)
    pals.recommend_pinned(pm, pt, 3, 10)
    (ut, idx, vt, us, k), = seen
    assert ut is pt.data and us is pt.scale and idx == [3]
    assert vt is pm.item_factors.data and k == 16
    # the replicated lanes' per-device tables: the copy on the device of
    # the model's item table serves, through the same one launch
    tables, nbytes = pals.pin_user_rows_lanes(pm, PIN_USERS, 8,
                                              ["cpu", "cpu"])
    assert len(tables) == 2 and nbytes == 2 * (8 * RANK + 8 * 4)
    seen.clear()
    got = pals.recommend_pinned(pm, tables, 3, 10)
    (ut, idx, vt, us, k), = seen
    assert ut is tables[0].data and us is tables[0].scale and idx == [3]
    want = pals.recommend_pinned(pm, pt, 3, 10)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_pin_hot_entities_and_its_ladder(monkeypatch):
    import predictionio_tpu_torch.templates.recommendation as rec

    U, V = factors(4)
    pm = port_model(U, V)
    algo = recommendation_engine().make_algorithms(
        recommendation_engine().params_from_variant(VARIANT))[0]
    calls = []
    real = pals.recommend_pinned

    def count(*a):
        calls.append(a[3])
        return real(*a)

    monkeypatch.setattr(rec, "recommend_pinned", count)
    handles, nbytes = algo.pin_hot_entities(
        pm, ["u3", "nobody", "u1", "u7"])
    assert calls == [8, 16, 32, 64, 128]  # 8 ... min(128, n_items)
    assert set(handles) == {"u3", "u1", "u7"}
    table, slot = handles["u1"]
    assert table.shape == (4, RANK) and slot == 1  # pow2 capacity
    assert nbytes == 4 * RANK * 4
    q = from_jsonable(algo.query_class,
                      {"user": "u1", "num": 5, "blackList": ["i3"]})
    assert algo.predict_pinned(pm, q, handles["u1"]) == algo.predict(pm, q)
    assert algo.pin_hot_entities(pm, ["nobody"]) == ({}, 0)
    # replicated lanes: one pinned table a lane device, the same answer
    lanes, lane_bytes = algo.pin_hot_entities(pm, ["u3", "u1"],
                                              devices=["cpu", "cpu"])
    tables, slot = lanes["u1"]
    assert isinstance(tables, tuple) and len(tables) == 2 and slot == 1
    assert lane_bytes == 2 * 2 * RANK * 4
    assert algo.predict_pinned(pm, q, lanes["u1"]) == algo.predict(pm, q)


# ---------------------------------------------------------------------------
# both packages' QueryServers with the cache on, query for query
# ---------------------------------------------------------------------------

def jax_server(U, V, U2, V2, quant):
    storage = JStorage(env={"PIO_STORAGE_SOURCES_MEM_TYPE": "memory"})
    ctx = JContext(app_name="cacheapp", _storage=storage)
    engine = jax_recommendation_engine()
    ep = jax_default_params("cacheapp", rank=RANK)
    insts = [JEngineInstance(
        id=iid, status="COMPLETED", start_time=T0, end_time=T0,
        engine_id="cache", engine_version="1", engine_variant="engine.json",
        engine_factory="synthetic") for iid in ("ca1", "ca2")]
    qs = JQueryServer(ctx, engine, ep, [jax_model(U, V)], insts[0],
                      JServerConfig(warm_start=False, serving_cache=True,
                                    serving_quant=quant,
                                    hot_refresh_every=NEVER))
    return qs, insts[1], [jax_model(U2, V2)]


def port_server(U, V, U2, V2, quant):
    storage = Storage(env={"PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"})
    engine = recommendation_engine()
    ep = engine.params_from_variant(VARIANT)
    insts = [EngineInstance(
        id=iid, status=STATUS_COMPLETED, start_time=T0, end_time=T0,
        engine_id="cache", engine_version="1", engine_variant="engine.json",
        engine_factory="synthetic") for iid in ("ca1", "ca2")]
    qs = QueryServer(engine, ep, [port_model(U, V)],
                     ServerConfig(device="cpu", warm_start=False,
                                  serving_cache=True, serving_quant=quant,
                                  hot_refresh_every=NEVER),
                     insts[0], Context(device="cpu", _storage=storage))
    return qs, insts[1], [port_model(U2, V2)]


def folded(qs, U2row, port: bool, quant: str, U, V):
    """The bound model with user 2's row replaced: what a fold-in hands
    ``apply_stream_delta``."""
    U = U.copy()
    U[2] = U2row
    if port:
        m = port_model(U, V)
        if quant != "off":
            m = pals.quantize_serving_model(m, quant)
        return qs.algorithms[0].prepare_serving_model(m, qs.device)
    m = jax_model(U, V)
    return jals.quantize_serving_model(m, quant) if quant != "off" else m


def drive(qs, cand_inst, cand_models, bus, port, quant, U, V):
    """The query sequence: answers, hot hits and misses, stats."""
    answers = []

    def serve(q):
        answers.append(qs.serve(q))

    for q in ([{"user": "u1", "num": 3}] * 3 + [{"user": "u2", "num": 4}] * 2
              + [{"user": "u3", "num": 2}, {"num": 3, "user": "u1"},
                 {"user": "stranger", "num": 5},
                 {"user": "u4", "num": 3, "blackList": ["i1", "i2"]}]):
        serve(q)
    qs.cache.hot.refresh(wait=True)
    qs.cache.query.flush()
    for q in ({"user": "u1", "num": 3}, {"user": "u2", "num": 4},
              {"user": "u9", "num": 3}):
        serve(q)
    # an ingest for u1 through the bus
    bus.publish(0, "user", "u1", "view")
    serve({"user": "u1", "num": 3})
    serve({"user": "u2", "num": 4})
    # a fold-in that rewrote u2's row
    row = np.full(RANK, 0.75, np.float32)
    assert qs.apply_stream_delta(0, folded(qs, row, port, quant, U, V),
                                 ["u2"], "ca1")
    qs.cache.hot.refresh(wait=True)
    serve({"user": "u2", "num": 4})
    serve({"user": "u1", "num": 3})
    # a candidate beside stable, then its promotion (a rebind)
    qs.bind_candidate(cand_inst, models=cand_models)
    answers.append(qs.serve_candidate({"user": "u1", "num": 3}))
    answers.append(qs.serve_candidate({"user": "u1", "num": 3}))
    keys = sorted({k[0] for s in qs.cache.query._shards for k in s.entries})
    qs.promote_candidate()
    serve({"user": "u1", "num": 3})
    return answers, keys, qs.cache.stats()


def rebus(qs, mod):
    bus = mod.InvalidationBus()
    qs.cache.bus.unsubscribe(qs.cache)
    qs.cache.bus = bus
    bus.subscribe(qs.cache)
    return bus


@pytest.mark.parametrize("quant", ["off", "int8"])
def test_query_servers_with_the_cache_answer_alike(quant):
    U, V = factors(5)
    U2, V2 = factors(6)
    jqs, jinst, jm2 = jax_server(U, V, U2, V2, quant)
    pqs, pinst, pm2 = port_server(U, V, U2, V2, quant)
    try:
        jout = drive(jqs, jinst, jm2, rebus(jqs, jcache), False, quant,
                     U, V)
        pout = drive(pqs, pinst, pm2, rebus(pqs, pcache), True, quant,
                     U, V)
    finally:
        jqs.close()
        pqs.close()
    rtol = 1e-5 if quant == "off" else 1e-4
    for p, j in zip(pout[0], jout[0], strict=True):
        assert [s["item"] for s in p["itemScores"]] \
            == [s["item"] for s in j["itemScores"]]
        np.testing.assert_allclose([s["score"] for s in p["itemScores"]],
                                   [s["score"] for s in j["itemScores"]],
                                   rtol=rtol, atol=rtol)
    assert pout[1] == jout[1] == ["ca1", "ca2"]
    p, j = pout[2], jout[2]
    assert set(p) == set(j) and set(p["tiers"]) == set(j["tiers"])
    for tier in j["tiers"]:
        assert set(p["tiers"][tier]) - set(j["tiers"][tier]) \
            <= PORT_HOT_KEYS
        for key in ("hits", "misses", "invalidations", "entries"):
            assert p["tiers"][tier][key] == j["tiers"][tier][key], \
                (tier, key)
    for key in ("flushes", "busEvents", "singleflightCoalesced",
                "stalePutDrops"):
        assert p[key] == j[key], key
    hot = p["tiers"]["hot"]
    assert hot["hits"] >= 4 and hot["refreshErrors"] == 0 \
        and hot["pinnedStale"] == 0


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------

def start(U, V, **cfg):
    engine = recommendation_engine()
    ep = engine.params_from_variant(VARIANT)
    return deploy_models(engine, ep, [port_model(U, V)],
                         ServerConfig(device="cpu", **cfg), "127.0.0.1",
                         0).start_background()


def call(srv, method, path, body=None):
    data = (json.dumps(body).encode() if body is not None
            else (b"" if method == "POST" else None))
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}",
                                 data=data, method=method,
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with LOCAL.open(req, timeout=30) as resp:
            raw = resp.read()
            if "json" in resp.headers.get("Content-Type", ""):
                return resp.status, json.loads(raw)
            return resp.status, raw.decode()
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def test_cache_routes_when_off():
    U, V = factors(7)
    srv = start(U, V)
    try:
        status, body = call(srv, "GET", "/cache.json")
        assert status == 200 and body["enabled"] is False
        assert "--cache" in body["hint"]
        assert call(srv, "POST", "/cache/flush")[0] == 409
        assert call(srv, "GET", "/status.json")[1]["cache"] \
            == {"enabled": False}
        assert "cache hit ratio" not in call(srv, "GET", "/")[1]
    finally:
        srv.close()


def test_cache_routes_status_page_metrics_and_key_guard():
    U, V = factors(8)
    srv = start(U, V, serving_cache=True, accesskey="K",
                hot_refresh_every=NEVER)
    try:
        for _ in range(3):
            status, _ = call(srv, "POST", "/queries.json",
                             {"user": "u1", "num": 3})
            assert status == 200
        status, cj = call(srv, "GET", "/cache.json")
        assert status == 200 and cj["enabled"]
        assert cj["tiers"]["query"]["hits"] == 2
        assert set(cj["tiers"]) == {"query", "feature", "hot"}
        assert cj["tiers"]["hot"]["records"] == 3
        assert call(srv, "GET", "/status.json")[1]["cache"]["enabled"]
        assert "cache hit ratio: query 67% of 3" in call(srv, "GET", "/")[1]
        _, text = call(srv, "GET", "/metrics")
        assert 'pio_cache_hits{tier="query"} 2' in text
        assert call(srv, "POST", "/cache/flush")[0] in (401, 403)
        assert srv.query_server.cache.stats()["tiers"]["query"]["entries"]
        status, fl = call(srv, "POST", "/cache/flush?accessKey=K")
        assert status == 200 and fl["removed"]["query"] == 1
        assert set(fl["removed"]) == {"query", "feature", "hot"}
        assert call(srv, "GET", "/cache.json")[1]["tiers"]["query"][
            "entries"] == 0
    finally:
        srv.close()


def test_a_hit_is_traced_and_a_follower_is_coalesced():
    U, V = factors(9)
    srv = start(U, V, serving_cache=True, trace_slow_ms=1e-6)
    qs = srv.query_server
    try:
        qs.serve({"user": "u1", "num": 3})
        obs = {}
        qs.serve({"user": "u1", "num": 3}, obs=obs)
        assert obs["cache"] == "hit"
        _, rec = call(srv, "GET", "/trace.json")
        call(srv, "POST", "/queries.json", {"user": "u1", "num": 3})
        _, rec = call(srv, "GET", "/trace.json?slowest=50")
        tid = next(t["traceId"] for t in rec["traces"]
                   if t["name"] == "POST /queries.json")
        _, tr = call(srv, "GET", f"/trace.json?id={tid}")
        names = [e["name"] for e in tr["traceEvents"][1:]]
        assert "cache_hit" in names
        # concurrent identical misses: one compute, the rest coalesced
        algo = qs.algorithms[0]
        real = algo.predict
        gate = threading.Event()

        def slow(model, query):
            gate.wait(5)
            return real(model, query)

        algo.predict = slow
        obs_list = [{} for _ in range(4)]
        threads = [threading.Thread(target=qs.serve,
                                    args=({"user": "u5", "num": 2}, o))
                   for o in obs_list]
        for t in threads:
            t.start()
        while qs.cache.flight.coalesced < 3:
            time.sleep(0.005)
        gate.set()
        for t in threads:
            t.join()
        assert sorted(o.get("cache", "") for o in obs_list) \
            == ["", "coalesced", "coalesced", "coalesced"]
    finally:
        srv.close()


def pinned_server(U, V, **cfg):
    srv = start(U, V, serving_cache=True, hot_refresh_every=NEVER, **cfg)
    qs = srv.query_server
    qs.warm_done.wait(30)
    qs.serve({"user": "u2", "num": 3})
    qs.cache.hot.refresh(wait=True)
    qs.cache.query.flush()
    return srv, qs


def test_a_stale_handle_is_served_through_the_full_table_and_counted():
    U, V = factors(10)
    srv, qs = pinned_server(U, V)
    try:
        pinned = dict(qs.cache.hot._pinned)
        assert pinned["u2"][0] == qs.binding_id
        want = qs.serve({"user": "u2", "num": 3})
        assert qs.cache.hot.stats()["hits"] == 1
        qs.cache.query.flush()
        # a pin that raced a rebind: the handle names the old binding
        qs._bind(qs.engine_params, [port_model(U, V)])
        assert qs.binding_id != pinned["u2"][0]
        qs.cache.hot._pinned = pinned
        served = []
        real = qs.algorithms[0].predict_pinned
        qs.algorithms[0].predict_pinned = lambda *a: served.append(a) \
            or real(*a)
        assert qs.serve({"user": "u2", "num": 3}) == want
        assert served == []
        st = qs.cache.hot.stats()
        assert st["pinnedStale"] == 1 and st["hits"] == 2
    finally:
        srv.close()


def test_a_raising_pinned_serve_is_a_500_not_a_fallback():
    U, V = factors(11)
    srv, qs = pinned_server(U, V)
    try:
        full = []
        algo = qs.algorithms[0]
        real_predict = algo.predict

        def boom(*a):
            raise RuntimeError("fused_topk kernel launch failed: CUDA "
                               "error 719")

        def predict(*a):
            full.append(a)
            return real_predict(*a)

        algo.predict_pinned = boom
        algo.predict = predict
        status, body = call(srv, "POST", "/queries.json",
                            {"user": "u2", "num": 3})
        assert status == 500 and "CUDA error 719" in body["message"]
        assert full == []
        assert qs.query_errors.get("500") == 1
        assert qs.cache.stats()["tiers"]["query"]["entries"] == 0
    finally:
        srv.close()


def test_a_pinned_serve_answers_as_the_full_table():
    U, V = factors(12)
    srv, qs = pinned_server(U, V, serving_quant="int8")
    try:
        want = qs.query({"user": "u2", "num": 7, "blackList": ["i4"]})
        qs.cache.hot.flush()
        qs.serve({"user": "u2", "num": 7})
        qs.cache.hot.refresh(wait=True)
        before = qs.cache.hot.stats()["hits"]
        got = qs.serve({"user": "u2", "num": 7, "blackList": ["i4"]})
        assert qs.cache.hot.stats()["hits"] == before + 1
        assert got == want
    finally:
        srv.close()


def test_fold_in_invalidates_touched_users_and_repins():
    U, V = factors(13)
    srv, qs = pinned_server(U, V)
    try:
        qs.serve({"user": "u3", "num": 3})
        qs.cache.hot.refresh(wait=True)
        a2 = qs.serve({"user": "u2", "num": 3})
        a3 = qs.serve({"user": "u3", "num": 3})
        st0 = qs.cache.stats()
        U2 = U.copy()
        U2[2] = -U[2]
        new = qs.algorithms[0].prepare_serving_model(port_model(U2, V),
                                                     qs.device)
        assert qs.apply_stream_delta(0, new, ["u2"], qs.binding_id)
        qs.cache.hot.refresh(wait=True)  # the re-pin the apply started
        assert qs.cache.hot.stats()["refreshes"] \
            > st0["tiers"]["hot"]["refreshes"]
        st = qs.cache.stats()
        assert st["tiers"]["query"]["invalidations"] \
            == st0["tiers"]["query"]["invalidations"] + 1
        hits = qs.cache.hot.stats()["hits"]
        got = qs.serve({"user": "u2", "num": 3})
        assert qs.cache.hot.stats()["hits"] == hits + 1  # re-pinned
        assert got == qs.query({"user": "u2", "num": 3}) != a2
        assert qs.serve({"user": "u3", "num": 3}) == a3  # untouched hit
        # an untouched pinned user keeps its handle
        assert qs.cache.hot.lookup("u3") is not None
    finally:
        srv.close()


def test_reload_flushes_every_tier():
    storage = Storage(env={"PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"})
    storage.apps().insert(App(0, "cacheapp"))
    for iid, seed in (("rl1", 14), ("rl2", 15)):
        storage.engine_instances().insert(EngineInstance(
            id=iid, status=STATUS_COMPLETED, start_time=T0, end_time=T0,
            engine_id="cache", engine_version="1",
            engine_variant="engine.json", engine_factory="synthetic"))
        storage.models().insert(Model(iid, dumps_models(
            [port_model(*factors(seed))])))
    engine = recommendation_engine()
    srv = deploy(Context(device="cpu", _storage=storage), engine,
                 engine.params_from_variant(VARIANT), "cache", "1",
                 "engine.json", ServerConfig(device="cpu",
                                             serving_cache=True,
                                             hot_refresh_every=NEVER),
                 "127.0.0.1", 0).start_background()
    qs = srv.query_server
    try:
        qs.serve({"user": "u1", "num": 3})
        qs.cache.hot.refresh(wait=True)
        qs.cache.features.put(("seen", "u1"), {"i1"})
        st = qs.cache.stats()["tiers"]
        assert st["query"]["entries"] == st["hot"]["entries"] == 1
        flushes = qs.cache.stats()["flushes"]
        assert call(srv, "POST", "/reload")[0] == 200
        st = qs.cache.stats()
        assert st["flushes"] == flushes + 1
        assert all(t["entries"] == 0 for t in st["tiers"].values())
    finally:
        srv.close()


def test_rollback_flushes_the_candidate_namespace_only():
    U, V = factors(16)
    pqs, pinst, pm2 = port_server(U, V, *factors(17), "off")
    try:
        pqs.serve({"user": "u1", "num": 3})
        pqs.bind_candidate(pinst, models=pm2)
        pqs.serve_candidate({"user": "u1", "num": 3})
        ns = {k[0] for s in pqs.cache.query._shards for k in s.entries}
        assert ns == {"ca1", "ca2"}
        pqs.drop_candidate()
        ns = {k[0] for s in pqs.cache.query._shards for k in s.entries}
        assert ns == {"ca1"}
    finally:
        pqs.close()


def test_ingest_through_the_event_server_invalidates():
    from predictionio_tpu_torch.server.eventserver import (
        create_event_server,
    )

    storage = Storage(env={"PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"})
    app_id = storage.apps().insert(App(0, "cacheapp"))
    storage.access_keys().insert(AccessKey("CK", app_id, ()))
    U, V = factors(18)
    srv = start(U, V, serving_cache=True)
    ev = create_event_server(storage, "127.0.0.1", 0).start_background()
    try:
        call(srv, "POST", "/queries.json", {"user": "u1", "num": 3})
        call(srv, "POST", "/queries.json", {"user": "u2", "num": 3})
        before = call(srv, "GET", "/cache.json")[1]
        status, _ = call(ev, "POST", "/events.json?accessKey=CK",
                         {"event": "rate", "entityType": "user",
                          "entityId": "u1", "targetEntityType": "item",
                          "targetEntityId": "i5",
                          "properties": {"rating": 4}})
        assert status == 201
        after = call(srv, "GET", "/cache.json")[1]
        assert after["tiers"]["query"]["invalidations"] \
            == before["tiers"]["query"]["invalidations"] + 1
        assert after["busEvents"] == before["busEvents"] + 1
        obs = {}
        srv.query_server.serve({"user": "u1", "num": 3}, obs=obs)
        assert "cache" not in obs  # a miss
        srv.query_server.serve({"user": "u2", "num": 3}, obs=obs)
        assert obs["cache"] == "hit"
    finally:
        ev.close()
        srv.close()


def test_the_feature_tier_reaches_the_algorithms(monkeypatch):
    import predictionio_tpu_torch.templates.recommendation as rec

    got = []
    monkeypatch.setattr(rec.ALSAlgorithm, "bind_feature_cache",
                        lambda self, c: got.append(c), raising=False)
    U, V = factors(19)
    srv = start(U, V, serving_cache=True)
    try:
        assert got == [srv.query_server.cache.features]
    finally:
        srv.close()
    srv = start(U, V)
    srv.close()
    assert len(got) == 1  # no cache: nothing handed


def wait_threads(limit, timeout=10.0):
    deadline = time.monotonic() + timeout
    while threading.active_count() > limit and time.monotonic() < deadline:
        time.sleep(0.05)
    return threading.active_count()


@pytest.mark.parametrize("how", ["stop", "close"])
@pytest.mark.parametrize("batching", [False, True])
def test_shutdown_with_the_cache_leaves_no_threads(how, batching):
    """The cache-on counterpart of the engine server's shutdown test: a
    refresh thread still pinning when the server closes is joined."""
    U, V = factors(20)
    base = wait_threads(threading.active_count())
    srv = start(U, V, serving_cache=True, batching=batching,
                hot_refresh_every=2)
    qs = srv.query_server
    algo = qs.algorithms[0]
    real = algo.pin_hot_entities

    def slow_pin(*a, **kw):
        time.sleep(0.3)
        return real(*a, **kw)

    algo.pin_hot_entities = slow_pin
    for u in ("u1", "u1", "u2", "u2"):
        call(srv, "POST", "/queries.json", {"user": u, "num": 3})
    assert any(t.name == "hot-tier-refresh" for t in threading.enumerate())
    if how == "stop":
        assert call(srv, "POST", "/stop", {})[0] == 200
    else:
        srv.close()
    assert wait_threads(base) <= base
    assert qs.cache.hot.stats()["refreshErrors"] == 0


# ---------------------------------------------------------------------------
# the commands
# ---------------------------------------------------------------------------

def test_cli_cache_stats_and_flush(capsys):
    U, V = factors(21)
    srv = start(U, V, serving_cache=True, accesskey="K")
    try:
        qs = srv.query_server
        qs.serve({"user": "u1", "num": 3})
        qs.serve({"user": "u1", "num": 3})
        port = str(srv.port)
        assert cli.main(["cache", "stats", "--port", port]) == 0
        out = capsys.readouterr().out
        assert "query: 1 entries, 50.0% hit ratio over 2 lookups" in out
        assert cli.main(["cache", "flush", "--port", port]) == 1
        assert "cache flush failed" in capsys.readouterr().err
        assert cli.main(["cache", "flush", "--port", port,
                         "--accesskey", "K"]) == 0
        assert "Flushed: query=1" in capsys.readouterr().out
        assert len(qs.cache.query) == 0
    finally:
        srv.close()
    off = start(U, V)
    try:
        assert cli.main(["cache", "stats", "--port", str(off.port)]) == 0
        assert "Serving cache is OFF" in capsys.readouterr().out
    finally:
        off.close()
    assert cli.main(["cache", "stats", "--port", port]) == 1


def test_cli_deploy_cache_flags_reach_the_server_config(tmp_path):
    U, V = factors(22)
    (tmp_path / "engine.json").write_text(json.dumps(VARIANT))
    (tmp_path / "model.bin").write_bytes(dumps_models([port_model(U, V)]))
    base = ["deploy", "--engine-json", str(tmp_path / "engine.json"),
            "--model", str(tmp_path / "model.bin"), "--device", "cpu",
            "--ip", "127.0.0.1", "--port", "0"]
    srv = cli.build_deploy(cli._parser().parse_args(
        base + ["--cache", "--cache-entries", "64", "--cache-ttl", "7",
                "--feature-ttl", "2", "--hot-entities", "16"]))
    try:
        cfg = srv.query_server.config
        assert (cfg.serving_cache, cfg.cache_entries, cfg.cache_ttl_sec,
                cfg.feature_ttl_sec, cfg.hot_entities) \
            == (True, 64, 7.0, 2.0, 16)
        cache = srv.query_server.cache
        assert cache.query.max_entries == 64 and cache.hot.capacity == 16
        assert cache.features.ttl_sec == 2.0
    finally:
        srv.close()
    srv = cli.build_deploy(cli._parser().parse_args(base))
    try:
        assert srv.query_server.cache is None
        assert dataclasses.asdict(srv.query_server.config)[
            "serving_cache"] is False
    finally:
        srv.close()


def test_server_config_defaults_are_the_jax_package_s():
    port, jax = ServerConfig(), JServerConfig()
    for name in ("serving_cache", "cache_entries", "cache_ttl_sec",
                 "feature_cache_entries", "feature_ttl_sec", "hot_entities",
                 "hot_refresh_every"):
        assert getattr(port, name) == getattr(jax, name), name


def test_http_error_is_raised_not_cached():
    U, V = factors(23)
    srv = start(U, V, serving_cache=True)
    try:
        qs = srv.query_server
        for _ in range(2):
            with pytest.raises(HTTPError):
                qs.serve({"bogus": 1})
        assert len(qs.cache.query) == 0
    finally:
        srv.close()
