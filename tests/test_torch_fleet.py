"""The port's fleet plane against the JAX package's: the histogram merge
and rebuild, the sketch merge, the aggregator's exact merge (two
aggregators, one of each package, fed the same scrapes of the same two
port engine servers), and a fleet of port replicas behind the port's
router against a JAX fleet of the same model behind the JAX router.
"""

import json
import math
import os
import re
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from datetime import datetime, timezone
from pathlib import Path

import numpy as np
import pytest

import predictionio_tpu.cli as jcli
import predictionio_tpu.fleet as jfleet
import predictionio_tpu.models.als as jals
import predictionio_tpu.obs as jobs
import predictionio_tpu.router as jrouter
import predictionio_tpu.server.engineserver as jes
from predictionio_tpu.controller import Context as JContext
from predictionio_tpu.data.bimap import BiMap as JBiMap
from predictionio_tpu.data.storage import App as JApp
from predictionio_tpu.data.storage import Storage as JStorage
from predictionio_tpu.data.storage.base import STATUS_COMPLETED as J_DONE
from predictionio_tpu.data.storage.base import EngineInstance as JInstance
from predictionio_tpu.templates.recommendation import (
    default_engine_params as jax_engine_params,
)
from predictionio_tpu.templates.recommendation import (
    recommendation_engine as jax_engine,
)
from predictionio_tpu_torch import cli
from predictionio_tpu_torch import faults as pfaults
from predictionio_tpu_torch import fleet as pfleet
from predictionio_tpu_torch import obs as pobs
from predictionio_tpu_torch.controller.context import Context
from predictionio_tpu_torch.data.storage.base import (
    STATUS_COMPLETED,
    App,
    EngineInstance,
    Model,
)
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.models.convert import (
    als_model_from_numpy,
    factors_to_numpy,
)
from predictionio_tpu_torch.server.engineserver import (
    QueryServer,
    ServerConfig,
    create_engine_server,
)
from predictionio_tpu_torch.templates.recommendation import (
    recommendation_engine,
)
from predictionio_tpu_torch.workflow.persistence import dumps_models

ROOT = Path(__file__).resolve().parents[1]
CI_SPECS = str(ROOT / "slo" / "specs" / "ci.json")
BOUNDS = [0.001, 0.01, 0.1, 1.0, 10.0]
N_USERS, N_ITEMS, RANK = 40, 60, 8
APP = "fleetapp"
VARIANT = {"id": "fleet", "version": "1",
           "algorithms": [{"name": "als", "params": {"rank": RANK}}]}

#: loopback only: no proxy from the environment may carry these requests
LOCAL = urllib.request.build_opener(urllib.request.ProxyHandler({}))


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    pfaults.clear()


def hist_of(obs, samples, bounds=BOUNDS):
    h = obs.StreamingHistogram(bounds)
    for v in samples:
        h.record(float(v))
    return h


def hist_view(h):
    return (h.bucket_counts(), h.count, h.sum, h.min, h.max,
            [h.quantile(q) for q in (0.5, 0.9, 0.99, 0.999)])


# -- the histogram merge --------------------------------------------------------

def test_the_bucket_bounds_are_the_jax_packages():
    """A merged p99 is the pooled population's only when every replica
    buckets alike: the port's default bounds are the JAX package's."""
    assert pobs.DEFAULT_LATENCY_BOUNDS == jobs.DEFAULT_LATENCY_BOUNDS
    assert pobs.POW2_COUNT_BOUNDS == jobs.POW2_COUNT_BOUNDS


def splits(samples):
    s = list(samples)
    third = len(s) // 3
    srt = sorted(s)
    return {"round_robin": [s[0::3], s[1::3], s[2::3]],
            "sorted_thirds": [srt[:third], srt[third:2 * third],
                              srt[2 * third:]],
            "one_idle": [s, [], []],
            "singleton_heavy": [s[:1], s[1:2], s[2:]]}


@pytest.mark.parametrize("split", ["round_robin", "sorted_thirds",
                                   "one_idle", "singleton_heavy"])
def test_merge_of_splits_is_the_pooled_population_as_in_jax(split):
    samples = np.random.default_rng(42).lognormal(-3.0, 1.5, 2000)
    views = {}
    for name, obs in (("jax", jobs), ("port", pobs)):
        merged = obs.StreamingHistogram(BOUNDS)
        for part in splits(samples)[split]:
            merged.merge(hist_of(obs, part))
        views[name] = hist_view(merged)
    assert views["port"] == views["jax"]
    whole = hist_of(pobs, samples)
    assert views["port"][0] == whole.bucket_counts()
    assert views["port"][5] == hist_view(whole)[5]


SAMPLE_SETS = {
    "spread": [0.0005, 0.05, 0.05, 0.7, 42.0],
    "one": [0.003],
    "overflow": [11.0, 12.0, 99.0],
    "empty": [],
}


@pytest.mark.parametrize("name", sorted(SAMPLE_SETS))
@pytest.mark.parametrize("moments", [True, False])
def test_from_buckets_rebuilds_as_the_jax_package(name, moments):
    views = {}
    for pkg, obs in (("jax", jobs), ("port", pobs)):
        h = hist_of(obs, SAMPLE_SETS[name])
        exported = [["+Inf" if math.isinf(le) else le, c]
                    for le, c in h.bucket_counts()]
        kw = dict(sum=h.sum, minimum=h.min, maximum=h.max) \
            if moments else {}
        views[pkg] = hist_view(obs.StreamingHistogram.from_buckets(
            exported, **kw))
    assert views["port"] == views["jax"]


@pytest.mark.parametrize("buckets", [
    [(math.inf, 1)], [(0.1, 1), (1.0, 2)],
    [(0.1, 5), (1.0, 3), (math.inf, 6)]], ids=["short", "no-inf", "regress"])
def test_from_buckets_refuses_as_the_jax_package(buckets):
    with pytest.raises(ValueError) as jerr:
        jobs.StreamingHistogram.from_buckets(buckets)
    with pytest.raises(ValueError) as perr:
        pobs.StreamingHistogram.from_buckets(buckets)
    assert str(perr.value) == str(jerr.value)


def test_merge_refuses_other_bounds_and_takes_empties():
    with pytest.raises(ValueError) as jerr:
        hist_of(jobs, [0.1]).merge(jobs.StreamingHistogram([1.0, 2.0]))
    with pytest.raises(ValueError) as perr:
        hist_of(pobs, [0.1]).merge(pobs.StreamingHistogram([1.0, 2.0]))
    assert str(perr.value) == str(jerr.value)
    h = hist_of(pobs, [0.05, 0.2])
    h.merge(pobs.StreamingHistogram(BOUNDS))
    e = pobs.StreamingHistogram(BOUNDS)
    e.merge(h)
    assert hist_view(e) == hist_view(h)


# -- the sketch merge and remove_matching -----------------------------------------

@pytest.mark.parametrize("capacity", [4, 8, 128])
def test_merge_items_equal(capacity):
    draws = [np.random.default_rng(capacity + i).zipf(1.5, 400)
             for i in range(3)]
    out = {}
    for pkg, obs in (("jax", jobs), ("port", pobs)):
        fleet = obs.SpaceSaving(capacity=capacity)
        for d in draws:
            sk = obs.SpaceSaving(capacity=capacity)
            for u in d:
                sk.record(f"u{u}")
            snap = sk.snapshot(capacity)
            fleet.merge_items(snap["top"], total=snap["total"])
        fleet.merge_items([{"key": ""}, {"key": "u1", "count": 2.0}])
        out[pkg] = (fleet.top(), fleet.total, fleet.snapshot())
    assert out["port"] == out["jax"]
    assert out["port"][1] == 1200.0


def test_remove_matching_equal():
    out = {}
    for pkg, obs in (("jax", jobs), ("port", pobs)):
        reg = obs.MetricsRegistry()
        fam = reg.gauge("g")
        for r in ("a:1", "b:2"):
            for s in ("x", "y"):
                fam.labels(replica=r, state=s).set(1)
        fam.labels(agg="min").set(0)
        removed = fam.remove_matching(replica="a:1")
        none = fam.remove_matching(replica="zz")
        out[pkg] = (removed, none, sorted(i for i, _ in fam.children()))
    assert out["port"] == out["jax"]
    assert out["port"][0] == 2


# -- the aggregator's merge over fake replicas ---------------------------------------

def replica_registry(obs, queries, lat, gauge_val):
    reg = obs.MetricsRegistry()
    reg.counter("pio_http_requests_total", "req").labels(
        route="/queries.json", status="200").inc(queries)
    reg.counter("pio_http_requests_total", "req").labels(
        route="/queries.json", status="500").inc(queries // 10)
    h = reg.histogram("pio_http_request_duration_seconds", "lat",
                      bounds=BOUNDS).labels(route="/queries.json")
    for v in lat:
        h.observe(v)
    reg.gauge("pio_inflight_requests", "inflight").set(gauge_val)
    reg.gauge("pio_slo_burn_rate", "a replica's own verdict").labels(
        slo="queries", window="fast").set(9.0)
    return reg


class FakeFleet:
    """Three fake replicas (port registries) behind an injected fetch
    shared by a JAX and a port aggregator."""

    def __init__(self, **cfg):
        self.regs = {
            "r0": replica_registry(pobs, 10, [0.002] * 4, 1.0),
            "r1": replica_registry(pobs, 20, [0.002, 0.5], 2.0),
            "r2": replica_registry(pobs, 30, [5.0], 4.0),
        }
        self.status = {n: {"servingWarm": True, "lifecycle": "ready",
                           "requestCount": i,
                           "hotKeys": {"total": 3.0 + i, "top": [
                               {"key": f"u{i}", "count": 3.0,
                                "error": 0.0},
                               {"key": "u9", "count": float(i),
                                "error": 0.0}]}}
                       for i, n in enumerate(self.regs)}
        self.dead = set()
        self.aggs = {
            "jax": jfleet.FleetAggregator(jfleet.FleetConfig(
                replicas=list(self.regs), slo_interval_sec=0.0, **cfg),
                fetch=self.fetch),
            "port": pfleet.FleetAggregator(pfleet.FleetConfig(
                replicas=list(self.regs), slo_interval_sec=0.0, **cfg),
                fetch=self.fetch)}

    def fetch(self, url, timeout):
        name = url.split("://", 1)[1].split("/", 1)[0]
        if name in self.dead:
            raise OSError(f"{name} is down")
        path = url.split(name, 1)[1]
        if path == "/metrics.json":
            return 200, json.loads(json.dumps(self.regs[name].export()))
        if path == "/status.json":
            return 200, self.status[name]
        raise AssertionError(url)

    def cycle(self):
        return {pkg: agg.scrape_cycle() for pkg, agg in self.aggs.items()}


#: families whose values are timing or this process's own resources
VOLATILE = re.compile(r"^pio_(fleet_(scrape_seconds|last_scrape_age_seconds"
                      r"|qps|capacity_headroom)|process_"
                      r"|metrics_render_seconds|http_)")


def merged_view(agg, volatile=VOLATILE):
    out = {}
    for name, fam in agg.registry.export().items():
        if volatile.match(name) and name != "pio_http_requests_total" \
                and name != "pio_http_request_duration_seconds":
            continue
        out[name] = fam
    return out


def fleet_view(agg):
    st = agg.fleet_status()
    drop = {"lastScrapeAgeSec", "scrapeSec"}
    return dict(
        {k: v for k, v in st.items()
         if k not in ("replicas", "qps", "capacityHeadroom")},
        replicas=[{k: v for k, v in r.items() if k not in drop}
                  for r in st["replicas"]])


def assert_same_merge(f):
    assert merged_view(f.aggs["port"]) == merged_view(f.aggs["jax"])
    assert fleet_view(f.aggs["port"]) == fleet_view(f.aggs["jax"])
    # qps (and the headroom under a knee) reads each aggregator's own
    # clock between its cycles
    ps, js = (f.aggs[k].capacity_signals() for k in ("port", "jax"))
    assert ps["kneeQps"] == js["kneeQps"]
    assert (ps["headroom"] is None) == (js["headroom"] is None)


def restart(f, name):
    f.regs[name] = replica_registry(pobs, 3, [0.002], 0.0)


AGG_SCENARIOS = {
    "steady": lambda f: None,
    "counter-reset": lambda f: restart(f, "r1"),
    "down": lambda f: f.dead.add("r2"),
    "draining-departs": lambda f: (
        f.status["r0"].update(lifecycle="draining"), f.cycle(),
        f.dead.add("r0")),
    "remove-and-rejoin": lambda f: [
        agg.remove_replica("r1") for agg in f.aggs.values()] + [
        agg.add_replica("r1") for agg in f.aggs.values()],
    "add-replica": lambda f: (
        f.regs.__setitem__("r3", replica_registry(pobs, 7, [0.02], 9.0)),
        f.status.__setitem__("r3", {"servingWarm": True}),
        [agg.add_replica("r3") for agg in f.aggs.values()]),
}


@pytest.mark.parametrize("scenario", sorted(AGG_SCENARIOS))
def test_the_merge_matches_the_jax_aggregator(scenario):
    f = FakeFleet(stale_after_sec=60.0)
    f.cycle()
    assert_same_merge(f)
    for reg in f.regs.values():
        reg.counter("pio_http_requests_total").labels(
            route="/queries.json", status="200").inc(5)
        reg.histogram("pio_http_request_duration_seconds").labels(
            route="/queries.json").observe(0.05)
    AGG_SCENARIOS[scenario](f)
    outcomes = f.cycle()
    assert outcomes["port"] == outcomes["jax"]
    assert_same_merge(f)
    f.cycle()
    assert_same_merge(f)
    merged = f.aggs["port"].registry.get("pio_slo_burn_rate")
    assert merged is None  # a replica's own verdicts never merge


def test_counters_sum_and_histograms_pool_exactly():
    f = FakeFleet()
    f.cycle()
    agg = f.aggs["port"]
    want = {items: c.value for items, c in agg.registry.get(
        "pio_http_requests_total").children()}
    assert want[(("route", "/queries.json"), ("status", "200"))] == 60.0
    (items, child), = agg.registry.get(
        "pio_http_request_duration_seconds").children()
    assert child.count == 7 and child.max == 5.0
    restart(f, "r0")
    f.cycle()
    got = {items: c.value for items, c in agg.registry.get(
        "pio_http_requests_total").children()}
    assert got[(("route", "/queries.json"), ("status", "200"))] == 63.0
    resets = agg.registry.get("pio_fleet_counter_resets_total")
    assert sum(c.value for _, c in resets.children()) >= 1


def test_capacity_signals_with_a_knee_match(tmp_path):
    cap = tmp_path / "CAPACITY.json"
    cap.write_text(json.dumps({"configs": {"a": {"knee_qps": 40.0},
                                           "b": {"knee_qps": 80.0}}}))
    f = FakeFleet(capacity_path=str(cap))
    f.cycle()
    assert f.aggs["port"].capacity_signals()["kneeQps"] == 80.0
    assert_same_merge(f)


# -- two aggregators, one of each package, over two port engine servers ------------

def ids(prefix, n):
    return {f"{prefix}{i}": i for i in range(n)}


@pytest.fixture(scope="module")
def jmodel():
    rng = np.random.default_rng(5)
    return jals.ALSModel(
        user_factors=rng.standard_normal((N_USERS, RANK)).astype(
            np.float32),
        item_factors=rng.standard_normal((N_ITEMS, RANK)).astype(
            np.float32),
        n_users=N_USERS, n_items=N_ITEMS,
        user_ids=JBiMap(ids("u", N_USERS)),
        item_ids=JBiMap(ids("i", N_ITEMS)),
        params=jals.ALSParams(rank=RANK))


def port_model(jmodel):
    """The JAX model's weights carried across by ``models/convert.py``."""
    U, V = factors_to_numpy(jmodel.user_factors, jmodel.item_factors)
    return als_model_from_numpy(U, V, N_USERS, N_ITEMS, ids("u", N_USERS),
                                ids("i", N_ITEMS), {"rank": RANK},
                                device="cpu")


def instance(cls, iid="f0"):
    now = datetime.now(timezone.utc)
    return cls(id=iid, status=J_DONE, start_time=now, end_time=now,
               engine_id="fleet", engine_version="1",
               engine_variant="engine.json", engine_factory="synthetic")


def port_replica(jmodel, port=0, **cfg):
    storage = Storage(env={"PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"})
    storage.apps().insert(App(0, APP))
    inst = instance(EngineInstance)
    storage.engine_instances().insert(inst)
    engine = recommendation_engine()
    qs = QueryServer(engine, engine.params_from_variant(VARIANT),
                     [port_model(jmodel)],
                     ServerConfig(device="cpu", **cfg), inst,
                     Context(device="cpu", _storage=storage))
    return create_engine_server(qs, "127.0.0.1", port).start_background()


def jax_replica(jmodel, port):
    storage = JStorage(env={"PIO_STORAGE_SOURCES_MEM_TYPE": "memory"})
    storage.apps().insert(JApp(0, APP))
    inst = instance(JInstance)
    storage.engine_instances().insert(inst)
    qs = jes.QueryServer(
        JContext(app_name=APP, _storage=storage), jax_engine(),
        jax_engine_params(APP, rank=RANK), [jmodel], inst,
        jes.ServerConfig(warm_start=False))
    return qs, jes.create_engine_server(qs, "127.0.0.1",
                                        port).start_background()


def call(port, method, path, body=None, headers=None):
    data = json.dumps(body).encode() if body is not None else (
        b"" if method == "POST" else None)
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method=method,
                                 headers=headers or {})
    try:
        resp = LOCAL.open(req, timeout=30)
    except urllib.error.HTTPError as e:
        resp = e
    with resp:
        raw = resp.read()
        ctype = resp.headers.get("Content-Type", "")
        out = json.loads(raw) if "json" in ctype and raw else raw.decode()
        return resp.status, out, dict(resp.headers)


class SharedScrape:
    """One real HTTP fetch a URL per cycle, handed to both aggregators:
    they merge the very same bytes."""

    def __init__(self):
        self.cache = {}

    def new_cycle(self):
        self.cache = {}

    def fetch(self, url, timeout):
        if url not in self.cache:
            try:
                with LOCAL.open(url, timeout=timeout) as resp:
                    self.cache[url] = (resp.status, resp.read())
            except urllib.error.HTTPError as e:
                self.cache[url] = (e.code, e.read())
        code, raw = self.cache[url]
        return code, json.loads(raw)


def test_two_aggregators_over_the_same_port_servers_agree(jmodel):
    servers = [port_replica(jmodel, slo_interval_ms=0) for _ in range(2)]
    shared = SharedScrape()
    names = [f"127.0.0.1:{s.port}" for s in servers]
    aggs = {
        "jax": jfleet.FleetAggregator(jfleet.FleetConfig(
            replicas=names, slo_specs=CI_SPECS, stale_after_sec=600.0),
            fetch=shared.fetch),
        "port": pfleet.FleetAggregator(pfleet.FleetConfig(
            replicas=names, slo_specs=CI_SPECS, stale_after_sec=600.0),
            fetch=shared.fetch)}
    codes = []
    try:
        # 30% of dispatches fail with a 500 from tick 4 to 12: the fleet
        # availability spec burns, then recovers
        for t in range(20):
            if t == 4:
                pfaults.inject_spec("serving.dispatch=error,rate=0.3,seed=1")
            if t == 12:
                pfaults.clear()
            for i in range(6):
                codes.append(call(
                    servers[i % 2].port, "POST", "/queries.json",
                    {"user": f"u{(t * 6 + i) % N_USERS}", "num": 4})[0])
            shared.new_cycle()
            outcomes = {pkg: agg.scrape_cycle() for pkg, agg in aggs.items()}
            assert outcomes["port"] == outcomes["jax"]
            for agg in aggs.values():
                agg.slo.observe(now=float(t))
            assert merged_view(aggs["port"]) == merged_view(aggs["jax"]), t
            assert fleet_view(aggs["port"]) == fleet_view(aggs["jax"]), t
        slo = aggs["port"].slo.status()
        by_name = {s["name"]: s for s in slo["specs"]}
        assert by_name["queries-availability"]["violations"] == 1
        merged = aggs["port"].registry.get("pio_query_latency_seconds")
        (_, child), = merged.children()
        assert child.count == codes.count(200) < len(codes) == 120
        assert set(codes) == {200, 500}
        failed = sum(c.value for items, c in aggs["port"].registry.get(
            "pio_http_requests_total").children()
            if dict(items).get("route") == "/queries.json"
            and dict(items).get("status") == "500")
        assert failed == codes.count(500)
    finally:
        for s in servers:
            s.close()


# -- the fleet end to end: port replicas behind the port's router -------------------

def free_port_pair():
    for _ in range(200):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            p = s.getsockname()[1]
        if p > 65000:
            continue
        try:
            with socket.socket() as a, socket.socket() as b:
                a.bind(("127.0.0.1", p))
                b.bind(("127.0.0.1", p + 1))
            return p
        except OSError:
            continue
    raise RuntimeError("no two consecutive free ports")


QUERIES = [{"user": f"u{(7 * i) % N_USERS}", "num": 5,
            **({"blackList": [f"i{i % 9}"]} if i % 5 == 0 else {})}
           for i in range(64)]


def jax_fleet_answers(jmodel, base):
    """The JAX fleet: two JAX engine servers on ``base`` and ``base + 1``
    behind the JAX router."""
    reps = [jax_replica(jmodel, base + i) for i in range(2)]
    router = jrouter.QueryRouter(jrouter.RouterConfig(),
                                 registry=jobs.MetricsRegistry())
    for _, srv in reps:
        router.add(f"127.0.0.1:{srv.port}")
    rsrv = jrouter.create_router_server(router, "127.0.0.1", 0)
    rsrv.start_background()
    try:
        out = []
        for q in QUERIES:
            code, body, h = call(rsrv.port, "POST", "/queries.json", q)
            out.append((code, [s["item"] for s in body["itemScores"]],
                        int(h["X-Routed-To"].rsplit(":", 1)[1]) - base))
        return out
    finally:
        rsrv.shutdown()
        for qs, srv in reps:
            srv.shutdown()
            qs.close()


@pytest.fixture()
def fleet_store(tmp_path, jmodel):
    engine_json = tmp_path / "engine.json"
    engine_json.write_text(json.dumps(VARIANT))
    storage = Storage(env={"PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"})
    now = datetime.now(timezone.utc)
    storage.engine_instances().insert(EngineInstance(
        id="f1", status=STATUS_COMPLETED, start_time=now, end_time=now,
        engine_id="fleet", engine_version="1",
        engine_variant=str(engine_json), engine_factory="synthetic"))
    storage.models().insert(Model("f1", dumps_models([port_model(jmodel)])))
    return storage, str(engine_json)


def fleet_args(engine_json, base, *extra):
    return cli._parser().parse_args([
        "deploy", "--engine-json", engine_json, "--device", "cpu",
        "--ip", "127.0.0.1", "--port", str(base), "--fleet-of", "2",
        "--fleet-port", "0", "--router-port", "0", "--batching",
        "--fleet-scrape-interval-ms", "100", *extra])


def test_the_fleet_answers_as_the_jax_fleet_on_the_same_replicas(
        jmodel, fleet_store):
    base = free_port_pair()
    want = jax_fleet_answers(jmodel, base)
    storage, engine_json = fleet_store
    before = threading.active_count()
    fleet = cli.build_fleet_deploy(fleet_args(engine_json, base), storage)
    fleet.server.start_background()
    try:
        assert [s.port for s in fleet.replicas] == [base, base + 1]
        assert fleet.lifecycle.await_ready(2, 30)
        got = []
        for q in QUERIES:
            code, body, h = call(fleet.router_server.port, "POST",
                                 "/queries.json", q)
            got.append((code, [s["item"] for s in body["itemScores"]],
                        int(h["X-Routed-To"].rsplit(":", 1)[1]) - base))
        assert got == want
        assert {idx for _, _, idx in got} == {0, 1}
        code, _, _ = call(fleet.server.port, "POST", "/scrape")
        _, fj, _ = call(fleet.server.port, "GET", "/fleet.json")
        counts = {r["replica"]: r["requestCount"] for r in fj["replicas"]}
        for i in range(2):
            assert counts[f"127.0.0.1:{base + i}"] == sum(
                1 for _, _, idx in got if idx == i)
        assert fj["replicasUp"] == 2 and fj["kneeQps"] is None
        assert fj["capacityHeadroom"] == -1.0
    finally:
        fleet.close()
    deadline = time.monotonic() + 10
    while threading.active_count() > before and \
            time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def expected_items(jmodel, q):
    U = np.asarray(jmodel.user_factors, dtype=np.float64)
    V = np.asarray(jmodel.item_factors, dtype=np.float64)
    scores = V @ U[int(q["user"][1:])]
    black = {int(b[1:]) for b in q.get("blackList", [])}
    order = [i for i in np.argsort(-scores, kind="stable")
             if i not in black]
    return [f"i{i}" for i in order[:q["num"]]]


def test_scaling_out_and_in_loses_no_query(jmodel, fleet_store, capsys):
    storage, engine_json = fleet_store
    before = threading.active_count()
    fleet = cli.build_fleet_deploy(
        fleet_args(engine_json, 0, "--autoscale", "--max-replicas", "4"),
        storage)
    fleet.server.start_background()
    fleet.autoscaler.policy.interval_sec = 0.05
    results, stop = [], threading.Event()

    def client(k):
        i = 0
        while not stop.is_set():
            q = QUERIES[(i * 3 + k) % len(QUERIES)]
            code, body, _ = call(fleet.router_server.port, "POST",
                                 "/queries.json", q)
            results.append((q, code, body))
            i += 1

    clients = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    try:
        assert fleet.lifecycle.await_ready(2, 30)
        for t in clients:
            t.start()
        port = str(fleet.server.port)
        assert cli.main(["fleet", "scale", "--to", "3", "--port", port]) \
            == 0
        assert "target 3" in capsys.readouterr().out
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and \
                len(fleet.router.members()) < 3:
            time.sleep(0.02)
        assert len(fleet.router.members()) == 3
        time.sleep(0.3)
        assert cli.main(["fleet", "scale", "--to", "1", "--port", port]) \
            == 0
        while time.monotonic() < deadline and (
                len(fleet.router.members()) > 1
                or fleet.lifecycle.count("draining")):
            time.sleep(0.02)
        assert len(fleet.router.members()) == 1
        time.sleep(0.3)
    finally:
        stop.set()
        for t in clients:
            t.join(30)
        status = fleet.autoscaler.status()
        fleet.close()
    assert len(results) > 20
    bad = [(q, code) for q, code, _ in results if code != 200]
    assert not bad, bad[:5]
    for q, _, body in results:
        assert [s["item"] for s in body["itemScores"]] == \
            expected_items(jmodel, q)
    assert [d["action"] for d in status["decisions"]] == ["manual"] * 2
    assert len(status["removed"]) == 2
    deadline = time.monotonic() + 10
    while threading.active_count() > before and \
            time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_the_fleet_routes_and_commands(jmodel, fleet_store, capsys):
    storage, engine_json = fleet_store
    fleet = cli.build_fleet_deploy(
        fleet_args(engine_json, 0, "--autoscale"), storage)
    fleet.server.start_background()
    port = fleet.server.port
    try:
        assert fleet.lifecycle.await_ready(2, 30)
        for q in QUERIES[:16]:
            assert call(fleet.router_server.port, "POST", "/queries.json",
                        q)[0] == 200
        assert call(port, "POST", "/scrape")[0] == 200
        _, hot, _ = call(port, "GET", "/hotkeys.json?n=4")
        assert len(hot["fleet"]) == 4 and len(hot["replicas"]) == 2
        _, route, _ = call(port, "GET", "/route.json?key=u3")
        assert route["affinity"] == fleet.router.route_key("u3")
        _, slo, _ = call(port, "GET", "/slo.json")
        assert slo["enabled"] and len(slo["specs"]) == 2
        _, text, _ = call(port, "GET", "/metrics")
        for fam in ("pio_router_requests_total", "pio_autoscale_replicas",
                    "pio_autoscale_target_replicas", "pio_fleet_replica_up",
                    "pio_fleet_scrapes_total", "pio_query_latency_seconds",
                    "pio_slo_burn_rate"):
            assert f"# TYPE {fam} " in text, fam
        _, page, _ = call(port, "GET", "/")
        assert "2/2 replicas up" in page
        assert call(port, "GET", "/trace.json?id=nope")[0] == 404
        _, slowest, _ = call(port, "GET", "/trace.json?slowest=3")
        assert "traces" in slowest
        assert call(port, "POST", "/scale")[0] == 400
        for sub in (["route", "--key", "u3"], ["hotkeys", "--top", "4"],
                    ["slo"]):
            argv = ["fleet", *sub, "--port", str(port)]
            assert cli.main(argv) == jcli.main(argv, storage=object())
            out = capsys.readouterr().out
            half = len(out) // 2
            assert out[:half] == out[half:], sub
        assert cli.main(["fleet", "status", "--port", str(port)]) == 0
        out = capsys.readouterr().out
        assert "2/2 replicas up" in out and "fleet SLO ok" in out
        assert "autoscale: target 2" in out
    finally:
        fleet.close()
    assert cli.main(["fleet", "status", "--port", str(port)]) == 1


def test_fleet_serve_and_stop(jmodel):
    servers = [port_replica(jmodel) for _ in range(2)]
    before = set(threading.enumerate())
    agg, srv = pfleet.create_fleet_server(pfleet.FleetConfig(
        replicas=[f"127.0.0.1:{s.port}" for s in servers],
        scrape_interval_sec=0.05), host="127.0.0.1", port=0)
    srv.start_background()
    try:
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and \
                call(srv.port, "GET", "/fleet.json")[1]["replicasUp"] < 2:
            time.sleep(0.02)
        assert call(srv.port, "GET", "/fleet.json")[1]["replicasUp"] == 2
        assert call(srv.port, "POST", "/stop")[1] == {"stopping": True}
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and \
                set(threading.enumerate()) - before:
            time.sleep(0.02)
        assert not set(threading.enumerate()) - before
        with pytest.raises(urllib.error.URLError):
            LOCAL.open(f"http://127.0.0.1:{srv.port}/fleet.json", timeout=5)
    finally:
        srv.close()
        for s in servers:
            s.close()


def test_deploy_fleet_of_as_a_process_stops_with_exit_0(tmp_path, jmodel):
    """``cli deploy --fleet-of 2`` in a process of its own, as a user
    runs it: queries through the router, ``POST /stop`` to the
    aggregator, exit 0."""
    home = tmp_path / "home"
    engine_json = tmp_path / "engine.json"
    engine_json.write_text(json.dumps(VARIANT))
    st = Storage(env={"PIO_HOME": str(home)})
    now = datetime.now(timezone.utc)
    st.engine_instances().insert(EngineInstance(
        id="p1", status=STATUS_COMPLETED, start_time=now, end_time=now,
        engine_id="fleet", engine_version="1",
        engine_variant=str(engine_json), engine_factory="synthetic"))
    st.models().insert(Model("p1", dumps_models([port_model(jmodel)])))
    st.close()
    env = dict(os.environ, PIO_HOME=str(home), PYTHONPATH=str(ROOT),
               PTPU_FAULTS="router.forward=error,times=1")
    err = open(tmp_path / "stderr.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.cli", "deploy",
         "--engine-json", str(engine_json), "--device", "cpu", "--ip",
         "127.0.0.1", "--port", "0", "--fleet-of", "2", "--fleet-port",
         "0", "--router-port", "0", "--slo-specs", CI_SPECS],
        env=env, stdout=subprocess.PIPE, stderr=err, text=True,
        cwd=str(tmp_path))
    try:
        ports = {}
        while len(ports) < 2:
            line = proc.stdout.readline()
            assert line, (tmp_path / "stderr.log").read_text()
            m = re.search(r"(Query router|Fleet aggregator) live at "
                          r"http://127\.0\.0\.1:(\d+)", line)
            if m:
                ports[m.group(1)] = int(m.group(2))
        router, agg = ports["Query router"], ports["Fleet aggregator"]
        for q in QUERIES[:8]:
            code, body, _ = call(router, "POST", "/queries.json", q)
            assert code == 200
            assert [s["item"] for s in body["itemScores"]] == \
                expected_items(jmodel, q)
        _, text, _ = call(agg, "GET", "/metrics")
        assert re.search(r'pio_router_retries_total\{replica="[^"]+"\} 1',
                         text)
        assert call(agg, "POST", "/stop")[1] == {"stopping": True}
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        err.close()
