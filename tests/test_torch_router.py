"""The port's consistent-hash ring, query router, replica lifecycle and
autoscaler against the JAX package's (``predictionio_tpu/router/``).

``key_point`` is bit-equal on 100,000 keys, so a user lands on the same
replica whichever package routes it; ring assignments, preference lists,
spill and ejection, the lifecycle's state sequences and the autoscaler's
decision sequences are identical under the same fakes and fake clock.
"""

import random
import re
import threading
import time

import pytest

import predictionio_tpu.faults as jfaults
import predictionio_tpu.obs as jobs
import predictionio_tpu.router as jrouter
import predictionio_tpu.server.http as jhttp
from predictionio_tpu_torch import faults as pfaults
from predictionio_tpu_torch import obs as pobs
from predictionio_tpu_torch import router as prouter
from predictionio_tpu_torch.server import http as phttp

PKGS = {"jax": (jrouter, jobs, jfaults, jhttp),
        "port": (prouter, pobs, pfaults, phttp)}
MEMBERS = [f"10.0.0.{i}:8000" for i in range(10)]


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    jfaults.clear()
    pfaults.clear()


# -- the ring ------------------------------------------------------------------

def keys_100k():
    """User ids as the templates name them, and awkward strings: unicode,
    empty, very long, a lone surrogate (sha256 over ``surrogatepass``
    UTF-8)."""
    rng = random.Random(7)
    out = [f"u{i}" for i in range(90_000)]
    out += ["".join(chr(rng.randrange(32, 0x2FFF)) for _ in range(
        rng.randrange(0, 24))) for _ in range(9_996)]
    out += ["", "\ud800", "x" * 10_000, "user\x00id"]
    return out


def test_key_point_is_bit_equal_on_100k_keys():
    keys = keys_100k()
    assert len(keys) == 100_000
    got = [prouter.key_point(k) for k in keys]
    assert got == [jrouter.key_point(k) for k in keys]
    assert all(0 <= p < 2 ** 64 for p in got)
    assert len(set(got)) > 99_000


KEYS = [f"u{i}" for i in range(5000)]


def ring_view(pkg, members, vnodes=64):
    ring = PKGS[pkg][0].HashRing(members, vnodes=vnodes)
    return ([ring.assign(k) for k in KEYS],
            [ring.preference(k, 3) for k in KEYS[:1000]],
            ring.describe(), ring.members(), len(ring))


@pytest.mark.parametrize("vnodes", [1, 8, 64])
def test_assign_and_preference_equal_across_membership_changes(vnodes):
    for members in (MEMBERS[:1], MEMBERS[:3], MEMBERS, MEMBERS[::-1],
                    MEMBERS[2:7], ["127.0.0.1:8000", "127.0.0.1:8001"]):
        assert ring_view("port", members, vnodes) \
            == ring_view("jax", members, vnodes), members
    for pkg in PKGS:
        ring = PKGS[pkg][0].HashRing(MEMBERS, vnodes=vnodes)
        ring.remove(MEMBERS[3])
        ring.add("10.0.0.99:8000")
        ring.add(MEMBERS[0])  # idempotent
        ring.remove("absent")
        if pkg == "jax":
            jview = [ring.assign(k) for k in KEYS]
        else:
            pview = [ring.assign(k) for k in KEYS]
    assert pview == jview


def test_the_ring_moves_about_1_over_n_of_the_keys():
    before = prouter.HashRing(MEMBERS)
    after = prouter.HashRing(MEMBERS + ["10.0.0.10:8000"])
    moved = sum(before.assign(k) != after.assign(k) for k in KEYS)
    assert moved / len(KEYS) < 2.0 / 11
    assert prouter.HashRing().assign("x") is None
    assert prouter.HashRing(MEMBERS[:2]).preference("x", 5) == \
        jrouter.HashRing(MEMBERS[:2]).preference("x", 5)
    with pytest.raises(ValueError):
        prouter.HashRing(vnodes=0)


# -- placement (no sockets) -----------------------------------------------------

def router_of(pkg, **cfg):
    mod, obs, _, _ = PKGS[pkg]
    r = mod.QueryRouter(mod.RouterConfig(**cfg),
                        registry=obs.MetricsRegistry())
    for m in ("127.0.0.1:9001", "127.0.0.1:9002", "127.0.0.1:9003",
              "127.0.0.1:9004"):
        r.add(m)
    return r


def placement_run(pkg):
    """Affinity, hot-key spill (sketch-confirmed only), drain, remove,
    health veto and keyless rotation, as candidate lists."""
    r = router_of(pkg, spill_share=0.2, spill_min_total=50,
                  spill_fanout=2, retries=1)
    out = [r.candidates(k) for k in KEYS[:200]]
    for _ in range(10):
        r.hot.record("viral")
    out.append(r.candidates("viral"))          # under spill_min_total
    for i in range(100):
        r.hot.record("viral")
        r.hot.record(f"cold-{i}")
    out += [r.candidates("viral"), r.candidates("cold-1")]
    first = r.route_key("u42")
    r.drain(first)
    out += [r.route_key("u42"), r.members(), r.inflight(first)]
    out.append(sorted((b["replica"], b["state"])
                      for b in r.status()["replicas"]))
    r.remove(r.route_key("u7"))
    out += [r.members(), [r.candidates(k) for k in KEYS[:200]]]
    second = r.route_key("u9")
    r.set_health(lambda name: name != second)
    out.append(r.candidates("u9"))
    r.set_health(lambda name: False)           # no opinion wins
    out.append(r.candidates("u9"))
    r.set_health(None)
    out.append([r.route_key(None) for _ in range(7)])
    out.append(r.preference("u9", 3))
    return out


def test_placement_spill_drain_and_veto_match():
    got = placement_run("port")
    assert got == placement_run("jax")
    assert got[201][1] is True and got[200][1] is False  # viral spilled
    assert got[202][1] is False                          # cold did not


def test_router_config_refuses_as_the_jax_config():
    for kw in ({"spill_share": 0.0}, {"spill_share": 1.5},
               {"spill_fanout": 0}):
        with pytest.raises(ValueError) as jerr:
            jrouter.RouterConfig(**kw)
        with pytest.raises(ValueError) as perr:
            prouter.RouterConfig(**kw)
        assert str(perr.value) == str(jerr.value)


# -- forwarding over real backends ------------------------------------------------

def backend(name, behavior="ok"):
    """A stand-in replica on the port's HTTP server: answers its name,
    or sheds with 503, or fails with 500."""
    app = phttp.HTTPApp(name=f"backend-{name}")
    hits = []

    @app.route("POST", "/queries.json")
    def q(req):
        hits.append(req.json())
        if behavior == "shed":
            return phttp.Response(status=503, body={"error": "shed"},
                                  headers={"Retry-After": "0.05"})
        if behavior == "fail":
            raise phttp.HTTPError(500, "kernel launch failed")
        return phttp.json_response({"replica": name})

    return phttp.AppServer(app, "127.0.0.1", 0).start_background(), hits


@pytest.fixture()
def trio():
    servers = [backend(f"b{i}") for i in range(3)]
    yield servers
    for srv, _ in servers:
        srv.close()


def forward(r, http, user):
    body = ('{"user": "%s", "num": 1}' % user).encode()
    try:
        resp = r.forward("/queries.json", body, {})
        return resp.status, resp.headers.get("X-Routed-To"), \
            resp.headers.get("X-Routed-Retry")
    except http.HTTPError as e:
        return e.status, None, None


def counters(r):
    out = {}
    for fam in ("pio_router_requests_total", "pio_router_retries_total",
                "pio_router_ejections_total", "pio_router_spill_total",
                "pio_router_no_backend_total"):
        f = r.registry.get(fam)
        out[fam] = sorted((items, c.value) for items, c in f.children())
    return out


def forward_run(pkg, servers):
    """Affinity, a one-shot transport fault, repeated faults to ejection,
    the ejected replica skipped, every replica dead, spill: the routed-to
    sequence and the router's counters."""
    mod, obs, faults, http = PKGS[pkg]
    r = mod.QueryRouter(mod.RouterConfig(
        retries=1, eject_failures=2, eject_sec=60.0, timeout_sec=5.0,
        spill_share=0.3, spill_min_total=20), registry=obs.MetricsRegistry())
    for srv, _ in servers:
        r.add(f"127.0.0.1:{srv.port}")
    out = [forward(r, http, f"u{i}") for i in range(12)]
    faults.inject("router.forward", "error", times=1)
    out += [forward(r, http, "u3"), forward(r, http, "u3")]
    target = r.route_key("u5")
    faults.inject("router.forward", "error", match={"replica": target})
    out += [forward(r, http, "u5") for _ in range(3)]
    out.append(forward(r, http, "u5"))   # ejected: no retry hop
    faults.clear()
    faults.inject("router.forward", "error")
    out.append(forward(r, http, "u6"))   # every candidate fails: 503
    faults.clear()
    out += [forward(r, http, "hot") for _ in range(30)]
    return out, counters(r), r.hot.top(3)


def test_forward_retry_ejection_and_spill_match(trio):
    jout, jcount, jhot = forward_run("jax", trio)
    for _, hits in trio:
        hits.clear()
    pout, pcount, phot = forward_run("port", trio)
    assert pout == jout
    assert pcount == jcount
    assert phot == jhot
    assert pout[12][0] == 200 and pout[12][2] == "1"      # retried once
    assert pout[-31][0] == 503
    assert any(items for items, _ in pcount["pio_router_spill_total"])


def test_forward_retries_once_under_the_spec_and_answers(trio):
    r = prouter.QueryRouter(prouter.RouterConfig(retries=1),
                            registry=pobs.MetricsRegistry())
    for srv, _ in trio:
        r.add(f"127.0.0.1:{srv.port}")
    before = pfaults.status()["injections"].get("router.forward|error", 0)
    pfaults.inject_spec("router.forward=error,times=1")
    status, routed, retry = forward(r, phttp, "u1")
    assert status == 200 and retry == "1"
    assert routed == r.preference("u1", 2)[1]
    assert sum(c.value for _, c in r.registry.get(
        "pio_router_retries_total").children()) == 1.0
    assert forward(r, phttp, "u1") == (200, r.route_key("u1"), None)
    assert pfaults.status()["injections"]["router.forward|error"] \
        == before + 1
    assert "router.forward" in pfaults.POINTS


def test_a_500_is_passed_through_never_retried():
    """A replica whose kernel fails answers 500: the router hands that
    on and retries nothing, so no retry hides a failed launch."""
    bad, bad_hits = backend("bad", "fail")
    ok, ok_hits = backend("ok")
    try:
        for pkg in PKGS:
            mod, obs, _, http = PKGS[pkg]
            r = mod.QueryRouter(mod.RouterConfig(retries=1),
                                registry=obs.MetricsRegistry())
            r.add(f"127.0.0.1:{bad.port}")
            r.add(f"127.0.0.1:{ok.port}")
            user = next(f"u{i}" for i in range(100)
                        if r.route_key(f"u{i}") == f"127.0.0.1:{bad.port}")
            resp = r.forward("/queries.json",
                             ('{"user": "%s"}' % user).encode(), {})
            assert resp.status == 500, pkg
            assert r.registry.get("pio_router_retries_total").children() \
                == [], pkg
        assert len(bad_hits) == 2 and not ok_hits
    finally:
        bad.close()
        ok.close()


def test_a_shed_retries_on_the_next_replica():
    shedder, _ = backend("shed", "shed")
    ok, ok_hits = backend("ok")
    r = prouter.QueryRouter(prouter.RouterConfig(retries=1),
                            registry=pobs.MetricsRegistry())
    r.add(f"127.0.0.1:{shedder.port}")
    r.add(f"127.0.0.1:{ok.port}")
    try:
        for i in range(8):
            assert forward(r, phttp, f"u{i}")[0] == 200
        assert len(ok_hits) == 8
    finally:
        shedder.close()
        ok.close()


def test_the_router_app_serves_queries_route_and_drain(trio):
    import json
    import urllib.request

    local = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    r = prouter.QueryRouter(prouter.RouterConfig(accesskey="k"))
    for srv, _ in trio:
        r.add(f"127.0.0.1:{srv.port}")
    srv = prouter.create_router_server(r, "127.0.0.1", 0).start_background()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        req = urllib.request.Request(base + "/queries.json",
                                     data=b'{"user": "u1"}', method="POST")
        with local.open(req, timeout=10) as resp:
            assert resp.headers["X-Routed-To"] == r.route_key("u1")
        with local.open(base + "/route.json?key=u1", timeout=10) as resp:
            route = json.loads(resp.read())
        assert route["affinity"] == r.route_key("u1")
        assert route["preference"] == r.preference("u1", 2)
        assert route["server"] == "router" and len(route["replicas"]) == 3
        with pytest.raises(urllib.error.HTTPError) as err:
            local.open(urllib.request.Request(
                base + "/drain?replica=" + route["affinity"], data=b""),
                timeout=10)
        assert err.value.code == 401
        with local.open(urllib.request.Request(
                base + f"/drain?replica={route['affinity']}&accessKey=k",
                data=b""), timeout=10) as resp:
            assert json.loads(resp.read()) == {
                "draining": route["affinity"]}
        assert route["affinity"] not in r.members()
        with local.open(base + "/metrics", timeout=10) as resp:
            text = resp.read().decode()
        for fam in ("pio_router_requests_total", "pio_router_replicas",
                    "pio_router_inflight", "pio_router_request_seconds"):
            assert f"# TYPE {fam} " in text
    finally:
        srv.close()


# -- the replica lifecycle ----------------------------------------------------------

class FakeRouter:
    def __init__(self):
        self.calls = []
        self.inflight_by = {}

    def add(self, base):
        self.calls.append(("add", base))

    def drain(self, name):
        self.calls.append(("drain", name))

    def remove(self, name):
        self.calls.append(("remove", name))

    def inflight(self, name):
        return self.inflight_by.get(name, 0)


class FakeAgg:
    def __init__(self):
        self.calls = []

    def add_replica(self, base):
        self.calls.append(("add", base))

    def remove_replica(self, name):
        self.calls.append(("remove", name))


_PLACEHOLDER = re.compile(r"\(spawning-[0-9a-f]+\)")


def wait_for(cond, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline and not cond():
        time.sleep(0.005)
    assert cond()


def lifecycle_run(pkg):
    """Adopt; spawn gated on warm; drain that waits for in-flight work;
    a drain deadline; mark_dead; a warm timeout; a failed spawn. The
    transition sequence, the fakes' calls and the stops."""
    mod, obs, _, _ = PKGS[pkg]
    warm, stopped, events = {}, [], []
    ports = iter(range(9500, 9600))
    fail = [False]

    def spawn():
        if fail[0]:
            raise RuntimeError("no capacity")
        spec = f"127.0.0.1:{next(ports)}"
        return spec, (lambda s=spec: stopped.append(s))

    router, agg = FakeRouter(), FakeAgg()
    reg = obs.MetricsRegistry()
    lc = mod.ReplicaLifecycle(
        spawn, router=router, aggregator=agg, registry=reg,
        probe=lambda base, t: {"servingWarm": warm.get(
            base.split("://", 1)[1], False)},
        notify_drain=lambda base, t: events.append(("notify", base)),
        poll_interval_sec=0.005, warm_timeout_sec=2.0,
        drain_deadline_sec=2.0,
        on_transition=lambda n, s, r: events.append(
            (_PLACEHOLDER.sub("(spawning)", n), s, r)))
    lc.adopt("127.0.0.1:9400", stop_fn=lambda: stopped.append("9400"))
    lc.scale_out("grow")
    wait_for(lambda: lc.count("warming") == 1)
    time.sleep(0.05)
    ring_before_warm = list(router.calls)
    warm["127.0.0.1:9500"] = True
    assert lc.await_ready(2, 5.0)
    router.inflight_by["127.0.0.1:9500"] = 2
    victim = (lc.pick_drain_victim(),
              lc.scale_in("127.0.0.1:9500", reason="shrink"))
    time.sleep(0.05)
    stopped_while_busy = list(stopped)
    router.inflight_by["127.0.0.1:9500"] = 0
    wait_for(lambda: "127.0.0.1:9500" in stopped)
    dead = lc.mark_dead("127.0.0.1:9400", "chaos")
    lc.warm_timeout_sec = 0.05
    lc.scale_out("never warms")
    wait_for(lambda: "127.0.0.1:9501" in stopped)
    fail[0] = True
    lc.scale_out("fails")
    wait_for(lambda: any(e[1] == "dead" and "spawn failed" in e[2]
                         for e in events))
    counts, live = lc.counts(), lc.live_count()
    gauges = sorted((items, c.value) for items, c in reg.get(
        "pio_autoscale_replicas").children())
    trans = sorted((items, c.value) for items, c in reg.get(
        "pio_autoscale_transitions_total").children())
    lc.close(stop_replicas=True)
    return dict(events=events, router=router.calls, agg=agg.calls,
                stopped=stopped, ring_before_warm=ring_before_warm,
                victim=victim, busy=stopped_while_busy, dead=dead,
                counts=counts, live=live, gauges=gauges, trans=trans)


def test_lifecycle_state_sequences_equal():
    got = lifecycle_run("port")
    assert got == lifecycle_run("jax")
    assert got["ring_before_warm"] == [("add", "http://127.0.0.1:9400")]
    assert got["busy"] == []               # in-flight work kept it alive
    assert [e[1] for e in got["events"] if e[0] == "127.0.0.1:9500"] == [
        "warming", "ready", "draining", "terminated"]


def test_concurrent_spawns_each_keep_their_placeholder():
    # two scale-outs in flight at once: both placeholders are registered
    # before either spawn returns, and each spawn replaces its own
    gate = threading.Barrier(2)
    ports = iter([9801, 9802])
    taken = threading.Lock()

    def spawn():
        gate.wait(5.0)
        with taken:
            port = next(ports)
        return f"127.0.0.1:{port}", lambda: None

    lc = prouter.ReplicaLifecycle(
        spawn, probe=lambda base, t: {"servingWarm": True},
        poll_interval_sec=0.005, warm_timeout_sec=5.0)
    try:
        lc.scale_out("a")
        lc.scale_out("b")
        assert lc.await_ready(2, 5.0)
        assert lc.count("spawning") == 0
    finally:
        lc.close()


def test_lifecycle_close_joins_its_threads():
    before = set(threading.enumerate())
    lc = prouter.ReplicaLifecycle(
        lambda: ("127.0.0.1:9700", lambda: None),
        probe=lambda base, t: {"servingWarm": False},
        poll_interval_sec=0.01, warm_timeout_sec=60.0)
    lc.scale_out("x")
    wait_for(lambda: lc.count("warming") == 1)
    assert set(threading.enumerate()) - before
    lc.close()
    assert not set(threading.enumerate()) - before
    assert not lc.await_ready(1, 0.1)


# -- the autoscaler -----------------------------------------------------------------

class FakeSLO:
    def __init__(self):
        self.fast = []

    def fast_burning(self):
        return list(self.fast)


class SignalAgg:
    """The aggregator surface the autoscaler reads."""

    def __init__(self):
        self.headroom = None
        self.qps = 0.0
        self.knee = 100.0
        self.slo = FakeSLO()
        self.health = {}

    def capacity_signals(self):
        return {"qps": self.qps, "kneeQps": self.knee,
                "headroom": self.headroom}

    def replica_health(self, name):
        return self.health.get(name, "up")


def autoscaled(pkg, n=2, **policy):
    mod, obs, _, _ = PKGS[pkg]
    agg = SignalAgg()
    warm = {}
    ports = iter(range(9600, 9700))

    def spawn():
        spec = f"127.0.0.1:{next(ports)}"
        warm[spec] = True
        return spec, lambda: None

    lc = mod.ReplicaLifecycle(
        spawn, router=FakeRouter(), aggregator=FakeAgg(),
        probe=lambda base, t: {"servingWarm": warm.get(
            base.split("://", 1)[1], False)},
        notify_drain=lambda base, t: None,
        poll_interval_sec=0.005, drain_deadline_sec=0.05)
    for i in range(n):
        lc.adopt(f"127.0.0.1:{9590 + i}")
    clk = [1000.0]
    pol = dict(min_replicas=1, max_replicas=4, headroom_floor=0.15,
               headroom_ceiling=0.60, scale_in_sustain_sec=10.0,
               cooldown_sec=30.0)
    pol.update(policy)
    reg = obs.MetricsRegistry()
    asc = mod.Autoscaler(agg, lc, mod.AutoscalePolicy(**pol),
                         registry=reg, tracer=obs.Tracer(ring=64),
                         clock=lambda: clk[0])
    return asc, agg, lc, clk, reg


def settle(lc):
    """Wait until no replica is spawning, warming or draining."""
    wait_for(lambda: not (lc.count("spawning") or lc.count("warming")
                          or lc.count("draining")
                          or lc.count("terminated")))


DECISION_KEYS = ("action", "reason", "headroom", "qps", "kneeQps",
                 "burningFast", "live", "ready", "target", "seq")

#: (signal changes, clock advance) before each evaluation
SCRIPTS = {
    "hold": [({}, 0)] * 3,
    "burn": [({"fast": ["queries-p99-latency"]}, 0), ({}, 1),
             ({"fast": []}, 40)],
    "floor": [({"headroom": 0.05}, 0), ({}, 5), ({}, 31), ({}, 31)],
    "no-model": [({"headroom": None}, 0), ({}, 60)],
    "sustain": [({"headroom": 0.9}, 0), ({}, 5), ({}, 6), ({}, 1),
                ({}, 40)],
    "band": [({"headroom": 0.4}, 60)] * 5,
    "cooldown": [({"headroom": 0.05}, 0), ({}, 10), ({"headroom": 0.9},
                 10), ({}, 15), ({}, 31)],
    "burn-vetoes-in": [({"headroom": 0.95, "fast": ["x"]}, 1), ({}, 60),
                       ({"fast": []}, 60), ({}, 60)],
    "heal": [({"headroom": 0.05}, 0), ({"down": 0}, 1), ({}, 1)],
    "manual": [({"manual": 9}, 0), ({}, 1), ({"manual": 1}, 1), ({}, 1),
               ({}, 1)],
    "all": [({}, 0), ({"fast": ["a"]}, 0), ({"fast": []}, 5),
            ({"headroom": 0.05}, 31), ({"down": 1}, 1), ({"manual": 2}, 1),
            ({}, 1), ({"headroom": 0.9}, 31), ({}, 11), ({}, 40),
            ({}, 40)],
}


def autoscale_run(pkg, script):
    asc, agg, lc, clk, reg = autoscaled(pkg)
    out = []
    for change, advance in SCRIPTS[script]:
        clk[0] += advance
        if "fast" in change:
            agg.slo.fast = change["fast"]
        if "headroom" in change:
            agg.headroom = change["headroom"]
        if "down" in change:
            agg.health[lc.names("ready")[change["down"]]] = "down"
        if "manual" in change:
            out.append(("granted", asc.request_target(change["manual"],
                                                      "ops")))
        d = asc.evaluate()
        settle(lc)
        out.append({k: d[k] for k in DECISION_KEYS})
        out.append(("traced", "traceId" in d))
        out.append(sorted(lc.names("ready")))
    st = asc.status()
    out.append([{k: d[k] for k in DECISION_KEYS} for d in st["decisions"]])
    out.append((st["target"], sorted(st["removed"]), st["lifecycle"]))
    out.append(sorted((items, c.value) for items, c in reg.get(
        "pio_autoscale_decisions_total").children()))
    out.append(reg.get("pio_autoscale_target_replicas").labels().value)
    retained = sorted(t.retained_reason
                      for t in asc.tracer.recorder.recent(256))
    out.append(retained)
    lc.close()
    return out


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_autoscaler_decision_sequences_equal(script):
    got = autoscale_run("port", script)
    assert got == autoscale_run("jax", script)
    actions = {d["action"] for d in got[-5]} if got[-5] else set()
    expect = {"hold": set(), "burn": {"scale_out"},
              "floor": {"scale_out"}, "no-model": set(),
              "sustain": {"scale_in"}, "band": set(),
              "cooldown": {"scale_out", "scale_in"},
              "burn-vetoes-in": {"scale_out", "scale_in"},
              "heal": {"scale_out", "replace"},
              "manual": {"manual"},
              "all": {"scale_out", "replace", "manual", "scale_in"}}
    assert actions == expect[script], actions
    assert set(got[-1]) <= {"autoscale"}


def test_the_autoscaler_thread_is_joined():
    asc, agg, lc, clk, _ = autoscaled("port")
    asc.policy.interval_sec = 0.01
    asc.start()
    wait_for(lambda: asc.status()["target"] is not None)
    assert asc.status()["running"]
    asc.stop()
    lc.close()
    assert not asc.status()["running"]
    assert not [t for t in threading.enumerate()
                if t.name == "autoscaler" and t.is_alive()]


def test_policy_refuses_as_the_jax_policy():
    for kw in ({"min_replicas": 0}, {"min_replicas": 3, "max_replicas": 2},
               {"headroom_floor": 0.5, "headroom_ceiling": 0.4}):
        with pytest.raises(ValueError) as jerr:
            jrouter.AutoscalePolicy(**kw)
        with pytest.raises(ValueError) as perr:
            prouter.AutoscalePolicy(**kw)
        assert str(perr.value) == str(jerr.value)
