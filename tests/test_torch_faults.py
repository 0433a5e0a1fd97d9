"""Fault injection and the debug locks of the port, held to the JAX
package's: the registry's grammar and seeded schedules
(``tests/test_faults.py``), the ``storage.io`` point of MEMORY and SQLite,
the engine server's ``serving.dispatch`` point, ``ServerConfig.faults`` /
``deploy --faults``, the ``pio_fault_*`` families and the
``faultInjection`` flag (``tests/test_reliability.py``), and the
``concurrency`` package (``tests/test_concurrency.py``). The lane and
multi-process cases wait for replicated lanes (``ROADMAP.md`` queue 1 item
13)."""

import json
import logging
import threading
import time
import urllib.request

import numpy as np
import pytest

import predictionio_tpu.concurrency as jconc
import predictionio_tpu.faults as jfaults
from predictionio_tpu.faults.registry import FaultRegistry as JRegistry
from predictionio_tpu_torch import cli
from predictionio_tpu_torch import concurrency as pconc
from predictionio_tpu_torch import faults as pfaults
from predictionio_tpu_torch.concurrency import (
    DebugLock,
    LockRegistry,
    dump_all_stacks,
    instrument_locks,
    lock_registry,
    locks_instrumented,
    new_lock,
    new_rlock,
    register_lock_metrics,
)
from predictionio_tpu_torch.concurrency.locks import _env_enabled
from predictionio_tpu_torch.data.event import Event, utcnow
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.faults import FaultError, FaultSpec, parse_specs
from predictionio_tpu_torch.faults.registry import (
    FaultRegistry as PRegistry,
)
from predictionio_tpu_torch.models.convert import als_model_from_numpy
from predictionio_tpu_torch.obs import MetricsRegistry
from predictionio_tpu_torch.server.engineserver import (
    QueryServer,
    ServerConfig,
    deploy_models,
)
from predictionio_tpu_torch.templates.recommendation import (
    recommendation_engine,
)

REGISTRIES = {"jax": JRegistry, "port": PRegistry}
N_USERS, N_ITEMS, RANK = 40, 30, 4

#: loopback only: no proxy from the environment may carry these requests
LOCAL = urllib.request.build_opener(urllib.request.ProxyHandler({}))


@pytest.fixture(autouse=True)
def _clean_global_registries():
    yield
    pfaults.clear()
    jfaults.clear()


@pytest.fixture()
def restore_instrumentation():
    was = locks_instrumented()
    yield
    instrument_locks(was)


# -- the registry, against the JAX package's --------------------------------

@pytest.mark.parametrize("raw", [
    "storage.io=error",
    "serving.dispatch=error,rate=0.5,times=3,after=2,seed=7,lane=1",
    "checkpoint.commit=crash,after=2; storage.io=latency,delay_ms=5",
    "serving.dispatch=latency,delay_ms=400,times=1",
])
def test_spec_grammar_is_the_jax_packages(raw):
    def fields(specs):
        return [(s.point, s.mode, s.rate, s.times, s.after, s.delay_ms,
                 s.seed, s.message, s.match) for s in specs]

    assert fields(parse_specs(raw)) == fields(jfaults.parse_specs(raw))


@pytest.mark.parametrize("raw", ["nonsense", "p=error,rate=", "p=explode"])
def test_bad_specs_raise_as_in_the_jax_package(raw):
    with pytest.raises(ValueError):
        jfaults.parse_specs(raw)
    with pytest.raises(ValueError):
        parse_specs(raw)


def _schedule(cls, spec_kwargs, fires):
    """The injections a registry of ``cls`` delivers over ``fires``
    ((point, labels) pairs), and its status afterwards."""
    r = cls()
    r.inject(r_spec(cls)(**spec_kwargs))
    out = []
    for point, labels in fires:
        try:
            r.fire(point, **labels)
            out.append(0)
        except Exception as e:  # noqa: BLE001 — both packages' FaultError
            assert type(e).__name__ == "FaultError" and e.point == point
            out.append(1)
    st = r.status()
    return out, st["injections"], st["fired"]


def r_spec(cls):
    return jfaults.FaultSpec if cls is JRegistry else FaultSpec


@pytest.mark.parametrize("spec,fires", [
    ({"point": "p", "times": 2}, [("p", {})] * 4),
    ({"point": "p", "after": 3, "times": 1}, [("p", {})] * 5),
    ({"point": "p", "rate": 0.4, "seed": 11}, [("p", {})] * 50),
    ({"point": "serving.dispatch", "match": {"lane": "1"}},
     [("serving.dispatch", {"lane": 0}), ("serving.dispatch", {"lane": 1})]),
    ({"point": "checkpoint.*", "times": 2},
     [("checkpoint.save", {}), ("checkpoint.commit", {}),
      ("storage.io", {})]),
], ids=["times", "after", "rate", "labels", "glob"])
def test_schedules_are_the_jax_packages(spec, fires):
    assert _schedule(PRegistry, spec, fires) == \
        _schedule(JRegistry, spec, fires)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_latency_mode_sleeps_then_proceeds(pkg):
    r = REGISTRIES[pkg]()
    r.inject(r_spec(REGISTRIES[pkg])(point="p", mode="latency",
                                     delay_ms=30))
    t0 = time.monotonic()
    r.fire("p")
    assert time.monotonic() - t0 >= 0.025


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_clear_enabled_and_listeners(pkg):
    cls = REGISTRIES[pkg]
    r = cls()
    seen = []
    r.add_listener(lambda point, mode: seen.append((point, mode)))
    r.inject(r_spec(cls)(point="a", times=1))
    r.inject(r_spec(cls)(point="b"))
    assert r.enabled()
    with pytest.raises(Exception, match="injected fault at a"):
        r.fire("a")
    r.fire("a")
    assert seen == [("a", "error")]
    assert r.clear("a") == 1 and r.clear() == 1
    assert not r.enabled()
    r.fire("b")


def test_global_inject_spec_status_and_env(monkeypatch):
    pfaults.fire("storage.io", op="insert")  # disarmed: a no-op
    pfaults.inject_spec("storage.io=error,times=1")
    assert pfaults.enabled() and pfaults.registry().enabled()
    with pytest.raises(FaultError):
        pfaults.fire("storage.io")
    st = pfaults.status()
    assert st["fired"]["storage.io"] >= 1
    assert st["injections"]["storage.io|error"] >= 1
    assert set(st) == set(jfaults.status())
    monkeypatch.setenv("PTPU_FAULTS", "a.b=error,times=1")
    r = PRegistry()
    r.load_env()
    r.load_env()
    assert len(r.status()["armed"]) == 1


def test_points_catalog_holds_the_ported_points():
    import predictionio_tpu_torch.router.router  # noqa: F401
    import predictionio_tpu_torch.server.engineserver  # noqa: F401
    import predictionio_tpu_torch.streaming.trainer  # noqa: F401
    import predictionio_tpu_torch.workflow.checkpoint  # noqa: F401

    for point in ("storage.io", "storage.remote", "serving.dispatch",
                  "stream.pass", "checkpoint.save", "checkpoint.commit",
                  "checkpoint.restore", "router.forward"):
        assert point in pfaults.POINTS, point


# -- storage.io ----------------------------------------------------------------

def _storage(kind, tmp_path):
    if kind == "MEMORY":
        return Storage(env={"PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"})
    return Storage(env={"PIO_HOME": str(tmp_path)})


@pytest.mark.parametrize("kind", ["MEMORY", "SQLITE"])
def test_storage_io_fails_inserts_and_finds(kind, tmp_path):
    st = _storage(kind, tmp_path)
    events = st.events()
    events.init(1)
    ev = Event(event="rate", entity_type="user", entity_id="u1",
               target_entity_type="item", target_entity_id="i1",
               event_time=utcnow())
    events.insert(ev, 1)
    pfaults.inject_spec(f"storage.io=error,op=insert,backend="
                        f"{kind.lower()},times=1")
    with pytest.raises(FaultError):
        events.insert(ev, 1)
    events.insert(ev, 1)  # the budget is spent
    pfaults.inject_spec(f"storage.io=error,op=find,backend={kind.lower()}")
    with pytest.raises(FaultError):
        list(events.find(1))
    pfaults.clear()
    assert len(list(events.find(1))) == 2
    st.close()


def test_storage_io_fails_sqlite_column_blocks(tmp_path):
    from predictionio_tpu_torch.data.columnar import columnar_from_events

    st = _storage("SQLITE", tmp_path)
    st.events().init(1)
    batch = columnar_from_events([Event(
        event="rate", entity_type="user", entity_id="u1",
        target_entity_type="item", target_entity_id="i1",
        event_time=utcnow())])
    pfaults.inject_spec("storage.io=error,op=insert_columnar")
    with pytest.raises(FaultError):
        st.events().insert_columnar(batch, 1)
    pfaults.clear()
    assert st.events().insert_columnar(batch, 1) == 1
    st.close()


# -- the engine server ------------------------------------------------------------

def _model():
    rng = np.random.default_rng(0)
    return als_model_from_numpy(
        rng.standard_normal((N_USERS, RANK)).astype(np.float32),
        rng.standard_normal((N_ITEMS, RANK)).astype(np.float32),
        N_USERS, N_ITEMS, {f"u{i}": i for i in range(N_USERS)},
        {f"i{i}": i for i in range(N_ITEMS)}, {"rank": RANK}, device="cpu")


def _engine():
    engine = recommendation_engine()
    ep = engine.params_from_variant(
        {"algorithms": [{"name": "als", "params": {"rank": RANK}}]})
    return engine, ep


def _get(port, path):
    with LOCAL.open(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.read().decode()


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with LOCAL.open(req, timeout=30) as r:
        return r.status, json.loads(r.read())


@pytest.mark.parametrize("mode", [
    {"batching": False},
    {"batching": True, "serving_pipeline": "serial"},
    {"batching": True, "serving_pipeline": "staged"},
], ids=["per-query", "serial", "staged"])
def test_serving_dispatch_fault_is_traced_counted_and_flagged(mode):
    """Every dispatch route fires ``serving.dispatch``: an injected
    error fails the query with a 500, an injected delay is kept in the
    flight recorder with reason ``fault``, and both are counted."""
    engine, ep = _engine()
    srv = deploy_models(engine, ep, [_model()], ServerConfig(
        device="cpu", warm_start=False, **mode),
        host="127.0.0.1", port=0).start_background()
    try:
        port = srv.port
        assert _post(port, {"user": "u1", "num": 3})[0] == 200
        status = json.loads(_get(port, "/status.json"))
        assert status["degraded"]["faultInjection"] is False
        pfaults.inject_spec("serving.dispatch=latency,delay_ms=150,times=1")
        status = json.loads(_get(port, "/status.json"))
        assert status["degraded"]["faultInjection"] is True
        t0 = time.monotonic()
        assert _post(port, {"user": "u2", "num": 3})[0] == 200
        assert time.monotonic() - t0 >= 0.14
        pfaults.clear()
        pfaults.inject_spec("serving.dispatch=error,times=1")
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(port, {"user": "u3", "num": 3})
        assert ei.value.code == 500
        pfaults.clear()
        text = _get(port, "/metrics")
        assert ('pio_fault_injections_total{mode="latency",'
                'point="serving.dispatch"} 1') in text \
            or ('pio_fault_injections_total{point="serving.dispatch",'
                'mode="latency"} 1') in text
        assert "pio_fault_enabled 0" in text
        traces = json.loads(_get(port, "/trace.json?slowest=64"))["traces"]
        assert any(t["reason"] == "fault" for t in traces), traces
    finally:
        srv.close()


def test_config_faults_arm_at_start_and_deploy_flags_parse(tmp_path):
    args = cli._parser().parse_args([
        "deploy", "--engine-json", "e.json", "--device", "cpu",
        "--faults", "storage.io=error,times=1", "--debug-locks"])
    assert args.faults == "storage.io=error,times=1" and args.debug_locks
    engine, ep = _engine()
    qs = QueryServer(engine, ep, [_model()], ServerConfig(
        device="cpu", warm_start=False,
        faults="storage.io=latency,delay_ms=1"))
    try:
        assert pfaults.enabled()
        assert pfaults.status()["armed"][0]["point"] == "storage.io"
    finally:
        qs.close()


def test_fault_families_are_the_jax_packages():
    """``pio_fault_injections_total`` and ``pio_fault_enabled`` carry the
    JAX package's kinds and help."""
    from test_concurrency import _echo_server

    engine, ep = _engine()
    qs = QueryServer(engine, ep, [_model()], ServerConfig(
        device="cpu", warm_start=False))
    jqs = _echo_server()
    try:
        def families(text):
            return {ln for ln in text.splitlines()
                    if ln.startswith(("# HELP pio_fault",
                                      "# TYPE pio_fault"))}

        mine = families(qs.metrics.render())
        assert len(mine) == 4
        assert mine == families(jqs.metrics.render())
    finally:
        qs.close()
        if hasattr(jqs, "close"):
            jqs.close()


# -- the debug locks ------------------------------------------------------------

def test_factories_return_the_stdlib_locks_when_off(restore_instrumentation):
    instrument_locks(False)
    assert type(new_lock("x")) is type(threading.Lock())
    assert type(new_rlock("x")) is type(threading.RLock())
    instrument_locks(True)
    lock, rlock = new_lock("F.lock"), new_rlock("F.rlock")
    assert isinstance(lock, DebugLock) and not lock.reentrant
    assert isinstance(rlock, DebugLock) and rlock.reentrant


def test_env_flag_parsing(monkeypatch):
    for val, expect in (("1", True), ("true", True), ("on", True),
                        ("0", False), ("", False), ("no", False)):
        monkeypatch.setenv("PTPU_DEBUG_LOCKS", val)
        assert _env_enabled() is expect, val


def test_concurrency_exports_are_the_jax_packages():
    assert set(jconc.__all__) <= set(pconc.__all__)


def _cross(reg):
    """Two threads taking {A, B} in opposite orders, one after the other
    (the graph, not a deadlock, must catch it)."""
    a = DebugLock("A", registry=reg, watchdog_sec=30)
    b = DebugLock("B", registry=reg, watchdog_sec=30)
    done = threading.Event()

    def t1():
        with a:
            with b:
                pass
        done.set()

    def t2():
        done.wait(timeout=10)
        with b:
            with a:
                pass

    threads = [threading.Thread(target=t) for t in (t1, t2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()


def test_an_inversion_is_caught_once_a_pair():
    reg = LockRegistry()
    _cross(reg)
    _cross(reg)
    assert len(reg.inversions) == 1
    inv = reg.inversions[0]
    assert inv["held"] == "B" and inv["acquiring"] == "A"
    assert inv["prior_site"] != "?"


def test_a_consistent_order_is_clean():
    reg = LockRegistry()
    a, b = DebugLock("A", registry=reg), DebugLock("B", registry=reg)

    def worker():
        for _ in range(50):
            with a:
                with b:
                    pass

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert reg.inversions == []
    assert reg.report()["edges"] == {"A": ["B"]}


def test_a_reentry_raises_and_an_rlock_reenters():
    reg = LockRegistry()
    lock = DebugLock("L", registry=reg)
    with pytest.raises(RuntimeError, match="re-entry"):
        with lock:
            with lock:
                pass
    assert [r["lock"] for r in reg.reentries] == ["L"]
    with lock:
        pass
    rlock = DebugLock("R", reentrant=True, registry=reg)
    with rlock:
        with rlock:
            pass
    assert len(reg.reentries) == 1


def test_the_watchdog_dumps_every_stack_to_the_access_log(caplog):
    reg = LockRegistry()
    lock = DebugLock("W", registry=reg, watchdog_sec=0.15)
    release, held = threading.Event(), threading.Event()

    def holder():
        with lock:
            held.set()
            release.wait(timeout=10)

    th = threading.Thread(target=holder, name="wd-holder")
    th.start()
    held.wait(timeout=10)
    with caplog.at_level(logging.ERROR, "predictionio_tpu_torch.access"):
        tw = threading.Thread(target=lambda: lock.acquire() and
                              lock.release(), name="wd-waiter")
        tw.start()
        time.sleep(0.4)
        release.set()
        tw.join(timeout=10)
    th.join(timeout=10)
    assert reg.report()["watchdogDumps"] >= 1
    dump = "\n".join(r.getMessage() for r in caplog.records
                     if "lock watchdog" in r.getMessage())
    assert "'W'" in dump and "wd-holder" in dump
    block = dump_all_stacks(reason="unit probe",
                            logger=logging.getLogger("tests.watchdog"))
    assert "unit probe" in block


def test_lock_families_are_emitted(restore_instrumentation):
    instrument_locks(True)
    lock = new_lock("TestLockMetrics.lock")
    for _ in range(5):
        with lock:
            pass
    metrics = MetricsRegistry()
    register_lock_metrics(metrics)
    text = metrics.render()
    for series in ("pio_lock_instrumented 1", "pio_lock_acquisitions",
                   "pio_lock_contention_total", "pio_lock_inversions_total",
                   "pio_lock_reentries_total",
                   "pio_lock_watchdog_dumps_total"):
        assert series in text, series
    assert 'pio_lock_hold_seconds_count{lock="TestLockMetrics.lock"}' in text
    assert lock_registry().report()["acquisitions"] >= 5


def test_debug_locks_instrument_the_serving_stack(restore_instrumentation):
    instrument_locks(False)
    engine, ep = _engine()
    qs = QueryServer(engine, ep, [_model()], ServerConfig(
        device="cpu", warm_start=False, debug_locks=True,
        serving_cache=True, hot_entities=8, hot_refresh_every=4))
    try:
        assert locks_instrumented()
        assert isinstance(qs._lock, DebugLock)
        assert isinstance(qs.cache.flight._lock, DebugLock)
        assert isinstance(qs.cache.query._shards[0].lock, DebugLock)
        assert "pio_lock_instrumented 1" in qs.metrics.render()
        reg = lock_registry()
        base = len(reg.inversions)
        stop, errors = threading.Event(), []

        def serve_loop(i):
            n = 0
            try:
                while not stop.is_set():
                    n += 1
                    out = qs.serve({"user": f"u{n % 5}", "num": 3})
                    assert len(out["itemScores"]) == 3
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        def rebind_loop():
            try:
                while not stop.is_set():
                    qs._bind(qs.engine_params, [_model()], qs.instance)
                    time.sleep(0.02)
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = ([threading.Thread(target=serve_loop, args=(i,))
                    for i in range(4)]
                   + [threading.Thread(target=rebind_loop)])
        for t in threads:
            t.start()
        time.sleep(0.8)
        stop.set()
        for t in threads:
            t.join(timeout=10)
            assert not t.is_alive()
        assert errors == []
        assert reg.inversions[base:] == []
        assert reg.reentries == []
    finally:
        qs.close()
