"""The port's packages export the JAX package's public names, import
without JAX and without building a kernel or touching CUDA, and the
storage registry's ``register_backend`` and ``EventStore.write`` behave
as the JAX package's over MEMORY and SQLite."""

import importlib
import subprocess
import sys
from datetime import datetime, timedelta, timezone
from pathlib import Path

import pytest

import predictionio_tpu.data.storage as jstorage
from predictionio_tpu.data.datamap import DataMap as JDataMap
from predictionio_tpu.data.event import Event as JEvent
from predictionio_tpu.data.storage.base import EventFilter as JFilter
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import (
    Backend,
    EventFilter,
    Storage,
    StorageError,
    register_backend,
)
from predictionio_tpu_torch.data.storage import memory as pmemory
from predictionio_tpu_torch.data.storage import registry as pregistry

ROOT = Path(__file__).resolve().parents[1]
T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)

#: subpackage -> names of the JAX package's exports the port leaves out,
#: each by a decision in ``ROADMAP.md``
EXCEPTIONS = {
    "obs": {"TransferGuardCounter"},  # XLA transfer logging
}

#: the JAX ``__init__`` files whose exports the port re-exports
PACKAGES = ["", ".data", ".data.storage", ".models", ".workflow",
            ".server", ".utils", ".faults", ".controller", ".obs",
            ".concurrency", ".cache", ".rollout", ".streaming", ".slo",
            ".fleet", ".router", ".parallel"]


def public_names(mod):
    """``__all__``, or for an ``__init__`` without one (``server``,
    ``utils``) every public name that is not a submodule."""
    names = getattr(mod, "__all__", None)
    if names is not None:
        return set(names)
    return {n for n in dir(mod) if not n.startswith("_")
            and not isinstance(getattr(mod, n), type(sys))}


@pytest.mark.parametrize("sub", PACKAGES, ids=lambda s: s or "top")
def test_the_jax_packages_names_are_exported(sub):
    jax_mod = importlib.import_module("predictionio_tpu" + sub)
    port_mod = importlib.import_module("predictionio_tpu_torch" + sub)
    want = public_names(jax_mod) - EXCEPTIONS.get(sub.lstrip("."), set())
    missing = sorted(n for n in want if not hasattr(port_mod, n))
    assert not missing, f"predictionio_tpu_torch{sub} lacks {missing}"
    if hasattr(jax_mod, "__all__"):
        assert want <= set(port_mod.__all__)


def test_importing_the_packages_loads_no_jax_builds_nothing():
    """A fresh interpreter imports every re-exporting package: no
    ``jax`` module, no CUDA context, no kernel library loaded."""
    code = (
        "import sys, torch\n"
        "import predictionio_tpu_torch as p\n"
        "from predictionio_tpu_torch.data.storage import Storage, "
        "register_backend\n"
        "import predictionio_tpu_torch.data, predictionio_tpu_torch.models,"
        " predictionio_tpu_torch.workflow, predictionio_tpu_torch.server,"
        " predictionio_tpu_torch.utils, predictionio_tpu_torch.faults,"
        " predictionio_tpu_torch.controller,"
        " predictionio_tpu_torch.concurrency, predictionio_tpu_torch.slo,"
        " predictionio_tpu_torch.fleet, predictionio_tpu_torch.router\n"
        "from predictionio_tpu_torch.ops import _build\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ml_dtypes', 'predictionio_tpu')]\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert not _build._loaded, _build._loaded\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


def test_register_backend_opens_a_type_of_ones_own():
    calls = []

    def make_client(cfg):
        calls.append(dict(cfg))
        return "client"

    register_backend("mine", Backend(
        make_client=make_client,
        daos={"events": lambda c: pmemory.MemoryEventStore(),
              "apps": lambda c: pmemory.MemoryApps(),
              "access_keys": lambda c: pmemory.MemoryAccessKeys(),
              "channels": lambda c: pmemory.MemoryChannels(),
              "engine_instances": lambda c: pmemory.MemoryEngineInstances(),
              "evaluation_instances":
                  lambda c: pmemory.MemoryEvaluationInstances(),
              "models": lambda c: pmemory.MemoryModels()}))
    try:
        st = Storage(env={"PIO_STORAGE_SOURCES_X_TYPE": "Mine",
                          "PIO_STORAGE_SOURCES_X_OPTION": "v"})
        st.events().init(1)
        assert calls == [{"OPTION": "v"}]
        assert isinstance(st.events(), pmemory.MemoryEventStore)
        st.close()
    finally:
        pregistry._BACKENDS.pop("MINE", None)
    with pytest.raises(StorageError):
        Storage(env={"PIO_STORAGE_SOURCES_X_TYPE": "mine"}).events()
    # the JAX package's registry keys its types the same way
    assert set(jstorage.registry._BACKENDS) <= set(pregistry._BACKENDS)


def _events(pkg_event, pkg_map, n):
    return [pkg_event(event="rate", entity_type="user",
                      entity_id=f"u{k % 7}", target_entity_type="item",
                      target_entity_id=f"i{k % 11}",
                      properties=pkg_map({"rating": float(k % 5)}),
                      event_time=T0 + timedelta(seconds=k))
            for k in range(n)]


@pytest.mark.parametrize("kind", ["MEMORY", "SQLITE"])
@pytest.mark.parametrize("n", [0, 7, 2500])
def test_event_store_write_is_the_jax_packages(kind, n, tmp_path):
    """``write`` stores every event (batches of 1,000), and a find reads
    back what the JAX package's ``write`` stored from the same events."""
    if kind == "MEMORY":
        env = {"PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"}
        penv, jenv = env, env
    else:
        penv = {"PIO_HOME": str(tmp_path / "port")}
        jenv = {"PIO_HOME": str(tmp_path / "jax")}
    pst, jst = Storage(env=penv), jstorage.Storage(env=jenv)
    try:
        pst.events().init(1)
        jst.events().init(1)
        pst.events().write(iter(_events(Event, DataMap, n)), 1)
        jst.events().write(iter(_events(JEvent, JDataMap, n)), 1)

        def rows(found):
            return sorted((e.entity_id, e.target_entity_id,
                           e.properties.to_dict()["rating"],
                           e.event_time.timestamp()) for e in found)

        assert rows(pst.events().find(1, filter=EventFilter())) == \
            rows(jst.events().find(1, filter=JFilter()))
        assert len(rows(pst.events().find(1, filter=EventFilter()))) == n
    finally:
        pst.close()
        jst.close()


# -- the public methods of the port's classes (ROADMAP queue 1 item 18) --------

#: (module, class) whose public methods, properties and static methods the
#: port's class defines as the JAX package's does; None: the module's own
#: public functions
CLASS_SURFACES = [
    ("cache.bus", "InvalidationBus"),
    ("rollout.splitter", "TrafficSplitter"),
    ("models.als", "QuantizedFactors"),
    ("models.als", None),
    ("server.http", "AppServer"),
    ("server.engineserver", "QueryServer"),
    ("controller.context", "Context"),
    ("controller.engine", "Engine"),
    ("ops.ragged", None),
    ("utils.tracing", None),
    ("parallel.mesh", None),
]

#: names of those surfaces the port leaves out, each by a decision under
#: "Decided not to port" in ``ROADMAP.md``
LEFT_OUT = {
    # the XLA compile caches and the sharding rules' findings
    ("server.engineserver", "QueryServer"): {"artifact_key",
                                             "sharding_findings_status"},
    # serving_topk: the card ranks k <= 128 through fused_topk
    ("models.als", None): {"resolved_topk_mode", "set_serving_topk_mode"},
}


def surface(mod, cls_name):
    import inspect

    if cls_name is None:
        return {n for n, v in vars(mod).items()
                if not n.startswith("_") and inspect.isfunction(v)
                and v.__module__ == mod.__name__}
    return {n for n, v in vars(getattr(mod, cls_name)).items()
            if not n.startswith("_") and (
                inspect.isfunction(v)
                or isinstance(v, (property, staticmethod, classmethod)))}


@pytest.mark.parametrize("module,cls_name", CLASS_SURFACES,
                         ids=lambda v: str(v))
def test_the_jax_classes_methods_are_ported(module, cls_name):
    jax_mod = importlib.import_module("predictionio_tpu." + module)
    port_mod = importlib.import_module("predictionio_tpu_torch." + module)
    want = surface(jax_mod, cls_name) - LEFT_OUT.get((module, cls_name),
                                                     set())
    owner = port_mod if cls_name is None else getattr(port_mod, cls_name)
    missing = sorted(n for n in want if not hasattr(owner, n))
    assert not missing, f"{module}.{cls_name or ''} lacks {missing}"


def test_subscriber_count_follows_subscribe_and_unsubscribe():
    import gc

    from predictionio_tpu.cache.bus import InvalidationBus as JBus
    from predictionio_tpu_torch.cache.bus import InvalidationBus

    class Owner:
        def on_event(self, *a):
            pass

    counts = {}
    for name, bus in (("jax", JBus()), ("port", InvalidationBus())):
        a, b, c = Owner(), Owner(), Owner()
        seen = [bus.subscriber_count()]
        for owner in (a, b, c):
            bus.subscribe(owner)
        del owner
        seen.append(bus.subscriber_count())
        bus.unsubscribe(b)
        seen.append(bus.subscriber_count())
        del c
        gc.collect()
        seen.append(bus.subscriber_count())
        assert bus.stats()["subscribers"] == seen[-1]
        counts[name] = seen
    assert counts["port"] == counts["jax"] == [0, 3, 2, 1]


@pytest.mark.parametrize("fraction,shadow", [(0.25, True), (1.0, False)])
def test_describe_is_the_jax_splitters(fraction, shadow):
    from predictionio_tpu.rollout.splitter import TrafficSplitter as JSplit
    from predictionio_tpu_torch.rollout.splitter import TrafficSplitter

    assert TrafficSplitter(fraction, shadow).describe() == \
        JSplit(fraction, shadow).describe() == \
        {"fraction": fraction, "shadow": shadow}


@pytest.mark.parametrize("quant", ["int8", "bf16"])
def test_quantized_factors_nbytes_and_shape_are_the_jax_packages(quant):
    import numpy as np
    import jax.numpy as jnp

    import predictionio_tpu.models.als as jals
    from predictionio_tpu_torch.models import als as pals

    rows = np.random.default_rng(4).normal(size=(37, 12)).astype(np.float32)
    jd, js = jals._quantize_rows(rows, quant)
    pd, ps = pals._quantize_rows(rows, quant)
    jq = jals.QuantizedFactors(jnp.asarray(jd),
                               None if js is None else jnp.asarray(js), quant)
    pq = pals.QuantizedFactors(pd, ps, quant)
    assert pq.shape == jq.shape == (37, 12)
    assert pq.nbytes == jq.nbytes == (37 * 12 + 37 * 4 if quant == "int8"
                                      else 37 * 12 * 2)


def test_ensure_device_resident_places_the_model():
    import numpy as np

    from predictionio_tpu_torch.models import als as pals
    from predictionio_tpu_torch.models.convert import als_model_from_numpy

    rng = np.random.default_rng(5)
    U = rng.normal(size=(6, 4)).astype(np.float32)
    V = rng.normal(size=(9, 4)).astype(np.float32)
    m = als_model_from_numpy(U, V, 6, 9, {f"u{i}": i for i in range(6)},
                             {f"i{i}": i for i in range(9)}, {"rank": 4},
                             device="cpu")
    placed = pals.ensure_device_resident(m, max_batch=64, device="cpu")
    assert placed.user_factors.device.type == "cpu"
    assert np.array_equal(placed.user_factors.numpy(), U)
    assert np.array_equal(placed.item_factors.numpy(), V)


def test_app_server_shutdown_stops_serving_as_the_jax_packages():
    import socket

    from predictionio_tpu.server import http as jhttp
    from predictionio_tpu_torch.server import http as phttp

    for pkg in (jhttp, phttp):
        srv = pkg.AppServer(pkg.HTTPApp("t"), "127.0.0.1", 0)
        srv.start_background()
        port = srv.port
        socket.create_connection(("127.0.0.1", port), timeout=5).close()
        srv.shutdown()
        with pytest.raises(OSError):
            socket.create_connection(("127.0.0.1", port), timeout=5)


def test_serving_kernel_status_shows_the_knobs_and_what_serves():
    import numpy as np

    from predictionio_tpu.server.engineserver import ServerConfig as JCfg
    from predictionio_tpu_torch.models.convert import als_model_from_numpy
    from predictionio_tpu_torch.server import engineserver as es
    from predictionio_tpu_torch.templates.recommendation import (
        recommendation_engine,
    )

    rng = np.random.default_rng(6)
    m = als_model_from_numpy(
        rng.normal(size=(20, 8)).astype(np.float32),
        rng.normal(size=(50, 8)).astype(np.float32), 20, 50,
        {f"u{i}": i for i in range(20)}, {f"i{i}": i for i in range(50)},
        {"rank": 8}, device="cpu")
    engine = recommendation_engine()
    ep = engine.params_from_variant(
        {"algorithms": [{"name": "als", "params": {"rank": 8}}]})
    qs = es.QueryServer(engine, ep, [m], es.ServerConfig(
        device="cpu", warm_start=False, serving_quant="int8",
        serving_topk="fused"))
    try:
        got = qs.status()["servingKernel"]
        assert got == qs.serving_kernel_status()
        assert {"configuredQuant", "configuredTopk", "mode", "quant"} <= \
            set(got)
        assert (got["configuredQuant"], got["configuredTopk"]) == \
            ("int8", "fused")
        assert (got["mode"], got["kernel"]) == ("fused", "fused_topk")
        assert got["quant"] == es.serving_quant_of(qs.models[0])
        assert es.ServerConfig().serving_topk == JCfg().serving_topk
    finally:
        qs.close()


def test_context_rng_draws_alike_for_one_seed():
    import torch

    from predictionio_tpu_torch.controller.context import Context

    def draws(seed):
        return torch.rand(8, generator=Context(device="cpu",
                                               seed=seed).rng())

    assert torch.equal(draws(3), draws(3))
    assert not torch.equal(draws(3), draws(4))
    assert Context(device="cpu").rng().device.type == "cpu"


def test_context_with_mesh_lays_out_the_local_devices(monkeypatch):
    from predictionio_tpu_torch import parallel as ppar
    from predictionio_tpu_torch.controller.context import Context

    monkeypatch.setenv(ppar.FORCE_DEVICE_COUNT_ENV, "4")
    ctx = Context(device="cpu")
    mesh = ctx.with_mesh()
    assert ctx.mesh is mesh and mesh.shape == (4, 1)
    assert mesh.axis_names == (ppar.DATA_AXIS, ppar.MODEL_AXIS)
    assert ctx.with_mesh() is mesh
    given = ppar.make_mesh(data=2, devices=ppar.local_devices("cpu"))
    assert Context(device="cpu", mesh=given).with_mesh() is given


@pytest.mark.parametrize("max_len,pad_rows_to", [(None, 1), (3, 4)])
def test_pack_histories_and_transpose_coo_are_the_jax_packages(max_len,
                                                              pad_rows_to):
    import numpy as np

    import predictionio_tpu.ops.ragged as jrag
    from predictionio_tpu_torch.ops import ragged as prag

    rng = np.random.default_rng(8)
    rows = rng.integers(0, 9, size=60).astype(np.int32)
    cols = rng.integers(0, 13, size=60).astype(np.int32)
    vals = rng.normal(size=60).astype(np.float32)
    want = jrag.pack_histories(rows, cols, vals, 10, max_len, pad_rows_to)
    got = prag.pack_histories(rows, cols, vals, 10, max_len, pad_rows_to)
    for field in ("indices", "values", "counts"):
        g = getattr(got, field)
        assert g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), getattr(want, field))
    for g, w in zip(prag.transpose_coo(rows, cols, vals),
                    jrag.transpose_coo(rows, cols, vals)):
        np.testing.assert_array_equal(g, w)


def test_trace_writes_a_chrome_trace_only_where_asked(tmp_path):
    import json

    import torch

    from predictionio_tpu_torch.utils.tracing import trace

    with trace(None):
        torch.ones(4).sum()
    with trace(""):
        torch.ones(4).sum()
    out = tmp_path / "traces"
    with trace(str(out)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = out.iterdir()
    assert path.suffix == ".json"
    assert json.loads(path.read_text())["traceEvents"]


def test_the_mesh_helpers_are_the_jax_packages(mesh8):
    import predictionio_tpu.parallel.mesh as jmesh
    from predictionio_tpu_torch import parallel as ppar
    from predictionio_tpu_torch.parallel import mesh as pmesh

    port = pmesh.make_mesh(data=4, model=2,
                           devices=[pmesh.local_devices("cpu")[0]] * 8)
    for name in ("data_sharding", "model_sharding", "replicated"):
        want = tuple(a for a in getattr(jmesh, name)(mesh8).spec
                     if a is not None)
        assert getattr(pmesh, name)(port) == want, name
        assert getattr(ppar, name) is getattr(pmesh, name)
    assert pmesh.single_device_mesh("cpu").shape == \
        tuple(jmesh.single_device_mesh().devices.shape) == (1, 1)
    with pmesh.maybe_mesh(None) as m:
        assert m is None
    with pmesh.maybe_mesh(port) as m:
        assert m is port
