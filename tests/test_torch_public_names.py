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
