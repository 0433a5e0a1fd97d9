"""The port's bind-time warm-up and kernel root, held to the JAX package
where it has a counterpart, on the CPU.

- The serving ladder: ``ALSAlgorithm.warm_serving`` calls
  ``recommend_products`` and ``recommend_batch`` at exactly the JAX
  package's (B, k) pairs, and ``SeqRecAlgorithm.warm_serving``
  ``recommend_next_batch`` at its batch sizes (each recorded by wrapping
  the functions of both packages).
- The engine server's lifecycle (``warming`` -> ``ready`` ->
  ``draining``, answering all along), the re-warm of ``/reload`` and of
  a promotion under a new generation (a stale warm thread never sets
  ``warm_done``), and a warm-up that raises: ``warmReport["error"]``
  carries its text and the query that follows raises the same.
- The kernel root of ``ops/_build.py``: flag, then
  ``$PTPU_ARTIFACT_DIR``, then the default; no move after a load; the
  build's bookkeeping through a stand-in ``nvcc``; ``cli build`` without
  ``nvcc`` fails with ``find_nvcc``'s message.
"""

import ctypes
import json
import os
import stat
import threading
import time
import urllib.error
import urllib.request
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

import predictionio_tpu.models.als as jals
import predictionio_tpu.models.seqrec as jseqrec
from predictionio_tpu.data.bimap import BiMap as JBiMap
from predictionio_tpu.templates import sequential as jseq_t
from predictionio_tpu.templates.recommendation import (
    ALSAlgorithm as JALSAlgorithm,
)
from predictionio_tpu_torch import cli
from predictionio_tpu_torch.controller.context import Context
from predictionio_tpu_torch.data.storage.base import (
    STATUS_COMPLETED,
    App,
    EngineInstance,
    Model,
)
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.models.convert import als_model_from_numpy
from predictionio_tpu_torch.models.seqrec import (
    SeqRecModel,
    SeqRecParams,
    _init_weights,
)
from predictionio_tpu_torch.ops import _build
from predictionio_tpu_torch.server import engineserver as es
from predictionio_tpu_torch.templates import recommendation as rec_t
from predictionio_tpu_torch.templates import sequential as seq_t
from predictionio_tpu_torch.templates.recommendation import (
    ALSAlgorithm,
    recommendation_engine,
)
from predictionio_tpu_torch.workflow.persistence import dumps_models

T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
RANK = 4
N_USERS = 12
ENGINE = ("warm-engine", "1", "engine.json")
VARIANT = {"algorithms": [{"name": "als", "params": {"rank": RANK}}]}

_LOCAL = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def call(port, method, path, body=None):
    data = json.dumps(body).encode() if body is not None else (
        b"" if method == "POST" else None)
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method=method)
    try:
        with _LOCAL.open(req, timeout=30) as r:
            raw = r.read()
            return r.status, (json.loads(raw) if path != "/" else
                              raw.decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def tables(n_items, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N_USERS, RANK)).astype(np.float32),
            rng.standard_normal((n_items, RANK)).astype(np.float32))


def port_model(n_items, seed=0):
    U, V = tables(n_items, seed)
    return als_model_from_numpy(
        U, V, N_USERS, n_items, {f"u{i}": i for i in range(N_USERS)},
        {f"i{i}": i for i in range(n_items)}, {"rank": RANK}, device="cpu")


def jax_model(n_items, seed=0):
    U, V = tables(n_items, seed)
    return jals.ALSModel(
        user_factors=U, item_factors=V, n_users=N_USERS, n_items=n_items,
        user_ids=JBiMap({f"u{i}": i for i in range(N_USERS)}),
        item_ids=JBiMap({f"i{i}": i for i in range(n_items)}),
        params=jals.ALSParams(rank=RANK))


def wait_for(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


# -- the serving ladder ------------------------------------------------------

@pytest.mark.parametrize("n_items,max_batch", [(40, 1), (40, 5), (300, 128),
                                               (6, 16)],
                         ids=["k8-32-B1", "k8-32-B8", "k8-128-B128",
                              "catalog-6"])
def test_ladder_is_the_jax_ladder(monkeypatch, n_items, max_batch):
    """The port's ladder calls the serving functions at exactly the JAX
    package's (entry, B, k) sequence; the port's calls run for real on
    CPU tensors and return k ranked rows each."""
    jcalls, pcalls = [], []
    monkeypatch.setattr(jals, "recommend_products",
                        lambda m, u, k: jcalls.append(("products", 1, k)))
    monkeypatch.setattr(jals, "recommend_batch",
                        lambda m, idx, k: jcalls.append(
                            ("batch", len(idx), k)))
    JALSAlgorithm(jals.ALSParams(rank=RANK)).warm_serving(
        jax_model(n_items), max_batch)

    real_products, real_batch = rec_t.recommend_products, \
        rec_t.recommend_batch

    def products(m, u, k):
        ids, _ = real_products(m, u, k)
        assert len(ids) == min(k, m.n_items)
        pcalls.append(("products", 1, k))

    def batch(m, idx, k):
        ids, _ = real_batch(m, idx, k)
        assert ids.shape == (len(idx), min(k, m.n_items))
        pcalls.append(("batch", len(idx), k))

    monkeypatch.setattr(rec_t, "recommend_products", products)
    monkeypatch.setattr(rec_t, "recommend_batch", batch)
    n = ALSAlgorithm().warm_serving(port_model(n_items), max_batch)
    assert pcalls == jcalls and n == len(jcalls) > 0
    assert max(k for _, _, k in pcalls) <= 128


@pytest.mark.parametrize("max_batch", [1, 6, 32])
def test_seqrec_ladder_is_the_jax_ladder(monkeypatch, max_batch):
    jb, pb = [], []
    monkeypatch.setattr(jseq_t, "recommend_next_batch",
                        lambda m, h, k=10: jb.append((len(h), k)))
    jseq_t.SeqRecAlgorithm().warm_serving(
        jseqrec.SeqRecModel(params=jseqrec.SeqRecParams(), weights={},
                            n_items=5), max_batch)
    p = SeqRecParams(dim=8, heads=2, max_len=4)
    model = SeqRecModel(weights=_init_weights(5, p), n_items=5, params=p)
    real = seq_t.recommend_next_batch

    def wrapped(m, histories, k=10):
        ids, _ = real(m, histories, k=k)
        assert ids.shape[0] == len(histories)
        pb.append((len(histories), k))
        return ids, _

    monkeypatch.setattr(seq_t, "recommend_next_batch", wrapped)
    n = seq_t.SeqRecAlgorithm().warm_serving(model, max_batch)
    assert pb == jb and n == len(jb)


# -- the engine server's warm-up and lifecycle ------------------------------------

class GatedWarm:
    """Stands in for ``ALSAlgorithm.warm_serving``: each call waits for
    its own gate, in call order, and then runs the real ladder."""

    def __init__(self, monkeypatch):
        self.gates, self.done = [], []
        self._lock = threading.Lock()
        real = ALSAlgorithm.warm_serving

        def warm(algo, model, max_batch=1):
            with self._lock:
                gate, done = threading.Event(), threading.Event()
                self.gates.append(gate)
                self.done.append(done)
            try:
                assert gate.wait(30)
                return real(algo, model, max_batch)
            finally:
                done.set()

        monkeypatch.setattr(ALSAlgorithm, "warm_serving", warm)

    def release(self, i):
        assert wait_for(lambda: len(self.gates) > i)
        self.gates[i].set()
        assert self.done[i].wait(30)


def test_lifecycle_warming_ready_draining(monkeypatch):
    gated = GatedWarm(monkeypatch)
    srv = es.deploy_models(recommendation_engine(),
                           recommendation_engine().params_from_variant(
                               VARIANT),
                           [port_model(40)],
                           es.ServerConfig(device="cpu", batching=True,
                                           max_batch=8),
                           "127.0.0.1", 0).start_background()
    try:
        qs = srv.query_server
        _, st = call(srv.port, "GET", "/status.json")
        assert st["lifecycle"] == "warming" and not st["servingWarm"]
        # a query while warming is answered
        code, got = call(srv.port, "POST", "/queries.json",
                         {"user": "u1", "num": 3})
        assert code == 200 and len(got["itemScores"]) == 3
        gated.release(0)
        assert qs.warm_done.wait(30)
        _, st = call(srv.port, "GET", "/status.json")
        assert st["lifecycle"] == "ready" and st["servingWarm"]
        rep = st["warmReport"]
        assert st["artifactWarm"] and "error" not in rep
        # the CPU loads no library; the ladder: k 8..32, B 1..8
        assert rep["libraries"] == {} and rep["probeCalls"] == 3 + 3 * 4
        assert set(rep["seconds"]) == {"load", "compile", "replicate",
                                       "probe"}
        assert rep["seconds"]["compile"] == 0 \
            and rep["seconds"]["replicate"] == 0
        assert rep["launches"] == {"fused_topk": 0}  # plain versions
        code, body = call(srv.port, "POST", "/drain")
        assert code == 200 and body == {"lifecycle": "draining"}
        code, got = call(srv.port, "POST", "/queries.json",
                         {"user": "u2", "num": 2})
        assert code == 200 and len(got["itemScores"]) == 2
        _, st = call(srv.port, "GET", "/status.json")
        assert st["lifecycle"] == "draining" and st["requestCount"] == 2
        assert st["avgServingSec"] > 0 and st["lastServingSec"] > 0
        text = qs.metrics.render()
        assert "pio_serving_warm 1" in text
        assert 'pio_warmup_seconds_count{phase="probe"} 1' in text
    finally:
        srv.close()


def test_warm_start_off_is_ready_at_once():
    srv = es.deploy_models(recommendation_engine(),
                           recommendation_engine().params_from_variant(
                               VARIANT),
                           [port_model(40)],
                           es.ServerConfig(device="cpu", warm_start=False),
                           "127.0.0.1", 0)
    try:
        st = srv.query_server.status()
        assert st["servingWarm"] and st["lifecycle"] == "ready"
        assert st["warmReport"] == {}
    finally:
        srv.close()


def add_release(storage, iid, minute, seed):
    start = T0 + timedelta(minutes=minute)
    storage.engine_instances().insert(EngineInstance(
        id=iid, status=STATUS_COMPLETED, start_time=start, end_time=start,
        engine_id=ENGINE[0], engine_version=ENGINE[1],
        engine_variant=ENGINE[2], engine_factory="synthetic"))
    storage.models().insert(Model(iid, dumps_models([port_model(40,
                                                                seed)])))


@pytest.fixture()
def release_store():
    st = Storage(env={"PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"})
    st.apps().insert(App(0, "warmapp"))
    add_release(st, "w1", 0, seed=1)
    add_release(st, "w2", 1, seed=2)
    return st


def _deploy(storage, **cfg):
    engine = recommendation_engine()
    return es.deploy(Context(device="cpu", _storage=storage), engine,
                     engine.params_from_variant(VARIANT), *ENGINE,
                     config=es.ServerConfig(device="cpu", **cfg),
                     host="127.0.0.1", port=0).start_background()


def test_reload_rewarms_and_a_stale_generation_never_sets_warm(
        monkeypatch, release_store):
    gated = GatedWarm(monkeypatch)
    srv = _deploy(release_store)
    qs = srv.query_server
    try:
        code, body = call(srv.port, "POST", "/reload")  # while warming
        assert code == 200 and body["engineInstanceId"] == "w2"
        assert qs._warm_gen == 1 and not qs.warm_done.is_set()
        gated.release(0)  # the bind's thread, now stale, finishes
        time.sleep(0.05)
        assert not qs.warm_done.is_set()
        assert call(srv.port, "GET", "/status.json")[1]["lifecycle"] \
            == "warming"
        gated.release(1)  # the reload's thread
        assert qs.warm_done.wait(30)
        assert qs.status()["lifecycle"] == "ready"
        # a promotion re-warms under the next generation
        qs.bind_candidate(release_store.engine_instances().get("w1"))
        assert qs.promote_candidate() == "w1"
        assert qs._warm_gen == 2 and not qs.warm_done.is_set()
        gated.release(2)
        assert qs.warm_done.wait(30)
        assert qs.status()["warmReport"]["probeCalls"] == 3 + 3
    finally:
        srv.close()
    assert not any(t.is_alive() for t in qs._warm_threads)


def test_a_failed_warm_is_reported_and_the_next_query_raises_the_same(
        monkeypatch):
    from predictionio_tpu_torch.models import als

    def broken(*a, **kw):
        raise RuntimeError("nvcc failed to build fused_topk.cu")

    monkeypatch.setattr(als, "_device_topk", broken)
    srv = es.deploy_models(recommendation_engine(),
                           recommendation_engine().params_from_variant(
                               VARIANT),
                           [port_model(40)], es.ServerConfig(device="cpu"),
                           "127.0.0.1", 0).start_background()
    try:
        assert srv.query_server.warm_done.wait(30)
        _, st = call(srv.port, "GET", "/status.json")
        assert st["warmReport"]["error"] == \
            "nvcc failed to build fused_topk.cu"
        assert not st["artifactWarm"]
        code, body = call(srv.port, "POST", "/queries.json",
                          {"user": "u1", "num": 3})
        assert code == 500 and body["message"] == st["warmReport"]["error"]
    finally:
        srv.close()


def test_the_load_phase_reports_a_build(monkeypatch):
    """The load phase's bookkeeping, with ``load_all`` stood in for (the
    CPU loads no library): a library compiled at this bind makes the warm
    not an artifact warm and its seconds the compile phase; a load that
    raises is reported and the ladder is not run."""
    srv = es.deploy_models(recommendation_engine(),
                           recommendation_engine().params_from_variant(
                               VARIANT),
                           [port_model(40)],
                           es.ServerConfig(device="cpu", warm_start=False),
                           "127.0.0.1", 0)
    qs = srv.query_server
    try:
        asked = []
        monkeypatch.setattr(qs, "_serving_kernels",
                            lambda algos: ["fused_topk"])

        def load_all(names, since=None):
            asked.append(list(names))
            return {"libraries": {"fused_topk": {"compiled": True,
                                                 "seconds": 4.5}},
                    "compileSeconds": 4.5, "seconds": 4.75}

        monkeypatch.setattr(_build, "load_all", load_all)
        qs._warm_serving(qs._warm_gen)
        rep = qs.status()["warmReport"]
        assert asked == [["fused_topk"]] and not rep["artifact"]
        assert rep["seconds"]["compile"] == 4.5
        assert rep["seconds"]["load"] == pytest.approx(0.25)
        assert rep["probeCalls"] == 3 + 3

        def no_nvcc(names, since=None):
            _build.find_nvcc()

        monkeypatch.setattr(_build.shutil, "which", lambda _: None)
        monkeypatch.setattr(_build.os, "access", lambda *_: False)
        monkeypatch.setattr(_build, "load_all", no_nvcc)
        qs._warm_serving(qs._warm_gen)
        rep = qs.status()["warmReport"]
        assert rep["error"].startswith("nvcc not found")
        assert rep["probeCalls"] == 0 and not rep["artifact"]
    finally:
        srv.close()


def test_serving_kernels_of_a_card_binding():
    qs = es.QueryServer(recommendation_engine(),
                        recommendation_engine().params_from_variant(VARIANT),
                        [port_model(40)],
                        es.ServerConfig(device="cpu", warm_start=False))
    try:
        algos = qs.algorithms
        assert qs._serving_kernels(algos) == []  # the CPU: plain versions
        qs.device = type(qs.device)("cuda", 0)
        assert qs._serving_kernels(algos) == ["fused_topk"]
        qs.config.streaming = True
        assert qs._serving_kernels(algos) == ["fused_topk", "fused_gram",
                                              "chol_solve"]
    finally:
        qs.close()


def test_status_page_and_drain_on_a_release_store(release_store):
    srv = _deploy(release_store)
    try:
        assert srv.query_server.warm_done.wait(30)
        call(srv.port, "POST", "/queries.json", {"user": "u0", "num": 2})
        code, page = call(srv.port, "GET", "/")
        assert code == 200
        for text in ("engine instance: w2", "requests served: 1",
                     "lifecycle: ready", "stable release: w2",
                     "model lineage: base w2", "<td>deploy</td>"):
            assert text in page, text
        call(srv.port, "POST", "/drain")
        assert "lifecycle: draining" in call(srv.port, "GET", "/")[1]
    finally:
        srv.close()


# -- the kernel root ----------------------------------------------------------

@pytest.fixture()
def fresh_root(monkeypatch):
    """The build module's per-process state, restored after the test."""
    monkeypatch.setattr(_build, "_root", None)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_compiled", {})
    monkeypatch.delenv("PTPU_ARTIFACT_DIR", raising=False)


def test_root_from_flag_then_variable_then_default(fresh_root, monkeypatch,
                                                    tmp_path):
    assert _build.root() == _build.BUILD_ROOT
    monkeypatch.setattr(_build, "_root", None)
    monkeypatch.setenv("PTPU_ARTIFACT_DIR", str(tmp_path / "env"))
    assert _build.root() == tmp_path / "env" / "torch_kernels"
    assert _build.set_root(str(tmp_path / "flag")) \
        == tmp_path / "flag" / "torch_kernels"
    assert _build.root() == tmp_path / "flag" / "torch_kernels"
    assert _build._target("fused_topk").parent.parent \
        == tmp_path / "flag" / "torch_kernels"


def test_set_root_after_a_load_raises(fresh_root, tmp_path):
    _build.set_root(str(tmp_path / "a"))
    _build._loaded["fused_topk"] = object()
    assert _build.set_root(str(tmp_path / "a")) \
        == tmp_path / "a" / "torch_kernels"  # the same root: no move
    with pytest.raises(RuntimeError, match="cannot move it"):
        _build.set_root(str(tmp_path / "b"))
    assert _build.root() == tmp_path / "a" / "torch_kernels"


@pytest.fixture()
def fake_nvcc(tmp_path, monkeypatch):
    """An ``nvcc`` on ``PATH`` that "compiles" by copying a loadable
    shared object (the interpreter's ``_ctypes`` extension) to ``-o``,
    after a pause, and logs a ptxas line."""
    import _ctypes

    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        "while [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = -o ]; then out=$2; fi; shift\n"
        "done\n"
        "sleep 0.2\n"
        f"cp '{_ctypes.__file__}' \"$out\"\n"
        "echo 'ptxas info    : Used 32 registers'\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}"
                               f"{os.environ.get('PATH', '')}")
    return nvcc


def test_build_all_then_load_all_loads_from_disk(fresh_root, fake_nvcc,
                                                 tmp_path):
    _build.set_root(str(tmp_path / "art"))
    first = _build.build_all()
    libs = first["libraries"]
    assert sorted(libs) == _build.all_sources()
    assert all(r["compiled"] and r["seconds"] >= 0.2 for r in libs.values())
    assert all("Used 32 registers" in r["log"] for r in libs.values())
    assert _build.built() == _build.all_sources()
    assert not list((tmp_path / "art").rglob("*.tmp")) \
        and not list((tmp_path / "art").rglob("*.log"))
    again = _build.build_all()
    assert not any(r["compiled"] for r in again["libraries"].values())
    loaded = _build.load_all(["fused_topk", "chol_solve", "fused_topk"])
    assert loaded["compileSeconds"] == 0.0
    assert loaded["libraries"] == {
        "fused_topk": {"compiled": False, "seconds": 0.0},
        "chol_solve": {"compiled": False, "seconds": 0.0}}
    assert isinstance(_build.load_library("fused_topk"), ctypes.CDLL)
    with pytest.raises(RuntimeError, match="cannot move it"):
        _build.set_root(str(tmp_path / "elsewhere"))


def test_load_all_compiles_what_is_missing(fresh_root, fake_nvcc, tmp_path,
                                           monkeypatch):
    monkeypatch.setattr(_build, "_compiled", {})
    _build.set_root(str(tmp_path / "cold"))
    bind = time.monotonic()
    out = _build.load_all(["fused_topk"], since=bind)
    assert out["libraries"]["fused_topk"]["compiled"]
    assert out["compileSeconds"] >= 0.2
    assert _build.built() == ["fused_topk"]
    # a kernel call that built its library first, after the bind: the
    # bind's load still reports the build
    _build.load_library("chol_solve")
    out = _build.load_all(["fused_topk", "chol_solve"], since=bind)
    assert all(r["compiled"] for r in out["libraries"].values())
    # a later bind (a reload) built nothing
    out = _build.load_all(["fused_topk", "chol_solve"])
    assert not any(r["compiled"] for r in out["libraries"].values())
    assert out["compileSeconds"] == 0.0


def test_cli_build_reports_each_library(fresh_root, fake_nvcc, tmp_path,
                                        capsys):
    ej = tmp_path / "engine.json"
    ej.write_text(json.dumps(VARIANT))
    art = str(tmp_path / "art")
    assert cli.main(["build", "--engine-json", str(ej), "--artifact-dir",
                     art], storage=Storage(
        env={"PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"})) == 0
    out = capsys.readouterr().out
    assert "loads OK (1 algorithm(s) configured)." in out
    assert f"Kernel root: {tmp_path / 'art' / 'torch_kernels'}" in out
    for name in _build.all_sources():
        assert f"  {name}: compiled (" in out
    assert out.rstrip().endswith("Build finished successfully.")
    assert cli.main(["build", "--engine-json", str(ej), "--artifact-dir",
                     art, "--aot", "--batching", "--max-batch", "64"],
                    storage=Storage(
                        env={"PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"})) == 0
    assert "  fused_topk: already built (" in capsys.readouterr().out


def test_cli_build_builds_the_native_codec_beside_the_kernels(
        fresh_root, fake_nvcc, tmp_path, capsys):
    """``cli build`` compiles the host codec (g++) into the same kernel
    root, and a second build compiles neither."""
    from predictionio_tpu_torch import native

    ej = tmp_path / "engine.json"
    ej.write_text(json.dumps(VARIANT))
    argv = ["build", "--engine-json", str(ej), "--artifact-dir",
            str(tmp_path / "art")]
    st = Storage(env={"PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"})
    assert cli.main(argv, storage=st) == 0
    assert "  native codec (host, g++): compiled (" in \
        capsys.readouterr().out
    so = native.target()
    assert so.exists() and so.parent.parent == \
        tmp_path / "art" / "torch_kernels"
    assert cli.main(argv, storage=st) == 0
    out = capsys.readouterr().out
    assert "compiled (" not in out
    assert "  native codec (host, g++): already built (" in out


def test_cli_build_without_nvcc_fails_with_find_nvcc_message(
        fresh_root, monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os, "access", lambda *_: False)
    ej = tmp_path / "engine.json"
    ej.write_text(json.dumps(VARIANT))
    st = Storage(env={"PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"})
    assert cli.main(["build", "--engine-json", str(ej), "--artifact-dir",
                     str(tmp_path / "art")], storage=st) == 1
    captured = capsys.readouterr()
    assert "loads OK" in captured.out
    assert "nvcc not found (neither on PATH nor /usr/local/cuda/bin)" \
        in captured.err
    assert "Build finished" not in captured.out
    # --device cpu checks the variant only
    assert cli.main(["build", "--engine-json", str(ej), "--device", "cpu"],
                    storage=st) == 0
    assert "Build finished successfully." in capsys.readouterr().out


def test_deploy_artifact_dir_sets_the_root(fresh_root, tmp_path):
    srv = es.deploy_models(recommendation_engine(),
                           recommendation_engine().params_from_variant(
                               VARIANT),
                           [port_model(40)],
                           es.ServerConfig(device="cpu",
                                           artifact_dir=str(tmp_path)),
                           "127.0.0.1", 0)
    try:
        assert srv.query_server.warm_done.wait(30)
        assert srv.query_server.status()["warmReport"]["root"] \
            == str(tmp_path / "torch_kernels")
    finally:
        srv.close()
