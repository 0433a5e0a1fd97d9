"""The pod layout of the port on the CPU: the storage server's command
line, ``start-all --with-storageserver``, ``import`` into SEGMENTFS
through the native lane, and the ``pio`` slice trained and deployed on
storage that goes REMOTE -> SEGMENTFS for events and metadata plus an S3
bucket for the model blob, held to the JAX package on the same events.

The slice's parity follows ``tests/test_torch_lifecycle.py``: both
packages read the same ratings (the JAX package through its own REMOTE
client, against the port's storage server) and train from the JAX
package's initial draw, so the factors agree within rtol 2e-3, atol 2e-4;
the deployed server's top-k ids equal the JAX factors' top-k in float64.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path
from urllib.parse import quote

import jax
import numpy as np
import pytest
import torch

import predictionio_tpu.models.als as jals
import predictionio_tpu.templates.recommendation as jrec
from predictionio_tpu.controller.context import Context as JContext
from predictionio_tpu.data.storage.registry import Storage as JStorage
from predictionio_tpu_torch import cli, native
from predictionio_tpu_torch.controller.context import Context
from predictionio_tpu_torch.data.storage.base import STATUS_COMPLETED
from predictionio_tpu_torch.data.storage.objectstore import (
    FakeObjectStoreServer,
)
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.models import als
from predictionio_tpu_torch.server.storageserver import (
    create_storage_server,
)
from predictionio_tpu_torch.templates import recommendation as prec
from predictionio_tpu_torch.workflow.persistence import loads_models

ROOT = Path(__file__).resolve().parent.parent
APP = "MyApp1"
JAX_FACTORY = "predictionio_tpu.templates.recommendation:recommendation_engine"
N_USERS, N_ITEMS, RANK = 40, 30, 8

#: loopback only: no proxy from the environment may carry these requests
_LOCAL = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def remote_env(url: str, secret: str) -> dict:
    return {"PIO_STORAGE_SOURCES_NET_TYPE": "REMOTE",
            "PIO_STORAGE_SOURCES_NET_URL": url,
            "PIO_STORAGE_SOURCES_NET_SECRET": secret}


def rating_events(seed=0):
    """Every user rates a quarter of the items on half-star values."""
    rng = np.random.default_rng(seed)
    out = []
    for u in range(N_USERS):
        items = rng.choice(N_ITEMS, max(3, N_ITEMS // 4), replace=False)
        for k, i in enumerate(items):
            out.append({
                "event": "rate", "entityType": "user", "entityId": f"u{u}",
                "targetEntityType": "item", "targetEntityId": f"i{i}",
                "properties": {"rating": float(rng.integers(1, 11)) / 2},
                "eventTime": f"2024-01-01T00:{u % 60:02d}:{k:02d}.000Z"})
    return out


def write_jsonl(path: Path, events) -> str:
    path.write_text("".join(json.dumps(e) + "\n" for e in events))
    return str(path)


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_storageserver_serves_both_packages_clients(tmp_path):
    env = dict(os.environ, PIO_HOME=str(tmp_path / "home"),
               PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.cli",
         "storageserver", "--ip", "127.0.0.1", "--port", "0", "--secret",
         "pod"], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        line = proc.stdout.readline()
        assert "Storage Server is listening at http://127.0.0.1:" in line
        url = line.split(" at ", 1)[1].strip().rstrip(".")
        port_side = Storage(env=remote_env(url, "pod"))
        from predictionio_tpu.data.storage.base import App as JApp
        from predictionio_tpu_torch.data.storage.base import App
        app_id = port_side.apps().insert(App(0, "a1"))
        jax_side = JStorage(env=remote_env(url, "pod"))
        assert jax_side.apps().get(app_id).name == "a1"
        assert jax_side.apps().insert(JApp(0, "a2")) == app_id + 1
        assert [a.name for a in port_side.apps().get_all()] == ["a1", "a2"]
        port_side.close()
        jax_side.close()
        with pytest.raises(Exception, match="401"):
            Storage(env=remote_env(url, "nope")).apps().get_all()
    finally:
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=30)
    assert proc.returncode == 0 and "Shutting down." in out


def test_start_all_with_the_storage_server(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("PIO_HOME", str(tmp_path / "home"))
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    ports = {n: free_port() for n in ("storageserver", "eventserver",
                                      "adminserver", "dashboard")}
    pid_dir = tmp_path / "pids"
    argv = ["start-all", "--ip", "127.0.0.1", "--pid-dir", str(pid_dir),
            "--eventserver-port", str(ports["eventserver"]),
            "--adminserver-port", str(ports["adminserver"]),
            "--dashboard-port", str(ports["dashboard"]),
            "--with-storageserver",
            "--storageserver-port", str(ports["storageserver"]),
            "--storage-secret", "pod", "--start-timeout", "90"]
    store = Storage(env={"PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"})
    pids = {}
    try:
        assert cli.main(argv, storage=store) == 0, capsys.readouterr()
        out = capsys.readouterr().out
        assert out.index("storageserver: up") < out.index("eventserver: up")
        pids = {n: int((pid_dir / f"{n}.pid").read_text()) for n in ports}
        url = f"http://127.0.0.1:{ports['storageserver']}"
        remote = Storage(env=remote_env(url, "pod"))
        remote.verify_all_data_objects()
        remote.close()
        with pytest.raises(Exception, match="401"):
            Storage(env=remote_env(url, "bad")).apps().get_all()
    finally:
        assert cli.main(["stop-all", "--pid-dir", str(pid_dir)],
                        storage=store) == 0
    for n, pid in pids.items():
        assert not (pid_dir / f"{n}.pid").exists()
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    assert len(pids) == 4


def test_cli_import_into_segmentfs_takes_the_native_lane(tmp_path, capsys):
    st = Storage(env={"PIO_STORAGE_SOURCES_SEG_TYPE": "SEGMENTFS",
                      "PIO_STORAGE_SOURCES_SEG_PATH": str(tmp_path / "seg")})
    assert cli.main(["app", "new", APP], storage=st) == 0
    f = write_jsonl(tmp_path / "ev.jsonl", rating_events()[:200])
    native.reset_lane_counts()
    assert cli.main(["import", "--app", APP, "--input", f], storage=st) == 0
    out = capsys.readouterr().out
    assert "Imported 200 event(s)." in out and "sidecar ready" in out
    counts = native.lane_counts()
    assert counts["import_jsonl"] == {"native": 1, "python": 0}
    assert counts["parse_segment"]["python"] == 0
    assert len(list(st.events().find(1))) == 200
    st.close()


# -- the slice -------------------------------------------------------------------

def _jax_draw(seed, n_u, n_u_pad, n_i, n_i_pad, rank):
    """The JAX package's initial draw for these shapes, padded to the
    port's rows."""
    ku, ki = jax.random.split(jax.random.key(seed))
    out = []
    for key, n, n_pad in ((ku, n_u, n_u_pad), (ki, n_i, n_i_pad)):
        f = torch.zeros((n_pad, rank), dtype=torch.float32)
        f[:n] = torch.from_numpy(np.array(
            jals._init_factors(key, n=n, n_padded=n, rank=rank)))
        out.append(f)
    return tuple(out)


def call(port, method, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=None if body is None else json.dumps(body).encode())
    with _LOCAL.open(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read() or b"null")


def test_pio_on_the_pod_layout_matches_the_jax_package(tmp_path,
                                                       monkeypatch,
                                                       capsys):
    monkeypatch.setattr(als, "draw_initial_factors", _jax_draw)
    backing = Storage(env={"PIO_STORAGE_SOURCES_SEG_TYPE": "SEGMENTFS",
                           "PIO_STORAGE_SOURCES_SEG_PATH":
                               str(tmp_path / "seg")})
    srv = create_storage_server(backing, host="127.0.0.1", port=0,
                                secret="pod").start_background()
    bucket = FakeObjectStoreServer(str(tmp_path / "bucket"))
    bucket.start_background()
    env = dict(remote_env(f"http://127.0.0.1:{srv.port}", "pod"), **{
        "PIO_STORAGE_SOURCES_OBJ_TYPE": "S3",
        "PIO_STORAGE_SOURCES_OBJ_ENDPOINT":
            f"http://127.0.0.1:{bucket.port}/models",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "NET",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "NET",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "OBJ"})
    pod, jpod, deployed = Storage(env=env), JStorage(env=env), None
    try:
        assert cli.main(["app", "new", APP], storage=pod) == 0
        f = write_jsonl(tmp_path / "ev.jsonl", rating_events(seed=1))
        native.reset_lane_counts()
        assert cli.main(["import", "--app", APP, "--input", f],
                        storage=pod) == 0
        # the server's SEGMENTFS took the forwarded block on its native lane
        assert native.lane_counts()["import_jsonl"] == {"native": 1,
                                                        "python": 0}
        variant = tmp_path / "engine.json"
        variant.write_text(json.dumps({
            "id": "recommendation", "version": "1",
            "engineFactory": JAX_FACTORY,
            "datasource": {"params": {"app_name": APP}},
            "algorithms": [{"name": "als", "params": {
                "rank": RANK, "num_iterations": 3, "reg": 0.01,
                "seed": 3}}]}))
        assert cli.main(["train", "--engine-json", str(variant), "--device",
                         "cpu"], storage=pod) == 0
        assert "Training completed" in capsys.readouterr().out
        (inst,) = pod.engine_instances().get_all()
        assert inst.status == STATUS_COMPLETED
        blob = pod.models().get(inst.id).models
        on_disk = (tmp_path / "bucket" / quote(f"models/{inst.id}",
                                                safe="")).read_bytes()
        assert blob == on_disk
        (model,) = loads_models(blob)

        # the JAX package: the same ratings through its REMOTE client
        jtd = jrec.RecommendationDataSource(jrec.DataSourceParams(
            app_name=APP)).read_training(JContext(_storage=jpod))
        ptd = prec.RecommendationDataSource(prec.DataSourceParams(
            app_name=APP)).read_training(Context(device="cpu",
                                                 _storage=pod))
        for fld in ("users", "items", "ratings"):
            np.testing.assert_array_equal(getattr(ptd.ratings, fld),
                                          getattr(jtd.ratings, fld))
        assert ptd.user_ids.to_dict() == jtd.user_ids.to_dict()
        assert model.user_ids.to_dict() == jtd.user_ids.to_dict()
        jU, jV = jals.train_als(jtd.ratings, jals.ALSParams(
            rank=RANK, num_iterations=3, seed=3, reg=0.01))
        jU = np.asarray(jU)[:N_USERS].astype(np.float64)
        jV = np.asarray(jV)[:N_ITEMS].astype(np.float64)
        np.testing.assert_allclose(model.user_factors.numpy(), jU,
                                   rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(model.item_factors.numpy(), jV,
                                   rtol=2e-3, atol=2e-4)

        args = cli._parser().parse_args([
            "deploy", "--engine-json", str(variant), "--ip", "127.0.0.1",
            "--port", "0", "--device", "cpu"])
        deployed = cli.build_deploy(args, pod).start_background()
        st = call(deployed.port, "GET", "/status.json")[1]
        assert st["engineInstanceId"] == inst.id
        inv = jtd.item_ids.inverse
        for u in range(0, N_USERS, 3):
            status, body = call(deployed.port, "POST", "/queries.json",
                                {"user": f"u{u}", "num": 5})
            assert status == 200
            scores = jV @ jU[jtd.user_ids[f"u{u}"]]
            want = [inv[int(i)] for i in np.argsort(-scores,
                                                    kind="stable")[:5]]
            assert [r["item"] for r in body["itemScores"]] == want
    finally:
        if deployed is not None:
            deployed.close()
        pod.close()
        jpod.close()
        srv.close()
        bucket.shutdown()
        backing.close()


def test_training_reads_segmentfs_maps_without_writing_them(tmp_path):
    """A one-segment SEGMENTFS sidecar comes back as read-only maps of
    files other hosts share: the data source and the packing read them
    and write nothing into them."""
    import hashlib

    from predictionio_tpu_torch.models.data import ratings_from_columnar

    st = Storage(env={"PIO_STORAGE_SOURCES_SEG_TYPE": "SEGMENTFS",
                      "PIO_STORAGE_SOURCES_SEG_PATH": str(tmp_path / "seg")})
    assert cli.main(["app", "new", APP], storage=st) == 0
    f = write_jsonl(tmp_path / "ev.jsonl", rating_events(seed=2))
    assert cli.main(["import", "--app", APP, "--input", f], storage=st) == 0
    sidecar = tmp_path / "seg" / "events" / "app_1" / "columnar"

    def digest():
        return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
                for p in sorted(sidecar.rglob("*.npy"))}

    before = digest()
    fresh = Storage(env={"PIO_STORAGE_SOURCES_SEG_TYPE": "SEGMENTFS",
                         "PIO_STORAGE_SOURCES_SEG_PATH":
                             str(tmp_path / "seg")})
    batch = fresh.events().find_columnar(1, ordered=False, with_props=False)
    assert not batch.entity_id.flags.writeable
    ratings, _, _ = ratings_from_columnar(batch)
    U, V = als.train_als(ratings, als.ALSParams(rank=RANK, num_iterations=2,
                                                seed=3), device="cpu")
    assert torch.isfinite(U).all() and torch.isfinite(V).all()
    td = prec.RecommendationDataSource(prec.DataSourceParams(
        app_name=APP)).read_training(Context(device="cpu", _storage=fresh))
    np.testing.assert_array_equal(td.ratings.users, ratings.users)
    assert digest() == before
    fresh.close()
    st.close()
