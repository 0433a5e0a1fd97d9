"""The pod topology end to end, as ``tests/test_pod_topology.py`` runs it
for the JAX package: one storage server and 4 ``cli train`` processes of
the port (``PIO_COORDINATOR`` / ``PIO_NUM_PROCESSES``, gloo on the CPU,
2 CPU shards a process through ``PTPU_TORCH_FORCE_DEVICE_COUNT``), the
REMOTE backend with shard pushdown. At once:

- every rank exits 0, and the factors match a single-process ``cli
  train`` against the same storage (the JAX test's rtol 2e-3, atol 2e-4);
- each rank pulled at most 0.4 of the columnar bytes the single run
  pulled (the pushdown engaged over the wire);
- the engine instance went INIT -> COMPLETED once, with one model blob
  (process 0 the single writer).
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import App
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.server.storageserver import (
    create_storage_server,
)
from predictionio_tpu_torch.workflow import persistence

ROOT = Path(__file__).resolve().parents[1]

WORKER = textwrap.dedent("""
    import json, os, sys

    pid, outdir, engine_json = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    # count the bulk-read bytes this rank pulls off the wire
    from predictionio_tpu_torch.data.storage import remote
    real = remote.RemoteClient.request
    stats = {"columnar_bytes": 0}
    def wrapped(self, method, path, body=None, **kw):
        st, hd, bd = real(self, method, path, body, **kw)
        if "/columnar" in path:
            stats["columnar_bytes"] += len(bd or b"")
        return st, hd, bd
    remote.RemoteClient.request = wrapped

    from predictionio_tpu_torch.cli import main
    rc = main(["train", "--engine-json", engine_json, "--device", "cpu"])
    json.dump({"rc": rc, "pid": pid, **stats},
              open(os.path.join(outdir, f"worker{pid}.json"), "w"))
    sys.exit(rc)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _remote_env(port: int) -> dict:
    return {
        "PIO_STORAGE_SOURCES_NET_TYPE": "remote",
        "PIO_STORAGE_SOURCES_NET_URL": f"http://127.0.0.1:{port}",
        "PIO_STORAGE_SOURCES_NET_SECRET": "podsecret",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "NET",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "NET",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "NET",
    }


def _run(procs, timeout=120):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def test_four_process_cli_train_over_storage_server(tmp_path):
    backing = Storage(env={"PIO_HOME": str(tmp_path / "home")})
    srv = create_storage_server(backing, host="127.0.0.1", port=0,
                                secret="podsecret").start_background()
    s = None
    try:
        env_remote = _remote_env(srv.port)
        s = Storage(env=env_remote)
        app_id = s.apps().insert(App(0, "PodApp"))
        s.events().init(app_id)
        rng = np.random.default_rng(11)
        n = 1500
        s.events().insert_batch(
            [Event(event="rate", entity_type="user",
                   entity_id=f"u{int(u)}", target_entity_type="item",
                   target_entity_id=f"i{int(i)}",
                   properties=DataMap({"rating": float(r)}))
             for u, i, r in zip(rng.integers(0, 60, n),
                                rng.integers(0, 30, n),
                                rng.integers(1, 6, n))], app_id)

        engine_json = tmp_path / "engine.json"
        engine_json.write_text(json.dumps({
            "id": "podrec", "version": "1",
            "engineFactory": "predictionio_tpu.templates."
                             "recommendation:recommendation_engine",
            "datasource": {"params": {"app_name": "PodApp"}},
            "algorithms": [{"name": "als", "params": {
                "rank": 8, "num_iterations": 2, "reg": 0.05,
                "seed": 5}}],
        }))
        worker = tmp_path / "worker.py"
        worker.write_text(WORKER)

        base_env = {k: v for k, v in os.environ.items()
                    if not k.startswith(("PIO_", "PTPU_"))}
        base_env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT)] + base_env.get("PYTHONPATH", "").split(os.pathsep))
        base_env.update(env_remote)
        coord = _free_port()
        procs = []
        for pid in range(4):
            env = dict(base_env, PIO_COORDINATOR=f"127.0.0.1:{coord}",
                       PIO_NUM_PROCESSES="4", PIO_PROCESS_ID=str(pid),
                       PTPU_TORCH_FORCE_DEVICE_COUNT="2")
            procs.append(subprocess.Popen(
                [sys.executable, str(worker), str(pid), str(tmp_path),
                 str(engine_json)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        for p, out in zip(procs, _run(procs)):
            assert p.returncode == 0, f"rank failed:\n{out[-4000:]}"

        # metadata: INIT -> COMPLETED exactly once, one model blob
        instances = list(s.engine_instances().get_all())
        assert len(instances) == 1, [(i.id, i.status) for i in instances]
        inst = instances[0]
        assert inst.status == "COMPLETED"
        blob = s.models().get(inst.id)
        assert blob is not None
        model_multi = persistence.loads_models(blob.models)[0]

        # the single-process reference through the same CLI
        (p1,) = procs1 = [subprocess.Popen(
            [sys.executable, str(worker), "9", str(tmp_path),
             str(engine_json)], env=base_env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)]
        (out1,) = _run(procs1)
        assert p1.returncode == 0, out1[-4000:]
        instances2 = list(s.engine_instances().get_all())
        assert len(instances2) == 2
        single_id = next(i.id for i in instances2 if i.id != inst.id)
        model_single = persistence.loads_models(
            s.models().get(single_id).models)[0]

        for side, attr in (("user_ids", "user_factors"),
                           ("item_ids", "item_factors")):
            ids_m = getattr(model_multi, side).to_dict()
            ids_s = getattr(model_single, side).to_dict()
            assert set(ids_m) == set(ids_s)
            fm = getattr(model_multi, attr).numpy()
            fs = getattr(model_single, attr).numpy()
            keys = sorted(ids_m)
            np.testing.assert_allclose(fm[[ids_m[k] for k in keys]],
                                       fs[[ids_s[k] for k in keys]],
                                       rtol=2e-3, atol=2e-4)

        single_bytes = json.loads(
            (tmp_path / "worker9.json").read_text())["columnar_bytes"]
        for pid in range(4):
            wb = json.loads((tmp_path / f"worker{pid}.json")
                            .read_text())["columnar_bytes"]
            assert 0 < wb <= 0.4 * single_bytes, (pid, wb, single_bytes)
    finally:
        if s is not None:
            s.close()
        srv.close()
        backing.close()
