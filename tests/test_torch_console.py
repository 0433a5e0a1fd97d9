"""The port's console commands and its other servers, held to the JAX
package's on one store, on the CPU.

- ``app show|delete|data-delete|channel-new|channel-delete`` and
  ``accesskey delete``: one script of commands run by either package
  leaves the same rows, as both packages read them, and ``app show``,
  ``app list`` and ``accesskey list`` print the same lines.
- ``export`` writes the same JSON lines from both packages (compared as
  parsed JSON, line for line); ``import`` reads them back.
- The admin API returns the same status codes and JSON from both
  packages' servers, with and without the accessKey guard; the dashboard
  the same payloads for one evaluation instance, and its session cookie.
- ``status --device cpu``, ``version``, ``template``, ``run`` and
  ``shell`` (commands on stdin); ``start-all``/``stop-all`` leave no
  process; HTTPS with an ``openssl``-made certificate on the admin
  server and the engine server, reached by ``--https --insecure``;
  ``pypio``'s ``find``, columns and properties against the JAX
  package's.
"""

import io
import json
import os
import socket
import ssl
import subprocess
import time
import urllib.request
from datetime import datetime, timedelta, timezone
from pathlib import Path

import numpy as np
import pytest

from predictionio_tpu import cli as jcli
from predictionio_tpu.data.datamap import DataMap as JDataMap
from predictionio_tpu.data.event import Event as JEvent
from predictionio_tpu.data.storage.base import (
    EvaluationInstance as JEvaluationInstance,
)
from predictionio_tpu.data.storage.base import EventFilter as JEventFilter
from predictionio_tpu.data.storage.registry import Storage as JStorage
from predictionio_tpu.data.store import EventStoreFacade as JFacade
from predictionio_tpu.pypio import PEventStore as JPEventStore
from predictionio_tpu.pypio import events_to_columns as j_events_to_columns
from predictionio_tpu.server import adminserver as jadmin
from predictionio_tpu.server import dashboard as jdash
from predictionio_tpu.server.http import Request as JRequest
from predictionio_tpu_torch import cli
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.base import (
    STATUS_EVALCOMPLETED,
    EvaluationInstance,
    EventFilter,
)
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.obs.trace import parse_traceparent
from predictionio_tpu_torch.data.store import EventStoreFacade
from predictionio_tpu_torch.models.convert import als_model_from_numpy
from predictionio_tpu_torch.pypio import PEventStore, events_to_columns
from predictionio_tpu_torch.server import adminserver, dashboard
from predictionio_tpu_torch.server import engineserver as es
from predictionio_tpu_torch.server.http import (
    AppServer,
    Request,
    ssl_context_from,
)
from predictionio_tpu_torch.templates.recommendation import (
    recommendation_engine,
)

T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
MEM = {"PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"}
JMEM = {"PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"}

PACKAGES = {
    "jax": (JStorage, jcli.main, JEvent, JDataMap, JEventFilter),
    "port": (Storage, cli.main, Event, DataMap, EventFilter),
}


def open_store(pkg, home):
    return PACKAGES[pkg][0](env={"PIO_HOME": str(home)})


def events(pkg, n=6, channel_tag=""):
    """``n`` rate/view events of 3 users, with properties and tags, at
    distinct times."""
    _, _, ev, dm, _ = PACKAGES[pkg]
    out = []
    for k in range(n):
        out.append(ev(
            event="rate" if k % 2 == 0 else "view", entity_type="user",
            entity_id=f"u{k % 3}", target_entity_type="item",
            target_entity_id=f"i{k}{channel_tag}",
            properties=dm({"rating": float(k), "note": f"n{k}"}),
            tags=["t1"] if k % 3 == 0 else [],
            event_time=T0 + timedelta(seconds=k, milliseconds=7)))
    return out


def dump(store, pkg):
    """Every row the console commands touch, as plain values."""
    ef = PACKAGES[pkg][4]
    apps = sorted(store.apps().get_all(), key=lambda a: a.id)
    out = {"apps": [(a.id, a.name, a.description) for a in apps],
           "keys": sorted((k.key, k.app_id, tuple(k.events))
                          for k in store.access_keys().get_all()),
           "channels": [], "events": {}}
    for a in apps:
        chans = store.channels().get_by_app_id(a.id)
        out["channels"] += sorted((c.id, c.name, c.app_id) for c in chans)
        for cid in [None] + [c.id for c in chans]:
            rows = [e.to_json() for e in store.events().find(a.id, cid,
                                                             ef())]
            for r in rows:
                r.pop("eventId", None)
                r.pop("creationTime", None)
            out["events"][f"{a.name}/{cid}"] = rows
    return out


def run_script(pkg, home):
    """The app, channel and key commands, with events inserted between
    them, through ``pkg``'s own CLI on a SQLite ``PIO_HOME``."""
    store = open_store(pkg, home)
    main = PACKAGES[pkg][1]

    def run(*argv):
        assert main(list(argv), storage=store) == 0, argv

    run("app", "new", "shop", "--description", "demo", "--access-key",
        "KEY1")
    run("app", "new", "other", "--access-key", "KEY2")
    run("app", "channel-new", "shop", "mobile")
    run("app", "channel-new", "shop", "web")
    run("accesskey", "new", "shop", "view", "buy", "--key", "KEY3")
    shop = store.apps().get_by_name("shop").id
    chans = {c.name: c.id for c in store.channels().get_by_app_id(shop)}
    store.events().insert_batch(events(pkg), shop)
    store.events().insert_batch(events(pkg, 4, "m"), shop, chans["mobile"])
    store.events().insert_batch(events(pkg, 3, "w"), shop, chans["web"])
    other = store.apps().get_by_name("other").id
    store.events().insert_batch(events(pkg, 2), other)
    run("app", "data-delete", "shop", "--channel", "mobile", "-f")
    store.events().insert_batch(events(pkg, 1, "m2"), shop,
                                chans["mobile"])
    run("app", "channel-delete", "shop", "web", "-f")
    run("accesskey", "delete", "KEY1")
    run("app", "new", "gone", "--access-key", "KEY4")
    run("app", "channel-new", "gone", "c1")
    run("app", "delete", "gone", "-f")
    run("app", "data-delete", "other", "-f")
    store.close()


def test_app_channel_and_key_commands_leave_the_same_rows(tmp_path):
    homes = {pkg: tmp_path / pkg for pkg in PACKAGES}
    for pkg, home in homes.items():
        run_script(pkg, home)
    views = {}
    for writer, home in homes.items():
        for reader in PACKAGES:
            store = open_store(reader, home)
            views[writer, reader] = dump(store, reader)
            store.close()
    first = views["jax", "jax"]
    assert first["apps"] == [(1, "shop", "demo"), (2, "other", None)]
    assert [c[1] for c in first["channels"]] == ["mobile"]
    assert sorted(k[0] for k in first["keys"]) == ["KEY2", "KEY3"]
    assert len(first["events"]["shop/None"]) == 6
    assert len(first["events"]["shop/1"]) == 1
    assert first["events"]["other/None"] == []
    for key, view in views.items():
        assert view == first, key


@pytest.mark.parametrize("argv", [("app", "show", "shop"), ("app", "list"),
                                  ("accesskey", "list"),
                                  ("accesskey", "list", "--app", "shop")],
                         ids=["app-show", "app-list", "key-list",
                              "key-list-app"])
def test_listing_commands_print_the_same_lines(tmp_path, capsys, argv):
    run_script("jax", tmp_path)
    out = {}
    for pkg in PACKAGES:
        store = open_store(pkg, tmp_path)
        capsys.readouterr()
        assert PACKAGES[pkg][1](list(argv), storage=store) == 0
        out[pkg] = capsys.readouterr().out
        store.close()
    assert out["port"] == out["jax"]
    assert "shop" in out["port"] or "KEY3" in out["port"]


def test_missing_app_and_channel_fail_alike(tmp_path, capsys):
    run_script("port", tmp_path)
    for argv in (("app", "show", "nope"), ("app", "delete", "nope", "-f"),
                 ("app", "channel-new", "shop", "bad name!"),
                 ("app", "channel-new", "shop", "mobile"),
                 ("app", "channel-delete", "shop", "nope", "-f"),
                 ("app", "data-delete", "shop", "--channel", "nope", "-f"),
                 ("export", "--app", "nope", "--output", "x")):
        rcs, errs = [], []
        for pkg in PACKAGES:
            store = open_store(pkg, tmp_path)
            rcs.append(PACKAGES[pkg][1](list(argv), storage=store))
            errs.append(capsys.readouterr().err)
            store.close()
        assert rcs == [1, 1] and errs[0] == errs[1], argv


def test_delete_without_force_asks_and_keeps_the_app(tmp_path, monkeypatch):
    store = Storage(env=MEM)
    assert cli.main(["app", "new", "keep"], storage=store) == 0
    monkeypatch.setattr("sys.stdin", io.StringIO("n\n"))
    assert cli.main(["app", "delete", "keep"], storage=store) == 1
    assert store.apps().get_by_name("keep") is not None
    monkeypatch.setattr("sys.stdin", io.StringIO("y\n"))
    assert cli.main(["app", "delete", "keep"], storage=store) == 0
    assert store.apps().get_by_name("keep") is None


@pytest.mark.parametrize("channel", ["", "mobile"])
def test_export_writes_the_same_json_lines(tmp_path, channel):
    run_script("jax", tmp_path)
    lines = {}
    for pkg in PACKAGES:
        store = open_store(pkg, tmp_path)
        out = tmp_path / f"{pkg}.jsonl"
        argv = ["export", "--app", "shop", "--output", str(out)]
        if channel:
            argv += ["--channel", channel]
        assert PACKAGES[pkg][1](argv, storage=store) == 0
        lines[pkg] = [json.loads(ln) for ln in
                      out.read_text().splitlines()]
        store.close()
    assert lines["port"] == lines["jax"]
    assert len(lines["port"]) == (1 if channel else 6)
    # import reads the export back unchanged
    store = open_store("port", tmp_path)
    assert cli.main(["app", "new", "copy"], storage=store) == 0
    assert cli.main(["import", "--app", "copy", "--input",
                     str(tmp_path / "port.jsonl")], storage=store) == 0
    out = tmp_path / "copy.jsonl"
    assert cli.main(["export", "--app", "copy", "--output", str(out)],
                    storage=store) == 0
    assert [json.loads(ln) for ln in out.read_text().splitlines()] \
        == lines["jax"]
    store.close()


# -- the admin API and the dashboard ----------------------------------------------

def handle(app, req_cls, method, path, body=None, query=None, headers=None):
    resp = app.handle(req_cls(method=method, path=path, query=query or {},
                              headers=headers or {},
                              body=json.dumps(body).encode() if body
                              else b""))
    raw = resp.encoded()
    return resp.status, (json.loads(raw) if raw else None)


ADMIN_SCRIPT = [("GET", "/", None), ("GET", "/cmd/app", None),
                ("POST", "/cmd/app", {"name": "adminapp",
                                      "description": "d"}),
                ("POST", "/cmd/app", {"name": "adminapp"}),
                ("POST", "/cmd/app", {}),
                ("GET", "/cmd/app", None),
                ("DELETE", "/cmd/app/adminapp/data", None),
                ("DELETE", "/cmd/app/ghost/data", None),
                ("DELETE", "/cmd/app/adminapp", None),
                ("DELETE", "/cmd/app/ghost", None),
                ("GET", "/cmd/app", None),
                ("PUT", "/cmd/app", None), ("GET", "/nope", None)]


def _mask_keys(body):
    if isinstance(body, dict):
        return {k: (bool(v) if k in ("key", "accessKey") else _mask_keys(v))
                for k, v in body.items()}
    if isinstance(body, list):
        return [_mask_keys(v) for v in body]
    return body


@pytest.mark.parametrize("accesskey,query", [(None, {}),
                                             ("SECRET", {}),
                                             ("SECRET",
                                              {"accessKey": "SECRET"})],
                         ids=["open", "guarded-no-key", "guarded-key"])
def test_admin_routes_answer_like_jax(accesskey, query):
    jst, pst = JStorage(env=JMEM), Storage(env=MEM)
    japp = jadmin.build_app(jst, accesskey=accesskey)
    papp = adminserver.build_app(pst, accesskey=accesskey)
    for method, path, body in ADMIN_SCRIPT:
        want = handle(japp, JRequest, method, path, body, query)
        got = handle(papp, Request, method, path, body, query)
        assert (got[0], _mask_keys(got[1])) \
            == (want[0], _mask_keys(want[1])), (method, path)
    assert [a.name for a in pst.apps().get_all()] \
        == [a.name for a in jst.apps().get_all()]


def test_dashboard_routes_answer_like_jax(tmp_path):
    jst = JStorage(env={"PIO_HOME": str(tmp_path)})
    iid = jst.evaluation_instances().insert(JEvaluationInstance(
        id="", status=STATUS_EVALCOMPLETED, start_time=T0, end_time=T0,
        evaluation_class="my.Eval",
        evaluator_results="[Precision@10] best variant 1: 0.500000",
        evaluator_results_html="<html>ok</html>",
        evaluator_results_json='{"metric": 0.5}'))
    pst = Storage(env={"PIO_HOME": str(tmp_path)})
    apps = {"jax": (jdash.build_app(jst), JRequest),
            "port": (dashboard.build_app(pst), Request)}

    def get(pkg, path):
        app, req = apps[pkg]
        return app.handle(req(method="GET", path=path, query={},
                              headers={}, body=b""))

    for suffix in ("evaluator_results.txt", "evaluator_results.html",
                   "evaluator_results.json",
                   "local_evaluator_results.json"):
        path = f"/engine_instances/{iid}/{suffix}"
        want, got = get("jax", path), get("port", path)
        assert (got.status, got.encoded(), got.content_type) \
            == (want.status, want.encoded(), want.content_type), suffix
        # the request id and the trace context are per request: the same
        # keys, a well-formed traceparent, every other header equal
        assert got.headers.keys() == want.headers.keys()
        assert parse_traceparent(got.headers["traceparent"]) is not None
        assert {k: v for k, v in got.headers.items()
                if k not in ("X-Request-ID", "traceparent")} \
            == {k: v for k, v in want.headers.items()
                if k not in ("X-Request-ID", "traceparent")}
    assert get("port", "/engine_instances/nope/evaluator_results.txt") \
        .status == get("jax", "/engine_instances/nope/"
                              "evaluator_results.txt").status == 404

    def table(page: bytes) -> str:
        text = page.decode()
        return text[text.index("<table"):text.index("</table>")]

    want, got = get("jax", "/"), get("port", "/")
    assert got.status == want.status == 200
    assert table(got.encoded()) == table(want.encoded())
    assert "my.Eval" in table(got.encoded())
    pst.close()
    jst.close()


def test_dashboard_guard_and_session_cookie_like_jax():
    stores = {"jax": JStorage(env=JMEM), "port": Storage(env=MEM)}
    for pkg, st in stores.items():
        inst_cls = JEvaluationInstance if pkg == "jax" \
            else EvaluationInstance
        st.evaluation_instances().insert(inst_cls(
            id="", status=STATUS_EVALCOMPLETED, start_time=T0, end_time=T0,
            evaluator_results="r"))
    apps = {"jax": (jdash.build_app(stores["jax"], accesskey="SECRET"),
                    JRequest),
            "port": (dashboard.build_app(stores["port"], accesskey="SECRET"),
                     Request)}
    seen = {}
    for pkg, (app, req) in apps.items():
        r0 = app.handle(req(method="GET", path="/", query={}, headers={},
                            body=b""))
        r1 = app.handle(req(method="GET", path="/",
                            query={"accessKey": "SECRET"}, headers={},
                            body=b""))
        cookie = r1.headers.get("Set-Cookie", "")
        r2 = app.handle(req(method="GET", path="/", query={},
                            headers={"Cookie": cookie.split(";")[0]},
                            body=b""))
        r3 = app.handle(req(method="GET", path="/", query={},
                            headers={"Cookie":
                                     "pio_dashboard_session=forged"},
                            body=b""))
        r4 = app.handle(req(method="GET", path="/", query={},
                            headers={"Authorization": "Bearer SECRET"},
                            body=b""))
        seen[pkg] = (r0.status, r1.status, "accessKey" in
                     r1.encoded().decode(), cookie.split("=")[0],
                     cookie.split(";", 1)[1], r2.status, r3.status,
                     r4.status)
    assert seen["port"] == seen["jax"] == (
        401, 200, False, "pio_dashboard_session",
        " HttpOnly; SameSite=Strict; Path=/", 200, 401, 200)


# -- status, version, template, run, shell ------------------------------------------

def test_status_on_the_cpu(tmp_path, capsys):
    store = open_store("port", tmp_path)
    assert cli.main(["app", "new", "stapp"], storage=store) == 0
    capsys.readouterr()
    assert cli.main(["status", "--device", "cpu"], storage=store) == 0
    out = capsys.readouterr().out
    assert "card: cpu" in out and "Kernel root:" in out
    assert "Storage: all data objects verified." in out
    assert out.rstrip().endswith("Your system is all ready to go.")
    store.close()


def test_status_without_cuda_fails_with_the_device_message(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the status reads it")
    assert cli.main(["status"], storage=Storage(env=MEM)) == 1
    assert "CUDA is not available" in capsys.readouterr().err


def test_version_and_template(capsys):
    assert jcli.main(["version"], storage=JStorage(env=JMEM)) == 0
    want = capsys.readouterr().out
    assert cli.main(["version"]) == 0
    assert capsys.readouterr().out == want
    assert cli.main(["template"], storage=Storage(env=MEM)) == 0
    out = capsys.readouterr().out
    assert "predictionio_tpu_torch.templates" in out
    for name in ("recommendation", "classification", "similarproduct",
                 "ecommerce", "sequential"):
        assert name in out


def _run_target(marker):
    return f"ran:{marker}"


def _apps_of_the_process_storage():
    from predictionio_tpu_torch.data.storage.registry import get_storage

    return sorted(a.name for a in get_storage().apps().get_all())


def test_run_calls_the_target_like_jax(capsys):
    target = "tests.test_torch_console:_run_target"
    assert jcli.main(["run", target, "xyz"],
                     storage=JStorage(env=JMEM)) == 0
    want = capsys.readouterr().out
    store = Storage(env=MEM)
    assert cli.main(["run", target, "xyz"], storage=store) == 0
    assert capsys.readouterr().out == want == "ran:xyz\n"
    cli.main(["app", "new", "runapp"], storage=store)
    capsys.readouterr()
    assert cli.main(["run", "tests.test_torch_console:"
                            "_apps_of_the_process_storage"],
                    storage=store) == 0
    assert capsys.readouterr().out == "['runapp']\n"


def test_shell_runs_the_commands_on_stdin(tmp_path, monkeypatch, capsys):
    run_script("jax", tmp_path)
    store = open_store("port", tmp_path)
    monkeypatch.setattr("sys.stdin", io.StringIO(
        "print(sorted(a.name for a in storage.apps().get_all()))\n"
        "print(len(p_event_store.find('shop')))\n"
        "print(len(list(event_store.find('shop', channel_name='mobile'))))"
        "\n"))
    assert cli.main(["shell"], storage=store) == 0
    out = capsys.readouterr().out
    assert "['other', 'shop']" in out and "6\n" in out and "1\n" in out
    store.close()


# -- start-all / stop-all ------------------------------------------------------------

def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def pid_alive(pid):
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False


def test_start_all_stop_all_round_trip(tmp_path, monkeypatch, capsys):
    root = Path(__file__).resolve().parents[1]
    monkeypatch.setenv("PIO_HOME", str(tmp_path / "home"))
    monkeypatch.setenv("PYTHONPATH", str(root))
    ports = {"eventserver": free_port(), "adminserver": free_port(),
             "dashboard": free_port()}
    pid_dir = tmp_path / "pids"
    argv = ["start-all", "--ip", "127.0.0.1", "--pid-dir", str(pid_dir),
            "--eventserver-port", str(ports["eventserver"]),
            "--adminserver-port", str(ports["adminserver"]),
            "--dashboard-port", str(ports["dashboard"]),
            "--start-timeout", "90"]
    store = Storage(env=MEM)
    pids = {}
    try:
        rc = cli.main(argv, storage=store)
        assert rc == 0, capsys.readouterr()
        pids = {n: int((pid_dir / f"{n}.pid").read_text())
                for n in ports}
        opener = urllib.request.build_opener(
            urllib.request.ProxyHandler({}))
        with opener.open(f"http://127.0.0.1:{ports['adminserver']}/",
                         timeout=10) as r:
            assert json.loads(r.read()) == {"status": "alive"}
        with opener.open(f"http://127.0.0.1:{ports['dashboard']}/",
                         timeout=10) as r:
            assert b"Evaluation history" in r.read()
        # a second start refuses, and leaves the pidfiles as they are
        assert cli.main(argv, storage=store) == 1
        assert {n: int((pid_dir / f"{n}.pid").read_text())
                for n in ports} == pids
    finally:
        assert cli.main(["stop-all", "--pid-dir", str(pid_dir)],
                        storage=store) == 0
    for n, pid in pids.items():
        assert not (pid_dir / f"{n}.pid").exists()
        assert not pid_alive(pid), f"{n} pid {pid} survived stop-all"
    assert pids and "stopped (pid" in capsys.readouterr().out


# -- TLS --------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cert(tmp_path_factory):
    d = tmp_path_factory.mktemp("tls")
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048",
                    "-keyout", str(d / "key.pem"), "-out",
                    str(d / "cert.pem"), "-days", "1", "-nodes", "-subj",
                    "/CN=localhost"], check=True, capture_output=True)
    return str(d / "cert.pem"), str(d / "key.pem")


def _insecure():
    ctx = ssl.create_default_context()
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    return ctx


def test_https_admin_server(cert):
    srv = adminserver.create_admin_server(
        Storage(env=MEM), host="127.0.0.1", port=0,
        ssl_context=ssl_context_from(*cert)).start_background()
    try:
        assert srv.scheme == "https"
        with urllib.request.urlopen(f"https://127.0.0.1:{srv.port}/",
                                    context=_insecure(), timeout=5) as r:
            assert json.loads(r.read()) == {"status": "alive"}
    finally:
        srv.close()


def test_ssl_context_from_like_jax(cert, monkeypatch):
    from predictionio_tpu.server.http import ssl_context_from as jssl

    monkeypatch.delenv("PIO_SSL_CERT", raising=False)
    monkeypatch.delenv("PIO_SSL_KEY", raising=False)
    assert ssl_context_from() is None and jssl() is None
    for fn in (ssl_context_from, jssl):
        with pytest.raises(ValueError, match="without a certificate"):
            fn(None, cert[1])
    monkeypatch.setenv("PIO_SSL_CERT", cert[0])
    monkeypatch.setenv("PIO_SSL_KEY", cert[1])
    assert isinstance(ssl_context_from(), ssl.SSLContext)


def test_https_engine_server_status_and_undeploy(cert, capsys):
    rng = np.random.default_rng(0)
    model = als_model_from_numpy(
        rng.standard_normal((5, 4)).astype(np.float32),
        rng.standard_normal((9, 4)).astype(np.float32), 5, 9,
        {f"u{i}": i for i in range(5)}, {f"i{i}": i for i in range(9)},
        {"rank": 4}, device="cpu")
    engine = recommendation_engine()
    srv = es.deploy_models(
        engine, engine.params_from_variant(
            {"algorithms": [{"name": "als", "params": {"rank": 4}}]}),
        [model], es.ServerConfig(device="cpu"), "127.0.0.1", 0,
        ssl_context=ssl_context_from(*cert)).start_background()
    try:
        req = urllib.request.Request(
            f"https://127.0.0.1:{srv.port}/queries.json",
            data=json.dumps({"user": "u1", "num": 3}).encode(),
            method="POST")
        with urllib.request.urlopen(req, context=_insecure(),
                                    timeout=10) as r:
            assert len(json.loads(r.read())["itemScores"]) == 3
        store = Storage(env=MEM)
        flags = ["--ip", "127.0.0.1", "--port", str(srv.port), "--https",
                 "--insecure"]
        assert cli.main(["status", "--device", "cpu"] + flags,
                        storage=store) == 0
        assert "Serving [None]: base bind-1" in capsys.readouterr().out
        assert cli.main(["undeploy"] + flags, storage=store) == 0
        assert "Undeployed engine server" in capsys.readouterr().out
        deadline = time.monotonic() + 10
        while srv._thread.is_alive() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not srv._thread.is_alive()
    finally:
        srv.close()


def test_cli_builds_each_server_with_tls(cert):
    store = Storage(env=MEM)
    p = cli._parser()
    for name in ("eventserver", "adminserver", "dashboard"):
        args = p.parse_args([name, "--ip", "127.0.0.1", "--port", "0",
                             "--cert", cert[0], "--key", cert[1]])
        srv = cli.SERVERS[name][0](args, store)
        try:
            assert isinstance(srv, AppServer) and srv.scheme == "https"
        finally:
            srv.close()


# -- pypio ----------------------------------------------------------------------------

def test_pypio_find_columns_and_properties_like_jax(tmp_path):
    run_script("jax", tmp_path)
    jst, pst = open_store("jax", tmp_path), open_store("port", tmp_path)
    shop = pst.apps().get_by_name("shop").id
    pst.events().insert_batch([
        Event(event="$set", entity_type="user", entity_id="u1",
              properties=DataMap({"a": 1, "b": 2}), event_time=T0),
        Event(event="$unset", entity_type="user", entity_id="u1",
              properties=DataMap({"b": None}),
              event_time=T0 + timedelta(hours=1))], shop)
    jp, pp = JPEventStore(JFacade(jst)), PEventStore(EventStoreFacade(pst))
    for kw in ({}, {"event_names": ["view"]}, {"entity_id": "u1"},
               {"channel_name": "mobile"}):
        want, got = jp.find("shop", **kw), pp.find("shop", **kw)
        assert [e.to_json() for e in got] == [e.to_json() for e in want]
        jc, pc = j_events_to_columns(want), events_to_columns(got)
        assert jc.keys() == pc.keys()
        for k in jc:
            assert pc[k].dtype == jc[k].dtype
            assert pc[k].tolist() == jc[k].tolist(), k
    want = jp.aggregate_properties("shop", "user")
    got = pp.aggregate_properties("shop", "user")
    assert {k: v.to_dict() for k, v in got.items()} \
        == {k: v.to_dict() for k, v in want.items()} == {"u1": {"a": 1}}
    jst.close()
    pst.close()
