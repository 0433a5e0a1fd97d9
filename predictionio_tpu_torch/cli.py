"""Command line of the port (the lifecycle commands of
``predictionio_tpu.cli``)::

    python -m predictionio_tpu_torch.cli app new MyApp1
    python -m predictionio_tpu_torch.cli accesskey new MyApp1 [EVENT ...]
    python -m predictionio_tpu_torch.cli eventserver --port 7070
    python -m predictionio_tpu_torch.cli import --app MyApp1 --input ev.jsonl
    python -m predictionio_tpu_torch.cli train --engine-json engine.json
    python -m predictionio_tpu_torch.cli deploy --engine-json engine.json \\
        --port 8000 [--serving-quant int8] [--batching] [--model FILE] \\
        [--pipeline staged|serial] [--queue-deadline-ms 30000] \\
        [--stream --stream-app MyApp1]
    python -m predictionio_tpu_torch.cli batchpredict \\
        --engine-json engine.json --input q.jsonl --output out.jsonl
    python -m predictionio_tpu_torch.cli eval module:evaluation \\
        [module:params_generator] [--parallelism N]
    python -m predictionio_tpu_torch.cli stream status|start|stop \\
        [--port 8000] [--app MyApp1]
    python -m predictionio_tpu_torch.cli undeploy [--port 8000]
    python -m predictionio_tpu_torch.cli release list
    python -m predictionio_tpu_torch.cli release show|pin|status|canary|\\
        promote|rollback --engine-id ID --engine-json engine.json ...

Storage is the JAX package's: ``PIO_STORAGE_*`` variables, else one
SQLite file at ``$PIO_HOME/pio.db``. ``train``, ``deploy``,
``batchpredict`` and ``eval`` run on the CUDA card unless ``--device
cpu`` is given; without CUDA they raise. ``deploy`` binds the pinned
release of the variant's engine, else its latest COMPLETED instance, or,
with ``--model``, a file written by
``workflow/persistence.py::dumps_models``; it serves until ``POST /stop``
(``undeploy``, which records the undeploy in the release history).
With ``--batching`` concurrent queries coalesce through the staged
pipeline (``--pipeline serial``: the drainer threads), each shed with a
503 past ``--queue-deadline-ms``. ``batchpredict`` writes one
``{"query", "prediction"}`` line for each query line of ``--input``,
from the latest COMPLETED instance. ``eval`` walks the generator's params
grid (or the evaluation's own ``engine_params_list``), prints the
winner's one-liner and records an EVALCOMPLETED evaluation instance.
With ``--stream`` a stream trainer folds the app's new events into the
served model (not with ``--model``: it needs the storage the instance
came from). ``stream`` drives a running engine server's trainer over
HTTP. ``release`` lists, shows and pins releases in the storage (the JAX
package's release blobs: a pin either package writes binds in both) and
drives a running engine server's canary, promote and rollback (``status``
falls back to the storage when the server is unreachable); as in the JAX
package its engine triple is ``--engine-id`` (default "default"),
``--engine-version`` (default "1") and the ``--engine-json`` path.

An ``engineFactory``, evaluation or params generator under
``predictionio_tpu.`` is read as the same path under
``predictionio_tpu_torch.``, so the JAX package's shipped variants train
and deploy on the port unchanged; the JAX package is never imported.
Left out (``ROADMAP.md`` queue 1): build, status, export, channels and
app deletion, TLS and fleets.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import urllib.error
import urllib.request
from typing import List, Optional

from .controller.context import Context
from .controller.params import load_variant
from .data.storage.base import AccessKey, App, JsonlImportError
from .data.storage.registry import Storage, get_storage
from .server.engineserver import ServerConfig, deploy, deploy_models
from .server.http import AppServer

JAX_PACKAGE = "predictionio_tpu"
#: the engine of a variant that names no ``engineFactory``: the
#: recommendation template's, as in the JAX package (the e-commerce and
#: similar-product variants name theirs)
DEFAULT_FACTORY = ("predictionio_tpu_torch.templates.recommendation:"
                   "recommendation_engine")


def _out(msg: str) -> None:
    print(msg, flush=True)


def _err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def port_module_name(mod_name: str) -> str:
    """A module path of the JAX package read as the port's own."""
    if mod_name == JAX_PACKAGE or mod_name.startswith(JAX_PACKAGE + "."):
        return "predictionio_tpu_torch" + mod_name[len(JAX_PACKAGE):]
    return mod_name


def load_engine_factory(spec: str):
    """Resolve ``module.path:callable``, a JAX-package path read as the
    port's."""
    if ":" not in spec:
        raise SystemExit(f"engineFactory must look like "
                         f"'package.module:factory', got {spec!r}")
    mod_name, attr = spec.split(":", 1)
    mod_name = port_module_name(mod_name)
    try:
        mod = importlib.import_module(mod_name)
    except ImportError as e:
        raise SystemExit(f"Cannot import engine factory module "
                         f"{mod_name!r}: {e}")
    try:
        return getattr(mod, attr)
    except AttributeError:
        raise SystemExit(f"Module {mod_name!r} has no attribute {attr!r}")


def engine_from_variant(variant: dict):
    factory = load_engine_factory(variant.get("engineFactory")
                                  or DEFAULT_FACTORY)
    engine = factory() if callable(factory) else factory
    return engine, engine.params_from_variant(variant)


def _engine_key(args, variant: dict) -> dict:
    return dict(engine_id=args.engine_id or variant.get("id", "default"),
                engine_version=(args.engine_version
                                or variant.get("version", "1")),
                engine_variant=args.engine_json)


# -- commands ---------------------------------------------------------------

def cmd_app(args, storage: Storage) -> int:
    apps, keys = storage.apps(), storage.access_keys()
    if args.app_command == "new":
        if apps.get_by_name(args.name) is not None:
            _err(f"App {args.name} already exists. Aborting.")
            return 1
        app_id = apps.insert(App(id=args.id or 0, name=args.name,
                                 description=args.description))
        if app_id is None:
            _err(f"Unable to create app {args.name} (ID conflict?). "
                 f"Aborting.")
            return 1
        storage.events().init(app_id)
        key = keys.insert(AccessKey(key=args.access_key or "",
                                    app_id=app_id, events=()))
        if key is None:
            _err("Unable to create access key (duplicate?). Aborting.")
            return 1
        _out(f"Initialized Event Store for this app ID: {app_id}.")
        _out("Created new app:")
        _out(f"      Name: {args.name}")
        _out(f"        ID: {app_id}")
        _out(f"Access Key: {key}")
        return 0
    _out(f"{'Name':20} |   ID | Access Key")
    for a in sorted(apps.get_all(), key=lambda a: a.name):
        for k in keys.get_by_app_id(a.id) or [None]:
            allowed = ",".join(k.events) if k and k.events else "(all)"
            _out(f"{a.name:20} | {a.id:4} | {k.key if k else ''} | "
                 f"{allowed}")
    _out(f"Finished listing {len(apps.get_all())} app(s).")
    return 0


def cmd_accesskey(args, storage: Storage) -> int:
    keys, apps = storage.access_keys(), storage.apps()
    if args.ak_command == "new":
        a = apps.get_by_name(args.app)
        if a is None:
            _err(f"App {args.app} does not exist. Aborting.")
            return 1
        key = keys.insert(AccessKey(key=args.key or "", app_id=a.id,
                                    events=tuple(args.events or ())))
        if key is None:
            _err("Unable to create access key (duplicate?). Aborting.")
            return 1
        _out(f"Created new access key: {key}")
        return 0
    rows = keys.get_all()
    if args.app:
        a = apps.get_by_name(args.app)
        if a is None:
            _err(f"App {args.app} does not exist. Aborting.")
            return 1
        rows = keys.get_by_app_id(a.id)
    for k in rows:
        allowed = ",".join(k.events) if k.events else "(all)"
        _out(f"{k.key} | app {k.app_id} | {allowed}")
    _out(f"Finished listing {len(rows)} access key(s).")
    return 0


def build_eventserver(args, storage: Storage) -> AppServer:
    """The event server the eventserver command would serve, not yet
    serving."""
    from .server.eventserver import create_event_server

    return create_event_server(storage, args.ip, args.port)


def cmd_import(args, storage: Storage) -> int:
    """JSON lines -> event store, committed in all-or-nothing chunks;
    then the columnar sidecar is built, so the first train does not pay
    it."""
    a = (storage.apps().get_by_name(args.app) if args.app
         else storage.apps().get(args.appid))
    if a is None:
        _err("App does not exist. Aborting.")
        return 1
    try:
        total = storage.events().import_jsonl(args.input, a.id)
    except JsonlImportError as err:
        _err(f"Import failed near line {err.lineno}: {err.cause}")
        _err(f"{err.committed_events} event(s) (input lines "
             f"1-{err.committed_lines}) are already committed; importing "
             f"the whole file again would duplicate them.")
        return 1
    _out(f"Imported {total} event(s).")
    if storage.events().warm_columnar(a.id):
        _out("Columnar sidecar ready.")
    return 0


def cmd_train(args, storage: Storage) -> int:
    from .workflow.core import run_train

    variant = load_variant(args.engine_json)
    engine, engine_params = engine_from_variant(variant)
    ctx = Context(device=args.device, _storage=storage,
                  skip_sanity_check=args.skip_sanity_check,
                  stop_after_read=args.stop_after_read,
                  stop_after_prepare=args.stop_after_prepare)
    instance_id = run_train(ctx, engine, engine_params,
                            engine_factory=variant.get("engineFactory", ""),
                            **_engine_key(args, variant))
    if args.stop_after_read or args.stop_after_prepare:
        stage = "read" if args.stop_after_read else "prepare"
        _out(f"Workflow stopped after {stage} (instance {instance_id} "
             f"left in INIT).")
        return 0
    _out(f"Train stages: {json.dumps(ctx.stage_timings)}")
    _out(f"Training completed. Engine instance ID: {instance_id}")
    return 0


def build_deploy(args, storage: Optional[Storage] = None) -> AppServer:
    """The engine server the deploy command would serve, not yet
    serving: the latest COMPLETED instance from storage, or the
    ``--model`` file."""
    variant = load_variant(args.engine_json)
    engine, engine_params = engine_from_variant(variant)
    config = ServerConfig(batching=args.batching,
                          batch_pipeline=args.batch_pipeline,
                          serving_pipeline=args.pipeline,
                          queue_deadline_ms=args.queue_deadline_ms,
                          assemble_workers=args.assemble_workers,
                          readback_workers=args.readback_workers,
                          pipeline_depth=args.pipeline_depth,
                          serving_quant=args.serving_quant,
                          device=args.device,
                          streaming=args.stream,
                          stream_app_name=args.stream_app or None,
                          stream_interval_ms=args.stream_interval_ms,
                          stream_max_events=args.stream_max_events,
                          stream_consumer=args.stream_consumer,
                          stream_drift_threshold=args.stream_drift_threshold,
                          stream_canary_probes=args.stream_canary_probes)
    if args.model:
        from .workflow.persistence import loads_models

        with open(args.model, "rb") as f:
            models = loads_models(f.read())
        return deploy_models(engine, engine_params, models, config,
                             args.ip, args.port)
    ctx = Context(device=args.device,
                  _storage=storage if storage is not None else get_storage())
    return deploy(ctx, engine, engine_params, config=config, host=args.ip,
                  port=args.port, **_engine_key(args, variant))


def cmd_batchpredict(args, storage: Storage) -> int:
    """Predict every query line of ``--input`` with the latest COMPLETED
    instance, on the card unless ``--device cpu``."""
    from .workflow.batch_predict import run_batch_predict

    variant = load_variant(args.engine_json)
    engine, engine_params = engine_from_variant(variant)
    ctx = Context(device=args.device, _storage=storage)
    n = run_batch_predict(ctx, engine, engine_params,
                          input_path=args.input, output_path=args.output,
                          **_engine_key(args, variant))
    _out(f"Wrote {n} prediction(s) to {args.output}.")
    return 0


def cmd_eval(args, storage: Storage) -> int:
    """Evaluate a params grid on the card unless ``--device cpu``; print
    the winner's one-liner."""
    from .workflow.core import run_evaluation

    evaluation = load_engine_factory(args.evaluation)
    if callable(evaluation) and not hasattr(evaluation, "engine"):
        evaluation = evaluation()
    params_list = None
    if args.engine_params_generator:
        gen = load_engine_factory(args.engine_params_generator)
        if callable(gen) and not hasattr(gen, "engine_params_list"):
            gen = gen()
        params_list = list(gen.engine_params_list)
    elif getattr(evaluation, "engine_params_list", None):
        params_list = list(evaluation.engine_params_list)
    if not params_list:
        _err("No engine params to evaluate; provide an engine params "
             "generator.")
        return 1
    ctx = Context(device=args.device, _storage=storage)
    result = run_evaluation(
        ctx, evaluation, params_list,
        evaluation_class=args.evaluation,
        params_generator_class=args.engine_params_generator or "",
        parallelism=max(1, args.parallelism))
    _out(result.to_one_liner())
    return 0


def _server_call(args, path: str, method: str = "GET",
                 body: Optional[dict] = None):
    """One JSON call to the engine server at ``args.ip``:``args.port``."""
    data = json.dumps(body).encode() if body is not None else (
        b"" if method == "POST" else None)
    req = urllib.request.Request(f"http://{args.ip}:{args.port}{path}",
                                 data=data, method=method)
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    with opener.open(req, timeout=30) as resp:
        return json.loads(resp.read() or b"null")


def _call_error(e: Exception) -> str:
    if isinstance(e, urllib.error.HTTPError):
        try:
            return f"{e.code}: {json.loads(e.read()).get('message', '')}"
        except ValueError:
            return str(e.code)
    return str(e)


def cmd_stream(args) -> int:
    """Attach, stop or inspect a running engine server's stream
    trainer."""
    sub = args.stream_command
    try:
        if sub == "status":
            payload = _server_call(args, "/stream.json")
        elif sub == "start":
            body = {k: v for k, v in (
                ("appName", args.app), ("channelName", args.channel),
                ("consumer", args.consumer),
                ("intervalMs", args.interval_ms),
                ("maxEvents", args.max_events),
                ("driftThreshold", args.drift_threshold),
                ("canaryProbes", args.canary_probes))
                if v not in (None, "")}
            payload = _server_call(args, "/stream/start", "POST", body)
        else:
            payload = _server_call(args, "/stream/stop", "POST")
    except (urllib.error.URLError, OSError) as e:
        _err(f"stream {sub} failed: {_call_error(e)}")
        return 1
    if sub == "status":
        _out(json.dumps(payload, indent=2))
        lin = payload.get("lineage") or {}
        _out(f"serving: base {lin.get('baseInstanceId', '?')} "
             f"+{lin.get('incrementalGeneration', 0)} fold-ins "
             f"({lin.get('incrementalRows', 0)} rows), staleness "
             f"{lin.get('stalenessSec', '?')}s")
        if not payload.get("running"):
            _out("Streaming trainer is OFF (stream start --app <app>, or "
                 "deploy with --stream).")
    elif sub == "start":
        st = payload.get("stream") or {}
        _out(f"Streaming trainer started (app {st.get('appName', '?')}, "
             f"consumer {st.get('consumer', '?')}, interval "
             f"{st.get('intervalMs', '?')}ms).")
    else:
        _out(payload.get("message", "Stopped."))
        _out("The durable cursor keeps its position; a later start with "
             "the same consumer resumes there.")
    return 0


def cmd_undeploy(args, storage: Storage) -> int:
    """Stop the engine server at ``args.ip``:``args.port``, recording the
    undeploy in the history of the release it was serving."""
    from .rollout import ReleaseRegistry

    # which release goes off traffic, learnt BEFORE stopping it
    info = None
    try:
        info = _server_call(args, "/status.json")
    except (OSError, ValueError):
        pass  # liveness is checked by /stop below
    try:
        _server_call(args, "/stop", "POST")
    except OSError as e:
        _err(f"Cannot undeploy {args.ip}:{args.port}: {_call_error(e)}")
        return 1
    if not (info and info.get("engineId")):
        _out(f"Undeployed engine server at {args.ip}:{args.port}.")
        return 0
    _out(f"Undeployed engine server at {args.ip}:{args.port} (engine "
         f"{info['engineId']}, release instance "
         f"{info.get('engineInstanceId', '?')}).")
    try:
        ReleaseRegistry(storage, info["engineId"],
                        info.get("engineVersion") or "1",
                        info.get("engineVariant") or "engine.json").record(
            "undeploy", instance_id=info.get("engineInstanceId") or "",
            actor="pio undeploy", reason=f"stopped {args.ip}:{args.port}")
    except Exception as e:  # noqa: BLE001 — history is best-effort
        _err(f"release history write failed: {e}")
    return 0


def cmd_release(args, storage: Storage) -> int:
    """List, show and pin releases in the storage; drive a running engine
    server's canary, promote, rollback and status over its routes."""
    from .rollout import ReleaseRegistry
    from .rollout.splitter import parse_fraction

    sub = args.release_command
    if sub == "list":
        tracked = ReleaseRegistry.list_tracked(storage)
        if not tracked:
            _out("No releases recorded yet (deploy to create one).")
            return 0
        for engine_id, engine_version, engine_variant in sorted(tracked):
            st = ReleaseRegistry(storage, engine_id, engine_version,
                                 engine_variant).state()
            _out(f"{engine_id} v{engine_version} ({engine_variant}): "
                 f"stable={st.get('stable') or '(none)'} "
                 f"pinned={st.get('pinned') or '-'} "
                 f"candidate={st.get('candidate') or '-'}")
        return 0

    reg = ReleaseRegistry(storage, args.engine_id or "default",
                          args.engine_version or "1", args.engine_json)
    if sub == "show":
        _out(json.dumps(reg.to_json(history_limit=args.limit), indent=2))
        return 0
    if sub == "pin":
        if args.clear:
            reg.unpin(actor="pio release", reason=args.reason)
            _out("Unpinned; deploy/reload bind the latest COMPLETED "
                 "instance again.")
            return 0
        if not args.instance_id:
            _err("instance_id required (or --clear).")
            return 1
        try:
            reg.pin(args.instance_id, actor="pio release",
                    reason=args.reason)
        except ValueError as e:
            _err(str(e))
            return 1
        _out(f"Pinned release {args.instance_id}; deploy/reload now bind "
             f"it (POST /reload to apply on a live server).")
        return 0
    if sub == "status":
        try:
            payload = _server_call(args, "/release.json")
        except (OSError, ValueError) as e:
            _err(f"engine server at {args.ip}:{args.port} unreachable "
                 f"({_call_error(e)}); showing storage state")
            payload = reg.to_json(history_limit=10)
        _out(json.dumps(payload, indent=2))
        return 0
    if sub == "canary":
        body = {"instanceId": args.instance_id, "shadow": args.shadow,
                "actor": "pio release", "reason": args.reason}
        try:
            if args.fraction:
                body["fraction"] = parse_fraction(args.fraction)
        except ValueError as e:
            _err(str(e))
            return 1
        try:
            resp = _server_call(args, "/release/canary", "POST", body)
        except OSError as e:
            _err(f"canary start failed: {_call_error(e)}")
            return 1
        ro = (resp or {}).get("rollout") or {}
        _out(f"{'Shadow' if args.shadow else 'Canary'} rollout of "
             f"{args.instance_id} started at "
             f"{float(ro.get('fraction') or 0) * 100:.0f}% "
             f"(watch: release status).")
        return 0
    try:  # promote, rollback
        resp = _server_call(args, f"/release/{sub}", "POST",
                            {"reason": args.reason})
    except OSError as e:
        _err(f"{sub} failed: {_call_error(e)}")
        return 1
    _out(f"{resp.get('message', 'OK')} Serving instance: "
         f"{resp.get('engineInstanceId', '?')}")
    return 0


def _serve(srv: AppServer, what: str, args) -> int:
    _out(f"{what} is listening at http://{args.ip}:{srv.port}.")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        _out("Shutting down.")
    finally:
        srv.close()
    return 0


# -- parser -----------------------------------------------------------------

def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="predictionio_tpu_torch.cli")
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("app", help="manage apps")
    app_sub = sp.add_subparsers(dest="app_command", required=True)
    s = app_sub.add_parser("new")
    s.add_argument("name")
    s.add_argument("--id", type=int, default=0)
    s.add_argument("--description")
    s.add_argument("--access-key", default="")
    app_sub.add_parser("list")

    sp = sub.add_parser("accesskey", help="manage access keys")
    ak_sub = sp.add_subparsers(dest="ak_command", required=True)
    s = ak_sub.add_parser("new")
    s.add_argument("app")
    s.add_argument("events", nargs="*")
    s.add_argument("--key", default="")
    s = ak_sub.add_parser("list")
    s.add_argument("--app", default="")

    s = sub.add_parser("eventserver", help="start the event server")
    s.add_argument("--ip", default="0.0.0.0")
    s.add_argument("--port", type=int, default=7070)

    s = sub.add_parser("import", help="import events from JSON lines")
    s.add_argument("--appid", type=int, default=0)
    s.add_argument("--app", default="")
    s.add_argument("--input", required=True)

    for name, help_ in (("train", "train an engine"),
                        ("deploy", "serve the latest trained engine"),
                        ("batchpredict", "predict JSON lines of queries "
                                         "with the latest trained engine")):
        s = sub.add_parser(name, help=help_)
        s.add_argument("--engine-json", default="engine.json")
        s.add_argument("--engine-id", default="")
        s.add_argument("--engine-version", default="")
        s.add_argument("--device", default=None,
                       help="the device (default: the CUDA card)")
        if name == "train":
            s.add_argument("--skip-sanity-check", action="store_true")
            s.add_argument("--stop-after-read", action="store_true")
            s.add_argument("--stop-after-prepare", action="store_true")
            continue
        if name == "batchpredict":
            s.add_argument("--input", required=True)
            s.add_argument("--output", required=True)
            continue
        s.add_argument("--model", default="",
                       help="serve this model file instead of the latest "
                            "trained instance")
        s.add_argument("--ip", default="0.0.0.0")
        s.add_argument("--port", type=int, default=8000)
        s.add_argument("--serving-quant", default="off",
                       choices=("off", "bf16", "int8"))
        s.add_argument("--batching", action="store_true",
                       help="coalesce concurrent queries into batched "
                            "launches")
        s.add_argument("--batch-pipeline", type=int, default=4,
                       help="serial pipeline: drainer threads; staged: "
                            "dispatch threads")
        s.add_argument("--pipeline", default="staged",
                       choices=("staged", "serial"),
                       help="batch path: staged = assemble, dispatch and "
                            "readback stages overlapping host work with "
                            "the card; serial = drainer threads")
        s.add_argument("--queue-deadline-ms", type=float, default=30000.0,
                       help="per-query deadline from submit through "
                            "readback; past it the query is shed with "
                            "503. 0 disables")
        s.add_argument("--assemble-workers", type=int, default=1,
                       help="staged pipeline: threads parsing and "
                            "supplementing the next batch")
        s.add_argument("--readback-workers", type=int, default=4,
                       help="staged pipeline: threads waiting on results "
                            "and serving them")
        s.add_argument("--pipeline-depth", type=int, default=0,
                       help="staged pipeline: batches in flight; 0 = auto "
                            "(2 on the CPU, 4 on the card)")
        s.add_argument("--stream", action="store_true",
                       help="streaming fold-in: a trainer tails the event "
                            "log and folds new events into the served "
                            "model")
        s.add_argument("--stream-app", default="",
                       help="app whose event log the trainer tails")
        s.add_argument("--stream-interval-ms", type=float, default=500.0,
                       help="poll interval; in-process ingest wakes the "
                            "trainer at once")
        s.add_argument("--stream-max-events", type=int, default=2048,
                       help="events consumed per fold-in pass")
        s.add_argument("--stream-consumer", default="stream-trainer",
                       help="durable cursor identity")
        s.add_argument("--stream-drift-threshold", type=float, default=1.0,
                       help="DriftMonitor score that flags a full retrain")
        s.add_argument("--stream-canary-probes", type=int, default=8,
                       help="touched-user probes gating each fold-in (0 "
                            "disables the gate)")

    s = sub.add_parser("eval", help="run an evaluation")
    s.add_argument("evaluation", help="module.path:evaluation_object")
    s.add_argument("engine_params_generator", nargs="?", default="",
                   help="module.path:params_generator (optional)")
    s.add_argument("--parallelism", type=int, default=1,
                   help="grid-walk thread pool size (fold reads, packings "
                        "and trainings are shared; >1 overlaps host work "
                        "with the card's)")
    s.add_argument("--device", default=None,
                   help="the device (default: the CUDA card)")

    s = sub.add_parser("stream", help="attach, stop or inspect a running "
                                      "engine server's stream trainer")
    stream_sub = s.add_subparsers(dest="stream_command", required=True)
    for name, help_ in (("start", "attach the stream trainer"),
                        ("status", "trainer state, cursor, drift, lineage"),
                        ("stop", "stop the trainer (the cursor stays)")):
        c = stream_sub.add_parser(name, help=help_)
        c.add_argument("--ip", default="127.0.0.1")
        c.add_argument("--port", type=int, default=8000)
        if name == "start":
            c.add_argument("--app", default="")
            c.add_argument("--channel", default="")
            c.add_argument("--consumer", default="")
            c.add_argument("--interval-ms", type=float, default=None)
            c.add_argument("--max-events", type=int, default=None)
            c.add_argument("--drift-threshold", type=float, default=None)
            c.add_argument("--canary-probes", type=int, default=None)

    s = sub.add_parser("undeploy", help="stop a deployed engine server")
    s.add_argument("--ip", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8000)

    s = sub.add_parser("release", help="list, show and pin releases; drive "
                                       "a server's canary, promote and "
                                       "rollback")
    rel_sub = s.add_subparsers(dest="release_command", required=True)

    def release_flags(sp, server: bool = False):
        sp.add_argument("--engine-json", default="engine.json")
        sp.add_argument("--engine-id", default="")
        sp.add_argument("--engine-version", default="")
        sp.add_argument("--reason", default="",
                        help="recorded in the release history")
        if server:
            sp.add_argument("--ip", default="127.0.0.1")
            sp.add_argument("--port", type=int, default=8000)

    rel_sub.add_parser("list", help="every engine with release state")
    r = rel_sub.add_parser("show", help="state and history (JSON)")
    release_flags(r)
    r.add_argument("--limit", type=int, default=50,
                   help="history entries to include")
    r = rel_sub.add_parser("pin", help="pin deploy/reload to an instance")
    release_flags(r)
    r.add_argument("instance_id", nargs="?", default="")
    r.add_argument("--clear", action="store_true",
                   help="unpin (bind the latest COMPLETED again)")
    r = rel_sub.add_parser("canary", help="start a health-gated canary of "
                                          "an instance on the server")
    release_flags(r, server=True)
    r.add_argument("instance_id")
    r.add_argument("--fraction", default="",
                   help="initial candidate traffic fraction (0.05 or 5%%; "
                        "default: the first ramp step)")
    r.add_argument("--shadow", action="store_true",
                   help="mirror queries to the candidate without "
                        "returning its answers (never auto-promotes)")
    for name, help_ in (("promote", "promote the live candidate to the "
                                    "pinned stable"),
                        ("rollback", "abort the live candidate (or revert "
                                     "stable to the previous release)"),
                        ("status", "the server's /release.json (the "
                                   "storage's state when unreachable)")):
        release_flags(rel_sub.add_parser(name, help=help_), server=True)
    return p


def main(argv: Optional[List[str]] = None,
         storage: Optional[Storage] = None) -> int:
    args = _parser().parse_args(argv)
    if args.command == "stream":
        return cmd_stream(args)
    storage = storage if storage is not None else get_storage()
    if args.command == "app":
        return cmd_app(args, storage)
    if args.command == "accesskey":
        return cmd_accesskey(args, storage)
    if args.command == "import":
        return cmd_import(args, storage)
    if args.command == "train":
        return cmd_train(args, storage)
    if args.command == "batchpredict":
        return cmd_batchpredict(args, storage)
    if args.command == "eval":
        return cmd_eval(args, storage)
    if args.command == "undeploy":
        return cmd_undeploy(args, storage)
    if args.command == "release":
        return cmd_release(args, storage)
    if args.command == "eventserver":
        return _serve(build_eventserver(args, storage), "Event Server", args)
    srv = build_deploy(args, storage)
    return _serve(srv, f"Engine server ({srv.app.name})", args)


if __name__ == "__main__":
    sys.exit(main())
