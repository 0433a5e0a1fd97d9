"""Command line of the port (the ``pio`` console of
``predictionio_tpu.cli``)::

    python -m predictionio_tpu_torch.cli app new|list|show|delete|\\
        data-delete|channel-new|channel-delete MyApp1 [...] [-f]
    python -m predictionio_tpu_torch.cli accesskey new|list|delete ...
    python -m predictionio_tpu_torch.cli eventserver|adminserver|dashboard \\
        [--ip IP] [--port N] [--cert PEM --key PEM] [--stats]
    python -m predictionio_tpu_torch.cli storageserver [--ip IP] \\
        [--port 7077] [--secret S] [--cert PEM --key PEM]
    python -m predictionio_tpu_torch.cli start-all|stop-all [--pid-dir D] \\
        [--with-storageserver [--storageserver-port 7077] \\
        [--storage-secret S]]
    python -m predictionio_tpu_torch.cli import|export --app MyApp1 \\
        --input|--output ev.jsonl [--channel C]
    python -m predictionio_tpu_torch.cli build --engine-json engine.json \\
        [--artifact-dir D]
    python -m predictionio_tpu_torch.cli train --engine-json engine.json
    python -m predictionio_tpu_torch.cli deploy --engine-json engine.json \\
        --port 8000 [--artifact-dir D] [--serving-quant int8] [--batching] \\
        [--max-batch 128] [--model FILE] [--pipeline staged|serial] \\
        [--queue-deadline-ms 30000] [--stream --stream-app MyApp1] \\
        [--no-trace] [--trace-ring 512] [--trace-slow-ms 0] \\
        [--access-log-sample 1.0] [--profile-dir D] [--hot-keys-k 128] \\
        [--cache [--cache-entries 8192] [--cache-ttl 30] [--feature-ttl 5] \\
        [--hot-entities 512]] [--faults SPEC] [--debug-locks] \\
        [--slo-specs FILE] [--slo-interval-ms 1000] [--cert PEM --key PEM] \\
        [--fleet-of N [--fleet-port 8200] [--router-port 8100] \\
        [--fleet-scrape-interval-ms 5000] [--autoscale [--min-replicas 1] \\
        [--max-replicas 8]] [--capacity CAPACITY.json]]
    python -m predictionio_tpu_torch.cli batchpredict \\
        --engine-json engine.json --input q.jsonl --output out.jsonl
    python -m predictionio_tpu_torch.cli eval module:evaluation \\
        [module:params_generator] [--parallelism N]
    python -m predictionio_tpu_torch.cli stream status|start|stop \\
        [--port 8000] [--app MyApp1]
    python -m predictionio_tpu_torch.cli undeploy [--port 8000]
    python -m predictionio_tpu_torch.cli cache stats|flush [--port 8000] \\
        [--accesskey K]
    python -m predictionio_tpu_torch.cli trace [--port 8000] \\
        [--id TRACE_ID [-o FILE] | --slowest N]
    python -m predictionio_tpu_torch.cli slo status [--port 8000]
    python -m predictionio_tpu_torch.cli slo check [--capacity C.json] \\
        [--specs slo/specs/ci.json] [--update]
    python -m predictionio_tpu_torch.cli fleet serve --replicas H:P,H:P \\
        [--port 8200] [--slo-specs FILE] [--capacity C.json]
    python -m predictionio_tpu_torch.cli fleet status|slo|hotkeys|route|\\
        scale|trace [--port 8200] [--key K] [--to N] [--id T|--slowest N]
    python -m predictionio_tpu_torch.cli release list
    python -m predictionio_tpu_torch.cli release show|pin|status|canary|\\
        promote|rollback --engine-id ID --engine-json engine.json ...
    python -m predictionio_tpu_torch.cli status [--ip IP --port N]
    python -m predictionio_tpu_torch.cli check [PATH ...] [--rule R] \
        [--list-rules] [--format text|json|sarif] [--baseline F \
        [--write-baseline [--baseline-grow]]]
    python -m predictionio_tpu_torch.cli audit-lifecycle [--entry E] \
        [--list-entries] [--cycles 3] [--format text|json] [--out F] \
        [--baseline F [--write-baseline [--baseline-grow]]] [--device cpu]
    python -m predictionio_tpu_torch.cli audit-numerics [--entry E] \
        [--list-entries] [--format text|json] [--out F] \
        [--baseline F] [--write-baseline [--baseline-grow]] [--device cpu]
    python -m predictionio_tpu_torch.cli audit-hlo [--entry E] \
        [--list-entries] [--format text|json] [--out F] \
        [--baseline F] [--write-baseline [--baseline-grow]] [--device cpu]
    python -m predictionio_tpu_torch.cli version|template|shell
    python -m predictionio_tpu_torch.cli run module:callable [ARG ...]

Storage is the JAX package's: ``PIO_STORAGE_*`` variables, else one
SQLite file at ``$PIO_HOME/pio.db``. ``train``, ``deploy``,
``batchpredict``, ``eval`` and ``status`` run on the CUDA card unless
``--device cpu`` is given; without CUDA they fail. ``build`` checks that
the variant loads and compiles every kernel library into the kernel root
(``--artifact-dir D`` gives ``D/torch_kernels``, else
``$PTPU_ARTIFACT_DIR``, else ``build/torch_kernels``; without ``nvcc``
it fails, ``--device cpu`` checks the variant only); ``deploy`` with the
same ``--artifact-dir`` loads them at bind and runs the serving ladder
before it reports ``servingWarm``, so the first query pays no build.
``deploy`` binds the pinned release of the variant's engine, else its
latest COMPLETED instance, or, with ``--model``, a file written by
``workflow/persistence.py::dumps_models``; it serves until ``POST /stop``
(``undeploy``, which records the undeploy in the release history).
With ``--batching`` concurrent queries coalesce through the staged
pipeline (``--pipeline serial``: the drainer threads), each shed with a
503 past ``--queue-deadline-ms``. ``batchpredict`` writes one
``{"query", "prediction"}`` line for each query line of ``--input``,
from the latest COMPLETED instance. ``eval`` walks the generator's params
grid (or the evaluation's own ``engine_params_list``), prints the
winner's one-liner and records an EVALCOMPLETED evaluation instance,
which the ``dashboard`` lists. With ``--stream`` a stream trainer folds
the app's new events into the served model (not with ``--model``: it
needs the storage the instance came from). ``stream`` drives a running
engine server's trainer over HTTP. ``release`` lists, shows and pins
releases in the storage (the JAX package's release blobs: a pin either
package writes binds in both) and drives a running engine server's
canary, promote and rollback (``status`` falls back to the storage when
the server is unreachable); as in the JAX package its engine triple is
``--engine-id`` (default "default"), ``--engine-version`` (default "1")
and the ``--engine-json`` path. ``storageserver`` serves this host's
storage to REMOTE-backend clients (hosts of a pod with no shared mount)
over the JAX package's protocol, ``--secret`` guarding every route.
``start-all`` runs the event server, the admin server and the dashboard
(with ``--with-storageserver``, the storage server first) as daemons with
pidfiles; ``stop-all`` stops them. ``import`` loads through the event
store's own bulk lane (SEGMENTFS: the native codec), then builds the
columnar sidecar. ``--https`` (and ``--insecure``) reach a server deployed
with ``--cert``/``--key``. ``trace`` reads a running engine server's
flight recorder: its status, the N slowest retained traces, or one trace
written as Chrome/Perfetto trace-event JSON. ``eventserver --stats``
keeps the per-app ``/stats.json`` counts. A deployed server traces every
request (``--no-trace`` turns that off; ``--trace-ring``,
``--trace-slow-ms`` size and tune the recorder), writes
``--access-log-sample`` of its successful requests to the access log,
keeps ``POST /profile`` captures under ``--profile-dir`` and tracks the
``--hot-keys-k`` hottest users; ``PTPU_DEBUG_NUMERICS=1`` arms the NaN/Inf
sentinels. Every deployed server runs the SLO engine (``--slo-specs``, the
built-in objectives by default; ``--slo-interval-ms 0`` turns it off);
``slo status`` prints its burn rates, ``slo check`` gates a capacity
model against the committed spec file. ``deploy --fleet-of N`` boots N
engine servers in one process (each with its own tables on the card and
its own warm-up) behind the entity-affinity query router
(``--router-port``) and the fleet aggregator (``--fleet-port``, merged
``/metrics`` and ``/fleet.json``), with ``--autoscale`` the autoscaler
between ``--min-replicas`` and ``--max-replicas``; it serves until ``POST
/stop`` to the aggregator. ``fleet`` reads a running aggregator, and
``fleet scale --to N`` drives the autoscaler (a new replica joins the
ring once warm, a removed one drains first). Without ``--capacity`` the
fleet has no capacity knee: the headroom branches never fire. ``deploy --cache`` serves through the serving cache hierarchy
(the query tier of ``--cache-entries`` answers kept ``--cache-ttl``
seconds at most, singleflight, the feature tier of ``--feature-ttl``,
and the ``--hot-entities`` hottest users ranked from a table pinned on
the card); ``cache stats`` prints a running engine server's tiers and
``cache flush`` empties them.

An ``engineFactory``, evaluation or params generator under
``predictionio_tpu.`` is read as the same path under
``predictionio_tpu_torch.``, so the JAX package's shipped variants train
and deploy on the port unchanged; the JAX package is never imported.

``check`` runs the port's static analysis (``analysis/``: the
concurrency, lifecycle, kernel-safety and numerics rule families, host
syncs with torch's sync calls, ``unbounded-retry``, the metric catalog
and the shared-memory budget of ``csrc/``) over ``predictionio_tpu_torch``
or the given paths, loading neither torch nor the storage;
``audit-lifecycle`` cycles the port's servers start→serve→stop on
``--device`` (the card by default) and gates the thread/fd/socket leak
census against ``analysis/lifecycle_baseline.json``; ``audit-numerics``
runs the 13 numeric entry points under a ``TorchDispatchMode`` on
``--device`` and gates their dtype census against the platform's section
of ``analysis/numerics_baseline.json``; ``audit-hlo`` runs the 8 mesh
entry points over 8 positions of ``--device`` and gates their collective
census (each collective call with its result shape, the moves between
positions that go through no collective, the peak bytes allocated)
against the platform's section of ``analysis/hlo_baseline.json``. Their
flags, output and exit codes are the JAX package's ``ptpu check``,
``ptpu audit-lifecycle``, ``ptpu audit-numerics`` and ``ptpu audit-hlo``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import ssl
import sys
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import TYPE_CHECKING, List, Optional

from . import __version__

if TYPE_CHECKING:
    from .data.storage.registry import Storage
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

def _find_channel(storage: Storage, app: App, name: str):
    """The channel ``name`` of ``app``; None when absent."""
    return next((c for c in storage.channels().get_by_app_id(app.id)
                 if c.name == name), None)


def _confirm(prompt: str) -> bool:
    try:
        return input(f"{prompt} (y/N) ").strip().lower() == "y"
    except EOFError:
        return False


def cmd_app(args, storage: Storage) -> int:
    from .data.storage.base import AccessKey, App, Channel

    apps, keys, chans = (storage.apps(), storage.access_keys(),
                         storage.channels())
    sub = args.app_command
    if sub == "new":
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
    if sub == "list":
        _out(f"{'Name':20} |   ID | Access Key")
        for a in sorted(apps.get_all(), key=lambda a: a.name):
            for k in keys.get_by_app_id(a.id) or [None]:
                allowed = ",".join(k.events) if k and k.events else "(all)"
                _out(f"{a.name:20} | {a.id:4} | {k.key if k else ''} | "
                     f"{allowed}")
        _out(f"Finished listing {len(apps.get_all())} app(s).")
        return 0
    a = apps.get_by_name(args.name)
    if a is None:
        _err(f"App {args.name} does not exist. Aborting.")
        return 1
    if sub == "show":
        _out(f"    App Name: {a.name}")
        _out(f"      App ID: {a.id}")
        _out(f" Description: {a.description or ''}")
        for k in keys.get_by_app_id(a.id):
            allowed = ",".join(k.events) if k.events else "(all)"
            _out(f"  Access Key: {k.key} | {allowed}")
        for c in chans.get_by_app_id(a.id):
            _out(f"     Channel: {c.name} (ID {c.id})")
        return 0
    if sub == "delete":
        if not args.force and not _confirm(
                f"Delete app {args.name} and ALL its data?"):
            return 1
        for c in chans.get_by_app_id(a.id):
            storage.events().remove(a.id, c.id)
            chans.delete(c.id)
        storage.events().remove(a.id)
        for k in keys.get_by_app_id(a.id):
            keys.delete(k.key)
        apps.delete(a.id)
        _out(f"Deleted app {args.name}.")
        return 0
    if sub == "data-delete":
        if not args.force and not _confirm(
                f"Delete ALL data of app {args.name}?"):
            return 1
        channel_id = None
        if args.channel:
            ch = _find_channel(storage, a, args.channel)
            if ch is None:
                _err(f"Channel {args.channel} does not exist. Aborting.")
                return 1
            channel_id = ch.id
        storage.events().remove(a.id, channel_id)
        storage.events().init(a.id, channel_id)
        _out(f"Removed Event Store for the app ID: {a.id}")
        return 0
    if sub == "channel-new":
        if not Channel.is_valid_name(args.channel):
            _err(f"Channel name {args.channel} is invalid (1-16 "
                 f"alphanumeric/dash characters). Aborting.")
            return 1
        if _find_channel(storage, a, args.channel) is not None:
            _err(f"Channel {args.channel} already exists. Aborting.")
            return 1
        cid = chans.insert(Channel(id=0, name=args.channel, app_id=a.id))
        storage.events().init(a.id, cid)
        _out(f"Created channel {args.channel} (ID {cid}) for app "
             f"{args.name}.")
        return 0
    # channel-delete
    ch = _find_channel(storage, a, args.channel)
    if ch is None:
        _err(f"Channel {args.channel} does not exist. Aborting.")
        return 1
    if not args.force and not _confirm(
            f"Delete channel {args.channel} and its data?"):
        return 1
    storage.events().remove(a.id, ch.id)
    chans.delete(ch.id)
    _out(f"Deleted channel {args.channel}.")
    return 0


def cmd_accesskey(args, storage: Storage) -> int:
    from .data.storage.base import AccessKey

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
    if args.ak_command == "delete":
        keys.delete(args.key)
        _out(f"Deleted access key {args.key}.")
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


def _ssl(args):
    """The server TLS context of ``--cert``/``--key`` (or
    ``PIO_SSL_CERT``/``PIO_SSL_KEY``); None for plain HTTP."""
    from .server.http import ssl_context_from

    return ssl_context_from(args.cert or None, args.key or None)


def build_eventserver(args, storage: Storage) -> AppServer:
    """The event server the eventserver command would serve, not yet
    serving."""
    from .server.eventserver import create_event_server

    return create_event_server(storage, args.ip, args.port,
                               stats=args.stats, ssl_context=_ssl(args))


def build_adminserver(args, storage: Storage) -> AppServer:
    from .server.adminserver import create_admin_server

    return create_admin_server(storage, host=args.ip, port=args.port,
                               accesskey=args.accesskey or None,
                               ssl_context=_ssl(args))


def build_dashboard(args, storage: Storage) -> AppServer:
    from .server.dashboard import create_dashboard

    return create_dashboard(storage, host=args.ip, port=args.port,
                            accesskey=args.accesskey or None,
                            ssl_context=_ssl(args))


def build_storageserver(args, storage: Storage) -> AppServer:
    """The storage server the storageserver command would serve, not yet
    serving."""
    from .server.storageserver import create_storage_server

    return create_storage_server(storage, host=args.ip, port=args.port,
                                 secret=args.secret or None,
                                 ssl_context=_ssl(args))


def _app_and_channel(args, storage: Storage):
    """The app of ``--app``/``--appid`` and the id of ``--channel``;
    ``(None, None)`` after an error message."""
    a = (storage.apps().get_by_name(args.app) if args.app
         else storage.apps().get(args.appid))
    if a is None:
        _err("App does not exist. Aborting.")
        return None, None
    if not args.channel:
        return a, None
    ch = _find_channel(storage, a, args.channel)
    if ch is None:
        _err(f"Channel {args.channel} does not exist. Aborting.")
        return None, None
    return a, ch.id


def cmd_import(args, storage: Storage) -> int:
    """JSON lines -> event store, committed in all-or-nothing chunks;
    then the columnar sidecar is built, so the first train does not pay
    it."""
    from .data.storage.base import JsonlImportError

    a, channel_id = _app_and_channel(args, storage)
    if a is None:
        return 1
    try:
        total = storage.events().import_jsonl(args.input, a.id, channel_id)
    except JsonlImportError as err:
        _err(f"Import failed near line {err.lineno}: {err.cause}")
        _err(f"{err.committed_events} event(s) (input lines "
             f"1-{err.committed_lines}) are already committed; importing "
             f"the whole file again would duplicate them.")
        return 1
    _out(f"Imported {total} event(s).")
    if storage.events().warm_columnar(a.id, channel_id):
        _out("Columnar sidecar ready.")
    return 0


def cmd_export(args, storage: Storage) -> int:
    """Event store -> JSON lines, in the JAX package's format (one event
    a line, the REST API's JSON); ``import`` reads it back."""
    from .data.storage.base import EventFilter

    a, channel_id = _app_and_channel(args, storage)
    if a is None:
        return 1
    n = 0
    with open(args.output, "w", encoding="utf-8") as f:
        for e in storage.events().find(a.id, channel_id, EventFilter()):
            f.write(json.dumps(e.to_json()) + "\n")
            n += 1
    _out(f"Exported {n} event(s) to {args.output}.")
    return 0


def cmd_build(args, storage: Storage) -> int:
    """Check that the variant loads, then build every kernel library into
    the kernel root (``--artifact-dir``, ``$PTPU_ARTIFACT_DIR`` or
    ``build/torch_kernels``), where a deploy with the same root loads
    them at bind, and the host's native codec beside them. ``--device
    cpu`` checks the variant only. A machine without ``nvcc`` fails
    here."""
    import subprocess

    from . import native
    from .controller.params import load_variant
    from .ops import _build

    variant = load_variant(args.engine_json)
    _, engine_params = engine_from_variant(variant)
    _out(f"Engine factory {variant.get('engineFactory')} loads OK "
         f"({len(engine_params.algorithms)} algorithm(s) configured).")
    if args.device != "cpu":
        try:
            _build.set_root(args.artifact_dir)
            result = _build.build_all()
        except RuntimeError as e:
            _err(f"Kernel build failed: {e}")
            return 1
        try:
            codec = native.build()
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _err(f"Native codec build failed: {e}")
            return 1
        _out(f"Kernel root: {result['root']}")
        for name, lib in sorted(result["libraries"].items()):
            what = "compiled" if lib["compiled"] else "already built"
            _out(f"  {name}: {what} ({lib['seconds']:.2f}s)")
        what = "compiled" if codec["compiled"] else "already built"
        _out(f"  native codec (host, g++): {what} "
             f"({codec['seconds']:.2f}s)")
        _out(f"Kernels built in {result['seconds']:.2f}s. Deploy with "
             f"--artifact-dir {args.artifact_dir or '(the same root)'} to "
             f"load them at bind.")
    _out("Build finished successfully.")
    return 0


def cmd_train(args, storage: Storage) -> int:
    from .controller.context import Context
    from .controller.params import load_variant
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
    _out(f"Train stages: "
         f"{json.dumps({k: round(v, 3) for k, v in ctx.stage_timings.items()})}")
    _out(f"Training completed. Engine instance ID: {instance_id}")
    return 0


def build_deploy(args, storage: Optional[Storage] = None,
                 port: Optional[int] = None) -> AppServer:
    """The engine server the deploy command would serve, not yet
    serving: the latest COMPLETED instance from storage, or the
    ``--model`` file; on ``port`` when given, else ``--port``."""
    from .controller.context import Context
    from .controller.params import load_variant
    from .data.storage.registry import get_storage
    from .server.engineserver import ServerConfig, deploy, deploy_models

    port = args.port if port is None else port
    variant = load_variant(args.engine_json)
    engine, engine_params = engine_from_variant(variant)
    config = ServerConfig(feedback=args.feedback,
                          feedback_app_name=args.feedback_app_name or None,
                          batching=args.batching,
                          max_batch=args.max_batch,
                          batch_window_ms=args.batch_window_ms,
                          batch_pipeline=args.batch_pipeline,
                          serving_pipeline=args.pipeline,
                          queue_deadline_ms=args.queue_deadline_ms,
                          assemble_workers=args.assemble_workers,
                          readback_workers=args.readback_workers,
                          pipeline_depth=args.pipeline_depth,
                          serving_quant=args.serving_quant,
                          serving_topk=args.serving_topk,
                          device=args.device,
                          streaming=args.stream,
                          stream_app_name=args.stream_app or None,
                          stream_interval_ms=args.stream_interval_ms,
                          stream_max_events=args.stream_max_events,
                          stream_consumer=args.stream_consumer,
                          stream_drift_threshold=args.stream_drift_threshold,
                          stream_canary_probes=args.stream_canary_probes,
                          artifact_dir=args.artifact_dir or None,
                          tracing=not args.no_trace,
                          trace_ring=args.trace_ring,
                          trace_slow_ms=args.trace_slow_ms,
                          access_log_sample=args.access_log_sample,
                          profile_dir=args.profile_dir or None,
                          hot_keys_k=args.hot_keys_k,
                          serving_cache=args.cache,
                          cache_entries=args.cache_entries,
                          cache_ttl_sec=args.cache_ttl,
                          feature_ttl_sec=args.feature_ttl,
                          hot_entities=args.hot_entities,
                          serving_mode=args.serving_mode,
                          faults=args.faults or None,
                          debug_locks=args.debug_locks,
                          slo_specs=args.slo_specs or None,
                          slo_interval_ms=args.slo_interval_ms)
    ssl_ctx = _ssl(args)
    if args.model:
        from .workflow.persistence import loads_models

        with open(args.model, "rb") as f:
            models = loads_models(f.read())
        return deploy_models(engine, engine_params, models, config,
                             args.ip, port, ssl_context=ssl_ctx)
    ctx = Context(device=args.device,
                  _storage=storage if storage is not None else get_storage())
    return deploy(ctx, engine, engine_params, config=config, host=args.ip,
                  port=port, ssl_context=ssl_ctx,
                  **_engine_key(args, variant))


class FleetDeploy:
    """What ``deploy --fleet-of N`` runs in one process: N engine-server
    replicas, the fleet aggregator (:attr:`server`, not yet serving), the
    entity-affinity query router (:attr:`router_server`, serving), the
    replica lifecycle and, with ``--autoscale``, the autoscaler.
    :meth:`close` stops all of it and joins every thread it started."""

    def __init__(self, replicas, agg, server, router, router_server,
                 lifecycle, autoscaler) -> None:
        self.replicas = replicas
        self.agg = agg
        self.server = server
        self.router = router
        self.router_server = router_server
        self.lifecycle = lifecycle
        self.autoscaler = autoscaler

    def close(self) -> None:
        if self.autoscaler is not None:
            self.autoscaler.stop()
        self.lifecycle.close(stop_replicas=True)
        self.router_server.close()
        self.server.close()


def build_fleet_deploy(args, storage: Optional[Storage] = None,
                       tracer=None) -> FleetDeploy:
    """Boot ``--fleet-of`` engine servers on consecutive ports from
    ``--port`` (each its own ``QueryServer``, its own tables on the card
    and its own warm-up), adopt them into the lifecycle, and front them
    with the router (``--router-port``) and the aggregator
    (``--fleet-port``); the aggregator's liveness view vetoes routing
    candidates. A spawned replica (autoscaler or ``fleet scale``) takes a
    free port and joins the ring once ``servingWarm``. ``tracer`` keeps
    the autoscaler's decisions (reason ``autoscale``)."""
    from .data.storage.registry import get_storage
    from .fleet import FleetConfig, create_fleet_server
    from .router import (
        Autoscaler,
        AutoscalePolicy,
        QueryRouter,
        ReplicaLifecycle,
        RouterConfig,
        create_router_server,
    )
    from .server.http import AppServer

    storage = storage if storage is not None else get_storage()
    ssl_ctx = _ssl(args)
    scheme = "https" if ssl_ctx else "http"
    accesskey = getattr(args, "accesskey", "") or None

    def boot(port: int) -> AppServer:
        return build_deploy(args, storage, port=port).start_background()

    def url(srv: AppServer) -> str:
        return f"{scheme}://127.0.0.1:{srv.port}"

    servers: List[AppServer] = []
    try:
        for i in range(args.fleet_of):
            servers.append(boot(args.port + i if args.port else 0))
    except BaseException:
        for srv in servers:
            srv.close()
        raise
    fleet_cfg = FleetConfig(
        replicas=[url(srv) for srv in servers],
        scrape_interval_sec=args.fleet_scrape_interval_ms / 1000.0,
        slo_specs=args.slo_specs or None,
        slo_interval_sec=args.slo_interval_ms / 1000.0,
        capacity_path=args.capacity or None,
        accesskey=accesskey)
    agg, fleet_srv = create_fleet_server(fleet_cfg, host=args.ip,
                                         port=args.fleet_port,
                                         ssl_context=ssl_ctx)
    # the pio_router_* families ride the fleet's /metrics beside the
    # merged replica series and pio_autoscale_*
    router = QueryRouter(RouterConfig(accesskey=accesskey),
                         registry=agg.registry)
    router_srv = create_router_server(router, host=args.ip,
                                      port=args.router_port,
                                      ssl_context=ssl_ctx)
    router_srv.start_background()
    agg.attach_router(router)
    # "unknown"/"absent" (not scraped yet) is no opinion: a fresh replica
    # is not vetoed during its first scrape window
    router.set_health(lambda name: {"up": True, "down": False}.get(
        agg.replica_health(name)))

    def spawn():
        srv = boot(0)
        return url(srv), srv.close

    lifecycle = ReplicaLifecycle(spawn=spawn, router=router,
                                 aggregator=agg, registry=agg.registry,
                                 accesskey=accesskey)
    for srv in servers:
        lifecycle.adopt(url(srv), stop_fn=srv.close)
    autoscaler = None
    if args.autoscale:
        autoscaler = Autoscaler(
            agg, lifecycle,
            AutoscalePolicy(min_replicas=args.min_replicas,
                            max_replicas=args.max_replicas),
            registry=agg.registry, tracer=tracer).start()
        agg.attach_autoscaler(autoscaler)
    return FleetDeploy(servers, agg, fleet_srv, router, router_srv,
                       lifecycle, autoscaler)


def cmd_deploy_fleet(args, storage: Storage) -> int:
    """``deploy --fleet-of N``: serve the fleet until ``POST /stop`` to
    the aggregator (or SIGINT), then stop every replica and thread."""
    fleet = build_fleet_deploy(args, storage)
    scheme = fleet.server.scheme
    try:
        for srv in fleet.replicas:
            _out(f"Replica live at {scheme}://{args.ip}:{srv.port}.")
        if fleet.autoscaler is not None:
            knee = fleet.agg.capacity_signals()["kneeQps"]
            _out(f"Autoscaler running: {args.min_replicas}-"
                 f"{args.max_replicas} replicas, knee model "
                 f"{'loaded' if knee else 'ABSENT'}.")
        _out(f"Query router live at {scheme}://{args.ip}:"
             f"{fleet.router_server.port}; send /queries.json here "
             f"(entity affinity, retry, spill).")
        _out(f"Fleet aggregator live at {scheme}://{args.ip}:"
             f"{fleet.server.port}; merged /metrics, /fleet.json, "
             f"/route.json, /trace.json, /hotkeys.json.")
        fleet.server.serve_forever()
    except KeyboardInterrupt:
        _out("Shutting down.")
    finally:
        fleet.close()
    return 0


def cmd_batchpredict(args, storage: Storage) -> int:
    """Predict every query line of ``--input`` with the latest COMPLETED
    instance, on the card unless ``--device cpu``."""
    from .controller.context import Context
    from .controller.params import load_variant
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
    from .controller.context import Context
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
    """One JSON call to the engine server at ``args.ip``:``args.port``;
    over HTTPS with ``--https`` (certificates verified unless
    ``--insecure``, for a self-signed local certificate), with
    ``?accessKey=`` where the command takes ``--accesskey``."""
    https = getattr(args, "https", False)
    data = json.dumps(body).encode() if body is not None else (
        b"" if method == "POST" else None)
    url = f"{'https' if https else 'http'}://{args.ip}:{args.port}{path}"
    if getattr(args, "accesskey", ""):
        url += f"{'&' if '?' in url else '?'}accessKey={args.accesskey}"
    req = urllib.request.Request(url, data=data, method=method)
    handlers: list = [urllib.request.ProxyHandler({})]
    if https:
        ctx = ssl.create_default_context()
        if getattr(args, "insecure", False):
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        handlers.append(urllib.request.HTTPSHandler(context=ctx))
    opener = urllib.request.build_opener(*handlers)
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


def cmd_cache(args) -> int:
    """Operate a running engine server's serving cache: each tier's
    stats, or the operator's flush of every tier."""
    sub = args.cache_command
    if sub == "stats":
        try:
            payload = _server_call(args, "/cache.json")
        except (urllib.error.URLError, OSError, ValueError) as e:
            _err(f"engine server at {args.ip}:{args.port} unreachable: "
                 f"{_call_error(e)}")
            return 1
        if not (payload or {}).get("enabled"):
            _out("Serving cache is OFF on this server "
                 "(deploy with --cache).")
            return 0
        _out(json.dumps(payload, indent=2))
        for name, t in (payload.get("tiers") or {}).items():
            total = t.get("hits", 0) + t.get("misses", 0)
            _out(f"{name}: {t.get('entries', 0)} entries, "
                 f"{t.get('hitRatio', 0) * 100:.1f}% hit ratio over "
                 f"{total} lookups, {t.get('invalidations', 0)} "
                 f"invalidations")
        return 0
    try:
        payload = _server_call(args, "/cache/flush", "POST")
    except (urllib.error.URLError, OSError, ValueError) as e:
        _err(f"cache flush failed: {_call_error(e)}")
        return 1
    removed = (payload or {}).get("removed") or {}
    _out("Flushed: " + ", ".join(f"{k}={v}" for k, v in removed.items()))
    return 0


def cmd_trace(args) -> int:
    """Read a running engine server's flight recorder: its status, the N
    slowest retained traces, or one trace written as Chrome/Perfetto
    trace-event JSON (load the file at ui.perfetto.dev)."""
    if args.id:
        path = f"/trace.json?id={args.id}"
    elif args.slowest is not None:
        path = f"/trace.json?slowest={args.slowest}"
    else:
        path = "/trace.json"
    try:
        payload = _server_call(args, path) or {}
    except (OSError, ValueError) as e:
        _err(f"server at {args.ip}:{args.port} unreachable: "
             f"{_call_error(e)}")
        return 1
    if args.id:
        out_path = args.output or f"trace-{args.id[:12]}.json"
        with open(out_path, "w", encoding="utf-8") as f:
            json.dump(payload, f)
        n = len(payload.get("traceEvents") or [])
        _out(f"Wrote {n} trace events to {out_path}; load it at "
             f"https://ui.perfetto.dev (or chrome://tracing).")
        return 0
    if args.slowest is not None:
        traces = payload.get("traces") or []
        if not traces:
            _out("No retained traces yet (only slow, failed, shed and "
                 "stream traces are kept).")
            return 0
        for t in traces:
            _out(f"{t.get('traceId')}  {t.get('durationMs', '?')}ms  "
                 f"status={t.get('status')}  reason={t.get('reason')}  "
                 f"{t.get('name', '')}")
        _out(f"Export one: trace --id {traces[0]['traceId']}")
        return 0
    _out(json.dumps(payload, indent=2))
    _out(f"flight recorder: {payload.get('retained', 0)}/"
         f"{payload.get('ringCapacity', '?')} retained of "
         f"{payload.get('requests', 0)} traced requests"
         + (f", slow ≥ {payload['slowThresholdMs']}ms"
            if payload.get("slowThresholdMs") is not None else ""))
    return 0


def _print_slo_payload(payload: Optional[dict]) -> int:
    """One line per spec of a ``/slo.json`` body (``slo status`` and
    ``fleet slo``); exit 1 while a spec burns."""
    p = payload or {}
    if not p.get("enabled", False):
        _out("SLO engine is disabled on this server "
             f"({p.get('hint', '')})")
        return 0
    burning = p.get("burning") or []
    for sp in p.get("specs") or []:
        budget = sp.get("budgetRemaining")
        bits = [f"{sp['name']:<28} {sp['state']:<18}"]
        for key, label in (("burnFast", "fast"), ("burnSlow", "slow")):
            v = sp.get(key)
            bits.append(f"burn[{label}] "
                        + (f"{v:6.2f}x" if v is not None else "     ?"))
        bits.append("budget " + (f"{budget * 100:6.1f}%"
                                 if budget is not None else "     ?"))
        bits.append(f"violations {sp.get('violations', 0)}")
        _out("  ".join(bits))
    _out(f"{len(p.get('specs') or [])} spec(s), "
         + (f"BURNING: {', '.join(burning)}" if burning
            else "none burning")
         + f" ({p.get('ticks', 0)} evaluation ticks)")
    return 1 if burning else 0


def cmd_slo(args) -> int:
    """``slo status``: a running server's live burn rates and budgets
    (``GET /slo.json``), one line per spec. ``slo check``: the capacity
    gate: a capacity model (``CAPACITY.json``) against the committed spec
    file's ``capacity`` section, with ratchet semantics (``--update``
    tightens the committed gates toward a better run, never loosens
    them)."""
    if args.slo_command == "status":
        try:
            payload = _server_call(args, "/slo.json")
        except (OSError, ValueError) as e:
            _err(f"server at {args.ip}:{args.port} unreachable: "
                 f"{_call_error(e)}")
            return 1
        return _print_slo_payload(payload)
    from .slo import gate_capacity, load_specs, ratchet_gates, write_gates

    try:
        with open(args.capacity, encoding="utf-8") as f:
            capacity = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        _err(f"cannot read capacity model {args.capacity}: {e}")
        return 1
    try:
        _specs, gates = load_specs(args.specs)
    except (OSError, ValueError) as e:
        _err(f"cannot read SLO spec file {args.specs}: {e}")
        return 1
    if not gates:
        _err(f"{args.specs} commits no capacity gates; add a 'capacity' "
             f"section")
        return 1
    failures = gate_capacity(capacity, gates)
    for line in failures:
        _err(f"FAIL {line}")
    if failures:
        _err(f"{len(failures)} capacity regression(s) vs {args.specs} "
             f"— fix the regression or, for an accepted trade-off, "
             f"loosen the committed gate in an explicit commit")
        return 1
    n_checked = sum(len(g) for g in gates.values())
    _out(f"capacity gate PASS: {n_checked} committed limit(s) over "
         f"{len(gates)} config(s) hold for {args.capacity}")
    if args.update:
        new_gates, changes = ratchet_gates(capacity, gates)
        if changes:
            write_gates(args.specs, new_gates)
            for c in changes:
                _out(f"ratchet {c}")
            _out(f"tightened {len(changes)} gate(s) in {args.specs} — "
                 f"commit the file")
        else:
            _out("no gate beat its committed value; nothing to ratchet")
    return 0


def cmd_fleet(args) -> int:
    """The fleet plane. ``serve`` runs the aggregator over
    ``--replicas``; ``status`` prints each replica's liveness, lag and
    flags and the fleet's headroom (exit 1 while a replica is down or a
    fleet SLO burns; one the autoscaler removed on purpose is not down);
    ``slo`` the fleet SLO engine's burn rates; ``trace`` looks a trace up
    on every replica (``--id``) or merges the slowest; ``hotkeys`` the
    fleet-wide top-K; ``route`` the router's ring and backends (and where
    a ``--key`` lands); ``scale`` hands the autoscaler a replica-count
    target. Needs no storage."""
    if args.fleet_command == "serve":
        from .fleet import FleetConfig, create_fleet_server

        cfg = FleetConfig(
            replicas=[r.strip() for r in args.replicas.split(",")
                      if r.strip()],
            scrape_interval_sec=args.scrape_interval_ms / 1000.0,
            stale_after_sec=(args.stale_after_ms / 1000.0
                             if args.stale_after_ms else None),
            slo_specs=args.slo_specs or None,
            slo_interval_sec=args.slo_interval_ms / 1000.0,
            capacity_path=args.capacity or None,
            hot_keys_k=args.hot_keys_k,
            timeout_sec=args.timeout_sec,
            accesskey=args.accesskey or None)
        _agg, server = create_fleet_server(cfg, host=args.ip,
                                           port=args.port,
                                           ssl_context=_ssl(args))
        return _serve(server, "Fleet aggregator", args,
                      f"Merging {len(cfg.replicas)} replica(s): /metrics, "
                      f"/fleet.json, /slo.json, /trace.json, "
                      f"/hotkeys.json.")
    sub = args.fleet_command
    try:
        if sub == "status":
            payload = _server_call(args, "/fleet.json") or {}
        elif sub == "slo":
            return _print_slo_payload(_server_call(args, "/slo.json"))
        elif sub == "hotkeys":
            payload = _server_call(args,
                                   f"/hotkeys.json?n={args.top}") or {}
        elif sub == "route":
            path = "/route.json"
            if args.key:
                path += "?key=" + urllib.parse.quote(args.key)
            payload = _server_call(args, path) or {}
        elif sub == "scale":
            path = f"/scale?to={int(args.to)}"
            if args.reason:
                path += "&reason=" + urllib.parse.quote(args.reason)
            payload = _server_call(args, path, "POST") or {}
        elif args.id:
            payload = _server_call(args, f"/trace.json?id={args.id}")
        elif args.slowest is not None:
            payload = _server_call(args,
                                   f"/trace.json?slowest={args.slowest}")
        else:
            payload = _server_call(args, "/trace.json")
    except (OSError, ValueError) as e:
        _err(f"fleet aggregator at {args.ip}:{args.port} unreachable: "
             f"{_call_error(e)}")
        return 1
    if sub == "status":
        # the decision log tells an intentional exit (scale-in) from a
        # corpse: a replica removed on purpose, or draining, is no outage
        autoscale = payload.get("autoscale") or {}
        removed = set(autoscale.get("removed") or [])
        down = 0
        for r in payload.get("replicas") or []:
            lifecycle = r.get("lifecycle")
            if r.get("up"):
                state = "draining" if lifecycle == "draining" else "up"
            elif r.get("replica") in removed or lifecycle == "draining":
                state = "removed"
            else:
                state = "DOWN"
                down += 1
            flags = []
            if r.get("degraded"):
                flags.append("DEGRADED")
            if r.get("nonfinite"):
                flags.append("NONFINITE")
            if r.get("sloBurning"):
                flags.append("burning:" + ",".join(r["sloBurning"]))
            age = r.get("lastScrapeAgeSec")
            _out(f"{r.get('replica', '?'):<24} {state:<9} "
                 f"age {age if age is not None else '?':>7}s  "
                 f"requests {r.get('requestCount') or 0:>8}  "
                 f"{' '.join(flags)}")
        headroom = payload.get("capacityHeadroom")
        burning = (payload.get("slo") or {}).get("burning") or []
        _out(f"{payload.get('replicasUp', 0)}/"
             f"{payload.get('replicasConfigured', 0)} replicas up, "
             f"qps {payload.get('qps', 0.0):.2f}, headroom "
             + (f"{headroom:.3f}" if headroom is not None else "?")
             + (f", fleet SLO BURNING: {', '.join(burning)}"
                if burning else ", fleet SLO ok")
             + f" ({payload.get('cycles', 0)} scrape cycles)")
        if autoscale.get("enabled"):
            decisions = autoscale.get("decisions") or []
            last = decisions[-1] if decisions else {}
            _out(f"autoscale: target {autoscale.get('target')}, "
                 f"{len(removed)} scaled-in, last decision "
                 f"{last.get('action', 'none')}"
                 + (f" ({last.get('reason')})" if last.get("reason")
                    else ""))
        return 1 if (down or burning) else 0
    if sub == "hotkeys":
        for k in payload.get("fleet") or []:
            _out(f"{k['key']:<32} {k['count']:>12.0f} "
                 f"(±{k['error']:.0f})")
        if not payload.get("fleet"):
            _out("No hot keys observed yet (the sketch fills from "
                 "query-path entity ids).")
        return 0
    if sub == "route":
        for b in payload.get("replicas") or []:
            _out(f"{b.get('replica', '?'):<24} {b.get('state', '?'):<9} "
                 f"inflight {b.get('inflight', 0):>4}  "
                 f"requests {b.get('requests', 0):>8}  "
                 f"failures {b.get('consecutiveFailures', 0)}")
        if args.key:
            _out(f"key {args.key!r} → {payload.get('affinity')} "
                 f"(preference: "
                 f"{', '.join(payload.get('preference') or [])})")
        ring = payload.get("ring") or {}
        _out(f"{len(payload.get('replicas') or [])} backend(s), "
             f"{ring.get('vnodes', '?')} vnodes each; retries "
             f"{payload.get('retries')}; spill "
             f"{(payload.get('spill') or {}).get('share')}")
        return 0
    if sub == "scale":
        _out(f"requested {payload.get('requested')} → target "
             f"{payload.get('target')} (clamped to policy bounds); the "
             f"control loop converges on its next tick.")
        return 0
    if args.id:
        trace = (payload or {}).get("trace")
        out_path = args.output or f"trace-{args.id[:12]}.json"
        with open(out_path, "w", encoding="utf-8") as f:
            json.dump(trace, f)
        n = len((trace or {}).get("traceEvents") or [])
        _out(f"Trace found on replica {(payload or {}).get('replica', '?')}"
             f"; wrote {n} trace events to {out_path}; load it at "
             f"https://ui.perfetto.dev.")
        return 0
    if args.slowest is not None:
        traces = (payload or {}).get("traces") or []
        if not traces:
            _out("No retained traces anywhere in the fleet yet.")
            return 0
        for t in traces:
            _out(f"{t.get('traceId')}  {t.get('durationMs', '?')}ms  "
                 f"replica={t.get('replica')}  status={t.get('status')}  "
                 f"reason={t.get('reason')}  {t.get('name', '')}")
        _out(f"Export one: fleet trace --id {traces[0]['traceId']} "
             f"--port {args.port}")
        return 0
    _out(json.dumps(payload, indent=2))
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


def cmd_status(args, storage: Storage) -> int:
    """Versions, the card (name and power limit), the kernel root and
    what is built there, a storage check, the release of each tracked
    engine and, with ``--ip``, the serving lineage of a live engine
    server. Without CUDA it fails unless ``--device cpu``."""
    import subprocess

    import torch

    from .ops import _build
    from .rollout import ReleaseRegistry
    from .utils.device import card_info

    _out(f"PredictionIO on PyTorch {__version__}")
    try:
        card = card_info(args.device)
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        _err(f"Device check failed: {e}")
        return 1
    _out(f"torch {torch.__version__} (CUDA {torch.version.cuda}); card: "
         f"{card['name']}, power limit {card['power_limit'] or 'n/a'}")
    built = _build.built()
    _out(f"Kernel root: {_build.root()}; built: "
         f"{', '.join(built) if built else '(none)'} of "
         f"{', '.join(_build.all_sources())}")
    try:
        storage.verify_all_data_objects()
    except Exception as e:  # noqa: BLE001 — report, don't traceback
        _err(f"Storage check failed: {e}")
        return 1
    _out("Storage: all data objects verified.")
    for engine_id, engine_version, engine_variant in sorted(
            ReleaseRegistry.list_tracked(storage)):
        st = ReleaseRegistry(storage, engine_id, engine_version,
                             engine_variant).state()
        line = (f"Release [{engine_id} v{engine_version}]: "
                f"stable={st.get('stable') or '(none)'}")
        if st.get("pinned"):
            line += f" pinned={st['pinned']}"
        if st.get("candidate"):
            line += (f" candidate={st['candidate']} "
                     f"({st.get('candidateMode')} at "
                     f"{float(st.get('fraction') or 0) * 100:.0f}%)")
        _out(line)
    if args.ip:
        try:
            payload = _server_call(args, "/status.json")
        except (OSError, ValueError) as e:
            _err(f"engine server at {args.ip}:{args.port} unreachable "
                 f"({_call_error(e)}); skipping lineage")
            payload = None
        mesh = (payload or {}).get("mesh") or {}
        if mesh:
            line = f"Mesh: mode {mesh.get('mode', '?')}"
            if mesh.get("meshShape"):
                line += ", mesh " + " x ".join(
                    f"{k}={v}" for k, v in mesh["meshShape"].items())
            if mesh.get("devices"):
                line += f", {mesh['devices']} device(s)"
            _out(line)
            for lane in mesh.get("lanes", ()):
                _out(f"  lane {lane['lane']} on {lane['device']}: "
                     f"{lane['dispatches']} dispatches, batch p50 "
                     f"{lane['batchP50Ms']} ms, p99 {lane['batchP99Ms']} ms")
        lin = (payload or {}).get("lineage") or {}
        if lin:
            _out(f"Serving [{payload.get('engineId', '?')}]: "
                 f"base {lin.get('baseInstanceId', '?')} "
                 f"+{lin.get('incrementalGeneration', 0)} fold-ins "
                 f"({lin.get('incrementalRows', 0)} rows), staleness "
                 f"{lin.get('stalenessSec', '?')}s"
                 + (", stream live" if lin.get("streaming") else "")
                 + f"; lifecycle {payload.get('lifecycle', '?')}")
    _out("(sleeping 0 seconds) Your system is all ready to go.")
    return 0


def cmd_template(args, storage: Storage) -> int:
    _out("Bundled engine templates (predictionio_tpu_torch.templates):")
    _out("  recommendation  — ALS top-N (module: predictionio_tpu_torch."
         "templates.recommendation:recommendation_engine)")
    _out("  classification  — naive Bayes / random forest (…"
         "classification:classification_engine)")
    _out("  similarproduct  — ALS cosine / cooccurrence / like (…"
         "similarproduct:similarproduct_engine)")
    _out("  ecommerce       — ALS + popularity + filters (…"
         "ecommerce:ecommerce_engine)")
    _out("  sequential      — self-attention next item (…"
         "sequential:sequential_engine)")
    return 0


def cmd_run(args, storage: Storage) -> int:
    """Call ``module.path:callable`` with the positional arguments and the
    storage installed as the process-wide one; print what it returns."""
    from .data.storage import registry

    fn = load_engine_factory(args.target)
    if not callable(fn):
        raise SystemExit(f"{args.target!r} is not callable")
    prior = registry._global
    registry.set_storage(storage)
    try:
        result = fn(*args.args)
        if result is not None:
            _out(str(result))
        return 0
    finally:
        registry.set_storage(prior)


def cmd_shell(args, storage: Storage) -> int:
    """An interactive Python shell with ``storage``, ``event_store``,
    ``p_event_store`` and ``Context`` preloaded (reads stdin)."""
    import code

    from .controller.context import Context
    from .data.store import EventStoreFacade
    from .pypio import PEventStore

    facade = EventStoreFacade(storage)
    ns = {"storage": storage, "event_store": facade,
          "p_event_store": PEventStore(facade), "Context": Context}
    code.interact(banner="PredictionIO on PyTorch shell. Preloaded: "
                         "storage, event_store, p_event_store, Context.",
                  local=ns, exitmsg="")
    return 0


#: the servers ``start-all`` runs, with their default ports, in order (the
#: storage server only with ``--with-storageserver``)
START_ALL = {"storageserver": 7077, "eventserver": 7070, "adminserver": 7071,
             "dashboard": 9000}


def _pid_dir(args) -> str:
    d = os.path.expanduser(args.pid_dir or os.environ.get("PIO_PID_DIR",
                                                          "~/.ptpu"))
    os.makedirs(d, exist_ok=True)
    return d


def _pid_alive(pid: int) -> bool:
    # reap the pid first if it is this process's child: kill(pid, 0)
    # succeeds on a zombie, which would read as alive forever when
    # start-all and stop-all share a process
    try:
        os.waitpid(pid, os.WNOHANG)
    except ChildProcessError:
        pass
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


def cmd_start_all(args, storage: Storage) -> int:
    """Start the event server, the admin server and the dashboard (with
    ``--with-storageserver``, the storage server first) as daemons
    (``python -m predictionio_tpu_torch.cli <name>`` in a session of
    their own, so they outlive this command), each with a pidfile and a
    log under ``--pid-dir``; wait until each answers its port."""
    import socket
    import subprocess

    d = _pid_dir(args)
    ports = {"eventserver": args.event_port, "adminserver": args.admin_port,
             "dashboard": args.dash_port,
             "storageserver": args.storage_port}
    started, failed = [], []
    for name, default_port in START_ALL.items():
        if name == "storageserver" and not args.with_storageserver:
            continue
        port = ports[name] or default_port
        pidfile = os.path.join(d, f"{name}.pid")
        if os.path.exists(pidfile):
            try:
                with open(pidfile) as f:
                    old = int(f.read().strip())
            except ValueError:
                old = -1
            if old > 0 and _pid_alive(old):
                _err(f"{name} already running (pid {old}, {pidfile}); "
                     f"run stop-all first")
                failed.append(name)
                continue
            os.unlink(pidfile)  # a dead process's pidfile
        cmd = [sys.executable, "-m", "predictionio_tpu_torch.cli", name,
               "--ip", args.ip, "--port", str(port)]
        if name == "storageserver" and args.storage_secret:
            cmd += ["--secret", args.storage_secret]
        log_path = os.path.join(d, f"{name}.log")
        with open(log_path, "ab") as log_f:
            proc = subprocess.Popen(cmd, stdout=log_f,
                                    stderr=subprocess.STDOUT,
                                    start_new_session=True)
        with open(pidfile, "w") as f:
            f.write(str(proc.pid))
        host = "127.0.0.1" if args.ip == "0.0.0.0" else args.ip
        deadline = time.monotonic() + args.start_timeout
        up = False
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                with socket.create_connection((host, port), timeout=1.0):
                    up = True
                    break
            except OSError:
                time.sleep(0.1)
        if up:
            # a foreign listener on the port answers too, while the child
            # dies on its bind a moment later
            time.sleep(0.3)
            up = proc.poll() is None
        if up:
            _out(f"{name}: up on port {port} (pid {proc.pid}, log "
                 f"{log_path})")
            started.append(name)
            continue
        _err(f"{name}: failed to come up on port {port} within "
             f"{args.start_timeout}s — see {log_path}")
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5)
        os.unlink(pidfile)
        failed.append(name)
    if failed:
        return 1
    _out(f"All servers up ({', '.join(started)}). `stop-all` stops them.")
    return 0


def cmd_stop_all(args, storage: Storage) -> int:
    """SIGTERM every server with a pidfile under ``--pid-dir``, SIGKILL
    one still alive after ``--stop-timeout``, and remove the pidfiles."""
    import signal

    d = _pid_dir(args)
    stopped = 0
    for name in START_ALL:
        pidfile = os.path.join(d, f"{name}.pid")
        if not os.path.exists(pidfile):
            continue
        try:
            with open(pidfile) as f:
                pid = int(f.read().strip())
        except ValueError:
            os.unlink(pidfile)
            continue
        if not _pid_alive(pid):
            _out(f"{name}: not running (stale pidfile)")
            os.unlink(pidfile)
            continue
        try:
            os.kill(pid, signal.SIGTERM)
        except ProcessLookupError:
            pass  # exited meanwhile
        except PermissionError:
            # we started our servers as this user: a pid we cannot signal
            # was recycled by another user's process
            _out(f"{name}: pid {pid} now belongs to a foreign process; "
                 f"dropping the stale pidfile")
            os.unlink(pidfile)
            continue
        deadline = time.monotonic() + args.stop_timeout
        while time.monotonic() < deadline and _pid_alive(pid):
            time.sleep(0.1)
        if _pid_alive(pid):
            _err(f"{name} (pid {pid}) ignored SIGTERM; killing")
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            deadline = time.monotonic() + 10.0
            while _pid_alive(pid) and time.monotonic() < deadline:
                time.sleep(0.05)
            if _pid_alive(pid):
                _err(f"{name} (pid {pid}) survived SIGKILL; leaving its "
                     f"pidfile")
                continue
        _out(f"{name}: stopped (pid {pid})")
        stopped += 1
        os.unlink(pidfile)
    if stopped == 0:
        _out("Nothing to stop.")
    return 0


def _serve(srv: AppServer, what: str, args, note: str = "") -> int:
    _out(f"{what} is listening at {srv.scheme}://{args.ip}:{srv.port}.")
    if note:
        _out(note)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        _out("Shutting down.")
    finally:
        srv.close()
    return 0


# -- parser -----------------------------------------------------------------

def cmd_check(args) -> int:
    """``check`` — the concurrency, lifecycle, host-sync and
    shared-memory static analysis of ``analysis/``, interprocedural over
    the scanned set (pure AST, no torch/storage import, and nothing of
    the scanned tree is executed: ``ops/smem.py``'s formulas are
    interpreted by ``analysis/interp.py``). Non-zero exit on findings — or, with ``--baseline``, on
    findings NOT in the baseline (which only ever ratchets down; see
    --baseline-grow). ``--format json|sarif`` for machines. Flags,
    output and exit codes are the JAX package's ``ptpu check``."""
    from .analysis import (
        RULES,
        findings_to_json,
        findings_to_sarif,
        load_baseline,
        new_findings,
        run_check,
        shrinkable_entries,
        write_baseline,
    )

    if args.list_rules:
        for name, rule in sorted(RULES.items()):
            _out(f"{name}: {rule.description}")
        return 0
    try:
        findings = run_check(args.paths or ["predictionio_tpu_torch"],
                             rule_names=args.rule or None)
    except ValueError as e:
        _err(str(e))
        return 2
    if args.write_baseline:
        if not args.baseline:
            _err("--write-baseline requires --baseline FILE")
            return 2
        cap = None
        if not args.baseline_grow and os.path.exists(args.baseline):
            try:
                cap = load_baseline(args.baseline)
            except (OSError, ValueError, KeyError, TypeError) as e:
                _err(f"ptpu check: cannot read baseline: {e}")
                return 2
        n = write_baseline(args.baseline, findings, cap=cap)
        _err(f"ptpu check: wrote {n} baseline entr"
             f"{'y' if n == 1 else 'ies'} "
             f"({len(findings)} finding(s)) to {args.baseline}"
             f"{' (ratchet: shrink-only)' if cap is not None else ''}.")
        if cap is not None:
            overflow = new_findings(findings, cap)
            if overflow:
                _err(f"ptpu check: {len(overflow)} finding(s) exceed "
                     f"the recorded baseline and were NOT absorbed "
                     f"(the baseline only ratchets down; fix them or "
                     f"re-record deliberately with --baseline-grow):")
                for f in overflow:
                    _err(f"  {f.format()}")
                return 1
        return 0
    gating = findings
    baselined = 0
    if args.baseline:
        try:
            baseline = load_baseline(args.baseline)
        except (OSError, ValueError, KeyError, TypeError) as e:
            _err(f"ptpu check: cannot read baseline: {e}")
            return 2
        gating = new_findings(findings, baseline)
        baselined = len(findings) - len(gating)
        shrinkable = shrinkable_entries(findings, baseline)
        if shrinkable:
            _err(f"ptpu check: {len(shrinkable)} baseline entr"
                 f"{'y is' if len(shrinkable) == 1 else 'ies are'} "
                 f"no longer fully reproduced — the baseline can "
                 f"ratchet down (re-run with --write-baseline):")
            for (path, rule, _msg), rec, act in shrinkable:
                _err(f"  {path}: {rule}: recorded {rec}, found {act}")
    if args.format == "json":
        _out(findings_to_json(gating))
    elif args.format == "sarif":
        _out(findings_to_sarif(gating, RULES))
    else:
        for f in gating:
            _out(f.format())
    suffix = (f" ({baselined} baselined finding(s) not counted)"
              if baselined else "")
    if gating:
        _err(f"ptpu check: {len(gating)} "
             f"{'new ' if args.baseline else ''}finding(s){suffix}. "
             f"Fix them or suppress with "
             f"'# ptpu: allow[rule] — justification'.")
        return 1
    if args.format == "text":
        _out(f"ptpu check: clean.{suffix}")
    return 0


def cmd_audit_lifecycle(args) -> int:
    """``audit-lifecycle`` — boot each subsystem (event / storage /
    engine servers, stream trainer, fleet aggregator, router autoscaler)
    on ``--device`` (the card unless ``cpu``), drive start→serve→stop
    cycles, snapshot ``/proc/self`` threads/fds/sockets around them and
    gate the leak census against the committed golden manifest
    (``analysis/lifecycle_baseline.json``) with shrink-only ratchet
    semantics. The static lifecycle rules catch the leaks the AST can
    see; this catches the ones only a running process shows. Non-zero
    exit on any leak above the recorded allowance (see --baseline-grow);
    exit 2 without the card unless ``--device cpu``. Flags, output and
    exit codes are the JAX package's ``ptpu audit-lifecycle``."""
    from .analysis import lifecycle_audit as la

    if args.list_entries:
        for name, (_b, desc) in la.ENTRY_POINTS.items():
            _out(f"{name}: {desc}")
        return 0
    try:
        manifest = la.run_audit(args.entry or None, cycles=args.cycles,
                                device=args.device)
    except la.AuditError as e:
        _err(f"ptpu audit-lifecycle: {e}")
        return 2
    baseline_path = args.baseline or la.DEFAULT_BASELINE
    if args.out:
        from .analysis.baseline import atomic_write_text

        atomic_write_text(
            args.out, json.dumps(manifest, indent=2, sort_keys=True) + "\n")
    if args.write_baseline:
        cap = None
        if not args.baseline_grow and os.path.exists(baseline_path):
            try:
                cap = la.load_manifest(baseline_path)
            except (OSError, ValueError) as e:
                _err(f"ptpu audit-lifecycle: cannot read baseline: {e}")
                return 2
        la.write_manifest(baseline_path, manifest, cap=cap)
        _err(f"ptpu audit-lifecycle: wrote "
             f"{len(manifest['entries'])} entry point(s) to "
             f"{baseline_path}"
             f"{' (ratchet: shrink-only)' if cap is not None else ''}.")
        if cap is not None:
            violations, _ = la.diff_manifests(manifest, cap)
            if violations:
                _err(f"ptpu audit-lifecycle: {len(violations)} "
                     f"leak(s) were NOT absorbed (the baseline only "
                     f"ratchets down; fix them or re-record "
                     f"deliberately with --baseline-grow):")
                for v in violations:
                    _err(f"  {v}")
                return 1
        return 0
    if args.format == "json":
        _out(json.dumps(manifest, indent=2, sort_keys=True))
    else:
        _out(la.format_text(manifest))
    if not os.path.exists(baseline_path):
        _err(f"ptpu audit-lifecycle: no baseline at {baseline_path} — "
             f"record one with --write-baseline (gate skipped).")
        return 0
    try:
        baseline = la.load_manifest(baseline_path)
    except (OSError, ValueError) as e:
        _err(f"ptpu audit-lifecycle: cannot read baseline: {e}")
        return 2
    if args.entry:
        # a subset run gates only the audited entries — the others
        # were not cycled, not "no longer reproduced"
        keep = set(args.entry)
        baseline = {**baseline,
                    "entries": {k: v
                                for k, v in baseline["entries"].items()
                                if k in keep}}
    violations, shrinkable = la.diff_manifests(manifest, baseline)
    if shrinkable:
        _err(f"ptpu audit-lifecycle: {len(shrinkable)} baseline entr"
             f"{'y is' if len(shrinkable) == 1 else 'ies are'} no "
             f"longer fully reproduced — ratchet down with "
             f"--write-baseline:")
        for s in shrinkable:
            _err(f"  {s}")
    if violations:
        _err(f"ptpu audit-lifecycle: {len(violations)} resource "
             f"leak(s) vs {baseline_path}:")
        for v in violations:
            _err(f"  {v}")
        return 1
    _err("ptpu audit-lifecycle: every start->stop cycle released its "
         "threads, fds and sockets.")
    return 0


def cmd_audit_numerics(args) -> int:
    """``audit-numerics`` — run the port's numeric entry points at small
    shapes on ``--device`` (the card unless ``cpu``; without CUDA it
    raises) under a ``TorchDispatchMode``, extract each one's dtype
    census (op counts, cast inventory, accumulation dtypes, bytes by
    dtype, kernel launches) and gate it against the platform's section
    of the committed golden manifest (``analysis/numerics_baseline.json``)
    with shrink-only ratchet semantics. The static dtype-flow rules catch
    the narrowings the AST can see; this catches the ones only a running
    entry shows. Non-zero exit on new casts / narrowed accumulators /
    grown bytes / kernels no longer launched (see --baseline-grow).
    Flags, output and exit codes are the JAX package's ``ptpu
    audit-numerics``, plus ``--device``."""
    from .analysis import numerics_audit as na

    if args.list_entries:
        for name, (_b, desc) in na.ENTRY_POINTS.items():
            _out(f"{name}: {desc}")
        return 0
    try:
        manifest = na.run_audit(args.entry or None, device=args.device)
    except na.AuditError as e:
        _err(f"ptpu audit-numerics: {e}")
        return 2
    platform = manifest["platform"]
    baseline_path = args.baseline or na.DEFAULT_BASELINE
    if args.out:
        from .analysis.baseline import atomic_write_text

        atomic_write_text(
            args.out, json.dumps(manifest, indent=2, sort_keys=True) + "\n")
    doc = None
    if os.path.exists(baseline_path):
        try:
            doc = na.load_manifest(baseline_path)
        except (OSError, ValueError) as e:
            _err(f"ptpu audit-numerics: cannot read baseline: {e}")
            return 2
    recorded = na.section(doc, platform) if doc is not None else None
    if args.write_baseline:
        cap = None if args.baseline_grow else recorded
        na.write_manifest(baseline_path, manifest, cap=cap)
        _err(f"ptpu audit-numerics: wrote "
             f"{len(manifest['entries'])} entry point(s) to the "
             f"{platform} section of {baseline_path}"
             f"{' (ratchet: shrink-only)' if cap is not None else ''}.")
        if cap is not None:
            violations, _ = na.diff_manifests(manifest, cap)
            if violations:
                _err(f"ptpu audit-numerics: {len(violations)} "
                     f"regression(s) were NOT absorbed (the baseline "
                     f"only ratchets down; fix them or re-record "
                     f"deliberately with --baseline-grow):")
                for v in violations:
                    _err(f"  {v}")
                return 1
        return 0
    if args.format == "json":
        _out(json.dumps(manifest, indent=2, sort_keys=True))
    else:
        _out(na.format_text(manifest))
    if recorded is None:
        _err(f"ptpu audit-numerics: no {platform} baseline at "
             f"{baseline_path} — record one with --write-baseline (gate "
             f"skipped).")
        return 0
    baseline = recorded
    if args.entry:
        # a subset run gates only the audited entries — the others
        # were not run, not "no longer reproduced"
        keep = set(args.entry)
        baseline = {**baseline,
                    "entries": {k: v
                                for k, v in baseline["entries"].items()
                                if k in keep}}
    violations, shrinkable = na.diff_manifests(manifest, baseline)
    if shrinkable:
        _err(f"ptpu audit-numerics: {len(shrinkable)} baseline entr"
             f"{'y is' if len(shrinkable) == 1 else 'ies are'} no "
             f"longer fully reproduced — ratchet down with "
             f"--write-baseline:")
        for s in shrinkable:
            _err(f"  {s}")
    if violations:
        _err(f"ptpu audit-numerics: {len(violations)} precision "
             f"regression(s) vs {baseline_path} ({platform}):")
        for v in violations:
            _err(f"  {v}")
        return 1
    _err(f"ptpu audit-numerics: the {platform} dtype census matches the "
         f"golden manifest.")
    return 0


def cmd_audit_hlo(args) -> int:
    """``audit-hlo`` — run the port's 8 mesh entry points at small shapes
    over 8 positions of ``--device`` (the card unless ``cpu``; without
    CUDA it raises), record each one's collective census (collective
    calls and their per-position result shapes, the joins between
    positions outside any collective, the peak bytes allocated) and gate
    it against the platform's section of the committed golden manifest
    (``analysis/hlo_baseline.json``) with shrink-only ratchet semantics.
    Non-zero exit on new collectives / joins / grown temps (see
    --baseline-grow). Flags, output and exit codes are the JAX package's
    ``ptpu audit-hlo``, plus ``--device``."""
    from .analysis import hlo_audit as ha

    if args.list_entries:
        for name, (_b, desc) in ha.ENTRY_POINTS.items():
            _out(f"{name}: {desc}")
        return 0
    try:
        manifest = ha.run_audit(args.entry or None, device=args.device)
    except ha.AuditError as e:
        _err(f"ptpu audit-hlo: {e}")
        return 2
    platform = manifest["platform"]
    baseline_path = args.baseline or ha.DEFAULT_BASELINE
    if args.out:
        from .analysis.baseline import atomic_write_text

        atomic_write_text(
            args.out, json.dumps(manifest, indent=2, sort_keys=True) + "\n")
    doc = None
    if os.path.exists(baseline_path):
        try:
            doc = ha.load_manifest(baseline_path)
        except (OSError, ValueError) as e:
            _err(f"ptpu audit-hlo: cannot read baseline: {e}")
            return 2
    recorded = ha.section(doc, platform) if doc is not None else None
    if args.write_baseline:
        cap = None if args.baseline_grow else recorded
        ha.write_manifest(baseline_path, manifest, cap=cap)
        _err(f"ptpu audit-hlo: wrote "
             f"{len(manifest['entries'])} entry point(s) to the "
             f"{platform} section of {baseline_path}"
             f"{' (ratchet: shrink-only)' if cap is not None else ''}.")
        if cap is not None:
            violations, _ = ha.diff_manifests(manifest, cap)
            if violations:
                _err(f"ptpu audit-hlo: {len(violations)} regression(s) "
                     f"were NOT absorbed (the baseline only ratchets "
                     f"down; fix them or re-record deliberately with "
                     f"--baseline-grow):")
                for v in violations:
                    _err(f"  {v}")
                return 1
        return 0
    if args.format == "json":
        _out(json.dumps(manifest, indent=2, sort_keys=True))
    else:
        _out(ha.format_text(manifest))
    if recorded is None:
        _err(f"ptpu audit-hlo: no {platform} baseline at {baseline_path} "
             f"— record one with --write-baseline (gate skipped).")
        return 0
    baseline = recorded
    if args.entry:
        # a subset run gates only the audited entries — the others were
        # not run, not "no longer reproduced"
        keep = set(args.entry)
        baseline = {**baseline,
                    "entries": {k: v
                                for k, v in baseline["entries"].items()
                                if k in keep}}
    violations, shrinkable = ha.diff_manifests(manifest, baseline)
    if shrinkable:
        _err(f"ptpu audit-hlo: {len(shrinkable)} baseline entr"
             f"{'y is' if len(shrinkable) == 1 else 'ies are'} no "
             f"longer fully reproduced — ratchet down with "
             f"--write-baseline:")
        for s in shrinkable:
            _err(f"  {s}")
    if violations:
        _err(f"ptpu audit-hlo: {len(violations)} collective/temp "
             f"regression(s) vs {baseline_path} ({platform}):")
        for v in violations:
            _err(f"  {v}")
        return 1
    _err(f"ptpu audit-hlo: the {platform} collective census matches the "
         f"golden manifest.")
    return 0


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
    s = app_sub.add_parser("show")
    s.add_argument("name")
    s = app_sub.add_parser("delete")
    s.add_argument("name")
    s.add_argument("-f", "--force", action="store_true")
    s = app_sub.add_parser("data-delete")
    s.add_argument("name")
    s.add_argument("--channel", default="")
    s.add_argument("-f", "--force", action="store_true")
    s = app_sub.add_parser("channel-new")
    s.add_argument("name")
    s.add_argument("channel")
    s = app_sub.add_parser("channel-delete")
    s.add_argument("name")
    s.add_argument("channel")
    s.add_argument("-f", "--force", action="store_true")

    sp = sub.add_parser("accesskey", help="manage access keys")
    ak_sub = sp.add_subparsers(dest="ak_command", required=True)
    s = ak_sub.add_parser("new")
    s.add_argument("app")
    s.add_argument("events", nargs="*")
    s.add_argument("--key", default="")
    s = ak_sub.add_parser("list")
    s.add_argument("--app", default="")
    s = ak_sub.add_parser("delete")
    s.add_argument("key")

    def tls_flags(sp):
        sp.add_argument("--cert", default="", help="PEM cert to serve HTTPS")
        sp.add_argument("--key", default="", help="PEM private key")

    def client_tls_flags(sp):
        sp.add_argument("--https", action="store_true",
                        help="the server was deployed with --cert/--key")
        sp.add_argument("--insecure", action="store_true",
                        help="skip TLS certificate verification (self-"
                             "signed local certificates only)")

    for name, port, ip, help_ in (
            ("eventserver", 7070, "0.0.0.0", "start the event server"),
            ("adminserver", 7071, "127.0.0.1", "start the admin API"),
            ("dashboard", 9000, "127.0.0.1",
             "start the evaluation dashboard")):
        s = sub.add_parser(name, help=help_)
        s.add_argument("--ip", default=ip)
        s.add_argument("--port", type=int, default=port)
        if name != "eventserver":
            s.add_argument("--accesskey", default="")
        else:
            s.add_argument("--stats", action="store_true",
                           help="keep per-app ingest counts on "
                                "/stats.json")
        tls_flags(s)

    s = sub.add_parser("storageserver",
                       help="serve storage to REMOTE-backend clients")
    s.add_argument("--ip", default="0.0.0.0")
    s.add_argument("--port", type=int, default=7077)
    s.add_argument("--secret", default="",
                   help="shared secret clients must send")
    tls_flags(s)

    s = sub.add_parser("start-all", help="start the event server, admin "
                                         "server and dashboard (and "
                                         "optionally the storage server) "
                                         "as daemons with pidfiles")
    s.add_argument("--ip", default="0.0.0.0")
    s.add_argument("--pid-dir", default="",
                   help="pidfile and log dir (default $PIO_PID_DIR or "
                        "~/.ptpu)")
    s.add_argument("--eventserver-port", dest="event_port", type=int,
                   default=0)
    s.add_argument("--adminserver-port", dest="admin_port", type=int,
                   default=0)
    s.add_argument("--dashboard-port", dest="dash_port", type=int,
                   default=0)
    s.add_argument("--with-storageserver", action="store_true",
                   help="also start the storage server of REMOTE clients")
    s.add_argument("--storageserver-port", dest="storage_port", type=int,
                   default=0)
    s.add_argument("--storage-secret", default="")
    s.add_argument("--start-timeout", type=float, default=30.0)

    s = sub.add_parser("stop-all", help="stop every start-all daemon")
    s.add_argument("--pid-dir", default="")
    s.add_argument("--stop-timeout", type=float, default=10.0)

    s = sub.add_parser("status", help="check the card, the kernels, the "
                                      "storage and the releases")
    s.add_argument("--ip", default="",
                   help="also read a live engine server's /status.json "
                        "for the serving lineage")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--device", default=None,
                   help="the device (default: the CUDA card)")
    client_tls_flags(s)

    for name, help_ in (("import", "import events from JSON lines"),
                        ("export", "export events to JSON lines")):
        s = sub.add_parser(name, help=help_)
        s.add_argument("--appid", type=int, default=0)
        s.add_argument("--app", default="")
        s.add_argument("--channel", default="")
        if name == "import":
            s.add_argument("--input", required=True)
        else:
            s.add_argument("--output", required=True)

    s = sub.add_parser("build", help="check the engine variant loads and "
                                     "build the kernel libraries")
    s.add_argument("--engine-json", default="engine.json")
    s.add_argument("--engine-id", default="")
    s.add_argument("--engine-version", default="")
    s.add_argument("--device", default=None,
                   help="cpu: check the variant only (the CPU runs no "
                        "kernel)")
    s.add_argument("--aot", action="store_true",
                   help="accepted for the JAX package's command line: the "
                        "port's kernels take any shape, so --aot builds "
                        "the same libraries")
    s.add_argument("--artifact-dir", default="",
                   help="kernel root is ARTIFACT_DIR/torch_kernels "
                        "(default $PTPU_ARTIFACT_DIR/torch_kernels, else "
                        "build/torch_kernels); deploy --artifact-dir with "
                        "the same dir loads from it")
    s.add_argument("--batching", action="store_true",
                   help="accepted for the JAX package's command line; the "
                        "libraries serve every batch size")
    s.add_argument("--max-batch", type=int, default=128,
                   help="accepted for the JAX package's command line; the "
                        "libraries serve every batch size")
    s.add_argument("--serving-mode", default="single",
                   choices=("auto", "single", "replicated", "sharded"),
                   help="serving placement the deploy will use (every "
                        "mode serves through the same fused_topk "
                        "library)")
    s.add_argument("--serving-quant", default="off",
                   choices=("off", "bf16", "int8"),
                   help="accepted for the JAX package's command line; "
                        "fused_topk serves every table type")
    s.add_argument("--serving-topk", default="auto",
                   choices=("auto", "einsum", "fused"),
                   help="accepted for the JAX package's command line; the "
                        "card serves k <= 128 through fused_topk")

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
        tls_flags(s)
        s.add_argument("--artifact-dir", default="",
                       help="load the kernels `build --artifact-dir` built "
                            "there (ARTIFACT_DIR/torch_kernels); a library "
                            "missing there is compiled at bind")
        s.add_argument("--serving-quant", default="off",
                       choices=("off", "bf16", "int8"))
        s.add_argument("--serving-topk", default="auto",
                       choices=("auto", "einsum", "fused"),
                       help="accepted for the JAX package's command "
                            "line; the card serves k <= 128 through "
                            "fused_topk")
        s.add_argument("--batching", action="store_true",
                       help="coalesce concurrent queries into batched "
                            "launches")
        s.add_argument("--max-batch", type=int, default=128,
                       help="max queries per coalesced launch (the warm "
                            "ladder runs every power of two up to it)")
        s.add_argument("--batch-window-ms", type=float, default=2.0,
                       help="wait for a lone query before serving it "
                            "solo")
        s.add_argument("--feedback", action="store_true",
                       help="record every answer as a predict event on "
                            "entity type pio_pr in --feedback-app-name "
                            "and put its prId into the answer")
        s.add_argument("--feedback-app-name", default="",
                       help="the app receiving feedback events")
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
                       help="app whose event log the trainer tails "
                            "(defaults to --feedback-app-name)")
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
        s.add_argument("--no-trace", action="store_true",
                       help="trace no request (every request is traced "
                            "by default; only slow, failed and shed "
                            "traces are kept)")
        s.add_argument("--trace-ring", type=int, default=512,
                       help="retained traces the flight recorder holds "
                            "(oldest evicted)")
        s.add_argument("--trace-slow-ms", type=float, default=0.0,
                       help="fixed slow-retention threshold in ms; 0 = "
                            "adaptive (the live p99 of traced requests)")
        s.add_argument("--access-log-sample", type=float, default=1.0,
                       help="share of successful requests written to the "
                            "JSON access log (errors and 503s always)")
        s.add_argument("--profile-dir", default="",
                       help="where POST /profile writes its captures "
                            "(default $PTPU_PROFILE_DIR or "
                            "<tmp>/ptpu-profiles)")
        s.add_argument("--hot-keys-k", type=int, default=128,
                       help="Space-Saving hot-key sketch capacity "
                            "(pio_hot_keys, /status.json hotKeys); 0 "
                            "disables it")
        s.add_argument("--cache", action="store_true",
                       help="serving cache hierarchy: query-result and "
                            "feature caches and the hot-entity tier "
                            "pinned on the card")
        s.add_argument("--cache-entries", type=int, default=8192,
                       help="query-result cache capacity (entries)")
        s.add_argument("--cache-ttl", type=float, default=30.0,
                       help="query-result staleness bound (seconds)")
        s.add_argument("--feature-ttl", type=float, default=5.0,
                       help="serving-time event-store read staleness "
                            "bound (seconds)")
        s.add_argument("--hot-entities", type=int, default=512,
                       help="hottest users whose rows stay pinned on the "
                            "card (0 off)")
        s.add_argument("--serving-mode", default="single",
                       choices=("auto", "single", "replicated", "sharded"),
                       help="mesh-wide serving: replicated = full model "
                            "copy per device, micro-batches fan out "
                            "per-device (~Nx qps); sharded = factor "
                            "tables row-sharded over the (batch, model) "
                            "mesh (models > one card's memory); auto = "
                            "sharded when the model exceeds the "
                            "per-device memory headroom, else replicated "
                            "(PTPU_TORCH_FORCE_DEVICE_COUNT=N serves N "
                            "devices on one card)")
        s.add_argument("--faults", default="",
                       help="fault-injection spec armed at start, for "
                            "failure drills, e.g. 'serving.dispatch="
                            "latency,delay_ms=400,times=1'; the "
                            "PTPU_FAULTS variable works on every server")
        s.add_argument("--debug-locks", action="store_true",
                       help="instrument every serving-stack lock: live "
                            "lock-order and re-entry detection, pio_lock_* "
                            "families, the deadlock watchdog "
                            "(PTPU_DEBUG_LOCKS=1 works too)")
        s.add_argument("--slo-specs", default="",
                       help="SLO spec file evaluated continuously against "
                            "the server's metrics (and, with --fleet-of, "
                            "the fleet's merged series); default: the "
                            "built-in availability, latency and freshness "
                            "objectives")
        s.add_argument("--slo-interval-ms", type=float, default=1000.0,
                       help="SLO evaluation tick; 0 turns the engine off")
        s.add_argument("--fleet-of", type=int, default=1,
                       help="deploy N replicas on consecutive ports from "
                            "--port (free ports with --port 0) behind the "
                            "query router and the fleet aggregator")
        s.add_argument("--fleet-port", type=int, default=8200,
                       help="port of the fleet aggregator (--fleet-of > 1)")
        s.add_argument("--fleet-scrape-interval-ms", type=float,
                       default=5000.0,
                       help="the aggregator's scrape cadence")
        s.add_argument("--router-port", type=int, default=8100,
                       help="port of the entity-affinity query router "
                            "(--fleet-of > 1): clients send /queries.json "
                            "there")
        s.add_argument("--autoscale", action="store_true",
                       help="run the SLO-driven autoscaler: out on a "
                            "fast-window burn or low capacity headroom, in "
                            "against the capacity model's knee")
        s.add_argument("--min-replicas", type=int, default=1,
                       help="autoscaler floor (--autoscale)")
        s.add_argument("--max-replicas", type=int, default=8,
                       help="autoscaler ceiling (--autoscale)")
        s.add_argument("--capacity", default="",
                       help="a measured capacity model (CAPACITY.json) "
                            "whose knee feeds the fleet headroom gauge and "
                            "the autoscaler; without one there is no "
                            "headroom")

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
        client_tls_flags(c)
        if name == "start":
            c.add_argument("--app", default="")
            c.add_argument("--channel", default="")
            c.add_argument("--consumer", default="")
            c.add_argument("--interval-ms", type=float, default=None)
            c.add_argument("--max-events", type=int, default=None)
            c.add_argument("--drift-threshold", type=float, default=None)
            c.add_argument("--canary-probes", type=int, default=None)

    s = sub.add_parser("cache", help="a running engine server's serving "
                                     "cache: per-tier stats, flush")
    cache_sub = s.add_subparsers(dest="cache_command", required=True)
    for name, help_ in (("stats", "per-tier hit/miss/eviction/"
                                  "invalidation stats"),
                        ("flush", "flush every cache tier")):
        c = cache_sub.add_parser(name, help=help_)
        c.add_argument("--ip", default="127.0.0.1")
        c.add_argument("--port", type=int, default=8000)
        c.add_argument("--accesskey", default="")
        client_tls_flags(c)

    s = sub.add_parser("undeploy", help="stop a deployed engine server")
    s.add_argument("--ip", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8000)
    client_tls_flags(s)

    s = sub.add_parser("trace", help="a running engine server's flight "
                                     "recorder: status, the slowest "
                                     "retained traces, or one as Perfetto "
                                     "JSON")
    s.add_argument("--ip", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8000)
    client_tls_flags(s)
    s.add_argument("--id", default="",
                   help="write this retained trace as Chrome/Perfetto "
                        "trace-event JSON")
    s.add_argument("--slowest", type=int, default=None,
                   help="list the N slowest retained traces")
    s.add_argument("-o", "--output", default="",
                   help="output file for --id (default "
                        "trace-<id>.json)")

    s = sub.add_parser("slo", help="service-level objectives: a running "
                                   "server's burn rates, or gate a "
                                   "capacity model against the committed "
                                   "specs")
    slo_sub = s.add_subparsers(dest="slo_command", required=True)
    c = slo_sub.add_parser("status", help="per-spec burn rates, budgets "
                                          "and breach state from GET "
                                          "/slo.json (exit 1 while "
                                          "burning)")
    c.add_argument("--ip", default="127.0.0.1")
    c.add_argument("--port", type=int, default=8000)
    c.add_argument("--accesskey", default="")
    client_tls_flags(c)
    c = slo_sub.add_parser("check", help="gate a CAPACITY.json against the "
                                         "committed spec file's capacity "
                                         "section")
    c.add_argument("--capacity", default="CAPACITY.json",
                   help="the measured capacity model")
    c.add_argument("--specs", default="slo/specs/ci.json",
                   help="committed SLO spec file with the capacity gates")
    c.add_argument("--update", action="store_true",
                   help="ratchet: tighten the committed gates toward a "
                        "better measurement (never loosens)")

    s = sub.add_parser("fleet", help="the fleet plane: run the aggregator "
                                     "that merges N replicas' metrics "
                                     "exactly, or query a running one")
    fleet_sub = s.add_subparsers(dest="fleet_command", required=True)
    c = fleet_sub.add_parser("serve", help="run the aggregator over "
                                           "--replicas")
    c.add_argument("--replicas", required=True,
                   help="comma-separated replica addresses (host:port or "
                        "URLs)")
    c.add_argument("--ip", default="0.0.0.0")
    c.add_argument("--port", type=int, default=8200)
    c.add_argument("--scrape-interval-ms", type=float, default=5000.0,
                   help="how often each replica's /metrics.json and "
                        "/status.json are pulled and merged")
    c.add_argument("--stale-after-ms", type=float, default=0.0,
                   help="a replica unscraped this long is DOWN (default: "
                        "3x the scrape interval)")
    c.add_argument("--slo-specs", default="",
                   help="SLO spec file evaluated against the MERGED "
                        "series; default: the built-in objectives")
    c.add_argument("--slo-interval-ms", type=float, default=1000.0,
                   help="fleet SLO evaluation tick; 0 turns it off")
    c.add_argument("--capacity", default="",
                   help="CAPACITY.json whose knee qps feeds "
                        "pio_fleet_capacity_headroom")
    c.add_argument("--hot-keys-k", type=int, default=128,
                   help="fleet-wide merged hot-key sketch capacity")
    c.add_argument("--timeout-sec", type=float, default=5.0,
                   help="per-replica scrape and fan-out timeout")
    c.add_argument("--accesskey", default="",
                   help="require ?accessKey= on POST /scrape, /scale and "
                        "/stop")
    tls_flags(c)
    for name, help_ in (
            ("status", "per-replica liveness, lag and flags and the "
                       "fleet's headroom (exit 1 on a down replica or a "
                       "burning fleet SLO)"),
            ("slo", "fleet SLO burn rates over the merged series"),
            ("trace", "cross-replica flight-recorder lookup"),
            ("hotkeys", "fleet-wide hot-key top-K"),
            ("route", "the query router: ring, backends, where --key "
                      "lands"),
            ("scale", "ask the autoscaler for a replica count (clamped "
                      "to --min/--max-replicas)")):
        c = fleet_sub.add_parser(name, help=help_)
        c.add_argument("--ip", default="127.0.0.1")
        c.add_argument("--port", type=int, default=8200)
        c.add_argument("--accesskey", default="")
        client_tls_flags(c)
        if name == "trace":
            c.add_argument("--id", default="",
                           help="find this trace on any replica and write "
                                "it as Perfetto JSON")
            c.add_argument("--slowest", type=int, default=None,
                           help="the fleet's N slowest retained traces")
            c.add_argument("-o", "--output", default="",
                           help="output file for --id")
        if name == "hotkeys":
            c.add_argument("--top", type=int, default=16,
                           help="keys to list")
        if name == "route":
            c.add_argument("--key", default="",
                           help="show where this entity id routes")
        if name == "scale":
            c.add_argument("--to", type=int, required=True,
                           help="desired replica count")
            c.add_argument("--reason", default="",
                           help="recorded in the decision log")

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
            client_tls_flags(sp)

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

    sub.add_parser("template", help="list the bundled engine templates")
    sub.add_parser("shell", help="interactive shell with the storage "
                                 "preloaded")
    s = sub.add_parser("run", help="run module.path:callable with the "
                                   "storage configured")
    s.add_argument("target")
    s.add_argument("args", nargs="*")
    sub.add_parser("version", help="print the version")
    s = sub.add_parser("check", help="concurrency, lifecycle, host-sync "
                       "and shared-memory static analysis, "
                       "interprocedural (lock-discipline, leaked-thread, "
                       "timeout, persist, queue, spin, retry, metric "
                       "catalog, smem-budget lints)")
    s.add_argument("paths", nargs="*",
                   help="files/dirs to check (default: "
                        "predictionio_tpu_torch)")
    s.add_argument("--rule", action="append", default=[],
                   help="run only the named rule (repeatable)")
    s.add_argument("--list-rules", action="store_true",
                   help="print the rule catalogue and exit")
    s.add_argument("--format", choices=("text", "json", "sarif"),
                   default="text",
                   help="output format (sarif for GitHub code-scanning "
                        "PR annotations)")
    s.add_argument("--baseline", default="",
                   help="baseline file: exit 1 only on findings NOT "
                        "recorded in it (legacy-debt burn-down)")
    s.add_argument("--write-baseline", action="store_true",
                   help="record current findings into --baseline FILE; "
                        "against an existing baseline this only "
                        "RATCHETS (removes/decrements entries) and "
                        "fails on findings beyond the recorded debt")
    s.add_argument("--baseline-grow", action="store_true",
                   help="with --write-baseline: allow recording NEW "
                        "debt (e.g. when enabling a rule) instead of "
                        "the default shrink-only ratchet")

    s = sub.add_parser("audit-lifecycle", help="boot each subsystem, "
                       "drive start->serve->stop cycles, snapshot "
                       "/proc threads/fds/sockets around them and "
                       "gate the leak census against the committed "
                       "golden manifest (the runtime complement of "
                       "the ptpu check lifecycle rules)")
    s.add_argument("--entry", action="append", default=[],
                   help="audit only the named entry point (repeatable)")
    s.add_argument("--list-entries", action="store_true",
                   help="print the entry-point catalogue and exit")
    s.add_argument("--cycles", type=int, default=3,
                   help="measured start->stop cycles per entry "
                        "(default 3; one extra warmup cycle always "
                        "runs unmeasured)")
    s.add_argument("--format", choices=("text", "json"), default="text",
                   help="output format for the fresh manifest")
    s.add_argument("--out", default="",
                   help="also write the fresh manifest JSON to FILE "
                        "(the CI artifact)")
    s.add_argument("--baseline", default="",
                   help="golden manifest to gate against (default: the "
                        "committed analysis/lifecycle_baseline.json)")
    s.add_argument("--write-baseline", action="store_true",
                   help="record the fresh manifest as the baseline; "
                        "against an existing one this only RATCHETS "
                        "(shrinks the allowed leaks) and fails on "
                        "growth")
    s.add_argument("--baseline-grow", action="store_true",
                   help="with --write-baseline: allow recording new "
                        "entries / larger allowances (deliberate "
                        "daemon changes) instead of the shrink-only "
                        "ratchet")
    s.add_argument("--device", default=None,
                   help="the device the entries train, serve and fold in "
                        "on (default: the CUDA card)")

    s = sub.add_parser("audit-numerics", help="run the numeric entry "
                       "points at small shapes under a TorchDispatchMode "
                       "and diff the dtype census (casts, accumulation "
                       "dtypes, bytes, kernel launches) against the "
                       "platform's section of the committed golden "
                       "manifest (the runtime complement of the ptpu "
                       "check dtype-flow rules)")
    s.add_argument("--entry", action="append", default=[],
                   help="audit only the named entry point (repeatable)")
    s.add_argument("--list-entries", action="store_true",
                   help="print the entry-point catalogue and exit")
    s.add_argument("--format", choices=("text", "json"), default="text",
                   help="output format for the fresh manifest")
    s.add_argument("--out", default="",
                   help="also write the fresh manifest JSON to FILE "
                        "(the CI artifact)")
    s.add_argument("--baseline", default="",
                   help="golden manifest to gate against (default: the "
                        "committed analysis/numerics_baseline.json)")
    s.add_argument("--write-baseline", action="store_true",
                   help="record the fresh manifest as its platform's "
                        "section of the baseline; against an existing "
                        "section this only RATCHETS (shrinks "
                        "counts/bytes) and fails on growth")
    s.add_argument("--baseline-grow", action="store_true",
                   help="with --write-baseline: allow recording new "
                        "casts/entries (deliberate precision changes) "
                        "instead of the shrink-only ratchet")
    s.add_argument("--device", default=None,
                   help="the device the entries run on (default: the "
                        "CUDA card; cpu runs the kernels' plain "
                        "versions)")

    s = sub.add_parser("audit-hlo", help="run the 8 mesh entry points over "
                       "8 positions at small shapes and diff their "
                       "collective census (collective calls and shapes, "
                       "joins between positions outside any collective, "
                       "temp bytes) against the platform's section of "
                       "the committed golden manifest")
    s.add_argument("--entry", action="append", default=[],
                   help="audit only the named entry point (repeatable)")
    s.add_argument("--list-entries", action="store_true",
                   help="print the entry-point catalogue and exit")
    s.add_argument("--format", choices=("text", "json"), default="text",
                   help="output format for the fresh manifest")
    s.add_argument("--out", default="",
                   help="also write the fresh manifest JSON to FILE "
                        "(the CI artifact)")
    s.add_argument("--baseline", default="",
                   help="golden manifest to gate against (default: the "
                        "committed analysis/hlo_baseline.json)")
    s.add_argument("--write-baseline", action="store_true",
                   help="record the fresh manifest as its platform's "
                        "section of the baseline; against an existing "
                        "section this only RATCHETS (shrinks "
                        "counts/temps) and fails on growth")
    s.add_argument("--baseline-grow", action="store_true",
                   help="with --write-baseline: allow recording new "
                        "collectives/joins/entries (deliberate schedule "
                        "changes) instead of the shrink-only ratchet")
    s.add_argument("--device", default=None,
                   help="the device the entries run on (default: the "
                        "CUDA card; cpu runs the kernels' plain "
                        "versions)")
    return p


COMMANDS = {
    "app": cmd_app,
    "accesskey": cmd_accesskey,
    "build": cmd_build,
    "import": cmd_import,
    "export": cmd_export,
    "train": cmd_train,
    "batchpredict": cmd_batchpredict,
    "eval": cmd_eval,
    "undeploy": cmd_undeploy,
    "release": cmd_release,
    "status": cmd_status,
    "template": cmd_template,
    "run": cmd_run,
    "shell": cmd_shell,
    "start-all": cmd_start_all,
    "stop-all": cmd_stop_all,
}

#: the long-running servers: what builds each, and its banner name
SERVERS = {
    "eventserver": (build_eventserver, "Event Server"),
    "adminserver": (build_adminserver, "Admin server"),
    "dashboard": (build_dashboard, "Dashboard"),
    "storageserver": (build_storageserver, "Storage Server"),
}


def main(argv: Optional[List[str]] = None,
         storage: Optional[Storage] = None) -> int:
    args = _parser().parse_args(argv)
    if args.command == "version":
        _out(__version__)
        return 0
    if args.command == "check":
        # pure-AST lint: needs neither storage nor torch
        return cmd_check(args)
    if args.command == "audit-lifecycle":
        # boots its own in-memory storages on the card (or the CPU)
        return cmd_audit_lifecycle(args)
    if args.command == "audit-numerics":
        # small in-memory inputs on the card (or the CPU); no storage
        return cmd_audit_numerics(args)
    if args.command == "audit-hlo":
        # small in-memory inputs over 8 positions of the card (or the
        # CPU); no storage
        return cmd_audit_hlo(args)
    if args.command == "stream":
        return cmd_stream(args)
    if args.command == "trace":
        return cmd_trace(args)
    if args.command == "cache":
        return cmd_cache(args)
    if args.command == "slo":
        return cmd_slo(args)
    if args.command == "fleet":
        return cmd_fleet(args)
    if os.environ.get("PIO_COORDINATOR") \
            or os.environ.get("PIO_NUM_PROCESSES"):
        # join the process group before any device use; CPU tensors
        # travel only over gloo, so --device cpu names it
        from .parallel.multihost import initialize_distributed, shutdown

        initialize_distributed(
            backend="gloo" if getattr(args, "device", None) == "cpu"
            and not os.environ.get("PIO_DIST_BACKEND") else None)
        try:
            return _run(args, storage)
        finally:
            shutdown()
    return _run(args, storage)


def _run(args, storage: Optional[Storage]) -> int:
    """The commands that read storage (and maybe the device)."""
    from .data.storage.registry import get_storage

    storage = storage if storage is not None else get_storage()
    if args.command in COMMANDS:
        return COMMANDS[args.command](args, storage)
    if args.command in SERVERS:
        build, what = SERVERS[args.command]
        note = ("Per-app /stats.json is OFF (enable with --stats); "
                "aggregate telemetry is always on at /metrics."
                if args.command == "eventserver" and not args.stats
                else "")
        return _serve(build(args, storage), what, args, note)
    if args.fleet_of > 1:
        return cmd_deploy_fleet(args, storage)
    srv = build_deploy(args, storage)
    return _serve(srv, f"Engine server ({srv.app.name})", args)


if __name__ == "__main__":
    sys.exit(main())
