"""Engine server: deployed-model query serving on the card (the port of the
serving core of ``predictionio_tpu/server/engineserver.py``).

``POST /queries.json`` parses the query into the template's query class,
runs supplement, per-algorithm predict and serve, and returns the result
as JSON. At bind a model is row-quantized if asked (behind the
template's parity probe) and then placed on the serving device once.
With ``batching`` on, concurrent queries coalesce in a
:class:`MicroBatcher` into one batched top-k launch. ``GET /status.json``
names the card, the quantization in force and the kernel's launch
count; ``POST /stop`` shuts the server down.

:func:`deploy` is the ``pio deploy`` flow: it binds the latest COMPLETED
engine instance of an engine id, version and variant from the context's
storage. :func:`deploy_models` binds models the caller already holds.

Streaming fold-in: with ``ServerConfig.streaming`` (or ``POST
/stream/start``) a :class:`~predictionio_tpu_torch.streaming.StreamTrainer`
tails an app's event log and hot-swaps folded models into the binding
(:meth:`QueryServer.apply_stream_delta`); ``GET /stream.json`` shows it,
``POST /stream/stop`` stops it. It needs the storage a :func:`deploy`
binds from.

Left out (``ROADMAP.md`` queue 1): the release registry (pinned
releases, promote, rollback, ``/reload``), so deploy never reads a pin;
the serving caches, so a fold-in invalidates no cached answer.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, List, Optional

from ..controller.context import Context
from ..controller.engine import Engine
from ..controller.params import EngineParams
from ..data.storage.base import EngineInstance
from ..models.als import SERVING_QUANT_MODES, serving_quant_of
from ..ops import fused_topk as _fused_topk
from ..utils.device import card_info, resolve_device
from ..utils.jsonutil import from_jsonable, to_jsonable
from .http import AppServer, HTTPApp, HTTPError, Request, Response, json_response

log = logging.getLogger(__name__)

#: batcher threads draining the query queue: while one waits for its
#: batch's results, the next forms and launches a batch
_DRAINERS = 2


@dataclass
class ServerConfig:
    """Serving knobs (a subset of the JAX package's ``ServerConfig``)."""

    #: coalesce concurrent queries into one batched launch
    batching: bool = False
    #: most queries one batch takes
    max_batch: int = 128
    #: how long a lone query waits for company before it serves alone
    batch_window_ms: float = 2.0
    #: "int8" or "bf16" row-quantized serving tables, or "off" (f32);
    #: the template's parity probe may keep f32 (auto-off)
    serving_quant: str = "off"
    #: serving device; None is the CUDA card, "cpu" the plain versions
    device: Optional[str] = None
    #: start a streaming trainer with the deploy: it tails
    #: ``stream_app_name``'s event log and folds fresh events into the
    #: bound ALS model (``POST /stream/start`` attaches one later)
    streaming: bool = False
    #: app whose event log the trainer tails (required when streaming)
    stream_app_name: Optional[str] = None
    #: poll interval between fold-in passes; in-process ingest wakes the
    #: trainer at once through the invalidation bus
    stream_interval_ms: float = 500.0
    #: events per fold-in micro-batch
    stream_max_events: int = 2048
    #: durable cursor identity
    stream_consumer: str = "stream-trainer"
    #: DriftMonitor retrain trigger
    stream_drift_threshold: float = 1.0
    #: touched-entity probes per fold-in canary check (0 disables)
    stream_canary_probes: int = 8


class QueryServer:
    """One deployed engine: algorithms, bound models and serving."""

    def __init__(self, engine: Engine, engine_params: EngineParams,
                 models: List[Any], config: Optional[ServerConfig] = None,
                 instance: Optional[EngineInstance] = None,
                 ctx: Optional[Context] = None):
        self.engine = engine
        #: the engine instance the models came from (None: handed in)
        self.instance = instance
        #: the deploy's context: its storage is what a stream trainer
        #: tails (None for models handed in)
        self.ctx = ctx
        self.config = config or ServerConfig()
        if self.config.serving_quant not in SERVING_QUANT_MODES:
            raise ValueError(
                f"serving_quant must be one of {SERVING_QUANT_MODES}, "
                f"got {self.config.serving_quant!r}")
        self.device = resolve_device(self.config.device)
        self.card = card_info(self.device)
        self._lock = threading.Lock()
        self.request_count = 0
        self._binds = 0
        self.stream = None
        self._bind(engine_params, models)
        self.batcher: Optional[MicroBatcher] = None
        if self.config.batching:
            self.batcher = MicroBatcher(self, self.config.batch_window_ms,
                                        self.config.max_batch)
        if self.config.streaming:
            try:
                self.start_stream()
            except BaseException:
                self.close()
                raise

    def _bind(self, engine_params: EngineParams, models: List[Any]) -> None:
        """Bind: quantize (if asked), then place every model on the
        serving device once — no query moves a table."""
        algorithms = self.engine.make_algorithms(engine_params)
        if len(models) != len(algorithms):
            raise ValueError(f"{len(models)} models for "
                             f"{len(algorithms)} algorithms")
        quant = self.config.serving_quant
        if quant != "off":
            models = [a.quantize_serving_model(m, quant)
                      if hasattr(a, "quantize_serving_model") else m
                      for a, m in zip(algorithms, models)]
        models = [a.prepare_serving_model(m, self.device)
                  for a, m in zip(algorithms, models)]
        serving = self.engine.make_serving(engine_params)
        with self._lock:
            self.engine_params = engine_params
            self.algorithms, self.models, self.serving = \
                algorithms, models, serving
            # what a fold-in in flight re-checks: the instance id, or a
            # token of this bind where models were handed in, so that a
            # second bind voids it either way
            self._binds += 1
            self.binding_id = (self.instance.id if self.instance
                               else f"bind-{self._binds}")
            # stream lineage: a bind starts a fresh base
            self._stream_generation = 0
            self._stream_rows = 0
            self._stream_last_apply: Optional[float] = None
            self._stream_base_bound_at = time.time()

    def _binding(self):
        with self._lock:
            return self.algorithms, self.models, self.serving

    def _count(self, n: int) -> None:
        with self._lock:
            self.request_count += n

    def serve(self, query_json: Any) -> Any:
        """The ``/queries.json`` entry: the micro-batcher when batching,
        else the per-query path. Raises :class:`HTTPError`."""
        if self.batcher is not None:
            result = self.batcher.submit(query_json)
            if isinstance(result, HTTPError):
                raise result
            return result
        return self.query(query_json)

    def query(self, query_json: Any) -> Any:
        """One query: parse, supplement, predict with every algorithm,
        serve, and render JSON."""
        algorithms, models, serving = self._binding()
        try:
            query = from_jsonable(algorithms[0].query_class, query_json)
        except (TypeError, ValueError) as e:
            raise HTTPError(400, str(e)) from e
        supplemented = serving.supplement(query)
        predictions = [a.predict(m, supplemented)
                       for a, m in zip(algorithms, models)]
        result = to_jsonable(serving.serve(query, predictions))
        self._count(1)
        return result

    def query_batch(self, query_jsons: List[Any]) -> List[Any]:
        """Serve many queries with ONE batched launch per algorithm.
        A query that fails to parse gets its own 400; the other slots
        are unaffected."""
        algorithms, models, serving = self._binding()
        out: List[Any] = [None] * len(query_jsons)
        parsed, rows = [], []
        for i, qj in enumerate(query_jsons):
            try:
                parsed.append(from_jsonable(algorithms[0].query_class, qj))
                rows.append(i)
            except (TypeError, ValueError) as e:
                out[i] = HTTPError(400, str(e))
        if parsed:
            supplemented = [serving.supplement(q) for q in parsed]
            per_algo = [a.batch_predict(m, supplemented)
                        for a, m in zip(algorithms, models)]
            for j, i in enumerate(rows):
                out[i] = to_jsonable(serving.serve(
                    parsed[j], [preds[j] for preds in per_algo]))
        self._count(len(rows))
        return out

    def status(self) -> dict:
        _, models, _ = self._binding()
        return {
            "status": "alive",
            "device": str(self.device),
            "card": self.card["name"],
            "powerLimit": self.card["power_limit"],
            "servingQuant": serving_quant_of(models[0]) if models else "off",
            "servingQuantRequested": self.config.serving_quant,
            "batching": self.config.batching,
            "kernels": {"fused_topk": {
                "launches": _fused_topk.LAUNCHES}},
            "requestCount": self.request_count,
            "engineInstanceId": self.instance.id if self.instance else None,
            "lineage": self.stream_lineage(),
            "stream": (self.stream.status() if self.stream is not None
                       else {"running": False}),
        }

    def close(self, timeout: float = 5.0) -> None:
        """Stop the stream trainer and the batcher's threads (queued
        queries still serve), joining each. Idempotent."""
        self.stop_stream()
        if self.batcher is not None:
            self.batcher.close(timeout)

    # -- streaming fold-in ---------------------------------------------------
    @property
    def storage(self):
        """The storage the deploy bound from: what a stream trainer
        tails. Models handed in (:func:`deploy_models`) have none."""
        if self.ctx is None:
            raise ValueError(
                "streaming needs the storage the models came from: deploy "
                "from storage (deploy / the deploy command), not "
                "deploy_models")
        return self.ctx.storage

    def stream_snapshot(self, algo_index: int = 0):
        """The stream trainer's read side: ``(binding_id, model)`` of the
        current binding, taken together under the lock, or None where the
        model is not foldable (no id maps: not an ALS factor model). The
        apply re-checks the id."""
        with self._lock:
            if not 0 <= algo_index < len(self.models):
                return None
            model = self.models[algo_index]
            binding_id = self.binding_id
        if getattr(model, "user_ids", None) is None \
                or getattr(model, "item_ids", None) is None:
            return None
        return binding_id, model

    def apply_stream_delta(self, algo_index: int, new_model: Any,
                           touched_entities: List[str],
                           base_instance_id: str,
                           rows_updated: int = 0,
                           rows_inserted: int = 0) -> bool:
        """Hot-swap a fold-in delta: rebind ``models[algo_index]`` to the
        folded model, whose tables are new tensors (the old model keeps
        serving any batch in flight). Under the lock the base binding id
        is re-checked: a rebind that raced the fold-in wins and this
        returns False (the trainer's unadvanced cursor re-folds against
        the new base). ``touched_entities`` is what a serving cache
        would invalidate; the port has none yet."""
        with self._lock:
            if self.binding_id != base_instance_id:
                return False
            if not 0 <= algo_index < len(self.models):
                return False
            self.models = list(self.models)
            self.models[algo_index] = new_model
            self._stream_generation += 1
            self._stream_rows += int(rows_updated) + int(rows_inserted)
            self._stream_last_apply = time.time()
        return True

    def start_stream(self, config=None):
        """Attach and start the stream trainer. ``config`` is a
        :class:`~predictionio_tpu_torch.streaming.StreamConfig`; None
        builds one from the ``ServerConfig.stream_*`` knobs. Raises
        ``ValueError`` on a missing app or storage (a streaming deploy
        fails fast) and ``HTTPError`` 409 when one is already running."""
        from ..streaming import StreamConfig, StreamTrainer

        with self._lock:
            if self.stream is not None and self.stream.running:
                raise HTTPError(
                    409, f"streaming trainer already running (consumer "
                         f"{self.stream.config.consumer!r}); stop it "
                         f"first")
        cfg = config or StreamConfig(
            interval_ms=self.config.stream_interval_ms,
            max_events=self.config.stream_max_events,
            consumer=self.config.stream_consumer,
            drift_threshold=self.config.stream_drift_threshold,
            canary_probes=self.config.stream_canary_probes)
        if not cfg.app_name:
            cfg.app_name = self.config.stream_app_name or ""
        if not cfg.app_name:
            raise ValueError(
                "streaming requires an app name (ServerConfig."
                "stream_app_name, --stream-app, or the request's "
                "appName): the app whose event log the trainer tails")
        trainer = StreamTrainer(self, cfg)
        with self._lock:
            self.stream = trainer
        trainer.start()
        log.info("streaming trainer started (app %s, consumer %s)",
                 cfg.app_name, cfg.consumer)
        return trainer

    def stop_stream(self, timeout: float = 10.0) -> bool:
        """Stop, join and detach the stream trainer; False when none is
        attached. The durable cursor stays in the event store: a later
        start with the same consumer resumes exactly where this one
        stopped."""
        with self._lock:
            trainer = self.stream
            self.stream = None
        if trainer is None:
            return False
        trainer.stop(timeout=timeout)
        return True

    def stream_lineage(self) -> dict:
        """What blend of batch and stream is serving: the base binding,
        how many fold-in generations sit on top of it, and how stale the
        serving model is (seconds since it last absorbed data: the last
        fold-in, else the base instance's end time, else the bind)."""
        with self._lock:
            base_id = self.binding_id
            gen = self._stream_generation
            rows = self._stream_rows
            last = self._stream_last_apply
            bound = self._stream_base_bound_at
            trainer = self.stream
        now = time.time()
        trained = getattr(self.instance, "end_time", None)
        if last is not None:
            staleness = now - last
        elif trained is not None:
            try:
                staleness = max(0.0, now - trained.timestamp())
            except (OSError, OverflowError, ValueError):
                staleness = now - bound
        else:
            staleness = now - bound
        return {
            "baseInstanceId": base_id,
            "incrementalGeneration": gen,
            "incrementalRows": rows,
            "lastFoldInSecAgo": (round(now - last, 3)
                                 if last is not None else None),
            "stalenessSec": round(staleness, 3),
            "streaming": trainer is not None and trainer.running,
        }


class _Submit:
    """One caller's queue entry: the query and its completion slot."""

    __slots__ = ("query_json", "done", "result")

    def __init__(self, query_json: Any):
        self.query_json = query_json
        self.done = threading.Event()
        self.result: Any = None


#: close sentinel: each drainer consumes exactly one and exits
_CLOSE = object()


class MicroBatcher:
    """Coalesces concurrent queries into one batched launch.

    Each HTTP worker thread enqueues its query and blocks; drainer
    threads take everything queued (up to ``max_batch``) and run
    :meth:`QueryServer.query_batch`. A lone query waits ``window_ms``
    once for company, so a burst coalesces while a single query is
    delayed by at most the window."""

    def __init__(self, server: QueryServer, window_ms: float = 2.0,
                 max_batch: int = 128):
        self.server = server
        self.window = max(window_ms, 0.0) / 1000.0
        self.max_batch = max(max_batch, 1)
        # depth is bounded by the HTTP threads blocked on their entries
        self._q: "queue.Queue" = queue.Queue()
        self._threads = [
            threading.Thread(target=self._drain, daemon=True,
                             name=f"query-microbatcher-{i}")
            for i in range(_DRAINERS)]
        for t in self._threads:
            t.start()

    def submit(self, query_json: Any) -> Any:
        e = _Submit(query_json)
        self._q.put(e)
        e.done.wait()
        return e.result

    def close(self, timeout: float = 5.0) -> None:
        """Stop the drainers: one close sentinel per live drainer, then
        join. Work queued ahead of the sentinels still serves, so no
        caller is stranded. Idempotent."""
        live = [t for t in self._threads if t.is_alive()]
        for _ in live:
            self._q.put(_CLOSE)
        deadline = time.monotonic() + timeout
        for t in live:
            t.join(timeout=max(0.0, deadline - time.monotonic()))

    def _form_batch(self, first: _Submit) -> List[_Submit]:
        """Everything already queued, up to ``max_batch``; a lone query
        waits the window once for a concurrent arrival."""
        batch = [first]
        waited = False
        while len(batch) < self.max_batch:
            try:
                nxt = self._q.get_nowait()
            except queue.Empty:
                if waited or len(batch) > 1 or self.window <= 0:
                    break
                waited = True
                try:
                    nxt = self._q.get(timeout=self.window)
                except queue.Empty:
                    break
            if nxt is _CLOSE:
                self._q.put(nxt)  # a sibling's sentinel: hand it back
                break
            batch.append(nxt)
        return batch

    def _drain(self) -> None:
        while True:
            first = self._q.get()
            if first is _CLOSE:
                return
            batch = self._form_batch(first)
            try:
                results = self.server.query_batch(
                    [e.query_json for e in batch])
            except Exception as exc:  # noqa: BLE001 — fail the batch, keep draining
                log.exception("batched query failed")
                results = [HTTPError(500, str(exc))] * len(batch)
            for e, result in zip(batch, results):
                e.result = result
                e.done.set()


def build_app(server: QueryServer) -> HTTPApp:
    app = HTTPApp("engineserver")
    app_server_ref: List[AppServer] = []

    @app.route("POST", "/queries.json")
    def queries(req: Request) -> Response:
        try:
            query_json = req.json()
        except (ValueError, UnicodeDecodeError) as e:
            raise HTTPError(400, str(e)) from e
        return json_response(server.serve(query_json))

    @app.route("GET", "/status.json")
    def status(req: Request) -> Response:
        return json_response(server.status())

    @app.route("GET", "/stream.json")
    def stream_json(req: Request) -> Response:
        """The stream trainer's state and the model lineage."""
        trainer = server.stream
        if trainer is None:
            return json_response({
                "running": False,
                "lineage": server.stream_lineage(),
                "hint": "POST /stream/start {\"appName\": ...} (or "
                        "deploy with --stream) to attach the "
                        "incremental trainer"})
        return json_response({**trainer.status(),
                              "lineage": server.stream_lineage()})

    @app.route("POST", "/stream/start")
    def stream_start(req: Request) -> Response:
        """Attach the stream trainer to this live server: ``{"appName",
        "channelName", "intervalMs", "maxEvents", "consumer",
        "driftThreshold", "canaryProbes"}``, every field optional where
        the deploy's config names the app. 409 when one is running."""
        from ..streaming import StreamConfig

        cfg = server.config
        try:
            body = req.json() or {}
        except (ValueError, UnicodeDecodeError):
            body = {}
        try:
            scfg = StreamConfig(
                app_name=str(body.get("appName")
                             or cfg.stream_app_name or ""),
                channel_name=body.get("channelName") or None,
                consumer=str(body.get("consumer") or cfg.stream_consumer),
                interval_ms=float(body.get("intervalMs",
                                           cfg.stream_interval_ms)),
                max_events=int(body.get("maxEvents",
                                        cfg.stream_max_events)),
                drift_threshold=float(body.get(
                    "driftThreshold", cfg.stream_drift_threshold)),
                canary_probes=int(body.get("canaryProbes",
                                           cfg.stream_canary_probes)))
            trainer = server.start_stream(scfg)
        except (TypeError, ValueError) as e:
            raise HTTPError(400, str(e))
        return json_response({"message": "Streaming trainer started.",
                              "stream": trainer.status()})

    @app.route("POST", "/stream/stop")
    def stream_stop(req: Request) -> Response:
        if not server.stop_stream():
            raise HTTPError(409, "no streaming trainer is running")
        return json_response({"message": "Streaming trainer stopped."})

    @app.route("POST", "/stop")
    def stop(req: Request) -> Response:
        def delayed_shutdown():
            # let THIS response flush before the listener goes down
            time.sleep(0.25)
            app_server_ref[0].close()

        threading.Thread(target=delayed_shutdown, daemon=True,
                         name="engineserver-stop").start()
        return json_response({"message": "Shutting down..."})

    app._server_ref = app_server_ref  # type: ignore[attr-defined]
    return app


def create_engine_server(server: QueryServer, host: str = "0.0.0.0",
                         port: int = 8000) -> AppServer:
    """Bind the engine server's HTTP app; closing it closes the server."""
    app = build_app(server)
    srv = AppServer(app, host, port)
    srv.query_server = server  # the binding behind the routes
    srv.on_close(server.close)
    app._server_ref.append(srv)  # type: ignore[attr-defined]
    return srv


def deploy_models(engine: Engine, engine_params: EngineParams,
                  models: List[Any], config: Optional[ServerConfig] = None,
                  host: str = "0.0.0.0", port: int = 8000) -> AppServer:
    """Bind ``models`` (quantize, place on the device) and return the
    engine server, not yet serving: call ``start_background()`` or
    ``serve_forever()`` on it."""
    server = QueryServer(engine, engine_params, models, config)
    return create_engine_server(server, host, port)


def deploy(ctx: Context, engine: Engine, engine_params: EngineParams,
           engine_id: str = "default", engine_version: str = "1",
           engine_variant: str = "engine.json",
           config: Optional[ServerConfig] = None,
           host: str = "0.0.0.0", port: int = 8000) -> AppServer:
    """The ``pio deploy`` flow: bind the latest COMPLETED instance of
    ``engine_id``/``engine_version``/``engine_variant`` from
    ``ctx.storage`` and return the engine server, not yet serving. Runs
    on the card unless ``config.device`` is "cpu". With
    ``config.streaming`` the stream trainer starts with it, tailing
    ``ctx.storage``."""
    from ..workflow import core as wf

    instance = wf.get_latest_completed(ctx, engine_id, engine_version,
                                       engine_variant)
    if instance is None:
        raise RuntimeError(
            f"No COMPLETED engine instance for {engine_id} "
            f"{engine_version} {engine_variant}; run train first.")
    models = wf.load_models_for_deploy(ctx, engine, instance, engine_params)
    server = QueryServer(engine, engine_params, models, config, instance,
                         ctx)
    return create_engine_server(server, host, port)
