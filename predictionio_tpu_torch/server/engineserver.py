"""Engine server: deployed-model query serving on the card (the port of
the serving core of ``predictionio_tpu/server/engineserver.py``).

``POST /queries.json`` parses the query into the template's query class,
runs supplement, per-algorithm predict and serve, and returns the result
as JSON. At bind each algorithm gets the deploy's context
(``bind_serving``: a template's serving-time store reads go to the
deploy's storage), and a model is row-quantized if asked (behind the
template's parity probe) and then placed on the serving device once.
``GET /status.json`` names the card, the quantization in force, the
kernel's launch count and the batch path's state (``pipeline``);
``POST /stop`` shuts the server down.

With ``batching`` on, concurrent queries coalesce into one batched top-k
launch, through one of two architectures (``serving_pipeline``):

- "staged" (the default), :class:`StagedPipeline`: an assemble stage
  forms a batch, parses it (a malformed query gets its 400 there) and
  supplements it; a dispatch stage launches it on the card without
  waiting; a readback stage waits for its results, serves them and wakes
  the callers. Batches in flight are bounded by ``pipeline_depth``, so
  while the card is busy arrivals pool and the next pickup takes them
  all;
- "serial", :class:`MicroBatcher`: ``batch_pipeline`` drainer threads,
  each doing everything for its own batch.

Both shed a query unanswered after ``queue_deadline_ms`` with a counted
503. Each batch is served wholly from the binding it was assembled
against, whatever rebinds meanwhile. Both record the same overlap tracks
(:class:`~predictionio_tpu_torch.obs.OverlapTracker`; the JAX package's
serial drainers record none), so the two read on one scale.

Releases: :func:`deploy` is the ``pio deploy`` flow through the release
registry (:mod:`predictionio_tpu_torch.rollout`): it binds the PINNED
release of an engine id, version and variant when one is set, else the
latest COMPLETED engine instance, and records the deploy; ``POST
/reload`` rebinds the same way. ``POST /release/canary`` binds a
candidate release beside the stable one and starts the health-gated
rollout: a cohort of queries (hash of the user) goes to the candidate,
which serves each at B = 1, while the stable arm keeps its batch path;
the gate ramps a healthy candidate to a promoted, pinned stable or rolls
an unhealthy one back. ``shadow`` mirrors queries to the candidate and
answers from stable. ``POST /release/{promote,rollback}`` are the
operator's overrides, ``GET /release.json`` the state, history and
per-arm series, ``GET /metrics`` the ``pio_release_*`` families. The
registry is the JAX package's blob in the shared MODELDATA repo, so a
pin either package writes binds in both. :func:`deploy_models` binds
models the caller already holds, with no registry.

Streaming fold-in: with ``ServerConfig.streaming`` (or ``POST
/stream/start``) a :class:`~predictionio_tpu_torch.streaming.StreamTrainer`
tails an app's event log and hot-swaps folded models into the binding
(:meth:`QueryServer.apply_stream_delta`); ``GET /stream.json`` shows it,
``POST /stream/stop`` stops it. It needs the storage a :func:`deploy`
binds from.

Warm-up and lifecycle: with ``ServerConfig.warm_start`` (the default)
a background thread loads, at bind and after every reload or promotion,
the kernel libraries the bound algorithms launch (``fused_topk``, and
``fused_gram`` and ``chol_solve`` when streaming) from the kernel root
(``ServerConfig.artifact_dir``, see :mod:`..ops._build`; a library
``pio build`` did not build is compiled there, and a query that needs it
meanwhile waits for it), then runs each algorithm's ``warm_serving``
ladder. ``/status.json`` shows ``servingWarm``, ``artifactWarm`` (no
``nvcc`` ran at this bind), ``warmReport`` (the phases' seconds, and
``error`` where the warm-up raised: it is logged and reported, never
hidden, and the queries that follow raise the same way) and
``lifecycle``: ``warming``, ``ready``, or ``draining`` after ``POST
/drain``, which keeps the server answering. ``GET /`` is the status
page.

Serving caches (:mod:`predictionio_tpu_torch.cache`), with
``ServerConfig.serving_cache``: ``serve`` looks a query up in the query
tier (key: the serving binding and the canonical query JSON) before the
batch paths, and a miss computes once however many identical queries
arrive meanwhile (singleflight), then fills under an epoch token, so an
invalidation that ran during the compute drops the fill. The candidate
arm caches under its own instance id. The per-query path ranks a user
the hot tier pinned from the pinned table (``predict_pinned``: on the
card a ``fused_topk`` launch with that table as its user table); a handle
pinned against another binding than the query's (a pin that raced a
rebind) is served through the full table and counted (``pinnedStale``),
and any other error of a pinned serve is the query's 500, never a silent
fallback. The feature tier goes to every algorithm with
``bind_feature_cache``. An ingest in this process invalidates through the
bus, a fold-in per touched user (and re-pins when a pinned user was
touched), a rebind flushes every tier and a rollback the candidate's
namespace. ``GET /cache.json`` and ``POST /cache/flush`` operate it; the
``pio_cache_*`` families are on ``/metrics``.

Telemetry (:mod:`predictionio_tpu_torch.obs`): every request carries a
trace (``ServerConfig.tracing``, on by default) through whichever path
serves it: the single query's phases, the serial drainers' ``batch`` and
its stages, the staged pipeline's ``batch`` with ``queue_wait`` from the
enqueue, the host stages from the pickup and the device stages from the
real dispatch time, the candidate arm's ``candidate_serve``; the tail
sampler keeps the slow, failed and shed ones for ``GET /trace.json``.
``GET /metrics`` (and ``/metrics.json``) carries the query, batch,
pipeline, numerics, trace, hot-key, HTTP, runtime (the card's memory
among them) and release families; ``POST /profile`` captures a bounded
``torch.profiler`` window into ``ServerConfig.profile_dir`` and ``GET
/profile.json`` lists the captures; output plugins
(:class:`~predictionio_tpu_torch.server.plugins.EngineServerPlugins`)
see every served result. ``ServerConfig.debug_numerics`` (or
``PTPU_DEBUG_NUMERICS=1``) arms the NaN/Inf sentinels of the served
scores and the fold-in solve. With ``ServerConfig.accesskey`` the
control routes need ``?accessKey=``.

Failure drills: ``ServerConfig.faults`` (``deploy --faults``) arms a
``PTPU_FAULTS`` spec at start; every dispatch route (the per-query
path, the serial drainers' batch and the staged pipeline's dispatch
stage) fires the ``serving.dispatch`` point inside the batch's traces,
so an injected delay lands in the traces it slows and they are kept
(reason ``fault``). ``pio_fault_injections_total`` and
``pio_fault_enabled`` are on ``/metrics``, ``faultInjection`` in
``/status.json``'s degraded block. ``ServerConfig.debug_locks`` (``deploy
--debug-locks``, ``PTPU_DEBUG_LOCKS=1``) builds the serving stack's locks
as ``concurrency.DebugLock``s and adds the ``pio_lock_*`` families.

Service-level objectives (:mod:`predictionio_tpu_torch.slo`): every
server runs an SLO engine by default (``ServerConfig.slo_interval_ms``,
1,000; 0 turns it off) over the built-in specs or
``ServerConfig.slo_specs``: the ``pio_slo_burn_rate``,
``pio_slo_budget_remaining``, ``pio_slo_breach`` and
``pio_slo_violations_total`` families, the ``slo`` block of
``/status.json`` and ``GET /slo.json``. While a spec burns, the flight
recorder keeps every trace under reason ``slo``. ``lifecycle``,
``servingWarm`` and ``POST /drain`` are what the fleet's router and
replica lifecycle read (:mod:`predictionio_tpu_torch.router`).

Left out (``ROADMAP.md`` queue 1): replicated lanes and the ``pio_lane_*``,
``pio_serving_lanes`` and ``pio_serving_degraded`` families (item 13);
feedback events
and ``log_url``. ``transfer_guard``, the XLA recompile sentinel
(``pio_compiles_since_warm``, the per-executable compile table of
``/profile.json``) and ``pio_sharding_findings`` are XLA mechanisms with
nothing to port (``ROADMAP.md``); a candidate is ready once its tables
are on the card.
"""

from __future__ import annotations

import html
import logging
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from datetime import datetime, timezone
from typing import Any, Dict, List, Optional

from ..concurrency import (
    instrument_locks,
    locks_instrumented,
    new_lock,
    register_lock_metrics,
)
from ..controller.context import Context
from ..controller.engine import Engine
from ..controller.params import EngineParams
from ..data.storage.base import STATUS_COMPLETED, EngineInstance
from ..models.als import (
    SERVING_QUANT_MODES,
    resolved_gram_mode,
    serving_quant_of,
)
from ..obs import (
    DEFAULT_LATENCY_BOUNDS,
    DEVICE_TRACK,
    POW2_COUNT_BOUNDS,
    DeviceProfiler,
    MetricsRegistry,
    OverlapTracker,
    SpaceSaving,
    Tracer,
    activate_traces,
    add_stage_spans,
    mount_hot_key_metrics,
)
from ..faults import declare, fire
from ..faults import inject_spec as arm_faults
from ..faults import registry as fault_registry
from ..obs import hbm_stats, mark_active_traces, numerics
from ..ops import _build
from ..ops import fused_topk as _fused_topk
from ..rollout.registry import ReleaseRegistry
from ..rollout.splitter import ARM_CANDIDATE, ARM_STABLE
from ..utils.device import card_info, resolve_device
from ..utils.jsonutil import from_jsonable, to_jsonable
from ..workflow.batch_predict import (
    PendingBatch,
    dispatch_batch,
    make_pool,
    predict_serve_batch,
    supplement_batch,
)
from .http import (
    AppServer,
    HTTPApp,
    HTTPError,
    Request,
    Response,
    json_response,
    make_key_auth,
    mount_metrics,
)
from .plugins import EngineServerPlugins, resolve_plugin

log = logging.getLogger(__name__)

F_DISPATCH = declare("serving.dispatch",
                     "one batched device dispatch (any serving mode)")

#: the batch-path architectures (``ServerConfig.serving_pipeline``)
PIPELINE_MODES = ("staged", "serial")


@dataclass
class ServerConfig:
    """Serving knobs (a subset of the JAX package's ``ServerConfig``)."""

    #: coalesce concurrent queries into one batched launch
    batching: bool = False
    #: most queries one batch takes
    max_batch: int = 128
    #: how long a lone query waits for company before it serves alone
    batch_window_ms: float = 2.0
    #: serial: the drainer threads; staged: the dispatch threads (the
    #: batches in flight are bounded by ``pipeline_depth``, not this)
    batch_pipeline: int = 4
    #: the batch path's architecture: "staged" (assemble, dispatch and
    #: readback stages with bounded hand-offs) or "serial" (drainers,
    #: each doing everything for its own batch)
    serving_pipeline: str = "staged"
    #: per-query deadline from submit through readback: past it the
    #: caller gets 503 and its queue entry is shed; 0 disables
    queue_deadline_ms: float = 30_000.0
    #: staged: threads forming, parsing and supplementing batches (more
    #: split the arrivals into smaller batches)
    assemble_workers: int = 1
    #: staged: threads waiting on a batch's results and serving them
    readback_workers: int = 4
    #: staged: batches in flight (launched, not yet read back). 0 = auto:
    #: 2 on the CPU, where the "device" shares the host's cores; 4 on the
    #: card, where a readback waits on a device behind later launches
    pipeline_depth: int = 0
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
    #: load the kernel libraries and run each algorithm's serving ladder
    #: on a background thread at bind (``servingWarm`` on
    #: ``/status.json``); off, the first query that needs a library
    #: builds or loads it
    warm_start: bool = True
    #: the kernel root ``pio build --artifact-dir`` built into (see
    #: ``ops/_build.py``); None keeps ``$PTPU_ARTIFACT_DIR`` or the
    #: default ``build/torch_kernels``
    artifact_dir: Optional[str] = None
    #: require ``?accessKey=`` on the control routes (reload, releases,
    #: stream start and stop, drain, stop, plugins, profile, cache flush)
    accesskey: Optional[str] = None
    #: trace every request into the tail-sampled flight recorder: only
    #: slow (adaptive p99), failed and shed traces are kept, served on
    #: ``GET /trace.json``; off for A/B runs of its cost
    tracing: bool = True
    #: retained traces the flight recorder's ring holds (oldest evicted)
    trace_ring: int = 512
    #: a fixed slow-retention threshold in ms; 0 = adaptive (the live
    #: p99 of traced request durations)
    trace_slow_ms: float = 0.0
    #: the share of successful requests the JSON access log writes
    #: (errors and 503s always)
    access_log_sample: float = 1.0
    #: where ``POST /profile`` writes its captures (None:
    #: ``$PTPU_PROFILE_DIR``, else ``<tmp>/ptpu-profiles``)
    profile_dir: Optional[str] = None
    #: capacity of the Space-Saving sketch of the queries' entity ids
    #: (``pio_hot_keys``, the ``hotKeys`` block); 0 disables it
    hot_keys_k: int = 128
    #: arm the NaN/Inf sentinels of the served scores and the fold-in
    #: solve (process-wide; ``PTPU_DEBUG_NUMERICS=1`` does the same)
    debug_numerics: bool = False
    #: the serving cache hierarchy: an exact-key query-result cache
    #: consulted before the batch paths (singleflight dedups concurrent
    #: identical misses), a feature cache for serving-time event-store
    #: reads and the pinned hot-entity tier, all invalidated by the
    #: event server's ingest bus and flushed on every rebind. Off by
    #: default: caching results is a staleness decision of the operator
    serving_cache: bool = False
    #: query-tier LRU capacity (entries)
    cache_entries: int = 8192
    #: query-result staleness BOUND: the bus usually invalidates far
    #: sooner; this TTL is the ceiling when ingest happens in another
    #: process (no in-process bus delivery)
    cache_ttl_sec: float = 30.0
    feature_cache_entries: int = 8192
    #: event-store read staleness bound
    feature_ttl_sec: float = 5.0
    #: hottest entities whose factor rows stay pinned on the serving
    #: device (0 disables the tier)
    hot_entities: int = 512
    #: serves between re-ranks and re-pins of the hot tier
    hot_refresh_every: int = 256
    #: a ``PTPU_FAULTS``-grammar spec armed in the process's fault
    #: registry when the server is built (``deploy --faults``), for
    #: failure drills; None arms nothing (the variable still works)
    faults: Optional[str] = None
    #: build the serving stack's locks as ``DebugLock``s (``deploy
    #: --debug-locks``; ``PTPU_DEBUG_LOCKS=1`` does the same): live
    #: lock-order-inversion and re-entry detection, the ``pio_lock_*``
    #: families and the deadlock watchdog. Off: the stdlib locks
    debug_locks: bool = False
    #: the SLO engine's objectives, evaluated continuously against this
    #: server's registry with multi-window error-budget burn rates (the
    #: ``pio_slo_*`` families, ``GET /slo.json``, the ``slo`` block of
    #: ``/status.json``). None = the built-in defaults (availability and
    #: latency of ``/queries.json``, freshness while streaming); a path
    #: loads a spec file (``slo/specs/*.json``). While a spec burns, the
    #: flight recorder keeps every trace (reason ``slo``)
    slo_specs: Optional[str] = None
    #: the SLO engine's evaluation tick; 0 turns the engine off
    slo_interval_ms: float = 1000.0


@dataclass
class CandidateBinding:
    """A candidate release bound BESIDE the stable one: its own
    algorithms, models and serving, so the two arms share no mutable
    state. ``raw_models`` are the blobs as loaded: promotion rebinds them
    through the normal :meth:`QueryServer._bind`. The port compiles
    nothing per shape, so the binding is ready (``warm_done`` set) once
    its tables are on the card."""

    engine_params: EngineParams
    algorithms: List[Any]
    models: List[Any]
    raw_models: List[Any]
    serving: Any
    instance: EngineInstance
    warm_done: threading.Event


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
        if self.config.serving_pipeline not in PIPELINE_MODES:
            raise ValueError(
                f"serving_pipeline must be 'staged' or 'serial', got "
                f"{self.config.serving_pipeline!r}")
        self.device = resolve_device(self.config.device)
        self.card = card_info(self.device)
        self.plugins = EngineServerPlugins()
        if self.config.faults:
            # armed before anything that might be their target exists
            arm_faults(self.config.faults)
        if self.config.debug_locks and not locks_instrumented():
            # before any serving-stack lock exists, so the cache, rollout
            # and batcher locks built below all feed one order graph
            instrument_locks(True)
        if self.config.debug_numerics or numerics.debug_env():
            # arm the NaN/Inf sentinels BEFORE the bind, so the warm-up
            # is covered too
            numerics.enable()
        self._lock = new_lock("QueryServer._lock")
        self.request_count = 0
        self.start_time = datetime.now(timezone.utc)
        # mean and last serving wall time a query (under _lock)
        self.avg_serving_sec = 0.0
        self.last_serving_sec = 0.0
        # the server's metric registry: the query path's phases and
        # latency, the batch paths' occupancy, queue depths, stages,
        # sheds and overlap; build_app mounts it on /metrics
        self.metrics = MetricsRegistry()
        self._phase_hist = self.metrics.histogram(
            "pio_query_phase_seconds",
            "Per-phase query-path wall time (queue_wait, assemble, "
            "supplement, dispatch, serve, readback, feedback)",
            bounds=DEFAULT_LATENCY_BOUNDS)
        self._latency_hist = self.metrics.histogram(
            "pio_query_latency_seconds",
            "End-to-end serving wall time per query",
            bounds=DEFAULT_LATENCY_BOUNDS)
        self._batch_occupancy = self.metrics.histogram(
            "pio_batch_occupancy",
            "Queries coalesced per micro-batch dispatch",
            bounds=POW2_COUNT_BOUNDS)
        self._queue_depth = self.metrics.histogram(
            "pio_queue_depth",
            "Batcher queue depth observed at each batch pickup",
            bounds=POW2_COUNT_BOUNDS)
        self._query_errors = self.metrics.counter(
            "pio_query_errors_total", "Failed queries by status class")
        self._pipeline_stage_hist = self.metrics.histogram(
            "pio_pipeline_stage_seconds",
            "Per-batch wall time of each staged-pipeline stage "
            "(assemble = parse+supplement, dispatch = device enqueue, "
            "readback = device wait + serve + serialize + feedback)",
            bounds=DEFAULT_LATENCY_BOUNDS)
        self._pipeline_qdepth = self.metrics.histogram(
            "pio_pipeline_queue_depth",
            "Queue depth observed at each pipeline stage pickup "
            "(queue=submit|dispatch|readback)",
            bounds=POW2_COUNT_BOUNDS)
        self._deadline_exceeded = self.metrics.counter(
            "pio_query_deadline_exceeded_total",
            "Queries shed with 503 after exceeding "
            "ServerConfig.queue_deadline_ms — load shedding under a "
            "wedged or saturated dispatch, never silent hangs")
        self._pipeline_overlapped = self.metrics.counter(
            "pio_pipeline_overlapped_dispatches_total",
            "Batch launches that found an earlier batch still in "
            "flight on the device — direct evidence of stage overlap")
        self.overlap = OverlapTracker()
        self.metrics.gauge(
            "pio_pipeline_device_idle_fraction",
            "Fraction of wall time (since first batch) with NO batch "
            "in flight on the device; the staged pipeline under load "
            "should drive this toward 0",
            fn=self.overlap.device_idle_fraction)
        self.metrics.gauge(
            "pio_pipeline_overlap_fraction",
            "Fraction of wall time where the device was busy WHILE an "
            "assemble/readback host stage ran — the overlap the staged "
            "pipeline exists to create (a serial drainer reads ~0)",
            fn=self.overlap.overlap_fraction)
        # request traces (the server owns the tracer, so direct query()
        # callers trace as HTTP traffic does; build_app mounts it on the
        # request path and /trace.json) and the bounded profiler capture
        # behind POST /profile
        cfg = self.config
        self.tracer = (Tracer(ring=cfg.trace_ring, slow_ms=cfg.trace_slow_ms)
                       if cfg.tracing else None)
        self.profiler = DeviceProfiler(cfg.profile_dir)
        self.slo = None  # the SLO engine, started last (see below)
        # hot keys: a Space-Saving sketch of the queries' entity ids
        self.hotkeys: Optional[SpaceSaving] = None
        if cfg.hot_keys_k > 0:
            self.hotkeys = SpaceSaving(capacity=cfg.hot_keys_k)
            mount_hot_key_metrics(self.metrics, self.hotkeys)
        # the NaN/Inf sentinels' checks, wherever in the process they ran,
        # by entry; a nonfinite one flags degraded.nonfinite
        self._numerics_checks = self.metrics.counter(
            "pio_numerics_checks_total",
            "Numeric-sentinel NaN/Inf checks delivered, by entry "
            "point (debug_numerics only; absent in production)")
        self._numerics_nonfinite = self.metrics.counter(
            "pio_numerics_nonfinite_total",
            "Numeric-sentinel checks that observed NaN/Inf, by entry "
            "point — nonzero flags nonfinite in /status.json")
        self._numerics_listener = None
        if numerics.active():
            self._numerics_listener = self._on_numerics
            numerics.add_listener(self._on_numerics)
        # fault injections delivered anywhere in the process, by point
        # and mode, each flagged onto the traces its thread works on, so
        # a fault-injected request is retained by the flight recorder
        self._fault_injections = self.metrics.counter(
            "pio_fault_injections_total",
            "Fault-registry injections delivered, by point and mode "
            "(drills only; 0 in production)")
        fault_registry().add_listener(self._on_fault)
        self.metrics.gauge(
            "pio_fault_enabled",
            "1 while any fault-injection spec is armed in this process",
            fn=lambda: 1.0 if fault_registry().enabled() else 0.0)
        if locks_instrumented():
            register_lock_metrics(self.metrics)
        # concurrent supplements and blocking predictions; shut down in
        # close() (its threads start on first use)
        self._pool = make_pool()
        self._binds = 0
        self.stream = None
        # releases: the per-arm series the rollout gate windows, the
        # registry this server's deploy, reload, promote and rollback are
        # recorded in (None without storage: models handed in), and the
        # (at most one) live candidate binding and controller
        self._release_queries = self.metrics.counter(
            "pio_release_queries_total",
            "Queries served per release arm while a rollout is live")
        self._release_errors = self.metrics.counter(
            "pio_release_query_errors_total",
            "Server-side (5xx) query failures per release arm while a "
            "rollout is live")
        self._release_latency = self.metrics.histogram(
            "pio_release_latency_seconds",
            "End-to-end serving wall time per release arm while a "
            "rollout is live",
            bounds=DEFAULT_LATENCY_BOUNDS)
        self._shadow_mirrors = self.metrics.counter(
            "pio_release_shadow_mirrors_total",
            "Queries mirrored to a shadow candidate")
        # warm-up and lifecycle: warm_done is set by the warm thread of
        # the newest generation (a reload bumps it, so a stale thread
        # never reports warm), drain_started by POST /drain
        self.warm_done = threading.Event()
        self.drain_started = threading.Event()
        self._warm_gen = 0
        self._warm_report: dict = {}
        self._warm_threads: List[threading.Thread] = []
        self.metrics.gauge(
            "pio_serving_warm",
            "1 once the kernels are loaded and the serving ladder ran",
            fn=lambda: 1.0 if self.warm_done.is_set() else 0.0)
        self._warmup_seconds = self.metrics.histogram(
            "pio_warmup_seconds",
            "Serving warm-up wall time by phase (phase=load|compile|"
            "replicate|probe); a warm from built libraries puts nothing "
            "in compile",
            bounds=[0.01, 0.05, 0.25, 1.0, 2.0, 5.0, 15.0, 30.0, 60.0])
        if self.config.artifact_dir:
            _build.set_root(self.config.artifact_dir)
        self.releases = (ReleaseRegistry(
            ctx.storage, instance.engine_id, instance.engine_version,
            instance.engine_variant)
            if ctx is not None and instance is not None else None)
        self.rollout = None  # the live RolloutController, if any
        self._candidate: Optional[CandidateBinding] = None
        # shadow mirrors, on a pool of their own (started on first use,
        # shut down in close())
        self._mirror_pool: Optional[ThreadPoolExecutor] = None
        # one canary start at a time (check-then-bind)
        self._release_lock = new_lock("QueryServer._release_lock")
        # the serving caches: built before the first bind, which flushes
        # them and hands the feature tier to the algorithms
        self.cache = self._make_cache()
        if self.cache is not None:
            self.cache.register_metrics(self.metrics)
        self._bind(engine_params, models, instance)
        self.batcher = None
        if cfg.batching and cfg.serving_pipeline == "staged":
            self.batcher = StagedPipeline(
                self, cfg.batch_window_ms, cfg.max_batch,
                assemble_workers=cfg.assemble_workers,
                readback_workers=cfg.readback_workers,
                depth=cfg.pipeline_depth, deadline_ms=cfg.queue_deadline_ms,
                dispatch_workers=cfg.batch_pipeline)
        elif cfg.batching:
            self.batcher = MicroBatcher(
                self, cfg.batch_window_ms, cfg.max_batch,
                pipeline=cfg.batch_pipeline,
                deadline_ms=cfg.queue_deadline_ms)
        if cfg.warm_start:
            self._start_warm(0)
        else:
            self.warm_done.set()
        if self.config.streaming:
            try:
                self.start_stream()
            except BaseException:
                self.close()
                raise
        if cfg.slo_interval_ms > 0:
            try:
                self._start_slo()
            except BaseException:
                self.close()
                raise

    # -- service-level objectives --------------------------------------------
    def _start_slo(self) -> None:
        """Account every objective against this server's registry on a
        background tick (``slo-engine``); a spec file that does not load
        fails the deploy."""
        from ..slo import SLOEngine, default_specs, load_specs

        if self.config.slo_specs:
            specs, _ = load_specs(self.config.slo_specs)
        else:
            specs = default_specs(streaming=self.config.streaming)
        engine = SLOEngine(self.metrics, specs,
                           on_transition=self._on_slo_transition)
        engine.register_metrics(self.metrics)
        self.slo = engine
        engine.start(self.config.slo_interval_ms / 1000.0)

    def _on_slo_transition(self, spec, breached: bool, info) -> None:
        """ok<->breach edge hook: while ANY spec burns, the tail sampler
        keeps every trace (reason ``slo``), so a violation always comes
        with flight-recorder evidence."""
        tracer = self.tracer
        if tracer is None or self.slo is None:
            return
        tracer.force_retention("slo" if self.slo.burning() else None)

    def slo_status(self) -> dict:
        """The ``slo`` block of ``/status.json`` (and ``/slo.json``)."""
        if self.slo is None:
            return {"enabled": False,
                    "hint": "deploy with --slo-specs FILE (or leave "
                            "slo_interval_ms at its default) to "
                            "evaluate service objectives"}
        return self.slo.status()

    def stop_slo(self) -> None:
        """Join the SLO engine's tick thread; its series stay readable."""
        if self.slo is not None:
            self.slo.stop()

    def _serving_algorithms(self, engine_params: EngineParams,
                            models: List[Any]) -> tuple:
        """The algorithms of ``engine_params`` bound to the deploy's
        context, and ``models`` quantized (if asked, behind the
        template's parity probe) and placed on the serving device once —
        no query moves a table. Shared by both arms: a candidate serves
        under the stable arm's quantization."""
        algorithms = self.engine.make_algorithms(engine_params)
        if len(models) != len(algorithms):
            raise ValueError(f"{len(models)} models for "
                             f"{len(algorithms)} algorithms")
        # serving-time reads go to the deploy's storage (the process-wide
        # one where models were handed in)
        serving_ctx = self.ctx if self.ctx is not None \
            else Context(device=self.device)
        for a in algorithms:
            a.bind_serving(serving_ctx)
            self._bind_feature_cache(a)
        quant = self.config.serving_quant
        if quant != "off":
            models = [a.quantize_serving_model(m, quant)
                      if hasattr(a, "quantize_serving_model") else m
                      for a, m in zip(algorithms, models)]
        models = [a.prepare_serving_model(m, self.device)
                  for a, m in zip(algorithms, models)]
        return algorithms, models

    def _bind(self, engine_params: EngineParams, models: List[Any],
              instance: Optional[EngineInstance] = None,
              promoted: Optional[CandidateBinding] = None) -> None:
        """Bind the stable arm: prepare the models, then swap them in
        together with ``instance`` (None keeps the serving one) under the
        one lock, so the binding id, ``/status.json`` and a fold-in's
        re-check all move with the models. A batch assembled before the
        swap finishes on the binding it took. ``promoted`` is the
        candidate being promoted: it stays bound, and serves its cohort,
        until this same swap unbinds it, so no query of its cohort meets
        the old stable meanwhile."""
        algorithms, models = self._serving_algorithms(engine_params, models)
        serving = self.engine.make_serving(engine_params)
        with self._lock:
            if self.cache is not None:
                # a FULL flush on every rebind (deploy, reload, promote):
                # a new model must never serve answers, or pinned rows,
                # of the old one
                self.cache.flush_all()
            if instance is None:
                instance = self.instance
            if promoted is not None and self._candidate is promoted:
                self._candidate = None
            self.engine_params = engine_params
            self.instance = instance
            self.algorithms, self.models, self.serving = \
                algorithms, models, serving
            # what a fold-in in flight re-checks: the instance id, or a
            # token of this bind where models were handed in, so that a
            # second bind voids it either way
            self._binds += 1
            self.binding_id = (instance.id if instance is not None
                               else f"bind-{self._binds}")
            # stream lineage: a bind starts a fresh base
            self._stream_generation = 0
            self._stream_rows = 0
            self._stream_last_apply: Optional[float] = None
            self._stream_base_bound_at = time.time()
            self._record_gram_mode()
            self._record_serving_kernel()

    def _binding(self):
        with self._lock:
            return self.algorithms, self.models, self.serving

    # -- the serving caches --------------------------------------------------
    def _make_cache(self):
        cfg = self.config
        if not cfg.serving_cache:
            return None
        from ..cache import ServingCache

        return ServingCache(
            query_entries=cfg.cache_entries,
            query_ttl_sec=cfg.cache_ttl_sec,
            feature_entries=cfg.feature_cache_entries,
            feature_ttl_sec=cfg.feature_ttl_sec,
            hot_capacity=cfg.hot_entities,
            hot_refresh_every=cfg.hot_refresh_every,
            pin_fn=self._pin_hot)

    def _bind_feature_cache(self, algo: Any) -> None:
        """Hand the feature tier to algorithms that cache serving-time
        event-store reads (the e-commerce template's seen, unavailable,
        weighted and recent lookups)."""
        if self.cache is None:
            return
        bind = getattr(algo, "bind_feature_cache", None)
        if bind is not None:
            bind(self.cache.features)

    def _pin_hot(self, entity_keys: List[str]):
        """The hot tier's pin: the (single) algorithm's
        ``pin_hot_entities`` against the binding of this moment. Each
        handle is ``(binding_id, handle)``: the per-query path serves it
        only under the binding it was pinned against."""
        with self._lock:
            algorithms, models = self.algorithms, self.models
            binding_id = self.binding_id
        if len(algorithms) != 1:
            return {}, 0  # several algorithms blend; one pin would skew
        pin = getattr(algorithms[0], "pin_hot_entities", None)
        if pin is None:
            return {}, 0
        handles, nbytes = pin(models[0], entity_keys)
        return {e: (binding_id, h) for e, h in handles.items()}, nbytes

    def _dispatch_predictions(self, algorithms: List[Any],
                              models: List[Any], binding_id: str,
                              supplemented: Any, trace=None) -> List[Any]:
        """The per-query path's predictions: a user the hot tier pinned
        under ``binding_id`` is ranked from the pinned table
        (``predict_pinned``), every other query by each algorithm's
        ``predict``. A handle pinned under another binding (a pin that
        raced a rebind) is counted and served through the full table; a
        pinned serve that raises fails the query like any serve. The
        ``serving.dispatch`` fault point fires first, flagging
        ``trace``."""
        with activate_traces([trace]):
            fire(F_DISPATCH)
        cache = self.cache
        if (cache is not None and cache.hot is not None
                and len(algorithms) == 1):
            entity = getattr(supplemented, "user", None)
            handle = (cache.hot.lookup(str(entity))
                      if entity is not None else None)
            pinned = getattr(algorithms[0], "predict_pinned", None)
            if handle is not None and pinned is not None:
                pinned_binding, h = handle
                if pinned_binding == binding_id:
                    return [pinned(models[0], supplemented, h)]
                cache.hot.note_stale()
        return [a.predict(m, supplemented)
                for a, m in zip(algorithms, models)]

    # ptpu: guarded-by[_lock] — only ever called from _bind under the
    # lock, inside the swap that installs the binding it describes
    def _record_gram_mode(self) -> None:
        """The ``pio_gram_mode`` info gauge: 1 at the gram realization the
        bound ALS params resolve to (``models/als.py::
        resolved_gram_mode``), 0 at a label a rebind left behind."""
        for algo in self.algorithms:
            p = getattr(algo, "params", None)
            if p is not None and hasattr(p, "gram_mode"):
                fam = self.metrics.gauge(
                    "pio_gram_mode",
                    "Resolved ALS gram realization of the bound engine "
                    "params (info gauge: 1 at the active mode label)")
                for _, child in fam.children():
                    child.set(0.0)
                fam.labels(mode=resolved_gram_mode(p)).set(1.0)
                return

    # ptpu: guarded-by[_lock] — only ever called from _bind under the
    # lock, like _record_gram_mode
    def _record_serving_kernel(self) -> None:
        """The ``pio_serving_kernel`` info gauge: 1 at the serving top-k
        realization (the port serves through ``fused_topk``) and the quant
        wire the bound ALS model serves, 0 at labels a rebind left
        behind."""
        for algo, model in zip(self.algorithms, self.models):
            p = getattr(algo, "params", None)
            if p is not None and hasattr(p, "rank"):
                fam = self.metrics.gauge(
                    "pio_serving_kernel",
                    "Resolved serving top-k realization x quant dtype of "
                    "the bound engine (info gauge: 1 at the active "
                    "labels)")
                for _, child in fam.children():
                    child.set(0.0)
                fam.labels(mode="fused",
                           quant=serving_quant_of(model)).set(1.0)
                return

    def _on_fault(self, point: str, mode: str) -> None:
        self._fault_injections.labels(point=point, mode=mode).inc()
        mark_active_traces("fault", faultPoint=point, faultMode=mode)

    def _on_numerics(self, entry: str, bad: bool) -> None:
        self._numerics_checks.labels(entry=entry).inc()
        if bad:
            self._numerics_nonfinite.labels(entry=entry).inc()

    # -- the batch path's counters, read off the metric families -------------
    @property
    def deadline_exceeded(self) -> int:
        """Queries shed at their deadline."""
        return int(self._deadline_exceeded.labels().value)

    @property
    def query_errors(self) -> Dict[str, int]:
        """Error answers by status."""
        return {dict(items)["status"]: int(c.value)
                for items, c in self._query_errors.children()}

    @property
    def batches_served(self) -> int:
        return self._batch_occupancy.labels().count

    @property
    def queries_batched(self) -> int:
        """Queries the batches held (mean batch = this over
        :attr:`batches_served`)."""
        return int(self._batch_occupancy.labels().sum)

    @property
    def overlapped_dispatches(self) -> int:
        """Launches made while an earlier batch was on the device."""
        return int(self._pipeline_overlapped.labels().value)

    @property
    def phase_seconds(self) -> Dict[str, float]:
        """Wall seconds by query phase, summed (a batch's phases once a
        batch, ``queue_wait`` once a query)."""
        return {dict(items)["phase"]: h.sum
                for items, h in self._phase_hist.children()}

    @property
    def stage_seconds(self) -> Dict[str, float]:
        """Wall seconds by staged-pipeline stage, summed over batches."""
        return {dict(items)["stage"]: h.sum
                for items, h in self._pipeline_stage_hist.children()}

    def _count(self, n: int, seconds: float) -> None:
        """``n`` queries answered in ``seconds`` of serving wall time
        between them: the mean and last serving time a query."""
        if n <= 0:
            return
        with self._lock:
            total = self.request_count
            self.avg_serving_sec = ((self.avg_serving_sec * total + seconds)
                                    / (total + n))
            self.last_serving_sec = seconds / n
            self.request_count += n

    def _record_phases(self, phases: Dict[str, float]) -> None:
        for phase, sec in phases.items():
            self._phase_hist.labels(phase=phase).observe(sec)

    def _trace_of(self, obs: Optional[dict]):
        """The live request trace riding the obs dict (None when the
        caller is untraced or tracing is off)."""
        if obs is None or self.tracer is None:
            return None
        return obs.get("_trace")

    @staticmethod
    def _entity_of(query_json: Any) -> Optional[str]:
        """The query's entity (``user``), the hot-key sketch's key."""
        if isinstance(query_json, dict):
            entity = query_json.get("user")
            if entity is not None:
                return str(entity)
        return None

    def _compute_stable(self, query_json: Any,
                        obs: Optional[dict]) -> Any:
        """The uncached stable arm: the batch path when batching, else
        the per-query path. Raises :class:`HTTPError`."""
        if self.batcher is not None:
            result = self.batcher.submit(query_json, obs=obs)
            if isinstance(result, HTTPError):
                raise result
            return result
        return self.query(query_json, obs=obs)

    def _record_cache_hit(self, arm: str, t0: float,
                          obs: Optional[dict]) -> None:
        """A query-tier hit's bookkeeping: the latency histogram (with the
        trace's exemplar), the arm's series, the served count, and on the
        trace the ``cacheTier`` attribute and one ``cache_hit`` span: a
        hit never reaches the card."""
        dt = time.monotonic() - t0
        self._latency_hist.observe(dt)
        self._observe_release(arm, dt, error=False)
        if obs is not None:
            obs["cache"] = "hit"
            tr = self._trace_of(obs)
            if tr is not None:
                tr.set_attr("arm", arm)
                tr.set_attr("cacheTier", "query")
                tr.add_span("cache_hit", t0, t0 + dt, tier="query")
                tr.exemplar(self._latency_hist.labels(), dt)
        self._count(1, dt)

    def _serve_cached(self, namespace: str, query_json: Any,
                      obs: Optional[dict], arm: str, compute) -> Any:
        """The query tier around ``compute``: a hit returns the cached
        answer; a miss computes once for every identical query in flight
        (singleflight; a follower's ``obs["cache"]`` is "coalesced") and
        fills the tier under an epoch token taken before the compute, so
        an invalidation that ran meanwhile drops the fill. Errors raise
        and are never cached."""
        from ..cache import canonical_key, entity_tag

        cache = self.cache
        t0 = time.monotonic()
        key = (namespace, canonical_key(query_json))
        found, value = cache.query.lookup(key)
        if found:
            self._record_cache_hit(arm, t0, obs)
            return value
        entity = self._entity_of(query_json)
        tag = entity_tag("user", entity) if entity is not None else None

        def fill() -> Any:
            token = cache.epoch_token(tag)
            result = compute()
            cache.put_query_fresh(key, result, (tag,) if tag else (), token)
            return result

        result, leader = cache.flight.do(key, fill)
        if obs is not None and not leader:
            obs["cache"] = "coalesced"
        return result

    def serve(self, query_json: Any, obs: Optional[dict] = None) -> Any:
        """The ``/queries.json`` entry of the stable arm: with the serving
        cache, the query tier, singleflight, then the batch path when
        batching, else the per-query path; without it, straight to
        those. Raises :class:`HTTPError`."""
        if self.hotkeys is not None:
            # recorded before the cache: a key hot because it keeps
            # hitting the cache is still a hot key
            self.hotkeys.record(self._entity_of(query_json))
        cache = self.cache
        if cache is None:
            return self._compute_stable(query_json, obs)
        entity = self._entity_of(query_json)
        if entity is not None and cache.hot is not None:
            cache.hot.record(entity)
        with self._lock:
            binding_id = self.binding_id
        return self._serve_cached(
            binding_id, query_json, obs, ARM_STABLE,
            lambda: self._compute_stable(query_json, obs))

    def query(self, query_json: Any, obs: Optional[dict] = None) -> Any:
        """One query: parse, supplement, predict with every algorithm,
        serve, render JSON and run the output plugins, each phase timed
        and, with a trace in ``obs``, laid out as its spans."""
        t0 = time.monotonic()
        phases: Dict[str, float] = {}
        trace = self._trace_of(obs)
        with self._lock:
            algorithms, models, serving = \
                self.algorithms, self.models, self.serving
            binding_id = self.binding_id
        if trace is not None:
            trace.set_attr("engineInstanceId", binding_id)
            trace.set_attr("arm", ARM_STABLE)
        try:
            query = from_jsonable(algorithms[0].query_class, query_json)
        except (TypeError, ValueError) as e:
            self._query_errors.labels(status="400").inc()
            raise HTTPError(400, str(e)) from e
        t1 = time.monotonic()
        phases["assemble"] = t1 - t0
        try:
            supplemented = serving.supplement(query)
            t2 = time.monotonic()
            phases["supplement"] = t2 - t1
            predictions = self._dispatch_predictions(
                algorithms, models, binding_id, supplemented, trace)
            t3 = time.monotonic()
            phases["dispatch"] = t3 - t2
            prediction = serving.serve(query, predictions)
            t4 = time.monotonic()
            phases["serve"] = t4 - t3
            result = to_jsonable(prediction)
            phases["readback"] = time.monotonic() - t4
            result = self.plugins.process_output(query_json, result)
        except Exception:
            self._query_errors.labels(status="500").inc()
            self._observe_release(ARM_STABLE, time.monotonic() - t0,
                                  error=True)
            self._record_phases(phases)
            add_stage_spans(trace, t0, phases)
            raise
        dt = time.monotonic() - t0
        self._record_phases(phases)
        self._latency_hist.observe(dt)
        self._observe_release(ARM_STABLE, dt, error=False)
        if trace is not None:
            # the phases ran back to back on this thread: the sequential
            # layout from t0 is the real timeline
            add_stage_spans(trace, t0, phases)
            trace.exemplar(self._latency_hist.labels(), dt)
        if obs is not None:
            obs.update({f"{k}Ms": round(v * 1000, 3)
                        for k, v in phases.items()})
        self._count(1, dt)
        return result

    def query_batch(self, query_jsons: List[Any],
                    obs_list: Optional[List[Optional[dict]]] = None
                    ) -> List[Any]:
        """Serve many queries with ONE batched launch per algorithm (the
        serial drainers' work). A query that fails to parse gets its own
        400 and one that fails to predict or serve its own 500; the
        other slots are unaffected. ``obs_list`` (one dict a query, from
        the batcher) gets each query's access-log fields, and its trace a
        ``batch`` span with the stages laid out from the batch's start
        (this path really is sequential)."""
        t0 = time.monotonic()
        with self._lock:
            algorithms, models, serving = \
                self.algorithms, self.models, self.serving
            binding_id = self.binding_id
        traces = [self._trace_of(o) for o in (obs_list or [])]
        traces += [None] * (len(query_jsons) - len(traces))
        out: List[Any] = [None] * len(query_jsons)
        parsed, rows = [], []
        self.overlap.enter("assemble")
        try:
            for i, qj in enumerate(query_jsons):
                try:
                    parsed.append(from_jsonable(algorithms[0].query_class,
                                                qj))
                    rows.append(i)
                except (TypeError, ValueError) as e:
                    out[i] = HTTPError(400, str(e))
        finally:
            self.overlap.exit("assemble")
        phases: Dict[str, float] = {"assemble": time.monotonic() - t0}
        if parsed:
            if self.overlap.enter(DEVICE_TRACK) > 0:
                self._pipeline_overlapped.inc()
            try:
                with activate_traces(traces):
                    fire(F_DISPATCH)
                served = predict_serve_batch(algorithms, models, serving,
                                             parsed, timings=phases,
                                             pool=self._pool)
            finally:
                self.overlap.exit(DEVICE_TRACK)
            self.overlap.enter("readback")
            try:
                for j, i in enumerate(rows):
                    out[i] = self._render(served[j], phases, query_jsons[i])
            finally:
                self.overlap.exit("readback")
        dt = time.monotonic() - t0
        self._record_phases(phases)
        self._batch_occupancy.observe(len(query_jsons))
        batch_obs = {"batchSize": len(query_jsons)}
        batch_obs.update({f"{k}Ms": round(v * 1000, 3)
                          for k, v in phases.items()})
        for i, result in enumerate(out):
            # each coalesced query experienced the batch's wall time
            self._latency_hist.observe(dt)
            self._observe_release(ARM_STABLE, dt, error=_is_5xx(result))
            if isinstance(result, HTTPError):
                self._query_errors.labels(status=str(result.status)).inc()
            tr = traces[i]
            if tr is not None:
                tr.set_attr("engineInstanceId", binding_id)
                tr.set_attr("arm", ARM_STABLE)
                parent = tr.add_span("batch", t0, t0 + dt,
                                     batchSize=len(query_jsons))
                add_stage_spans(tr, t0, phases, parent_id=parent.span_id,
                                skip=("queue_wait",))
                tr.exemplar(self._latency_hist.labels(), dt)
            if obs_list is not None and i < len(obs_list) \
                    and obs_list[i] is not None:
                obs_list[i].update(batch_obs)
        self._count(len(query_jsons), dt * len(query_jsons))
        return out

    def _render(self, prediction: Any, phases: Dict[str, float],
                query_json: Any) -> Any:
        """One served prediction as JSON through the output plugins, or
        the 500 it becomes. The batch's ``readback`` phase is the slowest
        query's serialization, not the sum over the batch."""
        if isinstance(prediction, HTTPError):
            return prediction
        if isinstance(prediction, Exception):
            return HTTPError(500, str(prediction))
        t0 = time.monotonic()
        try:
            result = to_jsonable(prediction)
            phases["readback"] = max(phases.get("readback", 0.0),
                                     time.monotonic() - t0)
            return self.plugins.process_output(query_json, result)
        except Exception as e:  # noqa: BLE001 — isolate per query
            return HTTPError(500, str(e))

    def _finish_pipeline_batch(self, ab: "_AssembledBatch",
                               results: List[Any]) -> None:
        """The readback stage's tail: render each resolved prediction,
        record the batch and its traces, wake the callers."""
        final = [self._render(r, ab.phases, e.query_json)
                 for r, e in zip(results, ab.entries)]
        now = time.monotonic()
        self._record_phases(ab.phases)
        self._batch_occupancy.observe(len(ab.entries))
        self._trace_pipeline_batch(ab, now)
        batch_obs = {"batchSize": len(ab.entries), "pipeline": "staged"}
        batch_obs.update({f"{k}Ms": round(v * 1000, 3)
                          for k, v in ab.phases.items()})
        total = 0.0
        for entry, result in zip(ab.entries, final):
            # end to end per query, its queue wait included
            dt = now - entry.t_enq
            total += dt
            self._latency_hist.observe(dt)
            self._observe_release(ARM_STABLE, dt, error=_is_5xx(result))
            if isinstance(result, HTTPError):
                self._query_errors.labels(status=str(result.status)).inc()
            if entry.obs is not None:
                entry.obs.update(batch_obs)
            entry.result = result
            entry.done.set()
        self._count(len(ab.entries), total)

    def _trace_pipeline_batch(self, ab: "_AssembledBatch",
                              now: float) -> None:
        """The staged timeline on every traced query of the batch: a
        ``batch`` span, ``queue_wait`` from the query's own enqueue, the
        host stages (assemble, supplement) from the pickup, and the device
        stages (dispatch, device_wait, serve, readback) from the REAL
        dispatch time, so the hops between stage threads show as gaps."""
        if self.tracer is None:
            return
        phases = ab.phases
        host = {k: phases[k] for k in ("assemble", "supplement")
                if k in phases}
        device = {k: phases[k]
                  for k in ("dispatch", "device_wait", "serve", "readback")
                  if k in phases}
        for entry in ab.entries:
            tr = self._trace_of(entry.obs)
            if tr is None:
                continue
            tr.set_attr("engineInstanceId", ab.binding_id)
            tr.set_attr("arm", ARM_STABLE)
            tr.set_attr("pipeline", "staged")
            wait = (entry.obs or {}).get("queueWaitMs", 0.0) / 1000.0
            t_pick = entry.t_enq + wait
            parent = tr.add_span("batch", t_pick, now,
                                 batchSize=len(ab.entries))
            if wait > 0:
                tr.add_span("queue_wait", entry.t_enq, t_pick,
                            parent_id=parent.span_id)
            add_stage_spans(tr, t_pick, host,
                            order=("assemble", "supplement"),
                            parent_id=parent.span_id)
            add_stage_spans(
                tr, ab.t_dispatched if ab.t_dispatched is not None
                else t_pick, device,
                order=("dispatch", "device_wait", "serve", "readback"),
                parent_id=parent.span_id)
            tr.exemplar(self._latency_hist.labels(), now - entry.t_enq)

    def pipeline_status(self) -> dict:
        """The batch path for ``/status.json``: architecture, deadline
        accounting, and the overlap of the device with the host stages
        (the JAX package's keys)."""
        b = self.batcher
        mode = ("staged" if isinstance(b, StagedPipeline)
                else "serial" if b is not None else "off")
        exceeded = self.deadline_exceeded
        overlapped = self.overlapped_dispatches
        out: dict = {
            "mode": mode,
            "deadlineMs": self.config.queue_deadline_ms,
            "deadlineExceeded": exceeded,
        }
        if isinstance(b, StagedPipeline):
            out["assembleWorkers"] = self.config.assemble_workers
            out["readbackWorkers"] = self.config.readback_workers
            out["depth"] = b.depth  # resolved (0 = auto in the config)
            out["inFlight"] = self.overlap.active(DEVICE_TRACK)
        snap = self.overlap.snapshot()
        if snap["wall_sec"] > 0:
            out["overlap"] = {
                "wallSec": round(snap["wall_sec"], 3),
                "deviceBusySec": round(snap["device_busy_sec"], 3),
                "deviceIdleFraction": round(
                    snap["device_idle_fraction"], 4),
                "overlapFraction": round(snap["overlap_fraction"], 4),
                "overlappedDispatches": overlapped,
            }
        return out

    # -- warm-up and lifecycle -----------------------------------------------
    @property
    def lifecycle(self) -> str:
        """``warming`` | ``ready`` | ``draining``: what ``/status.json``
        advertises. Draining means "finish what is in flight, send
        nothing new"; the server keeps answering."""
        if self.drain_started.is_set():
            return "draining"
        return "ready" if self.warm_done.is_set() else "warming"

    def enter_drain(self) -> None:
        """Irreversible: announce the drain (``POST /drain``). Queries are
        still answered; every surface reports ``draining``."""
        self.drain_started.set()

    def _serving_kernels(self, algorithms: List[Any]) -> List[str]:
        """The kernel libraries this binding launches on the card: each
        algorithm's ``serving_kernels``, and the fold-in's when
        streaming. None on the CPU, where the plain versions serve."""
        if self.device.type != "cuda":
            return []
        names = [n for a in algorithms
                 for n in getattr(a, "serving_kernels", ())]
        if self.config.streaming:
            names += ["fused_gram", "chol_solve"]
        return list(dict.fromkeys(names))

    def _start_warm(self, gen: int) -> None:
        t = threading.Thread(target=self._warm_serving,
                             args=(gen, time.monotonic()), daemon=True,
                             name=f"serving-warmup-{gen}")
        with self._lock:
            self._warm_threads = [w for w in self._warm_threads
                                  if w.is_alive()] + [t]
        t.start()

    def _rewarm(self) -> None:
        """Re-warm after a rebind (reload, promotion) under a new
        generation, so ``/status.json`` reads ``warming`` until the new
        binding's ladder ran."""
        if not self.config.warm_start:
            return
        with self._lock:  # pairs with _warm_serving's check-and-set
            self._warm_gen += 1
            gen = self._warm_gen
            self.warm_done.clear()
        self._start_warm(gen)

    def _warm_serving(self, gen: int, since: Optional[float] = None
                      ) -> None:
        """Warm the binding of generation ``gen``, in three phases:
        ``load`` (the kernel libraries it launches, :func:`_build.
        load_all`), ``compile`` (the seconds ``nvcc`` ran for the ones not
        on disk; 0 when ``pio build`` built them all) and ``probe``
        (each algorithm's ``warm_serving(model, max_batch)``, which on
        the card launches the kernels at every batch and k of the
        ladder). ``replicate`` is 0: one card serves. A failure is logged
        and its text kept in the report's ``error``; the queries that
        follow take the same path and raise the same way. Only the
        newest generation sets ``warm_done``. ``since`` is when the
        binding was made: a library a query compiled after it (before
        the load took the lock) counts as compiled at this bind."""
        with self._lock:
            algorithms, models = self.algorithms, self.models
        max_b = self.config.max_batch if self.config.batching else 1
        phases = {"load": 0.0, "compile": 0.0, "replicate": 0.0,
                  "probe": 0.0}
        errors: List[str] = []
        libraries: dict = {}
        compiled = False
        launches0 = _fused_topk.LAUNCHES
        calls = 0
        try:
            loaded = _build.load_all(self._serving_kernels(algorithms),
                                     since=since)
            libraries = loaded["libraries"]
            compiled = any(r["compiled"] for r in libraries.values())
            phases["compile"] = loaded["compileSeconds"]
            phases["load"] = loaded["seconds"] - loaded["compileSeconds"]
        except Exception as e:  # noqa: BLE001 — reported, never hidden
            log.exception("loading the serving kernels failed")
            errors.append(str(e))
        if not errors:
            t0 = time.perf_counter()
            for algo, model in zip(algorithms, models):
                warm = getattr(algo, "warm_serving", None)
                if warm is None:
                    continue
                try:
                    calls += warm(model, max_b) or 0
                except Exception as e:  # noqa: BLE001 — warm the rest
                    log.exception("serving warm-up failed for %s",
                                  type(algo).__name__)
                    errors.append(str(e))
            phases["probe"] = time.perf_counter() - t0
        for phase, sec in phases.items():
            self._warmup_seconds.labels(phase=phase).observe(sec)
        report = {
            # no nvcc ran at this bind: every library was on disk
            "artifact": not errors and not compiled,
            "root": str(_build.root()),
            "libraries": libraries,
            "probeCalls": calls,
            "launches": {"fused_topk": _fused_topk.LAUNCHES - launches0},
            "seconds": {k: round(v, 4) for k, v in phases.items()},
            "totalSeconds": round(sum(phases.values()), 4),
        }
        if errors:
            report["error"] = "; ".join(errors)
        with self._lock:
            if gen == self._warm_gen:
                self._warm_report = report
                self.warm_done.set()

    def status(self) -> dict:
        with self._lock:
            models, inst = self.models, self.instance
            report = self._warm_report
            avg, last = self.avg_serving_sec, self.last_serving_sec
            requests, stream = self.request_count, self.stream
        return {
            "status": "alive",
            "engineId": inst.engine_id if inst else None,
            "engineVersion": inst.engine_version if inst else None,
            "engineVariant": inst.engine_variant if inst else None,
            "engineInstanceId": inst.id if inst else None,
            "release": self.release_summary(),
            "device": str(self.device),
            "card": self.card["name"],
            "powerLimit": self.card["power_limit"],
            "servingQuant": serving_quant_of(models[0]) if models else "off",
            "servingQuantRequested": self.config.serving_quant,
            "batching": self.config.batching,
            "pipeline": self.pipeline_status(),
            "kernels": {"fused_topk": {
                "launches": _fused_topk.LAUNCHES}},
            "requestCount": requests,
            "avgServingSec": avg,
            "lastServingSec": last,
            "servingWarm": self.warm_done.is_set(),
            "artifactWarm": bool(report.get("artifact")),
            "warmReport": report,
            "lifecycle": self.lifecycle,
            "lineage": self.stream_lineage(),
            "stream": (stream.status() if stream is not None
                       else {"running": False}),
            "trace": (self.tracer.status() if self.tracer is not None
                      else {"enabled": False}),
            "hotKeys": (self.hotkeys.snapshot() if self.hotkeys is not None
                        else {"enabled": False}),
            "slo": self.slo_status(),
            "profile": self.profile_summary(),
            "degraded": self.degraded_status(),
            "hbm": hbm_stats(),
            "cache": (self.cache.stats() if self.cache is not None
                      else {"enabled": False}),
            **self.phase_table(),
        }

    def profile_summary(self) -> dict:
        """The ``profile`` block of ``/status.json``: whether a capture
        runs, and the last one finished (``GET /profile.json`` has
        them all)."""
        st = self.profiler.status()
        return {"active": st["active"] is not None,
                "baseDir": st["baseDir"],
                "captures": len(st["history"]),
                "last": st["history"][-1] if st["history"] else None}

    def degraded_status(self) -> dict:
        """The ``degraded`` block of ``/status.json``: ``nonfinite`` once
        a NaN/Inf sentinel saw a nonfinite value, ``faultInjection``
        while a fault spec is armed in the process. (The JAX package's
        lane keys are queue 1 item 13's.)"""
        nonfinite = numerics.active() and numerics.nonfinite_seen()
        return {"active": nonfinite, "nonfinite": nonfinite,
                "faultInjection": fault_registry().enabled()}

    def phase_table(self) -> dict:
        """Percentile summaries of the phase, latency, occupancy and
        queue-depth families, for ``/status.json``."""
        snap = self.metrics.snapshot()
        out = {}
        for key, label in (("pio_query_phase_seconds", "phases"),
                           ("pio_query_latency_seconds", "latency"),
                           ("pio_batch_occupancy", "batchOccupancy"),
                           ("pio_queue_depth", "queueDepth")):
            v = snap.get(key)
            if v:
                out[label] = v
        return out

    def spans_summary(self) -> dict:
        """Percentile rows for the status page: each query phase and the
        end-to-end latency, from the live histograms."""
        out: dict = {}

        def row(hist) -> Optional[dict]:
            s = hist.snapshot()
            if not s.get("count"):
                return None
            return {"count": s["count"], "p50": s["p50"],
                    "p90": s["p90"], "p99": s["p99"],
                    "max_sec": s["max"]}

        for items, child in self._phase_hist.children():
            r = row(child)
            if r is not None:
                out["phase:" + dict(items).get("phase", "?")] = r
        for _, child in self._latency_hist.children():
            r = row(child)
            if r is not None:
                out["query (end-to-end)"] = r
        return out

    def close(self, timeout: float = 5.0) -> None:
        """Stop the rollout's gate thread, the stream trainer, the SLO
        engine, the batch path's threads (queued queries still serve), a
        profiler capture, the shadow mirrors, the plugins' sniffer thread
        and the pool, and join the warm-up threads and the hot tier's
        refresh thread, each within ``timeout``; detach the numerics
        listener. Idempotent."""
        # ptpu: guarded-by[_release_lock] — one read of the reference
        # start_canary swaps whole under _release_lock
        rollout = self.rollout
        if rollout is not None:
            rollout.stop()
        self.stop_stream()
        self.stop_slo()
        if self.batcher is not None:
            self.batcher.close(timeout)
        self.profiler.close(timeout)
        with self._lock:
            mirrors = self._mirror_pool
        if mirrors is not None:
            mirrors.shutdown(wait=True)
        self.plugins.close()
        self._pool.shutdown(wait=True)
        with self._lock:
            warm_threads = list(self._warm_threads)
        for t in warm_threads:
            t.join(timeout)
        if self.cache is not None:
            self.cache.close()
        if self._numerics_listener is not None:
            numerics.remove_listener(self._numerics_listener)
            self._numerics_listener = None
        fault_registry().remove_listener(self._on_fault)

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
        the new base). After the swap the serving cache drops the cached
        answers of exactly the ``touched_entities`` and their pinned
        rows, and re-pins when a pinned entry dropped."""
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
            cache = self.cache
        if cache is not None and touched_entities:
            # per entity, not a flush: the untouched entities' answers
            # are still exactly right
            cache.invalidate_entities("user", touched_entities)
            # re-pin only when the swap dropped a pinned entry: the
            # untouched pinned rows did not change
            if cache.hot is not None \
                    and cache.hot.invalidate(touched_entities):
                cache.hot.refresh(wait=False)
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
            instance_id = self.binding_id
        trainer.start()
        self._record_release(
            "stream-start", instance_id=instance_id,
            actor=f"stream-trainer:{cfg.consumer}",
            reason=f"tailing app {cfg.app_name!r} every "
                   f"{cfg.interval_ms:g}ms")
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
            instance_id = self.binding_id
        if trainer is None:
            return False
        trainer.stop(timeout=timeout)
        self._record_release(
            "stream-stop", instance_id=instance_id,
            actor=f"stream-trainer:{trainer.config.consumer}",
            reason=f"{trainer.applies} deltas applied, "
                   f"{trainer.events_consumed} events consumed")
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
            inst = self.instance
        now = time.time()
        trained = getattr(inst, "end_time", None)
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

    # -- releases ------------------------------------------------------------
    def _record_release(self, action: str, **kw) -> None:
        """A history event without a state change; best-effort (a failed
        write is logged, never raised into serving), and nothing where
        the server has no registry."""
        if self.releases is None:
            return
        try:
            self.releases.record(action, **kw)
        except Exception as e:  # noqa: BLE001 — history is best-effort
            log.error("release history write failed on %s: %s", action, e)

    def _require_releases(self) -> ReleaseRegistry:
        if self.releases is None:
            raise HTTPError(
                409, "releases need the storage the models came from: "
                     "deploy from storage (deploy / the deploy command), "
                     "not deploy_models")
        return self.releases

    def _observe_release(self, arm: str, seconds: float,
                         error: bool) -> None:
        """Per-arm health series, recorded only while a rollout is live
        (the controller windows these; a client's 4xx never counts
        against an arm)."""
        # ptpu: guarded-by[_release_lock] — one read of the reference
        # start_canary swaps whole; a query must not wait on the lock a
        # canary's bind holds
        rollout = self.rollout
        if rollout is None or not rollout.active:
            return
        self._release_queries.labels(arm=arm).inc()
        if error:
            self._release_errors.labels(arm=arm).inc()
        self._release_latency.labels(arm=arm).observe(seconds)

    def release_arm_snapshot(self, arm: str):
        """Cumulative ``(queries, errors, latency buckets)`` of one
        release arm: the rollout controller diffs successive snapshots
        into windows."""
        return (self._release_queries.labels(arm=arm).value,
                self._release_errors.labels(arm=arm).value,
                self._release_latency.labels(arm=arm).bucket_counts())

    def release_arms(self) -> dict:
        """Per-arm queries, errors and latency for ``/release.json``."""
        out = {}
        for arm in (ARM_STABLE, ARM_CANDIDATE):
            queries, errors, _ = self.release_arm_snapshot(arm)
            out[arm] = {
                "queries": int(queries), "errors": int(errors),
                "latency": self._release_latency.labels(
                    arm=arm).snapshot()}
        return out

    def release_summary(self) -> dict:
        """The compact release state of ``/status.json``."""
        # ptpu: guarded-by[_release_lock] — one read of the swapped
        # reference, as in _observe_release
        rollout = self.rollout
        active = rollout is not None and rollout.active
        state: dict = {}
        if self.releases is not None:
            try:
                state = self.releases.state()
            except Exception as e:  # noqa: BLE001 — status must render
                log.error("release registry read failed: %s", e)
        with self._lock:
            stable = self.instance.id if self.instance else None
        return {
            "stable": stable,
            "pinned": state.get("pinned", ""),
            "candidate": self.candidate_instance_id or "",
            "mode": (("shadow" if rollout.shadow else "canary")
                     if active else ""),
            "fraction": rollout.splitter.fraction if active else 0.0,
        }

    def reload(self) -> str:
        """Rebind through the release registry: the PINNED release when
        one is set (409 when it is missing or not COMPLETED), else the
        latest COMPLETED instance of the serving triple (404 when there
        is none). Every reload is a recorded release action."""
        from ..workflow import core as wf

        releases = self._require_releases()
        instances = self.ctx.storage.engine_instances()
        pinned = None
        try:
            pinned = releases.pinned_instance()
        except Exception as e:  # noqa: BLE001 — the registry must never
            log.error(          # make a model unreloadable
                "release registry read failed; reloading latest: %s", e)
        with self._lock:
            serving_instance = self.instance
            engine_params = self.engine_params
        if pinned:
            latest = instances.get(pinned)
            if latest is None or latest.status != STATUS_COMPLETED:
                raise HTTPError(
                    409, f"pinned release {pinned!r} is not a "
                         f"COMPLETED engine instance (unpin or re-pin)")
        else:
            latest = instances.get_latest_completed(
                serving_instance.engine_id,
                serving_instance.engine_version,
                serving_instance.engine_variant)
            if latest is None:
                raise HTTPError(
                    404, "no COMPLETED engine instance to reload")
        models = wf.load_models_for_deploy(self.ctx, self.engine, latest,
                                           engine_params)
        self._bind(engine_params, models, latest)
        self._rewarm()
        try:
            releases.record_deploy(
                latest.id, actor="/reload",
                reason=("pinned release" if pinned
                        else "latest COMPLETED instance"))
        except Exception as e:  # noqa: BLE001 — history is best-effort
            log.error("release history write failed on reload: %s", e)
        log.info("reloaded engine instance %s%s", latest.id,
                 " (pinned)" if pinned else "")
        return latest.id

    def bind_candidate(self, instance: EngineInstance,
                       engine_params: Optional[EngineParams] = None,
                       models: Optional[List[Any]] = None) -> None:
        """Bind a candidate release BESIDE the stable one (stable serving
        is untouched): the stable arm's quantization behind the same
        parity probe, its tables placed on the serving device once, here.
        The candidate serves each query alone (B = 1): at canary
        fractions there is nothing to coalesce."""
        from ..workflow import core as wf

        with self._lock:
            stable_params = self.engine_params
        ep = engine_params or stable_params
        if models is None:
            models = wf.load_models_for_deploy(self.ctx, self.engine,
                                               instance, ep)
        algorithms, prepared = self._serving_algorithms(ep, list(models))
        binding = CandidateBinding(
            engine_params=ep, algorithms=algorithms, models=prepared,
            raw_models=list(models), serving=self.engine.make_serving(ep),
            instance=instance, warm_done=threading.Event())
        binding.warm_done.set()
        with self._lock:
            self._candidate = binding
            stable_id = self.binding_id
        log.info("candidate release %s bound beside stable %s",
                 instance.id, stable_id)

    def drop_candidate(self) -> None:
        with self._lock:
            cand = self._candidate
            self._candidate = None
        if cand is not None and self.cache is not None:
            # a rollback: the dead arm's cached answers die with it; the
            # stable arm's namespace, still serving, stays
            self.cache.flush_namespace(cand.instance.id)

    @property
    def candidate_instance_id(self) -> Optional[str]:
        with self._lock:
            cand = self._candidate
        return cand.instance.id if cand is not None else None

    def promote_candidate(self) -> str:
        """Swap the candidate in as the stable release through the same
        single-lock :meth:`_bind` every deploy and reload takes: a query
        sees the old binding or the new one in full, never a mix. 409
        when none is bound."""
        with self._lock:
            cand = self._candidate
        if cand is None:
            raise HTTPError(409, "no candidate release bound")
        self._bind(cand.engine_params, cand.raw_models, cand.instance,
                   promoted=cand)
        self._rewarm()
        log.info("candidate %s promoted to serving stable",
                 cand.instance.id)
        return cand.instance.id

    def start_canary(self, instance_id: str,
                     fraction: Optional[float] = None,
                     shadow: bool = False, actor: str = "",
                     reason: str = "", policy=None,
                     models: Optional[List[Any]] = None):
        """Bind ``instance_id`` as the candidate and start the
        health-gated rollout (canary split or shadow mirror). Returns
        the live :class:`~predictionio_tpu_torch.rollout.RolloutController`.
        409 while one is live, 404 for an unknown instance, 400 for one
        not COMPLETED or already the stable."""
        from ..rollout import HealthPolicy, RolloutController

        releases = self._require_releases()
        with self._release_lock:
            previous = self.rollout
            if previous is not None and previous.active:
                raise HTTPError(409, "a rollout is already in progress "
                                f"(candidate {previous.instance_id})")
            # ptpu: allow[blocking-under-lock] — _release_lock makes one
            # canary at a time atomic: the live-rollout check, this read
            # and the candidate's bind below happen under it (the JAX
            # package checks and binds unlocked: ROADMAP.md queue 3).
            # Release calls take it; no query does.
            inst = self.ctx.storage.engine_instances().get(instance_id)
            if inst is None:
                raise HTTPError(
                    404, f"engine instance {instance_id!r} not found")
            if inst.status != STATUS_COMPLETED:
                raise HTTPError(
                    400, f"instance {instance_id!r} is {inst.status}, "
                         f"not {STATUS_COMPLETED}")
            with self._lock:
                stable_id = self.instance.id if self.instance else None
            if inst.id == stable_id:
                raise HTTPError(
                    400, f"instance {instance_id!r} is already the "
                         f"serving stable")
            if previous is not None:
                previous.stop()  # concluded: join its gate thread
            # ptpu: allow[blocking-under-lock] — the bind that the
            # check-then-bind under _release_lock protects (see above)
            self.bind_candidate(inst, models=models)
            pol = policy or HealthPolicy()
            mode = "shadow" if shadow else "canary"
            start_fraction = (fraction if fraction is not None
                              else (1.0 if shadow else pol.ramp[0]))
            try:
                releases.start_candidate(
                    inst.id, start_fraction, mode=mode, actor=actor,
                    reason=reason)
            except Exception as e:  # noqa: BLE001 — history is best-effort
                log.error("release history write failed on %s: %s",
                          mode, e)
            controller = RolloutController(
                self, releases, inst.id, policy=pol,
                fraction=start_fraction, shadow=shadow,
                actor=actor or "engine-server")
            self.rollout = controller
            controller.start()
        return controller

    def serve_candidate(self, query_json: Any,
                        obs: Optional[dict] = None) -> Any:
        """The candidate arm's serving entry: the cache discipline of
        :meth:`serve` under the CANDIDATE instance's namespace, so the two
        arms never serve each other's cached answers. Raises like
        :meth:`query_candidate`."""
        if self.hotkeys is not None:
            self.hotkeys.record(self._entity_of(query_json))
        with self._lock:
            cand = self._candidate
        if self.cache is None or cand is None:
            return self.query_candidate(query_json, obs=obs)
        return self._serve_cached(
            cand.instance.id, query_json, obs, ARM_CANDIDATE,
            lambda: self.query_candidate(query_json, obs=obs))

    def query_candidate(self, query_json: Any,
                        obs: Optional[dict] = None) -> Any:
        """Serve one query off the CANDIDATE binding (canary route or
        shadow mirror), alone: no micro-batching. 503 when no candidate
        is bound, 400 for a malformed query (not counted against the
        arm); a failure past parsing is counted and raised. A traced
        query gets one ``candidate_serve`` span."""
        t0 = time.monotonic()
        with self._lock:
            cand = self._candidate
        if cand is None:
            raise HTTPError(503, "no candidate release bound")
        try:
            query = from_jsonable(cand.algorithms[0].query_class,
                                  query_json)
        except (TypeError, ValueError) as e:
            self._query_errors.labels(status="400").inc()
            raise HTTPError(400, str(e)) from e
        try:
            supplemented = cand.serving.supplement(query)
            predictions = [a.predict(m, supplemented)
                           for a, m in zip(cand.algorithms, cand.models)]
            result = to_jsonable(cand.serving.serve(query, predictions))
            result = self.plugins.process_output(query_json, result)
        except Exception:
            self._query_errors.labels(status="500").inc()
            self._observe_release(ARM_CANDIDATE, time.monotonic() - t0,
                                  error=True)
            raise
        dt = time.monotonic() - t0
        self._observe_release(ARM_CANDIDATE, dt, error=False)
        if obs is not None:
            obs["releaseArm"] = ARM_CANDIDATE
            tr = self._trace_of(obs)
            if tr is not None:
                tr.set_attr("arm", ARM_CANDIDATE)
                tr.set_attr("engineInstanceId", cand.instance.id)
                tr.add_span("candidate_serve", t0, t0 + dt)
        self._count(1, dt)
        return result

    def mirror_to_candidate(self, query_json: Any) -> None:
        """Shadow mode: replay the query against the candidate on a
        mirror thread. The answer is discarded (the arm's series keep the
        outcome); errors are counted and swallowed, so mirroring never
        slows or fails stable traffic."""
        with self._lock:
            if self._mirror_pool is None:
                self._mirror_pool = ThreadPoolExecutor(
                    max_workers=4, thread_name_prefix="shadow-mirror")
            pool = self._mirror_pool

        def _mirror():
            try:
                self.query_candidate(query_json)
            except Exception:  # noqa: BLE001 — counted in the arm's series
                pass

        self._shadow_mirrors.inc()
        pool.submit(_mirror)


class _Submit:
    """One caller's queue entry: the query, its completion slot, its
    deadline and its request's obs dict (the access-log fields and the
    live trace). The caller blocks on ``done``; whichever stage finishes
    or sheds the entry writes ``result`` and sets it. ``abandoned`` flips
    when the caller's deadline passed: later stages skip the entry
    instead of launching work nobody will read."""

    __slots__ = ("query_json", "done", "result", "t_enq", "deadline",
                 "abandoned", "obs")

    def __init__(self, query_json: Any, deadline_sec: float = 0.0,
                 obs: Optional[dict] = None):
        self.query_json = query_json
        self.done = threading.Event()
        self.result: Any = None
        self.t_enq = time.monotonic()
        self.deadline = (self.t_enq + deadline_sec if deadline_sec > 0
                         else None)
        self.abandoned = False
        self.obs = obs


def _is_5xx(result: Any) -> bool:
    """A server-side error answer: what counts against a release arm."""
    return isinstance(result, HTTPError) and result.status >= 500


#: close sentinel of the batch paths' queues: each worker consumes
#: exactly one and exits; :func:`_form_batch` hands back any it pulls on
#: a sibling's behalf
_CLOSE = object()


def _deadline_submit(batcher, server: QueryServer, query_json: Any,
                     obs: Optional[dict] = None) -> Any:
    """Enqueue, wait at most the deadline, and on expiry shed: count it,
    mark the entry abandoned so pickup skips it, and answer 503 rather
    than hold the HTTP worker on a wedged launch."""
    e = _Submit(query_json, batcher.deadline_sec, obs)
    batcher._q.put(e)
    if e.deadline is None:
        e.done.wait()
        return e.result
    if e.done.wait(timeout=batcher.deadline_sec):
        return e.result
    e.abandoned = True
    server._deadline_exceeded.inc()
    server._query_errors.labels(status="503").inc()
    return HTTPError(
        503, f"query shed: not served within the "
             f"{batcher.deadline_sec * 1000.0:.0f}ms queue deadline "
             f"(server saturated or dispatch wedged)")


def _form_batch(q: "queue.Queue", first: _Submit, max_batch: int,
                window: float) -> List[_Submit]:
    """Greedy batch formation, shared by both architectures: everything
    already queued, up to ``max_batch``, with no timed wait, so the batch
    size follows arrival rate times service time; a lone query waits the
    window once for a concurrent arrival. An entry whose caller already
    gave up completes as a 503 here and never joins the batch."""
    batch: List[_Submit] = []

    def admit(e: _Submit) -> None:
        if e.abandoned or (e.deadline is not None
                           and time.monotonic() > e.deadline):
            # the caller has its (counted) 503 already: complete the
            # entry so no stage spends device time on it
            e.result = HTTPError(503, "query deadline exceeded while "
                                      "queued")
            e.done.set()
            return
        batch.append(e)

    admit(first)
    waited = False
    while len(batch) < max_batch:
        try:
            nxt = q.get_nowait()
        except queue.Empty:
            if waited or len(batch) > 1 or window <= 0:
                break
            waited = True
            try:
                nxt = q.get(timeout=window)
            except queue.Empty:
                break
        if nxt is _CLOSE:
            q.put(nxt)  # a sibling's sentinel: hand it back
            break
        admit(nxt)
    return batch


class MicroBatcher:
    """The SERIAL architecture (``serving_pipeline="serial"``): each HTTP
    worker enqueues its query and blocks; ``pipeline`` drainer threads
    each take a batch (:func:`_form_batch`) and run
    :meth:`QueryServer.query_batch` on it (parse, supplement, launch,
    wait, serve), then wake its callers."""

    def __init__(self, server: QueryServer, window_ms: float = 2.0,
                 max_batch: int = 128, pipeline: int = 4,
                 deadline_ms: float = 0.0):
        self.server = server
        self.window = max(window_ms, 0.0) / 1000.0
        self.max_batch = max(max_batch, 1)
        self.deadline_sec = max(deadline_ms, 0.0) / 1000.0
        # ptpu: allow[unbounded-queue] — every entry has an HTTP worker
        # thread blocked on it, so the depth is bounded by the server's
        # connection concurrency; with a queue deadline, _deadline_submit
        # sheds past it with a counted 503
        self._q: "queue.Queue" = queue.Queue()
        self._threads = [
            threading.Thread(target=self._drain, daemon=True,
                             name=f"query-microbatcher-{i}")
            for i in range(max(pipeline, 1))]
        for t in self._threads:
            t.start()

    def submit(self, query_json: Any, obs: Optional[dict] = None) -> Any:
        return _deadline_submit(self, self.server, query_json, obs)

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

    def _drain(self) -> None:
        server = self.server
        while True:
            first = self._q.get()
            if first is _CLOSE:
                return
            # the backlog this batch found at pickup
            server._queue_depth.observe(self._q.qsize() + 1)
            batch = _form_batch(self._q, first, self.max_batch, self.window)
            if not batch:
                continue
            t_pick = time.monotonic()
            qwait = server._phase_hist.labels(phase="queue_wait")
            for e in batch:
                wait = t_pick - e.t_enq
                qwait.observe(wait)
                if e.obs is not None:
                    e.obs["queueWaitMs"] = round(wait * 1000, 3)
                    tr = server._trace_of(e.obs)
                    if tr is not None:
                        tr.add_span("queue_wait", e.t_enq, t_pick)
            try:
                results = server.query_batch(
                    [e.query_json for e in batch],
                    obs_list=[e.obs for e in batch])
            except Exception as exc:  # noqa: BLE001 — fail the batch, keep draining
                log.exception("batched query failed")
                results = [HTTPError(500, str(exc))] * len(batch)
            for e, result in zip(batch, results):
                e.result = result
                e.done.set()


class _AssembledBatch:
    """A batch between the pipeline's stages: what the assemble stage
    made of it, and the binding it was assembled against. Every stage
    uses that binding, so a rebind mid-flight serves a batch wholly from
    the old binding or wholly from the new one, never a mix."""

    __slots__ = ("entries", "queries", "out", "live", "supplemented",
                 "algorithms", "models", "serving", "binding_id", "phases",
                 "pending", "t_dispatched")

    def __init__(self, entries, queries, out, live, supplemented,
                 algorithms, models, serving, binding_id, phases):
        self.entries = entries
        self.queries = queries
        self.out = out
        self.live = live
        self.supplemented = supplemented
        self.algorithms = algorithms
        self.models = models
        self.serving = serving
        self.binding_id = binding_id
        self.phases = phases
        self.pending: Optional[PendingBatch] = None
        #: when the dispatch stage picked the batch up: the anchor of the
        #: device stages' spans
        self.t_dispatched: Optional[float] = None


class StagedPipeline:
    """The STAGED architecture (``serving_pipeline="staged"``, the
    default): three stages with bounded hand-off queues.

    - **assemble** (``assemble_workers`` threads): takes an in-flight
      slot, then forms a batch (:func:`_form_batch`), parses it (a
      malformed query completes with its 400 here, never riding a launch)
      and supplements it, while the card runs earlier batches.
    - **dispatch** (``dispatch_workers`` threads, all on the device's
      current stream): launches the batch
      (:func:`~predictionio_tpu_torch.workflow.batch_predict.dispatch_batch`:
      for ALS one ``fused_topk`` launch with its readback copies queued
      behind it) and returns at once, so batch k+1 launches before batch
      k is read back.
    - **readback** (``readback_workers`` threads): waits for a batch's
      results, frees its slot, serves and renders them and wakes the
      callers (:meth:`QueryServer._finish_pipeline_batch`).

    The in-flight slots (``depth``) bound the batches between pickup and
    readback: while they are taken nobody reads the submit queue, so
    arrivals pool there (where the deadline sheds them) and the next
    pickup takes them all as one batch."""

    def __init__(self, server: QueryServer, window_ms: float = 2.0,
                 max_batch: int = 128, assemble_workers: int = 1,
                 readback_workers: int = 4, depth: int = 0,
                 deadline_ms: float = 0.0, dispatch_workers: int = 1):
        self.server = server
        self.window = max(window_ms, 0.0) / 1000.0
        self.max_batch = max(max_batch, 1)
        self.deadline_sec = max(deadline_ms, 0.0) / 1000.0
        if depth <= 0:
            # auto: shallow where the "device" shares the host's cores
            # (deep pipelines only shred the batches), deep on the card
            depth = 2 if server.device.type == "cpu" else 4
        self.depth = depth
        # ptpu: allow[unbounded-queue] — every entry has an HTTP worker
        # thread blocked on it, so the depth is bounded by the server's
        # connection concurrency; with a queue deadline, _deadline_submit
        # sheds past it with a counted 503
        self._q: "queue.Queue" = queue.Queue()
        self._dispatch_q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._readback_q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._inflight = threading.BoundedSemaphore(depth)
        self._assemble_threads = [
            threading.Thread(target=self._assemble_loop, daemon=True,
                             name=f"pipeline-assemble-{i}")
            for i in range(max(assemble_workers, 1))]
        self._dispatch_threads = [
            threading.Thread(target=self._dispatch_loop, daemon=True,
                             name=f"pipeline-dispatch-{i}")
            for i in range(max(dispatch_workers, 1))]
        self._readback_threads = [
            threading.Thread(target=self._readback_loop, daemon=True,
                             name=f"pipeline-readback-{i}")
            for i in range(max(readback_workers, 1))]
        self._threads: List[threading.Thread] = (
            self._assemble_threads + self._dispatch_threads
            + self._readback_threads)
        for t in self._threads:
            t.start()

    def submit(self, query_json: Any, obs: Optional[dict] = None) -> Any:
        return _deadline_submit(self, self.server, query_json, obs)

    def close(self, timeout: float = 5.0) -> None:
        """Drain and stop stage by stage, upstream first: the assemble
        workers get their sentinels and are joined (nothing new enters),
        then dispatch, then readback. A stage is joined before the next
        is signalled, so a sentinel never overtakes a batch in flight and
        every queued query is still answered. Idempotent."""
        deadline = time.monotonic() + timeout
        for q, roster in ((self._q, self._assemble_threads),
                          (self._dispatch_q, self._dispatch_threads),
                          (self._readback_q, self._readback_threads)):
            live = [t for t in roster if t.is_alive()]
            for _ in live:
                q.put(_CLOSE)
            for t in live:
                t.join(timeout=max(0.0, deadline - time.monotonic()))

    # -- stage 1: assemble ---------------------------------------------------
    def _assemble_loop(self) -> None:
        server = self.server
        while True:
            # the in-flight slot FIRST: while the pipeline is full,
            # arrivals pool and the eventual pickup coalesces them
            self._inflight.acquire()
            handed_off = False
            try:
                first = self._q.get()
                if first is _CLOSE:
                    return  # the finally frees the slot
                depth = self._q.qsize() + 1
                server._queue_depth.observe(depth)
                server._pipeline_qdepth.labels(queue="submit").observe(
                    depth)
                batch = _form_batch(self._q, first, self.max_batch,
                                    self.window)
                if not batch:
                    continue
                t0 = time.monotonic()
                server.overlap.enter("assemble")
                try:
                    ab = self._assemble(batch)
                except Exception as e:  # noqa: BLE001 — isolate the batch
                    log.exception("assembling a batch failed")
                    for entry in batch:
                        entry.result = HTTPError(500, str(e))
                        entry.done.set()
                    ab = None
                finally:
                    server.overlap.exit("assemble")
                    server._pipeline_stage_hist.labels(
                        stage="assemble").observe(time.monotonic() - t0)
                if ab is not None and ab.entries:
                    self._dispatch_q.put(ab)
                    handed_off = True  # the readback stage frees the slot
            finally:
                if not handed_off:
                    self._inflight.release()

    def _assemble(self, batch: List[_Submit]) -> _AssembledBatch:
        server = self.server
        with server._lock:
            algorithms, models = server.algorithms, server.models
            serving, binding_id = server.serving, server.binding_id
        t_pick = time.monotonic()
        qwait = server._phase_hist.labels(phase="queue_wait")
        for e in batch:
            wait = t_pick - e.t_enq
            qwait.observe(wait)
            if e.obs is not None:
                e.obs["queueWaitMs"] = round(wait * 1000, 3)
        query_cls = algorithms[0].query_class
        entries: List[_Submit] = []
        queries: List[Any] = []
        t0 = time.monotonic()
        for e in batch:
            try:
                queries.append(from_jsonable(query_cls, e.query_json))
                entries.append(e)
            except (TypeError, ValueError) as err:
                # a malformed query completes HERE, off the device
                server._query_errors.labels(status="400").inc()
                server._latency_hist.observe(time.monotonic() - e.t_enq)
                e.result = HTTPError(400, str(err))
                e.done.set()
        phases: Dict[str, float] = {"assemble": time.monotonic() - t0}
        out: List[Any] = [None] * len(entries)
        supplemented: List[Any] = []
        live: List[int] = []
        if entries:
            supplemented, live = supplement_batch(
                serving, queries, out, timings=phases, pool=server._pool)
        return _AssembledBatch(entries, queries, out, live, supplemented,
                               algorithms, models, serving, binding_id,
                               phases)

    # -- stage 2: dispatch ---------------------------------------------------
    def _dispatch_loop(self) -> None:
        server = self.server
        while True:
            ab = self._dispatch_q.get()
            if ab is _CLOSE:
                return
            server._pipeline_qdepth.labels(queue="dispatch").observe(
                self._dispatch_q.qsize() + 1)
            t0 = time.monotonic()
            in_flight_before = server.overlap.enter(DEVICE_TRACK)
            try:
                # the dispatch half: nothing here may wait on the card;
                # the traces' spans are laid out at readback from these
                # host times
                with activate_traces([server._trace_of(e.obs)
                                      for e in ab.entries]):
                    fire(F_DISPATCH)
                resolvers = (dispatch_batch(ab.algorithms, ab.models,
                                            ab.supplemented,
                                            timings=ab.phases,
                                            pool=server._pool)
                             if ab.live else [])
                ab.pending = PendingBatch(ab.queries, ab.serving, ab.out,
                                          ab.live, resolvers)
            except Exception as e:  # noqa: BLE001 — one launch, whole batch
                for i in ab.live:
                    ab.out[i] = e
                ab.pending = PendingBatch(ab.queries, ab.serving, ab.out,
                                          [], [])
            if in_flight_before > 0:
                # launched while an earlier batch was still on the
                # device: the pipeline's overlap, counted
                server._pipeline_overlapped.inc()
            ab.t_dispatched = t0
            server._pipeline_stage_hist.labels(stage="dispatch").observe(
                time.monotonic() - t0)
            self._readback_q.put(ab)

    # -- stage 3: readback ---------------------------------------------------
    def _readback_loop(self) -> None:
        server = self.server
        while True:
            ab = self._readback_q.get()
            if ab is _CLOSE:
                return
            server._pipeline_qdepth.labels(queue="readback").observe(
                self._readback_q.qsize() + 1)
            t0 = time.monotonic()
            try:
                results = ab.pending.resolve(ab.phases)
            except Exception as e:  # noqa: BLE001 — resolve isolates
                results = [e] * len(ab.entries)  # its own failures
            finally:
                server.overlap.exit(DEVICE_TRACK)
                # off the device: free the slot, so assemble picks up the
                # pooled arrivals while this thread renders
                self._inflight.release()
            server.overlap.enter("readback")
            try:
                server._finish_pipeline_batch(ab, results)
            except Exception as e:  # noqa: BLE001 — isolate the batch
                log.exception("finishing a batch failed")
                for entry in ab.entries:
                    if not entry.done.is_set():
                        entry.result = HTTPError(500, str(e))
                        entry.done.set()
            finally:
                server.overlap.exit("readback")
                server._pipeline_stage_hist.labels(
                    stage="readback").observe(time.monotonic() - t0)


def build_app(server: QueryServer) -> HTTPApp:
    app = HTTPApp("engineserver")
    app_server_ref: List[AppServer] = []
    cfg = server.config
    _auth = make_key_auth(cfg.accesskey)

    @app.route("POST", "/queries.json")
    def queries(req: Request) -> Response:
        try:
            query_json = req.json()
        except (ValueError, UnicodeDecodeError) as e:
            raise HTTPError(400, str(e)) from e
        # a live rollout routes a cohort of queries to the candidate
        # (canary) or mirrors them to it (shadow); the stable arm serves
        # everyone else
        rollout = server.rollout
        if rollout is not None and rollout.active \
                and rollout.splitter.routes_candidate(query_json):
            if rollout.shadow:
                server.mirror_to_candidate(query_json)
            else:
                try:
                    return json_response(server.serve_candidate(
                        query_json, obs=req.obs))
                except HTTPError as e:
                    if e.status != 503:
                        raise
                    # the candidate was unbound mid-flight (a rollback
                    # won the race): the stable arm serves below
        return json_response(server.serve(query_json, obs=req.obs))

    def _body(req: Request) -> dict:
        try:
            return req.json() or {}
        except (ValueError, UnicodeDecodeError):
            return {}

    @app.route("POST", "/reload")
    def reload(req: Request) -> Response:
        _auth(req)
        instance_id = server.reload()
        return json_response({"message": "Reloading...",
                              "engineInstanceId": instance_id})

    @app.route("GET", "/release.json")
    def release_json(req: Request) -> Response:
        payload = server._require_releases().to_json()
        rollout = server.rollout
        with server._lock:
            stable_id = server.instance.id
        payload["serving"] = {
            "stableInstanceId": stable_id,
            "candidateInstanceId": server.candidate_instance_id,
        }
        payload["rollout"] = (rollout.status()
                              if rollout is not None else None)
        payload["arms"] = server.release_arms()
        return json_response(payload)

    @app.route("POST", "/release/canary")
    def release_canary(req: Request) -> Response:
        """Start a canary (or shadow) rollout of a COMPLETED instance:
        ``{"instanceId": ..., "fraction": 0.05, "shadow": false,
        "reason": ..., "windowSec": 30}``; ``windowSec`` (the gate's
        window, the other thresholds at their defaults) is the port's
        addition to the JAX package's body. The gate ramps or rolls back
        from here; ``/release.json`` tracks it."""
        from ..rollout import HealthPolicy
        from ..rollout.splitter import parse_fraction

        _auth(req)
        try:
            body = req.json() or {}
        except (ValueError, UnicodeDecodeError) as e:
            raise HTTPError(400, str(e)) from e
        instance_id = body.get("instanceId") or ""
        if not instance_id:
            raise HTTPError(400, "instanceId required")
        fraction = policy = None
        try:
            if body.get("fraction") is not None:
                fraction = parse_fraction(body["fraction"])
            if body.get("windowSec") is not None:
                window = float(body["windowSec"])
                if not window > 0:
                    raise ValueError(f"windowSec must be > 0, got "
                                     f"{body['windowSec']!r}")
                policy = HealthPolicy(window_sec=window)
        except (TypeError, ValueError) as e:
            raise HTTPError(400, str(e)) from e
        controller = server.start_canary(
            instance_id, fraction=fraction,
            shadow=bool(body.get("shadow")),
            actor=body.get("actor") or "http",
            reason=body.get("reason") or "", policy=policy)
        return json_response({"message": "Rollout started.",
                              "rollout": controller.status()})

    @app.route("POST", "/release/promote")
    def release_promote(req: Request) -> Response:
        """Force-promote the live candidate to stable (skips the rest of
        the ramp; the operator's override for shadow rollouts)."""
        _auth(req)
        releases = server._require_releases()
        reason = _body(req).get("reason") or "operator promote"
        rollout = server.rollout
        if rollout is not None and rollout.active:
            rollout.promote(reason)
            return json_response({"message": "Promoted.",
                                  "engineInstanceId":
                                      rollout.instance_id})
        instance_id = server.promote_candidate()  # 409 when none bound
        try:
            releases.promote(instance_id, actor="http", reason=reason)
        except Exception as e:  # noqa: BLE001 — serving already moved
            log.error("release history write failed on promote: %s", e)
        return json_response({"message": "Promoted.",
                              "engineInstanceId": instance_id})

    @app.route("POST", "/release/rollback")
    def release_rollback(req: Request) -> Response:
        """Roll back: abort the live candidate, or, with none bound,
        revert stable to the previous release and rebind it."""
        _auth(req)
        releases = server._require_releases()
        reason = _body(req).get("reason") or "operator rollback"
        rollout = server.rollout
        if rollout is not None and rollout.active:
            rollout.rollback(reason)
            with server._lock:
                stable_id = server.instance.id
            return json_response({"message": "Rolled back.",
                                  "engineInstanceId": stable_id})
        try:
            releases.rollback(actor="http", reason=reason)
        except ValueError as e:
            raise HTTPError(409, str(e)) from e
        instance_id = server.reload()  # binds the re-pinned previous
        return json_response({"message": "Rolled back.",
                              "engineInstanceId": instance_id})

    @app.route("GET", "/status.json")
    def status(req: Request) -> Response:
        return json_response(server.status())

    def _pipeline_line() -> str:
        """The batch path: mode, device idle share, overlap, sheds."""
        p = server.pipeline_status()
        if p["mode"] == "off":
            return ""
        parts = [f"serving pipeline: {p['mode']}"]
        ov = p.get("overlap")
        if ov:
            parts.append(
                f"device idle {ov['deviceIdleFraction'] * 100:.0f}%")
            parts.append(f"overlap {ov['overlapFraction'] * 100:.0f}%")
        if p.get("deadlineExceeded"):
            parts.append(f"deadline sheds {p['deadlineExceeded']}")
        return "<li>" + html.escape(" · ".join(parts)) + "</li>"

    def _trace_line() -> str:
        """The flight recorder: retained of the ring, the live slow
        threshold, a profiler capture running."""
        if server.tracer is None:
            return ""
        t = server.tracer.status()
        parts = [f"flight recorder: {t['retained']}/"
                 f"{t['ringCapacity']} retained"]
        if t.get("slowThresholdMs") is not None:
            parts.append(f"slow ≥ {t['slowThresholdMs']:.1f}ms")
        if server.profiler.active:
            parts.append("device profile capturing")
        return ("<li>" + html.escape(" · ".join(parts))
                + " (<a href='/trace.json'>trace.json</a>)</li>")

    def _span_table() -> str:
        """Percentiles of each query phase and the end-to-end latency."""
        rows = [f"<tr><td>{html.escape(name)}</td><td>{s['count']}</td>"
                f"<td>{s['p50'] * 1000:.3f}</td>"
                f"<td>{s['p90'] * 1000:.3f}</td>"
                f"<td>{s['p99'] * 1000:.3f}</td>"
                f"<td>{s['max_sec'] * 1000:.3f}</td></tr>"
                for name, s in sorted(server.spans_summary().items())]
        if not rows:
            return ""
        return ("<h2>Latency percentiles</h2>"
                "<table border='1'><tr><th>series</th><th>count</th>"
                "<th>p50 (ms)</th><th>p90 (ms)</th><th>p99 (ms)</th>"
                "<th>max (ms)</th></tr>" + "".join(rows) + "</table>")

    def _slo_line() -> str:
        """The SLO engine: specs watched, anything burning, the thinnest
        remaining budget."""
        s = server.slo_status()
        if not s.get("enabled", False) or not s.get("specs"):
            return ""
        parts = [f"SLOs: {len(s['specs'])} watched"]
        burning = s.get("burning") or []
        if burning:
            parts.append("BURNING: " + ", ".join(burning))
        budgets = [(sp["budgetRemaining"], sp["name"])
                   for sp in s["specs"]
                   if sp.get("budgetRemaining") is not None]
        if budgets:
            worst, name = min(budgets)
            parts.append(f"thinnest budget {worst * 100:.1f}% "
                         f"({name})")
        return ("<li>" + html.escape(" · ".join(parts))
                + " (<a href='/slo.json'>slo.json</a>)</li>")

    def _cache_line() -> str:
        """Each serving-cache tier's hit ratio over its lookups."""
        if server.cache is None:
            return ""
        tiers = server.cache.stats()["tiers"]
        parts = [f"{name} {t['hitRatio'] * 100:.0f}% of "
                 f"{t['hits'] + t['misses']}"
                 for name, t in tiers.items()]
        return ("<li>cache hit ratio: " + html.escape(", ".join(parts))
                + " (<a href='/cache.json'>cache.json</a>)</li>")

    def _stream_line() -> str:
        """The batch and stream blend serving now: base, fold-in
        generations, staleness."""
        lin = server.stream_lineage()
        parts = [f"model lineage: base {lin['baseInstanceId']}"]
        if lin["incrementalGeneration"]:
            parts.append(f"+{lin['incrementalGeneration']} fold-ins "
                         f"({lin['incrementalRows']} rows)")
        parts.append(f"staleness {lin['stalenessSec']:.1f}s")
        if lin["streaming"]:
            parts.append("stream live")
        return ("<li>" + html.escape(" · ".join(parts))
                + " (<a href='/stream.json'>stream.json</a>)</li>")

    def _release_panel() -> str:
        """Which release serves, what is canarying at what fraction,
        and the last 5 history rows."""
        rel = server.release_summary()
        rows = [f"<li>stable release: {html.escape(str(rel['stable']))}"
                f"</li>"]
        if rel["pinned"]:
            rows.append(f"<li>pinned: {html.escape(rel['pinned'])}</li>")
        if rel["candidate"]:
            rows.append(f"<li>candidate: {html.escape(rel['candidate'])} "
                        f"({html.escape(rel['mode'])} at "
                        f"{rel['fraction'] * 100:.0f}%)</li>")
        hist = []
        if server.releases is not None:
            try:
                events = server.releases.history(limit=5)
            except Exception as e:  # noqa: BLE001 — the page must render
                log.error("release history read failed: %s", e)
                events = []
            hist = [f"<tr><td>{html.escape(ev.time[:19])}</td>"
                    f"<td>{html.escape(ev.action)}</td>"
                    f"<td>{html.escape(ev.instance_id)}</td>"
                    f"<td>{html.escape(ev.actor)}</td>"
                    f"<td>{html.escape(ev.reason)}</td></tr>"
                    for ev in events]
        return ("<h2>Release</h2><ul>" + "".join(rows) + "</ul>"
                + ("<table border='1'><tr><th>time</th><th>action</th>"
                   "<th>instance</th><th>actor</th><th>reason</th></tr>"
                   + "".join(hist) + "</table>" if hist else "")
                + "<p><a href='/release.json'>release.json</a></p>")

    @app.route("GET", "/")
    def index(req: Request) -> Response:
        """The status page. Left out until their data is ported
        (``ROADMAP.md`` queue 1): the mesh panel and the sharding line
        (item 13); the JAX package's "compiles since warm" counts XLA
        compiles."""
        inst = server.instance
        esc = html.escape
        engine_id = inst.engine_id if inst else "(models handed in)"
        with server._lock:
            served = server.request_count
            avg, last = server.avg_serving_sec, server.last_serving_sec
        body = (
            f"<html><head><title>{esc(engine_id)} - predictionio_tpu_torch "
            f"engine server</title></head><body>"
            f"<h1>Engine: {esc(engine_id)}"
            + (f" v{esc(inst.engine_version)}" if inst else "") + "</h1>"
            f"<ul><li>engine instance: "
            f"{esc(inst.id) if inst else '-'}</li>"
            f"<li>variant: {esc(inst.engine_variant) if inst else '-'}</li>"
            f"<li>started: {server.start_time.isoformat()}</li>"
            f"<li>lifecycle: {server.lifecycle}</li>"
            f"<li>device: {esc(str(server.device))} "
            f"({esc(str(server.card['name']))})</li>"
            f"<li>requests served: {served}</li>"
            f"<li>average serving: {avg * 1000:.3f} ms</li>"
            f"<li>last serving: {last * 1000:.3f} ms</li>"
            f"{_pipeline_line()}{_stream_line()}{_cache_line()}"
            f"{_slo_line()}{_trace_line()}</ul>"
            f"{_release_panel()}{_span_table()}"
            "<p><a href='/metrics'>Prometheus metrics</a> · "
            "<a href='/status.json'>status.json</a></p></body></html>")
        return Response(body=body, content_type="text/html")

    @app.route("GET", "/slo.json")
    def slo_json(req: Request) -> Response:
        """Live SLO state: per-spec burn rates (fast and slow window),
        error budget remaining, breach and violation accounting (what
        ``slo status`` prints)."""
        return json_response(server.slo_status())

    @app.route("GET", "/cache.json")
    def cache_json(req: Request) -> Response:
        """Each tier's hits, misses, evictions and invalidations (what
        ``cli cache stats`` prints)."""
        if server.cache is None:
            return json_response({"enabled": False,
                                  "hint": "deploy with --cache (or "
                                          "ServerConfig(serving_cache="
                                          "True)) to enable the "
                                          "serving cache hierarchy"})
        return json_response(server.cache.stats())

    @app.route("POST", "/cache/flush")
    def cache_flush(req: Request) -> Response:
        """The operator's flush of every tier (``cli cache flush``);
        key-guarded like the other control routes. 409 when the cache is
        off."""
        _auth(req)
        if server.cache is None:
            raise HTTPError(409, "serving cache is not enabled")
        return json_response({"message": "Flushed.",
                              "removed": server.cache.flush_all()})

    @app.route("POST", "/drain")
    def drain(req: Request) -> Response:
        """Flip this server to ``lifecycle`` draining: it keeps serving
        what arrives, but advertises that nothing new should. Idempotent;
        it does not stop the server (``/stop`` does)."""
        _auth(req)
        server.enter_drain()
        return json_response({"lifecycle": server.lifecycle})

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

        _auth(req)
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
        _auth(req)
        if not server.stop_stream():
            raise HTTPError(409, "no streaming trainer is running")
        return json_response({"message": "Streaming trainer stopped."})

    @app.route("POST", "/stop")
    def stop(req: Request) -> Response:
        _auth(req)

        def delayed_shutdown():
            # let THIS response flush before the listener goes down
            time.sleep(0.25)
            app_server_ref[0].close()

        threading.Thread(target=delayed_shutdown, daemon=True,
                         name="engineserver-stop").start()
        return json_response({"message": "Shutting down..."})

    @app.route("GET", "/plugins.json")
    def plugins_json(req: Request) -> Response:
        return json_response({"plugins": server.plugins.describe()})

    @app.route("GET", r"/plugins/(?P<ptype>[^/]+)/(?P<pname>[^/]+)"
                      r"(?P<rest>(/[^/]+)*)")
    def plugin_rest(req: Request) -> Response:
        """A plugin's own REST surface
        (``/plugins/<outputblockers|outputsniffers>/<name>/<args...>``),
        key-guarded like the other control routes."""
        _auth(req)
        plugin, args = resolve_plugin(
            {"outputblockers": server.plugins.output_blockers,
             "outputsniffers": server.plugins.output_sniffers},
            req.path_params["ptype"], req.path_params["pname"],
            req.path_params["rest"])
        return json_response(plugin.handle_rest(args))

    @app.route("POST", "/profile")
    def profile_start(req: Request) -> Response:
        """Capture a ``torch.profiler`` window (CPU, and CUDA on the card)
        into the artifact dir: ``{"durationMs": 1000}``. 202 once the
        capture runs, 400 for a window out of range, 409 while another
        capture holds the profiler. Key-guarded: a profile exposes
        internals and costs overhead while it runs."""
        _auth(req)
        try:
            body = req.json() or {}
        except (ValueError, UnicodeDecodeError):
            body = {}
        try:
            info = server.profiler.start(
                float(body.get("durationMs", 1000.0)))
        except (TypeError, ValueError) as e:
            raise HTTPError(400, str(e))
        except RuntimeError as e:
            raise HTTPError(409, str(e))
        return json_response({
            "message": "Profiling.", **info,
            "hint": "poll GET /profile.json; each capture's dir holds a "
                    "trace.json for ui.perfetto.dev or chrome://tracing"},
            202)

    @app.route("GET", "/profile.json")
    def profile_json(req: Request) -> Response:
        """The running capture, the last 20 finished, and the artifact
        dirs under the base dir. (The JAX package's per-executable
        compile-time table counts XLA compiles: not ported.)"""
        return json_response(server.profiler.status())

    # /metrics, /metrics.json and the request instrumentation through the
    # server's own registry (the engine server keeps its own
    # /status.json); the tracer adds traceparent propagation and GET
    # /trace.json
    mount_metrics(app, server.metrics, server_name="engineserver",
                  tracer=(server.tracer if server.tracer is not None
                          else False))
    app.access_log_sample = cfg.access_log_sample

    app._server_ref = app_server_ref  # type: ignore[attr-defined]
    return app


def create_engine_server(server: QueryServer, host: str = "0.0.0.0",
                         port: int = 8000, ssl_context=None) -> AppServer:
    """Bind the engine server's HTTP app (HTTPS with ``ssl_context``);
    closing it closes the server."""
    app = build_app(server)
    srv = AppServer(app, host, port, ssl_context=ssl_context)
    srv.query_server = server  # the binding behind the routes
    srv.on_close(server.close)
    app._server_ref.append(srv)  # type: ignore[attr-defined]
    return srv


def deploy_models(engine: Engine, engine_params: EngineParams,
                  models: List[Any], config: Optional[ServerConfig] = None,
                  host: str = "0.0.0.0", port: int = 8000,
                  ssl_context=None) -> AppServer:
    """Bind ``models`` (quantize, place on the device) and return the
    engine server, not yet serving: call ``start_background()`` or
    ``serve_forever()`` on it."""
    server = QueryServer(engine, engine_params, models, config)
    return create_engine_server(server, host, port, ssl_context)


def deploy(ctx: Context, engine: Engine, engine_params: EngineParams,
           engine_id: str = "default", engine_version: str = "1",
           engine_variant: str = "engine.json",
           config: Optional[ServerConfig] = None,
           host: str = "0.0.0.0", port: int = 8000,
           ssl_context=None) -> AppServer:
    """The ``pio deploy`` flow through the release registry: bind the
    PINNED release of ``engine_id``/``engine_version``/``engine_variant``
    when one is set (``RuntimeError`` when it is not a COMPLETED
    instance), else the latest COMPLETED instance, from ``ctx.storage``;
    record the deploy; return the engine server, not yet serving. Runs on
    the card unless ``config.device`` is "cpu". With
    ``config.streaming`` the stream trainer starts with it, tailing
    ``ctx.storage``."""
    from ..workflow import core as wf

    releases = ReleaseRegistry(ctx.storage, engine_id, engine_version,
                               engine_variant)
    pinned = None
    try:
        pinned = releases.pinned_instance()
    except Exception as e:  # noqa: BLE001 — the registry must never make
        log.error(          # a model undeployable
            "release registry read failed; deploying latest: %s", e)
    if pinned:
        instance = ctx.storage.engine_instances().get(pinned)
        if instance is None or instance.status != STATUS_COMPLETED:
            raise RuntimeError(
                f"Pinned release {pinned!r} is not a COMPLETED engine "
                f"instance; `release pin --clear` or re-pin.")
    else:
        instance = wf.get_latest_completed(ctx, engine_id, engine_version,
                                           engine_variant)
        if instance is None:
            raise RuntimeError(
                f"No COMPLETED engine instance for {engine_id} "
                f"{engine_version} {engine_variant}; run train first.")
    models = wf.load_models_for_deploy(ctx, engine, instance, engine_params)
    server = QueryServer(engine, engine_params, models, config, instance,
                         ctx)
    try:
        releases.record_deploy(
            instance.id, actor="pio deploy",
            reason=("pinned release" if pinned
                    else "latest COMPLETED instance"))
    except Exception as e:  # noqa: BLE001 — history is best-effort
        log.error("release history write failed on deploy: %s", e)
    return create_engine_server(server, host, port, ssl_context)
