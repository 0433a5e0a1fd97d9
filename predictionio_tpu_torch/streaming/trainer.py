"""StreamTrainer: the thread that closes the event -> model loop (the port
of ``predictionio_tpu/streaming/trainer.py``).

Consumes accepted ingests behind a durable :class:`~.cursor.EventCursor`
(the correctness path: catch-up is a cursor read, so no event is lost
across restarts), with the :class:`~predictionio_tpu_torch.cache.bus.
InvalidationBus` as the low-latency wake signal (the event server
publishes every accepted ingest there). Each pass folds the pending
micro-batch into the bound ALS model through per-entity least-squares
solves (:mod:`.foldin` -> ``fused_gram`` and ``chol_solve`` on the card),
canaries the folded model against the serving one with a
:class:`~predictionio_tpu_torch.rollout.policy.HealthPolicy` probe
(``fused_topk``), and hot-swaps it into the live ``QueryServer``
binding through :meth:`QueryServer.apply_stream_delta`.

A :class:`~.drift.DriftMonitor` watches fold-in residuals and the
rating distribution; past its threshold it flags ``retrain_due``, records
``retrain-due`` in the release history and fires the optional
``on_retrain`` hook once per base model. A refused delta is recorded as
``stream-reject`` (the server records ``stream-start`` and
``stream-stop``).

Threading: ONE loop thread owns consume -> fold -> apply -> advance; the
bus callback only sets a wake event. The apply re-checks the binding
under the server's lock, so a rebind racing a fold-in voids the apply
and the unadvanced cursor retries against the new base.

Telemetry: the ``pio_stream_*`` families on the server's registry, and a
``stream.foldin`` trace a pass on the server's tracer (spans ``consume``,
``fold_in``, ``canary``, ``hot_swap``, ``advance``). The pass trace
adopts the trace context the event server stamped into the first traced
event (``pio_traceparent``), so the ingest request and the fold-in that
made it servable are one trace; the other events' trace ids ride in the
``links`` attribute. An applied or refused pass is always retained.

The touched entities' cached answers and pinned hot-tier rows are
invalidated by the server's :meth:`QueryServer.apply_stream_delta`, after
the swap, as in the JAX package.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np

from ..cache.bus import InvalidationBus, default_bus
from ..data.event import to_millis
from ..data.storage.base import StorageError
from ..faults import FaultError, declare, fire
from ..models.als import fixed_gramian, recommend_products
from ..obs import DEFAULT_LATENCY_BOUNDS
from ..obs.trace import parse_traceparent
from ..rollout.policy import ArmWindow, HealthPolicy
from ..utils.retrying import RetryPolicy, retry_call
from .cursor import EventCursor
from .drift import DriftMonitor
from .foldin import DEFAULT_EVENT_WEIGHTS, fold_in_events

log = logging.getLogger(__name__)

__all__ = ["StreamConfig", "StreamTrainer"]

F_PASS = declare("stream.pass",
                 "entry of one consume->fold->canary->apply->advance pass")

#: transient-storage retry budget for the cursor's log reads and writes:
#: a blip in the event store costs one short stall, not a failed pass
_STORAGE_RETRY = RetryPolicy(max_attempts=3, base_ms=25.0, cap_ms=500.0)
_STORAGE_ERRORS = (StorageError, FaultError, ConnectionError, OSError)


@dataclass
class StreamConfig:
    """Knobs of the incremental trainer (``deploy --stream*``)."""

    #: app whose event log is tailed
    app_name: str = ""
    channel_name: Optional[str] = None
    #: durable cursor identity: two trainers with the same consumer name
    #: share (and fight over) one cursor
    consumer: str = "stream-trainer"
    #: poll interval when no bus wake arrives (in-process ingest wakes
    #: the loop at once)
    interval_ms: float = 500.0
    #: events consumed per fold-in pass
    max_events: int = 2048
    #: per-entity history cap at fold-in assembly (most recent kept)
    max_history: int = 512
    #: event -> rating projection; None is the recommendation template's
    #: default ({"rate": None, "buy": 4.0})
    event_weights: Optional[Dict[str, Optional[float]]] = None
    #: DriftMonitor trigger
    drift_threshold: float = 1.0
    #: touched-entity probes per canary check (0 disables the gate)
    canary_probes: int = 8
    #: which bound algorithm the deltas apply to
    algo_index: int = 0


class StreamTrainer:
    def __init__(self, server, config: Optional[StreamConfig] = None,
                 bus: Optional[InvalidationBus] = None,
                 policy: Optional[HealthPolicy] = None,
                 on_retrain: Optional[Callable[[dict], None]] = None):
        self.server = server
        self.config = config or StreamConfig()
        storage = server.storage
        app_name = self.config.app_name
        if not app_name:
            raise ValueError("StreamConfig.app_name required (the app "
                             "whose event log the trainer tails)")
        app = storage.apps().get_by_name(app_name)
        if app is None:
            raise ValueError(f"app {app_name!r} does not exist")
        self.storage = storage
        self.app_id = app.id
        self.channel_id = None
        if self.config.channel_name:
            chans = storage.channels().get_by_app_id(app.id)
            match = next((c for c in chans
                          if c.name == self.config.channel_name), None)
            if match is None:
                raise ValueError(
                    f"channel {self.config.channel_name!r} does not "
                    f"exist in app {app_name!r}")
            self.channel_id = match.id
        self.weights = (dict(self.config.event_weights)
                        if self.config.event_weights
                        else dict(DEFAULT_EVENT_WEIGHTS))
        self.cursor = EventCursor(storage, self.app_id,
                                  self.config.consumer, self.channel_id)
        self.drift = DriftMonitor(threshold=self.config.drift_threshold)
        #: probe-scale gate: one window per fold-in, judged on the probe
        #: set; min_queries=1 so small batches still get a verdict
        self.policy = policy or HealthPolicy(min_queries=1)
        self.on_retrain = on_retrain
        self._retrain_fired = False
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._G = None          # cached implicit fixed-side Gramian
        self._base_seen = None  # the binding the cache is for
        self._last_lag = 0
        self._last_error: Optional[str] = None
        self._last_batch: dict = {}
        self.applies = 0
        self.rejects = 0
        self.events_consumed = 0
        self._register_metrics(server.metrics)
        self.bus = bus if bus is not None else default_bus()
        self.bus.subscribe(self, "on_ingest")

    # -- metrics -------------------------------------------------------------
    def _register_metrics(self, registry) -> None:
        self._m_consumed = registry.counter(
            "pio_stream_events_consumed_total",
            "Events consumed from the log by the streaming trainer")
        self._m_foldin = registry.histogram(
            "pio_stream_foldin_seconds",
            "Wall time of one fold-in pass (assembly + device solves "
            "+ delta apply)", bounds=DEFAULT_LATENCY_BOUNDS)
        self._m_freshness = registry.histogram(
            "pio_stream_freshness_seconds",
            "Event→servable freshness: ingest creation time to the "
            "moment the folded rows were serving",
            bounds=DEFAULT_LATENCY_BOUNDS)
        self._m_applies = registry.counter(
            "pio_stream_applies_total",
            "Fold-in deltas hot-swapped into the serving binding")
        self._m_rows = registry.counter(
            "pio_stream_rows_updated_total",
            "Factor rows written by fold-in, by kind "
            "(updated / user_cold / item_cold)")
        self._m_rejects = registry.counter(
            "pio_stream_canary_rejects_total",
            "Fold-in deltas the HealthPolicy probe gate refused to "
            "swap in")
        registry.gauge(
            "pio_stream_cursor_lag",
            "Unconsumed relevant events behind the durable cursor at "
            "the last pass (scan-capped)",
            fn=lambda: float(self._last_lag))
        registry.gauge(
            "pio_stream_drift_score",
            "DriftMonitor score (>= threshold flags a full retrain)",
            fn=lambda: self.drift.score())
        registry.gauge(
            "pio_stream_running",
            "1 while the streaming trainer loop is alive",
            fn=lambda: 1.0 if self.running else 0.0)

    # -- lifecycle -----------------------------------------------------------
    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> "StreamTrainer":
        if self.running:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="stream-trainer")
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the loop and join its thread (a pass in flight finishes
        first)."""
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)

    def on_ingest(self, app_id, entity_type: str, entity_id: str,
                  event_name: str = "") -> None:
        """Bus subscriber: an accepted ingest for our app wakes the loop
        NOW; anything else waits for the poll. Never does work on the
        ingest thread."""
        if app_id is not None and app_id != self.app_id:
            return
        if event_name and event_name not in self.weights:
            return
        self._wake.set()

    def _run(self) -> None:
        interval = max(self.config.interval_ms, 1.0) / 1000.0
        error_streak = 0
        while not self._stop.is_set():
            self._wake.wait(timeout=interval)
            if self._stop.is_set():
                break
            self._wake.clear()
            try:
                n = self.consume_once()
                error_streak = 0
                if n >= self.config.max_events:
                    self._wake.set()  # backlog: keep draining
            except Exception as e:  # noqa: BLE001 — the loop survives
                self._last_error = str(e)
                log.exception("stream fold-in pass failed: %s", e)
                # bounded exponential backoff on consecutive failures: a
                # failing dependency must not spin the loop hot
                error_streak += 1
                backoff = min(5.0, 0.05 * (2 ** min(error_streak, 7)))
                self._stop.wait(backoff)

    def _advance_durable(self, events) -> None:
        """Advance and persist the cursor with the bounded storage retry:
        a transient blip must not strand the cursor behind events the
        model already absorbed."""
        self.cursor.advance(events)
        retry_call(self.cursor.save, policy=_STORAGE_RETRY,
                   retry_on=_STORAGE_ERRORS)

    def _begin_pass_trace(self, events):
        """Open the pass's ``stream.foldin`` trace on the server's tracer
        (None without one), adopting the first traced event's
        ``pio_traceparent``; the other events' trace ids go in
        ``links``."""
        tracer = getattr(self.server, "tracer", None)
        if tracer is None:
            return None
        parents = [str(tp) for tp in
                   (e.properties.get("pio_traceparent", default=None)
                    for e in events) if tp]
        trace = tracer.begin(
            "stream.foldin", traceparent=parents[0] if parents else None,
            consumer=self.config.consumer, events=len(events))
        links = set()
        for tp in parents[1:]:
            parsed = parse_traceparent(tp)
            if parsed and parsed[0] != trace.trace_id:
                links.add(parsed[0])
        if links:
            trace.set_attr("links", sorted(links)[:32])
        return trace

    def _finish_pass_trace(self, trace, outcome: str, **attrs) -> None:
        tracer = getattr(self.server, "tracer", None)
        if trace is None or tracer is None:
            return
        trace.set_attr("outcome", outcome)
        for k, v in attrs.items():
            trace.set_attr(k, v)
        # an applied or refused pass is ALWAYS retained ("stream"): each
        # is the serving half of some ingest's trace; the other outcomes
        # go through the normal policy
        force = "stream" if outcome in ("applied", "rejected") else None
        tracer.finish(trace, force_reason=force)

    # -- one pass ------------------------------------------------------------
    def consume_once(self) -> int:
        """One consume -> fold -> canary -> apply -> advance pass; returns
        how many events were consumed (0: nothing pending, or the apply
        lost a rebind race and will retry)."""
        fire(F_PASS, consumer=self.config.consumer)
        t_consume0 = time.monotonic()
        events = retry_call(
            self.cursor.pending, event_names=list(self.weights),
            entity_type="user", limit=self.config.max_events,
            policy=_STORAGE_RETRY, retry_on=_STORAGE_ERRORS)
        self._last_lag = len(events)
        if not events:
            return 0
        t0 = time.monotonic()
        trace = self._begin_pass_trace(events)
        if trace is not None:
            trace.add_span("consume", t_consume0, t0, events=len(events))
        snap = self.server.stream_snapshot(self.config.algo_index)
        if snap is None:
            self._finish_pass_trace(trace, "no-foldable-model")
            return 0  # no foldable model bound (not an ALS model)
        base_id, model = snap
        if base_id != self._base_seen:
            # a new binding is serving: its distribution is the new
            # baseline and a cached Gramian is for dead factors
            self._base_seen = base_id
            self._G = None
            self._retrain_fired = False
            self.drift.reset()
        t_fold0 = time.monotonic()
        new_model, report = fold_in_events(
            model, events, self.storage, self.app_id,
            channel_id=self.channel_id, weights=self.weights,
            max_history=self.config.max_history, G=self._G)
        if trace is not None:
            trace.set_attr("baseInstanceId", base_id)
            trace.add_span("fold_in", t_fold0, time.monotonic(),
                           usersUpdated=report.users_updated,
                           usersInserted=report.users_inserted,
                           itemsInserted=report.items_inserted)
        if model.params.implicit_prefs and report.items_inserted == 0 \
                and self._G is None:
            # amortize the fixed-side Gramian across batches that leave
            # the item table as it is
            self._G = fixed_gramian(new_model.item_factors,
                                    new_model.params)
        elif report.items_inserted:
            self._G = None
        self.drift.observe(report.values, report.residual)
        touched = sorted({e.entity_id for e in events
                          if e.entity_type == "user"})
        if report.events_relevant == 0:
            # nothing projectable: just move the cursor past them
            self._advance_durable(events)
            self._finish_pass_trace(trace, "no-relevant-events")
            return len(events)
        t_canary0 = time.monotonic()
        verdict = self._canary_check(model, new_model, touched)
        if trace is not None:
            trace.add_span("canary", t_canary0, time.monotonic(),
                           probes=min(len(touched),
                                      self.config.canary_probes),
                           action=(verdict.action if verdict is not None
                                   else "skipped"))
        if verdict is not None and verdict.action == "rollback":
            # refuse the delta and move on (re-solving gives the same
            # rows); repeated refusals are what the drift lane is for
            self.rejects += 1
            self._m_rejects.inc()
            log.warning("stream canary refused a fold-in delta: %s",
                        verdict.reason)
            self._record_release("stream-reject", base_id, verdict.reason)
            self._advance_durable(events)
            self._maybe_retrain()
            self._finish_pass_trace(trace, "rejected",
                                    reason=verdict.reason)
            return len(events)
        t_swap0 = time.monotonic()
        applied = self.server.apply_stream_delta(
            self.config.algo_index, new_model, touched,
            base_instance_id=base_id,
            rows_updated=report.users_updated,
            rows_inserted=report.users_inserted + report.items_inserted)
        if trace is not None:
            trace.add_span("hot_swap", t_swap0, time.monotonic(),
                           applied=applied, touchedEntities=len(touched))
        if not applied:
            # the binding moved under us: nothing consumed, the next
            # pass re-folds against the new base
            self._wake.set()
            self._finish_pass_trace(trace, "rebind-race")
            return 0
        t_adv0 = time.monotonic()
        self._advance_durable(events)
        if trace is not None:
            trace.add_span("advance", t_adv0, time.monotonic())
        dt = time.monotonic() - t0
        now_ms = time.time() * 1000.0
        for e in events:
            self._m_freshness.observe(
                max(0.0, (now_ms - to_millis(e.creation_time)) / 1000.0))
        self.events_consumed += len(events)
        self.applies += 1
        self._m_consumed.inc(len(events))
        self._m_applies.inc()
        self._m_foldin.observe(dt)
        self._m_rows.labels(kind="updated").inc(report.users_updated)
        if report.users_inserted:
            self._m_rows.labels(kind="user_cold").inc(report.users_inserted)
        if report.items_inserted:
            self._m_rows.labels(kind="item_cold").inc(report.items_inserted)
        self._last_batch = {
            "events": len(events),
            "relevant": report.events_relevant,
            "usersUpdated": report.users_updated,
            "usersInserted": report.users_inserted,
            "itemsInserted": report.items_inserted,
            "residual": report.residual,
            "foldinMs": round(dt * 1000, 3),
        }
        self._finish_pass_trace(trace, "applied",
                                foldinMs=round(dt * 1000, 3),
                                generation=self.applies)
        self._maybe_retrain()
        return len(events)

    def _maybe_retrain(self) -> None:
        if not self.drift.retrain_due or self._retrain_fired:
            return
        self._retrain_fired = True  # once per base model
        status = self.drift.status()
        log.warning("stream drift %.3f passed threshold %.3f: full "
                    "retrain due", status["score"], status["threshold"])
        self._record_release(
            "retrain-due", self._base_seen or "",
            f"drift score {status['score']} >= {status['threshold']}")
        if self.on_retrain is not None:
            try:
                self.on_retrain(status)
            except Exception as e:  # noqa: BLE001 — the hook is advisory
                log.error("on_retrain hook failed: %s", e)

    def _record_release(self, action: str, instance_id: str,
                        reason: str) -> None:
        self.server._record_release(
            action, instance_id=instance_id,
            actor=f"stream-trainer:{self.config.consumer}",
            reason=reason[:500])

    # -- canary gate ---------------------------------------------------------
    def _canary_check(self, old_model, new_model, touched):
        """Probe the folded model against the serving one on the touched
        entities: per-probe latency and failure (exception, non-finite
        scores, empty where the old model answered) build one
        :class:`ArmWindow` per arm, judged by the HealthPolicy."""
        n = self.config.canary_probes
        if n <= 0:
            return None
        probe_keys = [u for u in touched
                      if new_model.user_ids and u in new_model.user_ids]
        probe_keys = probe_keys[:n]
        if not probe_keys:
            return None

        def probe(model, key) -> tuple:
            """(seconds, bad, answerable, n_results); ``answerable`` is
            False when the model has no row for the key (a cold-start
            user the OLD model cannot serve: not an error, and its
            instant return must not enter the latency window)."""
            t0 = time.monotonic()
            try:
                uidx = model.user_ids.get(key)
                if uidx is None:
                    return time.monotonic() - t0, False, False, 0
                ids, scores = recommend_products(
                    model, int(uidx), min(10, model.n_items))
                bad = not np.all(np.isfinite(np.asarray(scores)))
                return time.monotonic() - t0, bad, True, len(ids)
            except Exception:  # noqa: BLE001 — counted as an error
                return time.monotonic() - t0, True, True, 0

        stable_lats, stable_q, stable_errs = [], 0, 0
        cand_lats, cand_errs = [], 0
        for key in probe_keys:
            o_dt, o_bad, o_can, o_n = probe(old_model, key)
            # probe the candidate twice and keep the faster sample: a
            # grown table's first launch may pay one-off work that the
            # steady serving path never sees
            c_dt0, _, _, _ = probe(new_model, key)
            c_dt, c_bad, c_can, c_n = probe(new_model, key)
            cand_lats.append(min(c_dt0, c_dt))
            if c_bad or (not c_can) or (o_can and o_n and not c_n):
                cand_errs += 1
            if o_can:
                stable_q += 1
                stable_lats.append(o_dt)
                stable_errs += 1 if o_bad else 0
        stable = ArmWindow(
            queries=stable_q, errors=stable_errs,
            p99=max(stable_lats) if stable_lats else None)
        candidate = ArmWindow(
            queries=len(probe_keys), errors=cand_errs,
            p99=max(cand_lats) if cand_lats else None)
        return self.policy.evaluate(stable, candidate)

    # -- status --------------------------------------------------------------
    def status(self) -> dict:
        return {
            "running": self.running,
            "appName": self.config.app_name,
            "consumer": self.config.consumer,
            "intervalMs": self.config.interval_ms,
            "cursor": self.cursor.status(),
            "cursorLag": self._last_lag,
            "eventsConsumed": self.events_consumed,
            "applies": self.applies,
            "canaryRejects": self.rejects,
            "drift": self.drift.status(),
            "lastBatch": self._last_batch,
            "lastError": self._last_error,
        }
