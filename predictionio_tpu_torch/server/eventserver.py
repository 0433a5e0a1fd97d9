"""Event server: REST ingestion over the event store (the port of
``predictionio_tpu/server/eventserver.py``).

The access key comes from the ``accessKey`` query parameter or the
username of a Basic ``Authorization`` header; ``channel`` picks a channel
of its app, and a key's event list restricts what it may send. Routes,
status codes and JSON bodies are the JAX package's:

- ``POST /events.json``: one event -> 201 ``{"eventId"}``;
- ``POST /batch/events.json``: at most :data:`MAX_EVENTS_PER_BATCH`
  events, one status a position; the valid ones go down in one
  all-or-nothing ``insert_batch``, and per event if that fails;
- ``POST /columnar/events.npz``: one npz column block
  (``data/storage/wire.py``) in one ``insert_columnar`` -> 201
  ``{"accepted": n}``;
- ``GET /events.json``: a filtered query (default limit 20), 404 when
  nothing matches;
- ``GET`` / ``DELETE /events/<id>.json``;
- ``GET`` / ``POST /webhooks/<name>.json`` and ``.form``: a provider's
  payload through its connector (``data/webhooks/``: segment.io JSON,
  MailChimp forms) into one event -> 201 ``{"eventId"}``;
- ``GET /stats.json``: the app's per-hour counts where the server was
  built with ``stats=True`` (``eventserver --stats``), else a 404 that
  says how to turn them on;
- ``GET /plugins.json`` and ``/plugins/<type>/<name>/...``: the input
  blockers and sniffers (``server/plugins.py``), which see every event
  the JSON routes accept;
- ``GET /metrics``, ``/metrics.json``, ``/status.json`` and
  ``/trace.json`` (``server/http.py::mount_metrics``), with
  ``pio_events_ingested_total{route}`` and ``pio_stats_enabled``.

An event posted with a ``traceparent`` header is stored with that
request's trace context as its ``pio_traceparent`` property, so the
stream trainer's fold-in pass joins the ingest's trace; an event from a
caller that sent none is stored as it was posted.

Every accepted ingest is published to the invalidation bus
(``cache/bus.py``; the process-wide one unless ``bus`` is given): a
single event on its own, a batch or a column block coalesced through one
``publish_many``. An engine server's serving cache in the same process
drops the answers it contradicts, and a stream trainer wakes on it. A
failed publish is logged and never fails the ingest.
"""

from __future__ import annotations

import base64
import logging
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..cache.bus import InvalidationBus, default_bus
from ..data.datamap import DataMap
from ..data.event import Event, EventValidationError, parse_iso
from ..data.storage.base import ANY, EventFilter
from ..data.storage.registry import Storage, get_storage
from ..data.storage.wire import batch_from_npz
from ..data.webhooks import (
    ConnectorException,
    form_connectors,
    json_connectors,
    to_event,
)
from ..obs import MetricsRegistry
from .http import (
    AppServer,
    HTTPApp,
    HTTPError,
    Request,
    Response,
    json_response,
    mount_metrics,
)
from .plugins import EventServerPlugins, resolve_plugin
from .stats import StatsCollector

log = logging.getLogger(__name__)

MAX_EVENTS_PER_BATCH = 50


@dataclass
class AuthData:
    app_id: int
    channel_id: Optional[int]
    events: List[str]  # allowed event names; empty = all allowed


def authenticate(storage: Storage, req: Request) -> AuthData:
    """The access key (query parameter, else the Basic auth username) ->
    its app and, with ``channel``, a channel of that app."""
    key = req.query.get("accessKey")
    if key is None:
        auth = req.headers.get("Authorization", "")
        if not auth.startswith("Basic "):
            raise HTTPError(401, "Missing accessKey.")
        try:
            decoded = base64.b64decode(auth[len("Basic "):]).decode("utf-8")
        except Exception:
            raise HTTPError(401, "Invalid accessKey.")
        key = decoded.strip().split(":")[0]
    record = storage.access_keys().get(key)
    if record is None:
        raise HTTPError(401, "Invalid accessKey.")
    channel_id: Optional[int] = None
    channel_name = req.query.get("channel")
    if channel_name is not None:
        channels = {c.name: c.id for c in
                    storage.channels().get_by_app_id(record.app_id)}
        if channel_name not in channels:
            raise HTTPError(401, f"Invalid channel '{channel_name}'.")
        channel_id = channels[channel_name]
    return AuthData(app_id=record.app_id, channel_id=channel_id,
                    events=list(record.events))


def _allowed(auth: AuthData, event_name: str) -> bool:
    return not auth.events or event_name in auth.events


def _not_allowed(name: str) -> str:
    return f"{name} events are not allowed"


def _parse_event(load) -> Event:
    """``Event.from_json(load())``; a body or event that does not parse
    is a 400."""
    try:
        return Event.from_json(load())
    except (EventValidationError, TypeError, KeyError, ValueError) as e:
        raise HTTPError(400, str(e))


def build_app(storage: Optional[Storage] = None, *,
              stats: bool = False,
              plugins: Optional[EventServerPlugins] = None,
              bus: Optional[InvalidationBus] = None) -> HTTPApp:
    st = storage if storage is not None else get_storage()
    collector = StatsCollector() if stats else None
    plug = plugins or EventServerPlugins()
    inval_bus = bus if bus is not None else default_bus()
    app = HTTPApp("eventserver")
    app.plugins = plug  # type: ignore[attr-defined]  # closed with the server

    registry = MetricsRegistry()
    registry.gauge("pio_stats_enabled",
                   "1 when the --stats per-app collector is on"
                   ).set(1.0 if stats else 0.0)
    ingested = registry.counter(
        "pio_events_ingested_total",
        "Events accepted into the store, by ingest route")
    published = registry.counter(
        "pio_cache_bus_published_total",
        "Ingested events published to the serving-cache invalidation "
        "bus (deliveries = publishes × live subscribers)")
    mount_metrics(app, registry, server_name="eventserver",
                  status=lambda: {"status": "alive",
                                  "statsEnabled": bool(collector)})
    app.metrics_registry = registry  # type: ignore[attr-defined]

    def _publish(app_id: int, items: List[tuple], n: int) -> None:
        """Best-effort bus publish of ``(entity_type, entity_id, event)``
        items standing for ``n`` accepted events: ingest never fails
        because a subscriber did."""
        try:
            if len(items) == 1:
                inval_bus.publish(app_id, *items[0])
            else:
                inval_bus.publish_many(app_id, items)
            published.inc(n)
        except Exception as e:  # noqa: BLE001 — ingest goes on
            log.error("invalidation publish failed: %s", e)

    def _stamp_trace(req: Request, event: Event) -> Event:
        """The ingest request's trace context as the event's
        ``pio_traceparent`` property, only where the CALLER sent a
        ``traceparent`` (a request joins a trace; the server never
        imposes one) and no relay stamped it already."""
        if req.trace is None or req.trace.parent_span_id is None \
                or "pio_traceparent" in event.properties:
            return event
        return event.copy(properties=DataMap(
            {**event.properties, "pio_traceparent":
             req.trace.traceparent()}))

    def _book(app_id: int, event: Event) -> None:
        if collector:
            collector.bookkeeping(app_id, 201, event)

    @app.route("GET", "/")
    def index(req: Request) -> Response:
        return json_response({"status": "alive"})

    @app.route("GET", "/plugins.json")
    def plugins_json(req: Request) -> Response:
        return json_response({"plugins": plug.describe()})

    @app.route("GET", r"/plugins/(?P<ptype>[^/]+)/(?P<pname>[^/]+)"
                      r"(?P<rest>(/[^/]+)*)")
    def plugin_rest(req: Request) -> Response:
        """A plugin's own REST surface, behind the access key: its
        ``handle_rest`` gets the caller's app and channel and the
        remaining path segments."""
        auth = authenticate(st, req)
        plugin, args = resolve_plugin(
            {"inputblockers": plug.input_blockers,
             "inputsniffers": plug.input_sniffers},
            req.path_params["ptype"], req.path_params["pname"],
            req.path_params["rest"])
        return json_response(
            plugin.handle_rest(auth.app_id, auth.channel_id, args))

    @app.route("POST", "/events.json")
    def post_event(req: Request) -> Response:
        auth = authenticate(st, req)
        event = _parse_event(req.json)
        if not _allowed(auth, event.event):
            return json_response({"message": _not_allowed(event.event)}, 403)
        event = _stamp_trace(req, event)
        plug.process_input(auth.app_id, auth.channel_id, event)
        event_id = st.events().insert(event, auth.app_id, auth.channel_id)
        ingested.labels(route="events").inc()
        _publish(auth.app_id, [(event.entity_type, event.entity_id,
                                event.event)], 1)
        _book(auth.app_id, event)
        return json_response({"eventId": event_id}, 201)

    @app.route("GET", "/events.json")
    def get_events(req: Request) -> Response:
        auth = authenticate(st, req)
        q = req.query
        reversed_ = q.get("reversed", "false").lower() == "true"
        if reversed_ and not (q.get("entityType") and q.get("entityId")):
            raise HTTPError(400, "the parameter reversed can only be used "
                                 "with both entityType and entityId "
                                 "specified.")
        try:
            filt = EventFilter(
                start_time=(parse_iso(q["startTime"]) if "startTime" in q
                            else None),
                until_time=(parse_iso(q["untilTime"]) if "untilTime" in q
                            else None),
                entity_type=q.get("entityType"),
                entity_id=q.get("entityId"),
                event_names=[q["event"]] if "event" in q else None,
                target_entity_type=q.get("targetEntityType", ANY),
                target_entity_id=q.get("targetEntityId", ANY),
                limit=int(q.get("limit", 20)),
                reversed=reversed_)
        except (EventValidationError, ValueError) as e:
            raise HTTPError(400, str(e))
        events = list(st.events().find(auth.app_id, auth.channel_id, filt))
        if not events:
            return json_response({"message": "Not Found"}, 404)
        return json_response([e.to_json() for e in events])

    @app.route("POST", "/batch/events.json")
    def post_batch(req: Request) -> Response:
        auth = authenticate(st, req)
        payload = req.json()
        if not isinstance(payload, list):
            raise HTTPError(400, "batch request body must be a JSON array")
        if len(payload) > MAX_EVENTS_PER_BATCH:
            raise HTTPError(400, "Batch request must have less than or equal "
                                 f"to {MAX_EVENTS_PER_BATCH} events")
        results: list = []
        valid: list = []  # (position in results, event)
        for obj in payload:
            try:
                event = _stamp_trace(req, _parse_event(lambda: obj))
            except HTTPError as e:
                results.append({"status": 400, "message": e.message})
                continue
            if not _allowed(auth, event.event):
                results.append({"status": 403,
                                "message": _not_allowed(event.event)})
                continue
            try:
                plug.process_input(auth.app_id, auth.channel_id, event)
            except Exception as e:  # noqa: BLE001 — per-event isolation
                results.append({"status": 500, "message": str(e)})
                continue
            results.append(None)  # filled below
            valid.append((len(results) - 1, event))
        if valid:
            # one all-or-nothing transaction; per event if it fails, so
            # one poison event cannot fail the batch. Only the
            # insert_batch call is guarded: nothing after it may re-insert
            try:
                ids = st.events().insert_batch(
                    [e for _, e in valid], auth.app_id, auth.channel_id)
            except Exception:  # noqa: BLE001 — isolate per event
                ids = None
            for k, (pos, event) in enumerate(valid):
                if ids is not None:
                    results[pos] = {"status": 201, "eventId": ids[k]}
                    continue
                try:
                    eid = st.events().insert(event, auth.app_id,
                                             auth.channel_id)
                    results[pos] = {"status": 201, "eventId": eid}
                except Exception as e:  # noqa: BLE001
                    results[pos] = {"status": 500, "message": str(e)}
            accepted = [event for pos, event in valid
                        if results[pos]["status"] == 201]
            if accepted:
                ingested.labels(route="batch").inc(len(accepted))
                for e in accepted:
                    _book(auth.app_id, e)
                _publish(auth.app_id, [(e.entity_type, e.entity_id, e.event)
                                       for e in accepted], len(accepted))
        return json_response(results)

    @app.route("POST", "/columnar/events.npz")
    def post_columnar(req: Request) -> Response:
        """The bulk lane: one npz column block, no per-event JSON parse
        and no per-event ``Event`` object, written in one transaction."""
        auth = authenticate(st, req)
        try:
            batch = batch_from_npz(req.body)
        except Exception as e:
            raise HTTPError(400, f"bad columnar block: {e}")
        if auth.events:
            names = [batch.dicts.event_names.values[int(c)]
                     for c in np.unique(batch.event)]
            bad = [nm for nm in names if not _allowed(auth, nm)]
            if bad:
                return json_response({"message": _not_allowed(bad[0])}, 403)
        n = st.events().insert_columnar(batch, auth.app_id, auth.channel_id)
        ingested.labels(route="columnar").inc(n)
        if n:
            # one publish of the block's unique (type, id, event) triples
            d = batch.dicts
            uniq = np.unique(np.stack([batch.entity_type, batch.entity_id,
                                       batch.event], axis=1), axis=0)
            _publish(auth.app_id, [
                (d.entity_types.values[int(a)], d.entity_ids.values[int(b)],
                 d.event_names.values[int(c)]) for a, b, c in uniq], n)
        if collector:
            collector.bookkeeping_bulk(auth.app_id, 201, batch)
        return json_response({"accepted": int(n)}, 201)

    @app.route("GET", "/stats.json")
    def get_stats(req: Request) -> Response:
        auth = authenticate(st, req)
        if collector is None:
            return json_response(
                {"message": "To see stats, launch Event Server with --stats "
                            "argument.",
                 "statsEnabled": False,
                 "hint": "Restart with `ptpu eventserver --stats` — the "
                         "collector only exists when enabled at boot. "
                         "Aggregate counters are always available at "
                         "/metrics and /status.json."}, 404)
        return json_response(collector.get(auth.app_id))

    @app.route("GET", r"/events/(?P<event_id>[^/]+)\.json")
    def get_event(req: Request) -> Response:
        auth = authenticate(st, req)
        event = st.events().get(req.path_params["event_id"], auth.app_id,
                                auth.channel_id)
        if event is None:
            return json_response({"message": "Not Found"}, 404)
        return json_response(event.to_json())

    @app.route("DELETE", r"/events/(?P<event_id>[^/]+)\.json")
    def delete_event(req: Request) -> Response:
        auth = authenticate(st, req)
        if st.events().delete(req.path_params["event_id"], auth.app_id,
                              auth.channel_id):
            return json_response({"message": "Found"})
        return json_response({"message": "Not Found"}, 404)

    def _webhook_post(req: Request, name: str, is_form: bool) -> Response:
        auth = authenticate(st, req)
        connector = (form_connectors if is_form
                     else json_connectors).get(name)
        if connector is None:
            return json_response(
                {"message": f"webhooks connection for {name} is not "
                            "supported."}, 404)
        try:
            data = req.form() if is_form else req.json()
            event = _stamp_trace(req, to_event(connector, data))
        except (ConnectorException, EventValidationError, ValueError) as e:
            raise HTTPError(400, str(e))
        event_id = st.events().insert(event, auth.app_id, auth.channel_id)
        ingested.labels(route="webhook").inc()
        _publish(auth.app_id, [(event.entity_type, event.entity_id,
                                event.event)], 1)
        _book(auth.app_id, event)
        return json_response({"eventId": event_id}, 201)

    def _webhook_get(req: Request, name: str, is_form: bool) -> Response:
        authenticate(st, req)
        if name in (form_connectors if is_form else json_connectors):
            return json_response({"message": "Ok"})
        return json_response(
            {"message": f"webhooks connection for {name} is not supported."},
            404)

    for suffix, is_form in ((r"\.json", False), (r"\.form", True)):
        pattern = r"/webhooks/(?P<name>[^/]+)" + suffix
        app.route("POST", pattern)(
            lambda req, f=is_form: _webhook_post(
                req, req.path_params["name"], f))
        app.route("GET", pattern)(
            lambda req, f=is_form: _webhook_get(
                req, req.path_params["name"], f))

    return app


def create_event_server(storage: Optional[Storage] = None,
                        host: str = "0.0.0.0", port: int = 7070,
                        stats: bool = False,
                        bus: Optional[InvalidationBus] = None,
                        plugins: Optional[EventServerPlugins] = None,
                        ssl_context=None) -> AppServer:
    """Bind the event server (default port 7070), not yet serving: call
    ``start_background()`` or ``serve_forever()`` on it. ``close()``
    also stops the plugins' sniffer thread."""
    app = build_app(storage, stats=stats, plugins=plugins, bus=bus)
    srv = AppServer(app, host, port, ssl_context=ssl_context)
    srv.on_close(app.plugins.close)
    return srv
