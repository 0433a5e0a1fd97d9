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
- ``GET`` / ``DELETE /events/<id>.json``.

Every accepted ingest is published to the invalidation bus
(``cache/bus.py``; the process-wide one unless ``bus`` is given): a
single event on its own, a batch or a column block coalesced through one
``publish_many``. A stream trainer in the same process wakes on it. A
failed publish is logged and never fails the ingest.

Left out (``ROADMAP.md`` queue 1): event-server plugins, webhooks,
``/stats.json``, ``/metrics`` and trace stamping; those routes answer
404, and ``stats=True`` raises.
"""

from __future__ import annotations

import base64
import logging
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..cache.bus import InvalidationBus, default_bus
from ..data.event import Event, EventValidationError, parse_iso
from ..data.storage.base import ANY, LEFT_OUT, EventFilter
from ..data.storage.registry import Storage, get_storage
from ..data.storage.wire import batch_from_npz
from .http import AppServer, HTTPApp, HTTPError, Request, Response, \
    json_response

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
              bus: Optional[InvalidationBus] = None) -> HTTPApp:
    if stats:
        raise NotImplementedError(f"/stats.json is {LEFT_OUT}")
    st = storage if storage is not None else get_storage()
    inval_bus = bus if bus is not None else default_bus()
    app = HTTPApp("eventserver")

    def _publish(app_id: int, items: List[tuple]) -> None:
        """Best-effort bus publish of ``(entity_type, entity_id,
        event)`` items: ingest never fails because a subscriber did."""
        try:
            if len(items) == 1:
                inval_bus.publish(app_id, *items[0])
            else:
                inval_bus.publish_many(app_id, items)
        except Exception as e:  # noqa: BLE001 — ingest goes on
            log.error("invalidation publish failed: %s", e)

    @app.route("GET", "/")
    def index(req: Request) -> Response:
        return json_response({"status": "alive"})

    @app.route("POST", "/events.json")
    def post_event(req: Request) -> Response:
        auth = authenticate(st, req)
        event = _parse_event(req.json)
        if not _allowed(auth, event.event):
            return json_response({"message": _not_allowed(event.event)}, 403)
        event_id = st.events().insert(event, auth.app_id, auth.channel_id)
        _publish(auth.app_id, [(event.entity_type, event.entity_id,
                                event.event)])
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
                event = _parse_event(lambda: obj)
            except HTTPError as e:
                results.append({"status": 400, "message": e.message})
                continue
            if not _allowed(auth, event.event):
                results.append({"status": 403,
                                "message": _not_allowed(event.event)})
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
                _publish(auth.app_id, [(e.entity_type, e.entity_id, e.event)
                                       for e in accepted])
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
        if n:
            # one publish of the block's unique (type, id, event) triples
            d = batch.dicts
            uniq = np.unique(np.stack([batch.entity_type, batch.entity_id,
                                       batch.event], axis=1), axis=0)
            _publish(auth.app_id, [
                (d.entity_types.values[int(a)], d.entity_ids.values[int(b)],
                 d.event_names.values[int(c)]) for a, b, c in uniq])
        return json_response({"accepted": int(n)}, 201)

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

    return app


def create_event_server(storage: Optional[Storage] = None,
                        host: str = "0.0.0.0", port: int = 7070,
                        stats: bool = False,
                        bus: Optional[InvalidationBus] = None) -> AppServer:
    """Bind the event server (default port 7070), not yet serving: call
    ``start_background()`` or ``serve_forever()`` on it."""
    return AppServer(build_app(storage, stats=stats, bus=bus), host, port)
