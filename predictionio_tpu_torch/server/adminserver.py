"""Admin REST API: the port of ``predictionio_tpu/server/adminserver.py``.

``GET /`` liveness; ``GET /cmd/app`` lists apps; ``POST /cmd/app``
creates one (the app, a generated access key, the event store's init);
``DELETE /cmd/app/{name}`` deletes an app with its channels, events and
keys; ``DELETE /cmd/app/{name}/data`` wipes its events. Responses carry
the ``{status, message}`` shape of the JAX package's; with an
``accesskey`` every route but ``/`` needs ``?accessKey=``. Every server's
telemetry mount (``server/http.py::mount_metrics``) adds ``GET
/metrics``, ``/metrics.json``, ``/trace.json`` and ``/status.json``.
"""

from __future__ import annotations

from typing import Optional

from ..data.storage.base import AccessKey, App
from ..data.storage.registry import Storage, get_storage
from ..obs import MetricsRegistry
from .http import (
    AppServer,
    HTTPApp,
    Request,
    Response,
    json_response,
    make_key_auth,
    mount_metrics,
)


def build_app(storage: Optional[Storage] = None,
              accesskey: Optional[str] = None) -> HTTPApp:
    app = HTTPApp("adminserver")
    registry = MetricsRegistry()
    mount_metrics(app, registry, server_name="adminserver",
                  status=lambda: {"status": "alive"})
    app.metrics_registry = registry  # type: ignore[attr-defined]

    def st() -> Storage:
        return storage if storage is not None else get_storage()

    _auth = make_key_auth(accesskey)

    @app.route("GET", "/")
    def index(req: Request) -> Response:
        return json_response({"status": "alive"})

    @app.route("GET", "/cmd/app")
    def app_list(req: Request) -> Response:
        _auth(req)
        s = st()
        apps = []
        for a in s.apps().get_all():
            keys = s.access_keys().get_by_app_id(a.id)
            apps.append({"name": a.name, "id": a.id,
                         "accessKey": keys[0].key if keys else ""})
        return json_response({"status": 1, "message": "Successful retrieved"
                              " app list.", "apps": apps})

    @app.route("POST", "/cmd/app")
    def app_new(req: Request) -> Response:
        _auth(req)
        body = req.json() or {}
        name = body.get("name")
        if not name:
            return json_response({"status": 0,
                                  "message": "name is required."}, 400)
        s = st()
        if s.apps().get_by_name(name) is not None:
            return json_response(
                {"status": 0,
                 "message": f"App {name} already exists. Aborting."})
        app_id = s.apps().insert(App(id=int(body.get("id") or 0), name=name,
                                     description=body.get("description")))
        if app_id is None:
            return json_response({"status": 0,
                                  "message": "Unable to create new app."})
        s.events().init(app_id)
        key = s.access_keys().insert(AccessKey(key="", app_id=app_id,
                                               events=()))
        return json_response({"status": 1,
                              "message": "App created successfully.",
                              "id": app_id, "name": name, "key": key})

    @app.route("DELETE", r"/cmd/app/(?P<name>[^/]+)/data")
    def app_data_delete(req: Request) -> Response:
        _auth(req)
        s = st()
        a = s.apps().get_by_name(req.path_params["name"])
        if a is None:
            return json_response(
                {"status": 0,
                 "message": f"App {req.path_params['name']} does not "
                            f"exist."}, 404)
        s.events().remove(a.id)
        s.events().init(a.id)
        return json_response({"status": 1,
                              "message": f"Removed Event Store for this app "
                                         f"ID: {a.id}"})

    @app.route("DELETE", r"/cmd/app/(?P<name>[^/]+)")
    def app_delete(req: Request) -> Response:
        _auth(req)
        s = st()
        a = s.apps().get_by_name(req.path_params["name"])
        if a is None:
            return json_response(
                {"status": 0,
                 "message": f"App {req.path_params['name']} does not "
                            f"exist."}, 404)
        for c in s.channels().get_by_app_id(a.id):
            s.events().remove(a.id, c.id)
            s.channels().delete(c.id)
        s.events().remove(a.id)
        for k in s.access_keys().get_by_app_id(a.id):
            s.access_keys().delete(k.key)
        s.apps().delete(a.id)
        return json_response({"status": 1,
                              "message": "App successfully deleted"})

    return app


def create_admin_server(storage: Optional[Storage] = None,
                        host: str = "127.0.0.1",
                        port: int = 7071,
                        accesskey: Optional[str] = None,
                        ssl_context=None) -> AppServer:
    """Bind the admin server (default port 7071), not yet serving."""
    return AppServer(build_app(storage, accesskey=accesskey), host=host,
                     port=port, ssl_context=ssl_context)
