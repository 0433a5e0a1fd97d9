"""The event server's extras in the port against the JAX package's:
webhooks, ``/stats.json``, plugins, ``/metrics`` and ``pio_traceparent``
stamping.

Both servers run on port 0 over their own MEMORY storage, seeded alike
(the app, key and channel of ``tests/test_torch_eventserver.py``), with
``stats`` on or off. Every request goes to both in the same order; status
codes and JSON bodies must be equal (generated event ids and creation
times blanked), and so must the events each store holds afterwards.
"""

import json
import urllib.error
import urllib.parse
import urllib.request

import pytest

import predictionio_tpu.data.storage.base as jbase
from predictionio_tpu.data.storage.registry import Storage as JStorage
from predictionio_tpu.server import eventserver as jev
from predictionio_tpu.server.http import Request as JRequest
from predictionio_tpu.server.plugins import EventServerPlugin as JPlugin
from predictionio_tpu.server.plugins import EventServerPlugins as JPlugins
from predictionio_tpu.utils import tracing as jtracing
from predictionio_tpu_torch.data.storage import base as pbase
from predictionio_tpu_torch.data.storage.registry import Storage as PStorage
from predictionio_tpu_torch.data.webhooks import (
    ConnectorException,
    form_connectors,
    json_connectors,
)
from predictionio_tpu_torch.obs.trace import parse_traceparent
from predictionio_tpu_torch.server import eventserver as pev
from predictionio_tpu_torch.server.http import Request as PRequest
from predictionio_tpu_torch.server.plugins import EventServerPlugin as PPlugin
from predictionio_tpu_torch.server.plugins import EventServerPlugins as PPlugins
from predictionio_tpu_torch.utils import tracing as ptracing

MEMORY = {"PIO_STORAGE_SOURCES_MEM_TYPE": "MEMORY"}
K = "?accessKey=KEY1"

#: loopback only: no proxy from the environment may carry these requests
_LOCAL = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def seed(storage, base):
    app_id = storage.apps().insert(base.App(0, "testapp", None))
    storage.access_keys().insert(base.AccessKey("KEY1", app_id, ()))
    storage.access_keys().insert(base.AccessKey("KEYLIMITED", app_id,
                                                ("rate",)))
    storage.channels().insert(base.Channel(0, "chan1", app_id))
    return storage


@pytest.fixture(params=[True, False], ids=["stats", "no-stats"])
def servers(request):
    # the process-wide ``timed`` spans (``pio_span_seconds``) hold what
    # earlier tests of this worker recorded: clear both packages', so
    # each server renders only its own families
    jtracing.spans.reset()
    ptracing.spans.reset()
    jst = seed(JStorage(env=MEMORY), jbase)
    pst = seed(PStorage(env=MEMORY), pbase)
    jsrv = jev.create_event_server(jst, host="127.0.0.1", port=0,
                                   stats=request.param).start_background()
    psrv = pev.create_event_server(pst, host="127.0.0.1", port=0,
                                   stats=request.param).start_background()
    yield jsrv, psrv, jst, pst
    jsrv.shutdown()
    psrv.close()


def call(port, method, path, body=None, form=None, headers=None):
    """``(status, JSON body, response headers)``; ``form`` posts a
    url-encoded body."""
    if form is not None:
        data = urllib.parse.urlencode(form).encode()
    else:
        data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method=method, headers=headers or {})
    try:
        resp = _LOCAL.open(req, timeout=30)
    except urllib.error.HTTPError as e:
        resp = e
    with resp:
        raw = resp.read()
        try:
            out = json.loads(raw or b"null")
        except ValueError:
            out = raw.decode()
        return resp.status, out, dict(resp.headers)


def blank(x):
    if isinstance(x, list):
        return [blank(v) for v in x]
    if isinstance(x, dict):
        return {k: "*" if k in ("eventId", "creationTime") else blank(v)
                for k, v in x.items()}
    return x


SEGMENT = {"type": "track", "version": "2", "user_id": "u42",
           "timestamp": "2024-05-06T07:08:09.000Z", "event": "signup",
           "properties": {"plan": "pro"}, "context": {"ip": "10.0.0.1"}}

MAILCHIMP = {
    "type": "subscribe", "fired_at": "2009-03-26 21:35:57",
    "data[id]": "8a25ff1d98", "data[list_id]": "a6b5da1054",
    "data[email]": "api@mailchimp.com", "data[email_type]": "html",
    "data[merges][EMAIL]": "api@mailchimp.com",
    "data[merges][FNAME]": "MailChimp", "data[merges][LNAME]": "API",
    "data[ip_opt]": "10.20.10.30", "data[ip_signup]": "10.20.10.30",
}

TP = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"
EVENT = {"event": "rate", "entityType": "user", "entityId": "u1",
         "targetEntityType": "item", "targetEntityId": "i1",
         "properties": {"rating": 4.5},
         "eventTime": "2024-01-02T03:04:05.678Z"}

#: (id, method, path, JSON body, form body, headers), sent in order
SCRIPT = [
    ("segment", "POST", f"/webhooks/segmentio.json{K}", SEGMENT, None, None),
    ("segment-identify", "POST", f"/webhooks/segmentio.json{K}",
     {"type": "identify", "version": "2", "anonymous_id": "anon",
      "timestamp": "2024-05-06T07:08:10.000Z",
      "traits": {"email": "x@y.z"}}, None, None),
    ("segment-no-version", "POST", f"/webhooks/segmentio.json{K}",
     {"type": "track", "user_id": "u1"}, None, None),
    ("segment-unknown-type", "POST", f"/webhooks/segmentio.json{K}",
     {"type": "bogus", "version": "2", "user_id": "u1"}, None, None),
    ("segment-no-user", "POST", f"/webhooks/segmentio.json{K}",
     {"type": "track", "version": "2"}, None, None),
    ("segment-no-key", "POST", "/webhooks/segmentio.json", SEGMENT, None,
     None),
    ("segment-get", "GET", f"/webhooks/segmentio.json{K}", None, None, None),
    ("unknown-json", "POST", f"/webhooks/nope.json{K}", SEGMENT, None, None),
    ("unknown-get", "GET", f"/webhooks/nope.json{K}", None, None, None),
    ("mailchimp", "POST", f"/webhooks/mailchimp.form{K}", None, MAILCHIMP,
     None),
    ("mailchimp-unsubscribe", "POST", f"/webhooks/mailchimp.form{K}", None,
     {**MAILCHIMP, "type": "unsubscribe", "data[action]": "unsub",
      "data[reason]": "manual", "data[campaign_id]": "cb398d21d2"}, None),
    ("mailchimp-bad-time", "POST", f"/webhooks/mailchimp.form{K}", None,
     {**MAILCHIMP, "fired_at": "yesterday"}, None),
    ("mailchimp-get", "GET", f"/webhooks/mailchimp.form{K}", None, None,
     None),
    ("form-unknown", "GET", f"/webhooks/segmentio.form{K}", None, None,
     None),
    ("traced-event", "POST", f"/events.json{K}", EVENT, None,
     {"traceparent": TP}),
    ("traced-batch", "POST", f"/batch/events.json{K}",
     [dict(EVENT, entityId="u2"), dict(EVENT, entityId="u3")], None,
     {"traceparent": TP}),
    ("traced-webhook", "POST", f"/webhooks/segmentio.json{K}",
     dict(SEGMENT, user_id="u43"), None, {"traceparent": TP}),
    ("untraced-event", "POST", f"/events.json{K}",
     dict(EVENT, entityId="u4"), None, None),
    ("stats", "GET", f"/stats.json{K}", None, None, None),
    ("stats-no-key", "GET", "/stats.json", None, None, None),
    ("plugins", "GET", "/plugins.json", None, None, None),
    ("plugin-unknown", "GET", f"/plugins/inputblockers/nope{K}", None, None,
     None),
    ("status", "GET", "/status.json", None, None, None),
]


def run_script(servers):
    jsrv, psrv, _, _ = servers
    out = []
    for name, method, path, body, form, headers in SCRIPT:
        got = [call(srv.port, method, path, body, form, headers)
               for srv in (jsrv, psrv)]
        out.append((name, got))
    return out


def test_every_answer_matches(servers):
    for name, ((js, jb, _), (ps, pb, _)) in run_script(servers):
        if name == "status":  # the registry snapshot holds wall times
            jb = {k: v for k, v in jb.items() if k != "metrics"}
            pb = {k: v for k, v in pb.items() if k != "metrics"}
        assert (ps, blank(pb)) == (js, blank(jb)), name


def stored(storage):
    out = []
    for e in storage.events().find(1):
        d = e.to_json()
        d.pop("eventId")
        d.pop("creationTime")
        tp = d.get("properties", {}).pop("pio_traceparent", None)
        if tp is not None:  # the request's own span id is random
            d["traceId"] = parse_traceparent(tp)[0]
        out.append(d)
    return sorted(out, key=json.dumps)


def test_the_stores_hold_the_same_events(servers):
    run_script(servers)
    _, _, jst, pst = servers
    want, got = stored(jst), stored(pst)
    assert got == want
    traced = [e for e in got if "traceId" in e]
    # the traced event, the batch's two and the traced webhook's
    assert len(traced) == 4
    assert {e["traceId"] for e in traced} == {TP.split("-")[1]}
    assert [e["properties"]["event"] for e in got
            if e["event"] == "track"] == ["signup", "signup"]


def test_the_stamp_is_the_ingest_requests_own_context(servers):
    jsrv, psrv, jst, pst = servers
    for srv, st in ((jsrv, jst), (psrv, pst)):
        status, body, headers = call(srv.port, "POST", f"/events.json{K}",
                                     EVENT, headers={"traceparent": TP})
        assert status == 201
        e = st.events().get(body["eventId"], 1)
        assert e.properties.get("pio_traceparent") == headers["traceparent"]
        assert parse_traceparent(headers["traceparent"])[0] \
            == TP.split("-")[1]


def test_stats_json_counts_alike():
    """With ``--stats`` both packages count the same ingest the same way
    (events with and without a channel, a 403 left uncounted); without
    it both answer the same 404."""
    got = {}
    for stats in (True, False):
        for pkg, ev, mod_st, base in (("jax", jev, JStorage, jbase),
                                      ("port", pev, PStorage, pbase)):
            srv = ev.create_event_server(seed(mod_st(env=MEMORY), base),
                                         host="127.0.0.1", port=0,
                                         stats=stats).start_background()
            try:
                for n in range(5):
                    call(srv.port, "POST", f"/events.json{K}",
                         dict(EVENT, entityId=f"u{n}"))
                call(srv.port, "POST", f"/events.json{K}&channel=chan1",
                     dict(EVENT, event="buy"))
                call(srv.port, "POST", "/events.json?accessKey=KEYLIMITED",
                     dict(EVENT, event="buy"))
                call(srv.port, "POST", f"/batch/events.json{K}",
                     [dict(EVENT, event="view"), dict(EVENT, event="rate")])
                status, body, _ = call(srv.port, "GET", f"/stats.json{K}")
                got[pkg, stats] = status, body
            finally:
                (srv.close if pkg == "port" else srv.shutdown)()
    assert got["port", True] == got["jax", True]
    assert got["port", True][0] == 200
    assert sum(b["value"] for b in got["port", True][1]["basic"]) == 8
    assert got["port", False] == got["jax", False]
    assert got["port", False][0] == 404


def test_stats_on_mixed_target_types_fail_alike(servers):
    """A fault of both packages (ROADMAP queue 3): an app whose counts
    mix a target entity type and none cannot sort them, and /stats.json
    answers 500 in both."""
    jsrv, psrv, _, _ = servers
    answers = []
    for srv in (jsrv, psrv):
        call(srv.port, "POST", f"/events.json{K}", EVENT)
        call(srv.port, "POST", f"/webhooks/segmentio.json{K}", SEGMENT)
        answers.append(call(srv.port, "GET", f"/stats.json{K}")[:2])
    assert answers[1] == answers[0]
    if answers[0][0] != 404:  # with --stats
        assert answers[0][0] == 500 and "NoneType" in answers[0][1][
            "message"]


def families(text: str) -> set:
    return {ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE ")}


def samples(text: str, name: str) -> dict:
    return {ln.rpartition(" ")[0]: ln.rpartition(" ")[2]
            for ln in text.splitlines() if ln.startswith(name)}


def test_metrics_count_ingest_by_route(servers):
    run_script(servers)
    jsrv, psrv, _, _ = servers
    _, jtext, _ = call(jsrv.port, "GET", "/metrics")
    _, ptext, _ = call(psrv.port, "GET", "/metrics")
    xla = {"pio_xla_compiles_total", "pio_transfer_guard_violations_total"}
    assert families(ptext) == families(jtext) - xla
    for name in ("pio_events_ingested_total", "pio_stats_enabled",
                 "pio_cache_bus_published_total", "pio_http_requests_total"):
        assert samples(ptext, name) == samples(jtext, name), name
    assert samples(ptext, "pio_events_ingested_total") == {
        'pio_events_ingested_total{route="batch"}': "2",
        'pio_events_ingested_total{route="events"}': "2",
        'pio_events_ingested_total{route="webhook"}': "5"}


def test_input_plugins_block_and_serve_rest():
    """A blocker refuses every JSON ingest with a 500; ``/plugins.json``
    and the plugin's REST route answer alike."""
    answers = []
    for base, cls, plugins_cls, plugin_cls, ev, req_cls in (
            (jbase, JStorage, JPlugins, JPlugin, jev, JRequest),
            (pbase, PStorage, PPlugins, PPlugin, pev, PRequest)):

        class RejectAll(plugin_cls):
            plugin_name = "rejectall"
            plugin_description = "refuses everything"

            def process(self, app_id, channel_id, event):
                raise ValueError("blocked by plugin")

            def handle_rest(self, app_id, channel_id, args):
                return {"appId": app_id, "args": args}

        plugins = plugins_cls()
        plugins.register(RejectAll(), blocker=True)
        app = ev.build_app(seed(cls(env=MEMORY), base), plugins=plugins)

        def handle(method, path, body=None, query=None):
            resp = app.handle(req_cls(
                method=method, path=path, query=query or {}, headers={},
                body=json.dumps(body).encode() if body else b""))
            return resp.status, json.loads(resp.encoded())

        answers.append([
            handle("POST", "/events.json", EVENT, {"accessKey": "KEY1"}),
            handle("POST", "/batch/events.json", [EVENT],
                   {"accessKey": "KEY1"}),
            handle("GET", "/plugins.json"),
            handle("GET", "/plugins/inputblockers/rejectall/x/y",
                   query={"accessKey": "KEY1"}),
            handle("GET", "/plugins/inputblockers/rejectall/x"),
            handle("GET", "/plugins/outputblockers/rejectall",
                   query={"accessKey": "KEY1"})])
        plugins.close()
    want, got = answers
    assert got[2][1]["plugins"]["inputblockers"]["rejectall"]["class"] \
        .endswith("RejectAll")
    for g, w in zip(got, want):
        if "plugins" in w[1]:  # the class's qualified name is local
            continue
        assert g == w
    assert got[0][0] == 500 and got[3] == (200, {"appId": 1,
                                                 "args": ["x", "y"]})


@pytest.mark.parametrize("name,payload", [
    ("segmentio", {"type": "page", "version": "2", "user_id": "u9",
                   "name": "home", "properties": {"path": "/"}}),
    ("segmentio", {"type": "group", "version": "2", "user_id": "u9",
                   "group_id": "g1", "traits": {"n": 1}}),
    ("segmentio", {"type": "alias", "version": "2", "user_id": "u9",
                   "previous_id": "old"}),
    ("mailchimp", {**MAILCHIMP, "type": "cleaned", "data[reason]": "hard",
                   "data[email]": "x@y.z"}),
    ("mailchimp", {**MAILCHIMP, "type": "campaign",
                   "data[subject]": "hi", "data[status]": "sent",
                   "data[reason]": ""}),
    ("mailchimp", {**MAILCHIMP, "type": "upemail",
                   "data[new_id]": "n1", "data[new_email]": "a@b.c",
                   "data[old_email]": "o@b.c"}),
    ("mailchimp", {**MAILCHIMP, "type": "profile"}),
], ids=["page", "group", "alias", "cleaned", "campaign", "upemail",
        "profile"])
def test_connectors_convert_like_jax(name, payload):
    from predictionio_tpu.data import webhooks as jhooks

    reg_j = (jhooks.form_connectors if name == "mailchimp"
             else jhooks.json_connectors)
    reg_p = form_connectors if name == "mailchimp" else json_connectors
    try:
        want = reg_j[name].to_event_json(payload)
    except jhooks.ConnectorException as e:
        with pytest.raises(ConnectorException, match=str(e)[:20]):
            reg_p[name].to_event_json(payload)
        return
    assert reg_p[name].to_event_json(payload) == want
