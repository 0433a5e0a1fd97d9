"""The port's event server against the JAX package's, request for request.

Both servers run on port 0 over their own MEMORY storage, seeded alike
(one app, an open key, a key limited to ``rate``, a channel). Every
request goes to both, in the same order; status codes and JSON bodies
must be equal, with generated event ids and creation times blanked
(explicit ids and times are compared as they are).
"""

import base64
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import predictionio_tpu.data.columnar as jcol
import predictionio_tpu.data.event as jev
import predictionio_tpu.data.storage.base as jbase
import predictionio_tpu.data.storage.wire as jwire
from predictionio_tpu.data.storage.registry import Storage as JStorage
from predictionio_tpu.server.eventserver import \
    create_event_server as jax_event_server
from predictionio_tpu_torch.data.storage import base as pbase
from predictionio_tpu_torch.data.storage.registry import Storage as PStorage
from predictionio_tpu_torch.server.eventserver import (
    MAX_EVENTS_PER_BATCH,
    create_event_server,
)

MEMORY = {"PIO_STORAGE_SOURCES_MEM_TYPE": "MEMORY"}


def seed(storage, base):
    app_id = storage.apps().insert(base.App(0, "testapp", None))
    storage.access_keys().insert(base.AccessKey("KEY1", app_id, ()))
    storage.access_keys().insert(base.AccessKey("KEYLIMITED", app_id,
                                                ("rate",)))
    storage.channels().insert(base.Channel(0, "chan1", app_id))
    return storage


@pytest.fixture(scope="module")
def servers():
    jst = seed(JStorage(env=MEMORY), jbase)
    pst = seed(PStorage(env=MEMORY), pbase)
    jsrv = jax_event_server(jst, host="127.0.0.1", port=0)
    psrv = create_event_server(pst, host="127.0.0.1", port=0)
    jsrv.start_background()
    psrv.start_background()
    yield jsrv, psrv
    jsrv.shutdown()
    psrv.close()


#: loopback only: no proxy from the environment may carry these requests
_LOCAL = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def call(port, method, path, body=None, headers=None, raw=None):
    data = raw if raw is not None else (
        json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method=method,
                                 headers=headers or {})
    try:
        with _LOCAL.open(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def blank(x, explicit=("e1", "e2", "e3")):
    """Generated ids and creation times differ between two stores."""
    if isinstance(x, list):
        return [blank(v) for v in x]
    if isinstance(x, dict):
        return {k: ("*" if (k == "eventId" and v not in explicit)
                    or (k == "creationTime" and v != CREATED) else blank(v))
                for k, v in x.items()}
    return x


CREATED = "2024-01-01T00:00:00.000Z"


def ev(event="rate", user="u1", item="i1", t="2024-01-02T03:04:05.678Z",
       **extra):
    e = {"event": event, "entityType": "user", "entityId": user,
         "targetEntityType": "item", "targetEntityId": item,
         "eventTime": t, "creationTime": CREATED}
    if event == "rate":
        e["properties"] = {"rating": 4.5}
    e.update(extra)
    return e


def basic(key):
    return {"Authorization": "Basic " + base64.b64encode(
        f"{key}:".encode()).decode()}


def columnar_block(events):
    batch = jcol.columnar_from_events(jev.Event.from_json(e) for e in events)
    return jwire.batch_to_npz(batch)


K = "?accessKey=KEY1"
KL = "?accessKey=KEYLIMITED"
TIMES = [f"2024-01-0{d}T00:00:00.000Z" for d in range(3, 9)]

#: (id, method, path, JSON body or raw bytes, headers), sent in order
SCRIPT = [
    ("alive", "GET", "/", None, None),
    ("no-key", "POST", "/events.json", ev(), None),
    ("bad-key", "POST", "/events.json?accessKey=NOPE", ev(), None),
    ("basic-auth", "POST", "/events.json", ev(eventId="e3"), basic("KEY1")),
    ("post", "POST", f"/events.json{K}", ev(eventId="e1"), None),
    ("missing-entity", "POST", f"/events.json{K}",
     {"event": "rate", "entityType": "user"}, None),
    ("reserved-name", "POST", f"/events.json{K}", ev(event="$nope"), None),
    ("bad-json", "POST", f"/events.json{K}", b"{not json", None),
    ("limited-ok", "POST", f"/events.json{KL}", ev(user="u2"), None),
    ("limited-403", "POST", f"/events.json{KL}", ev(event="buy"), None),
    ("channel-post", "POST", f"/events.json{K}&channel=chan1",
     ev(user="uc"), None),
    ("channel-get", "GET", f"/events.json{K}&channel=chan1", None, None),
    ("channel-401", "POST", f"/events.json{K}&channel=nope", ev(), None),
    ("batch", "POST", f"/batch/events.json{K}",
     [ev(user=f"b{k}", t=TIMES[k]) for k in range(3)]
     + [{"event": "rate", "entityType": "", "entityId": "x"},
        ev(event="buy", eventId="e2", t=TIMES[4])], None),
    ("batch-limited", "POST", f"/batch/events.json{KL}",
     [ev(user="b9", t=TIMES[5]), ev(event="buy", user="b9")], None),
    ("batch-not-list", "POST", f"/batch/events.json{K}", {"a": 1}, None),
    ("batch-too-long", "POST", f"/batch/events.json{K}",
     [ev()] * (MAX_EVENTS_PER_BATCH + 1), None),
    ("get-all", "GET", f"/events.json{K}", None, None),
    ("get-limit", "GET", f"/events.json{K}&limit=2", None, None),
    ("get-entity-reversed", "GET",
     f"/events.json{K}&entityType=user&entityId=u1&reversed=true", None,
     None),
    ("reversed-alone-400", "GET", f"/events.json{K}&reversed=true", None,
     None),
    ("bad-time-400", "GET", f"/events.json{K}&startTime=yesterday", None,
     None),
    ("filter-event-target", "GET",
     f"/events.json{K}&event=buy&targetEntityType=item", None, None),
    ("time-window", "GET", f"/events.json{K}&startTime={TIMES[0]}"
     f"&untilTime={TIMES[2]}", None, None),
    ("none-404", "GET", f"/events.json{K}&entityId=nobody", None, None),
    ("get-one", "GET", f"/events/e1.json{K}", None, None),
    ("delete", "DELETE", f"/events/e1.json{K}", None, None),
    ("get-deleted-404", "GET", f"/events/e1.json{K}", None, None),
    ("delete-again-404", "DELETE", f"/events/e1.json{K}", None, None),
    ("columnar", "POST", f"/columnar/events.npz{K}",
     columnar_block([ev(user=f"c{k}", item=f"i{k % 3}", t=TIMES[k % 6])
                     for k in range(40)]), None),
    ("columnar-limited-403", "POST", f"/columnar/events.npz{KL}",
     columnar_block([ev(), ev(event="buy")]), None),
    ("columnar-bad-400", "POST", f"/columnar/events.npz{K}", b"junk", None),
    ("after-columnar", "GET", f"/events.json{K}&entityId=c7", None, None),
    ("unknown-route-404", "GET", "/nope.json", None, None),
    ("method-405", "DELETE", "/events.json", None, None),
]


@pytest.mark.parametrize("step", range(len(SCRIPT)),
                         ids=[s[0] for s in SCRIPT])
def test_same_answer_as_the_jax_server(servers, step):
    """Steps run in order against both servers (one module-scoped pair),
    so later reads see what earlier writes left."""
    _, method, path, body, headers = SCRIPT[step]
    raw = body if isinstance(body, bytes) else None
    got = [call(srv.port, method, path, None if raw else body, headers, raw)
           for srv in servers]
    (js, jb), (ps, pb) = got
    assert ps == js, (pb, jb)
    assert blank(pb) == blank(jb)


def test_columnar_block_lands_as_events():
    st = seed(PStorage(env=MEMORY), pbase)
    srv = create_event_server(st, "127.0.0.1", 0).start_background()
    try:
        block = columnar_block([ev(user=f"c{k}", t=TIMES[k % 6])
                                for k in range(10)])
        assert call(srv.port, "POST", f"/columnar/events.npz{K}",
                    raw=block) == (201, {"accepted": 10})
        got = list(st.events().find(1))
        assert sorted(e.entity_id for e in got) == sorted(
            f"c{k}" for k in range(10))
        np.testing.assert_array_equal(
            [e.properties["rating"] for e in got], [4.5] * 10)
    finally:
        srv.close()
