"""The port's native codec (``predictionio_tpu_torch/native``) against the
JAX package's and against its own Python lane.

The port builds its own copy of ``_codec.cpp`` with ``g++`` into its
kernel root. On the same bytes its ``parse_segment``, ``import_jsonl``
and ``pack_flat`` give what the JAX package's codec gives (the cases of
``tests/test_native.py``); a SEGMENTFS sidecar encoded through the codec
equals the Python lane's (``PTPU_NO_NATIVE=1``) and the JAX package's;
every block's lane is counted; a failed build falls back to the Python
lane with a warning.
"""

import json
import logging

import numpy as np
import pytest

import predictionio_tpu.native as jnative
from predictionio_tpu.data.storage.segmentfs import (
    SegmentFSClient as JSegmentFSClient,
    SegmentFSEventStore as JSegmentFSEventStore,
)
from predictionio_tpu_torch import native
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.segmentfs import (
    SegmentFSClient,
    SegmentFSEventStore,
)
from predictionio_tpu_torch.ops import _build


@pytest.fixture(scope="module")
def mods():
    """(the port's codec, the JAX package's): both build here."""
    port, jax_mod = native.codec(), jnative.codec()
    assert port is not None and jax_mod is not None
    return port, jax_mod


def test_the_library_lives_in_the_port_kernel_root(mods):
    path = native.target()
    assert path.exists() and path.parent.parent == _build.root()
    assert mods[0].__name__ == "predictionio_tpu_torch.native._codec"
    assert mods[0].__file__ == str(path)


TRICKY = [
    {"op": "put", "event": {
        "event": "rate", "entityType": "user", "entityId": "uñ→\"x\\",
        "targetEntityType": "item", "targetEntityId": "i\U0001F600",
        "eventId": "e1",
        "properties": {"rating": 4.5, "note": "a\nb",
                       "nested": {"k": [1, {"r": 2}]}, "flag": True},
        "eventTime": "2026-07-30T12:00:00.123Z",
        "creationTime": "2026-07-30T12:00:00.123Z", "tags": ["a", "b"]}},
    {"op": "put", "event": {
        "event": "$set", "entityType": "item", "entityId": "i1",
        "eventId": "e2", "eventTime": "2026-07-30T12:00:01.000Z",
        "creationTime": "2026-07-30T12:00:01.000Z"}},
]
NUMBERS = [{"op": "put", "event": {
    "event": "rate", "entityType": "user", "entityId": "u",
    "targetEntityType": "item", "targetEntityId": "i", "eventId": f"e{k}",
    "properties": {"rating": v}, "eventTime": "2026-01-01T00:00:00.000Z",
    "creationTime": "2026-01-01T00:00:00.000Z"}}
    for k, v in enumerate(["4.5", True, None, 3])]


def lines(recs) -> bytes:
    return "".join(json.dumps(r) + "\n" for r in recs).encode()


def same(a, b) -> None:
    """Equal, NaN equal to NaN."""
    assert type(a) is type(b) or {type(a), type(b)} <= {list, tuple}
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b)
    else:
        assert a == b


@pytest.mark.parametrize("recs", [TRICKY, NUMBERS], ids=["tricky",
                                                        "numbers"])
def test_parse_segment_matches_the_jax_codec(mods, recs):
    port, jax_mod = mods
    data = lines(recs)
    out = port.parse_segment(data, ("rating", "note"))
    same(out, jax_mod.parse_segment(data, ("rating", "note")))
    ev, et, ei, tt, ti, times, ids, praw, fps = out
    assert ids == [r["event"]["eventId"] for r in recs]
    if recs is TRICKY:
        assert ei[0] == 'uñ→"x\\' and tt[1] is None
        assert json.loads(praw[0]) == recs[0]["event"]["properties"]
        assert fps[0][0] == 4.5 and np.isnan(fps[0][1])
    else:  # only a real JSON number becomes a rating
        assert np.isnan(fps[0][:3]).all() and fps[0][3] == 3.0


def test_parse_segment_refusals_match(mods):
    port, jax_mod = mods
    dele = (json.dumps({"op": "del", "id": "x"}) + "\n").encode()
    assert port.parse_segment(dele, ()) is None
    assert jax_mod.parse_segment(dele, ()) is None
    for m in mods:
        with pytest.raises(ValueError):
            m.parse_segment(b'{"op": "put", "event": {oops\n', ())


def api_lines(n=300, seed=3) -> bytes:
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        e = {"event": "rate", "entityType": "user",
             "entityId": f"u{int(rng.integers(0, 40))}",
             "targetEntityType": "item",
             "targetEntityId": f"ié{int(rng.integers(0, 25))}",
             "properties": {"rating": float(rng.integers(1, 11)) / 2},
             "eventTime": f"2024-02-01T10:{k % 60:02d}:00.000Z"}
        if k % 17 == 0:
            del e["eventTime"]  # the block's default time
        if k % 23 == 0:
            e["eventId"] = f"explicit-{k}"
        out.append(json.dumps(e))
    return ("\n".join(out) + "\n").encode()


def test_import_jsonl_payload_matches_the_jax_codec(mods):
    port, jax_mod = mods
    buf = api_lines()
    nlines = buf.count(b"\n")
    rnd = bytes(range(256)) * (16 * nlines // 256 + 1)
    rnd = rnd[:16 * nlines]
    now = "2024-03-01T00:00:00.000Z"
    a = port.import_jsonl(buf, rnd, now)
    b = jax_mod.import_jsonl(buf, rnd, now)
    assert a == b and a[1] == 300 and a[0] is not None
    # a line the strict lane declines: the block comes back as None
    bad = b'{"event": "rate", "entityType": 7, "entityId": "u"}\n'
    assert port.import_jsonl(bad, bytes(16), now)[0] is None
    assert jax_mod.import_jsonl(bad, bytes(16), now)[0] is None


def test_pack_flat_matches_the_jax_codec(mods):
    port, jax_mod = mods
    rng = np.random.default_rng(5)
    nnz, n_rows = 500, 30
    rows = rng.integers(0, n_rows, nnz).astype(np.int32)
    cols = rng.integers(0, 90, nnz).astype(np.int32)
    vals = rng.random(nnz).astype(np.float32)
    counts = np.bincount(rows, minlength=n_rows).astype(np.int32)
    cap = np.minimum(counts, 12).astype(np.int32)
    base = np.concatenate([[0], np.cumsum(cap)[:-1]]).astype(np.int32)
    S = int(cap.sum())
    a = port.pack_flat(rows, cols, vals, base, cap, n_rows, S)
    b = jax_mod.pack_flat(rows, cols, vals, base, cap, n_rows, S)
    assert bytes(a[0]) == bytes(b[0]) and bytes(a[1]) == bytes(b[1])


def events(n=400, seed=7):
    rng = np.random.default_rng(seed)
    return [Event(event="rate", entity_type="user", entity_id=f"u{int(u)}",
                  target_entity_type="item", target_entity_id=f"ié{int(i)}",
                  properties=DataMap({"rating": float(r),
                                      "extra": "x,\"y\""}))
            for u, i, r in zip(rng.integers(0, 20, n),
                               rng.integers(0, 9, n),
                               rng.integers(1, 6, n))]


def encode(es_cls, client_cls, root, evs):
    es = es_cls(client_cls(str(root)))
    es.init(1)
    es.insert_batch(evs, 1)
    return es.find_columnar(1, ordered=True)


def rows(batch):
    return [(e.event, e.entity_id, e.target_entity_id,
             e.properties.to_dict()) for e in batch.to_events()]


def test_sidecar_encode_native_python_and_jax_agree(tmp_path, monkeypatch,
                                                    mods):
    evs = events()
    native.reset_lane_counts()
    b_native = encode(SegmentFSEventStore, SegmentFSClient,
                      tmp_path / "native", evs)
    assert native.lane_counts()["parse_segment"] == {"native": 1,
                                                     "python": 0}
    monkeypatch.setattr(native, "_state", {})
    monkeypatch.setenv("PTPU_NO_NATIVE", "1")
    native.reset_lane_counts()
    b_python = encode(SegmentFSEventStore, SegmentFSClient,
                      tmp_path / "python", evs)
    assert native.lane_counts()["parse_segment"] == {"native": 0,
                                                     "python": 1}
    monkeypatch.delenv("PTPU_NO_NATIVE")
    from predictionio_tpu.data.datamap import DataMap as JDataMap
    from predictionio_tpu.data.event import Event as JEvent
    b_jax = encode(JSegmentFSEventStore, JSegmentFSClient, tmp_path / "jax",
                   [JEvent(event=e.event, entity_type=e.entity_type,
                           entity_id=e.entity_id,
                           target_entity_type=e.target_entity_type,
                           target_entity_id=e.target_entity_id,
                           properties=JDataMap(e.properties.to_dict()),
                           event_time=e.event_time, event_id=e.event_id)
                    for e in evs])
    assert b_native.n == b_python.n == b_jax.n == 400
    for b in (b_python, b_jax):
        np.testing.assert_array_equal(b_native.float_prop("rating"),
                                      b.float_prop("rating"))
        assert rows(b_native) == rows(b)


def test_import_lanes_are_counted(tmp_path, monkeypatch, mods):
    f = tmp_path / "ev.jsonl"
    f.write_bytes(api_lines(120))
    es = SegmentFSEventStore(SegmentFSClient(str(tmp_path / "a")))
    es.init(1)
    native.reset_lane_counts()
    assert es.import_jsonl(str(f), 1) == 120
    assert native.lane_counts() == {"import_jsonl": {"native": 1,
                                                     "python": 0}}
    monkeypatch.setattr(native, "_state", {})
    monkeypatch.setenv("PTPU_NO_NATIVE", "1")
    es2 = SegmentFSEventStore(SegmentFSClient(str(tmp_path / "b")))
    es2.init(1)
    native.reset_lane_counts()
    assert es2.import_jsonl(str(f), 1) == 120
    assert native.lane_counts() == {"import_jsonl": {"native": 0,
                                                     "python": 1}}
    strip = [{k: v for k, v in e.to_json().items()
              if k not in ("eventId", "creationTime", "eventTime")}
             for e in es.find(1)]
    assert strip == [{k: v for k, v in e.to_json().items()
                      if k not in ("eventId", "creationTime", "eventTime")}
                     for e in es2.find(1)]


def test_a_failed_build_falls_back_with_a_warning(tmp_path, monkeypatch,
                                                  caplog):
    broken = tmp_path / "_codec.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "_state", {})
    monkeypatch.setattr(_build, "_root", tmp_path / "root")
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        assert native.codec() is None
    assert any("native codec build failed" in r.getMessage()
               and r.levelno == logging.WARNING for r in caplog.records)
    assert not list((tmp_path / "root").rglob("*.so"))
    f = tmp_path / "ev.jsonl"
    f.write_bytes(api_lines(30))
    es = SegmentFSEventStore(SegmentFSClient(str(tmp_path / "s")))
    es.init(1)
    native.reset_lane_counts()
    assert es.import_jsonl(str(f), 1) == 30
    assert native.lane_counts()["import_jsonl"]["python"] == 1
