"""The port's spans and counters (``predictionio_tpu_torch/utils/tracing.py``)
on the training and batch top-k paths, on the CPU.

With no profiler capture a span only records into its histogram; under a
``torch.profiler`` capture (CPU activity only here) it is also a
``ptpu.<name>`` range and a kept record with its parent, and counts are
kept beside the spans. Each test starts from an empty process registry.
"""

import json

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from predictionio_tpu_torch import parallel as ppar
from predictionio_tpu_torch.controller.base import DataSource
from predictionio_tpu_torch.controller.context import Context
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.models import als
from predictionio_tpu_torch.models.convert import als_model_from_numpy
from predictionio_tpu_torch.templates.recommendation import (
    TrainingData,
    recommendation_engine,
)
from predictionio_tpu_torch.utils import tracing

N_USERS, N_ITEMS, RANK, ITERS = 30, 22, 4, 2


def make_ratings():
    """Skewed ratings with a long user and a long item history, so the
    bucketed layout has several length classes and a capped pad layout
    drops entries."""
    rng = np.random.default_rng(7)
    mask = rng.random((N_USERS, N_ITEMS)) < 0.3
    mask[0, :] = True
    mask[:, 1] = True
    u, i = np.nonzero(mask)
    vals = rng.integers(1, 11, len(u)).astype(np.float32) / 2.0
    return als.RatingsCOO(u.astype(np.int32), i.astype(np.int32), vals,
                          N_USERS, N_ITEMS)


RATINGS = make_ratings()


class MemoryDataSource(DataSource):
    def __init__(self, params=None):
        pass

    def read_training(self, ctx):
        return TrainingData(RATINGS,
                            BiMap({f"u{n}": n for n in range(N_USERS)}),
                            BiMap({f"i{n}": n for n in range(N_ITEMS)}))


def train(**algo):
    """One tiny ``Engine.train`` of the recommendation template on the
    CPU: ``(ctx, the algorithm's ALSParams)``."""
    params = {"rank": RANK, "numIterations": ITERS, "lambda": 0.05,
              "seed": 5, **algo}
    engine = recommendation_engine(datasource_classes=MemoryDataSource)
    ep = engine.params_from_variant(
        {"algorithms": [{"name": "als", "params": params}]})
    ctx = Context(device="cpu")
    engine.train(ctx, ep)
    return ctx, ep.algorithms[0][1]


@pytest.fixture(autouse=True)
def empty_registry():
    tracing.spans.reset()
    yield
    tracing.spans.reset()


def capture():
    return profile(activities=[ProfilerActivity.CPU])


def children(kept, parent):
    return [r for r in kept if r.parent == parent.id]


def one(kept, name):
    (rec,) = [r for r in kept if r.name == name]
    return rec


def test_no_capture_keeps_nothing_but_the_histograms_count():
    assert not tracing.capturing()
    train(history_mode="bucket")
    assert tracing.spans.kept() == []
    assert tracing.spans.counted() == {}
    got = tracing.spans.summary()
    for name in ("engine.train", "engine.read", "engine.prepare",
                 "engine.algorithm", "als.train", "als.init",
                 "als.init.draw", "als.init.upload", "als.wait"):
        assert got[name]["count"] == 1, name
    assert got["engine.sanity"]["count"] == 3
    assert got["als.halfstep.user"]["count"] == ITERS
    assert got["als.halfstep.item"]["count"] == ITERS


LAYOUTS = {
    "bucket": dict(history_mode="bucket"),
    "pad": dict(history_mode="pad"),
    "pad_capped": dict(history_mode="pad", max_history=4),
    "split": dict(history_mode="split", max_history=4),
}


def expected_slots(params):
    """``(real, gathered)`` slots of one iteration, from the packed
    tensors (the layouts' own definitions, not the counters' host
    integers)."""
    real = gathered = 0
    for h in als.pack_ratings(RATINGS, params, "cpu"):
        if hasattr(h, "buckets"):
            real += sum(int(b.counts.sum()) for b in h.buckets)
            gathered += h.padded_entries
        elif hasattr(h, "n_virtual"):
            real += int(h.counts.sum())
            gathered += h.n_virtual * h.max_len
        else:
            real += int(h.counts.sum())
            gathered += h.n_rows * h.max_len
    return real, gathered


@pytest.mark.filterwarnings("ignore:history_mode='split'")
@pytest.mark.parametrize("implicit", [False, True],
                         ids=["explicit", "implicit"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_a_captured_training_keeps_the_span_tree_and_slot_counts(
        layout, implicit):
    with capture():
        ctx, params = train(implicitPrefs=implicit, alpha=2.0,
                            **LAYOUTS[layout])
    kept = tracing.spans.kept()
    top = one(kept, "engine.train")
    assert top.parent == -1
    assert [r.name for r in children(kept, top)] == [
        "engine.read", "engine.sanity", "engine.prepare", "engine.sanity",
        "engine.algorithm", "engine.sanity"]
    algo = one(kept, "engine.algorithm")
    assert [r.name for r in children(kept, algo)] == ["als.train",
                                                      "als.wait"]
    train_span = one(kept, "als.train")
    assert [r.name for r in children(kept, train_span)] == \
        ["als.init"] + ["als.halfstep.user", "als.halfstep.item"] * ITERS
    init = one(kept, "als.init")
    assert [r.name for r in children(kept, init)] == ["als.init.draw",
                                                      "als.init.upload"]
    for r in kept:  # a child lies inside its parent
        if r.parent != -1:
            (p,) = [x for x in kept if x.id == r.parent]
            assert p.start <= r.start <= r.end <= p.end
    real, gathered = expected_slots(params)
    assert tracing.spans.counted() == {"als.slots_real": ITERS * real,
                                       "als.slots_padded": ITERS * gathered}
    if layout != "pad_capped":  # the drop-free layouts keep every rating
        assert real == 2 * len(RATINGS.users)
    else:
        assert real < 2 * len(RATINGS.users)
    # every counted slot model agrees with the FLOP model's padded slots
    user_h, item_h = als.pack_ratings(RATINGS, params, "cpu")
    assert sum(als._slots(h)[1] for h in (user_h, item_h)) == gathered


def test_a_batch_of_two_chunks_keeps_two_dispatch_and_resolve_trees(
        monkeypatch):
    rng = np.random.default_rng(3)
    U = rng.standard_normal((N_USERS, RANK)).astype(np.float32)
    V = rng.standard_normal((N_ITEMS, RANK)).astype(np.float32)
    model = als_model_from_numpy(
        U, V, N_USERS, N_ITEMS, {f"u{n}": n for n in range(N_USERS)},
        {f"i{n}": n for n in range(N_ITEMS)}, {"rank": RANK}, device="cpu")
    monkeypatch.setattr(als, "_TOPK_CHUNK", 4)
    with capture():
        ids, _ = als.recommend_batch_async(model, np.arange(7), 3)()
    assert ids.shape == (7, 3)
    kept = tracing.spans.kept()
    dispatch = [r for r in kept if r.name == "topk.dispatch"]
    resolve = [r for r in kept if r.name == "topk.resolve"]
    assert len(dispatch) == len(resolve) == 2
    for d in dispatch:
        assert d.parent == -1
        assert [r.name for r in children(kept, d)] == ["topk.stage",
                                                       "topk.readback"]
    for r in resolve:
        assert [c.name for c in children(kept, r)] == ["topk.wait"]
    assert max(d.end for d in dispatch) <= min(r.start for r in resolve)


def test_the_ring_drops_its_oldest_past_its_bound(monkeypatch):
    monkeypatch.setattr(tracing.SpanRegistry, "RING", 4)
    reg = tracing.SpanRegistry()
    with capture():
        for n in range(6):
            with tracing.timed(f"s{n}", reg):
                pass
            reg.count("c", n)
    assert [r.name for r in reg.kept()] == ["s2", "s3", "s4", "s5"]
    assert reg.counted() == {"c": 2 + 3 + 4 + 5}
    assert reg.dropped == 4
    assert reg.summary()["s0"]["count"] == 1  # the histograms keep all
    reg.reset()
    assert reg.kept() == [] and reg.dropped == 0


def test_the_kept_window_holds_only_whole_spans():
    reg = tracing.SpanRegistry()
    with capture():
        with tracing.timed("a", reg):
            pass
        with tracing.timed("b", reg) as b:
            pass
    (a, kept_b) = reg.kept()
    assert [r.name for r in reg.kept(kept_b.start, kept_b.end)] == ["b"]
    assert reg.kept(a.start, kept_b.start) == [a]
    assert b.seconds == pytest.approx(kept_b.end - kept_b.start)


def test_the_ptpu_ranges_reach_the_exported_chrome_trace(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv(ppar.FORCE_DEVICE_COUNT_ENV, "2")
    mesh = ppar.make_mesh(data=2, model=1,
                          devices=ppar.local_devices("cpu"))
    params = als.ALSParams(rank=RANK, num_iterations=1, seed=2)
    with tracing.trace(str(tmp_path)):
        train(history_mode="bucket")
        als.train_als(RATINGS, params, mesh=mesh)
    (path,) = tmp_path.iterdir()
    events = json.loads(path.read_text())["traceEvents"]
    names = {e["name"] for e in events
             if e.get("cat") == "user_annotation"}
    for name in ("engine.train", "engine.algorithm", "als.train",
                 "als.init", "als.init.draw", "als.halfstep.user",
                 "als.halfstep.item", "als.wait", "all_gather"):
        assert "ptpu." + name in names, name


def test_stage_timings_are_unrounded_stage_seconds():
    ctx, _ = train(history_mode="bucket")
    stages = ctx.stage_timings
    assert set(stages) == {"read_s", "prepare_s", "algo_train_s"}
    # reading and preparing in-memory data take well under the 5 ms that
    # rounding to 10 ms read as 0
    for v in stages.values():
        assert v > 0 and v != round(v, 2)
