"""The e-commerce and similar-product templates on the port, held to
the JAX package on the CPU.

Both packages read the same seeded events (the JAX package's own
template-test streams) and train from the JAX package's initial draw
(``models.als.draw_initial_factors`` patched, as in the eval parity
test), the port on ``device="cpu"`` where every kernel takes its plain
version. Every scenario of the JAX package's template tests runs through
both: the item ids must be equal, in order, and the scores within
``SCORE_RTOL`` (the two packages' f32 training differs only in its order
of sums). Co-occurrence indices and counts must be equal exactly on the
dense path (``AᵀA``, then a top-N under a total order) and on the host
sparse path, ties included. The three new model kinds round-trip through
the model file, whose ``ALSModel`` blobs of earlier releases still load,
and ``cli train`` then ``deploy`` of both shipped ``engine.json`` files
answer over HTTP as the JAX engine's ``predict`` does in-process.
"""

import base64
import json
import urllib.request
from datetime import timedelta
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import predictionio_tpu.data.storage.registry as jregistry
import predictionio_tpu.models.als as jals
import predictionio_tpu.models.cooccurrence as jcooc
import predictionio_tpu.templates.ecommerce as jec
import predictionio_tpu.templates.similarproduct as jsp
from predictionio_tpu.controller.context import Context as JContext
from predictionio_tpu.controller.params import EngineParams as JEngineParams
from predictionio_tpu.data.datamap import DataMap as JDataMap
from predictionio_tpu.data.event import Event as JEvent
from predictionio_tpu.data.storage.base import App as JApp
from predictionio_tpu.data.storage.registry import Storage as JStorage
from predictionio_tpu_torch import cli
from predictionio_tpu_torch.controller.context import Context
from predictionio_tpu_torch.controller.params import EngineParams
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import registry
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.models import als
from predictionio_tpu_torch.models import cooccurrence as pcooc
from predictionio_tpu_torch.models.als import ALSModel, ALSParams
from predictionio_tpu_torch.templates import ecommerce as pec
from predictionio_tpu_torch.templates import similarproduct as psp
from predictionio_tpu_torch.utils.jsonutil import from_jsonable
from predictionio_tpu_torch.workflow.batch_predict import (
    batch_predict_lines,
)
from predictionio_tpu_torch.workflow.persistence import (
    dumps_models,
    loads_models,
)
from test_templates import (
    T0,
    ecommerce_events,
    similarproduct_events,
)

ROOT = Path(__file__).resolve().parents[1]
#: the two packages' factors differ by f32 training noise, not by method
SCORE_RTOL, SCORE_ATOL = 1e-3, 1e-5
MEM_ENV = {"PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"}
J_MEM_ENV = {
    "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
}
_LOCAL = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _jax_draw(seed, n_u, n_u_pad, n_i, n_i_pad, rank):
    """The JAX package's initial draw for these shapes (it depends only
    on the real rows), padded to the port's rows."""
    ku, ki = jax.random.split(jax.random.key(seed))
    out = []
    for key, n, n_pad in ((ku, n_u, n_u_pad), (ki, n_i, n_i_pad)):
        f = torch.zeros((n_pad, rank), dtype=torch.float32)
        f[:n] = torch.from_numpy(np.array(
            jals._init_factors(key, n=n, n_padded=n, rank=rank)))
        out.append(f)
    return tuple(out)


@pytest.fixture(autouse=True)
def jax_draw(monkeypatch):
    monkeypatch.setattr(als, "draw_initial_factors", _jax_draw)


def port_event(e):
    return Event(event=e.event, entity_type=e.entity_type,
                 entity_id=e.entity_id,
                 target_entity_type=e.target_entity_type,
                 target_entity_id=e.target_entity_id,
                 properties=DataMap(e.properties.to_dict()),
                 event_time=e.event_time)


class Pair:
    """The same app and events in a MEMORY store of each package."""

    def __init__(self, app, jax_events):
        self.app = app
        self.store = Storage(env=MEM_ENV)
        self.app_id = self.store.apps().insert(App(0, app))
        self.store.events().init(self.app_id)
        self.store.events().insert_batch(
            [port_event(e) for e in jax_events], self.app_id)
        self.jstore = JStorage(env=J_MEM_ENV)
        self.japp_id = self.jstore.apps().insert(JApp(0, app))
        self.jstore.events().init(self.japp_id)
        self.jstore.events().insert_batch(list(jax_events), self.japp_id)
        self.ctx = Context(device="cpu", app_name=app, _storage=self.store)
        self.jctx = JContext(app_name=app, _storage=self.jstore)

    def insert(self, **kw):
        props = kw.pop("properties", {})
        self.store.events().insert(
            Event(properties=DataMap(props), **kw), self.app_id)
        self.jstore.events().insert(
            JEvent(properties=JDataMap(props), **kw), self.japp_id)


def assert_same(mine, theirs):
    assert [s.item for s in mine.item_scores] == \
        [s.item for s in theirs.item_scores]
    np.testing.assert_allclose([s.score for s in mine.item_scores],
                               [s.score for s in theirs.item_scores],
                               rtol=SCORE_RTOL, atol=SCORE_ATOL)


# -- e-commerce -----------------------------------------------------------------

EC_APP = "ecapp"


def ec_params(pkg, app=EC_APP, **kw):
    return pkg.default_engine_params(app, rank=8, num_iterations=10,
                                     seed=9, **kw)


@pytest.fixture(scope="module")
def ec_models():
    """One training per package (the models do not depend on the
    algorithm's serving params)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(als, "draw_initial_factors", _jax_draw)
    try:
        pair = Pair(EC_APP, ecommerce_events())
        mine = pec.ecommerce_engine().train(pair.ctx, ec_params(pec))
        theirs = jec.ecommerce_engine().train(pair.jctx, ec_params(jec))
    finally:
        mp.undo()
    return mine.models[0], theirs.models[0]


def ec_predict(pair, models, query, bind=True, **params):
    mine, theirs = models
    out = []
    for pkg, ctx, model in ((pec, pair.ctx, mine), (jec, pair.jctx, theirs)):
        ep = ec_params(pkg, **params)
        algo = pkg.ecommerce_engine().make_algorithms(ep)[0]
        if bind:
            algo.bind_serving(ctx)
        out.append(algo.predict(model, pkg.Query(**query)))
    return out


def test_ec_trained_model_is_the_jax_packages(ec_models):
    mine, theirs = ec_models
    assert isinstance(mine.user_factors, np.ndarray)
    for name in ("has_user", "has_item", "popular_count"):
        np.testing.assert_array_equal(getattr(mine, name),
                                      getattr(theirs, name))
    np.testing.assert_allclose(mine.item_factors, theirs.item_factors,
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(mine.user_factors, theirs.user_factors,
                               rtol=2e-3, atol=2e-4)
    assert mine.user_ids.to_dict() == theirs.user_ids.to_dict()
    assert mine.items == {k: pec.Item(v.categories)
                          for k, v in theirs.items.items()}


EC_SCENARIOS = {
    "known_user": (dict(user="u0", num=4), {}),
    "popular_fallback": (dict(user="stranger", num=3), {}),
    "unseen_only": (dict(user="u0", num=6), dict(unseen_only=True)),
    "category_filter": (dict(user="u0", num=6, categories=["c1"]), {}),
    "white_list": (dict(user="u1", num=6, white_list=["i6", "i9", "i2"]),
                   {}),
    "black_list": (dict(user="u1", num=6, black_list=["i7", "i8"]), {}),
}


@pytest.mark.parametrize("name", sorted(EC_SCENARIOS))
def test_ec_scenario(ec_models, name):
    query, params = EC_SCENARIOS[name]
    pair = Pair(EC_APP, ecommerce_events())
    mine, theirs = ec_predict(pair, ec_models, query, **params)
    assert mine.item_scores
    assert_same(mine, theirs)


def test_ec_unknown_user_with_recent_views(ec_models):
    pair = Pair(EC_APP, ecommerce_events())
    pair.insert(event="view", entity_type="user", entity_id="newbie",
                target_entity_type="item", target_entity_id="i7",
                event_time=T0 + timedelta(days=1))
    mine, theirs = ec_predict(pair, ec_models, dict(user="newbie", num=4))
    assert sum(int(s.item[1:]) >= 6 for s in mine.item_scores) >= 2
    assert_same(mine, theirs)


def test_ec_unavailable_items_constraint(ec_models):
    pair = Pair(EC_APP, ecommerce_events())
    pair.insert(event="$set", entity_type="constraint",
                entity_id="unavailableItems", properties={"items": ["i3"]},
                event_time=T0 + timedelta(days=2))
    mine, theirs = ec_predict(pair, ec_models, dict(user="stranger", num=3))
    assert "i3" not in {s.item for s in mine.item_scores}
    assert_same(mine, theirs)


def test_ec_weighted_items_adjust_score(ec_models):
    pair = Pair(EC_APP, ecommerce_events())
    pair.insert(event="$set", entity_type="constraint",
                entity_id="weightedItems",
                properties={"weights": [{"items": ["i7"], "weight": 1000.0},
                                        {"items": ["i1", "i2"],
                                         "weight": 0.5}]},
                event_time=T0 + timedelta(days=4))
    for user in ("stranger", "u0"):
        mine, theirs = ec_predict(pair, ec_models, dict(user=user, num=4))
        assert_same(mine, theirs)
    assert mine.item_scores


def test_ec_weights_vector_is_memoized_until_the_groups_change(ec_models):
    pair = Pair(EC_APP, ecommerce_events())
    model = ec_models[0]
    algo = pec.ecommerce_engine().make_algorithms(ec_params(pec))[0]
    algo.bind_serving(pair.ctx)
    w1 = algo._weights_vector(model, EC_APP)
    assert algo._weights_vector(model, EC_APP) is w1
    pair.insert(event="$set", entity_type="constraint",
                entity_id="weightedItems",
                properties={"weights": [{"items": ["i7"], "weight": 3.0}]},
                event_time=T0 + timedelta(days=4))
    w2 = algo._weights_vector(model, EC_APP)
    assert w2 is not w1 and w2[model.item_ids["i7"]] == 3.0


def test_ec_bind_serving_uses_the_injected_storage(ec_models):
    """A fresh algorithm instance sees the serving storage only through
    ``bind_serving``; with it, ``unseen_only`` drops u0's items."""
    pair = Pair(EC_APP, ecommerce_events())
    mine, theirs = ec_predict(pair, ec_models, dict(user="u0", num=6),
                              unseen_only=True)
    seen = {e.target_entity_id for e in pair.ctx.event_store.find(
        EC_APP, entity_type="user", entity_id="u0",
        event_names=["view", "buy"])}
    assert seen and not ({s.item for s in mine.item_scores} & seen)
    assert_same(mine, theirs)


def test_ec_unbound_instance_degrades_without_a_global_store(ec_models,
                                                             monkeypatch):
    """Never bound, and the process-wide storage lacks the app: the
    filter reads fail softly (logged, empty) and serving still answers,
    unfiltered, in both packages."""
    monkeypatch.setattr(registry, "_global", Storage(env=MEM_ENV))
    monkeypatch.setattr(jregistry, "_global", JStorage(env=J_MEM_ENV))
    pair = Pair(EC_APP, ecommerce_events())
    mine, theirs = ec_predict(pair, ec_models, dict(user="u0", num=6),
                              bind=False, unseen_only=True)
    assert mine.item_scores
    assert_same(mine, theirs)


def test_ec_reads_time_out_to_empty_sets(ec_models):
    """A point read past its deadline degrades to an empty set: the
    answer is the unfiltered one."""
    pair = Pair(EC_APP, ecommerce_events())
    algo = pec.ecommerce_engine().make_algorithms(
        ec_params(pec, unseen_only=True, timeout_ms=-1))[0]
    algo.bind_serving(pair.ctx)
    got = algo.predict(ec_models[0], pec.Query(user="u0", num=6))
    bare = pec.ecommerce_engine().make_algorithms(ec_params(pec))[0]
    bare.bind_serving(pair.ctx)
    assert got == bare.predict(ec_models[0], pec.Query(user="u0", num=6))


def test_ec_params_and_query_keys_map_as_in_the_jax_package():
    wire = {"appName": "a", "unseenOnly": True, "seenEvents": ["buy"],
            "rank": 4, "numIterations": 3, "lambda": 0.25, "seed": 1}
    mine = from_jsonable(pec.ECommAlgorithmParams, wire)
    assert mine.lambda_ == 0.25 and mine.unseen_only and mine.app_name == "a"
    assert mine.seen_events == ["buy"] and mine.num_iterations == 3
    from predictionio_tpu.utils.jsonutil import from_jsonable as jfrom

    theirs = jfrom(jec.ECommAlgorithmParams, wire)
    assert vars(mine) == vars(theirs)
    q = from_jsonable(psp.Query, {"items": ["i1"], "num": 3,
                                  "whiteList": ["i2"], "blackList": ["i3"],
                                  "categoryBlackList": ["c0"],
                                  "categories": ["c1"]})
    assert (q.white_list, q.black_list, q.category_black_list,
            q.categories) == (("i2",), ("i3",), ("c0",), ("c1",))
    variant = json.loads((ROOT / "examples" / "ecommerce" /
                          "engine.json").read_text())
    ep = pec.ecommerce_engine().params_from_variant(variant)
    assert ep.algorithms[0][1].lambda_ == 0.01
    assert ep.algorithms[0][1].unseen_only is True


# -- similar product ------------------------------------------------------------

SP_APP = "spapp"
SP_ALS = dict(rank=8, num_iterations=10, implicit_prefs=True, alpha=1.0,
              seed=5)


def sp_params(pkg, name, params=None):
    if params is None:
        params = (pkg.CooccurrenceParams() if name == "cooccurrence"
                  else (ALSParams if pkg is psp else jals.ALSParams)(
                      **SP_ALS))
    ep_cls = EngineParams if pkg is psp else JEngineParams
    return ep_cls(datasource=("", pkg.DataSourceParams(app_name=SP_APP)),
                  algorithms=[(name, params)])


@pytest.fixture(scope="module")
def sp_models():
    """Each of the three algorithms trained once in each package."""
    mp = pytest.MonkeyPatch()
    mp.setattr(als, "draw_initial_factors", _jax_draw)
    out = {}
    try:
        pair = Pair(SP_APP, similarproduct_events())
        for name in ("als", "cooccurrence", "likealgo"):
            out[name] = (
                psp.similarproduct_engine().train(
                    pair.ctx, sp_params(psp, name)).models[0],
                jsp.similarproduct_engine().train(
                    pair.jctx, sp_params(jsp, name)).models[0])
    finally:
        mp.undo()
    return out


def sp_predict(models, name, query):
    out = []
    for pkg, model in ((psp, models[name][0]), (jsp, models[name][1])):
        algo = pkg.similarproduct_engine().make_algorithms(
            sp_params(pkg, name))[0]
        out.append(algo.predict(model, pkg.Query(**query)))
    return out


SP_QUERIES = {
    "one_item": dict(items=["i0"], num=5),
    "two_items": dict(items=["i1", "i12"], num=6),
    "white_list": dict(items=["i0"], num=10, white_list=["i2", "i4"]),
    "black_list": dict(items=["i0"], num=10, black_list=["i2"]),
    "categories": dict(items=["i0"], num=10, categories=["c1"]),
    "category_black_list": dict(items=["i0"], num=10,
                                category_black_list=["c0"]),
    "unknown_item": dict(items=["nope"], num=3),
}


@pytest.mark.parametrize("query", sorted(SP_QUERIES))
@pytest.mark.parametrize("name", ["als", "cooccurrence", "likealgo"])
def test_sp_scenario(sp_models, name, query):
    mine, theirs = sp_predict(sp_models, name, SP_QUERIES[query])
    assert_same(mine, theirs)
    if query == "one_item" and name != "likealgo":
        assert mine.item_scores
        assert sum(int(s.item[1:]) < 10 for s in mine.item_scores) >= 3


def test_sp_als_model_is_the_jax_packages(sp_models):
    for name in ("als", "likealgo"):
        mine, theirs = sp_models[name]
        np.testing.assert_array_equal(mine.has_factors, theirs.has_factors)
        assert np.isfinite(mine.item_factors).all()
        np.testing.assert_allclose(mine.item_factors, theirs.item_factors,
                                   rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("alpha", [2.0, 40.0])
def test_sp_like_past_alpha_one_is_non_finite_in_both_packages(alpha):
    """A known fault of both packages, kept as it is (ROADMAP.md queue
    3): a dislike (r = -1) has confidence 1 + alpha * r < 0 once alpha >
    1, the system stops being positive definite, and both packages give
    non-finite factors alike."""
    pair = Pair(SP_APP, similarproduct_events())
    kw = dict(SP_ALS, alpha=alpha)
    mine = psp.similarproduct_engine().train(
        pair.ctx, sp_params(psp, "likealgo", ALSParams(**kw))).models[0]
    theirs = jsp.similarproduct_engine().train(
        pair.jctx, sp_params(jsp, "likealgo", jals.ALSParams(**kw))
    ).models[0]
    assert not np.isfinite(mine.item_factors).all()
    assert not np.isfinite(theirs.item_factors).all()


def test_sp_cooccurrence_model_is_the_jax_packages(sp_models):
    (mine, ids, items), (theirs, jids, jitems) = sp_models["cooccurrence"]
    np.testing.assert_array_equal(mine.indices, theirs.indices)
    np.testing.assert_array_equal(mine.counts, theirs.counts)
    assert mine.counts.dtype == theirs.counts.dtype
    assert ids.to_dict() == jids.to_dict()


@pytest.mark.parametrize("num", [1, 3, 10])
def test_sp_engine_serves_as_the_jax_packages(sp_models, num):
    """The shipped three-algorithm combination through the z-score
    serving (which skips standardizing at num == 1)."""
    out = []
    for pkg, k in ((psp, 0), (jsp, 1)):
        engine = pkg.similarproduct_engine()
        ep_cls = EngineParams if pkg is psp else JEngineParams
        ep = ep_cls(
            datasource=("", pkg.DataSourceParams(app_name=SP_APP)),
            algorithms=[(n, sp_params(pkg, n).algorithms[0][1])
                        for n in ("als", "cooccurrence", "likealgo")])
        query = pkg.Query(items=["i3"], num=num)
        algos = engine.make_algorithms(ep)
        preds = [a.predict(sp_models[n][k], query)
                 for a, n in zip(algos, ("als", "cooccurrence", "likealgo"))]
        out.append(engine.make_serving(ep).serve(query, preds))
    assert out[0].item_scores
    assert_same(*out)


def test_sp_serving_standardizes_as_the_jax_package():
    def run(pkg):
        a = pkg.PredictedResult((pkg.ItemScore("i1", 100.0),
                                 pkg.ItemScore("i2", 50.0)))
        b = pkg.PredictedResult((pkg.ItemScore("i1", 0.9),
                                 pkg.ItemScore("i3", 0.1)))
        c = pkg.PredictedResult((pkg.ItemScore("i4", 2.0),))
        return pkg.SimilarProductServing().serve(
            pkg.Query(items=["i9"], num=3), [a, b, c])

    mine, theirs = run(psp), run(jsp)
    assert_same(mine, theirs)
    assert mine.item_scores[0].score == pytest.approx(2 * 0.7071067,
                                                      rel=1e-4)


# -- co-occurrence ---------------------------------------------------------------

def views(seed, n_users=40, n_items=30, n=400):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_users, n), rng.integers(0, n_items, n),
            n_users, n_items)


@pytest.mark.parametrize("path", ["dense", "sparse"])
@pytest.mark.parametrize("seed,top_n", [(0, 5), (1, 20), (2, 40), (3, 1)])
def test_cooccurrence_is_the_jax_packages(monkeypatch, path, seed, top_n):
    """Counts are small integers, so ties are the rule: indices and
    counts must be equal exactly, ties in ascending item order."""
    if path == "sparse":
        monkeypatch.setattr(pcooc, "_DENSE_CELL_LIMIT", 0)
        monkeypatch.setattr(jcooc, "_DENSE_CELL_LIMIT", 0)
    u, i, nu, ni = views(seed)
    mine = pcooc.train_cooccurrence(u, i, nu, ni, top_n, device="cpu")
    theirs = jcooc.train_cooccurrence(u, i, nu, ni, top_n)
    np.testing.assert_array_equal(mine.indices, theirs.indices)
    np.testing.assert_array_equal(mine.counts, theirs.counts)
    assert mine.indices.dtype == theirs.indices.dtype
    assert mine.counts.dtype == theirs.counts.dtype
    assert (mine.n, mine.n_items) == (theirs.n, theirs.n_items)
    want_idx, want_counts = numpy_topn(u, i, nu, ni, mine.indices.shape[1])
    np.testing.assert_array_equal(mine.indices, want_idx)
    np.testing.assert_array_equal(mine.counts, want_counts)
    if top_n > 1:  # ties inside the lists, broken by the lower index
        rows = mine.counts[:, :-1] - mine.counts[:, 1:]
        tie = (rows == 0) & (mine.indices[:, 1:] >= 0)
        assert tie.any()


def numpy_topn(u, i, nu, ni, k):
    """Each item's top ``k`` by (-count, index) from a numpy count of the
    distinct (user, item) pairs; pads -1 with count 0."""
    A = np.zeros((nu, ni), np.int64)
    A[u, i] = 1
    C = A.T @ A
    np.fill_diagonal(C, 0)
    idx = np.full((ni, k), -1, np.int32)
    counts = np.zeros((ni, k), np.float32)
    for a in range(ni):
        order = np.lexsort((np.arange(ni), -C[a]))[:k]
        keep = order[C[a, order] > 0]
        idx[a, :len(keep)] = keep
        counts[a, :len(keep)] = C[a, keep]
    return idx, counts


def test_cooccurrence_dense_equals_sparse(monkeypatch):
    u, i, nu, ni = views(7)
    dense = pcooc.train_cooccurrence(u, i, nu, ni, ni - 1, device="cpu")
    monkeypatch.setattr(pcooc, "_DENSE_CELL_LIMIT", 0)
    sparse = pcooc.train_cooccurrence(u, i, nu, ni, ni - 1, device="cpu")
    np.testing.assert_array_equal(dense.indices, sparse.indices)
    np.testing.assert_array_equal(dense.counts, sparse.counts)


def test_cooccurrence_counts_are_pair_counts():
    u, i, nu, ni = views(9)
    model = pcooc.train_cooccurrence(u, i, nu, ni, ni, device="cpu")
    A = np.zeros((nu, ni), np.int64)
    A[u, i] = 1
    C = A.T @ A
    np.fill_diagonal(C, 0)
    for a in range(ni):
        for j, c in model.neighbors(a):
            assert C[a, j] == c and c > 0
        assert len(model.neighbors(a)) == int((C[a] > 0).sum())


# -- the model file ----------------------------------------------------------------

#: an ``ALSModel`` blob as the port's model file wrote it before the
#: template kinds were added (rank 2, 3 users, 2 items, seed 7)
OLD_ALS_BLOB = (
    "UEsDBC0AAAAAAAAAIQCJv5wz//////////8PABQAMC51c2VyLmRhdGEubnB5AQAQAJgAAAAA"
    "AAAAmAAAAAAAAACTTlVNUFkBAHYAeydkZXNjcic6ICc8ZjQnLCAnZm9ydHJhbl9vcmRlcic6"
    "IEZhbHNlLCAnc2hhcGUnOiAoMywgMiksIH0gICAgICAgICAgICAgICAgICAgICAgICAgICAg"
    "ICAgICAgICAgICAgICAgICAgICAgICAgICAgICAgCgAAAAAAAIA+AAAAPwAAQD8AAIA/AACg"
    "P1BLAwQtAAAAAAAAACEAVC/mUP//////////DwAUADAuaXRlbS5kYXRhLm5weQEAEACQAAAA"
    "AAAAAJAAAAAAAAAAk05VTVBZAQB2AHsnZGVzY3InOiAnPGY0JywgJ2ZvcnRyYW5fb3JkZXIn"
    "OiBGYWxzZSwgJ3NoYXBlJzogKDIsIDIpLCB9ICAgICAgICAgICAgICAgICAgICAgICAgICAg"
    "ICAgICAgICAgICAgICAgICAgICAgICAgICAgICAgIAoAAIA/AAAAvwAAgD4AAABAUEsDBC0A"
    "AAAAAAAAIQCD9uNk//////////8IABQAbWV0YS5ucHkBABAA3QIAAAAAAADdAgAAAAAAAJNO"
    "VU1QWQEAdgB7J2Rlc2NyJzogJ3x1MScsICdmb3J0cmFuX29yZGVyJzogRmFsc2UsICdzaGFw"
    "ZSc6ICg2MDUsKSwgfSAgICAgICAgICAgICAgICAgICAgICAgICAgICAgICAgICAgICAgICAg"
    "ICAgICAgICAgICAgICAgICAKeyJmb3JtYXQiOiAicHJlZGljdGlvbmlvX3RwdV90b3JjaC5t"
    "b2RlbHMvMSIsICJtb2RlbHMiOiBbeyJraW5kIjogIkFMU01vZGVsIiwgIm5fdXNlcnMiOiAz"
    "LCAibl9pdGVtcyI6IDIsICJwYXJhbXMiOiB7InJhbmsiOiAyLCAibnVtX2l0ZXJhdGlvbnMi"
    "OiAzLCAicmVnIjogMC4wMSwgImFscGhhIjogMS4wLCAiaW1wbGljaXRfcHJlZnMiOiBmYWxz"
    "ZSwgInNlZWQiOiA3LCAibWF4X2hpc3RvcnkiOiBudWxsLCAic2NhbGVfcmVnX2J5X2NvdW50"
    "IjogdHJ1ZSwgImJsb2NrX3Jvd3MiOiBudWxsLCAibWF0bXVsX2R0eXBlIjogImZsb2F0MzIi"
    "LCAiZ2F0aGVyX2R0eXBlIjogImZsb2F0MzIiLCAiZ3JhbV9tb2RlIjogImF1dG8iLCAiaGlz"
    "dG9yeV9tb2RlIjogImF1dG8ifSwgInVzZXJfaWRzIjogW1sidTAiLCAwXSwgWyJ1MSIsIDFd"
    "LCBbInUyIiwgMl1dLCAiaXRlbV9pZHMiOiBbWyJpMCIsIDBdLCBbImkxIiwgMV1dLCAidXNl"
    "cl9mYWN0b3JzIjogeyJxdWFudCI6ICJvZmYiLCAiZHR5cGUiOiAiZmxvYXQzMiIsICJzY2Fs"
    "ZSI6IGZhbHNlfSwgIml0ZW1fZmFjdG9ycyI6IHsicXVhbnQiOiAib2ZmIiwgImR0eXBlIjog"
    "ImZsb2F0MzIiLCAic2NhbGUiOiBmYWxzZX19XX1QSwECLQMtAAAAAAAAACEAib+cM5gAAACY"
    "AAAADwAAAAAAAAAAAAAAgAEAAAAAMC51c2VyLmRhdGEubnB5UEsBAi0DLQAAAAAAAAAhAFQv"
    "5lCQAAAAkAAAAA8AAAAAAAAAAAAAAIAB2QAAADAuaXRlbS5kYXRhLm5weVBLAQItAy0AAAAA"
    "AAAAIQCD9uNk3QIAAN0CAAAIAAAAAAAAAAAAAACAAaoBAABtZXRhLm5weVBLBQYAAAAAAwAD"
    "ALAAAADBBAAAAAA="
)


def test_an_earlier_als_blob_still_loads():
    (m,) = loads_models(base64.b64decode(OLD_ALS_BLOB))
    assert isinstance(m, ALSModel)
    assert torch.equal(m.user_factors,
                       torch.arange(6, dtype=torch.float32).reshape(3, 2) / 4)
    assert torch.equal(m.item_factors,
                       torch.tensor([[1.0, -0.5], [0.25, 2.0]]))
    assert m.user_ids.to_dict() == {"u0": 0, "u1": 1, "u2": 2}
    assert m.params == ALSParams(rank=2, num_iterations=3, seed=7)


def _same_items(a, b):
    assert {k: v.categories for k, v in a.items()} == \
        {k: v.categories for k, v in b.items()}


def test_ecomm_model_round_trips(ec_models):
    model = ec_models[0]
    (back,) = loads_models(dumps_models([model]))
    assert isinstance(back, pec.ECommModel)
    for name in ("user_factors", "has_user", "item_factors", "has_item",
                 "popular_count"):
        got, want = getattr(back, name), getattr(model, name)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert (back.app_name, back.rank) == (model.app_name, model.rank)
    assert back.user_ids.to_dict() == model.user_ids.to_dict()
    assert back.item_ids.to_dict() == model.item_ids.to_dict()
    _same_items(back.items, model.items)
    assert all(isinstance(v, pec.Item) for v in back.items.values())


def test_sp_models_round_trip_in_one_blob(sp_models):
    models = [sp_models[n][0] for n in ("als", "cooccurrence", "likealgo")]
    back = loads_models(dumps_models(models))
    for got, want in ((back[0], models[0]), (back[2], models[2])):
        assert isinstance(got, psp.SPModel)
        np.testing.assert_array_equal(got.item_factors, want.item_factors)
        np.testing.assert_array_equal(got.has_factors, want.has_factors)
        assert got.item_ids.to_dict() == want.item_ids.to_dict()
        _same_items(got.items, want.items)
    (cooc, ids, items), (wcooc, wids, witems) = back[1], models[1]
    assert isinstance(cooc, pcooc.CooccurrenceModel)
    np.testing.assert_array_equal(cooc.indices, wcooc.indices)
    np.testing.assert_array_equal(cooc.counts, wcooc.counts)
    assert (cooc.n, cooc.n_items) == (wcooc.n, wcooc.n_items)
    assert ids.to_dict() == wids.to_dict()
    _same_items(items, witems)
    q = psp.Query(items=["i0"], num=5)
    algo = psp.SPCooccurrenceAlgorithm()
    assert algo.predict(back[1], q) == algo.predict(models[1], q)


def test_an_unknown_model_kind_is_refused():
    with pytest.raises(TypeError, match="no model kind is registered"):
        dumps_models([{"not": "a model"}])


# -- batch prediction binds the job's storage ---------------------------------------

def test_batch_predict_binds_the_context(ec_models):
    """With the job's context, ``unseen_only`` reads u0's history from
    it; without one, the reads fail softly and nothing is dropped."""
    pair = Pair(EC_APP, ecommerce_events())
    engine = pec.ecommerce_engine()
    ep = ec_params(pec, unseen_only=True)
    line = json.dumps({"user": "u0", "num": 12})
    (bound,) = batch_predict_lines(engine, ep, [ec_models[0]], [line],
                                   device="cpu", ctx=pair.ctx)
    got = {s["item"] for s in json.loads(bound)["prediction"]["itemScores"]}
    seen = {e.target_entity_id for e in pair.ctx.event_store.find(
        EC_APP, entity_type="user", entity_id="u0",
        event_names=["view", "buy"])}
    assert got and not got & seen
    want = ec_predict(pair, ec_models, dict(user="u0", num=12),
                      unseen_only=True)[0]
    assert [s["item"] for s in json.loads(bound)["prediction"][
        "itemScores"]] == [s.item for s in want.item_scores]


# -- cli train and deploy of the shipped variants ------------------------------------

def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/queries.json",
                                 data=json.dumps(body).encode(),
                                 method="POST")
    with _LOCAL.open(req, timeout=60) as resp:
        return json.loads(resp.read())


def _shipped(name):
    path = ROOT / "examples" / name / "engine.json"
    return path, json.loads(path.read_text())


@pytest.fixture
def homes(tmp_path, monkeypatch):
    """A SQLite ``PIO_HOME`` for the port's CLI and the JAX package over
    the same file; the process-wide storage of both is an empty MEMORY
    store, so a read that missed the deploy's storage would show."""
    monkeypatch.setattr(registry, "_global", Storage(env=MEM_ENV))
    monkeypatch.setattr(jregistry, "_global", JStorage(env=J_MEM_ENV))
    home = str(tmp_path / "home")
    st = Storage(env={"PIO_HOME": home})
    yield st, home
    st.close()


def _seed_app(st, app, jax_events):
    assert cli.main(["app", "new", app], storage=st) == 0
    app_id = st.apps().get_by_name(app).id
    st.events().insert_batch([port_event(e) for e in jax_events], app_id)
    return app_id


def _deploy(st, engine_json):
    args = cli._parser().parse_args([
        "deploy", "--engine-json", str(engine_json), "--device", "cpu",
        "--ip", "127.0.0.1", "--port", "0"])
    return cli.build_deploy(args, st).start_background()


def _jax_train(home, jpkg, factory, variant):
    jst = JStorage(env={"PIO_HOME": home})
    jctx = JContext(_storage=jst)
    engine = getattr(jpkg, factory)()
    ep = engine.params_from_variant(variant)
    models = engine.train(jctx, ep).models
    algos = engine.make_algorithms(ep)
    for a in algos:
        a.bind_serving(jctx)
    return jst, engine, ep, models, algos


def _as_result(pkg, answer):
    return pkg.PredictedResult(tuple(
        pkg.ItemScore(s["item"], s["score"]) for s in answer["itemScores"]))


def test_cli_train_and_deploy_the_shipped_ecommerce_variant(homes, capsys):
    st, home = homes
    path, variant = _shipped("ecommerce")
    app = variant["datasource"]["params"]["app_name"]
    app_id = _seed_app(st, app, ecommerce_events())
    assert cli.main(["train", "--engine-json", str(path), "--device", "cpu"],
                    storage=st) == 0
    assert "Training completed" in capsys.readouterr().out
    # a view after training: the recent-views path reads it at serving
    st.events().insert(Event(
        event="view", entity_type="user", entity_id="newbie",
        target_entity_type="item", target_entity_id="i7",
        event_time=T0 + timedelta(days=1)), app_id)
    jst, engine, ep, models, algos = _jax_train(
        home, jec, "ecommerce_engine", variant)
    queries = [{"user": "u0", "num": 4}, {"user": "u3", "num": 8},
               {"user": "newbie", "num": 4}, {"user": "stranger", "num": 3},
               {"user": "u2", "num": 6, "categories": ["c1"]},
               {"user": "u5", "num": 6, "whiteList": ["i6", "i7", "i1"]},
               {"user": "u4", "num": 5, "blackList": ["i1"]}]
    srv = _deploy(st, path)
    try:
        (bound,) = srv.query_server.models
        assert isinstance(bound, pec.ECommModel)
        for q in queries:
            got = _post(srv.port, q)
            jq = from_jsonable(jec.Query, q)
            want = algos[0].predict(models[0], jq)
            assert got["itemScores"], q
            assert_same(_as_result(pec, got), want)
        seen = {e.target_entity_id for e in st.events().find(app_id)
                if e.entity_id == "u0"}
        assert not {s["item"] for s in _post(
            srv.port, {"user": "u0", "num": 12})["itemScores"]} & seen
    finally:
        srv.close()
        jst.close()


def test_cli_train_and_deploy_the_shipped_similarproduct_variant(homes,
                                                                 capsys):
    st, home = homes
    path, variant = _shipped("similarproduct")
    app = variant["datasource"]["params"]["app_name"]
    _seed_app(st, app, similarproduct_events())
    assert cli.main(["train", "--engine-json", str(path), "--device", "cpu"],
                    storage=st) == 0
    assert "Training completed" in capsys.readouterr().out
    jst, engine, ep, models, algos = _jax_train(
        home, jsp, "similarproduct_engine", variant)
    serving = engine.make_serving(ep)
    queries = [{"items": ["i0"], "num": 5}, {"items": ["i11"], "num": 1},
               {"items": ["i1", "i14"], "num": 8},
               {"items": ["i2"], "num": 6, "categories": ["c0"]},
               {"items": ["i3"], "num": 6, "blackList": ["i4", "i5"]},
               {"items": ["i15"], "num": 6, "categoryBlackList": ["c0"]}]
    srv = _deploy(st, path)
    try:
        kinds = [type(m).__name__ for m in srv.query_server.models]
        assert kinds == ["SPModel", "SPCooccurrenceModel", "SPModel"]
        status = json.loads(_LOCAL.open(
            f"http://127.0.0.1:{srv.port}/status.json", timeout=60).read())
        assert status["servingQuant"] == "off"
        for q in queries:
            got = _post(srv.port, q)
            jq = from_jsonable(jsp.Query, q)
            want = serving.serve(jq, [a.predict(m, jq)
                                      for a, m in zip(algos, models)])
            assert got["itemScores"], q
            assert_same(_as_result(psp, got), want)
    finally:
        srv.close()
        jst.close()
