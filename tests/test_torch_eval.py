"""``pio eval`` on the port, held to the JAX package on the CPU.

Folds, fold reads, queries and actuals must be equal exactly; every
metric and the evaluator's result text too. The whole ``run_evaluation``
of the recommendation engine, both packages reading one SQLite store and
training from the JAX package's initial draw, gives every score within
1e-3 absolute of the JAX package's and the same best index; a query's
items are equal wherever the JAX package's own scores leave no near-tie
(1e-2) at the list's cut, and in the same order where no two neighbours
inside the list are a near-tie. The port's parallel grid walk gives the
serial walk's scores bit for bit, packing each fold and training each
(fold, algorithm params) pair once.
"""

import dataclasses
import json
import math
import sys
import threading
from datetime import datetime, timedelta, timezone

import jax
import numpy as np
import pytest
import torch

import predictionio_tpu.controller as jctl
import predictionio_tpu.controller.evaluation as jevaluation
import predictionio_tpu.controller.fast_eval as jfast
import predictionio_tpu.models.als as jals
import predictionio_tpu.models.data as jdata
import predictionio_tpu.templates.recommendation as jrec
import predictionio_tpu.workflow.core as jwf
from predictionio_tpu.controller.context import Context as JContext
from predictionio_tpu.data.storage.base import (
    STATUS_EVALCOMPLETED as J_EVALCOMPLETED,
)
from predictionio_tpu.data.storage.registry import Storage as JStorage
from predictionio_tpu_torch import cli
from predictionio_tpu_torch import controller as pctl
from predictionio_tpu_torch.controller import evaluation as pevaluation
from predictionio_tpu_torch.controller import fast_eval as pfast
from predictionio_tpu_torch.controller.context import Context
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.base import (
    STATUS_EVALCOMPLETED,
    STATUS_INIT,
    App,
    EvaluationInstance,
)
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.models import als
from predictionio_tpu_torch.models import data as pdata
from predictionio_tpu_torch.ops import fused_gram, fused_topk, gram, solve
from predictionio_tpu_torch.ops.launches import count_launch
from predictionio_tpu_torch.templates import recommendation as prec
from predictionio_tpu_torch.utils.memo import ComputeOnce
from predictionio_tpu_torch.workflow import core as pwf

APP = "evapp"
N_USERS, N_ITEMS = 30, 24
T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
MEM_ENV = {"PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"}
#: scores of the two packages' models differ by f32 training noise
#: (factors within rtol 2e-3, atol 2e-4); ranks closer than this are a
#: near-tie that either package may order its own way
NEAR_TIE = 1e-2


def rating_events(seed=0, n=360):
    """``n`` ``rate`` events on half-star values; every user rates at
    least 5 items, some items twice (duplicates are kept)."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        u = k % N_USERS if k < 5 * N_USERS else int(rng.integers(N_USERS))
        out.append(Event(
            event="rate", entity_type="user", entity_id=f"u{u}",
            target_entity_type="item",
            target_entity_id=f"i{int(rng.integers(N_ITEMS))}",
            properties={"rating": float(rng.integers(1, 11)) / 2},
            event_time=T0 + timedelta(seconds=k)))
    return out


def seed_store(storage, app=APP, seed=0, n=360):
    app_id = storage.apps().insert(App(id=0, name=app))
    storage.events().init(app_id)
    storage.events().insert_batch(rating_events(seed, n), app_id)
    return app_id


@pytest.fixture()
def sqlite_home(tmp_path):
    """One SQLite store written by the port, opened by both packages."""
    home = str(tmp_path / "home")
    store = Storage(env={"PIO_HOME": home})
    seed_store(store)
    jstore = JStorage(env={"PIO_HOME": home})
    yield store, jstore
    jstore.close()
    store.close()


# -- folds --------------------------------------------------------------------

@pytest.mark.parametrize("n,k,seed", [(0, 2, 0), (1, 3, 1), (97, 2, 3),
                                      (1000, 3, 3), (4096, 5, 11),
                                      (12345, 10, 0)])
def test_kfold_split_is_the_jax_packages(n, k, seed):
    mine = pdata.kfold_split(n, k, seed)
    theirs = jdata.kfold_split(n, k, seed)
    assert len(mine) == len(theirs) == k
    for (tr, te), (jtr, jte) in zip(mine, theirs):
        assert tr.dtype == jtr.dtype == np.bool_
        np.testing.assert_array_equal(tr, jtr)
        np.testing.assert_array_equal(te, jte)
        np.testing.assert_array_equal(tr, ~te)
    if n:
        assert np.sum([te for _, te in mine], axis=0).tolist() == [1] * n


# -- read_eval ------------------------------------------------------------------

def _qa_rows(qa):
    return [((q.user, q.num, q.black_list), a.ratings) for q, a in qa]


@pytest.mark.parametrize("eval_k,query_num,threshold",
                         [(2, 10, 2.0), (3, 4, 3.5)])
def test_read_eval_is_the_jax_packages(sqlite_home, eval_k, query_num,
                                       threshold):
    store, jstore = sqlite_home
    kw = dict(app_name=APP, eval_k=eval_k, eval_query_num=query_num,
              eval_rating_threshold=threshold)
    mine = prec.RecommendationDataSource(prec.DataSourceParams(
        **kw)).read_eval(Context(device="cpu", _storage=store))
    theirs = jrec.RecommendationDataSource(jrec.DataSourceParams(
        **kw)).read_eval(JContext(_storage=jstore))
    assert len(mine) == len(theirs) == eval_k
    held_out = 0
    for (td, ei, qa), (jtd, jei, jqa) in zip(mine, theirs):
        for f in ("users", "items", "ratings"):
            got, want = getattr(td.ratings, f), getattr(jtd.ratings, f)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        assert (td.ratings.n_users, td.ratings.n_items) == \
            (jtd.ratings.n_users, jtd.ratings.n_items)
        assert td.user_ids.to_dict() == jtd.user_ids.to_dict()
        assert td.item_ids.to_dict() == jtd.item_ids.to_dict()
        assert dataclasses.astuple(ei) == dataclasses.astuple(jei)
        assert _qa_rows(qa) == _qa_rows(jqa)
        assert all(q.num == query_num for q, _ in qa)
        held_out += sum(len(a.ratings) for _, a in qa)
    assert held_out == len(rating_events())


def test_read_eval_needs_two_folds():
    ds = prec.RecommendationDataSource(prec.DataSourceParams(app_name=APP))
    with pytest.raises(ValueError, match="eval_k"):
        ds.read_eval(Context(device="cpu"))


# -- metrics ----------------------------------------------------------------------

def _metric_pair(kind):
    """The same test metric subclassed from each package's base."""
    def make(mod):
        if kind == "q_minus_a":
            class M(mod.AverageMetric):
                def calculate_point(self, ei, q, p, a):
                    return q - (a or 0)
        elif kind == "option":
            class M(mod.OptionAverageMetric):
                def calculate_point(self, ei, q, p, a):
                    return None if a is None else float(q)
        elif kind == "stdev":
            class M(mod.StdevMetric):
                def calculate_point(self, ei, q, p, a):
                    return q
        elif kind == "option_stdev":
            class M(mod.OptionStdevMetric):
                def calculate_point(self, ei, q, p, a):
                    return None if a is None else q
        elif kind == "sum":
            class M(mod.SumMetric):
                def calculate_point(self, ei, q, p, a):
                    return q
        else:
            M = mod.ZeroMetric
        return M()
    return make(pctl), make(jctl)


def _folds(*points_per_fold):
    return [(None, pts) for pts in points_per_fold]


EVAL_DATA = {
    "multi_fold": _folds([(4, 0, 1), (2, 0, 1)], [(9, 0, 3)]),
    "with_none": _folds([(4, 0, 1), (2, 0, None), (6, 0, 1)]),
    "all_none": _folds([(4, 0, None)]),
    "empty": _folds([]),
    "no_folds": [],
    "classic": _folds([(2, 0, 0), (4, 0, 0), (4, 0, 0), (4, 0, 0),
                       (5, 0, 0), (5, 0, 0), (7, 0, 0), (9, 0, 0)]),
}


@pytest.mark.parametrize("data", sorted(EVAL_DATA))
@pytest.mark.parametrize("kind", ["q_minus_a", "option", "stdev",
                                  "option_stdev", "sum", "zero"])
def test_metric_aggregation_is_the_jax_packages(kind, data):
    mine, theirs = _metric_pair(kind)
    got = mine.calculate(EVAL_DATA[data])
    want = theirs.calculate(EVAL_DATA[data])
    assert type(got) is type(want) is float
    assert got == want or (math.isnan(got) and math.isnan(want))
    assert mine.header == theirs.header
    for a, b in ((2.0, 1.0), (1.0, 2.0), (1.0, 1.0)):
        assert mine.compare(a, b) == theirs.compare(a, b)


RANKING_CASES = [
    (["a", "b", "c"], {"a", "c"}, 2),
    (["a", "b"], {"a"}, 3),
    (["a"], set(), 3),
    (["x", "a"], {"a"}, 2),
    (["a", "b"], {"a", "b"}, 2),
    ([], {"a"}, 5),
    (["c", "b", "a", "d"], {"a", "b", "e", "f", "g"}, 3),
    (["x"], {"a"}, 0),
]


@pytest.mark.parametrize("case", range(len(RANKING_CASES)))
def test_ranking_helpers_are_the_jax_packages(case):
    predicted, relevant, k = RANKING_CASES[case]
    for name in ("precision_at_k", "ndcg_at_k"):
        mine = getattr(pctl, name)
        theirs = getattr(jctl, name)
        if k == 0 and name == "precision_at_k":
            with pytest.raises(ZeroDivisionError):
                theirs(predicted, relevant, k)
            with pytest.raises(ZeroDivisionError):
                mine(predicted, relevant, k)
            continue
        assert mine(predicted, relevant, k) == theirs(predicted, relevant, k)


def _template_eval_data(mod, seed):
    """Recommendation eval data with each package's own classes: ten
    queries of five answered items, actuals on half-star ratings, one
    query with no actual above any threshold and one empty answer."""
    rng = np.random.default_rng(seed)
    items = [f"i{j}" for j in range(12)]
    folds = []
    for f in range(2):
        pts = []
        for q in range(5):
            answer = rng.choice(items, 5, replace=False).tolist()
            if f == 1 and q == 4:
                answer = []
            actual = [(it, float(rng.integers(1, 11)) / 2)
                      for it in rng.choice(items, 4, replace=False)]
            if f == 0 and q == 0:
                actual = [(it, 0.5) for it, _ in actual]
            pts.append((
                mod.Query(user=f"u{q}", num=5),
                mod.PredictedResult(tuple(
                    mod.ItemScore(item=it, score=float(5 - r))
                    for r, it in enumerate(answer))),
                mod.ActualResult(tuple(actual))))
        folds.append((mod.EvalInfo(fold=f, rating_threshold=2.0), pts))
    return folds


@pytest.mark.parametrize("make", [
    lambda m: m.PrecisionAtK(k=10, rating_threshold=4.0),
    lambda m: m.PrecisionAtK(k=1, rating_threshold=0.0),
    lambda m: m.PrecisionAtK(k=3, rating_threshold=2.0),
    lambda m: m.NDCGAtK(k=10, rating_threshold=2.0),
    lambda m: m.NDCGAtK(k=2, rating_threshold=4.5),
    lambda m: m.PositiveCount(rating_threshold=2.0),
    lambda m: m.PositiveCount(rating_threshold=5.5),
], ids=["p10@4", "p1@0", "p3@2", "ndcg10@2", "ndcg2@4.5", "pos@2",
        "pos@5.5"])
@pytest.mark.parametrize("seed", [0, 1])
def test_template_metrics_are_the_jax_packages(make, seed):
    mine, theirs = make(prec), make(jrec)
    assert mine.header == theirs.header
    got = mine.calculate(_template_eval_data(prec, seed))
    want = theirs.calculate(_template_eval_data(jrec, seed))
    assert got == want or (math.isnan(got) and math.isnan(want))


# -- result text --------------------------------------------------------------------

def _grid(mod_rec, mod_als, mod_params):
    return [mod_params.EngineParams(
        datasource=("", mod_rec.DataSourceParams(app_name=APP, eval_k=3)),
        algorithms=[("als", mod_als.ALSParams(rank=r, num_iterations=it,
                                              reg=0.01, seed=3))])
        for r in (4, 8) for it in (2, 5)]


def _result(mod_eval, grid, scores):
    rows = [mod_eval.MetricScores(
        engine_params=ep, score=s, other_scores=[s / 2, float(i)],
        train_s=0.25 * i, eval_s=1.5 + i)
        for i, (ep, s) in enumerate(zip(grid, scores))]
    best = int(np.argmax(scores))
    return mod_eval.MetricEvaluatorResult(
        best_score=scores[best], best_engine_params=grid[best],
        best_index=best, metric_header="Precision@10 (threshold=4.0)",
        other_metric_headers=["NDCG@10 (threshold=2.0)", "PositiveCount"],
        scores=rows)


@pytest.mark.parametrize("scores", [[0.1, 0.25, 0.125, 1 / 3],
                                    [0.0, 0.0, 0.0, 0.0],
                                    [float("nan"), 0.5, 0.2, 0.1]])
def test_result_text_is_the_jax_packages(scores):
    import predictionio_tpu.controller.params as jparams

    from predictionio_tpu_torch.controller import params as pparams

    mine = _result(pevaluation, _grid(prec, als, pparams), scores)
    theirs = _result(jevaluation, _grid(jrec, jals, jparams), scores)
    assert mine.to_one_liner() == theirs.to_one_liner()
    assert mine.to_json() == theirs.to_json()
    assert mine.to_html() == theirs.to_html()
    assert mine.best_engine_params.to_json() == \
        theirs.best_engine_params.to_json()
    ep = mine.best_engine_params
    assert ep.copy(serving=("x", None)).serving == ("x", None)
    assert ep.copy().to_json() == ep.to_json()


def test_save_best_variant_json_is_the_jax_packages(tmp_path):
    import predictionio_tpu.controller.params as jparams

    from predictionio_tpu_torch.controller import params as pparams

    scores = [0.1, 0.4, 0.2, 0.3]
    base = {"id": "reco", "engineFactory": "x:y"}
    pevaluation.save_best_variant_json(
        _result(pevaluation, _grid(prec, als, pparams), scores),
        str(tmp_path / "mine.json"), base)
    jevaluation.save_best_variant_json(
        _result(jevaluation, _grid(jrec, jals, jparams), scores),
        str(tmp_path / "theirs.json"), base)
    mine = (tmp_path / "mine.json").read_text()
    assert mine == (tmp_path / "theirs.json").read_text()
    variant = json.loads(mine)
    assert variant["id"] == "reco"
    assert variant["algorithms"][0]["params"]["rank"] == 4
    assert variant["algorithms"][0]["params"]["num_iterations"] == 5
    engine, ep = cli.engine_from_variant(variant | {
        "engineFactory": cli.DEFAULT_FACTORY})
    assert ep.algorithms[0][1] == als.ALSParams(rank=4, num_iterations=5,
                                                reg=0.01, seed=3)


# -- the slice as a whole -------------------------------------------------------------

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


SLICE_GRID = [dict(rank=4, num_iterations=4, reg=0.3, seed=3),
              dict(rank=8, num_iterations=6, reg=0.01, seed=3)]


def _slice_grid(mod_rec, mod_als, mod_params):
    return [mod_params.EngineParams(
        datasource=("", mod_rec.DataSourceParams(
            app_name=APP, eval_k=3, eval_query_num=5,
            eval_rating_threshold=3.0)),
        algorithms=[("als", mod_als.ALSParams(**kw))]) for kw in SLICE_GRID]


def _evaluation(mod_rec, mod_ctl):
    return mod_ctl.Evaluation(
        engine=mod_rec.recommendation_engine(),
        metric=mod_rec.PrecisionAtK(k=5, rating_threshold=3.0),
        other_metrics=[mod_rec.NDCGAtK(k=5, rating_threshold=3.0),
                       mod_rec.PrecisionAtK(k=1, rating_threshold=0.0),
                       mod_rec.PositiveCount(rating_threshold=3.0)])


def _record(monkeypatch, mod_rec, evaluation):
    """Keep each training's model and the optimized metric's eval data."""
    seen = {"models": [], "eval_data": []}
    train = mod_rec.ALSAlgorithm.train

    def counted(self, ctx, td):
        model = train(self, ctx, td)
        seen["models"].append((self.params, td.ratings, model))
        return model

    monkeypatch.setattr(mod_rec.ALSAlgorithm, "train", counted)
    calc = evaluation.metric.calculate

    def keep(eval_data):
        seen["eval_data"].append(eval_data)
        return calc(eval_data)

    monkeypatch.setattr(evaluation.metric, "calculate", keep)
    return seen


def test_run_evaluation_matches_the_jax_package(sqlite_home, monkeypatch):
    import predictionio_tpu.controller.params as jparams

    from predictionio_tpu_torch.controller import params as pparams

    store, jstore = sqlite_home
    monkeypatch.setattr(als, "draw_initial_factors", _jax_draw)
    p_eval, j_eval = _evaluation(prec, pctl), _evaluation(jrec, jctl)
    p_seen = _record(monkeypatch, prec, p_eval)
    j_seen = _record(monkeypatch, jrec, j_eval)
    mine = pwf.run_evaluation(
        Context(device="cpu", _storage=store), p_eval,
        _slice_grid(prec, als, pparams), evaluation_class="port")
    theirs = jwf.run_evaluation(
        JContext(_storage=jstore), j_eval,
        _slice_grid(jrec, jals, jparams), evaluation_class="jax")

    assert mine.best_index == theirs.best_index
    assert abs(mine.scores[0].score - mine.scores[1].score) > 1e-2
    for s, js in zip(mine.scores, theirs.scores):
        assert abs(s.score - js.score) <= 1e-3
        np.testing.assert_allclose(s.other_scores, js.other_scores,
                                   rtol=0, atol=1e-3)
        assert s.engine_params.to_json() == js.engine_params.to_json()
    assert mine.metric_header == theirs.metric_header
    assert mine.other_metric_headers == theirs.other_metric_headers

    # 3 folds x 2 params sets, in the same order in both packages
    assert len(p_seen["models"]) == len(j_seen["models"]) == 6
    compared = ordered = 0
    for (pp, pr, _), (jp, jr, jmodel), pdata_, jdata_ in zip(
            p_seen["models"], j_seen["models"],
            [f for d in p_seen["eval_data"] for f in d],
            [f for d in j_seen["eval_data"] for f in d]):
        assert dataclasses.asdict(pp) == dataclasses.asdict(jp)
        np.testing.assert_array_equal(pr.users, jr.users)
        U = np.asarray(jmodel.user_factors, dtype=np.float64)
        V = np.asarray(jmodel.item_factors,
                       dtype=np.float64)[:jmodel.n_items]
        (_, pts), (_, jpts) = pdata_, jdata_
        assert len(pts) == len(jpts) > 0
        for (q, p, a), (jq, jp_, ja) in zip(pts, jpts):
            assert (q.user, q.num) == (jq.user, jq.num)
            assert a.ratings == ja.ratings
            scores = np.sort(V @ U[jmodel.user_ids[jq.user]])[::-1]
            n = jq.num
            got = [s.item for s in p.item_scores]
            want = [s.item for s in jp_.item_scores]
            assert len(got) == len(want) == n
            if scores[n - 1] - scores[n] > NEAR_TIE:
                compared += 1
                assert set(got) == set(want), jq.user
                if np.all(np.diff(scores[:n]) < -NEAR_TIE):
                    ordered += 1
                    assert got == want, jq.user
    n_queries = sum(len(pts) for d in p_seen["eval_data"] for _, pts in d)
    assert compared >= 0.7 * n_queries and ordered >= 0.3 * n_queries

    # one EVALCOMPLETED instance each, read alike by both packages
    for storage in (store, jstore):
        rows = sorted(storage.evaluation_instances().get_all(),
                      key=lambda i: i.evaluation_class)
        assert [i.evaluation_class for i in rows] == ["jax", "port"]
        assert all(i.status == STATUS_EVALCOMPLETED == J_EVALCOMPLETED
                   for i in rows)
        assert [i.evaluator_results for i in rows] == \
            [theirs.to_one_liner(), mine.to_one_liner()]
    got = json.loads(store.evaluation_instances().get_completed()[0]
                     .evaluator_results_json)
    assert got["bestIndex"] == mine.best_index
    assert got["metricScoresList"][1]["engineParams"] == \
        mine.scores[1].engine_params.to_json()


def _walk(parallelism, monkeypatch, grid):
    """The port's grid walk on a memory store, counting packings and
    trainings."""
    storage = Storage(env=MEM_ENV)
    seed_store(storage, n=400)
    counts = {"pack": 0, "train": 0}
    lock = threading.Lock()
    pack, train = als.pack_ratings, prec.ALSAlgorithm.train

    def counted_pack(*a, **k):
        with lock:
            counts["pack"] += 1
        return pack(*a, **k)

    def counted_train(self, ctx, td):
        with lock:
            counts["train"] += 1
        return train(self, ctx, td)

    monkeypatch.setattr(als, "pack_ratings", counted_pack)
    monkeypatch.setattr(prec.ALSAlgorithm, "train", counted_train)
    ev = pctl.Evaluation(engine=prec.recommendation_engine(),
                         metric=prec.PrecisionAtK(k=3),
                         other_metrics=[prec.NDCGAtK(k=3)])
    result = pctl.MetricEvaluator(ev, parallelism=parallelism).evaluate(
        Context(device="cpu", _storage=storage), grid)
    monkeypatch.undo()
    return result, counts


def test_parallel_walk_matches_serial_and_trains_each_prefix_once(
        monkeypatch):
    from predictionio_tpu_torch.controller.params import EngineParams

    grid = [EngineParams(
        datasource=("", prec.DataSourceParams(app_name=APP, eval_k=2)),
        algorithms=[("als", als.ALSParams(rank=r, num_iterations=3,
                                          reg=reg, seed=3))])
        for r in (3, 5) for reg in (0.05, 0.2)]
    grid.append(grid[1])  # a repeated set trains nothing new
    seq, seq_counts = _walk(1, monkeypatch, grid)
    par, par_counts = _walk(4, monkeypatch, grid)
    assert [s.score for s in seq.scores] == [s.score for s in par.scores]
    assert [s.other_scores for s in seq.scores] == \
        [s.other_scores for s in par.scores]
    assert seq.best_index == par.best_index
    assert seq.best_score == par.best_score
    assert seq.scores[1].score == seq.scores[4].score
    # 2 folds packed once each; 2 folds x 4 distinct algorithm params
    assert seq_counts == par_counts == {"pack": 2, "train": 8}


def test_pack_cache_is_compute_once_across_threads(monkeypatch):
    calls = []
    gate = threading.Event()
    pack = als.pack_ratings

    def slow_pack(*a, **k):
        calls.append(1)
        gate.wait(5)
        return pack(*a, **k)

    monkeypatch.setattr(als, "pack_ratings", slow_pack)
    r = als.RatingsCOO(np.array([0, 1, 1], np.int32),
                       np.array([0, 0, 1], np.int32),
                       np.array([1, 2, 3], np.float32), 2, 2)
    params = als.ALSParams(rank=2)
    out = [None] * 6
    threads = [threading.Thread(
        target=lambda i=i: out.__setitem__(
            i, als.pack_ratings_cached(r, params, device="cpu")))
        for i in range(6)]
    for t in threads:
        t.start()
    gate.set()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1
    assert all(o is out[0] for o in out)


def test_compute_once_retries_a_failed_key():
    memo = ComputeOnce(retry_on_failure=True)
    with pytest.raises(RuntimeError):
        memo.get("k", lambda: (_ for _ in ()).throw(RuntimeError("x")))
    assert memo.get_timed("k", lambda: 7)[0] == 7
    value, spent = memo.get_timed("k", lambda: 8)
    assert value == 7 and spent == 0.0
    sticky = ComputeOnce()
    with pytest.raises(RuntimeError):
        sticky.get("k", lambda: (_ for _ in ()).throw(RuntimeError("x")))
    with pytest.raises(RuntimeError):
        sticky.get("k", lambda: 1)


# -- fast eval ---------------------------------------------------------------------------

def _fast_fixture(ctl):
    """The counting engine of ``tests/test_fast_eval_cleaning.py``, built
    on one package's controller classes."""
    calls = {"read_eval": 0, "prepare": 0, "train": 0, "serve": 0}

    class CountingDataSource(ctl.DataSource):
        def __init__(self, params=None):
            self.params = params or {}

        def read_training(self, ctx):
            return [1, 2, 3]

        def read_eval(self, ctx):
            calls["read_eval"] += 1
            return [([1, 2], {"fold": 0}, [(10, 100), (20, 200)]),
                    ([3, 4], {"fold": 1}, [(30, 300)])]

    class CountingPreparator(ctl.IdentityPreparator):
        def __init__(self, params=None):
            self.params = params or {}

        def prepare(self, ctx, td):
            calls["prepare"] += 1
            return td

    class ParamAlgo(ctl.Algorithm):
        def __init__(self, params=None):
            self.factor = (params or {}).get("factor", 1)

        def train(self, ctx, pd):
            calls["train"] += 1
            return {"factor": self.factor}

        def predict(self, model, q):
            return q * model["factor"]

    class CountingServing(ctl.Serving):
        def __init__(self, params=None):
            self.params = params or {}

        def serve(self, q, ps):
            calls["serve"] += 1
            return ps[0]

    if ctl is pctl:
        engine = ctl.Engine({"algo": ParamAlgo, "": ParamAlgo},
                            CountingServing,
                            datasource_classes=CountingDataSource,
                            preparator_classes=CountingPreparator)
    else:
        engine = ctl.Engine(
            datasource_classes=CountingDataSource,
            preparator_classes=CountingPreparator,
            algorithm_classes={"algo": ParamAlgo, "": ParamAlgo},
            serving_classes=CountingServing)
    return engine, calls


def _ep(ctl_params, factor, serving_params=None):
    return ctl_params.EngineParams(
        datasource=("", {}), preparator=("", {}),
        algorithms=[("algo", {"factor": factor})],
        serving=("", serving_params or {}))


FAST_GRIDS = {
    "algorithm_sweep": [(1, None), (2, None), (3, None)],
    "identical": [(2, None), (2, None), (2, None)],
    "serving_only": [(2, {"s": 1}), (2, {"s": 2})],
}


@pytest.mark.parametrize("grid", sorted(FAST_GRIDS))
def test_fast_eval_miss_counts_are_the_jax_packages(grid):
    import predictionio_tpu.controller.params as jparams

    from predictionio_tpu_torch.controller import params as pparams

    out = {}
    for ctl, fast, params, ctx in (
            (pctl, pfast, pparams, Context(device="cpu",
                                           _storage=Storage(env=MEM_ENV))),
            (jctl, jfast, jparams, JContext(_storage=JStorage(env={
                "PIO_STORAGE_SOURCES_M_TYPE": "memory"})))):
        engine, calls = _fast_fixture(ctl)
        fe = fast.FastEvalEngine.from_engine(engine)
        results = fe.batch_eval(ctx, [_ep(params, f, s)
                                      for f, s in FAST_GRIDS[grid]])
        out[ctl] = (dict(fe.workflow_for(ctx).miss_counts), dict(calls),
                    [[(ei, [(q, p, a) for q, p, a in qpa])
                      for ei, qpa in folds] for _, folds in results])
        assert fe.workflow_for(ctx) is fe.workflow_for(ctx)
    assert out[pctl] == out[jctl]
    if grid == "algorithm_sweep":
        misses, calls, results = out[pctl]
        assert misses == {"datasource": 1, "preparator": 1,
                          "algorithms": 3, "serving": 3}
        assert calls["train"] == 6 and calls["read_eval"] == 1
        for folds, factor in zip(results, (1, 2, 3)):
            assert [p for _, p, _ in folds[0][1]] == [10 * factor,
                                                      20 * factor]


def test_plain_engine_recomputes_like_the_jax_packages():
    import predictionio_tpu.controller.params as jparams

    from predictionio_tpu_torch.controller import params as pparams

    out = {}
    for ctl, params, ctx in ((pctl, pparams, Context(device="cpu")),
                             (jctl, jparams, JContext())):
        engine, calls = _fast_fixture(ctl)
        results = engine.batch_eval(ctx, [_ep(params, 1), _ep(params, 2)])
        out[ctl] = (dict(calls), [folds for _, folds in results])
    assert out[pctl] == out[jctl]
    assert out[pctl][0]["read_eval"] == 2


def test_evaluator_needs_folds_and_average_serving():
    engine, _ = _fast_fixture(pctl)

    class NoEval(pctl.DataSource):
        def __init__(self, params=None):
            pass

        def read_training(self, ctx):
            return []

    engine.datasource_classes = {"": NoEval}
    ev = pctl.Evaluation(engine=engine, metric=pctl.ZeroMetric())
    from predictionio_tpu_torch.controller.params import EngineParams

    with pytest.raises(ValueError, match="read_eval"):
        pctl.MetricEvaluator(ev).evaluate(Context(device="cpu"),
                                          [EngineParams()])
    assert pctl.AverageServing().serve(None, [1.0, 2.0, 6.0]) == \
        jctl.AverageServing().serve(None, [1.0, 2.0, 6.0]) == 3.0
    simple = pctl.SimpleEngine(
        NoEval, _fast_fixture(pctl)[0].algorithm_classes["algo"])
    assert simple.make_serving(EngineParams()).serve(None, [5, 6]) == 5
    assert pctl.default_context(device="cpu").device == "cpu"
    assert pctl.EmptyParams() == pctl.EmptyParams()


# -- preparator and serving --------------------------------------------------------------

@pytest.mark.parametrize("excluded,from_file", [
    (("i3", "i7", "nope"), False), (("i0",), True), ((), False),
    (("i1", "i2", "i5", "i11"), True)])
def test_exclude_items_preparator_is_the_jax_packages(
        sqlite_home, tmp_path, excluded, from_file):
    store, jstore = sqlite_home
    kw = {"items": excluded}
    if from_file:
        path = tmp_path / "exclude.txt"
        path.write_text("\n".join(excluded) + "\n\n")
        kw = {"filepath": str(path)}
    ptd = prec.RecommendationDataSource(prec.DataSourceParams(
        app_name=APP)).read_training(Context(device="cpu", _storage=store))
    jtd = jrec.RecommendationDataSource(jrec.DataSourceParams(
        app_name=APP)).read_training(JContext(_storage=jstore))
    mine = prec.ExcludeItemsPreparator(
        prec.ExcludeItemsPreparatorParams(**kw)).prepare(None, ptd)
    theirs = jrec.ExcludeItemsPreparator(
        jrec.ExcludeItemsPreparatorParams(**kw)).prepare(None, jtd)
    for f in ("users", "items", "ratings"):
        got, want = getattr(mine.ratings, f), getattr(theirs.ratings, f)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert (mine.ratings.n_users, mine.ratings.n_items) == \
        (theirs.ratings.n_users, theirs.ratings.n_items)
    assert mine.item_ids.to_dict() == theirs.item_ids.to_dict()
    assert mine.user_ids.to_dict() == theirs.user_ids.to_dict()
    assert not set(excluded) & set(mine.item_ids.keys())
    assert (mine is ptd) == (not set(excluded) & set(ptd.item_ids.keys()))


def test_exclude_slot_trains_without_the_items(sqlite_home):
    store, _ = sqlite_home
    engine = prec.recommendation_engine()
    ep = engine.params_from_variant({
        "datasource": {"params": {"app_name": APP}},
        "preparator": {"name": "exclude", "params": {"items": ["i3"]}},
        "algorithms": [{"name": "als", "params": {"rank": 4,
                                                  "num_iterations": 2}}]})
    (model,) = engine.train(Context(device="cpu", _storage=store),
                            ep).models
    assert "i3" not in model.item_ids
    assert model.n_items == N_ITEMS - 1


@pytest.mark.parametrize("lines", [["i1", "i4"], [], ["", "  i2  ", "zz"]])
def test_file_blacklist_serving_is_the_jax_packages(tmp_path, lines):
    path = tmp_path / "black.txt"
    path.write_text("\n".join(lines) + "\n")
    served = {}
    for mod in (prec, jrec):
        pred = mod.PredictedResult(tuple(
            mod.ItemScore(item=f"i{j}", score=float(10 - j))
            for j in range(6)))
        serving = mod.FileBlacklistServing(
            mod.FileBlacklistServingParams(filepath=str(path)))
        served[mod] = serving.serve(mod.Query(user="u0", num=6),
                                    [pred]).to_json()
    assert served[prec] == served[jrec]
    engine = prec.recommendation_engine()
    ep = engine.params_from_variant({"serving": {
        "name": "fileblacklist", "params": {"filepath": str(path)}}})
    assert isinstance(engine.make_serving(ep), prec.FileBlacklistServing)


def test_default_engine_params_are_the_jax_packages():
    mine = prec.default_engine_params(APP, rank=6, num_iterations=3)
    theirs = jrec.default_engine_params(APP, rank=6, num_iterations=3)
    assert mine.to_json() == theirs.to_json()


# -- the evaluation-instance DAO ----------------------------------------------------------

@pytest.mark.parametrize("kind", ["memory", "sqlite"])
def test_evaluation_instances_dao(kind, tmp_path):
    env = MEM_ENV if kind == "memory" else {"PIO_HOME": str(tmp_path)}
    storage = Storage(env=env)
    try:
        dao = storage.evaluation_instances()
        t = datetime(2026, 3, 1, tzinfo=timezone.utc)
        ids = [dao.insert(EvaluationInstance(
            id="", status=STATUS_INIT, start_time=t + timedelta(hours=h),
            end_time=t, evaluation_class=f"m:e{h}", batch="b",
            env={"K": "v"})) for h in range(3)]
        assert len(set(ids)) == 3
        for h in (0, 2):
            done = dao.get(ids[h])
            dao.update(done.copy(status=STATUS_EVALCOMPLETED,
                                 evaluator_results=f"r{h}",
                                 evaluator_results_json="{}"))
        assert [i.id for i in dao.get_completed()] == [ids[2], ids[0]]
        got = dao.get(ids[2])
        assert got.env == {"K": "v"} and got.evaluator_results == "r2"
        assert got.start_time == t + timedelta(hours=2)
        assert len(dao.get_all()) == 3
        dao.delete(ids[1])
        assert dao.get(ids[1]) is None and len(dao.get_all()) == 2
    finally:
        storage.close()


def test_a_port_written_evaluation_instance_reads_alike_in_jax(tmp_path):
    storage = Storage(env={"PIO_HOME": str(tmp_path)})
    jstorage = JStorage(env={"PIO_HOME": str(tmp_path)})
    try:
        t = datetime(2026, 3, 1, 12, 30, tzinfo=timezone.utc)
        iid = storage.evaluation_instances().insert(EvaluationInstance(
            id="", status=STATUS_EVALCOMPLETED, start_time=t, end_time=t,
            evaluation_class="a:b", engine_params_generator_class="c:d",
            evaluator_results="one", evaluator_results_html="<p/>",
            evaluator_results_json='{"bestIndex": 1}'))
        mine = storage.evaluation_instances().get(iid)
        theirs = jstorage.evaluation_instances().get(iid)
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    finally:
        jstorage.close()
        storage.close()


# -- the CLI and the default device ------------------------------------------------------

EVAL_MODULE = '''
from predictionio_tpu_torch.controller import Evaluation
from predictionio_tpu_torch.controller.params import EngineParams
from predictionio_tpu_torch.models.als import ALSParams
from predictionio_tpu_torch.templates.recommendation import (
    DataSourceParams, PrecisionAtK, recommendation_engine)

evaluation = Evaluation(engine=recommendation_engine(),
                        metric=PrecisionAtK(k=3, rating_threshold=2.0))
engine_params_list = [
    EngineParams(
        datasource=("", DataSourceParams(app_name="evapp", eval_k=2)),
        algorithms=[("als", ALSParams(rank=r, num_iterations=4, seed=1))])
    for r in (4, 8)]


class Gen:
    engine_params_list = engine_params_list


gen = Gen()
'''


@pytest.fixture()
def eval_module(tmp_path, monkeypatch):
    (tmp_path / "torch_cli_eval_mod.py").write_text(EVAL_MODULE)
    monkeypatch.syspath_prepend(str(tmp_path))
    yield "torch_cli_eval_mod"
    sys.modules.pop("torch_cli_eval_mod", None)


@pytest.mark.parametrize("extra", [[], ["--parallelism", "2"]])
def test_cli_eval_on_cpu(eval_module, capsys, extra):
    storage = Storage(env=MEM_ENV)
    seed_store(storage)
    assert cli.main(["eval", f"{eval_module}:evaluation",
                     f"{eval_module}:gen", "--device", "cpu", *extra],
                    storage=storage) == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert out.startswith("[Precision@3 (threshold=2.0)] best variant ")
    score = float(out.rsplit(": ", 1)[1])
    assert 0.0 <= score <= 1.0 and len(out.rsplit(": ", 1)[1]) == 8
    (inst,) = storage.evaluation_instances().get_all()
    assert inst.status == STATUS_EVALCOMPLETED
    assert inst.evaluator_results == out
    assert inst.evaluation_class == f"{eval_module}:evaluation"
    assert inst.engine_params_generator_class == f"{eval_module}:gen"
    result = json.loads(inst.evaluator_results_json)
    assert len(result["metricScoresList"]) == 2
    assert result["bestScore"] == max(
        s["score"] for s in result["metricScoresList"])
    assert "<table border=1>" in inst.evaluator_results_html


def test_cli_eval_without_a_grid_fails(tmp_path, monkeypatch, capsys):
    (tmp_path / "torch_cli_eval_nogrid.py").write_text(
        "from predictionio_tpu_torch.controller import Evaluation, "
        "ZeroMetric\nfrom predictionio_tpu_torch.templates."
        "recommendation import recommendation_engine\nevaluation = "
        "Evaluation(engine=recommendation_engine(), metric=ZeroMetric())\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    try:
        storage = Storage(env=MEM_ENV)
        assert cli.main(["eval", "torch_cli_eval_nogrid:evaluation",
                         "--device", "cpu"], storage=storage) == 1
        assert "No engine params" in capsys.readouterr().err
        assert storage.evaluation_instances().get_all() == []
    finally:
        sys.modules.pop("torch_cli_eval_nogrid", None)


def test_the_shipped_example_is_the_jax_packages():
    """The port's evaluation example has the JAX package's grid and
    metrics, and loads through the CLI's module path."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / \
        "recommendation" / "evaluation.py"
    spec = importlib.util.spec_from_file_location("jax_example", path)
    theirs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(theirs)
    mine = cli.load_engine_factory(
        "predictionio_tpu_torch.examples.recommendation_evaluation:"
        "engine_params_generator").engine_params_list
    assert [ep.to_json() for ep in mine] == [
        ep.to_json() for ep in
        theirs.engine_params_generator.engine_params_list]
    ev = cli.load_engine_factory(
        "predictionio_tpu_torch.examples.recommendation_evaluation:"
        "evaluation")
    assert [m.header for m in ev.metrics] == [
        m.header for m in theirs.evaluation.metrics]
    assert type(ev.engine).__module__.startswith("predictionio_tpu_torch.")


def test_a_jax_package_evaluation_path_is_read_as_the_ports():
    from predictionio_tpu_torch.examples import recommendation_evaluation

    got = cli.load_engine_factory(
        "predictionio_tpu.examples.recommendation_evaluation:evaluation")
    assert got is recommendation_evaluation.evaluation


def test_eval_entry_points_default_to_the_card(eval_module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    storage = Storage(env=MEM_ENV)
    seed_store(storage)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["eval", f"{eval_module}:evaluation", f"{eval_module}:gen"],
                 storage=storage)
    ev = pctl.Evaluation(engine=prec.recommendation_engine(),
                         metric=prec.PrecisionAtK(k=3))
    grid = _grid(prec, als, pctl)[:1]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pwf.run_evaluation(Context(_storage=storage), ev, grid)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pctl.MetricEvaluator(ev).evaluate(Context(_storage=storage), grid)
    assert storage.evaluation_instances().get_all() == []


# -- launch counters ------------------------------------------------------------------------

@pytest.mark.parametrize("mod", [fused_topk, fused_gram, solve, gram],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_launch_counter_loses_no_count_under_threads(mod, monkeypatch):
    monkeypatch.setattr(mod, "LAUNCHES", 0)
    if mod is gram:
        monkeypatch.setattr(mod, "LAST_PATH", 0)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def bump():
            for _ in range(10_000):
                if mod is gram:
                    count_launch(mod.__name__, LAST_PATH=2)
                else:
                    count_launch(mod.__name__)

        threads = [threading.Thread(target=bump) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert mod.LAUNCHES == 80_000
    if mod is gram:
        assert mod.LAST_PATH == 2


def test_count_launch_counts_under_its_lock(monkeypatch):
    """A bump waits for the counters' lock: while another holder has it,
    no count moves (the stress test above cannot show a lost update on
    an interpreter that never switches inside ``+=``)."""
    from predictionio_tpu_torch.ops import launches

    monkeypatch.setattr(fused_topk, "LAUNCHES", 5)
    bumper = threading.Thread(target=count_launch,
                              args=(fused_topk.__name__,))
    with launches._lock:
        bumper.start()
        bumper.join(0.2)
        assert bumper.is_alive() and fused_topk.LAUNCHES == 5
    bumper.join(10)
    assert not bumper.is_alive()
    assert fused_topk.LAUNCHES == 6
