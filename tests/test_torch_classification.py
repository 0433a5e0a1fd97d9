"""The classification template, its models and ``e2/`` on the port, held
to the JAX package on the CPU.

Same inputs go through both packages. Tolerances, each where it is used:

- naive Bayes: log-priors and log-likelihoods within rtol 1e-12 (both
  float64 on the host), ``predict`` and ``predict_batch`` labels equal;
- random forest: the per-node arrays equal bit for bit (the same host
  code and ``default_rng`` draws), ``predict_batch`` labels equal, and
  the votes equal to a numpy traversal of the same arrays exactly;
- ``e2``: every case of ``tests/test_e2.py`` through both packages with
  its own tolerance (1e-4 on the reference's quoted values); the Markov
  chain's ``predict`` within rtol 1e-6 of the JAX package's (both f32;
  an ``index_add_`` may sum in another order);
- the template: ``read_eval``'s folds and ``Accuracy`` equal exactly.
"""

import json
import math
import pickle
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import predictionio_tpu.data.storage.registry as jregistry
import predictionio_tpu.e2 as je2
import predictionio_tpu.models.classify as jcls
import predictionio_tpu.templates.classification as jtpl
from predictionio_tpu.controller import Evaluation as JEvaluation
from predictionio_tpu.controller.context import Context as JContext
from predictionio_tpu.controller.params import EngineParams as JEngineParams
from predictionio_tpu.data.storage.base import App as JApp
from predictionio_tpu.data.storage.registry import Storage as JStorage
from predictionio_tpu.workflow import run_evaluation as jrun_evaluation
from predictionio_tpu_torch import cli
from predictionio_tpu_torch import e2 as pe2
from predictionio_tpu_torch.controller import Evaluation
from predictionio_tpu_torch.controller.context import Context
from predictionio_tpu_torch.controller.params import EngineParams
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import registry
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.models import classify as pcls
from predictionio_tpu_torch.models.convert import (
    naive_bayes_model_from_numpy,
    random_forest_model_from_numpy,
)
from predictionio_tpu_torch.templates import classification as ptpl
from predictionio_tpu_torch.utils.jsonutil import from_jsonable
from predictionio_tpu_torch.workflow.core import run_evaluation
from predictionio_tpu_torch.workflow.persistence import (
    dumps_models,
    loads_models,
)
from test_e2 import FRUIT_POINTS
from test_templates import classification_events

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
MEM_ENV = {"PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"}
J_MEM_ENV = {
    "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
}
_LOCAL = urllib.request.build_opener(urllib.request.ProxyHandler({}))


# -- e2: categorical naive Bayes ------------------------------------------------

def _points(pkg):
    return [pkg.LabeledPoint(p.label, p.features) for p in FRUIT_POINTS]


@pytest.fixture(scope="module")
def fruit():
    return (pe2.train_naive_bayes(_points(pe2)),
            je2.train_naive_bayes(_points(je2)))


def test_e2_nb_model_arrays_are_the_jax_packages(fruit):
    mine, theirs = fruit
    assert mine.labels.to_dict() == theirs.labels.to_dict()
    assert [v.to_dict() for v in mine.vocabs] == \
        [v.to_dict() for v in theirs.vocabs]
    np.testing.assert_array_equal(mine.priors, theirs.priors)
    np.testing.assert_array_equal(mine.likelihoods, theirs.likelihoods)
    np.testing.assert_array_equal(mine.present, theirs.present)


@pytest.mark.parametrize("label, slot, value", [
    ("Banana", 0, "Long"), ("Banana", 0, "Not Long"), ("Banana", 1, "Sweet"),
    ("Banana", 2, "Yellow"), ("Orange", 0, "Long"), ("Orange", 0, "Not Long"),
    ("Orange", 1, "Sweet"), ("Orange", 2, "Not Yellow"),
    ("Orange", 2, "Yellow"), ("Other Fruit", 1, "Sweet"),
    ("Other Fruit", 2, "Not Yellow")])
def test_e2_nb_likelihoods(fruit, label, slot, value):
    mine, theirs = fruit
    want = theirs.likelihood(label, slot, value)
    got = mine.likelihood(label, slot, value)
    assert (got is None) == (want is None)
    if want is not None:
        assert got == pytest.approx(want, abs=TOL)


@pytest.mark.parametrize("label", ["Banana", "Orange", "Other Fruit"])
def test_e2_nb_priors(fruit, label):
    mine, theirs = fruit
    assert mine.prior(label) == pytest.approx(theirs.prior(label), abs=TOL)


@pytest.mark.parametrize("point, default", [
    (("Banana", ["Long", "Not Sweet", "Not Yellow"]), None),
    (("Banana", ["Long", "Not Sweet", "Not Exist"]), None),
    (("Not Exist", ["Long", "Not Sweet", "Yellow"]), None),
    (("Banana", ["Long", "Not Sweet", "Not Exist"]), math.log(1e-9))])
def test_e2_nb_log_score(fruit, point, default):
    mine, theirs = fruit
    kw = {} if default is None else {"default_likelihood":
                                     lambda ls: default}
    want = theirs.log_score(je2.LabeledPoint(*point), **kw)
    got = mine.log_score(pe2.LabeledPoint(*point), **kw)
    if want is None or math.isinf(want):
        assert got == want
    else:
        assert got == pytest.approx(want, abs=TOL)


def test_e2_nb_predict_and_predict_batch(fruit):
    mine, theirs = fruit
    batch = [p.features for p in FRUIT_POINTS] + [
        ("Long", "Sweet", "Never Seen")]
    want = theirs.predict_batch(batch)
    assert mine.predict_batch(batch, device="cpu") == want
    assert [mine.predict(f) for f in batch] == \
        [theirs.predict(f) for f in batch]
    assert mine.predict(["Long", "Sweet", "Yellow"]) == "Banana"


def test_e2_nb_pickles_after_predict_batch(fruit):
    mine, _ = fruit
    mine.predict_batch([["Long", "Sweet", "Yellow"]], device="cpu")
    assert mine._batch_scorer is not None
    clone = pickle.loads(pickle.dumps(mine))
    assert clone._batch_scorer is None
    assert clone.predict_batch([["Long", "Sweet", "Yellow"]],
                               device="cpu") == ["Banana"]


def test_e2_nb_predict_batch_needs_the_card_unless_asked(fruit,
                                                         monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fruit[0].predict_batch([["Long", "Sweet", "Yellow"]])


def test_e2_nb_refuses_an_empty_dataset():
    with pytest.raises(ValueError, match="empty"):
        pe2.train_naive_bayes([])


# -- e2: Markov chain, vectorizer, cross validation ------------------------------

MC_CASES = {
    "two_by_two": ([0, 0, 1, 1], [0, 1, 0, 1], [3, 7, 10, 10], 2, 2),
    "top_n_by_full_total": (
        [0, 0, 1, 1, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4],
        [1, 2, 0, 1, 2, 3, 4, 1, 2, 4, 0, 3, 4, 1, 3, 4],
        [12, 8, 3, 3, 9, 2, 8, 10, 8, 10, 2, 3, 4, 7, 8, 10], 5, 2),
    "random": tuple(np.random.default_rng(3).integers(0, 40, (3, 400))) +
    (40, 6),
}


@pytest.mark.parametrize("name", sorted(MC_CASES))
def test_e2_markov_chain_is_the_jax_packages(name):
    rows, cols, tallies, n, top = MC_CASES[name]
    mine = pe2.train_markov_chain(rows, cols, tallies, n, top)
    theirs = je2.train_markov_chain(rows, cols, tallies, n, top)
    np.testing.assert_array_equal(mine.indices, theirs.indices)
    np.testing.assert_array_equal(mine.probs, theirs.probs)
    assert mine.n == theirs.n == top
    for s in range(n):
        assert mine.row(s) == theirs.row(s)
    cur = np.random.default_rng(5).random(n).astype(np.float32)
    np.testing.assert_allclose(mine.predict(cur, device="cpu"),
                               theirs.predict(cur), rtol=1e-6, atol=1e-7)


def test_e2_markov_chain_predict_and_pickle():
    model = pe2.train_markov_chain([0, 0, 1, 1], [0, 1, 0, 1],
                                   [3, 7, 10, 10], 2, 2)
    assert model.row(0) == [(0, pytest.approx(0.3)), (1, pytest.approx(0.7))]
    np.testing.assert_allclose(model.predict([0.4, 0.6], device="cpu"),
                               [0.42, 0.58], atol=1e-6)
    clone = pickle.loads(pickle.dumps(model))
    assert clone._predictor is None
    np.testing.assert_allclose(clone.predict([0.4, 0.6], device="cpu"),
                               [0.42, 0.58], atol=1e-6)


def test_e2_vectorizer_is_the_jax_packages():
    pairs = [("food", "orange"), ("food", "banana"), ("mood", "happy")]
    for pkg in (pe2, je2):
        vz = pkg.BinaryVectorizer.from_pairs(pairs)
        np.testing.assert_array_equal(
            vz.to_binary([("food", "banana"), ("mood", "happy")]),
            [0.0, 1.0, 1.0])
    maps = [{"food": "orange", "height": "tall"},
            {"food": "banana", "mood": "happy"}]
    mine = pe2.BinaryVectorizer.from_maps(maps, {"food", "mood"})
    theirs = je2.BinaryVectorizer.from_maps(maps, {"food", "mood"})
    assert mine.property_map == theirs.property_map
    assert repr(mine) == repr(theirs)
    batch = [[("food", "orange")], [("mood", "happy"), ("food", "kiwi")], []]
    np.testing.assert_array_equal(mine.to_matrix(batch),
                                  theirs.to_matrix(batch))


@pytest.mark.parametrize("k", [1, 3, 4])
def test_e2_split_data_is_the_jax_packages(k):
    data = list(range(10))
    args = dict(eval_k=k, dataset=data, evaluator_info="info",
                training_data_creator=list,
                query_creator=lambda d: ("q", d),
                actual_creator=lambda d: ("a", d))
    assert pe2.split_data(**args) == je2.split_data(**args)


# -- models/classify.py -----------------------------------------------------------

def _xy(n=200, F=3, C=3, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, C, n).astype(np.float64)
    X = rng.integers(0, 6, (n, F)).astype(np.float64) + 3.0 * (
        y[:, None] == np.arange(F)[None, :] % C)
    return X, y


@pytest.mark.parametrize("lam", [1.0, 0.25])
def test_naive_bayes_is_the_jax_packages(lam):
    X, y = _xy()
    mine = pcls.train_naive_bayes_multinomial(X, y, lam=lam)
    theirs = jcls.train_naive_bayes_multinomial(X, y, lam=lam)
    np.testing.assert_allclose(mine.log_priors, theirs.log_priors,
                               rtol=1e-12)
    np.testing.assert_allclose(mine.log_likelihoods, theirs.log_likelihoods,
                               rtol=1e-12)
    np.testing.assert_array_equal(mine.classes, theirs.classes)
    Xq = np.random.default_rng(1).integers(0, 9, (64, 3)).astype(np.float64)
    np.testing.assert_array_equal(mine.predict_batch(Xq, device="cpu"),
                                  theirs.predict_batch(Xq))
    assert [mine.predict(x) for x in Xq] == [theirs.predict(x) for x in Xq]


@pytest.mark.parametrize("lam", [0.0, -1.0])
def test_naive_bayes_refuses_lam_at_or_below_zero(lam):
    X, y = _xy(n=20)
    with pytest.raises(ValueError, match="positive"):
        pcls.train_naive_bayes_multinomial(X, y, lam=lam)


def test_naive_bayes_refuses_negative_features():
    with pytest.raises(ValueError, match="non-negative"):
        pcls.train_naive_bayes_multinomial(np.array([[-1.0, 2.0]]),
                                           np.array([0.0]))


def _numpy_votes(m, X):
    """The forest traversed in numpy, a query and a tree at a time."""
    X = np.asarray(X, np.float32)
    votes = np.zeros((len(X), len(m.classes)), np.float32)
    for b, x in enumerate(X):
        for t in range(m.feature.shape[0]):
            n = 0
            while m.feature[t, n] >= 0:
                n = (m.left[t, n] if x[m.feature[t, n]] <= m.threshold[t, n]
                     else m.right[t, n])
            votes[b, m.leaf[t, n]] += 1
    return votes


RF_CASES = {
    "default": ({}, 2),
    "gini_deep": (dict(num_classes=3, num_trees=7, max_depth=6, seed=4), 3),
    "entropy_all": (dict(num_classes=3, num_trees=5, impurity="entropy",
                         feature_subset_strategy="all", max_bins=4,
                         seed=9), 3),
    "log2_onethird": (dict(num_classes=3, num_trees=4,
                           feature_subset_strategy="onethird", seed=1), 3),
}


@pytest.mark.parametrize("name", sorted(RF_CASES))
def test_random_forest_is_the_jax_packages(name):
    kw, C = RF_CASES[name]
    X, y = _xy(n=150, C=C, seed=2)
    mine = pcls.train_random_forest(X, y, pcls.RandomForestParams(**kw))
    theirs = jcls.train_random_forest(X, y, jcls.RandomForestParams(**kw))
    for a in ("feature", "threshold", "left", "right", "leaf", "classes"):
        got, want = getattr(mine, a), getattr(theirs, a)
        assert got.dtype == want.dtype and got.shape == want.shape, a
        assert got.tobytes() == want.tobytes(), a
    assert mine.max_depth == theirs.max_depth
    Xq = np.random.default_rng(3).integers(0, 9, (80, 3)).astype(np.float64)
    votes = mine.votes(Xq, device="cpu").numpy()
    np.testing.assert_array_equal(votes, _numpy_votes(mine, Xq))
    np.testing.assert_array_equal(mine.predict_batch(Xq, device="cpu"),
                                  theirs.predict_batch(Xq))
    np.testing.assert_array_equal(
        mine.classes[np.argmax(votes, axis=1)], theirs.predict_batch(Xq))


def test_random_forest_validates_its_classes():
    X, y = _xy(n=30, C=3)
    with pytest.raises(ValueError, match="num_classes"):
        pcls.train_random_forest(X, y, pcls.RandomForestParams(num_classes=2))


def test_models_carried_from_the_jax_package_answer_alike():
    X, y = _xy(n=120, C=3, seed=6)
    jnb = jcls.train_naive_bayes_multinomial(X, y)
    jrf = jcls.train_random_forest(X, y, jcls.RandomForestParams(
        num_classes=3, num_trees=6, seed=2))
    nb = naive_bayes_model_from_numpy(jnb.log_priors, jnb.log_likelihoods,
                                      jnb.classes, device="cpu")
    rf = random_forest_model_from_numpy(
        jrf.feature, jrf.threshold, jrf.left, jrf.right, jrf.leaf,
        jrf.classes, jrf.max_depth, device="cpu")
    Xq = np.random.default_rng(7).integers(0, 9, (50, 3)).astype(np.float64)
    np.testing.assert_array_equal(nb.predict_batch(Xq), jnb.predict_batch(Xq))
    np.testing.assert_array_equal(rf.predict_batch(Xq), jrf.predict_batch(Xq))


def test_models_pickle_without_their_device_tensors():
    X, y = _xy(n=60)
    nb = pcls.train_naive_bayes_multinomial(X, y)
    rf = pcls.train_random_forest(X, y, pcls.RandomForestParams(
        num_classes=3, num_trees=3))
    for m in (nb, rf):
        before = m.predict_batch(X[:5], device="cpu")
        clone = pickle.loads(pickle.dumps(m))
        assert not hasattr(clone, "_scorer") and \
            not hasattr(clone, "_traverse")
        np.testing.assert_array_equal(clone.predict_batch(X[:5],
                                                          device="cpu"),
                                      before)


# -- the template end to end --------------------------------------------------------

APP = "clsapp"


def port_event(e):
    return Event(event=e.event, entity_type=e.entity_type,
                 entity_id=e.entity_id,
                 properties=DataMap(e.properties.to_dict()),
                 event_time=e.event_time)


@pytest.fixture(scope="module")
def ctxs():
    events = classification_events()
    st = Storage(env=MEM_ENV)
    app_id = st.apps().insert(App(0, APP))
    st.events().init(app_id)
    st.events().insert_batch([port_event(e) for e in events], app_id)
    jst = JStorage(env=J_MEM_ENV)
    japp_id = jst.apps().insert(JApp(0, APP))
    jst.events().init(japp_id)
    jst.events().insert_batch(list(events), japp_id)
    return (Context(device="cpu", app_name=APP, _storage=st),
            JContext(app_name=APP, _storage=jst))


ALGOS = {
    "naive": {},
    "randomforest": dict(num_classes=2, num_trees=8, max_depth=4, seed=3),
    "randomforest_5": dict(num_classes=2, num_trees=5, seed=1),
}
QUERIES = [(8.0, 1.0, 0.0), (0.0, 1.0, 8.0), (0.0, 0.0, 7.0),
           (6.0, 2.0, 1.0), (3.0, 3.0, 3.0), (0.0, 0.0, 0.0)]


def _train(ctxs, name):
    algo = name.split("_")[0]
    ctx, jctx = ctxs
    out = []
    for pkg, c in ((ptpl, ctx), (jtpl, jctx)):
        engine = pkg.classification_engine()
        ep = pkg.default_engine_params(APP, algo=algo, **ALGOS[name])
        out.append((engine.make_algorithms(ep)[0],
                    engine.train(c, ep).models[0]))
    return out


@pytest.mark.parametrize("name", sorted(ALGOS))
def test_template_lifecycle_answers_as_the_jax_package(ctxs, name):
    (algo, model), (jalgo, jmodel) = _train(ctxs, name)
    assert model.device == "cpu"
    got = [algo.predict(model, ptpl.Query(*q)).label for q in QUERIES]
    want = [jalgo.predict(jmodel, jtpl.Query(*q)).label for q in QUERIES]
    assert got == want
    assert got[:2] == [0.0, 1.0]
    batch = algo.batch_predict(model, [ptpl.Query(*q) for q in QUERIES])
    assert [b.label for b in batch] == got
    assert [b.label for b in jalgo.batch_predict(
        jmodel, [jtpl.Query(*q) for q in QUERIES])] == want


def test_template_models_round_trip_through_the_model_file(ctxs):
    (nb_algo, nb), _ = _train(ctxs, "naive")
    (rf_algo, rf), _ = _train(ctxs, "randomforest")
    back_nb, back_rf = loads_models(dumps_models([nb, rf]))
    assert isinstance(back_nb, pcls.NaiveBayesModel)
    assert isinstance(back_rf, pcls.RandomForestModel)
    for a in ("log_priors", "log_likelihoods", "classes"):
        np.testing.assert_array_equal(getattr(back_nb, a), getattr(nb, a))
    for a in ("feature", "threshold", "left", "right", "leaf", "classes"):
        np.testing.assert_array_equal(getattr(back_rf, a), getattr(rf, a))
    assert back_rf.max_depth == rf.max_depth
    back_nb = nb_algo.prepare_serving_model(back_nb, torch.device("cpu"))
    back_rf = rf_algo.prepare_serving_model(back_rf, torch.device("cpu"))
    qs = [ptpl.Query(*q) for q in QUERIES]
    assert nb_algo.batch_predict(back_nb, qs) == nb_algo.batch_predict(nb, qs)
    assert rf_algo.batch_predict(back_rf, qs) == rf_algo.batch_predict(rf, qs)


def test_read_eval_folds_and_accuracy_are_the_jax_packages(ctxs):
    ctx, jctx = ctxs
    ds = ptpl.ClassificationDataSource(ptpl.DataSourceParams(APP, eval_k=3))
    jds = jtpl.ClassificationDataSource(jtpl.DataSourceParams(APP, eval_k=3))
    folds, jfolds = ds.read_eval(ctx), jds.read_eval(jctx)
    assert len(folds) == len(jfolds) == 3
    for (td, ei, qa), (jtd, jei, jqa) in zip(folds, jfolds):
        np.testing.assert_array_equal(td.features, jtd.features)
        np.testing.assert_array_equal(td.labels, jtd.labels)
        assert ei is None and jei is None
        assert [(q.attr0, q.attr1, q.attr2, a.label) for q, a in qa] == \
            [(q.attr0, q.attr1, q.attr2, a.label) for q, a in jqa]
    ep = EngineParams(datasource=("", ptpl.DataSourceParams(APP, eval_k=3)),
                      algorithms=[("naive", ptpl.NaiveBayesParams())])
    jep = JEngineParams(datasource=("", jtpl.DataSourceParams(APP,
                                                              eval_k=3)),
                        algorithms=[("naive", jtpl.NaiveBayesParams())])
    got = run_evaluation(ctx, Evaluation(
        engine=ptpl.classification_engine(), metric=ptpl.Accuracy()), [ep])
    want = jrun_evaluation(jctx, JEvaluation(
        engine=jtpl.classification_engine(), metric=jtpl.Accuracy()), [jep])
    assert got.best_score == want.best_score
    assert got.best_score > 0.8
    with pytest.raises(ValueError, match="eval_k"):
        ptpl.ClassificationDataSource(ptpl.DataSourceParams(APP)).read_eval(
            ctx)


def test_an_app_without_points_fails_its_sanity_check():
    st = Storage(env=MEM_ENV)
    app_id = st.apps().insert(App(0, "empty"))
    st.events().init(app_id)
    engine = ptpl.classification_engine()
    with pytest.raises(ValueError, match="empty"):
        engine.train(Context(device="cpu", app_name="empty", _storage=st),
                     ptpl.default_engine_params("empty"))


# -- cli train and deploy ---------------------------------------------------------------

@pytest.fixture
def home(tmp_path, monkeypatch):
    monkeypatch.setattr(registry, "_global", Storage(env=MEM_ENV))
    monkeypatch.setattr(jregistry, "_global", JStorage(env=J_MEM_ENV))
    st = Storage(env={"PIO_HOME": str(tmp_path / "home")})
    yield st, str(tmp_path / "home")
    st.close()


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/queries.json",
                                 data=json.dumps(body).encode(),
                                 method="POST")
    with _LOCAL.open(req, timeout=60) as resp:
        return json.loads(resp.read())


@pytest.mark.parametrize("algo", ["naive", "randomforest"])
def test_cli_train_and_deploy_the_shipped_variant(home, tmp_path, capsys,
                                                  algo):
    """``examples/classification/engine.json`` as shipped, and with the
    random forest at the JAX package's default params: ``cli train``,
    ``cli deploy`` (batching on, so queries go through
    ``batch_predict``), answers equal to the JAX engine's ``predict``."""
    st, home_dir = home
    path = ROOT / "examples" / "classification" / "engine.json"
    variant = json.loads(path.read_text())
    if algo == "randomforest":
        variant["algorithms"] = [{"name": "randomforest", "params": {}}]
        path = tmp_path / "engine.json"
        path.write_text(json.dumps(variant))
    app = variant["datasource"]["params"]["app_name"]
    assert cli.main(["app", "new", app], storage=st) == 0
    app_id = st.apps().get_by_name(app).id
    events = classification_events()
    st.events().insert_batch([port_event(e) for e in events], app_id)
    assert cli.main(["train", "--engine-json", str(path), "--device",
                     "cpu"], storage=st) == 0
    assert "Training completed" in capsys.readouterr().out
    jst = JStorage(env={"PIO_HOME": home_dir})
    try:
        jengine = jtpl.classification_engine()
        jep = jengine.params_from_variant(variant)
        jmodel = jengine.train(JContext(_storage=jst), jep).models[0]
        jalgo = jengine.make_algorithms(jep)[0]
    finally:
        jst.close()
    args = cli._parser().parse_args([
        "deploy", "--engine-json", str(path), "--device", "cpu", "--ip",
        "127.0.0.1", "--port", "0", "--batching"])
    srv = cli.build_deploy(args, st).start_background()
    try:
        (bound,) = srv.query_server.models
        assert type(bound).__name__ == {"naive": "NaiveBayesModel",
                                        "randomforest":
                                        "RandomForestModel"}[algo]
        assert bound.device == "cpu"
        for q in QUERIES:
            body = {"attr0": q[0], "attr1": q[1], "attr2": q[2]}
            got = _post(srv.port, body)
            want = jalgo.predict(jmodel, from_jsonable(jtpl.Query, body))
            assert got == {"label": want.label}, body
    finally:
        srv.close()
