"""Models the JAX package trained, deployed by the port: for each shipped
template the JAX package trains and writes its MODELDATA blob (a pickle),
the port reads it (``workflow/persistence.py::loads_jax_models``) and its
answers equal the JAX package's own (ids exactly, scores within 1e-5). An
old single-block seqrec blob serves through ``_compat_model``; a blob
naming any other global is refused before anything of it runs; a bf16
leaf is refused with a message. ``chip_smoke.py``'s stand-in pickler
writes the JAX package's layout (its bytes load in the JAX package's own
``loads_models``). Custom persistence (``controller/persistent.py``)."""

import dataclasses
import json
import pickle
from datetime import timedelta

import numpy as np
import pytest
import torch

import chip_smoke
import predictionio_tpu.templates.classification as jcl
import predictionio_tpu.templates.ecommerce as jec
import predictionio_tpu.templates.recommendation as jrec
import predictionio_tpu.templates.sequential as jsq
import predictionio_tpu.templates.similarproduct as jsp
import predictionio_tpu.workflow.persistence as jpersistence
from predictionio_tpu.controller.context import Context as JContext
from predictionio_tpu.data.datamap import DataMap as JDataMap
from predictionio_tpu.data.event import Event as JEvent
from predictionio_tpu.data.storage.base import App as JApp
from predictionio_tpu.data.storage.registry import Storage as JStorage
from predictionio_tpu.workflow.batch_predict import (
    batch_predict_lines as jbatch_predict_lines,
)
from predictionio_tpu_torch import cli
from predictionio_tpu_torch.controller import (
    LocalFileSystemPersistentModel,
    PersistentModel,
    PersistentModelManifest,
)
from predictionio_tpu_torch.controller.context import Context
from predictionio_tpu_torch.controller.persistent import (
    load_from_manifest,
    manifest_for,
)
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.models.als import ALSModel
from predictionio_tpu_torch.models.seqrec import _compat_model
from predictionio_tpu_torch.workflow.batch_predict import batch_predict_lines
from predictionio_tpu_torch.workflow.persistence import (
    dumps_models,
    loads_models,
    to_device,
    to_host,
)
from test_templates import (
    T0,
    classification_events,
    ecommerce_events,
    similarproduct_events,
)

MEM_ENV = {"PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"}
SCORE_RTOL = 1e-5


def rating_events():
    rng = np.random.default_rng(0)
    return [JEvent(event="rate", entity_type="user", entity_id=f"u{u}",
                   target_entity_type="item", target_entity_id=f"i{i}",
                   properties=JDataMap({"rating":
                                        float(rng.integers(1, 6))}),
                   event_time=T0)
            for u in range(30) for i in rng.choice(20, 6, replace=False)]


def sequence_events():
    out, t = [], T0
    for u in range(40):
        for j in range(8):
            out.append(JEvent(event="view", entity_type="user",
                              entity_id=f"u{u}", target_entity_type="item",
                              target_entity_id=f"i{(u + j) % 12}",
                              event_time=t))
            t += timedelta(seconds=7)
    return out


def port_event(e):
    return Event(event=e.event, entity_type=e.entity_type,
                 entity_id=e.entity_id,
                 target_entity_type=e.target_entity_type,
                 target_entity_id=e.target_entity_id,
                 properties=DataMap(e.properties.to_dict()),
                 event_time=e.event_time)


#: template -> (JAX factory module, its factory, app, events, variant,
#: queries)
TEMPLATES = {
    "recommendation": (
        jrec, "recommendation_engine", "app1", rating_events,
        {"algorithms": [{"name": "als", "params": {
            "rank": 4, "num_iterations": 3}}]},
        [{"user": "u1", "num": 4}, {"user": "u7", "num": 6,
                                    "blackList": ["i1"]}]),
    "ecommerce": (
        jec, "ecommerce_engine", "app4", ecommerce_events,
        {"algorithms": [{"name": "ecomm", "params": {
            "app_name": "app4", "rank": 4, "num_iterations": 3}}]},
        [{"user": "u0", "num": 4}, {"user": "u3", "num": 3},
         {"user": "nobody", "num": 3}]),
    "similarproduct": (
        jsp, "similarproduct_engine", "app3", similarproduct_events,
        {"algorithms": [
            {"name": "als", "params": {"rank": 4, "num_iterations": 3}},
            {"name": "cooccurrence", "params": {"n": 5}},
            {"name": "likealgo", "params": {"rank": 4,
                                            "num_iterations": 3}}]},
        [{"items": ["i0"], "num": 5}, {"items": ["i2", "i3"], "num": 4}]),
    "classification": (
        jcl, "classification_engine", "app2", classification_events,
        {"algorithms": [{"name": "naive", "params": {"lambda": 1.0}},
                        {"name": "randomforest", "params": {}}]},
        [{"attr0": 8, "attr1": 1, "attr2": 0},
         {"attr0": 0, "attr1": 2, "attr2": 9}]),
    "sequential": (
        jsq, "sequential_engine", "app5", sequence_events,
        {"datasource": {"params": {"app_name": "app5", "max_len": 8}},
         "algorithms": [{"name": "seqrec", "params": {
             "dim": 8, "heads": 2, "max_len": 8, "num_epochs": 1,
             "batch_size": 16, "n_negatives": 4}}]},
        [{"items": ["i3", "i4"], "num": 3}, {"user": "u1", "num": 3}]),
}


def variant_of(name):
    mod, factory, app, _, variant, _ = TEMPLATES[name]
    return {"id": name, "version": "1",
            "engineFactory": f"{mod.__name__}:{factory}",
            "datasource": {"params": {"app_name": app}}, **variant}


class Trained:
    """One template trained by the JAX package on its MEMORY store, the
    same events in a port MEMORY store."""

    def __init__(self, name):
        mod, factory, app, events_fn, _, queries = TEMPLATES[name]
        events = events_fn()
        self.queries = queries
        self.variant = variant_of(name)
        self.jstore = JStorage(env=MEM_ENV)
        japp = self.jstore.apps().insert(JApp(0, app))
        self.jstore.events().init(japp)
        self.jstore.events().insert_batch(events, japp)
        self.store = Storage(env=MEM_ENV)
        papp = self.store.apps().insert(App(0, app))
        self.store.events().init(papp)
        self.store.events().insert_batch([port_event(e) for e in events],
                                         papp)
        self.jctx = JContext(app_name=app, _storage=self.jstore)
        self.ctx = Context(device="cpu", app_name=app, _storage=self.store)
        self.jengine = getattr(mod, factory)()
        self.jep = self.jengine.params_from_variant(self.variant)
        self.jmodels = self.jengine.train(self.jctx, self.jep).models
        self.blob = jpersistence.dumps_models(self.jmodels)

    def jax_answers(self, models=None):
        return [json.loads(line)["prediction"]
                for line in jbatch_predict_lines(
                    self.jengine, self.jep,
                    self.jmodels if models is None else models,
                    [json.dumps(q) for q in self.queries], ctx=self.jctx)]

    def port_answers(self, blob=None):
        engine, ep = cli.engine_from_variant(self.variant)
        models = loads_models(self.blob if blob is None else blob)
        return [json.loads(line)["prediction"]
                for line in batch_predict_lines(
                    engine, ep, models, [json.dumps(q) for q in self.queries],
                    device="cpu", ctx=self.ctx)]


@pytest.fixture(scope="module")
def trained():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = Trained(name)
        return cache[name]

    return get


def assert_same_answer(got, want, path="answer"):
    """Ids and labels exactly, floats within 1e-5 * (1 + |want|)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_same_answer(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_answer(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert abs(got - want) <= SCORE_RTOL * (1 + abs(want)), \
            f"{path}: {got} != {want}"
    else:
        assert got == want, f"{path}: {got!r} != {want!r}"


@pytest.mark.parametrize("name", sorted(TEMPLATES))
def test_a_jax_blob_of_every_shipped_template_serves_alike(trained, name):
    t = trained(name)
    models = loads_models(t.blob)
    assert [type(m).__name__ for m in models] == \
        [type(m).__name__.replace("tuple", "SPCooccurrenceModel")
         for m in t.jmodels]
    got, want = t.port_answers(), t.jax_answers()
    assert any(want), want
    for g, w in zip(got, want):
        assert_same_answer(g, w)


@pytest.mark.parametrize("name", sorted(TEMPLATES))
def test_the_reader_resolves_only_the_listed_globals(trained, name):
    """The globals each template's blob names, found by walking it, are
    all in the reader's list (the list was taken from these blobs)."""
    from predictionio_tpu_torch.workflow import persistence

    seen = set()

    class Spy(pickle.Unpickler):
        def find_class(self, module, qual):
            seen.add((module, qual))
            return super().find_class(module, qual)

    import io
    Spy(io.BytesIO(trained(name).blob)).load()
    allowed = set(persistence._JAX_CLASSES) | set(persistence._NUMPY_GLOBALS)
    assert seen and seen <= allowed, seen - allowed


def test_an_old_single_block_seqrec_blob_serves(trained):
    """The first revision's unsuffixed weight keys and num_blocks-less
    params: the JAX package serves such a blob through its
    ``_compat_model``, and the port through its own."""
    t = trained("sequential")
    (m,) = t.jmodels
    p = m.params
    if p.num_blocks != 1:
        pytest.skip("the shipped variant trains one block here")
    ren = {"qkv0": "qkv", "attn_out0": "attn_out", "ff10": "ff1",
           "ff20": "ff2", "ln10": "ln1", "ln1b0": "ln1b", "ln20": "ln2",
           "ln2b0": "ln2b"}
    old_params = type(p).__new__(type(p))
    object.__setattr__(old_params, "__dict__", {
        k: v for k, v in vars(p).items() if k != "num_blocks"})
    old = dataclasses.replace(m, weights={ren.get(k, k): v
                                          for k, v in m.weights.items()})
    object.__setattr__(old, "params", old_params)
    blob = pickle.dumps([jpersistence.to_host(old)], protocol=4)
    (mine,) = loads_models(blob)
    assert "qkv" in mine.weights and _compat_model(mine).params.num_blocks == 1
    for g, w in zip(t.port_answers(blob), t.jax_answers([old])):
        assert_same_answer(g, w)


class _WritesAMarker:
    def __init__(self, path):
        self.path = path

    def __reduce__(self):
        return (open, (self.path, "w"))


@pytest.mark.parametrize("payload", ["reduce", "class", "persistent"])
def test_a_blob_naming_another_global_is_refused_before_it_runs(
        tmp_path, payload):
    marker = tmp_path / "marker"
    if payload == "reduce":
        blob = pickle.dumps([_WritesAMarker(str(marker))], protocol=4)
    elif payload == "class":
        blob = pickle.dumps([Storage], protocol=4)
    else:
        import io

        class P(pickle.Pickler):
            def persistent_id(self, obj):
                return "x" if obj == "secret" else None

        buf = io.BytesIO()
        P(buf, protocol=4).dump(["secret"])
        blob = buf.getvalue()
    with pytest.raises(ValueError, match="refused"):
        loads_models(blob)
    assert not marker.exists()


def test_a_bf16_leaf_is_refused_with_a_message():
    """No shipped template writes a bf16 leaf: the reader refuses one by
    name rather than guessing its layout."""
    import ml_dtypes
    from predictionio_tpu.models.als import ALSModel as JModel

    m = JModel(np.zeros((3, 2), dtype=ml_dtypes.bfloat16),
               np.zeros((2, 2), dtype=np.float32), 3, 2)
    with pytest.raises(ValueError, match="ml_dtypes.*no shipped template"):
        loads_models(jpersistence.dumps_models([m]))


def test_unknown_fields_and_pair_gram_mode(trained):
    t = trained("recommendation")
    (m,) = t.jmodels
    paired = dataclasses.replace(m, params=dataclasses.replace(
        m.params, gram_mode="pair"))
    (mine,) = loads_models(jpersistence.dumps_models([paired]))
    assert mine.params.gram_mode == "einsum"
    extra = jpersistence.to_host(m)
    object.__setattr__(extra, "__dict__", {**vars(extra), "surprise": 1})
    with pytest.raises(ValueError, match="surprise"):
        loads_models(pickle.dumps([extra], protocol=4))
    with pytest.raises(ValueError, match="not a model blob"):
        loads_models(b"garbage")


def test_the_stand_in_pickler_writes_the_jax_packages_layout(trained):
    """``chip_smoke.py``'s writer, fed a JAX-trained model's fields, gives
    bytes the JAX package's own ``loads_models`` reads back as that model,
    field by field; the port reads both alike."""
    t = trained("recommendation")
    (m,) = t.jmodels
    blob = chip_smoke.jax_layout_blob([chip_smoke.JaxALSModel(
        np.asarray(m.user_factors), np.asarray(m.item_factors), m.n_users,
        m.n_items, chip_smoke.JaxBiMap(m.user_ids.to_dict()),
        chip_smoke.JaxBiMap(m.item_ids.to_dict()),
        chip_smoke.JaxALSParams(**dataclasses.asdict(m.params)))])
    (back,) = jpersistence.loads_models(blob)
    (orig,) = jpersistence.loads_models(t.blob)
    assert type(back) is type(orig)
    assert set(vars(back)) == set(vars(orig))
    for k in ("user_factors", "item_factors"):
        np.testing.assert_array_equal(getattr(back, k), getattr(orig, k))
        assert getattr(back, k).dtype == getattr(orig, k).dtype
    assert (back.n_users, back.n_items, back.mesh) == \
        (orig.n_users, orig.n_items, orig.mesh)
    assert type(back.params) is type(orig.params) and back.params == \
        orig.params
    for k in ("user_ids", "item_ids"):
        assert type(getattr(back, k)) is type(getattr(orig, k))
        assert vars(getattr(back, k)) == vars(getattr(orig, k))
    (a,), (b,) = loads_models(blob), loads_models(t.blob)
    assert torch.equal(a.user_factors, b.user_factors)
    assert a.params == b.params and a.item_ids.to_dict() == \
        b.item_ids.to_dict()


def test_to_host_and_to_device_move_every_tensor():
    m = ALSModel(torch.ones(3, 2), torch.zeros(2, 2), 3, 2)
    h = to_host(m)
    assert h is not m and h.user_factors.device.type == "cpu"
    d = to_device((m, [torch.ones(1)], {"k": torch.ones(1)}), "cpu")
    assert isinstance(d[0], ALSModel) and d[1][0].device.type == "cpu"


# -- custom persistence --------------------------------------------------------

class Weights(LocalFileSystemPersistentModel):
    def __init__(self, t):
        self.t = t


def test_a_persistent_model_round_trips_through_its_manifest(
        tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_HOME", str(tmp_path))
    m = Weights(torch.arange(4.0))
    manifest = manifest_for(m, "inst1", 0)
    assert manifest.class_name.endswith(":Weights")
    assert manifest.location == str(tmp_path / "models" / "inst1-0.pkl")
    (back_manifest,) = loads_models(dumps_models([manifest]))
    assert isinstance(back_manifest, PersistentModelManifest)
    assert vars(back_manifest) == vars(manifest)
    back = load_from_manifest(back_manifest)
    assert isinstance(back, Weights) and torch.equal(back.t, m.t)
    with pytest.raises(TypeError, match="expected"):
        class Other(LocalFileSystemPersistentModel):
            pass

        Other.load_path(manifest.location)
    assert issubclass(Weights, PersistentModel)


def test_a_manifest_naming_a_jax_class_is_refused():
    with pytest.raises(ValueError, match="predictionio_tpu.templates.x:M"):
        load_from_manifest(PersistentModelManifest(
            "predictionio_tpu.templates.x:M", "i", 0))
