"""The sequential template on the port, held to the JAX package on the
CPU.

Same-seed numpy inputs go through the JAX function (``JAX_PLATFORMS=cpu``)
and the port's (torch on the CPU). Tolerances, each where it is used:

- ``ring_attention``: f32 within rtol 1e-5, atol 1e-6 of the JAX
  package's single-device path; bf16 outputs within one bf16 step of it
  (rtol 2**-7) and within 0.05 of the float64 dense reference, as the
  JAX package's own bf16 test holds them.
- ``_encode``: within atol 1e-5 (activations up to ~3).
- one train step: the loss within rtol 1e-6, every gradient within
  rtol 1e-5, atol 1e-6 (the reference's gradient is read back from its
  first-moment update, ``m / (1 - b1)``).
- Adam steps: after ``K`` steps every weight is within 1e-5 of the
  reference's where the reference's gradient was at least ``GRAD_FLOOR``
  in magnitude at each step; elsewhere Adam's ``m / sqrt(v)`` is about
  ``±1`` whatever the gradient's size, so one rounding can flip it and
  the allowance is ``2 * K * lr``.
- ``train_seqrec`` with both seams (the JAX package's initial weights
  and its negatives): per-epoch losses within rtol 1e-4, and the final
  weights within 1e-4 on 99% of entries and within ``2 * K * lr`` on all.
- serving: the top-k ids equal the JAX package's, ties included (lowest
  index first); scores within rtol 1e-5, atol 1e-6.
"""

import json
import sys
import types
import urllib.request
from datetime import datetime, timedelta, timezone
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import predictionio_tpu.data.storage.registry as jregistry
import predictionio_tpu.models.seqrec as jseq
import predictionio_tpu.ops.ring_attention as jring
import predictionio_tpu.templates.sequential as jtpl
from predictionio_tpu.controller.context import Context as JContext
from predictionio_tpu.controller.params import EngineParams as JEngineParams
from predictionio_tpu.data.event import Event as JEvent
from predictionio_tpu.data.storage.base import App as JApp
from predictionio_tpu.data.storage.registry import Storage as JStorage
from predictionio_tpu_torch import cli
from predictionio_tpu_torch.controller.context import Context
from predictionio_tpu_torch.controller.evaluation import Evaluation
from predictionio_tpu_torch.controller.params import EngineParams
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import registry
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.models import seqrec
from predictionio_tpu_torch.models.convert import seqrec_model_from_numpy
from predictionio_tpu_torch.ops.ring_attention import ring_attention
from predictionio_tpu_torch.templates import sequential as ptpl
from predictionio_tpu_torch.workflow.batch_predict import batch_predict_lines
from predictionio_tpu_torch.workflow.persistence import (
    dumps_models,
    loads_models,
)

ROOT = Path(__file__).resolve().parents[1]
T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
MEM_ENV = {"PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"}
J_MEM_ENV = {
    "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
}
_LOCAL = urllib.request.build_opener(urllib.request.ProxyHandler({}))
#: an Adam entry whose reference gradient stays at least this large
#: moves by the same sign in both packages
GRAD_FLOOR = 1e-5


# -- ring_attention -------------------------------------------------------------

def _qkv(B=2, S=12, H=2, D=4, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, S, H, D)).astype(dtype)
                 for _ in range(3))


def _key_valid(B, S, seed):
    """Random key masks, left-pad style in row 0 and every key masked in
    row 1 (each of its query rows sees no key)."""
    rng = np.random.default_rng(seed)
    kv = rng.random((B, S)) > 0.3
    kv[0, :S // 2] = False
    kv[1, :] = False
    return kv


def _port(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_ring_attention_matches_the_jax_single_device_path(causal, masked):
    q, k, v = _qkv(B=3, S=12, seed=1 + causal + 2 * masked)
    kv = _key_valid(3, 12, seed=5) if masked else None
    want = np.asarray(jring.ring_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mesh=None,
        causal=causal, key_valid=None if kv is None else jnp.asarray(kv)))
    got = ring_attention(_port(q), _port(k), _port(v), causal=causal,
                         key_valid=None if kv is None else _port(kv))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    if masked:
        # every key of row 1 is masked: 0, not NaN, in both packages
        assert np.all(got.numpy()[1] == 0) and np.all(want[1] == 0)


def test_ring_attention_bf16_inputs():
    q, k, v = _qkv(B=2, S=16, H=3, D=8, seed=7)
    want = np.asarray(jring.ring_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), mesh=None, causal=True),
        dtype=np.float32)
    got = ring_attention(*(_port(x).to(torch.bfloat16) for x in (q, k, v)),
                         causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=2 ** -7)
    # the float64 dense reference of the JAX package's own bf16 test
    s = np.einsum("bqhd,bkhd->bhqk", q, k).astype(np.float64) * 8 ** -0.5
    s = np.where(np.tril(np.ones((16, 16), bool))[None, None], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    ref = np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), v)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0.05,
                               atol=0.05)


def test_ring_attention_over_a_mesh_is_the_jax_single_device_path(
        monkeypatch):
    """The ring over 4 positions (``tests/test_torch_sequence_parallel.py``
    holds it to the JAX package's ring) gives the single-device answer."""
    from predictionio_tpu_torch import parallel as ppar

    monkeypatch.setenv(ppar.FORCE_DEVICE_COUNT_ENV, "4")
    q, k, v = _qkv()
    kv = _key_valid(2, 12, seed=5)
    want = np.asarray(jring.ring_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mesh=None,
        causal=True, key_valid=jnp.asarray(kv)))
    mesh = ppar.make_mesh(data=4, devices=ppar.local_devices("cpu"))
    got = ring_attention(_port(q), _port(k), _port(v), mesh=mesh,
                         causal=True, key_valid=_port(kv))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_the_gradient_through_fully_masked_rows_is_finite():
    """A left-padded window with a single real item: under causal and
    key-valid masking every pad query row sees no key; its scores are
    all -inf and the backward stays finite."""
    q, k, v = (_port(x).requires_grad_(True) for x in _qkv(B=1, S=6))
    kv = torch.tensor([[False] * 5 + [True]])
    out = ring_attention(q, k, v, causal=True, key_valid=kv)
    assert torch.all(out[0, :5] == 0)
    out.square().sum().backward()
    for t in (q, k, v):
        assert torch.isfinite(t.grad).all()


# -- the model ------------------------------------------------------------------

P_SMALL = dict(dim=16, heads=2, num_blocks=2, max_len=8, batch_size=4,
               n_negatives=5, learning_rate=1e-3, seed=3)
N_ITEMS = 12


def _params(**kw):
    args = {**P_SMALL, **kw}
    return jseq.SeqRecParams(**args), seqrec.SeqRecParams(**args)


def _windows(lengths, L, n_items, seed):
    """Left-padded windows of the given real lengths."""
    rng = np.random.default_rng(seed)
    seq = np.full((len(lengths), L), -1, np.int32)
    for r, n in enumerate(lengths):
        if n:
            seq[r, -n:] = rng.integers(0, n_items, n)
    return seq


def _jax_weights(jp, n_items):
    return {k: np.asarray(v) for k, v in
            jseq._init_weights(jax.random.key(jp.seed), n_items, jp).items()}


def _torch_weights(wn):
    return {k: torch.from_numpy(np.array(v)) for k, v in wn.items()}


def test_params_validate_as_in_the_jax_package():
    with pytest.raises(ValueError, match="divide"):
        seqrec.SeqRecParams(dim=10, heads=3)
    with pytest.raises(ValueError, match="num_blocks"):
        seqrec.SeqRecParams(num_blocks=0)


def test_init_weights_have_the_jax_names_shapes_and_scales():
    jp, pp = _params(dim=32, num_blocks=2, max_len=50)
    want = _jax_weights(jp, 500)
    got = seqrec._init_weights(500, pp)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        # the same scale: N(0, s) rows, ones and zeros for the norms
        np.testing.assert_allclose(got[name].std().item(), w.std(),
                                   rtol=0.2, atol=1e-6, err_msg=name)
    again = seqrec._init_weights(500, pp)
    assert all(torch.equal(again[k], got[k]) for k in got)


def test_sequences_from_ratings_is_the_jax_packages():
    rng = np.random.default_rng(2)
    users = rng.integers(0, 40, 600)
    items = rng.integers(0, 90, 600)
    times = rng.integers(0, 10_000, 600)
    for L in (5, 50):
        np.testing.assert_array_equal(
            seqrec.sequences_from_ratings(users, items, times, 41, L),
            jseq.sequences_from_ratings(users, items, times, 41, L))


def test_encode_matches_the_jax_package():
    """JAX weights carried across; ragged left-padded windows (a full
    one, partial ones, a single item), 2 blocks."""
    jp, pp = _params()
    wn = _jax_weights(jp, N_ITEMS)
    seq = _windows([8, 5, 2, 1], 8, N_ITEMS, seed=0)
    want = np.asarray(jseq._encode({k: jnp.asarray(v) for k, v in
                                    wn.items()}, jnp.asarray(seq), jp))
    got = seqrec._encode(_torch_weights(wn), torch.from_numpy(seq).long(),
                         pp)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def _jax_steps(jp, wn, seq, n_steps):
    """The reference's own ``_train_step`` ``n_steps`` times from ``wn``
    on one batch, with the key chain of ``train_seqrec``. Returns the
    negatives, losses, gradients (from the first moment) and weights of
    each step."""
    key = jax.random.key(jp.seed)
    w = {k: jnp.asarray(v) for k, v in wn.items()}
    m = {k: jnp.zeros_like(v) for k, v in w.items()}
    v = {k: jnp.zeros_like(x) for k, x in w.items()}
    step = jnp.zeros((), jnp.int32)
    out = []
    shape = (seq.shape[0], seq.shape[1] - 1, jp.n_negatives)
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        negs = np.array(jax.random.randint(sub, shape, 0, N_ITEMS))
        m_prev = {k: np.asarray(x) for k, x in m.items()}
        w, m, v, step, loss = jseq._train_step(
            w, m, v, step, jnp.asarray(seq), sub, jp, N_ITEMS)
        grads = {k: (np.asarray(m[k]) - 0.9 * m_prev[k]) / np.float32(0.1)
                 for k in m}
        out.append((negs, float(loss), grads,
                    {k: np.asarray(x) for k, x in w.items()}))
    return out


def test_one_train_step_loss_and_gradients_match():
    jp, pp = _params()
    wn = _jax_weights(jp, N_ITEMS)
    # a window that is all padding but one item among the rows
    seq = _windows([8, 6, 3, 1], 8, N_ITEMS, seed=4)
    (negs, want_loss, want_grads, _), = _jax_steps(jp, wn, seq, 1)
    loss, grads = seqrec.loss_and_grads(
        _torch_weights(wn), torch.from_numpy(seq).long(),
        torch.from_numpy(negs).long(), pp)
    assert float(loss) == pytest.approx(want_loss, rel=1e-6)
    assert sorted(grads) == sorted(want_grads)
    for name, g in grads.items():
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), want_grads[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_three_adam_steps_match_under_the_sign_rule():
    K = 3
    jp, pp = _params()
    wn = _jax_weights(jp, N_ITEMS)
    seq = _windows([8, 7, 4, 2], 8, N_ITEMS, seed=6)
    ref = _jax_steps(jp, wn, seq, K)
    w = _torch_weights(wn)
    m = {k: torch.zeros_like(x) for k, x in w.items()}
    v = {k: torch.zeros_like(x) for k, x in w.items()}
    xb = torch.from_numpy(seq).long()
    for step, (negs, want_loss, _, _) in enumerate(ref):
        loss = seqrec.train_step(w, m, v, step, xb,
                                 torch.from_numpy(negs).long(), pp)
        assert float(loss) == pytest.approx(want_loss, rel=1e-5)
    want = ref[-1][3]
    for name, x in w.items():
        sure = np.ones(x.shape, bool)
        for _, _, grads, _ in ref:
            sure &= np.abs(grads[name]) >= GRAD_FLOOR
        err = np.abs(x.numpy() - want[name])
        assert np.all(err[sure] <= 1e-5), (name, err[sure].max())
        assert np.all(err <= 2 * K * pp.learning_rate), (name, err.max())


def test_adam_keeps_the_clamps():
    """A step count of 0 divides by the 1e-9 floor, not by 0, and a
    -0-ish second moment goes through the sqrt as 0."""
    w = {"a": torch.zeros(3)}
    m = {"a": torch.zeros(3)}
    v = {"a": torch.tensor([-1e-30, 0.0, 0.0])}
    seqrec.adam_update(w, m, v, {"a": torch.tensor([0.0, 1e-3, -1e-3])},
                       step=0, learning_rate=1e-3)
    assert torch.isfinite(w["a"]).all()
    assert seqrec._bias_correction(0.9, 0) == pytest.approx(1e-9)


def _key_chain_sampler(seed, n_items):
    """The JAX package's negatives: ``key, sub = split(key)`` a step
    from ``key(seed)``, then ``randint(sub, ...)``."""
    state = {"key": jax.random.key(seed)}

    def sample(step, shape):
        state["key"], sub = jax.random.split(state["key"])
        return torch.from_numpy(np.asarray(
            jax.random.randint(sub, shape, 0, n_items))).long()

    return sample


@pytest.mark.parametrize("n_rows", [30, 3])
def test_train_seqrec_with_both_seams_is_the_jax_training(n_rows):
    """With the JAX initial weights and negatives the port runs the
    reference's training: the same batches (the numpy permutation), the
    same steps; 3 rows take the partial-batch branch."""
    jp, pp = _params(num_epochs=3, batch_size=8)
    lengths = np.random.default_rng(8).integers(1, 9, n_rows)
    lengths[:2] = (8, 2)
    seqs = _windows(lengths, 8, N_ITEMS, seed=9)
    jmodel, jlosses = jseq.train_seqrec(seqs, N_ITEMS, jp)
    model, losses = seqrec.train_seqrec(
        seqs, N_ITEMS, pp, device="cpu",
        init=_jax_weights(jp, N_ITEMS),
        negatives=_key_chain_sampler(jp.seed, N_ITEMS))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    steps = 3 * max((len(seqs[(seqs >= 0).sum(1) >= 2]) // 8), 1)
    for name, x in model.weights.items():
        err = np.abs(x.numpy() - np.asarray(jmodel.weights[name]))
        assert np.mean(err <= 1e-4) >= 0.99, (name, err.max())
        assert np.all(err <= 2 * steps * pp.learning_rate), name


def test_train_seqrec_refuses_sequences_too_short():
    _, pp = _params()
    with pytest.raises(ValueError, match="length 2"):
        seqrec.train_seqrec(_windows([1, 1], 8, N_ITEMS, 0), N_ITEMS, pp,
                            device="cpu")


def test_train_seqrec_raises_without_cuda_unless_asked_for_the_cpu(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pp = _params()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        seqrec.train_seqrec(_windows([3, 4], 8, N_ITEMS, 0), N_ITEMS, pp)


# -- serving --------------------------------------------------------------------

def _tied_model(jp):
    """JAX weights whose item table holds duplicated rows, so whole
    groups of items score the same."""
    wn = _jax_weights(jp, N_ITEMS)
    emb = wn["item_emb"].copy()
    emb[7] = emb[3]
    emb[9] = emb[3]
    emb[5] = emb[2]
    wn["item_emb"] = emb
    jmodel = jseq.SeqRecModel(weights={k: jnp.asarray(v)
                                       for k, v in wn.items()},
                              n_items=N_ITEMS, params=jp)
    return wn, jmodel


def test_recommend_next_batch_ids_are_the_jax_packages_ties_included():
    jp, pp = _params()
    wn, jmodel = _tied_model(jp)
    model = seqrec_model_from_numpy(wn, N_ITEMS, None, pp, device="cpu")
    hists = [[3], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10], [11, 0], [5, 5, 5], [],
             [2]]
    for k in (1, 3, 6, N_ITEMS, N_ITEMS + 5):
        ids, scores = seqrec.recommend_next_batch(model, hists, k)
        jids, jscores = jseq.recommend_next_batch(jmodel, hists, k)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_allclose(scores, jscores, rtol=1e-5, atol=1e-6)
    ids, scores = seqrec.recommend_next_batch(model, hists, N_ITEMS)
    # the tied groups come out lowest index first
    for row in ids:
        pos = {int(i): n for n, i in enumerate(row)}
        assert pos[3] < pos[7] < pos[9] and pos[2] < pos[5]


def test_recommend_next_batch_equals_single():
    _, pp = _params()
    wn = _jax_weights(_params()[0], N_ITEMS)
    model = seqrec_model_from_numpy(wn, N_ITEMS, None, pp, device="cpu")
    hists = [[1, 2], [4], [0, 11, 3, 7, 2, 2, 9, 1, 6, 5]]
    ids, scores = seqrec.recommend_next_batch(model, hists, 5)
    for row, h in enumerate(hists):
        i1, s1 = seqrec.recommend_next(model, h, 5)
        np.testing.assert_array_equal(i1, ids[row])
        np.testing.assert_allclose(s1, scores[row], rtol=1e-6, atol=1e-7)


def test_recommend_next_batch_bound_raises():
    _, pp = _params()
    model = seqrec_model_from_numpy(_jax_weights(_params()[0], N_ITEMS),
                                    N_ITEMS, None, pp, device="cpu")
    with pytest.raises(ValueError, match="per-dispatch bound"):
        seqrec.recommend_next_batch(model, [[]] * ((1 << 16) + 1))


# -- the template end to end ------------------------------------------------------

APP = "seqapp"


def cycle_events():
    """Users walk an item cycle i -> (i+1) % 24 (``tests/
    test_sequential.py``'s stream)."""
    rng = np.random.default_rng(4)
    out, t = [], T0
    for u in range(300):
        start = int(rng.integers(0, 24))
        for j in range(int(rng.integers(6, 16))):
            out.append(dict(event="view", entity_type="user",
                            entity_id=f"u{u}", target_entity_type="item",
                            target_entity_id=f"i{(start + j) % 24}",
                            event_time=t))
            t += timedelta(seconds=7)
    return out


class Pair:
    """The same app and events in a MEMORY store of each package."""

    def __init__(self, events):
        self.store = Storage(env=MEM_ENV)
        app_id = self.store.apps().insert(App(0, APP))
        self.store.events().init(app_id)
        self.store.events().insert_batch([Event(**e) for e in events],
                                         app_id)
        self.jstore = JStorage(env=J_MEM_ENV)
        japp_id = self.jstore.apps().insert(JApp(0, APP))
        self.jstore.events().init(japp_id)
        self.jstore.events().insert_batch([JEvent(**e) for e in events],
                                          japp_id)
        self.ctx = Context(device="cpu", app_name=APP, _storage=self.store)
        self.jctx = JContext(app_name=APP, _storage=self.jstore)


@pytest.fixture(scope="module")
def pair():
    return Pair(cycle_events())


SEQ_PARAMS = dict(dim=32, heads=2, max_len=16, num_epochs=6, batch_size=64,
                  learning_rate=3e-3, n_negatives=16, seed=2)


def _ep(pkg, params_cls, **kw):
    return pkg_ep(pkg, params_cls(**{**SEQ_PARAMS, **kw}))


def pkg_ep(pkg, params):
    cls = JEngineParams if pkg is jtpl else EngineParams
    return cls(datasource=("", pkg.DataSourceParams(app_name=APP,
                                                    max_len=16,
                                                    eval_query_num=5)),
               algorithms=[("seqrec", params)])


@pytest.fixture(scope="module")
def trained(pair):
    """The JAX engine's model, and the port's model carrying its
    weights (the two packages' own draws differ)."""
    ep = _ep(jtpl, jseq.SeqRecParams)
    jmodel = jtpl.sequential_engine().train(pair.jctx, ep).models[0]
    model = seqrec_model_from_numpy(
        {k: np.asarray(v) for k, v in jmodel.weights.items()},
        jmodel.n_items, jmodel.item_ids.to_dict(),
        seqrec.SeqRecParams(**SEQ_PARAMS), events=jmodel.events,
        app_name=jmodel.app_name, device="cpu")
    return model, jmodel


def _algos(pair):
    algo = ptpl.sequential_engine().make_algorithms(
        _ep(ptpl, seqrec.SeqRecParams))[0]
    jalgo = jtpl.sequential_engine().make_algorithms(
        _ep(jtpl, jseq.SeqRecParams))[0]
    algo.bind_serving(pair.ctx)
    jalgo.bind_serving(pair.jctx)
    return algo, jalgo


def assert_same(mine, theirs):
    assert [s.item for s in mine.item_scores] == \
        [s.item for s in theirs.item_scores]
    np.testing.assert_allclose([s.score for s in mine.item_scores],
                               [s.score for s in theirs.item_scores],
                               rtol=1e-5, atol=1e-6)


def test_training_reads_the_jax_packages_sequences(pair):
    td = ptpl.SequentialDataSource(ptpl.DataSourceParams(
        app_name=APP, max_len=16)).read_training(pair.ctx)
    jtd = jtpl.SequentialDataSource(jtpl.DataSourceParams(
        app_name=APP, max_len=16)).read_training(pair.jctx)
    np.testing.assert_array_equal(td.sequences, jtd.sequences)
    assert td.item_ids.to_dict() == jtd.item_ids.to_dict()
    assert (td.n_items, td.events, td.app_name) == \
        (jtd.n_items, jtd.events, jtd.app_name)


QUERIES = {
    "items": dict(items=("i3", "i4", "i5"), num=3),
    "items_keep_known": dict(items=("i3", "i4"), num=6,
                             exclude_known=False),
    "items_unknown_dropped": dict(items=("i9", "zzz"), num=4),
    "user": dict(user="u0", num=4),
    "user_many": dict(user="u7", num=20),
    "unknown_user": dict(user="nobody", num=3),
    "empty": dict(num=3),
}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_template_answers_as_the_jax_package(pair, trained, name):
    model, jmodel = trained
    algo, jalgo = _algos(pair)
    mine = algo.predict(model, ptpl.Query(**QUERIES[name]))
    theirs = jalgo.predict(jmodel, jtpl.Query(**QUERIES[name]))
    assert_same(mine, theirs)
    if name in ("unknown_user", "empty"):
        assert mine.item_scores == ()
    else:
        assert mine.item_scores


def test_a_user_query_reads_the_serving_history(pair, trained):
    """u0's history comes from the bound store: its latest items are
    excluded, and a store without the app gives an empty answer."""
    model, _ = trained
    algo, _ = _algos(pair)
    seen = {e.target_entity_id for e in pair.store.events().find(1)
            if e.entity_id == "u0"}
    got = algo.predict(model, ptpl.Query(user="u0", num=24))
    assert got.item_scores
    assert not {s.item for s in got.item_scores} & seen
    algo.bind_serving(Context(device="cpu", _storage=Storage(env=MEM_ENV)))
    assert algo.predict(model, ptpl.Query(user="u0")).item_scores == ()


def test_batch_predict_equals_single_and_the_jax_package(pair, trained):
    model, jmodel = trained
    algo, jalgo = _algos(pair)
    qs = [QUERIES[n] for n in sorted(QUERIES)]
    batch = algo.batch_predict(model, [ptpl.Query(**q) for q in qs])
    jbatch = jalgo.batch_predict(jmodel, [jtpl.Query(**q) for q in qs])
    for q, b, jb in zip(qs, batch, jbatch):
        assert_same(b, algo.predict(model, ptpl.Query(**q)))
        assert_same(b, jb)


def test_read_eval_folds_are_the_jax_packages(pair):
    ds = ptpl.SequentialDataSource(ptpl.DataSourceParams(
        app_name=APP, max_len=16, eval_query_num=5))
    jds = jtpl.SequentialDataSource(jtpl.DataSourceParams(
        app_name=APP, max_len=16, eval_query_num=5))
    (td, ei, qa), = ds.read_eval(pair.ctx)
    (jtd, jei, jqa), = jds.read_eval(pair.jctx)
    np.testing.assert_array_equal(td.sequences, jtd.sequences)
    assert ei.n_users == jei.n_users == len(qa) == len(jqa)
    for (q, a), (jq, ja) in zip(qa, jqa):
        assert (q.items, q.num, q.exclude_known, a.item) == \
            (jq.items, jq.num, jq.exclude_known, ja.item)


def test_metrics_are_the_jax_packages(pair, trained):
    """HitRate@5 and SeqNDCG@5 over the leave-one-out queries, each
    package scoring its own answers from the same weights."""
    model, jmodel = trained
    algo, jalgo = _algos(pair)
    (_, ei, qa), = ptpl.SequentialDataSource(ptpl.DataSourceParams(
        app_name=APP, max_len=16, eval_query_num=5)).read_eval(pair.ctx)
    (_, jei, jqa), = jtpl.SequentialDataSource(jtpl.DataSourceParams(
        app_name=APP, max_len=16, eval_query_num=5)).read_eval(pair.jctx)
    preds = algo.batch_predict(model, [q for q, _ in qa])
    jpreds = jalgo.batch_predict(jmodel, [q for q, _ in jqa])
    data = [(ei, [(q, p, a) for (q, a), p in zip(qa, preds)])]
    jdata = [(jei, [(q, p, a) for (q, a), p in zip(jqa, jpreds)])]
    for mine, theirs in ((ptpl.HitRateAtK(5), jtpl.HitRateAtK(5)),
                         (ptpl.SeqNDCGAtK(5), jtpl.SeqNDCGAtK(5))):
        assert mine.header == theirs.header
        got, want = mine.calculate(data), theirs.calculate(jdata)
        assert got == pytest.approx(want, rel=1e-12)
    assert ptpl.HitRateAtK(5).calculate(data) > 0.5


def test_the_model_file_round_trips(pair, trained):
    model, _ = trained
    (back,) = loads_models(dumps_models([model]))
    assert isinstance(back, seqrec.SeqRecModel)
    assert sorted(back.weights) == sorted(model.weights)
    for k, w in model.weights.items():
        assert torch.equal(back.weights[k], w.cpu())
    assert (back.n_items, back.params, back.events, back.app_name) == \
        (model.n_items, model.params, model.events, model.app_name)
    assert back.item_ids.to_dict() == model.item_ids.to_dict()
    algo, _ = _algos(pair)
    back = algo.prepare_serving_model(back, torch.device("cpu"))
    q = ptpl.Query(items=("i1", "i2"), num=5)
    assert algo.predict(back, q) == algo.predict(model, q)


def test_learns_successor_structure_with_the_ports_own_draws(pair):
    """Trained through the engine with the port's own generators, the
    model learns the cycle to the JAX package's test bar."""
    engine = ptpl.sequential_engine()
    ep = _ep(ptpl, seqrec.SeqRecParams)
    model = engine.train(pair.ctx, ep).models[0]
    algo = engine.make_algorithms(ep)[0]
    hits = 0
    for s in (3, 11, 19):
        pred = algo.predict(model, ptpl.Query(
            items=(f"i{s}", f"i{s + 1}", f"i{s + 2}"), num=3))
        top = [x.item for x in pred.item_scores]
        assert pred.item_scores and f"i{s + 2}" not in top
        hits += f"i{(s + 3) % 24}" in top[:2]
    assert hits >= 2, "successor structure not learned"


def test_the_template_trains_over_the_contexts_mesh(pair, mesh8,
                                                   monkeypatch):
    """``tests/test_sequential.py``'s ``mesh8`` case: the engine trains
    over ``ctx.mesh``. With the JAX package's initial weights and
    negatives the port's 8 positions land on the JAX package's
    ``mesh8`` training within the seam test's limits, and answer."""
    from predictionio_tpu_torch import parallel as ppar

    monkeypatch.setenv(ppar.FORCE_DEVICE_COUNT_ENV, "8")
    ep = _ep(jtpl, jseq.SeqRecParams)
    jctx = JContext(app_name=APP, _storage=pair.jstore, mesh=mesh8)
    jmodel = jtpl.sequential_engine().train(jctx, ep).models[0]
    jp = ep.algorithms[0][1]
    wn = {k: np.asarray(v) for k, v in jseq._init_weights(
        jax.random.key(jp.seed), jmodel.n_items, jp).items()}
    monkeypatch.setattr(seqrec, "_init_weights",
                        lambda n, p: _torch_weights(wn))
    monkeypatch.setattr(seqrec, "default_negatives",
                        lambda n, seed, dev: _key_chain_sampler(seed, n))
    mesh = ppar.make_mesh(data=4, model=2,
                          devices=ppar.local_devices("cpu"))
    ctx = Context(device="cpu", app_name=APP, _storage=pair.store,
                  mesh=mesh)
    engine = ptpl.sequential_engine()
    pep = _ep(ptpl, seqrec.SeqRecParams)
    model = engine.train(ctx, pep).models[0]
    n_rows = len(ptpl.SequentialDataSource(ptpl.DataSourceParams(
        app_name=APP, max_len=16)).read_training(pair.ctx).sequences)
    steps = SEQ_PARAMS["num_epochs"] * max(
        n_rows // SEQ_PARAMS["batch_size"], 1)
    for name, x in model.weights.items():
        err = np.abs(x.numpy() - np.asarray(jmodel.weights[name]))
        assert np.mean(err <= 1e-4) >= 0.99, (name, err.max())
        assert np.all(err <= 2 * steps * SEQ_PARAMS["learning_rate"]), name
    pred = engine.make_algorithms(pep)[0].predict(
        model, ptpl.Query(items=("i5", "i6"), num=3))
    assert pred.item_scores


def test_batch_predict_job_binds_the_context(pair, trained):
    model, _ = trained
    engine = ptpl.sequential_engine()
    lines = [json.dumps({"user": "u0", "num": 4}),
             json.dumps({"items": ["i3", "i4"], "num": 2})]
    out = batch_predict_lines(engine, _ep(ptpl, seqrec.SeqRecParams),
                              [model], lines, device="cpu", ctx=pair.ctx)
    algo, _ = _algos(pair)
    for line, got in zip(lines, out):
        want = algo.predict(model, ptpl.Query(**json.loads(line)))
        got = json.loads(got)["prediction"]["itemScores"]
        assert got
        assert_same(ptpl.PredictedResult(tuple(
            ptpl.ItemScore(s["item"], s["score"]) for s in got)), want)


# -- cli train, deploy and eval of the shipped variant ----------------------------------

@pytest.fixture
def home(tmp_path, monkeypatch):
    monkeypatch.setattr(registry, "_global", Storage(env=MEM_ENV))
    monkeypatch.setattr(jregistry, "_global", JStorage(env=J_MEM_ENV))
    st = Storage(env={"PIO_HOME": str(tmp_path / "home")})
    yield st
    st.close()


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/queries.json",
                                 data=json.dumps(body).encode(),
                                 method="POST")
    with _LOCAL.open(req, timeout=60) as resp:
        return json.loads(resp.read())


def test_cli_train_deploy_and_eval_the_shipped_variant(home, tmp_path,
                                                       capsys, monkeypatch):
    """``examples/sequential/engine.json`` unchanged: train, deploy,
    answer over HTTP as the bound model answers in-process; then ``cli
    eval`` of the port's shipped evaluation on a grid cut to one small
    params set."""
    path = ROOT / "examples" / "sequential" / "engine.json"
    variant = json.loads(path.read_text())
    app = variant["datasource"]["params"]["app_name"]
    assert cli.main(["app", "new", app], storage=home) == 0
    app_id = home.apps().get_by_name(app).id
    home.events().insert_batch([Event(**e) for e in cycle_events()],
                               app_id)
    assert cli.main(["train", "--engine-json", str(path), "--device",
                     "cpu"], storage=home) == 0
    assert "Training completed" in capsys.readouterr().out
    args = cli._parser().parse_args([
        "deploy", "--engine-json", str(path), "--device", "cpu", "--ip",
        "127.0.0.1", "--port", "0"])
    srv = cli.build_deploy(args, home).start_background()
    try:
        (model,) = srv.query_server.models
        assert isinstance(model, seqrec.SeqRecModel)
        assert model.params.dim == 64 and model.params.num_blocks == 2
        algo = ptpl.sequential_engine().make_algorithms(
            ptpl.sequential_engine().params_from_variant(variant))[0]
        algo.bind_serving(Context(device="cpu", app_name=app,
                                  _storage=home))
        for q in ({"user": "u0", "num": 4}, {"user": "u5", "num": 10},
                  {"items": ["i3", "i4"], "num": 3},
                  {"user": "nobody", "num": 2}):
            got = _post(srv.port, q)
            want = algo.predict(model, ptpl.Query(**q)).to_json()
            assert [s["item"] for s in got["itemScores"]] == \
                [s["item"] for s in want["itemScores"]]
    finally:
        srv.close()
    # cli eval of the port's shipped evaluation, on a grid of one
    import predictionio_tpu_torch.examples.sequential_evaluation as ex
    mod = types.ModuleType("seq_eval_small")
    mod.evaluation = ex.evaluation
    mod.gen = types.SimpleNamespace(engine_params_list=[EngineParams(
        datasource=("", ptpl.DataSourceParams(app_name=app, max_len=16,
                                              eval_query_num=10)),
        algorithms=[("seqrec", seqrec.SeqRecParams(**SEQ_PARAMS))])])
    monkeypatch.setitem(sys.modules, "seq_eval_small", mod)
    assert isinstance(ex.evaluation, Evaluation)
    assert cli.main(["eval", "seq_eval_small:evaluation",
                     "seq_eval_small:gen", "--device", "cpu"],
                    storage=home) == 0
    out = capsys.readouterr().out
    assert "HitRate@10" in out and "best variant 0" in out
