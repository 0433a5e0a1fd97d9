"""Checkpoint resume and the split history layout of the port's ALS,
held to the JAX package's: ``workflow/checkpoint.py`` after
``tests/test_checkpoint.py``'s cases (plus the torn-step walk-back and the
orbax-directory refusal), the run fingerprint bit for bit, the split
packing's arrays, and split training, explicit and implicit, from the
JAX package's initial draw."""

import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch

import predictionio_tpu.models.als as jals
import predictionio_tpu.ops.ragged as jragged
from predictionio_tpu_torch import faults
from predictionio_tpu_torch.faults import FaultError
from predictionio_tpu_torch.models import als
from predictionio_tpu_torch.ops import ragged
from predictionio_tpu_torch.workflow.checkpoint import (
    Checkpointer,
    make_checkpointer,
)

#: ``tests/test_checkpoint.py::test_resume_matches_uninterrupted``'s limits
RTOL, ATOL = 1e-4, 1e-5
#: ``tests/test_torch_als_training.py::test_factors_match_jax``'s limits for
#: six iterations of the port against the JAX package (another kernel,
#: another order of sums)
PARITY_RTOL, PARITY_ATOL = 2e-3, 2e-4


def _jax_draw(seed, n_u, n_u_pad, n_i, n_i_pad, rank):
    """The JAX package's initial draw for these shapes, padded to the
    port's rows."""
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
    yield
    faults.clear()


def ratings_fixture(pkg=als):
    """``tests/test_checkpoint.py``'s problem."""
    rng = np.random.default_rng(4)
    nnz = 800
    return pkg.RatingsCOO(
        users=rng.integers(0, 30, nnz).astype(np.int32),
        items=rng.integers(0, 20, nnz).astype(np.int32),
        ratings=rng.uniform(1, 5, nnz).astype(np.float32),
        n_users=30, n_items=20)


def skewed(pkg=als, seed=7):
    """Zipf-skewed histories: long rows split into several virtual rows."""
    rng = np.random.default_rng(seed)
    nnz, n_u, n_i = 4000, 120, 60
    return pkg.RatingsCOO(
        users=(rng.zipf(1.4, nnz) % n_u).astype(np.int32),
        items=(rng.zipf(1.3, nnz) % n_i).astype(np.int32),
        ratings=rng.uniform(1, 5, nnz).astype(np.float32),
        n_users=n_u, n_items=n_i)


def train(ratings, **kw):
    ckpt = {k: kw.pop(k) for k in ("checkpoint_dir", "checkpoint_every")
            if k in kw}
    return als.train_als(ratings, als.ALSParams(**kw), device="cpu", **ckpt)


# -- the Checkpointer ----------------------------------------------------------

def test_save_restore_latest(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "ck"))
    state = {"a": np.arange(5.0), "b": 3}
    ckpt.save(2, state)
    ckpt.save(4, {"a": np.arange(5.0) * 2, "b": 7})
    assert ckpt.latest_step() == 4
    got = ckpt.restore(4, like=state)
    np.testing.assert_array_equal(got["a"], np.arange(5.0) * 2)
    assert int(got["b"]) == 7
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    ckpt.save(5, {"t": t})
    back = ckpt.restore(5, like={"t": torch.zeros(2, 3)})["t"]
    assert isinstance(back, torch.Tensor) and torch.equal(back, t)
    with pytest.raises(ValueError, match="expected"):
        ckpt.restore(5, like={"t": torch.zeros(3, 2)})
    assert sorted(os.listdir(ckpt.directory)) == ["step_4.npz", "step_5.npz"]
    ckpt.close()


def test_maybe_save_cadence(tmp_path):
    ckpt = make_checkpointer(str(tmp_path / "ck"))
    assert not ckpt.maybe_save(1, {"x": 1}, every=2)
    assert ckpt.maybe_save(2, {"x": 1}, every=2)
    assert not ckpt.maybe_save(3, {"x": 1}, every=0)
    assert ckpt.latest_step() == 2


def test_state_is_data_only(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "ck"))
    with pytest.raises(TypeError, match="only bool, int and float"):
        ckpt.save(1, {"o": np.array([{"a": 1}], dtype=object)})
    assert ckpt.all_steps() == []


def test_a_torn_step_falls_back_to_the_one_before(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "ck"), keep=3)
    ckpt.save(1, {"x": np.ones(3)})
    ckpt.save(2, {"x": np.full(3, 2.0)})
    (tmp_path / "ck" / "step_3.npz").write_bytes(b"PK\x03\x04torn")
    step, state = ckpt.restore_latest(like={"x": np.zeros(3)})
    assert step == 2 and state["x"].tolist() == [2.0, 2.0, 2.0]
    step, state = ckpt.restore_latest(max_step=1)
    assert step == 1
    assert Checkpointer(str(tmp_path / "empty")).restore_latest() == (0, None)


def test_a_failed_commit_keeps_the_previous_step(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "ck"))
    ckpt.save(1, {"x": np.ones(2)})
    faults.inject_spec("checkpoint.commit=error,times=1")
    with pytest.raises(FaultError):
        ckpt.save(2, {"x": np.zeros(2)})
    assert ckpt.all_steps() == [1]
    assert not [n for n in os.listdir(ckpt.directory) if ".tmp" in n]
    ckpt.set_metadata({"fingerprint": "f"})
    assert ckpt.get_metadata() == {"fingerprint": "f"}


def test_an_orbax_directory_is_refused(tmp_path):
    (tmp_path / "ck" / "3").mkdir(parents=True)
    with pytest.raises(RuntimeError, match=r"holds orbax checkpoints "
                       r"\(steps \['3'\]\)"):
        Checkpointer(str(tmp_path / "ck"))
    with pytest.raises(RuntimeError, match="orbax"):
        train(ratings_fixture(), rank=4, num_iterations=1,
              checkpoint_dir=str(tmp_path / "ck"))


# -- ALS resume ------------------------------------------------------------------

def test_resume_matches_uninterrupted(tmp_path):
    """Bitwise in the port; the JAX package's uninterrupted run within the
    port's ALS parity limits."""
    ratings = ratings_fixture()
    U_ref, V_ref = train(ratings, rank=6, num_iterations=6, seed=2)
    ckdir = str(tmp_path / "als_ck")
    train(ratings, rank=6, num_iterations=3, seed=2, checkpoint_dir=ckdir,
          checkpoint_every=1)
    U2, V2 = train(ratings, rank=6, num_iterations=6, seed=2,
                   checkpoint_dir=ckdir, checkpoint_every=1)
    assert torch.equal(U_ref, U2) and torch.equal(V_ref, V2)
    jU, jV = jals.train_als(ratings_fixture(jals),
                            jals.ALSParams(rank=6, num_iterations=6, seed=2))
    np.testing.assert_allclose(U2.numpy(), np.asarray(jU), rtol=PARITY_RTOL,
                               atol=PARITY_ATOL)
    np.testing.assert_allclose(V2.numpy(), np.asarray(jV), rtol=PARITY_RTOL,
                               atol=PARITY_ATOL)


def test_a_crash_mid_run_resumes_bitwise(tmp_path):
    """The run dies as step 3 commits; a torn step 3 is left behind; the
    resumed call skips it, restarts at 2 and ends where an uninterrupted
    run ends, running only the iterations left."""
    ratings = ratings_fixture()
    ckdir = tmp_path / "crash"
    faults.inject_spec("checkpoint.commit=error,after=2,times=1")
    with pytest.raises(FaultError):
        train(ratings, rank=4, num_iterations=5, checkpoint_dir=str(ckdir))
    faults.clear()
    assert Checkpointer(str(ckdir)).all_steps() == [1, 2]
    (ckdir / "step_3.npz").write_bytes(b"PK\x03\x04torn")
    calls = []
    orig = als._update_side

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    als._update_side = counted
    try:
        U, V = train(ratings, rank=4, num_iterations=5,
                     checkpoint_dir=str(ckdir))
    finally:
        als._update_side = orig
    assert len(calls) == 2 * 3
    U0, V0 = train(ratings, rank=4, num_iterations=5)
    assert torch.equal(U, U0) and torch.equal(V, V0)


def test_completed_checkpoint_short_circuits(tmp_path):
    ratings = ratings_fixture()
    ckdir = str(tmp_path / "als_done")
    U1, V1 = train(ratings, rank=4, num_iterations=2, seed=1,
                   checkpoint_dir=ckdir, checkpoint_every=1)
    U2, V2 = train(ratings, rank=4, num_iterations=2, seed=1,
                   checkpoint_dir=ckdir, checkpoint_every=1)
    assert torch.equal(U1, U2) and torch.equal(V1, V2)


def test_foreign_checkpoint_rejected(tmp_path):
    ratings = ratings_fixture()
    ckdir = str(tmp_path / "guard")
    train(ratings, rank=4, num_iterations=2, seed=1, checkpoint_dir=ckdir)
    with pytest.raises(ValueError, match="different ALS run"):
        train(ratings, rank=6, num_iterations=2, seed=1,
              checkpoint_dir=ckdir)
    with pytest.raises(ValueError, match="different ALS run"):
        train(skewed(), rank=4, num_iterations=2, seed=1,
              checkpoint_dir=ckdir)


def test_checkpoint_dir_without_every_still_saves(tmp_path):
    ckdir = str(tmp_path / "implied")
    train(ratings_fixture(), rank=4, num_iterations=3, seed=1,
          checkpoint_dir=ckdir)
    assert Checkpointer(ckdir).latest_step() == 3


def test_larger_step_than_budget_ignored(tmp_path):
    ratings = ratings_fixture()
    ckdir = str(tmp_path / "budget")
    train(ratings, rank=4, num_iterations=5, seed=1, checkpoint_dir=ckdir)
    U3, V3 = train(ratings, rank=4, num_iterations=3, seed=1,
                   checkpoint_dir=ckdir)
    U3_ref, V3_ref = train(ratings, rank=4, num_iterations=3, seed=1)
    assert torch.equal(U3, U3_ref) and torch.equal(V3, V3_ref)


def test_bad_matmul_dtype_rejected():
    with pytest.raises(ValueError, match="matmul_dtype"):
        als.ALSParams(matmul_dtype="bf16")


def test_packed_without_ratings_cannot_checkpoint(tmp_path):
    ratings = ratings_fixture()
    p = als.ALSParams(rank=4, num_iterations=1)
    packed = als.pack_ratings(ratings, p, "cpu")
    with pytest.raises(ValueError, match="fingerprints"):
        als.train_als(None, p, device="cpu", packed=packed,
                      checkpoint_dir=str(tmp_path / "x"))


@pytest.mark.parametrize("kw", [
    {"rank": 4},
    {"rank": 6, "seed": 2, "reg": 0.05},
    {"rank": 4, "implicit_prefs": True, "alpha": 2.0},
    {"rank": 4, "history_mode": "pad"},
    {"rank": 4, "history_mode": "split"},
    {"rank": 4, "gather_dtype": "bfloat16"},
    {"rank": 4, "max_history": 16},
], ids=["default", "params", "implicit", "pad", "split", "bf16", "capped"])
def test_the_fingerprint_is_the_jax_packages(kw, tmp_path):
    """Both packages write the same ``run_metadata.json`` for the same
    run, and each resumes in a directory the other fingerprinted."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        jals.train_als(ratings_fixture(jals),
                       jals.ALSParams(num_iterations=1, **kw),
                       checkpoint_dir=str(tmp_path / "jax"))
        train(ratings_fixture(), num_iterations=1,
              checkpoint_dir=str(tmp_path / "port"), **kw)

    def meta(d):
        return json.loads((tmp_path / d / "run_metadata.json").read_text())

    assert meta("port") == meta("jax")
    packed = als.pack_ratings(ratings_fixture(),
                              als.ALSParams(num_iterations=1, **kw), "cpu")
    pad = all(isinstance(h, ragged.PaddedHistories) for h in packed)
    assert meta("jax")["fingerprint"] == als.checkpoint_fingerprints(
        ratings_fixture(), als.ALSParams(num_iterations=1, **kw), pad)[0]


def test_a_pad_run_accepts_the_legacy_fingerprint(tmp_path):
    ratings = ratings_fixture()
    p = als.ALSParams(rank=4, num_iterations=1, history_mode="pad")
    prints = als.checkpoint_fingerprints(ratings, p, True)
    assert len(prints) == 2
    ck = Checkpointer(str(tmp_path / "legacy"))
    ck.set_metadata({"fingerprint": prints[1]})
    train(ratings, rank=4, num_iterations=1, history_mode="pad",
          checkpoint_dir=str(tmp_path / "legacy"))
    split = als.ALSParams(rank=4, num_iterations=1, history_mode="split")
    assert len(als.checkpoint_fingerprints(ratings, split, False)) == 1


# -- the split layout --------------------------------------------------------------

@pytest.mark.parametrize("L,pad", [(4, 1), (4, 4), (32, 1), (7, 3)])
def test_split_packing_is_the_jax_packages(L, pad):
    r = skewed()
    rows, cols, vals = r.users, r.items, r.ratings
    want = jragged.pack_histories_split(rows, cols, vals, r.n_users, L, pad)
    want_dev = jragged.pack_histories_split_device(rows, cols, vals,
                                                   r.n_users, L, pad)
    for got in (ragged.pack_histories_split(rows, cols, vals, r.n_users, L,
                                            pad),
                ragged.pack_histories_split_device(rows, cols, vals,
                                                   r.n_users, L, pad,
                                                   device="cpu")):
        for f in ("indices", "values", "counts", "row_ids", "real_counts"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          getattr(want, f), err_msg=f)
            np.testing.assert_array_equal(getattr(want_dev, f),
                                          getattr(want, f), err_msg=f)
        assert got.n_rows == want.n_rows and got.n_virtual == want.n_virtual


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_auto_split_len_is_the_jax_packages(seed):
    counts = np.random.default_rng(seed).zipf(1.3, 500) % 20000
    assert als.auto_split_len(counts) == jals.auto_split_len(counts)
    assert als.auto_split_len(np.zeros(3, np.int64)) == 32


def test_segment_sum_is_a_plain_loop_and_deterministic():
    rng = np.random.default_rng(3)
    owners = np.sort(rng.integers(0, 40, 300))
    parts = torch.from_numpy(rng.standard_normal((300, 3, 3))
                             .astype(np.float32))
    rows, sums = als._segment_sum(parts, owners)
    assert rows.tolist() == sorted(set(owners.tolist()))
    for r, s in zip(rows, sums):
        want = parts[torch.from_numpy(np.flatnonzero(owners == r))]
        torch.testing.assert_close(s, want.sum(0), rtol=1e-6, atol=1e-6)
    assert torch.equal(als._segment_sum(parts, owners)[1], sums)


@pytest.mark.parametrize("implicit", [False, True],
                         ids=["explicit", "implicit"])
@pytest.mark.parametrize("block_rows", [None, 16])
def test_split_training_is_the_jax_packages(implicit, block_rows):
    """The same split layout (``max_history`` sets L), from the JAX
    package's draw, within ``test_resume_matches_uninterrupted``'s
    limits; a second run is bitwise the first, and the bucket layout
    lands within the same limits."""
    kw = dict(rank=6, num_iterations=3, seed=2, implicit_prefs=implicit,
              history_mode="split", max_history=8, block_rows=block_rows)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        jU, jV = jals.train_als(ratings_fixture(jals), jals.ALSParams(**kw))
        U, V = train(ratings_fixture(), **kw)
        U2, V2 = train(ratings_fixture(), **kw)
    assert torch.equal(U, U2) and torch.equal(V, V2)
    np.testing.assert_allclose(U.numpy(), np.asarray(jU), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(V.numpy(), np.asarray(jV), rtol=RTOL,
                               atol=ATOL)
    bU, bV = train(ratings_fixture(), **{**kw, "history_mode": "bucket",
                                         "max_history": None})
    np.testing.assert_allclose(U.numpy(), bU.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(V.numpy(), bV.numpy(), rtol=RTOL, atol=ATOL)


def test_split_flops_count_virtual_rows():
    p = als.ALSParams(rank=4, history_mode="split", max_history=8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        packed = als.pack_ratings(skewed(), p, "cpu")
        jpacked = jals.pack_ratings(skewed(jals), jals.ALSParams(
            rank=4, history_mode="split", max_history=8))
    assert als.als_flops_per_iter(*packed, p) == jals.als_flops_per_iter(
        *jpacked, jals.ALSParams(rank=4, history_mode="split",
                                 max_history=8))
