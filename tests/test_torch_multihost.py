"""Training across processes: two ``torch.distributed`` ranks over gloo on
the CPU, each with 4 CPU shards (``PTPU_TORCH_FORCE_DEVICE_COUNT=4``), run
the contracts of ``tests/test_multihost.py``'s worker through the port:

- v1: every rank holds the global COO; ``pack_ratings(mesh=global)``
  routes to ``pack_ratings_multihost``;
- v2: a ``ColumnarRatingsSource`` per rank, each materialising only its
  rows (``touched <= 1.25 * nnz`` over both sides);
- v3: the drop-free bucketed layout on skewed implicit data;
- v4: a ``ShardedColumnarRatingsSource`` over each rank's storage shard,
  the triples gathered through ``exchange_filtered`` (pad and bucket).

Every run starts from the JAX package's own draw (``init=``, saved here
for the ranks). v1 and v3 are held to the JAX package's single-process
``train_als`` on the same seeded problems at that test's tolerance (rtol
2e-3, atol 2e-4); v2 and v4 to the same problem fed as a COO at its v4
tolerance (rtol 1e-4, atol 1e-5). A checkpointed v1 run goes through the
``DistributedCheckpointer`` (each rank its shard files, rank 0 the commit
marker) and resumes bit for bit. Then the ``DistributedCheckpointer`` in
one process against ``tests/test_reliability.py::
TestDistributedCheckpointer``."""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import predictionio_tpu.data.columnar as jcolumnar
import predictionio_tpu.models.als as jals
from predictionio_tpu.models.data import (
    ColumnarRatingsSource as JColumnarRatingsSource,
    ShardedColumnarRatingsSource as JShardedColumnarRatingsSource,
)
from predictionio_tpu_torch import faults
from predictionio_tpu_torch.data import columnar as pcolumnar
from predictionio_tpu_torch.models import als as pals
from predictionio_tpu_torch.models.data import (
    ColumnarRatingsSource,
    ShardedColumnarRatingsSource,
)
from predictionio_tpu_torch.parallel import make_mesh
from predictionio_tpu_torch.workflow.checkpoint import (
    Checkpointer,
    DistributedCheckpointer,
    TornCheckpointError,
    make_checkpointer,
)

ROOT = Path(__file__).resolve().parents[1]

WORKER = textwrap.dedent("""
    import json, os, sys
    import numpy as np

    pid, port, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    os.environ["PTPU_TORCH_FORCE_DEVICE_COUNT"] = "4"
    from predictionio_tpu_torch.parallel import multihost
    multihost.initialize_distributed(f"127.0.0.1:{port}", 2, pid,
                                     backend="gloo")
    assert multihost.process_count() == 2 and multihost.backend() == "gloo"
    import predictionio_tpu_torch.data.storage
    from predictionio_tpu_torch.data.columnar import (
        ColumnarDicts, columnar_from_columns)
    from predictionio_tpu_torch.models import als
    from predictionio_tpu_torch.models.data import (
        ColumnarRatingsSource, ShardedColumnarRatingsSource)
    from predictionio_tpu_torch.workflow.checkpoint import (
        DistributedCheckpointer, make_checkpointer)

    draws = np.load(os.path.join(outdir, "draws.npz"))
    def init(seed, nu, ni):
        return (draws[f"{seed}_{nu}_{ni}_U"], draws[f"{seed}_{nu}_{ni}_V"])
    def whole(t, n):
        return als.unshard_table(t).numpy()[:n]
    def close(a, b, n, what):
        np.testing.assert_allclose(whole(a, n), whole(b, n), rtol=1e-4,
                                   atol=1e-5, err_msg=what)

    mesh = multihost.global_mesh(data=8, device="cpu")
    assert mesh.ranks == (0,) * 4 + (1,) * 4 and mesh.spans_processes
    assert mesh.local_positions() == tuple(range(4 * pid, 4 * pid + 4))

    # v1: identical global COO on every rank
    rng = np.random.default_rng(7)
    nnz, n_users, n_items = 900, 64, 40
    ratings = als.RatingsCOO(
        rng.integers(0, n_users, nnz).astype(np.int32),
        rng.integers(0, n_items, nnz).astype(np.int32),
        rng.random(nnz).astype(np.float32) * 4 + 1, n_users, n_items)
    params = als.ALSParams(rank=4, num_iterations=3, reg=0.05, seed=5)
    packed = als.pack_ratings(ratings, params, mesh=mesh)
    assert isinstance(packed.user_h, als.MeshSide)
    U, V = als.train_als(ratings, params, mesh=mesh, packed=packed,
                         init=init(5, n_users, n_items))
    assert len(multihost.host_shard(np.arange(10))) == 5

    # v1 checkpointed: the distributed container, then a resume
    ck = os.path.join(outdir, "ck")
    assert isinstance(make_checkpointer(ck), DistributedCheckpointer)
    two = als.ALSParams(rank=4, num_iterations=2, reg=0.05, seed=5)
    als.train_als(ratings, two, mesh=mesh, packed=packed,
                  init=init(5, n_users, n_items), checkpoint_dir=ck)
    multihost.barrier("listed")
    step2 = sorted(os.listdir(os.path.join(ck, "step_00000002")))
    Uc, Vc = als.train_als(ratings, params, mesh=mesh, packed=packed,
                           init=init(5, n_users, n_items), checkpoint_dir=ck)
    np.testing.assert_array_equal(whole(Uc, n_users), whole(U, n_users))
    np.testing.assert_array_equal(whole(Vc, n_items), whole(V, n_items))

    # v2: partial reads through a source; each rank materialises ~half
    batch = columnar_from_columns(
        ColumnarDicts(), ["rate"] * nnz, ["user"] * nnz,
        [f"u{u:05d}" for u in ratings.users], ["item"] * nnz,
        [f"i{i:05d}" for i in ratings.items],
        np.arange(nnz, dtype=np.int64), [None] * nnz, float_props=())
    batch.float_props["rating"] = ratings.ratings.astype(np.float64)
    src = ColumnarRatingsSource(batch, chunk=257)
    touched = {"n": 0}
    orig_read = src.read_rows
    def counting_read(side, start, stop):
        r, c, v = orig_read(side, start, stop)
        touched["n"] += len(r)
        return r, c, v
    src.read_rows = counting_read
    packed2 = als.pack_ratings_multihost(src, params, mesh)
    assert touched["n"] <= 1.25 * nnz, touched
    su, si = src.n_users, src.n_items
    U2, V2 = als.train_als(None, params, mesh=mesh, packed=packed2,
                           init=init(5, su, si))
    coo_v2 = ColumnarRatingsSource(batch).to_coo()
    U3, V3 = als.train_als(coo_v2, params, mesh=mesh,
                           packed=als.pack_ratings_multihost(coo_v2, params,
                                                             mesh),
                           init=init(5, su, si))
    close(U2, U3, su, "v2 U")
    close(V2, V3, si, "v2 V")

    # v3: drop-free bucketed layout on skewed implicit data
    rng2 = np.random.default_rng(21)
    nnz2 = 1200
    r2 = als.RatingsCOO(rng2.integers(0, 48, nnz2).astype(np.int32),
                        ((rng2.zipf(1.2, nnz2) - 1) % 24).astype(np.int32),
                        np.ones(nnz2, np.float32), 48, 24)
    params2 = als.ALSParams(rank=4, num_iterations=2, seed=9,
                            implicit_prefs=True, alpha=10.0,
                            history_mode="bucket")
    packed_b = als.pack_ratings_multihost(r2, params2, mesh)
    assert packed_b.user_h.kind == "bucket"
    Ub, Vb = als.train_als(None, params2, mesh=mesh, packed=packed_b,
                           init=init(9, 48, 24))

    # v4: full shard pushdown, the triples through exchange_filtered
    my_shard = batch.shard(pid, 2, with_props=False)
    assert my_shard.n < nnz
    src4 = ShardedColumnarRatingsSource(my_shard, chunk=113,
                                        exchange_chunk=151)
    assert (src4.n_users, src4.n_items) == (su, si)
    U4, V4 = als.train_als(None, params, mesh=mesh,
                           packed=als.pack_ratings_multihost(src4, params,
                                                             mesh),
                           init=init(5, su, si))
    close(U4, U3, su, "v4 U")
    close(V4, V3, si, "v4 V")

    # v4 bucketed: arbitrary row sets through the shuffle
    batch_b = columnar_from_columns(
        ColumnarDicts(), ["rate"] * nnz2, ["user"] * nnz2,
        [f"u{u:05d}" for u in r2.users], ["item"] * nnz2,
        [f"i{i:05d}" for i in r2.items],
        np.arange(nnz2, dtype=np.int64), [None] * nnz2, float_props=())
    batch_b.float_props["rating"] = r2.ratings.astype(np.float64)
    src4b = ShardedColumnarRatingsSource(batch_b.shard(pid, 2),
                                         exchange_chunk=173)
    bu, bi = src4b.n_users, src4b.n_items
    U4b, V4b = als.train_als(None, params2, mesh=mesh,
                             packed=als.pack_ratings_multihost(
                                 src4b, params2, mesh),
                             init=init(9, bu, bi))
    coo_b = ColumnarRatingsSource(batch_b).to_coo()
    U5b, V5b = als.train_als(None, params2, mesh=mesh,
                             packed=als.pack_ratings_multihost(
                                 coo_b, params2, mesh),
                             init=init(9, bu, bi))
    close(U4b, U5b, bu, "v4 bucketed U")
    close(V4b, V5b, bi, "v4 bucketed V")
    # gloo moved CPU tensors: nothing was staged through the host for it
    assert multihost.HOST_STAGED == {"collectives": 0, "bytes": 0}

    def ordered(ids):
        return sorted(ids.keys(), key=ids.__getitem__)

    if pid == 0:
        np.savez(os.path.join(outdir, "factors.npz"),
                 U=whole(U, n_users), V=whole(V, n_items),
                 Ub=whole(Ub, 48), Vb=whole(Vb, 24),
                 U2=whole(U2, su), V2=whole(V2, si),
                 U4=whole(U4, su), V4=whole(V4, si),
                 U4b=whole(U4b, bu), V4b=whole(V4b, bi))
        ids = {name: [ordered(s.user_ids), ordered(s.item_ids)]
               for name, s in (("v2", src), ("v4", src4), ("v4b", src4b))}
        json.dump({"ok": True, "touched": touched["n"], "nnz": nnz,
                   "step2": step2, "ids": ids},
                  open(os.path.join(outdir, "ok.json"), "w"))
    multihost.shutdown()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_draw(seed, n_users, n_items, rank):
    ku, ki = jax.random.split(jax.random.key(seed))
    return [np.array(jals._init_factors(k, n=n, n_padded=n, rank=rank))
            for k, n in ((ku, n_users), (ki, n_items))]


def _problems():
    rng = np.random.default_rng(7)
    nnz, n_users, n_items = 900, 64, 40
    r1 = jals.RatingsCOO(rng.integers(0, n_users, nnz).astype(np.int32),
                         rng.integers(0, n_items, nnz).astype(np.int32),
                         rng.random(nnz).astype(np.float32) * 4 + 1,
                         n_users, n_items)
    rng2 = np.random.default_rng(21)
    nnz2 = 1200
    r2 = jals.RatingsCOO(rng2.integers(0, 48, nnz2).astype(np.int32),
                         ((rng2.zipf(1.2, nnz2) - 1) % 24).astype(np.int32),
                         np.ones(nnz2, np.float32), 48, 24)
    return r1, r2


def _observed(r):
    return (len(np.unique(np.asarray(r.users))),
            len(np.unique(np.asarray(r.items))))


def _jax_batch(r):
    """The worker's columnar batch of ``r``, built by the JAX package."""
    nnz = len(r.users)
    batch = jcolumnar.columnar_from_columns(
        jcolumnar.ColumnarDicts(), ["rate"] * nnz, ["user"] * nnz,
        [f"u{u:05d}" for u in np.asarray(r.users)], ["item"] * nnz,
        [f"i{i:05d}" for i in np.asarray(r.items)],
        np.arange(nnz, dtype=np.int64), [None] * nnz, float_props=())
    batch.float_props["rating"] = np.asarray(r.ratings).astype(np.float64)
    return batch


def _ordered(ids):
    return sorted(ids.keys(), key=ids.__getitem__)


def test_two_process_training_matches_the_jax_package(tmp_path):
    r1, r2 = _problems()
    draws = {}
    for seed, (nu, ni) in ((5, (64, 40)), (5, _observed(r1)),
                           (9, (48, 24)), (9, _observed(r2))):
        U, V = _jax_draw(seed, nu, ni, 4)
        draws[f"{seed}_{nu}_{ni}_U"], draws[f"{seed}_{nu}_{ni}_V"] = U, V
    np.savez(tmp_path / "draws.npz", **draws)
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PIO_", "PTPU_"))}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + env.get("PYTHONPATH", "").split(os.pathsep))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), str(port), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=180)[0].decode())
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out[-3000:]}"
    ok = json.loads((tmp_path / "ok.json").read_text())
    assert ok["touched"] <= 1.25 * ok["nnz"]
    # each rank wrote its shard files; rank 0 the commit marker
    assert ok["step2"] == ["COMMIT.json", "shard_p0.json", "shard_p0.npz",
                           "shard_p1.json", "shard_p1.npz"]

    got = np.load(tmp_path / "factors.npz")
    U1, V1 = jals.train_als(r1, jals.ALSParams(rank=4, num_iterations=3,
                                               reg=0.05, seed=5))
    np.testing.assert_allclose(got["U"], np.asarray(U1)[:64], rtol=2e-3,
                               atol=2e-4)
    np.testing.assert_allclose(got["V"], np.asarray(V1)[:40], rtol=2e-3,
                               atol=2e-4)
    params2 = jals.ALSParams(rank=4, num_iterations=2, seed=9,
                             implicit_prefs=True, alpha=10.0,
                             history_mode="bucket")
    Ub, Vb = jals.train_als(r2, params2)
    np.testing.assert_allclose(got["Ub"], np.asarray(Ub)[:48], rtol=2e-3,
                               atol=2e-4)
    np.testing.assert_allclose(got["Vb"], np.asarray(Vb)[:24], rtol=2e-3,
                               atol=2e-4)

    # v2 and v4: the JAX package's own source over the same batch gives
    # the ranks' indexation, and its single-process training their factors
    for names, r, params in ((("v2", "v4"), r1, jals.ALSParams(
            rank=4, num_iterations=3, reg=0.05, seed=5)),
            (("v4b",), r2, params2)):
        jsrc = JColumnarRatingsSource(_jax_batch(r))
        Uj, Vj = jals.train_als(jsrc.to_coo(), params)
        nu, ni = jsrc.n_users, jsrc.n_items
        for name in names:
            assert ok["ids"][name] == [_ordered(jsrc.user_ids),
                                       _ordered(jsrc.item_ids)], name
            np.testing.assert_allclose(got[f"U{name[1:]}"],
                                       np.asarray(Uj)[:nu],
                                       rtol=2e-3, atol=2e-4, err_msg=name)
            np.testing.assert_allclose(got[f"V{name[1:]}"],
                                       np.asarray(Vj)[:ni],
                                       rtol=2e-3, atol=2e-4, err_msg=name)


# -- the rating sources against the JAX package's, row for row ---------------


def _mixed_batches(n=600, seed=3):
    """One event mix (rated, bought and viewed items, NaN ratings, events
    without a target) encoded by both packages from the same columns."""
    rng = np.random.default_rng(seed)
    events = list(rng.choice(["rate", "buy", "view"], n, p=[.6, .25, .15]))
    users = [f"u{u:03d}" for u in rng.integers(0, 50, n)]
    targets = [None if rng.random() < 0.05 else f"i{i:03d}"
               for i in rng.integers(0, 30, n)]
    ttypes = [None if t is None else "item" for t in targets]
    rating = rng.integers(1, 6, n).astype(np.float64)
    rating[rng.random(n) < 0.1] = np.nan
    out = []
    for mod in (pcolumnar, jcolumnar):
        b = mod.columnar_from_columns(
            mod.ColumnarDicts(), events, ["user"] * n, users, ttypes,
            targets, np.arange(n, dtype=np.int64), [None] * n,
            float_props=())
        b.float_props["rating"] = rating
        out.append(b)
    return out


def _assert_same_source(p, j):
    assert (p.n_users, p.n_items) == (j.n_users, j.n_items)
    assert _ordered(p.user_ids) == _ordered(j.user_ids)
    assert _ordered(p.item_ids) == _ordered(j.item_ids)
    rng = np.random.default_rng(11)
    for side, n in (("user", j.n_users), ("item", j.n_items)):
        np.testing.assert_array_equal(p.row_counts(side),
                                      j.row_counts(side))
        for lo, hi in ((0, n), (3, 17), (n - 5, n), (n, n)):
            for a, b in zip(p.read_rows(side, lo, hi),
                            j.read_rows(side, lo, hi)):
                np.testing.assert_array_equal(a, b)
        mask = rng.random(n) < 0.4
        for a, b in zip(p.read_row_mask(side, mask),
                        j.read_row_mask(side, mask)):
            np.testing.assert_array_equal(a, b)
    pc, jc = p.to_coo(), j.to_coo()
    for f in ("users", "items", "ratings"):
        np.testing.assert_array_equal(getattr(pc, f),
                                      np.asarray(getattr(jc, f)))
    assert (pc.n_users, pc.n_items) == (jc.n_users, jc.n_items)


@pytest.mark.parametrize("weights,chunk", [
    (None, 7),
    ({"rate": None}, 4_000_000),
    ({"buy": 2.0, "view": 0.5}, 13),
    ({"rate": None, "buy": 4.0, "view": 1.0}, 64),
])
@pytest.mark.parametrize("kind", ["whole", "one_shard_of_three",
                                  "sharded_one_process"])
def test_rating_sources_match_the_jax_package(weights, chunk, kind):
    pb, jb = _mixed_batches()
    if kind == "whole":
        p = ColumnarRatingsSource(pb, weights, chunk=chunk)
        j = JColumnarRatingsSource(jb, weights, chunk=chunk)
    elif kind == "one_shard_of_three":
        p = ColumnarRatingsSource(pb.shard(1, 3), weights, chunk=chunk)
        j = JColumnarRatingsSource(jb.shard(1, 3), weights, chunk=chunk)
    else:
        p = ShardedColumnarRatingsSource(pb.shard(0, 1), weights,
                                         chunk=chunk, exchange_chunk=29)
        j = JShardedColumnarRatingsSource(jb.shard(0, 1), weights,
                                          chunk=chunk, exchange_chunk=29)
    assert p.n_users > 0 and p.n_items > 0
    _assert_same_source(p, j)


# -- the DistributedCheckpointer in one process ------------------------------


def test_roundtrip_and_prune(tmp_path):
    ck = DistributedCheckpointer(str(tmp_path / "d"), keep=2,
                                 process_index=0, process_count=1)
    for step in (1, 2, 3):
        ck.save(step, {"U": np.full((4, 2), float(step)), "n": step})
    assert ck.all_steps() == [2, 3]  # keep=2 pruned step 1
    step, state = ck.restore_latest(like={"U": np.zeros((4, 2)), "n": 0})
    assert step == 3
    np.testing.assert_array_equal(state["U"], np.full((4, 2), 3.0))
    assert int(state["n"]) == 3


def test_missing_commit_marker_is_torn(tmp_path):
    ck = DistributedCheckpointer(str(tmp_path / "d"), process_index=0,
                                 process_count=1)
    ck.save(1, {"x": np.ones(3)})
    ck.save(2, {"x": np.ones(3) * 2})
    os.remove(os.path.join(ck._step_dir(2), "COMMIT.json"))
    assert ck.all_steps() == [1]
    with pytest.raises(TornCheckpointError):
        ck.restore(2, like={"x": np.zeros(3)})
    step, state = ck.restore_latest(like={"x": np.zeros(3)})
    assert step == 1
    np.testing.assert_array_equal(state["x"], np.ones(3))
    assert ck.discard_torn() == [2]
    assert not os.path.exists(ck._step_dir(2))


def test_missing_shard_file_is_torn(tmp_path):
    ck = DistributedCheckpointer(str(tmp_path / "d"), process_index=0,
                                 process_count=1)
    ck.save(1, {"x": np.ones(3)})
    ck.save(2, {"x": np.ones(3) * 2})
    os.remove(os.path.join(ck._step_dir(2), "shard_p0.npz"))
    step, _ = ck.restore_latest(like={"x": np.zeros(3)})
    assert step == 1


def test_sharded_tables_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setenv("PTPU_TORCH_FORCE_DEVICE_COUNT", "3")
    mesh = make_mesh(data=3, devices=["cpu"] * 3)
    x = torch.arange(12.0).reshape(6, 2)
    table = pals.RowShardedTable(tuple(x[2 * s:2 * s + 2].clone()
                                       for s in range(3)), mesh)
    ck = DistributedCheckpointer(str(tmp_path / "d"), process_index=0,
                                 process_count=1)
    ck.save(1, {"U": table})
    manifest = json.loads((Path(ck._step_dir(1)) / "shard_p0.json")
                          .read_text())
    assert [e["rows"] for e in manifest["entries"]] == [[0, 2], [2, 4],
                                                         [4, 6]]
    step, state = ck.restore_latest(like={"U": torch.zeros(6, 2)})
    assert step == 1 and torch.equal(state["U"], x)
    # a shard file's rows missing: torn, never a table with a hole
    manifest["entries"] = manifest["entries"][:2]
    (Path(ck._step_dir(1)) / "shard_p0.json").write_text(
        json.dumps(manifest))
    with pytest.raises(TornCheckpointError, match=r"rows \[4, 6\)"):
        ck.restore(1)


def test_injected_crash_window_yields_torn_step(tmp_path):
    ck = DistributedCheckpointer(str(tmp_path / "d"), process_index=0,
                                 process_count=1)
    ck.save(1, {"x": np.ones(2)})
    faults.inject("checkpoint.commit", "error")
    try:
        with pytest.raises(faults.FaultError):
            ck.save(2, {"x": np.ones(2) * 2})
    finally:
        faults.clear()
    assert ck.all_steps() == [1]
    step, _ = ck.restore_latest(like={"x": np.zeros(2)})
    assert step == 1


def test_make_checkpointer_env_force(tmp_path, monkeypatch):
    monkeypatch.setenv("PTPU_DIST_CKPT", "1")
    assert isinstance(make_checkpointer(str(tmp_path / "a")),
                      DistributedCheckpointer)
    monkeypatch.delenv("PTPU_DIST_CKPT")
    assert isinstance(make_checkpointer(str(tmp_path / "b")), Checkpointer)


def test_a_jax_written_distributed_directory_is_refused(tmp_path):
    from predictionio_tpu.workflow.checkpoint import (
        DistributedCheckpointer as JDistributedCheckpointer,
    )

    d = str(tmp_path / "d")
    JDistributedCheckpointer(d, process_index=0, process_count=1).save(
        1, {"U": np.ones((4, 2))})
    with pytest.raises(RuntimeError, match="JAX package's distributed"):
        DistributedCheckpointer(d, process_index=0, process_count=1)
