"""Sequence parallelism and data-parallel seqrec on the port, held to the
JAX package on the CPU.

- ``ring_attention(mesh=)`` over the port's mesh of 8 CPU positions
  (``PTPU_TORCH_FORCE_DEVICE_COUNT=8``, laid out as the conftest's
  ``mesh8``, 4 x 2, and as 8 x 1) against the JAX package's ring over
  ``mesh8`` (and an 8 x 1 mesh): f32 within rtol 1e-5, atol 1e-6; bf16
  within one bf16 step (rtol and atol 2**-7). The ``sequence_shard``
  form keeps ``S / P`` blocks; a sequence that does not divide raises.
- ``ring_permute`` over a process mesh: two gloo ranks of 2 positions
  each give what the one-process mesh of 4 gives, and each rank
  receives one block's bytes from the other; the ring and data-parallel
  seqrec over that process mesh equal the one-process mesh's bit for
  bit.
- ``train_seqrec(mesh=)`` over 8 positions with both seams (the JAX
  package's initial weights and negatives) against the JAX package's
  ``train_seqrec(mesh=mesh8)``: per-epoch losses within rtol 1e-4, the
  weights within 1e-4 on 99% of entries and within ``2 * K * lr`` on
  all (``tests/test_torch_sequential.py``'s seam test). The batches hold
  windows of different lengths, so positions hold different valid
  counts.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import predictionio_tpu.models.seqrec as jseq
import predictionio_tpu.ops.ring_attention as jring
from predictionio_tpu.parallel.mesh import make_mesh as jmake_mesh
from predictionio_tpu_torch import parallel as ppar
from predictionio_tpu_torch.models import seqrec
from predictionio_tpu_torch.ops.ring_attention import (
    ring_attention,
    sequence_shard,
)
from predictionio_tpu_torch.parallel import collectives as pcoll

ROOT = Path(__file__).resolve().parents[1]
BF16_STEP = 2 ** -7


@pytest.fixture(autouse=True)
def eight_positions(monkeypatch):
    monkeypatch.setenv(ppar.FORCE_DEVICE_COUNT_ENV, "8")


def mesh_of(data, model=1):
    return ppar.make_mesh(data=data, model=model,
                          devices=ppar.local_devices("cpu"))


def _qkv(B=2, S=32, H=2, D=4, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, S, H, D)).astype(np.float32)
                 for _ in range(3))


def _key_valid(B, S, seed):
    """Left-pad style masks in row 0, random elsewhere, and every key of
    row 1 masked (its rows see nothing: 0, never NaN)."""
    rng = np.random.default_rng(seed)
    kv = rng.random((B, S)) > 0.3
    kv[0, :S // 2 + 3] = False
    kv[1, :] = False
    return kv


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _jax_ring(q, k, v, mesh, causal, kv, dtype=jnp.float32):
    return np.asarray(jring.ring_attention(
        jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
        mesh=mesh, causal=causal,
        key_valid=None if kv is None else jnp.asarray(kv)),
        dtype=np.float32)


# -- the ring -----------------------------------------------------------------

@pytest.mark.parametrize("layout", [(4, 2), (8, 1)], ids=str)
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_the_ring_matches_the_jax_ring(mesh8, layout, masked, causal):
    q, k, v = _qkv(B=3, S=32, seed=1 + causal + 2 * masked)
    kv = _key_valid(3, 32, seed=5) if masked else None
    jmesh = mesh8 if layout == (4, 2) else jmake_mesh(data=8, model=1)
    want = _jax_ring(q, k, v, jmesh, causal, kv)
    got = ring_attention(_t(q), _t(k), _t(v), mesh=mesh_of(*layout),
                         causal=causal, key_valid=None if kv is None
                         else _t(kv))
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    if masked:
        assert np.all(got.numpy()[1] == 0) and np.all(want[1] == 0)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_the_ring_in_bf16_is_within_one_step_of_the_jax_ring(mesh8,
                                                              causal):
    q, k, v = _qkv(B=2, S=32, H=2, D=8, seed=7)
    kv = _key_valid(2, 32, seed=3)
    want = _jax_ring(q, k, v, mesh8, causal, kv, jnp.bfloat16)
    got = ring_attention(*(_t(x).to(torch.bfloat16) for x in (q, k, v)),
                         mesh=mesh_of(4, 2), causal=causal,
                         key_valid=_t(kv))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_STEP,
                               atol=BF16_STEP)


def test_the_ring_is_the_one_card_path_up_to_rounding():
    q, k, v = (_t(x).double() for x in _qkv(B=2, S=48, seed=11))
    kv = _t(_key_valid(2, 48, seed=2))
    one = ring_attention(q, k, v, causal=True, key_valid=kv)
    ring = ring_attention(q, k, v, mesh=mesh_of(8), causal=True,
                          key_valid=kv)
    assert ring.dtype == torch.float64  # a float64 input stays float64
    np.testing.assert_allclose(ring.numpy(), one.numpy(), rtol=1e-12,
                               atol=1e-13)


def test_the_sequence_shard_form_keeps_its_blocks(mesh8):
    q, k, v = _qkv(B=2, S=32, seed=5)
    kv = _key_valid(2, 32, seed=9)
    mesh = mesh_of(8)
    qs, ks_, vs, kvs = (sequence_shard(_t(x), mesh) for x in (q, k, v, kv))
    assert len(qs) == 8 and all(b.shape == (2, 4, 2, 4) for b in qs)
    out = ring_attention(qs, ks_, vs, mesh=mesh, causal=True, key_valid=kvs)
    assert isinstance(out, list) and len(out) == 8
    assert all(b.shape == (2, 4, 2, 4) for b in out)
    whole = ring_attention(_t(q), _t(k), _t(v), mesh=mesh, causal=True,
                           key_valid=_t(kv))
    assert torch.equal(torch.cat(out, dim=1), whole)
    # the JAX package's sequence_shard form is sharded the same way
    jq = jring.sequence_shard(jnp.asarray(q), jmake_mesh(data=8, model=1))
    assert {s.data.shape for s in jq.addressable_shards} == {(2, 4, 2, 4)}


def test_positions_along_the_other_axis_hold_the_same_block():
    q, k, v = _qkv(B=1, S=16, seed=2)
    mesh = mesh_of(4, 2)
    out = ring_attention(*(sequence_shard(_t(x), mesh) for x in (q, k, v)),
                         mesh=mesh, causal=True)
    for p in range(0, 8, 2):  # (data i, model 0) and (data i, model 1)
        assert torch.equal(out[p], out[p + 1])


def test_a_sequence_that_does_not_divide_raises():
    q, k, v = (_t(x) for x in _qkv(S=30))
    with pytest.raises(ValueError, match="do not split over"):
        ring_attention(q, k, v, mesh=mesh_of(8))
    with pytest.raises(ValueError, match="do not split over"):
        sequence_shard(q, mesh_of(4, 2))


def test_split_and_join_along_the_sequence_are_inverse():
    x = torch.arange(2 * 16 * 3).reshape(2, 16, 3)
    mesh = mesh_of(4, 2)
    blocks = sequence_shard(x, mesh, "data")
    assert [b[0, 0, 0].item() for b in blocks] == \
        [0, 0, 12, 12, 24, 24, 36, 36]
    assert torch.equal(pcoll._assemble(blocks, mesh, ("data",), dim=1), x)


def test_ring_permute_on_one_process_sends_each_block_to_its_neighbour():
    mesh = mesh_of(4, 2)
    blocks = [torch.full((3,), float(p)) for p in range(8)]
    got = ppar.ring_permute(blocks, "data", 1, mesh=mesh)
    # position (i, j) gets (i - 1, j)'s block
    assert [int(b[0]) for b in got] == [6, 7, 0, 1, 2, 3, 4, 5]
    assert all(g.data_ptr() != b.data_ptr() for g, b in zip(got, blocks))


# -- the ring and seqrec across processes -------------------------------------

WORKER = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch

    pid, port, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    os.environ["PTPU_TORCH_FORCE_DEVICE_COUNT"] = "2"
    from predictionio_tpu_torch.parallel import multihost, ring_permute
    multihost.initialize_distributed(f"127.0.0.1:{port}", 2, pid,
                                     backend="gloo")
    from predictionio_tpu_torch.models import seqrec
    from predictionio_tpu_torch.ops.ring_attention import (
        ring_attention, sequence_shard)

    mesh = multihost.global_mesh(data=4, device="cpu")
    assert mesh.ranks == (0, 0, 1, 1)
    mine = mesh.local_positions()
    blocks = [torch.arange(6, dtype=torch.float32) + 100 * p for p in mine]
    got = ring_permute(blocks, "data", 1, mesh=mesh)
    received = dict(multihost.P2P_RECEIVED)

    data = np.load(os.path.join(outdir, "inputs.npz"))
    q, k, v, kv = (torch.from_numpy(data[n]) for n in ("q", "k", "v", "kv"))
    out = ring_attention(q, k, v, mesh=mesh, causal=True, key_valid=kv)
    blk = ring_attention(*(sequence_shard(x, mesh) for x in (q, k, v)),
                         mesh=mesh, causal=True,
                         key_valid=sequence_shard(kv, mesh))
    params = seqrec.SeqRecParams(**json.loads(sys.argv[4]))
    model, losses = seqrec.train_seqrec(data["seqs"], 12, params, mesh=mesh)
    np.savez(os.path.join(outdir, f"rank{pid}.npz"), out=out.numpy(),
             blocks=np.stack([b.numpy() for b in blk]),
             permuted=np.stack([g.numpy() for g in got]),
             losses=np.asarray(losses),
             **{"w_" + n: w.numpy() for n, w in model.weights.items()})
    json.dump(received, open(os.path.join(outdir, f"rank{pid}.json"), "w"))
    multihost.shutdown()
""")

SEQ_P = dict(dim=16, heads=2, num_blocks=2, max_len=8, batch_size=8,
             n_negatives=5, learning_rate=1e-3, num_epochs=2, seed=3)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _windows(lengths, L, n_items, seed):
    rng = np.random.default_rng(seed)
    seq = np.full((len(lengths), L), -1, np.int32)
    for r, n in enumerate(lengths):
        if n:
            seq[r, -n:] = rng.integers(0, n_items, n)
    return seq


def test_two_gloo_ranks_are_the_one_process_mesh(tmp_path, monkeypatch):
    q, k, v = _qkv(B=2, S=16, seed=4)
    kv = _key_valid(2, 16, seed=6)
    seqs = _windows(np.random.default_rng(1).integers(1, 9, 40), 8, 12, 2)
    np.savez(tmp_path / "inputs.npz", q=q, k=k, v=v, kv=kv, seqs=seqs)
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    env = {n: x for n, x in os.environ.items()
           if not n.startswith(("PIO_", "PTPU_"))}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + env.get("PYTHONPATH", "").split(os.pathsep))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), str(port), str(tmp_path),
         json.dumps(SEQ_P)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for i in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=180)[0].decode())
        except subprocess.TimeoutExpired:
            for x in procs:
                x.kill()
            raise
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out[-3000:]}"

    monkeypatch.setenv(ppar.FORCE_DEVICE_COUNT_ENV, "4")
    mesh = mesh_of(4)
    blocks = [torch.arange(6, dtype=torch.float32) + 100 * p
              for p in range(4)]
    want_perm = ppar.ring_permute(blocks, "data", 1, mesh=mesh)
    want = ring_attention(_t(q), _t(k), _t(v), mesh=mesh, causal=True,
                          key_valid=_t(kv))
    model, losses = seqrec.train_seqrec(seqs, 12, seqrec.SeqRecParams(
        **SEQ_P), mesh=mesh)
    for pid in range(2):
        got = np.load(tmp_path / f"rank{pid}.npz")
        for k_, p in enumerate((2 * pid, 2 * pid + 1)):
            np.testing.assert_array_equal(got["permuted"][k_],
                                          want_perm[p].numpy())
        np.testing.assert_array_equal(got["out"], want.numpy())
        np.testing.assert_array_equal(
            np.concatenate(list(got["blocks"]), axis=1),
            want.numpy()[:, 8 * pid:8 * pid + 8])
        np.testing.assert_array_equal(got["losses"], np.asarray(losses))
        for name, w in model.weights.items():
            np.testing.assert_array_equal(got["w_" + name], w.numpy(),
                                          err_msg=name)
        # the first ring_permute alone: each rank received one block
        received = json.loads((tmp_path / f"rank{pid}.json").read_text())
        assert received == {"messages": 1, "bytes": 6 * 4}


# -- data-parallel seqrec -----------------------------------------------------

N_ITEMS = 12


def _params(**kw):
    args = {**SEQ_P, "num_epochs": 3, **kw}
    return jseq.SeqRecParams(**args), seqrec.SeqRecParams(**args)


def _jax_weights(jp):
    return {n: np.asarray(w) for n, w in jseq._init_weights(
        jax.random.key(jp.seed), N_ITEMS, jp).items()}


def _key_chain_sampler(seed):
    state = {"key": jax.random.key(seed)}

    def sample(step, shape):
        state["key"], sub = jax.random.split(state["key"])
        return torch.from_numpy(np.asarray(
            jax.random.randint(sub, shape, 0, N_ITEMS))).long()

    return sample


@pytest.mark.parametrize("n_rows", [40, 3])
def test_train_seqrec_over_a_mesh_with_both_seams_is_the_jax_training(
        mesh8, n_rows):
    """Windows of 1..8 items: the 8 positions of every batch hold
    different valid counts, so a mean of per-position means would be
    off. 3 rows take the partial-batch branch."""
    jp, pp = _params()
    lengths = np.random.default_rng(8).integers(1, 9, n_rows)
    lengths[:2] = (8, 2)
    seqs = _windows(lengths, 8, N_ITEMS, seed=9)
    jmodel, jlosses = jseq.train_seqrec(seqs, N_ITEMS, jp, mesh=mesh8)
    model, losses = seqrec.train_seqrec(
        seqs, N_ITEMS, pp, mesh=mesh_of(4, 2), init=_jax_weights(jp),
        negatives=_key_chain_sampler(jp.seed))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    kept = len(seqs[(seqs >= 0).sum(1) >= 2])
    steps = 3 * max(kept // 8, 1)
    for name, x in model.weights.items():
        err = np.abs(x.numpy() - np.asarray(jmodel.weights[name]))
        assert np.mean(err <= 1e-4) >= 0.99, (name, err.max())
        assert np.all(err <= 2 * steps * pp.learning_rate), name


def test_the_mesh_step_divides_by_the_whole_batchs_valid_count():
    """One step over 4 positions whose rows hold 7, 1, 4 and 2 valid
    pairs is the one card's step: the gradient of the whole batch's mean,
    not a mean of per-position means."""
    _, pp = _params(batch_size=4, num_epochs=1)
    seq = torch.from_numpy(_windows([8, 2, 5, 3], 8, N_ITEMS, 1)).long()
    negs = torch.randint(0, N_ITEMS, (4, 7, pp.n_negatives),
                         generator=torch.Generator().manual_seed(0))
    w0 = seqrec._init_weights(N_ITEMS, pp)
    one = {n: x.clone() for n, x in w0.items()}
    m1 = {n: torch.zeros_like(x) for n, x in one.items()}
    v1 = {n: torch.zeros_like(x) for n, x in one.items()}
    loss1 = seqrec.train_step(one, m1, v1, 0, seq, negs, pp)
    ws = {n: x.clone() for n, x in w0.items()}
    ms = {n: torch.zeros_like(x) for n, x in ws.items()}
    vs = {n: torch.zeros_like(x) for n, x in ws.items()}
    step = seqrec._MeshStep(ws, ms, vs, mesh_of(4))
    loss4 = step.step(0, seq, negs, pp)
    assert float(loss4) == pytest.approx(float(loss1), rel=1e-6)
    for n in one:
        np.testing.assert_allclose(ms[n].numpy(), m1[n].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=n)


def test_a_mesh_rounds_the_batch_to_its_size():
    """``B = max(B // n, 1) * n``: 10 rows a batch over 4 positions is 8,
    so 17 rows make two batches an epoch, as in the JAX package."""
    _, pp = _params(batch_size=10, num_epochs=1)
    seqs = _windows([4] * 17, 8, N_ITEMS, 3)
    calls = []

    def sample(step, shape):
        calls.append(shape)
        return torch.zeros(shape, dtype=torch.long)

    seqrec.train_seqrec(seqs, N_ITEMS, pp, mesh=mesh_of(4), negatives=sample)
    assert calls == [(8, 7, pp.n_negatives)] * 2
