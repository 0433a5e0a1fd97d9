"""The port's mesh collectives against the JAX package's, in one process.

Each case builds the same ``(data, model)`` mesh in both packages (the
JAX package over its 8 forced CPU devices, ``tests/conftest.py``; the
port over ``PTPU_TORCH_FORCE_DEVICE_COUNT=8`` CPU shards, set here with
``monkeypatch``) and runs the bodies of ``tests/test_parallel.py::
TestCollectives`` through both: the JAX package's in a ``shard_map``,
the port's over its per-position blocks. The mesh shapes are that test
module's (1 x 8) and the conftest's ``mesh8`` (4 x 2), so the
collectives over ``model`` also run in groups. Sums of small integers are
exact in f32, so the results must be equal; the Gramian is held to f32
rounding. Then the process-group helpers with no group (the identity, as
``TestMultihost::test_host_shard_single_process``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import predictionio_tpu.parallel as jpar
from predictionio_tpu.parallel.collectives import (
    gramian_allreduce as jgramian_allreduce,
)
from predictionio_tpu.parallel.mesh import make_mesh as jmake_mesh
from predictionio_tpu_torch import parallel as ppar
from predictionio_tpu_torch.parallel import collectives as pcoll
from predictionio_tpu_torch.parallel import multihost as pmh

SHAPES = [(1, 8), (4, 2)]


@pytest.fixture(autouse=True)
def eight_shards(monkeypatch):
    monkeypatch.setenv(ppar.FORCE_DEVICE_COUNT_ENV, "8")


def meshes(shape):
    data, model = shape
    return (jmake_mesh(data=data, model=model),
            ppar.make_mesh(data=data, model=model,
                           devices=ppar.local_devices("cpu")))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_all_reduce_sum(shape):
    jm, pm = meshes(shape)
    x = np.arange(16, dtype=np.float32)

    @jpar.sharded(jm, in_specs=P("model"), out_specs=P())
    def jtotal(shard):
        return jpar.all_reduce_sum(shard.sum())

    @ppar.sharded(pm, in_specs=ppar.MODEL_AXIS, out_specs=None)
    def ptotal(shards):
        return ppar.all_reduce_sum([s.sum() for s in shards], mesh=pm)

    assert float(ptotal(x)) == float(jtotal(x)) == float(x.sum())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_all_gather_gives_every_position_the_whole(shape):
    jm, pm = meshes(shape)
    x = np.arange(16, dtype=np.float32)
    n = shape[1]

    @jpar.sharded(jm, in_specs=P("model"), out_specs=P("model"))
    def jfn(shard):
        full = jpar.all_gather(shard)
        i = jax.lax.axis_index("model")
        return jax.lax.dynamic_slice(full, (i * (16 // n),), (16 // n,))

    blocks = pcoll._split(x, pm, ppar.MODEL_AXIS)
    gathered = ppar.all_gather(blocks, mesh=pm)
    for g in gathered:
        np.testing.assert_array_equal(g.numpy(), x)
    np.testing.assert_array_equal(np.asarray(jfn(x)), x)
    stacked = ppar.all_gather(blocks, mesh=pm, tiled=False)
    assert tuple(stacked[0].shape) == (n, 16 // n)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_reduce_scatter_matches_psum_scatter(shape):
    jm, pm = meshes(shape)
    n = shape[1]
    x = np.arange(16, dtype=np.float32)

    @jpar.sharded(jm, in_specs=P("model"), out_specs=P("model"))
    def jrs(shard):
        return jpar.reduce_scatter(jnp.tile(shard, n))

    @ppar.sharded(pm, in_specs=ppar.MODEL_AXIS, out_specs=ppar.MODEL_AXIS)
    def prs(shards):
        return ppar.reduce_scatter([s.repeat(n) for s in shards], mesh=pm)

    np.testing.assert_array_equal(prs(x).numpy(), np.asarray(jrs(x)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("shift", [1, 3])
def test_ring_permute(shape, shift):
    jm, pm = meshes(shape)
    x = np.arange(8, dtype=np.float32)

    @jpar.sharded(jm, in_specs=P("model"), out_specs=P("model"))
    def jshift(shard):
        return jpar.ring_permute(shard, shift=shift)

    @ppar.sharded(pm, in_specs=ppar.MODEL_AXIS, out_specs=ppar.MODEL_AXIS)
    def pshift(shards):
        return ppar.ring_permute(shards, shift=shift, mesh=pm)

    np.testing.assert_array_equal(pshift(x).numpy(), np.asarray(jshift(x)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_axis_index_of_every_position(shape):
    jm, pm = meshes(shape)

    for axis in ("model", "data", ("data", "model")):
        @jpar.sharded(jm, in_specs=P(("data", "model")),
                      out_specs=P(("data", "model")))
        def jidx(shard, axis=axis):
            return jnp.full(shard.shape, jax.lax.axis_index(axis))

        want = np.asarray(jidx(np.zeros(8, np.int32)))
        got = [ppar.axis_index(pm, p, axis) for p in range(pm.size)]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gramian_allreduce(shape):
    jm, pm = meshes(shape)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((64, 6)).astype(np.float32)
    want = np.asarray(jgramian_allreduce(
        jax.device_put(x, NamedSharding(jm, P(("data", "model")))), jm))
    blocks = pcoll._split(x, pm, ppar.rows_spec(pm))
    got = ppar.gramian_allreduce(blocks, mesh=pm)
    assert len({id(g) for g in got}) == 1  # one result for one device
    np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-6, atol=1e-5)
    # the shard-order sum is the sum of the shards' partials in order
    total = sum(torch.matmul(b.T, b) for b in blocks)
    assert torch.equal(got[0], total)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_mesh_layout_matches_the_jax_mesh(shape):
    jm, pm = meshes(shape)
    assert pm.axis_names == tuple(jm.axis_names) == ("data", "model")
    assert pm.shape == tuple(jm.devices.shape)
    assert pm.size == jm.devices.size and not pm.spans_processes
    assert pm.local_positions() == tuple(range(8))
    assert ppar.rows_spec(pm) == tuple(jpar.rows_spec(jm)[0])
    assert ppar.data_sharding(pm) == ("data",)
    assert ppar.model_sharding(pm) == ("model",)
    assert ppar.replicated(pm) == ()


def test_make_mesh_refuses_what_the_jax_package_refuses():
    devices = ppar.local_devices("cpu")
    for kw in ({"data": 3, "model": 3}, {"model": 3}):
        with pytest.raises(ValueError) as jerr:
            jmake_mesh(**kw)
        with pytest.raises(ValueError) as perr:
            ppar.make_mesh(devices=devices, **kw)
        assert str(perr.value) == str(jerr.value)
    one = ppar.make_mesh(data=1, model=1, devices=devices[:1])
    assert one.shape == (1, 1) and one.devices == (torch.device("cpu"),)


def test_shard_map_compat_is_sharded():
    _, pm = meshes((1, 8))
    x = np.arange(8, dtype=np.float32)

    def body(shards):
        return ppar.all_reduce_sum([s * 2 for s in shards], mesh=pm)

    got = ppar.shard_map_compat(body, pm, ppar.MODEL_AXIS, None)(x)
    want = ppar.sharded(pm, ppar.MODEL_AXIS, None)(body)(x)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(got.numpy(), [2 * x.sum()])


def test_a_block_list_must_match_the_local_positions():
    _, pm = meshes((1, 8))
    with pytest.raises(ValueError, match="7 blocks for the 8 positions"):
        ppar.all_gather([torch.zeros(1)] * 7, mesh=pm)


def test_host_shard_single_process():
    # no process group: the shard is the whole array, as the JAX
    # package's single-process host_shard
    x = np.arange(10)
    np.testing.assert_array_equal(ppar.host_shard(x), x)
    np.testing.assert_array_equal(ppar.host_shard(x), jpar.host_shard(x))
    assert pmh.host_shard_bounds(10) == (0, 10)
    assert pmh.process_index() == 0 and pmh.process_count() == 1


def test_host_collectives_without_a_group_are_the_identity():
    assert not pmh.is_initialized() and pmh.backend() is None
    x = np.arange(6, dtype=np.int64)
    np.testing.assert_array_equal(pmh.allreduce_sum(x), x)
    assert pmh.broadcast_str("instance-7") == "instance-7"
    pmh.barrier("nothing")  # no group: returns at once
    a, b = np.arange(10), np.arange(10) * 2.5
    ka, kb = pmh.exchange_filtered([a, b], keep=lambda p, q: p % 3 == 0,
                                   chunk=4)
    np.testing.assert_array_equal(ka, [0, 3, 6, 9])
    np.testing.assert_array_equal(kb, [0, 7.5, 15, 22.5])
    with pytest.raises(ValueError, match="parallel arrays"):
        pmh.exchange_filtered([a, b[:3]], keep=lambda p, q: p > 0)
    # the global mesh of one process is make_mesh's
    gm = pmh.global_mesh(data=8, device="cpu")
    assert gm.shape == (8, 1) and not gm.spans_processes
    blocks = pmh.from_process_local(np.arange(16).reshape(8, 2), gm)
    assert [int(b[0]) for b in blocks] == list(range(0, 16, 2))


def test_initialize_distributed_needs_every_part(monkeypatch):
    for k in ("PIO_COORDINATOR", "PIO_NUM_PROCESSES", "PIO_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    pmh.initialize_distributed()  # nothing asked for: a no-op
    assert not pmh.is_initialized()
    with pytest.raises(ValueError, match="needs a coordinator"):
        pmh.initialize_distributed(coordinator_address="127.0.0.1:1",
                                   num_processes=2)
    with pytest.raises(ValueError, match="backend must be one of"):
        pmh.initialize_distributed("127.0.0.1:1", 1, 0, backend="mpi")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs CUDA"):
            pmh.initialize_distributed("127.0.0.1:1", 1, 0, backend="nccl")
    assert not pmh.is_initialized()
