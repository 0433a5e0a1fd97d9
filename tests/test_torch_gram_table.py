"""The port's ``gram_table`` against the JAX package's ``gram_table_pallas``.

The JAX kernel runs in interpret mode on the CPU, as
``tests/test_ops.py::test_gram_table_pallas_interpret`` runs it; the
port's wrapper takes its plain version for CPU tensors. Same inputs, made
with numpy from a seed. Tolerance: rtol 1e-4, atol 1e-4, the JAX test's
own (f32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops.gram import gram_table_pallas
from predictionio_tpu_torch.ops import _build, gram


def inputs(m, r, B, L, seed=4):
    rng = np.random.default_rng(seed)
    tab = rng.standard_normal((m, r)).astype(np.float32)
    idx = rng.integers(0, m, (B, L)).astype(np.int32)
    wa = rng.random((B, L)).astype(np.float32)
    wb = rng.random((B, L)).astype(np.float32)
    return tab, idx, wa, wb


@pytest.mark.parametrize("m,r,B,L", [(200, 16, 21, 24), (300, 64, 9, 40)],
                         ids=["jax-test-shape", "rank-64"])
def test_matches_jax_kernel_in_interpret_mode(m, r, B, L):
    tab, idx, wa, wb = inputs(m, r, B, L)
    jA, jb = gram_table_pallas(jnp.asarray(tab), jnp.asarray(idx),
                               jnp.asarray(wa), jnp.asarray(wb),
                               interpret=True)
    A, b = gram.gram_table(*(torch.from_numpy(x) for x in (tab, idx, wa, wb)))
    assert A.dtype == b.dtype == torch.float32
    assert A.shape == (B, r, r) and b.shape == (B, r)
    np.testing.assert_allclose(A.numpy(), np.asarray(jA), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-4,
                               atol=1e-4)


def test_padding_slots_count_nothing():
    """w = 0 slots are multiplied, not skipped, and add nothing."""
    tab, idx, wa, wb = inputs(50, 16, 6, 12, seed=1)
    wa[:, 7:] = 0.0
    wb[:, 7:] = 0.0
    t = torch.from_numpy
    A, b = gram.gram_table(t(tab), t(idx), t(wa), t(wb))
    A7, b7 = gram.gram_table(t(tab), t(np.ascontiguousarray(idx[:, :7])),
                             t(np.ascontiguousarray(wa[:, :7])),
                             t(np.ascontiguousarray(wb[:, :7])))
    np.testing.assert_allclose(A.numpy(), A7.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(b.numpy(), b7.numpy(), rtol=1e-6, atol=1e-6)


def test_bf16_table_is_upcast_exactly():
    tab, idx, wa, wb = inputs(64, 32, 5, 10, seed=2)
    t16 = torch.from_numpy(tab).bfloat16()
    A, b = gram.gram_table(t16, torch.from_numpy(idx), torch.from_numpy(wa),
                           torch.from_numpy(wb))
    Ar, br = gram.gram_table_reference(t16.float(), torch.from_numpy(idx),
                                       torch.from_numpy(wa),
                                       torch.from_numpy(wb))
    assert torch.equal(A, Ar) and torch.equal(b, br)


def test_cpu_tensors_launch_nothing():
    before = gram.LAUNCHES
    tab, idx, wa, wb = inputs(20, 8, 3, 4)
    gram.gram_table(*(torch.from_numpy(x) for x in (tab, idx, wa, wb)))
    assert gram.LAUNCHES == before


def test_shape_mismatch_raises():
    tab, idx, wa, wb = inputs(20, 8, 3, 4)
    with pytest.raises(ValueError, match="one \\[B, L\\] shape"):
        gram.gram_table(torch.from_numpy(tab), torch.from_numpy(idx),
                        torch.from_numpy(wa[:, :2]), torch.from_numpy(wb))


def test_kernel_source_is_built_with_the_others():
    assert "gram_table" in _build.all_sources()
    src = (_build.CSRC / "gram_table.cu").read_text()
    assert "predictionio_tpu/ops/gram.py::_gram_table_kernel" in src
    assert '#include "gram_tile.cuh"' in src  # fused_gram.cu's row tile
    for entry in gram._ENTRY.values():
        assert f"GRAM_TABLE_ENTRY({entry}," in src
