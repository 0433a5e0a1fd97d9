"""The port's history packers against the JAX package's, element for
element: indices, values, counts and row ids, padding sentinels
included. The port packs on the CPU here (``device="cpu"``)."""

import numpy as np
import pytest

import predictionio_tpu.ops.ragged as jrag
from predictionio_tpu_torch.ops import ragged as prag


def coo(n_rows=12, n_cols=9, nnz=60, seed=0, heavy=None, empty=(3, 7)):
    """Random triples in a shuffled order; ``heavy`` rows get many more
    entries (a skewed row), ``empty`` rows none."""
    rng = np.random.default_rng(seed)
    live = np.array([r for r in range(n_rows) if r not in empty])
    rows = rng.choice(live, nnz)
    if heavy is not None:
        rows = np.concatenate([rows, np.full(heavy[1], heavy[0])])
    rng.shuffle(rows)
    cols = rng.integers(0, n_cols, len(rows))
    vals = rng.normal(size=len(rows)).astype(np.float32)
    return rows.astype(np.int32), cols.astype(np.int32), vals


def assert_padded_equal(p, j):
    np.testing.assert_array_equal(p.indices.numpy(), np.asarray(j.indices))
    np.testing.assert_array_equal(p.values.numpy(), np.asarray(j.values))
    np.testing.assert_array_equal(p.counts.numpy(), np.asarray(j.counts))
    assert p.indices.dtype.itemsize == 4 and p.values.dtype.itemsize == 4


def assert_bucketed_equal(p, j):
    assert (p.n_rows, p.n_rows_padded) == (j.n_rows, j.n_rows_padded)
    assert p.padded_entries == j.padded_entries and p.max_len == j.max_len
    assert len(p.buckets) == len(j.buckets)
    for pb, jb in zip(p.buckets, j.buckets):
        assert pb.length == jb.length and pb.n_rows == jb.n_rows
        np.testing.assert_array_equal(pb.indices.numpy(),
                                      np.asarray(jb.indices))
        np.testing.assert_array_equal(pb.values.numpy(),
                                      np.asarray(jb.values))
        np.testing.assert_array_equal(pb.counts.numpy(),
                                      np.asarray(jb.counts))
        np.testing.assert_array_equal(pb.row_ids.numpy(),
                                      np.asarray(jb.row_ids))


CASES = {
    "plain": dict(),
    "skewed_row": dict(heavy=(5, 70)),
    "no_empty_rows": dict(empty=()),
    "one_row": dict(n_rows=1, empty=(), nnz=9),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("max_len,pad_rows_to", [(None, 1), (4, 1),
                                                 (None, 8), (3, 5)])
def test_pad_pack_equals_jax(case, max_len, pad_rows_to):
    kw = dict(CASES[case])
    n_rows = kw.pop("n_rows", 12)
    rows, cols, vals = coo(n_rows=n_rows, **kw)
    counts = np.bincount(rows, minlength=n_rows)
    L = prag.resolve_max_len(counts, n_rows, max_len)
    assert L == jrag.resolve_max_len(counts, n_rows, max_len)
    j = jrag.pack_histories_device(rows, cols, vals, n_rows, L,
                                   pad_rows_to=pad_rows_to)
    p = prag.pack_histories_device(rows, cols, vals, n_rows, L,
                                   pad_rows_to=pad_rows_to, device="cpu")
    assert_padded_equal(p, j)
    # and the JAX package's host packer, which resolves the length itself
    assert_padded_equal(p, jrag.pack_histories(
        rows, cols, vals, n_rows, max_len=max_len, pad_rows_to=pad_rows_to))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("max_len,pad_rows_to,min_len",
                         [(None, 1, 8), (None, 4, 8), (6, 1, 2),
                          (None, 3, 1)])
def test_bucket_pack_equals_jax(case, max_len, pad_rows_to, min_len):
    kw = dict(CASES[case])
    n_rows = kw.pop("n_rows", 12)
    rows, cols, vals = coo(n_rows=n_rows, **kw)
    j = jrag.pack_histories_bucketed_device(
        rows, cols, vals, n_rows, pad_rows_to=pad_rows_to,
        min_len=min_len, max_len=max_len)
    p = prag.pack_histories_bucketed_device(
        rows, cols, vals, n_rows, pad_rows_to=pad_rows_to,
        min_len=min_len, max_len=max_len, device="cpu")
    assert_bucketed_equal(p, j)


def test_bucket_padding_sentinels_are_distinct():
    rows, cols, vals = coo(heavy=(2, 40))
    p = prag.pack_histories_bucketed_device(rows, cols, vals, 12,
                                            pad_rows_to=4, device="cpu")
    for b in p.buckets:  # unique within a bucket: one writeback each
        assert len(np.unique(b.row_ids.numpy())) == b.n_rows
    rid = np.concatenate([b.row_ids.numpy() for b in p.buckets])
    real = rid[rid < p.n_rows_padded]
    assert sorted(real.tolist()) == sorted(set(rows.tolist()))
    # padding rows carry no history at all
    for b in p.buckets:
        pad = b.row_ids.numpy() >= p.n_rows_padded
        assert not b.counts.numpy()[pad].any()
        assert not b.values.numpy()[pad].any()


def test_truncation_keeps_input_order():
    rows = np.array([1, 0, 1, 1, 0, 1], np.int32)
    cols = np.array([10, 20, 11, 12, 21, 13], np.int32)
    vals = np.arange(6, dtype=np.float32)
    p = prag.pack_histories_device(rows, cols, vals, 2, 2, device="cpu")
    assert p.indices.tolist() == [[20, 21], [10, 11]]
    assert p.counts.tolist() == [2, 2]
    b = prag.pack_histories_bucketed_device(rows, cols, vals, 2,
                                            max_len=3, min_len=1,
                                            device="cpu")
    assert [bk.length for bk in b.buckets] == [2, 4]
    assert b.buckets[1].indices.tolist() == [[10, 11, 12, 0]]


def test_bucket_layout_and_constants_equal_jax():
    assert prag.AUTO_CAP_ENTRIES == jrag.AUTO_CAP_ENTRIES
    counts = np.array([0, 1, 7, 8, 9, 300, 0, 33])
    for kw in (dict(), dict(min_len=1, pad_rows_to=4),
               dict(max_len=16, min_len=2)):
        pp, pb, ps = prag.bucket_layout(counts, **kw)
        jp, jb, js = jrag.bucket_layout(counts, **kw)
        assert ps == js
        np.testing.assert_array_equal(pb, jb)
        assert [(L, n, o) for L, _, n, o in pp] == \
            [(L, n, o) for L, _, n, o in jp]
        for (_, pr, _, _), (_, jr, _, _) in zip(pp, jp):
            np.testing.assert_array_equal(pr, jr)


def test_resolve_max_len_auto_cap_equals_jax():
    counts = np.ones(2_000_000, dtype=np.int64)
    counts[:5] = 5000
    got = prag.resolve_max_len(counts, len(counts), None)
    assert got == jrag.resolve_max_len(counts, len(counts), None) < 5000
    assert prag.resolve_max_len(counts, len(counts), 7) == 7


def test_empty_input_buckets():
    p = prag.pack_histories_bucketed_device(
        np.zeros(0, np.int32), np.zeros(0, np.int32),
        np.zeros(0, np.float32), 4, pad_rows_to=2, device="cpu")
    assert p.buckets == () and p.n_rows_padded == 4
