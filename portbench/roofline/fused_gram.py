"""``fused_gram`` (``csrc/fused_gram.cu``): each row's gather and
weighted Gramian, ``A = sum_l wa f f^T`` and ``b = sum_l wb f``.

The least work is that of the row's real ratings, never its padding:
per rating ``r(r+1)/2`` multiply-adds for the distinct entries of the
symmetric ``A``, ``r`` multiplies for ``wa * f`` and ``r`` multiply-adds
for ``b``: ``r^2 + 4r`` operations. Bytes: each table row the ratings
name read once, each rating's index and two weights (12 bytes) once,
each solved row's ``A`` (all ``r x r``, as the kernel returns it) and
``b`` written once."""

#: the device kernels the wrapper launches (its rows and its partial sums)
KERNELS = ("gram_rows_kernel", "sum_partials")
PRECISION = "f32"


def ops(slots: int, rank: int) -> float:
    return float(slots) * (rank * rank + 4 * rank)


def nbytes(slots: int, rows_out: int, rows_read: int, rank: int,
           itemsize: int = 4) -> float:
    return (float(rows_read) * rank * itemsize + float(slots) * 12
            + float(rows_out) * (rank * rank + rank) * 4)
