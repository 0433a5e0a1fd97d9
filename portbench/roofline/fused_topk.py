"""``fused_topk`` (``csrc/fused_topk.cu``): each query row scored
against the whole item table, and its top ``k`` kept.

Per flush of ``B`` rows ``2 B I r`` operations at the wire's peak (f32
outside the tensor cores for the f32 wire). Bytes: the ``B`` gathered
user rows and the ``I`` item rows read once (at the wire's item size),
the row ids once, and the ``[B, k]`` scores and ids written once."""

KERNELS = ("fused_topk_kernel", "merge_topk_kernel")


def ops(rows: int, n_items: int, rank: int) -> float:
    return 2.0 * rows * n_items * rank


def nbytes(rows: int, flushes: int, n_items: int, rank: int, k: int,
           itemsize: int = 4) -> float:
    return (float(rows) * (rank * itemsize + 4 + k * 8)
            + float(flushes) * n_items * rank * itemsize)
