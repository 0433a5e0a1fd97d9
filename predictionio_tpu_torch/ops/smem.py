"""Dynamic shared memory of each hand-written kernel, in bytes.

One formula a kernel, each the same sum as the C function its launcher
calls before the launch (named beside it), and each exported by the
kernel's library as ``extern "C" long long <name>_smem_bytes(...)`` so
that the card can hold the C to this file. The launchers size their
launches from here (``fused_topk.py::topk_plan``,
``solve.py::solve_plan``).

The module imports nothing, not even torch, and keeps to the subset of
Python that ``analysis/interp.py`` interprets: the ``smem-overbudget``
rule of ``analysis/kernels.py`` evaluates :data:`KERNELS` over every
point a launcher accepts without executing the module.

:data:`KERNELS` names, for each kernel, its source under ``csrc/``, the
kernel expression its ``<<<…>>>`` launch names, its C export and the
export's argument order, ``bytes(point)``, ``grid()`` (every point the
launcher accepts) and ``refuses(point, nbytes)`` (the launcher's own
refusal of a point, mirroring its code).
"""

#: dynamic shared memory a block may ask for on Hopper once it opts in
#: (``cudaDevAttrMaxSharedMemoryPerBlockOptin`` on an H100: 227 KB)
SMEM_LIMIT = 232_448

#: dynamic shared memory a launch takes without opting in
DEFAULT_LIMIT = 48 * 1024

# ---- fused_topk (csrc/fused_topk.cu) ---------------------------------------

#: kMaxRank, kMaxK, kMaxQB, the chunk sizes, and the list lengths
TOPK_MAX_RANK = 256
TOPK_MAX_K = 128
TOPK_MAX_QB = 64
TOPK_CHUNKS = (32, 64, 128)
#: bytes of an element on each wire: f32, bf16, int8
TOPK_WIRES = (4, 2, 1)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def topk_smem_bytes(row_bytes: int, qb: int, chunk: int, k: int) -> int:
    """Dynamic shared memory of one block (``csrc/fused_topk.cu``
    smem_bytes): two item tiles and the user rows at a stride of the row
    padded to 32 bytes plus 16, per-query scales, thresholds and counts,
    the running lists (32 entries for k <= 32, else 128) and the
    candidate lists."""
    sw = _ceil_div(row_bytes, 32) * 8 + 4
    words = (2 * chunk * sw + qb * sw + 4 * qb
             + 2 * qb * (32 if k <= 32 else 128) + 2 * qb * chunk)
    return 4 * words


def topk_fit(row_bytes: int, qb: int, k: int, limit: int = SMEM_LIMIT):
    """``(qb, chunk)`` of a block that fits ``limit``: 128-row tiles and
    ``qb`` queries first, then the tiles halved down to 32 rows, then the
    queries halved in whole warps (``fused_topk.py::topk_plan``). Raises
    ValueError where not even 8 queries and 32 rows fit."""
    chunk = TOPK_CHUNKS[-1]
    while topk_smem_bytes(row_bytes, qb, chunk, k) > limit:
        if chunk > TOPK_CHUNKS[0]:
            chunk //= 2
        elif qb > 8:
            qb = 8 * _ceil_div(qb // 2, 8)
        else:
            raise ValueError(f"rows of {row_bytes} bytes and k {k} do not "
                             f"fit a block's shared memory")
    return qb, chunk


def _topk_grid():
    """Every (row_bytes, qb, chunk, k) ``topk_plan`` can launch: each
    wire, rank, list length (k <= 32 and past it) and starting block of
    queries, fitted. A point that does not fit raises there: refused."""
    seen = set()
    for itemsize in TOPK_WIRES:
        for r in range(1, TOPK_MAX_RANK + 1):
            for k in (32, TOPK_MAX_K):
                for qb0 in range(8, TOPK_MAX_QB + 1, 8):
                    try:
                        qb, chunk = topk_fit(r * itemsize, qb0, k)
                    except ValueError:
                        continue
                    point = (r * itemsize, qb, chunk, k)
                    if point not in seen:
                        seen.add(point)
                        yield point


# ---- chol_solve (csrc/chol_solve.cu) ---------------------------------------

#: kMaxRank, kRegMaxRank, kChunk, kWarpsPerBlock
CHOL_MAX_RANK = 128
CHOL_REG_MAX_RANK = 64
CHOL_CHUNK = 8
CHOL_WARPS_PER_BLOCK = 4


def chol_padded_rank(r: int) -> int:
    """The kernel's rank for ``r``: a multiple of 16 up to 64, 96 or 128
    past it."""
    if not 1 <= r <= CHOL_MAX_RANK:
        raise ValueError(f"the kernel takes rank 1..{CHOL_MAX_RANK}, got {r}")
    if r <= CHOL_REG_MAX_RANK:
        return -(-r // 16) * 16
    return 96 if r <= 96 else 128


def chol_systems_per_warp(R: int) -> int:
    """Systems one warp solves at padded rank ``R``: up to rank 64 each
    takes ``R / 2`` lanes, rounded up to a power of two; past it, one."""
    if R > CHOL_REG_MAX_RANK:
        return 1
    return 32 // (1 << max(0, (R // 2 - 1).bit_length()))


def _tri_floats(R: int) -> int:
    """Floats of L's ``R`` rows, row ``i`` rounded up to whole 16-byte
    words (``csrc/chol_solve.cu`` tri_offset)."""
    return sum(-(-(i + 1) // 4) * 4 for i in range(R))


def chol_smem_bytes(R: int, warps: int) -> int:
    """Dynamic shared memory of one block of ``warps`` warps at padded
    rank ``R``: up to rank 64 (``reg_smem_bytes``) each of a warp's
    ``32 / pow2(R/2)`` systems keeps two multiplier vectors of ``R + 8``
    floats and L's rows; past it (``shm_smem_bytes``) a warp's one system
    keeps its ``R x (R+4)`` matrix and two multiplier rows of ``R``."""
    if R <= CHOL_REG_MAX_RANK:
        floats = chol_systems_per_warp(R) * (2 * (R + CHOL_CHUNK)
                                             + _tri_floats(R))
    else:
        floats = R * (R + 4) + 2 * R
    return warps * floats * 4


def _chol_grid():
    """Every (R, warps) ``solve_plan`` launches: each padded rank of
    r <= 128, 1..4 warps a block up to rank 64 and one past it."""
    for R in sorted({chol_padded_rank(r)
                     for r in range(1, CHOL_MAX_RANK + 1)}):
        top = CHOL_WARPS_PER_BLOCK if R <= CHOL_REG_MAX_RANK else 1
        for warps in range(1, top + 1):
            yield (R, warps)


# ---- fused_gram (csrc/gram_tile.cuh) ----------------------------------------

#: kMaxRank, kChunk, kMetaRing of the tile; the f32 and bf16 wires
GRAM_MAX_RANK = 128
GRAM_CHUNK = 32
GRAM_META_RING = 3
GRAM_WIRES = (4, 2)


def gram_stage_bytes(r: int, itemsize: int) -> int:
    """Shared memory of one block's tile (``gram_tile.cuh``
    stage_bytes): two buffers of 32 gathered rows padded to a multiple of
    8 elements and the ring of indices and weights; after the last chunk
    the same bytes hold A at a row stride of ``r + 1`` words, and b."""
    staging = (2 * GRAM_CHUNK * ((r + 7) & ~7) * itemsize
               + GRAM_META_RING * GRAM_CHUNK * 12)
    out = (r * (r + 1) + r) * 4
    return max(staging, out)


def _gram_grid():
    for itemsize in GRAM_WIRES:
        for r in range(1, GRAM_MAX_RANK + 1):
            yield (r, itemsize)


# ---- gram_table (csrc/gram_table.cu) ----------------------------------------

#: slots of indices and weights a group (a lane each); the most workers
#: of a path-2 block whose workers are several warps (named barriers
#: 1..15)
TABLE_GROUP = 32
TABLE_MAX_BARRIER_WORKERS = 15
#: buffers of gathered rows a path-2 worker takes (kBuffers)
TABLE_BUFFERS = 2


def table_worker_warps(strips: int) -> int:
    """Warps of a row worker at ``strips`` 16-row strips of A
    (``gram_table.cu`` worker_warps): one a pair of strips."""
    return (strips + 1) // 2


def table_max_threads(strips: int) -> int:
    """Most threads of a block at ``strips`` strips (``gram_table.cu``
    max_threads, its kernels' launch bounds): what the register file
    gives warps that hold 2 S + 2 tiles of 4 sums each (16 warps leave
    128 registers a thread, 12 leave 168)."""
    if strips <= 2:
        return 640
    if strips <= 4:
        return 512
    return 384


def table_row_words(r: int, itemsize: int) -> int:
    """32-bit words a table row takes in shared memory (``gram_table.cu``
    row_words): whole 16-column strips of A, then up to a stride of 8 or
    24 words past a multiple of 32, so that the four slots of a k-step
    read four bank windows."""
    w = -(-r // 16) * 16 * itemsize // 4
    while w % 32 != 8 and w % 32 != 24:
        w += 4
    return w


def gram_resident_bytes(m: int, r: int, itemsize: int) -> int:
    """Shared memory of ``gram_table``'s path 1: the whole ``[m, r]``
    table and a zero row (for indices outside it), at
    :func:`table_row_words` a row."""
    return (m + 1) * table_row_words(r, itemsize) * 4


def gram_staged_bytes(r: int, itemsize: int, workers: int) -> int:
    """Shared memory of ``gram_table``'s path 2: :data:`TABLE_BUFFERS`
    buffers of :data:`TABLE_GROUP` gathered rows for each of ``workers``
    workers."""
    return (workers * TABLE_BUFFERS * TABLE_GROUP
            * table_row_words(r, itemsize) * 4)


def gram_table_bytes(path: int, m: int, r: int, itemsize: int,
                     workers: int) -> int:
    """Dynamic shared memory of one ``gram_table`` block
    (``gram_table.cu`` table_smem): path 1 the resident table, path 2
    the workers' buffers."""
    if path == 1:
        return gram_resident_bytes(m, r, itemsize)
    return gram_staged_bytes(r, itemsize, workers)


def table_workers(path: int, r: int, itemsize: int,
                  limit: int = SMEM_LIMIT) -> int:
    """Row workers of one block (``ops/gram.py::table_plan``): as many
    as the strips' thread budget gives; on path 2 no more than the
    named barriers and ``limit`` bytes of buffers allow."""
    strips = -(-r // 16)
    warps = table_worker_warps(strips)
    workers = table_max_threads(strips) // (32 * warps)
    if path == 2:
        if warps > 1:
            workers = min(workers, TABLE_MAX_BARRIER_WORKERS)
        workers = min(workers, limit // gram_staged_bytes(r, itemsize, 1))
    return workers


def _table_grid():
    """Every (path, m, r, itemsize, workers) ``table_plan`` can launch:
    path 2 at every rank and wire (its bytes do not hang on the table),
    path 1 at table heights up to the largest that could fit; the plan
    takes path 1 only where the card's opt-in limit holds the block."""
    for itemsize in GRAM_WIRES:
        for r in range(1, GRAM_MAX_RANK + 1):
            yield (2, 1, r, itemsize, table_workers(2, r, itemsize))
            workers = table_workers(1, r, itemsize)
            m = 1
            while m * r * itemsize <= 2 * SMEM_LIMIT:
                yield (1, m, r, itemsize, workers)
                m *= 2


def _never(point, nbytes) -> bool:
    return False


def _over_optin(point, nbytes) -> bool:
    # gram_table.cu launch: a plan only within the card's
    # cudaDevAttrMaxSharedMemoryPerBlockOptin (table_plan takes path 2
    # where the resident table does not fit)
    return nbytes > SMEM_LIMIT


KERNELS = {
    "fused_topk": {
        "source": "fused_topk.cu",
        "launch": "fused_topk_kernel<T>",
        "export": "fused_topk_smem_bytes",
        "args": ("row_bytes", "qb", "chunk", "k"),
        "bytes": lambda p: topk_smem_bytes(*p),
        "grid": _topk_grid,
        "refuses": _never,
    },
    "chol_solve": {
        "source": "chol_solve.cu",
        "launch": "kernel",
        "export": "chol_solve_smem_bytes",
        "args": ("rp", "warps"),
        "bytes": lambda p: chol_smem_bytes(*p),
        "grid": _chol_grid,
        "refuses": _never,
    },
    "fused_gram": {
        "source": "gram_tile.cuh",
        "launch": "gram_rows_kernel<T>",
        "export": "fused_gram_smem_bytes",
        "args": ("r", "itemsize"),
        "bytes": lambda p: gram_stage_bytes(*p),
        "grid": _gram_grid,
        "refuses": _never,
    },
    "gram_table": {
        "source": "gram_table.cu",
        "launch": "kern",
        "export": "gram_table_smem_bytes",
        "args": ("path", "m", "r", "itemsize", "workers"),
        "bytes": lambda p: gram_table_bytes(*p),
        "grid": _table_grid,
        "refuses": _over_optin,
    },
}
