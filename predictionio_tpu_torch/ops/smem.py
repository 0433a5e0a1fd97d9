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


# ---- fused_gram and gram_table (csrc/gram_tile.cuh, csrc/gram_table.cu) ----

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


def gram_resident_bytes(m: int, r: int, itemsize: int) -> int:
    """Shared memory of ``gram_table``'s path 1 (``gram_table.cu``
    resident_smem): the whole ``[m, r]`` table, 16-byte aligned, then the
    tile's staging."""
    return ((m * r * itemsize + 15) & ~15) + gram_stage_bytes(r, itemsize)


def _gram_grid():
    for itemsize in GRAM_WIRES:
        for r in range(1, GRAM_MAX_RANK + 1):
            yield (r, itemsize)


def _resident_grid():
    """Table heights up to the largest that could fit, at every rank and
    wire; the launcher takes path 1 only where the card's opt-in limit
    holds the block and path 2 (the tile alone) elsewhere."""
    for itemsize in GRAM_WIRES:
        for r in range(1, GRAM_MAX_RANK + 1):
            m = 1
            while m * r * itemsize <= 2 * SMEM_LIMIT:
                yield (m, r, itemsize)
                m *= 2


def _never(point, nbytes) -> bool:
    return False


def _over_optin(point, nbytes) -> bool:
    # gram_table.cu launch: path 1 only when resident_smem <= the card's
    # cudaDevAttrMaxSharedMemoryPerBlockOptin
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
        "args": ("m", "r", "itemsize"),
        "bytes": lambda p: gram_resident_bytes(*p),
        "grid": _resident_grid,
        "refuses": _over_optin,
    },
}
