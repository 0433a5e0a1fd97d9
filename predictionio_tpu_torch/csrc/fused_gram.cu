// Fused gather + weighted Gramian for the ALS normal equations, written
// for Hopper (sm_90a), bound to PyTorch through a plain C interface
// (ctypes).
//
// Replaces: predictionio_tpu/ops/fused_gram.py::_fused_gram_kernel (:93),
// the Pallas kernel that fused_gram (:196) launches at pallas_call (:229).
//
// What it computes, for each row i of a [B, L] history block:
//   f_l   = table[idx[i, l]]              (f32, or the bf16 shadow upcast
//                                          to f32 after the load)
//   A[i]  = sum_l wa[i, l] * f_l f_l^T    [r, r] f32
//   b[i]  = sum_l wb[i, l] * f_l          [r]    f32
// Padding slots carry w = 0 and a valid index; they are multiplied like
// every other slot, as the TPU kernel does, not skipped. An index outside
// [0, m) reads nothing and counts as a zero row. The [B, L, r] gather
// never exists in device memory: only A and b are written.
//
// What bounds it on this card: the products. Per slot the symmetric A
// needs r(r+1)/2 multiply-adds, wa * f and b another 2r (r*r + 4r
// operations, 4.4 k at r = 64) against 12 B of index and weights; the
// gathered rows come from a table read once (6.8 MB of items, 35 MB of
// users at r = 64: both fit the 50 MB L2), and each row writes (r*r + r)
// * 4 B of A and b (16.6 KB). At the 67 TFLOP/s f32 CUDA-core peak and
// 3.35 TB/s the operations bound rows longer than ~40 slots and writing A
// the shorter ones. One ML-20M iteration is ~58 M slots: ~4 ms at peak.
// wa * f must stay f32 (wa = alpha * rating for implicit feedback), so
// tensor cores are out on both wires: bf16 x bf16 products are exact in
// f32, but (wa * f) is no bf16 value.
//
// What the design does about it (the tile and its pipeline are
// gram_tile.cuh, shared with gram_table.cu):
// - The grid is rows x L-splits. ops/fused_gram.py::gram_plan picks the
//   split count from B and L: many short rows stay one block a row, a few
//   long rows (the item side's L = 131,072 bucket is 15 rows) are cut
//   into ranges of slots so that every SM has blocks. Partial A and b go
//   to a scratch [B, splits, r*r + r] that the wrapper allocated and a
//   second pass adds them in the order of the splits: no atomicAdd, so
//   training gives the same factors run after run.
// - Only the lower triangle of A is multiplied, 4 x 4 blocks in
//   registers, two 16-byte shared-memory reads for 16 FMAs a slot; the
//   mirror is written on the way out.
// - Rows are gathered by 16-byte cp.async copies into two buffers, chunk
//   c + 1 in flight while chunk c is multiplied; rows that are not whole
//   16-byte pieces (rank 10) take the element-wise branch of the same
//   loop.
// - A at r = 128 over 138,493 rows is 2.27 G elements, past 2^31: every
//   output offset is 64-bit.
// Still left: the Gramian fused with the solve that follows it (A would
// never reach device memory), TMA gathers, and a tensor-core path for
// explicit feedback alone (wa in {0, 1}).

#include "gram_tile.cuh"

namespace {

template <typename T>
int launch(int device, const void* table, const void* idx, const void* wa,
           const void* wb, int B, int L, int m, int r, int splits, int vec16,
           void* scratch, void* A, void* b, void* stream) {
  if (B < 0 || L < 0 || m < 1 || r < 1 || r > gram_tile::kMaxRank) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(gram_tile::launch_rows<T>(
      table, idx, wa, wb, B, L, m, r, splits, vec16, scratch, A, b,
      static_cast<cudaStream_t>(stream)));
}

}  // namespace

// C entry points, one per table type. table [m, r], idx/wa/wb [B, L]
// (contiguous, int32 / f32 / f32), A [B, r, r] and b [B, r] f32 outputs.
// splits (ranges a row's slots are cut into) and vec16 (16-byte
// asynchronous gathers) are ops/fused_gram.py::gram_plan's; scratch [B,
// splits, r*r + r] f32 is read and written only when splits > 1. Pointers
// and the stream are passed as addresses. Returns a cudaError_t.
#define FUSED_GRAM_ENTRY(NAME, T)                                           \
  extern "C" int NAME(int device, const void* table, const void* idx,       \
                      const void* wa, const void* wb, int B, int L, int m,  \
                      int r, int splits, int vec16, void* scratch, void* A, \
                      void* b, void* stream) {                              \
    return launch<T>(device, table, idx, wa, wb, B, L, m, r, splits, vec16, \
                     scratch, A, b, stream);                                \
  }

FUSED_GRAM_ENTRY(fused_gram_f32, float)
FUSED_GRAM_ENTRY(fused_gram_bf16, __nv_bfloat16)

// Host queries for the shared-memory audit. fused_gram_smem_bytes is
// gram_tile::stage_bytes<T>(r) for f32 (itemsize 4) or bf16 (2) tables
// (ops/smem.py::gram_stage_bytes is the same sum), -1 for another
// itemsize; fused_gram_static_smem writes the row kernel's static shared
// memory to *out. Returns a cudaError_t.
extern "C" long long fused_gram_smem_bytes(int r, int itemsize) {
  if (itemsize == 4) return (long long)gram_tile::stage_bytes<float>(r);
  if (itemsize == 2) {
    return (long long)gram_tile::stage_bytes<__nv_bfloat16>(r);
  }
  return -1;
}

extern "C" int fused_gram_static_smem(int itemsize, long long* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaErrorInvalidValue;
  if (itemsize == 4) {
    err = cudaFuncGetAttributes(&a, gram_tile::gram_rows_kernel<float>);
  }
  if (itemsize == 2) {
    err = cudaFuncGetAttributes(&a,
                                gram_tile::gram_rows_kernel<__nv_bfloat16>);
  }
  if (err == cudaSuccess) *out = static_cast<long long>(a.sharedSizeBytes);
  return static_cast<int>(err);
}
