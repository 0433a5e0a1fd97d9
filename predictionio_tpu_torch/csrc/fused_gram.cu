// Fused gather + weighted Gramian for the ALS normal equations, written
// for Hopper (sm_90a), bound to PyTorch through a plain C interface
// (ctypes).
//
// Replaces: predictionio_tpu/ops/fused_gram.py::_fused_gram_kernel (:93),
// the Pallas kernel that fused_gram (:196) launches at pallas_call (:229).
//
// What it computes, for each row i of a [B, L] history block:
//   f_l   = table[idx[i, l]]              (f32, or the bf16 shadow upcast
//                                          to f32 right after the load)
//   A[i]  = sum_l wa[i, l] * f_l f_l^T    [r, r] f32
//   b[i]  = sum_l wb[i, l] * f_l          [r]    f32
// Padding slots carry w = 0 and a valid index; they are multiplied like
// every other slot, as the TPU kernel does, not skipped. An index outside
// [0, m) reads nothing and counts as a zero row. The [B, L, r] gather
// never exists in device memory: only A and b are written.
//
// What bounds it: the products, with the bytes close behind. Per slot it
// does 2*r*r + 2*r operations (8.3 kFLOP at r = 64) and reads 12 B of
// index and weights; the gathered rows come from a table read once (6.8
// MB of items, 35 MB of users at r = 64: both fit the 50 MB L2), and each
// row writes (r*r + r) * 4 B of A and b (16.6 KB). At the 67 TFLOP/s
// f32 CUDA-core peak and 3.35 TB/s (~20 operations per byte) the
// operations bound rows longer than ~40 slots and writing A bounds the
// shorter ones. At ML-20M width one iteration is ~58 M slots, ~480
// GFLOP: ~7 ms at peak, almost all of it operations.
//
// What the design does about it:
// - One block owns one row i and loops over its history in chunks of
//   kChunk slots staged in shared memory (the loop inside the block takes
//   the place of the TPU kernel's sequential grid over history chunks).
//   The row's tile (gram_tile.cuh, shared with gram_table.cu) keeps A in
//   registers as a 16 x 16 grid of TT x TT tiles, TT = ceil(r / 16).
// - The longest rows run on one SM each: the item side's top bucket at
//   ML-20M is L = 131,072 (15 rows), ~1 GFLOP each, so that launch keeps
//   15 of 132 SMs busy for 15.7 ms (chip_smoke.py on an H100 80GB HBM3 at
//   700 W), over a quarter of the kernel's time in an iteration.
//   Splitting L across blocks (partial Gramians and a second pass) is left
//   for later.
// - A at r = 128 over 138,493 rows is 2.27 G elements, past 2^31: every
//   output offset is 64-bit.
// Left for later: cp.async / TMA double-buffered row gathers, and the
// products on tensor cores -- bf16 x bf16 products are exact in f32, so
// the bf16 wire can take wgmma with f32 accumulation unchanged.

#include "gram_tile.cuh"

namespace {

template <typename T>
int launch(int device, const void* table, const void* idx, const void* wa,
           const void* wb, int B, int L, int m, int r, void* A, void* b,
           void* stream) {
  if (B < 0 || L < 0 || m < 1 || r < 1 || r > gram_tile::kMaxRank) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(gram_tile::launch_rows<T>(
      table, idx, wa, wb, B, L, m, r, A, b,
      static_cast<cudaStream_t>(stream)));
}

}  // namespace

// C entry points, one per table type. table [m, r], idx/wa/wb [B, L]
// (contiguous, int32 / f32 / f32), A [B, r, r] and b [B, r] f32 outputs.
// Pointers and the stream are passed as addresses. Returns a cudaError_t.
#define FUSED_GRAM_ENTRY(NAME, T)                                           \
  extern "C" int NAME(int device, const void* table, const void* idx,       \
                      const void* wa, const void* wb, int B, int L, int m,  \
                      int r, void* A, void* b, void* stream) {              \
    return launch<T>(device, table, idx, wa, wb, B, L, m, r, A, b, stream); \
  }

FUSED_GRAM_ENTRY(fused_gram_f32, float)
FUSED_GRAM_ENTRY(fused_gram_bf16, __nv_bfloat16)
