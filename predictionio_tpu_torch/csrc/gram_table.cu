// Gather + weighted Gramian from a fixed table held on chip, written for
// Hopper (sm_90a), bound to PyTorch through a plain C interface (ctypes).
//
// Replaces: predictionio_tpu/ops/gram.py::_gram_table_kernel (:148), the
// Pallas kernel that gram_table_pallas (:182) launches at pallas_call
// (:198).
//
// What it computes, for each row i of a [B, L] history block:
//   f_l   = table[idx[i, l]]              (f32, or bf16 upcast to f32
//                                          right after the load)
//   A[i]  = sum_l wa[i, l] * f_l f_l^T    [r, r] f32
//   b[i]  = sum_l wb[i, l] * f_l          [r]    f32
// The same (A, b) as fused_gram.cu, from the same row tile
// (gram_tile.cuh). Padding slots carry w = 0 and are multiplied, not
// skipped; an index outside [0, m) counts as a zero row.
//
// What the TPU kernel is for is residency: the whole fixed table sits in
// VMEM and only idx, wa and wb (12 B a slot) stream from HBM. Its pair-
// packing of two rows into one [L, 2r] MXU contraction is a TPU tiling
// and does not carry over. On Hopper:
//
// - Path 1, the table in shared memory. When m * r * sizeof(T) fits a
//   block's opt-in shared memory (227 KB: 800+ rows at r = 64 f32, twice
//   that in bf16), each block of a persistent grid copies the table in
//   once with 16-byte loads, then strides over rows; every gather is a
//   shared-memory read. The launch raises the dynamic shared-memory
//   limit and checks the error.
// - Path 2, larger tables (the ML-20M item table at r = 64 is 6.85 MB):
//   one block per row gathers each chunk's rows from global memory, where
//   the 50 MB L2 holds the table. This is fused_gram.cu's launch. A
//   persisting L2 access-policy window over the table gained nothing
//   measurable on that table (chip_smoke.py, phase gram-table, times the
//   launch with one and without), so the launch sets none.
//
// What bounds it: the products. Per slot r(r+1)/2 + 2r useful operations
// (the symmetric A, wa * f, b) against 12 B of idx and weights; the table
// is read once and each row writes (r*r + r) * 4 B of A and b. At r = 64,
// B = 8,192, L = 512 that is 18.8 GFLOP against 184 MB: 0.28 ms at the
// 67 TFLOP/s f32 peak, 0.055 ms at 3.35 TB/s.
//
// Left for later: a thread-block cluster sharing the table through
// distributed shared memory (16 x 227 KB holds the bf16 ML-20M item
// table), and the products on tensor cores (wgmma).

#include "gram_tile.cuh"

namespace {

using gram_tile::kGrid;
using gram_tile::kThreads;

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// Dynamic shared memory of path 1: [table][staging of one chunk].
template <typename T, int TT>
constexpr size_t resident_smem(int m, int r) {
  return align16(static_cast<size_t>(m) * r * sizeof(T)) +
         sizeof(gram_tile::Stage<TT, true>);
}

template <typename T, int TT>
__global__ void __launch_bounds__(kThreads)
gram_table_resident(const T* __restrict__ table, const int* __restrict__ idx,
                    const float* __restrict__ wa,
                    const float* __restrict__ wb, int B, int L, int m, int r,
                    float* __restrict__ A, float* __restrict__ bout) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t nbytes = static_cast<size_t>(m) * r * sizeof(T);
  auto& st = *reinterpret_cast<gram_tile::Stage<TT, true>*>(
      smem + align16(nbytes));

  // the whole table, once per block: 16-byte loads where aligned
  const unsigned char* src = reinterpret_cast<const unsigned char*>(table);
  size_t done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const size_t n16 = nbytes / 16;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(smem);
    for (size_t k = threadIdx.x; k < n16; k += kThreads) d4[k] = s4[k];
    done = n16 * 16;
  }
  for (size_t k = done + threadIdx.x; k < nbytes; k += kThreads) {
    smem[k] = src[k];
  }
  // gram_row's first __syncthreads publishes the table

  const T* s_tab = reinterpret_cast<const T*>(smem);
  for (size_t row = blockIdx.x; row < static_cast<size_t>(B);
       row += gridDim.x) {
    gram_tile::gram_row<T, TT, true>(
        s_tab, idx + row * L, wa + row * L, wb + row * L, L, m, r, st,
        A + row * static_cast<size_t>(r) * r, bout + row * r);
  }
}

// Path 1: a persistent grid of resident-table blocks, as many as fit.
template <typename T, int TT>
cudaError_t launch_resident(const void* table, const void* idx,
                            const void* wa, const void* wb, int B, int L,
                            int m, int r, void* A, void* b,
                            cudaStream_t stream, int n_sm) {
  auto kern = gram_table_resident<T, TT>;
  const size_t smem = resident_smem<T, TT>(m, r);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long want = static_cast<long long>(per_sm) * n_sm;
  const int grid = static_cast<int>(want < B ? want : B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(table), static_cast<const int*>(idx),
      static_cast<const float*>(wa), static_cast<const float*>(wb), B, L, m,
      r, static_cast<float*>(A), static_cast<float*>(b));
  return cudaGetLastError();
}

template <typename T>
int launch(int device, const void* table, const void* idx, const void* wa,
           const void* wb, int B, int L, int m, int r, void* A, void* b,
           void* stream, int* path) {
  *path = 0;
  if (B < 0 || L < 0 || m < 1 || r < 1 || r > gram_tile::kMaxRank) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int optin = 0, n_sm = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tt = (r + kGrid - 1) / kGrid;
  // resident_smem at TT = 8 is the largest staging, so a table that fits
  // there fits at every TT
  if (resident_smem<T, 8>(m, r) <= static_cast<size_t>(optin)) {
    *path = 1;
#define RESIDENT_CASE(TT)                                                  \
  case TT:                                                                 \
    err = launch_resident<T, TT>(table, idx, wa, wb, B, L, m, r, A, b, s,  \
                                 n_sm);                                    \
    break;
    switch (tt) {
      RESIDENT_CASE(1)
      RESIDENT_CASE(2)
      RESIDENT_CASE(3)
      RESIDENT_CASE(4)
      RESIDENT_CASE(5)
      RESIDENT_CASE(6)
      RESIDENT_CASE(7)
      default:
      RESIDENT_CASE(8)
    }
#undef RESIDENT_CASE
    return static_cast<int>(err);
  }
  *path = 2;
  return static_cast<int>(
      gram_tile::launch_rows<T>(table, idx, wa, wb, B, L, m, r, A, b, s));
}

}  // namespace

// C entry points, one per table type. table [m, r], idx/wa/wb [B, L]
// (contiguous, int32 / f32 / f32), A [B, r, r] and b [B, r] f32 outputs.
// Pointers and the stream are passed as addresses; *path receives 1 (the
// table in shared memory) or 2 (rows gathered through L2). Returns a
// cudaError_t.
#define GRAM_TABLE_ENTRY(NAME, T)                                          \
  extern "C" int NAME(int device, const void* table, const void* idx,      \
                      const void* wa, const void* wb, int B, int L, int m, \
                      int r, void* A, void* b, void* stream, int* path) {  \
    return launch<T>(device, table, idx, wa, wb, B, L, m, r, A, b, stream, \
                     path);                                                \
  }

GRAM_TABLE_ENTRY(gram_table_f32, float)
GRAM_TABLE_ENTRY(gram_table_bf16, __nv_bfloat16)
