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
// - Path 1, the table in shared memory. When m * r * sizeof(T) and the
//   tile's staging buffers fit a block's opt-in shared memory (227 KB:
//   800+ rows at r = 64 f32, twice that in bf16), each block of a
//   persistent grid copies the table in once with 16-byte loads, then
//   strides over rows; every gather is a shared-memory read, staged into
//   the tile's buffers by its element-wise branch (cp.async reads global
//   memory only). The launch raises the dynamic shared-memory limit and
//   checks the error.
// - Path 2, larger tables (the ML-20M item table at r = 64 is 6.85 MB):
//   one block per row gathers each chunk's rows from global memory by
//   16-byte cp.async copies, where the 50 MB L2 holds the table. This is
//   fused_gram.cu's launch at one split. A persisting L2 access-policy
//   window over the table gained nothing measurable on that table
//   (chip_smoke.py, phase gram-table, times the launch with one and
//   without), so the launch sets none.
//
// What bounds it: the products. Per slot r(r+1)/2 + 2r useful operations
// (the symmetric A, wa * f, b) against 12 B of idx and weights; the table
// is read once and each row writes (r*r + r) * 4 B of A and b. At r = 64,
// B = 8,192, L = 512 that is 18.8 GFLOP against 184 MB: 0.28 ms at the
// 67 TFLOP/s f32 peak, 0.055 ms at 3.35 TB/s. The tile (gram_tile.cuh)
// multiplies only A's lower triangle, in f32 on both wires.
//
// Left for later: a thread-block cluster sharing the table through
// distributed shared memory (16 x 227 KB holds the bf16 ML-20M item
// table), reading resident rows where they lie instead of staging them,
// and splitting long rows as fused_gram does.

#include "gram_tile.cuh"

namespace {

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// Dynamic shared memory of path 1: [table][the tile's staging].
template <typename T>
size_t resident_smem(int m, int r) {
  return align16(static_cast<size_t>(m) * r * sizeof(T)) +
         gram_tile::stage_bytes<T>(r);
}

template <typename T>
__global__ void __launch_bounds__(gram_tile::kMaxThreads)
gram_table_resident(const T* __restrict__ table, const int* __restrict__ idx,
                    const float* __restrict__ wa,
                    const float* __restrict__ wb, int B, int L, int m, int r,
                    float* __restrict__ A, float* __restrict__ bout) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t nbytes = static_cast<size_t>(m) * r * sizeof(T);
  unsigned char* stage = smem + align16(nbytes);

  // the whole table, once per block: 16-byte loads where aligned
  const unsigned char* src = reinterpret_cast<const unsigned char*>(table);
  size_t done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const size_t n16 = nbytes / 16;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(smem);
    for (size_t k = threadIdx.x; k < n16; k += blockDim.x) d4[k] = s4[k];
    done = n16 * 16;
  }
  for (size_t k = done + threadIdx.x; k < nbytes; k += blockDim.x) {
    smem[k] = src[k];
  }
  // gram_row's first __syncthreads publishes the table

  const T* s_tab = reinterpret_cast<const T*>(smem);
  for (size_t row = blockIdx.x; row < static_cast<size_t>(B);
       row += gridDim.x) {
    gram_tile::gram_row<T>(s_tab, idx + row * L, wa + row * L, wb + row * L,
                           L, m, r, false, stage,
                           A + row * (size_t)r * (size_t)r,
                           bout + row * (size_t)r);
  }
}

// Path 1: a persistent grid of resident-table blocks, as many as fit.
template <typename T>
cudaError_t launch_resident(const void* table, const void* idx,
                            const void* wa, const void* wb, int B, int L,
                            int m, int r, void* A, void* b,
                            cudaStream_t stream, int n_sm) {
  auto kern = gram_table_resident<T>;
  const size_t smem = resident_smem<T>(m, r);
  const int threads = gram_tile::block_threads(r);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long want = static_cast<long long>(per_sm) * n_sm;
  const int grid = static_cast<int>(want < B ? want : B);
  kern<<<grid, threads, smem, stream>>>(
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
  if (resident_smem<T>(m, r) <= static_cast<size_t>(optin)) {
    *path = 1;
    return static_cast<int>(
        launch_resident<T>(table, idx, wa, wb, B, L, m, r, A, b, s, n_sm));
  }
  *path = 2;
  const int vec16 = (r * sizeof(T)) % 16 == 0 &&
                    (reinterpret_cast<uintptr_t>(table) & 15) == 0;
  return static_cast<int>(gram_tile::launch_rows<T>(
      table, idx, wa, wb, B, L, m, r, 1, vec16, nullptr, A, b, s));
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

// Host queries for the shared-memory audit. gram_table_smem_bytes is path
// 1's resident_smem<T>(m, r) for f32 (itemsize 4) or bf16 (2) tables
// (ops/smem.py::gram_resident_bytes is the same sum), -1 for another
// itemsize; gram_table_static_smem writes path 1's kernel's static shared
// memory to *out. Returns a cudaError_t.
extern "C" long long gram_table_smem_bytes(int m, int r, int itemsize) {
  if (itemsize == 4) return (long long)resident_smem<float>(m, r);
  if (itemsize == 2) return (long long)resident_smem<__nv_bfloat16>(m, r);
  return -1;
}

extern "C" int gram_table_static_smem(int itemsize, long long* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaErrorInvalidValue;
  if (itemsize == 4) {
    err = cudaFuncGetAttributes(&a, gram_table_resident<float>);
  }
  if (itemsize == 2) {
    err = cudaFuncGetAttributes(&a, gram_table_resident<__nv_bfloat16>);
  }
  if (err == cudaSuccess) *out = static_cast<long long>(a.sharedSizeBytes);
  return static_cast<int>(err);
}
