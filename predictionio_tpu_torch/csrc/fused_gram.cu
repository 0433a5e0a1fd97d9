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
// - 256 threads as a 16 x 16 grid; thread (ti, tj) keeps the TT x TT
//   elements A[ti + 16a][tj + 16c] in registers for the whole history,
//   TT = ceil(r / 16) (16 floats a thread at r = 64). Per slot it reads
//   TT + TT staged values for TT*TT FMAs; the strided ownership makes the
//   column reads 16 consecutive words (no bank conflict) and the row
//   reads two broadcast words per warp.
// - The longest rows run on one SM each: the item side's top bucket at
//   ML-20M is L = 131,072 (15 rows), ~1 GFLOP each, so that launch keeps
//   15 of 132 SMs busy for 21.5 ms (chip_smoke.py on an H100 80GB HBM3 at
//   700 W), over a quarter of the kernel's time in an iteration.
//   Splitting L across blocks (partial Gramians and a second pass) is left
//   for later.
// - A at r = 128 over 138,493 rows is 2.27 G elements, past 2^31: every
//   output offset is 64-bit.
// Left for later: cp.async / TMA double-buffered row gathers, and the
// products on tensor cores -- bf16 x bf16 products are exact in f32, so
// the bf16 wire can take wgmma with f32 accumulation unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGrid = 16;           // threads per side of the thread grid
constexpr int kChunk = 32;          // history slots staged per pass
constexpr int kMaxTile = 8;         // TT at the largest rank
constexpr int kMaxRank = kGrid * kMaxTile;  // 128

static_assert(kGrid * kGrid == kThreads, "one thread per tile");

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int TT>
__global__ void __launch_bounds__(kThreads)
fused_gram_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                  const float* __restrict__ wa, const float* __restrict__ wb,
                  int L, int m, int r, float* __restrict__ A,
                  float* __restrict__ bout) {
  constexpr int Rp = kGrid * TT;     // rank padded to the thread grid
  __shared__ float s_f[kChunk][Rp];  // the chunk's rows, upcast to f32
  __shared__ float s_wa[kChunk];
  __shared__ float s_wb[kChunk];
  __shared__ int s_row[kChunk];

  const int tid = threadIdx.x;
  const int ti = tid / kGrid;
  const int tj = tid % kGrid;
  const size_t row = blockIdx.x;
  const int* row_idx = idx + row * (size_t)L;
  const float* row_wa = wa + row * (size_t)L;
  const float* row_wb = wb + row * (size_t)L;

  float acc[TT][TT];
  float bacc[TT];
#pragma unroll
  for (int a = 0; a < TT; ++a) {
    bacc[a] = 0.f;
#pragma unroll
    for (int c = 0; c < TT; ++c) acc[a][c] = 0.f;
  }

  for (int l0 = 0; l0 < L; l0 += kChunk) {
    const int n = min(kChunk, L - l0);
    __syncthreads();  // the previous chunk is consumed
    if (tid < kChunk) {
      const bool live = tid < n;
      const int g = live ? row_idx[l0 + tid] : -1;
      s_row[tid] = (g >= 0 && g < m) ? g : -1;
      s_wa[tid] = live ? row_wa[l0 + tid] : 0.f;
      s_wb[tid] = live ? row_wb[l0 + tid] : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < kChunk * Rp; e += kThreads) {
      const int l = e / Rp;
      const int d = e - l * Rp;
      const int g = s_row[l];
      s_f[l][d] = (g >= 0 && d < r) ? to_f32(table[(size_t)g * r + d]) : 0.f;
    }
    __syncthreads();
    for (int l = 0; l < kChunk; ++l) {
      const float w = s_wa[l];
      float fi[TT];
      float fj[TT];
#pragma unroll
      for (int a = 0; a < TT; ++a) fi[a] = s_f[l][ti + kGrid * a];
#pragma unroll
      for (int c = 0; c < TT; ++c) fj[c] = s_f[l][tj + kGrid * c];
      if (tj == 0) {
        const float v = s_wb[l];
#pragma unroll
        for (int a = 0; a < TT; ++a) bacc[a] = fmaf(v, fi[a], bacc[a]);
      }
#pragma unroll
      for (int a = 0; a < TT; ++a) {
        const float wf = w * fi[a];
#pragma unroll
        for (int c = 0; c < TT; ++c) acc[a][c] = fmaf(wf, fj[c], acc[a][c]);
      }
    }
  }

  float* Ar = A + row * (size_t)r * (size_t)r;
#pragma unroll
  for (int a = 0; a < TT; ++a) {
    const int i = ti + kGrid * a;
    if (i >= r) continue;
#pragma unroll
    for (int c = 0; c < TT; ++c) {
      const int j = tj + kGrid * c;
      if (j < r) Ar[(size_t)i * r + j] = acc[a][c];
    }
    if (tj == 0) bout[row * (size_t)r + i] = bacc[a];
  }
}

template <typename T, int TT>
cudaError_t launch_tile(const void* table, const void* idx, const void* wa,
                        const void* wb, int B, int L, int m, int r, void* A,
                        void* b, cudaStream_t stream) {
  fused_gram_kernel<T, TT><<<B, kThreads, 0, stream>>>(
      static_cast<const T*>(table), static_cast<const int*>(idx),
      static_cast<const float*>(wa), static_cast<const float*>(wb), L, m, r,
      static_cast<float*>(A), static_cast<float*>(b));
  return cudaGetLastError();
}

template <typename T>
int launch(int device, const void* table, const void* idx, const void* wa,
           const void* wb, int B, int L, int m, int r, void* A, void* b,
           void* stream) {
  if (B < 0 || L < 0 || m < 1 || r < 1 || r > kMaxRank) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((r + kGrid - 1) / kGrid) {
    case 1: err = launch_tile<T, 1>(table, idx, wa, wb, B, L, m, r, A, b, s); break;
    case 2: err = launch_tile<T, 2>(table, idx, wa, wb, B, L, m, r, A, b, s); break;
    case 3: err = launch_tile<T, 3>(table, idx, wa, wb, B, L, m, r, A, b, s); break;
    case 4: err = launch_tile<T, 4>(table, idx, wa, wb, B, L, m, r, A, b, s); break;
    case 5: err = launch_tile<T, 5>(table, idx, wa, wb, B, L, m, r, A, b, s); break;
    case 6: err = launch_tile<T, 6>(table, idx, wa, wb, B, L, m, r, A, b, s); break;
    case 7: err = launch_tile<T, 7>(table, idx, wa, wb, B, L, m, r, A, b, s); break;
    default: err = launch_tile<T, 8>(table, idx, wa, wb, B, L, m, r, A, b, s); break;
  }
  return static_cast<int>(err);
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
