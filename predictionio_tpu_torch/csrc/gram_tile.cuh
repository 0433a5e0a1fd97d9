// The weighted-Gramian tile shared by fused_gram.cu and gram_table.cu
// (Hopper, sm_90a). Each .cu file includes it and compiles on its own.
//
// For one history row of L slots it computes
//   f_l = table[idx[l]]                    (f32, or bf16 upcast to f32
//                                           right after the load)
//   A   = sum_l wa[l] * f_l f_l^T          [r, r] f32
//   b   = sum_l wb[l] * f_l                [r]    f32
// Padding slots carry w = 0 and a valid index; they are multiplied like
// every other slot, not skipped. An index outside [0, m) counts as a zero
// row.
//
// 256 threads form a 16 x 16 grid; thread (ti, tj) keeps the TT x TT
// elements A[ti + 16a][tj + 16c] in registers for the whole history,
// TT = ceil(r / 16) (16 floats a thread at r = 64). The history is staged
// kChunk slots at a time in shared memory. Per slot a thread reads TT +
// TT values for TT*TT FMAs; the strided ownership makes the column reads
// 16 consecutive words (no bank conflict) and the row reads two broadcast
// words per warp. A and b offsets are 64-bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gram_tile {
namespace {  // each including library keeps its own copy

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

// Shared memory of one row's staging: the chunk's slots and, unless the
// table is resident, its gathered rows upcast to f32.
template <int TT, bool kResident>
struct Stage {
  float f[kResident ? 1 : kChunk][kGrid * TT];
  float wa[kChunk];
  float wb[kChunk];
  int row[kChunk];
};

// One history row into A (row-major [r, r]) and b. ``table`` is [m, r] in
// global memory, or in shared memory when ``kResident`` (then ``st.f`` is
// not used and the rows are read where they lie).
template <typename T, int TT, bool kResident>
__device__ __forceinline__ void gram_row(
    const T* __restrict__ table, const int* __restrict__ idx,
    const float* __restrict__ wa, const float* __restrict__ wb, int L, int m,
    int r, Stage<TT, kResident>& st, float* __restrict__ A,
    float* __restrict__ bout) {
  constexpr int Rp = kGrid * TT;     // rank padded to the thread grid
  const int tid = threadIdx.x;
  const int ti = tid / kGrid;
  const int tj = tid % kGrid;

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
    __syncthreads();  // the previous chunk (or row) is consumed
    if (tid < kChunk) {
      const bool live = tid < n;
      const int g = live ? idx[l0 + tid] : -1;
      st.row[tid] = (g >= 0 && g < m) ? g : -1;
      st.wa[tid] = live ? wa[l0 + tid] : 0.f;
      st.wb[tid] = live ? wb[l0 + tid] : 0.f;
    }
    __syncthreads();
    if constexpr (!kResident) {
      for (int e = tid; e < kChunk * Rp; e += kThreads) {
        const int l = e / Rp;
        const int d = e - l * Rp;
        const int g = st.row[l];
        st.f[l][d] = (g >= 0 && d < r)
            ? to_f32(table[static_cast<size_t>(g) * r + d]) : 0.f;
      }
      __syncthreads();
    }
    for (int l = 0; l < kChunk; ++l) {
      const float w = st.wa[l];
      float fi[TT];
      float fj[TT];
      if constexpr (kResident) {
        const int g = st.row[l];
        const T* f = table + static_cast<size_t>(g < 0 ? 0 : g) * r;
#pragma unroll
        for (int a = 0; a < TT; ++a) {
          const int i = ti + kGrid * a;
          fi[a] = (g >= 0 && i < r) ? to_f32(f[i]) : 0.f;
        }
#pragma unroll
        for (int c = 0; c < TT; ++c) {
          const int j = tj + kGrid * c;
          fj[c] = (g >= 0 && j < r) ? to_f32(f[j]) : 0.f;
        }
      } else {
#pragma unroll
        for (int a = 0; a < TT; ++a) fi[a] = st.f[l][ti + kGrid * a];
#pragma unroll
        for (int c = 0; c < TT; ++c) fj[c] = st.f[l][tj + kGrid * c];
      }
      if (tj == 0) {
        const float v = st.wb[l];
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

#pragma unroll
  for (int a = 0; a < TT; ++a) {
    const int i = ti + kGrid * a;
    if (i >= r) continue;
#pragma unroll
    for (int c = 0; c < TT; ++c) {
      const int j = tj + kGrid * c;
      if (j < r) A[static_cast<size_t>(i) * r + j] = acc[a][c];
    }
    if (tj == 0) bout[i] = bacc[a];
  }
}

// One block per history row, the rows gathered from global memory (the
// table stays wherever the caches put it).
template <typename T, int TT>
__global__ void __launch_bounds__(kThreads)
gram_rows_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                 const float* __restrict__ wa, const float* __restrict__ wb,
                 int L, int m, int r, float* __restrict__ A,
                 float* __restrict__ bout) {
  __shared__ Stage<TT, false> st;
  const size_t row = blockIdx.x;
  gram_row<T, TT, false>(table, idx + row * (size_t)L, wa + row * (size_t)L,
                         wb + row * (size_t)L, L, m, r, st,
                         A + row * (size_t)r * (size_t)r,
                         bout + row * (size_t)r);
}

// Launches gram_rows_kernel for B rows, TT chosen from r (1 <= r <=
// kMaxRank, checked by the caller).
template <typename T>
cudaError_t launch_rows(const void* table, const void* idx, const void* wa,
                        const void* wb, int B, int L, int m, int r, void* A,
                        void* b, cudaStream_t stream) {
#define GRAM_ROWS_CASE(TT)                                                 \
  case TT:                                                                 \
    gram_rows_kernel<T, TT><<<B, kThreads, 0, stream>>>(                   \
        static_cast<const T*>(table), static_cast<const int*>(idx),        \
        static_cast<const float*>(wa), static_cast<const float*>(wb), L,   \
        m, r, static_cast<float*>(A), static_cast<float*>(b));             \
    break;
  switch ((r + kGrid - 1) / kGrid) {
    GRAM_ROWS_CASE(1)
    GRAM_ROWS_CASE(2)
    GRAM_ROWS_CASE(3)
    GRAM_ROWS_CASE(4)
    GRAM_ROWS_CASE(5)
    GRAM_ROWS_CASE(6)
    GRAM_ROWS_CASE(7)
    default:
    GRAM_ROWS_CASE(8)
  }
#undef GRAM_ROWS_CASE
  return cudaGetLastError();
}

}  // namespace
}  // namespace gram_tile
