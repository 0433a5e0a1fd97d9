// The weighted-Gramian tile shared by fused_gram.cu and gram_table.cu
// (Hopper, sm_90a). Each .cu file includes it and compiles on its own.
//
// For a range of L history slots of one row it computes
//   f_l = table[idx[l]]                    (f32, or bf16 upcast to f32
//                                           right after the shared-memory
//                                           read)
//   A   = sum_l wa[l] * f_l f_l^T          [r, r] f32
//   b   = sum_l wb[l] * f_l                [r]    f32
// Padding slots carry w = 0 and a valid index; they are multiplied like
// every other slot, not skipped. An index outside [0, m) counts as a zero
// row. Every product and sum is f32 (wa * f is never rounded below f32,
// so the bf16 wire stays off the tensor cores: wa is alpha * rating for
// implicit feedback, and wa * f is then no bf16 value).
//
// The tile. A is symmetric, so only its lower triangle is computed: with
// n = ceil(r / 4) the n (n + 1) / 2 blocks of 4 x 4 on or under the
// diagonal get one thread each (136 threads at r = 64, 528 at r = 128),
// which keeps its 16 sums in registers over the whole range. Per slot a
// thread reads two 16-byte operands (f[4 ti..] and f[4 tj..], most lanes
// of a warp the same addresses) for 16 FMAs and 4 multiplies, so the loop
// is bound by the FMA rate, not by shared memory. b takes n more threads (4
// sums each), so no warp of the triangle diverges for it. On the way out
// each block is written with its mirror image into a shared-memory copy
// of A, which then leaves in whole coalesced rows: the returned A is all
// of [r, r] and exactly symmetric.
//
// The pipeline. Slots are staged kChunk at a time: while chunk c is
// multiplied, chunk c + 1's rows are in flight to the other buffer as
// 16-byte cp.async copies (zero-filled for an index outside the table),
// and chunk c + 2's indices and weights are on their way through
// registers into a ring of three. A row whose byte length is not a
// multiple of 16 (rank 10 in f32 is 40 bytes), an unaligned table, or a
// table that lies in shared memory takes the element-wise staging branch
// of the same loop. A and b offsets are 64-bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gram_tile {
namespace {  // each including library keeps its own copy

constexpr int kTile = 4;            // a thread's block of A is kTile x kTile
constexpr int kMaxSide = 32;        // most blocks per side of A
constexpr int kMaxRank = kTile * kMaxSide;  // 128
constexpr int kMaxThreads = 576;    // 528 blocks of A + 32 of b, in whole warps
constexpr int kChunk = 32;          // history slots staged per pass
constexpr int kMetaRing = 3;        // chunks of indices and weights in flight

static_assert(kMaxSide * (kMaxSide + 1) / 2 + kMaxSide <= kMaxThreads,
              "a thread a block");

// Rank padded so that a staged row is whole 16-byte pieces in both types.
__host__ __device__ __forceinline__ int padded_rank(int r) {
  return (r + 7) & ~7;
}

// Threads of a block: one per lower-triangle 4 x 4 block of A and one per
// 4 entries of b, in whole warps.
__host__ __device__ __forceinline__ int block_threads(int r) {
  const int n = (r + kTile - 1) / kTile;
  return (n * (n + 1) / 2 + n + 31) & ~31;
}

// Shared memory of one block's tile: two buffers of kChunk gathered rows
// in the table's type and the ring of indices and weights; after the last
// chunk the same bytes hold A at a row stride of r + 1 words, and b.
template <typename T>
__host__ __device__ __forceinline__ size_t stage_bytes(int r) {
  const size_t staging =
      2 * static_cast<size_t>(kChunk) * padded_rank(r) * sizeof(T) +
      static_cast<size_t>(kMetaRing) * kChunk * 12;
  const size_t out = (static_cast<size_t>(r) * (r + 1) + r) * 4;
  return staging > out ? staging : out;
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(x.x << 16);
  v[1] = __uint_as_float(x.x & 0xffff0000u);
  v[2] = __uint_as_float(x.y << 16);
  v[3] = __uint_as_float(x.y & 0xffff0000u);
}

__device__ __forceinline__ float zero_of(const float*) { return 0.f; }
__device__ __forceinline__ __nv_bfloat16 zero_of(const __nv_bfloat16*) {
  return __float2bfloat16(0.f);
}

// 16 bytes global -> shared, asynchronously; zeros when src_bytes is 0.
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src,
                                           int src_bytes) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// L slots of one history row into A (row-major [r, r], mirrored) and b.
// ``table`` is [m, r] in global memory, or anywhere a plain load reaches
// (shared memory) when ``vec16`` is false. ``stage`` is stage_bytes<T>(r)
// of shared memory, 16-byte aligned. Every thread of the block calls it.
template <typename T>
__device__ __forceinline__ void gram_row(
    const T* __restrict__ table, const int* __restrict__ idx,
    const float* __restrict__ wa, const float* __restrict__ wb, int L, int m,
    int r, bool vec16, unsigned char* stage, float* __restrict__ A,
    float* __restrict__ bout) {
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int Rp = padded_rank(r);
  T* s_f = reinterpret_cast<T*>(stage);                 // [2][kChunk][Rp]
  float* s_wa = reinterpret_cast<float*>(s_f + 2 * kChunk * Rp);
  float* s_wb = s_wa + kMetaRing * kChunk;              // [ring][kChunk]
  int* s_row = reinterpret_cast<int*>(s_wb + kMetaRing * kChunk);

  // this thread's block (ti, tj), tj <= ti, of the lower triangle
  const int n = (r + kTile - 1) / kTile;
  const int n_tiles = n * (n + 1) / 2;
  const bool has_tile = tid < n_tiles;
  const bool has_b = tid >= n_tiles && tid < n_tiles + n;  // b[4 bi..]
  const int bi = tid - n_tiles;
  int ti = 0;
  if (has_tile) {
    ti = static_cast<int>((sqrtf(8.f * tid + 1.f) - 1.f) * 0.5f);
    while (ti * (ti + 1) / 2 > tid) --ti;
    while ((ti + 1) * (ti + 2) / 2 <= tid) ++ti;
  }
  const int tj = tid - ti * (ti + 1) / 2;

  float acc[kTile][kTile];
  float bacc[kTile];
#pragma unroll
  for (int a = 0; a < kTile; ++a) {
    bacc[a] = 0.f;
#pragma unroll
    for (int c = 0; c < kTile; ++c) acc[a][c] = 0.f;
  }

  const int nch = (L + kChunk - 1) / kChunk;
  int m_row = -1;        // a chunk's index and weights on their way to the
  float m_wa = 0.f;      // ring (threads 0..kChunk-1)
  float m_wb = 0.f;
  auto fetch_meta = [&](int c) {
    if (tid < kChunk) {
      const int l = c * kChunk + tid;
      const int g = l < L ? idx[l] : -1;
      m_row = (g >= 0 && g < m) ? g : -1;
      m_wa = l < L ? wa[l] : 0.f;
      m_wb = l < L ? wb[l] : 0.f;
    }
  };
  auto store_meta = [&](int c) {
    if (tid < kChunk) {
      const int o = (c % kMetaRing) * kChunk + tid;
      s_row[o] = m_row;
      s_wa[o] = m_wa;
      s_wb[o] = m_wb;
    }
  };
  // Chunk c's rows into buffer c & 1, one commit group.
  auto gather = [&](int c) {
    T* dst = s_f + (c & 1) * kChunk * Rp;
    const int* rows = s_row + (c % kMetaRing) * kChunk;
    if (vec16) {
      const int per_row = r * static_cast<int>(sizeof(T)) / 16;
      for (int e = tid; e < kChunk * per_row; e += nthreads) {
        const int l = e / per_row;
        const int p = e - l * per_row;
        const int g = rows[l];
        const char* src = reinterpret_cast<const char*>(
            table + static_cast<size_t>(g < 0 ? 0 : g) * r) + p * 16;
        cp_async16(reinterpret_cast<char*>(dst + l * Rp) + p * 16, src,
                   g < 0 ? 0 : 16);
      }
    } else {
      for (int e = tid; e < kChunk * r; e += nthreads) {
        const int l = e / r;
        const int d = e - l * r;
        const int g = rows[l];
        dst[l * Rp + d] = g < 0 ? zero_of(table)
                                : table[static_cast<size_t>(g) * r + d];
      }
    }
    cp_async_commit();
  };

  // (columns r..Rp of a staged row are never written: they only reach
  // sums of rows and columns past r, which are not stored)
  if (nch > 0) { fetch_meta(0); store_meta(0); }
  if (nch > 1) { fetch_meta(1); store_meta(1); }
  __syncthreads();
  if (nch > 0) gather(0);

  for (int c = 0; c < nch; ++c) {
    if (c + 2 < nch) fetch_meta(c + 2);
    if (c + 1 < nch) {
      gather(c + 1);  // lands while chunk c is multiplied
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c's rows are in
    if (has_tile) {
      const T* f = s_f + (c & 1) * kChunk * Rp;
      const float* cwa = s_wa + (c % kMetaRing) * kChunk;
#pragma unroll 4
      for (int l = 0; l < kChunk; ++l) {
        float fi[kTile];
        float fj[kTile];
        load4(f + l * Rp + kTile * ti, fi);
        load4(f + l * Rp + kTile * tj, fj);
        const float w = cwa[l];
#pragma unroll
        for (int a = 0; a < kTile; ++a) {
          const float wf = w * fi[a];
#pragma unroll
          for (int cc = 0; cc < kTile; ++cc) {
            acc[a][cc] = fmaf(wf, fj[cc], acc[a][cc]);
          }
        }
      }
    } else if (has_b) {
      const T* f = s_f + (c & 1) * kChunk * Rp;
      const float* cwb = s_wb + (c % kMetaRing) * kChunk;
#pragma unroll 4
      for (int l = 0; l < kChunk; ++l) {
        float fi[kTile];
        load4(f + l * Rp + kTile * bi, fi);
        const float v = cwb[l];
#pragma unroll
        for (int a = 0; a < kTile; ++a) bacc[a] = fmaf(v, fi[a], bacc[a]);
      }
    }
    if (c + 2 < nch) store_meta(c + 2);
    __syncthreads();  // chunk c's buffer and ring slot are free
  }

  // A and b into shared memory (every chunk is consumed), each block of
  // A with its mirror image, then out in whole rows
  float* s_out = reinterpret_cast<float*>(stage);  // [r][r + 1], then b [r]
  const int ld = r + 1;
  if (has_tile) {
#pragma unroll
    for (int a = 0; a < kTile; ++a) {
      const int i = kTile * ti + a;
      if (i >= r) continue;
#pragma unroll
      for (int cc = 0; cc < kTile; ++cc) {
        const int j = kTile * tj + cc;
        if (j >= r || (ti == tj && cc > a)) continue;  // a diagonal block's
        s_out[i * ld + j] = acc[a][cc];   // upper half is the mirror of its
        s_out[j * ld + i] = acc[a][cc];   // lower half
      }
    }
  } else if (has_b) {
#pragma unroll
    for (int a = 0; a < kTile; ++a) {
      if (kTile * bi + a < r) s_out[r * ld + kTile * bi + a] = bacc[a];
    }
  }
  __syncthreads();
  const int lane = tid & 31;
  for (int i = tid >> 5; i < r; i += nthreads >> 5) {
    for (int j = lane; j < r; j += 32) {
      A[static_cast<size_t>(i) * r + j] = s_out[i * ld + j];
    }
  }
  for (int i = tid; i < r; i += nthreads) bout[i] = s_out[r * ld + i];
  __syncthreads();  // the next row of this block may stage again
}

// One block per (history row, range of its slots), the rows gathered from
// global memory (the table stays wherever the caches put it). With one
// split a block writes A and b; with more it writes its partial sums to
// scratch [B, splits, r*r + r] and sum_partials adds them.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gram_rows_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                 const float* __restrict__ wa, const float* __restrict__ wb,
                 int L, int m, int r, int splits, int vec16,
                 float* __restrict__ scratch, float* __restrict__ A,
                 float* __restrict__ bout) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t row = blockIdx.x;
  const int s = blockIdx.y;
  const int nch = (L + kChunk - 1) / kChunk;
  const int l0 = static_cast<int>((long long)s * nch / splits) * kChunk;
  const int l1 = min(L, static_cast<int>((long long)(s + 1) * nch / splits) *
                            kChunk);
  float* Ao = A + row * (size_t)r * (size_t)r;
  float* bo = bout + row * (size_t)r;
  if (splits > 1) {
    Ao = scratch + (row * splits + s) * ((size_t)r * r + r);
    bo = Ao + (size_t)r * r;
  }
  const size_t at = row * (size_t)L + l0;
  gram_row<T>(table, idx + at, wa + at, wb + at, l1 - l0, m, r, vec16 != 0,
              smem, Ao, bo);
}

// The second pass of a split launch: every element of A and b is the sum
// of its `splits` partials in the order of the splits, so the result is
// the same run after run (no atomics), and A stays exactly symmetric.
__global__ void __launch_bounds__(256)
sum_partials(const float* __restrict__ scratch, size_t B, int r, int splits,
             float* __restrict__ A, float* __restrict__ bout) {
  const size_t rr = (size_t)r * r;
  const size_t per = rr + r;
  const size_t total = B * per;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const size_t row = e / per;
    const size_t o = e - row * per;
    const float* p = scratch + row * splits * per + o;
    float sum = p[0];
    for (int s = 1; s < splits; ++s) sum += p[s * per];
    if (o < rr) {
      A[row * (size_t)r * (size_t)r + o] = sum;
    } else {
      bout[row * (size_t)r + (o - rr)] = sum;
    }
  }
}

// Launches gram_rows_kernel for B rows cut into `splits` ranges of slots
// each (1 <= r <= kMaxRank, checked by the caller), then sum_partials
// when splits > 1 (scratch [B, splits, r*r + r] f32 from the caller).
template <typename T>
cudaError_t launch_rows(const void* table, const void* idx, const void* wa,
                        const void* wb, int B, int L, int m, int r,
                        int splits, int vec16, void* scratch, void* A,
                        void* b, cudaStream_t stream) {
  const int nch = (L + kChunk - 1) / kChunk;
  if (splits < 1 || splits > 65535 || (splits > 1 && splits > nch) ||
      (splits > 1 && scratch == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (vec16 && ((r * sizeof(T)) % 16 != 0 ||
                (reinterpret_cast<uintptr_t>(table) & 15) != 0)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(B, splits);
  const size_t smem = stage_bytes<T>(r);
  if (smem > 48 * 1024) {  // rank 128 stages 66 KB of A: past the default
    const cudaError_t err = cudaFuncSetAttribute(
        gram_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  gram_rows_kernel<T><<<grid, block_threads(r), smem, stream>>>(
      static_cast<const T*>(table), static_cast<const int*>(idx),
      static_cast<const float*>(wa), static_cast<const float*>(wb), L, m, r,
      splits, vec16, static_cast<float*>(scratch), static_cast<float*>(A),
      static_cast<float*>(b));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t total = static_cast<size_t>(B) * ((size_t)r * r + r);
  const size_t want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  sum_partials<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(scratch), static_cast<size_t>(B), r, splits,
      static_cast<float*>(A), static_cast<float*>(b));
  return cudaGetLastError();
}

}  // namespace
}  // namespace gram_tile
