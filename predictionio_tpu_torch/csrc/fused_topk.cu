// Fused gather -> score -> top-k for ALS serving, written for Hopper
// (sm_90a), bound to PyTorch through a plain C interface (ctypes).
//
// Replaces: predictionio_tpu/ops/fused_topk.py::_fused_topk_kernel (:97),
// the Pallas kernel that fused_topk (:223) launches at pallas_call (:321).
//
// What it computes, for each query b:
//   u      = user[idx[b]] (upcast to f32) * user_scale[idx[b]]
//   s[i]   = (u . item[i]) * item_scale[i]        f32 accumulation
//   s[i]   = -inf where base + i >= n_items
//   out[b] = the k best (s[i], base + i), ordered by score descending,
//            ties to the lower id; slots past the catalog hold (-inf, 0).
// Tables are f32, bf16 or int8 (int8 with per-row f32 scales).
//
// What bounds it: at ML-20M width (I = 26,744 items, rank r = 64) and a
// batch of B = 2,048 queries it does 2*B*I*r = 7.0 GFLOP and must read
// I*r*wire + B*r*wire bytes plus the row scales (3.4 MB on the f32 wire,
// 1.9 MB on int8) and write B*k*8 bytes. At 3.35 TB/s the bytes take
// about a microsecond; the multiply-adds take ~100 us even at the
// 67 TFLOP/s f32 CUDA-core peak. The work is arithmetic, and the
// selection (not a matrix product) is what a library cannot fuse.
//
// What the design does about it:
// - One block scores kQB queries against the whole catalog, so each item
//   tile staged in shared memory serves kQB dot products per row, and the
//   [B, I] score matrix never exists in device memory: only [B, k] scores
//   and ids are written.
// - Item rows stream through shared memory kChunk at a time, upcast to
//   f32 on the way in (the int8/bf16 wire is dequantized after the load,
//   accumulation is f32 FMAs on the CUDA cores).
// - Each query keeps its running top-k in shared memory, owned by one
//   warp. A chunk's candidate is kept only if it beats the current k-th
//   best; a chunk with no survivor for a query costs that warp one vote,
//   so after the first chunks the selection is nearly free. Survivors are
//   sorted by a warp bitonic sort and merged into the running list by one
//   bitonic merge. The comparator is (score descending, id ascending), a
//   total order, so ties go to the lower id whatever the order of work.
// Tensor cores (wgmma), TMA and a double-buffered tile are left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQB = kWarps;          // queries per block: warp w merges query w
constexpr int kChunk = 128;          // item rows per shared-memory tile
constexpr int kQPerThread = kQB * kChunk / kThreads;  // queries each thread scores
constexpr int kMaxK = 128;           // longest running top-k list
constexpr int kMaxRank = 256;        // sized to the shared-memory budget
constexpr int kEmptyId = 0x7fffffff; // id of an empty slot: loses every tie

static_assert(kThreads % kChunk == 0, "a thread scores one item row");
static_assert(kMaxK <= kChunk, "the merge takes the k best of one sorted chunk");

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f32<int8_t>(int8_t x) {
  return static_cast<float>(x);
}

// True when (as, ai) ranks ahead of (bs, bi): score descending, id ascending.
__device__ __forceinline__ bool ahead(float as, int ai, float bs, int bi) {
  return as > bs || (as == bs && ai < bi);
}

// Sort n pairs (n a power of two) best first. One warp, shared memory.
__device__ void warp_bitonic_sort(float* s, int* id, int n, int lane) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < (n >> 1); t += 32) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool best_first = (lo & size) == 0;
        const float sl = s[lo], sh = s[hi];
        const int il = id[lo], ih = id[hi];
        if (ahead(sh, ih, sl, il) == best_first) {
          s[lo] = sh; s[hi] = sl;
          id[lo] = ih; id[hi] = il;
        }
      }
      __syncwarp();
    }
  }
}

// top[0..kp) and cand[0..kp) are sorted best first. Keep the kp best of
// both in top, sorted: pairing top[i] with cand[kp-1-i] and keeping the
// better of each pair leaves a bitonic sequence that holds them, and the
// half-cleaners of a bitonic merge sort it. One warp.
__device__ void warp_merge_topk(float* ts, int* ti, const float* cs,
                                const int* ci, int kp, int lane) {
  for (int i = lane; i < kp; i += 32) {
    const float s = cs[kp - 1 - i];
    const int id = ci[kp - 1 - i];
    if (ahead(s, id, ts[i], ti[i])) {
      ts[i] = s;
      ti[i] = id;
    }
  }
  __syncwarp();
  for (int stride = kp >> 1; stride > 0; stride >>= 1) {
    for (int t = lane; t < (kp >> 1); t += 32) {
      const int lo = 2 * t - (t & (stride - 1));
      const int hi = lo + stride;
      const float sl = ts[lo], sh = ts[hi];
      const int il = ti[lo], ih = ti[hi];
      if (ahead(sh, ih, sl, il)) {
        ts[lo] = sh; ts[hi] = sl;
        ti[lo] = ih; ti[hi] = il;
      }
    }
    __syncwarp();
  }
}

// Row stride of the staged item tile: odd, so the 32 lanes of a warp,
// which read 32 consecutive rows at one column, hit 32 different banks.
__host__ __device__ __forceinline__ int tile_ld(int r) { return r | 1; }

__host__ __device__ __forceinline__ size_t smem_bytes(int r) {
  const size_t floats = (size_t)kChunk * tile_ld(r)  // item tile
                        + (size_t)kQB * r            // user rows
                        + (size_t)kQB * kChunk       // chunk scores
                        + kChunk                     // item scales
                        + (size_t)kQB * kMaxK        // top-k scores
                        + (size_t)kQB * kChunk;      // candidate scores
  const size_t ints = (size_t)kQB * kMaxK + (size_t)kQB * kChunk;
  return floats * sizeof(float) + ints * sizeof(int);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_topk_kernel(const T* __restrict__ user, const int* __restrict__ idx,
                  const T* __restrict__ item,
                  const float* __restrict__ uscale,
                  const float* __restrict__ iscale, int B, int m,
                  int n_rows, int r, int k, int kp, int base, int n_items,
                  float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ float smem[];
  const int ld = tile_ld(r);
  float* s_item = smem;                         // [kChunk][ld]
  float* s_user = s_item + kChunk * ld;         // [kQB][r]
  float* s_score = s_user + kQB * r;            // [kQB][kChunk]
  float* s_iscale = s_score + kQB * kChunk;     // [kChunk]
  float* s_top_s = s_iscale + kChunk;           // [kQB][kMaxK]
  float* s_cand_s = s_top_s + kQB * kMaxK;      // [kQB][kChunk]
  int* s_top_i = reinterpret_cast<int*>(s_cand_s + kQB * kChunk);  // [kQB][kMaxK]
  int* s_cand_i = s_top_i + kQB * kMaxK;        // [kQB][kChunk]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kQB;

  // Gather this block's user rows by index and dequantize them. A row
  // index outside [0, m) reads nothing and scores as a zero row.
  for (int e = tid; e < kQB * r; e += kThreads) {
    const int q = e / r;
    const int d = e - q * r;
    const int b = q0 + q;
    float v = 0.f;
    if (b < B) {
      const int row = idx[b];
      if (row >= 0 && row < m) {
        v = to_f32(user[(size_t)row * r + d]);
        if (uscale != nullptr) v *= uscale[row];
      }
    }
    s_user[e] = v;
  }
  for (int e = tid; e < kQB * kMaxK; e += kThreads) {
    s_top_s[e] = -INFINITY;
    s_top_i[e] = kEmptyId;
  }

  const int j = tid % kChunk;                       // item row this thread scores
  const int qg = (tid / kChunk) * kQPerThread;      // its first query
  float* top_s = s_top_s + warp * kMaxK;
  int* top_i = s_top_i + warp * kMaxK;
  float* cand_s = s_cand_s + warp * kChunk;
  int* cand_i = s_cand_i + warp * kChunk;
  const bool live_query = q0 + warp < B;            // uniform across the warp

  for (int c0 = 0; c0 < n_rows; c0 += kChunk) {
    const int rows = min(kChunk, n_rows - c0);
    __syncthreads();  // the previous tile is consumed; first pass: setup is visible
    const T* tile = item + (size_t)c0 * r;
    for (int e = tid; e < kChunk * r; e += kThreads) {
      const int jj = e / r;
      const int d = e - jj * r;
      s_item[jj * ld + d] = jj < rows ? to_f32(tile[e]) : 0.f;
    }
    if (tid < kChunk) {
      s_iscale[tid] = (iscale != nullptr && tid < rows) ? iscale[c0 + tid] : 1.f;
    }
    __syncthreads();

    float acc[kQPerThread];
#pragma unroll
    for (int qq = 0; qq < kQPerThread; ++qq) acc[qq] = 0.f;
    const float* vrow = s_item + j * ld;
    for (int d = 0; d < r; ++d) {
      const float v = vrow[d];
#pragma unroll
      for (int qq = 0; qq < kQPerThread; ++qq) {
        acc[qq] = fmaf(s_user[(qg + qq) * r + d], v, acc[qq]);
      }
    }
#pragma unroll
    for (int qq = 0; qq < kQPerThread; ++qq) {
      s_score[(qg + qq) * kChunk + j] = acc[qq] * s_iscale[j];
    }
    __syncthreads();

    if (live_query) {
      // only a candidate that beats the current k-th best can enter
      const float th_s = top_s[k - 1];
      const int th_i = top_i[k - 1];
      bool any = false;
      for (int jj = lane; jj < kChunk; jj += 32) {
        float s = -INFINITY;
        int id = kEmptyId;
        if (jj < rows) {
          const int gid = base + c0 + jj;
          const float sc = gid < n_items ? s_score[warp * kChunk + jj] : -INFINITY;
          if (ahead(sc, gid, th_s, th_i)) {
            s = sc;
            id = gid;
            any = true;
          }
        }
        cand_s[jj] = s;
        cand_i[jj] = id;
      }
      if (__any_sync(0xffffffffu, any)) {
        __syncwarp();
        warp_bitonic_sort(cand_s, cand_i, kChunk, lane);
        warp_merge_topk(top_s, top_i, cand_s, cand_i, kp, lane);
      }
    }
  }

  __syncwarp();
  if (live_query) {
    const size_t o = (size_t)(q0 + warp) * k;
    for (int t = lane; t < k; t += 32) {
      const int id = top_i[t];
      const bool empty = id == kEmptyId;
      out_s[o + t] = empty ? -INFINITY : top_s[t];
      out_i[o + t] = empty ? 0 : id;
    }
  }
}

template <typename T>
int launch(int device, const void* user, const void* idx, const void* item,
           const void* uscale, const void* iscale, int B, int m, int n_rows,
           int r, int k, int base, int n_items, void* out_s, void* out_i,
           void* stream) {
  if (B < 0 || m < 1 || n_rows < 0 || r < 1 || r > kMaxRank || k < 1 ||
      k > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int kp = 1;
  while (kp < k) kp <<= 1;
  const size_t smem = smem_bytes(r);
  err = cudaFuncSetAttribute(fused_topk_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + kQB - 1) / kQB);
  fused_topk_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(user), static_cast<const int*>(idx),
      static_cast<const T*>(item), static_cast<const float*>(uscale),
      static_cast<const float*>(iscale), B, m, n_rows, r, k, kp, base, n_items,
      static_cast<float*>(out_s), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, one per wire type. Pointers and the stream are passed
// as addresses; uscale/iscale may be null. Returns a cudaError_t.
#define FUSED_TOPK_ENTRY(NAME, T)                                            \
  extern "C" int NAME(int device, const void* user, const void* idx,         \
                      const void* item, const void* uscale,                  \
                      const void* iscale, int B, int m, int n_rows, int r,   \
                      int k, int base, int n_items, void* out_s,             \
                      void* out_i, void* stream) {                           \
    return launch<T>(device, user, idx, item, uscale, iscale, B, m, n_rows,  \
                     r, k, base, n_items, out_s, out_i, stream);             \
  }

FUSED_TOPK_ENTRY(fused_topk_f32, float)
FUSED_TOPK_ENTRY(fused_topk_bf16, __nv_bfloat16)
FUSED_TOPK_ENTRY(fused_topk_i8, int8_t)
