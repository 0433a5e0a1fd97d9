// Fused gather -> score -> top-k for ALS serving, written for Hopper
// (sm_90a), bound to PyTorch through a plain C interface (ctypes).
//
// Replaces: predictionio_tpu/ops/fused_topk.py::_fused_topk_kernel (:97),
// the Pallas kernel that fused_topk (:223) launches at pallas_call (:321).
//
// What it computes, for each query b:
//   u      = user[idx[b]], its row scale su = user_scale[idx[b]]
//   s[i]   = (u . item[i]) * su * item_scale[i]
//            f32 wire: f32 FMAs; bf16 wire: exact bf16 products summed in
//            f32; int8 wire: exact s32 dot product, scaled afterwards
//   s[i]   = -inf where base + i >= n_items
//   out[b] = the k best (s[i], base + i), ordered by score descending,
//            ties to the lower id; slots past the catalog hold (-inf, 0).
//
// What bounds it on this card. At ML-20M width (I = 26,744 items, rank
// r = 64) and B = 2,048 queries it does 2*B*I*r = 7.0 G operations and
// must move 1.9 MB (int8) to 7 MB (f32): about a microsecond of bytes, 4
// us of int8 tensor-core work, 100 us of f32 FMAs. What a library cannot
// fuse is the selection, and at serving's batch sizes (B = 1..8) the
// problem is too small for one block: one SM of 132 would walk the whole
// catalogue.
//
// What the design does about it:
// - The grid is query blocks x catalogue splits. The launch picks the
//   split count so that about two blocks an SM run whatever B is; each
//   block keeps the running top-k of its queries over its range of the
//   catalogue and, when there is more than one split, writes it to a
//   scratch [B, splits, kp] that the wrapper allocated. A second small
//   kernel merges a query's lists. The comparator (score descending, id
//   ascending) is a total order, so the result does not depend on which
//   block saw which row, and nothing is atomic in device memory.
// - Item tiles are staged in the wire's own type (an int8 tile stays int8)
//   by 16-byte cp.async copies, two stages: chunk c+1 lands while chunk c
//   is scored. A row whose byte length is not a multiple of 16 (or a
//   table that is not 16-byte aligned) takes an element-wise staging
//   branch of the same kernel, chosen in the launch.
// - int8 and bf16 scores come from tensor cores: mma.sync m16n8k32 (s8,
//   s32 sums) and m16n8k16 (bf16, f32 sums), 16 item rows x 8 queries a
//   tile, K padded with zeros in shared memory. Both operands are K-major
//   as the tables lie, so a fragment is plain 32-bit shared-memory reads;
//   the row stride (K + 16 bytes) spreads them over all banks. The f32
//   wire stays on f32 FMAs (TF32 would not hold 1e-5), register-tiled:
//   a thread scores up to 4 items x 8 queries from 16-byte reads.
// - A block takes up to 64 queries, so at B = 2,048 the table is read from
//   L2 32 times, not 256.
// - The selection never leaves registers and shared memory. A score is
//   compared with its query's current k-th best right where the tensor
//   core (or the FMA tile) left it; one warp vote a tile says whether any
//   lane has a candidate, so after a split's first chunks most tiles cost
//   a compare and a vote. Candidates go to a per-query list (a shared-
//   memory counter). One warp then takes a query: it holds the running
//   list in registers (entry j * 32 + lane in lane's j-th register; 32
//   entries for k <= 32, else 128), inserts a handful of candidates one
//   by one (a ballot finds the place, a shuffle moves the rest down), and
//   sorts and merges more with bitonic networks of shuffles.
// Still left: wgmma instead of mma.sync (the products are a small share
// beside the selection) and TMA instead of cp.async.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQB = 64;           // most queries a block takes
constexpr int kMaxChunk = 128;       // most item rows per staged tile
constexpr int kMinChunk = 32;
constexpr int kMaxK = 128;           // longest running top-k list
constexpr int kMaxRank = 256;        // sized to the shared-memory budget
constexpr int kEmptyId = 0x7fffffff; // id of an empty slot: loses every tie
constexpr int kInsertMax = 8;        // candidates inserted singly; more are
                                     // sorted and merged
constexpr unsigned kFull = 0xffffffffu;

static_assert(kMaxQB == kWarps * 8, "a warp owns at most 8 queries");
static_assert(kMaxChunk <= 128 && kMaxK <= 128, "lists are 4 x 32 at most");
static_assert(kMinChunk == 32, "the f32 tile gives a lane 32-row strides");

// True when (as, ai) ranks ahead of (bs, bi): score descending, id ascending.
__device__ __forceinline__ bool ahead(float as, int ai, float bs, int bi) {
  return as > bs || (as == bs && ai < bi);
}

// A list of 32 * NJ (score, id) pairs held by one warp: entry j * 32 + lane
// is in lane's j-th register. Empty entries are (-inf, kEmptyId).
template <int NJ>
struct RegList {
  float s[NJ];
  int id[NJ];
};

// The first n entries from memory, the rest empty.
template <int NJ>
__device__ __forceinline__ void list_load(RegList<NJ>& l, const float* s,
                                          const int* id, int n, int lane) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int e = j * 32 + lane;
    l.s[j] = e < n ? s[e] : -INFINITY;
    l.id[j] = e < n ? id[e] : kEmptyId;
  }
}

template <int NJ>
__device__ __forceinline__ void list_store(const RegList<NJ>& l, float* s,
                                           int* id, int n, int lane) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int e = j * 32 + lane;
    if (e < n) {
      s[e] = l.s[j];
      id[e] = l.id[j];
    }
  }
}

// One compare-exchange step of a bitonic network at distance `stride`:
// entry e and entry e ^ stride end up best first when `best_first(e)`.
// Within a lane for stride >= 32, by a shuffle below that.
template <int NJ, typename Dir>
__device__ __forceinline__ void list_step(RegList<NJ>& l, int stride, int lane,
                                          Dir best_first) {
  if (stride >= 32) {
    const int dj = stride >> 5;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if ((j & dj) == 0 && (j | dj) < NJ) {
        const int jh = j | dj;
        if (ahead(l.s[jh], l.id[jh], l.s[j], l.id[j]) == best_first(j * 32)) {
          const float ts = l.s[j];
          const int ti = l.id[j];
          l.s[j] = l.s[jh];
          l.id[j] = l.id[jh];
          l.s[jh] = ts;
          l.id[jh] = ti;
        }
      }
    }
  } else {
    const bool lower = (lane & stride) == 0;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float os = __shfl_xor_sync(kFull, l.s[j], stride);
      const int oi = __shfl_xor_sync(kFull, l.id[j], stride);
      // the lower position keeps the better pair when best first
      const bool keep = ahead(l.s[j], l.id[j], os, oi) ==
                        (lower == best_first(j * 32 + lane));
      if (!keep) {
        l.s[j] = os;
        l.id[j] = oi;
      }
    }
  }
}

// Sort all 32 * NJ entries best first (a bitonic sort of shuffles).
template <int NJ>
__device__ __forceinline__ void list_sort(RegList<NJ>& l, int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * NJ; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      list_step(l, stride, lane, [size](int e) { return (e & size) == 0; });
    }
  }
}

// top and cand are sorted best first. Keep the 32 * NJ best of both in
// top, sorted: pairing top[e] with cand[N-1-e] and keeping the better of
// each pair leaves a bitonic sequence that holds them, and the
// half-cleaners of a bitonic merge sort it.
template <int NJ>
__device__ __forceinline__ void list_merge(RegList<NJ>& top,
                                           const RegList<NJ>& cand, int lane) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float os = __shfl_sync(kFull, cand.s[NJ - 1 - j], 31 - lane);
    const int oi = __shfl_sync(kFull, cand.id[NJ - 1 - j], 31 - lane);
    if (ahead(os, oi, top.s[j], top.id[j])) {
      top.s[j] = os;
      top.id[j] = oi;
    }
  }
#pragma unroll
  for (int stride = 16 * NJ; stride > 0; stride >>= 1) {
    list_step(top, stride, lane, [](int) { return true; });
  }
}

// Insert one pair into a sorted list: its place is the number of entries
// ahead of it (a ballot), the entries behind it move down one (a shuffle),
// the last one falls out.
template <int NJ>
__device__ __forceinline__ void list_insert(RegList<NJ>& l, float xs, int xi,
                                            int lane) {
  int p = 0;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    p += __popc(__ballot_sync(kFull, ahead(l.s[j], l.id[j], xs, xi)));
  }
  float carry_s = 0.f;  // the last entry of the register above
  int carry_i = 0;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int e = j * 32 + lane;
    float prev_s = __shfl_up_sync(kFull, l.s[j], 1);
    int prev_i = __shfl_up_sync(kFull, l.id[j], 1);
    if (lane == 0) {
      prev_s = carry_s;
      prev_i = carry_i;
    }
    if (j + 1 < NJ) {
      carry_s = __shfl_sync(kFull, l.s[j], 31);
      carry_i = __shfl_sync(kFull, l.id[j], 31);
    }
    if (e == p) {
      l.s[j] = xs;
      l.id[j] = xi;
    } else if (e > p) {
      l.s[j] = prev_s;
      l.id[j] = prev_i;
    }
  }
}

// Row stride of a staged tile in 32-bit words: the row padded to whole
// 32-byte K steps plus 16 bytes. The stride is 4 mod 8 words, so eight
// rows read at one K offset (an mma fragment, or eight lanes' 16-byte
// reads) fall in eight different groups of four banks.
__host__ __device__ __forceinline__ int stride_words(int row_bytes) {
  return ((row_bytes + 31) / 32) * 8 + 4;
}

// Entries of a query's running list: 32 for k <= 32, else 128.
__host__ __device__ __forceinline__ int list_len(int k) {
  return k <= 32 ? 32 : 128;
}

// Dynamic shared memory in bytes; ops/fused_topk.py::topk_smem_bytes is
// the same sum.
__host__ __device__ __forceinline__ size_t smem_bytes(int row_bytes, int qb,
                                                      int chunk, int k) {
  const size_t sw = stride_words(row_bytes);
  const size_t words = 2 * (size_t)chunk * sw     // two item tiles
                       + (size_t)qb * sw          // user rows
                       + 4 * (size_t)qb           // scales, thresholds, counts
                       + 2 * (size_t)qb * list_len(k)  // running top-k
                       + 2 * (size_t)qb * chunk;  // candidates
  return words * 4;
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// D += A B on tensor cores, A 16 item rows x K, B 8 queries x K, both
// K-major. The fragments are 32-bit words: lane (g = lane / 4, t = lane %
// 4) holds A words (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of the
// 32-byte K step, B words (g, t), (g, t + 4), and D entries (item g, query
// 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tile(int (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tile(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// What a block's threads share, carved out of dynamic shared memory.
struct Shared {
  uint32_t* tile;   // [2][chunk][sw] item rows in the wire's type
  uint32_t* user;   // [qb][sw] gathered user rows in the wire's type
  float* uscale;    // [qb]
  float* th_s;      // [qb] score of each query's current k-th best (+inf
                    //      for a dead query: nothing passes)
  int* th_i;        // [qb] its id
  int* cnt;         // [qb] candidates of the chunk being scored
  float* top_s;     // [qb][len] running lists, sorted best first
  int* top_i;       // [qb][len]
  float* cand_s;    // [qb][chunk]
  int* cand_i;      // [qb][chunk]
  int len;          // list_len(k)
  int chunk;
};

// One scored (query, item) that reached its query's k-th best score: a
// candidate if it ranks ahead of the k-th best pair.
__device__ __forceinline__ void consider(const Shared& sh, int q, float sc,
                                         int gid) {
  const float th = sh.th_s[q];
  if (sc > th || (sc == th && gid < sh.th_i[q])) {
    const int pos = atomicAdd(&sh.cnt[q], 1);
    sh.cand_s[q * sh.chunk + pos] = sc;
    sh.cand_i[q * sh.chunk + pos] = gid;
  }
}

// After a chunk is scored: warp w takes the candidates of queries w, w +
// 8, ... into their running lists and renews their thresholds.
template <int NJ>
__device__ __forceinline__ void select_chunk(const Shared& sh, int warp,
                                             int lane, int nq, int k) {
  constexpr int N = 32 * NJ;
  int my_cnt = 0;  // lane j: the count of this warp's j-th query
  if (lane < kMaxQB / kWarps && warp + kWarps * lane < nq) {
    my_cnt = sh.cnt[warp + kWarps * lane];
  }
  unsigned todo = __ballot_sync(kFull, my_cnt > 0);
  while (todo != 0) {
    const int j = __ffs(todo) - 1;
    todo &= todo - 1;
    const int cnt = __shfl_sync(kFull, my_cnt, j);
    const int q = warp + kWarps * j;
    float* ts = sh.top_s + q * N;
    int* ti = sh.top_i + q * N;
    const float* cs = sh.cand_s + q * sh.chunk;
    const int* ci = sh.cand_i + q * sh.chunk;
    RegList<NJ> top;
    list_load(top, ts, ti, N, lane);
    if (cnt <= kInsertMax) {
      const float mine_s = lane < cnt ? cs[lane] : 0.f;
      const int mine_i = lane < cnt ? ci[lane] : 0;
      for (int c = 0; c < cnt; ++c) {
        list_insert(top, __shfl_sync(kFull, mine_s, c),
                    __shfl_sync(kFull, mine_i, c), lane);
      }
    } else {
      RegList<NJ> best;  // the candidates' best N, sorted
      if (cnt <= 32) {
        RegList<1> c1;
        list_load(c1, cs, ci, cnt, lane);
        list_sort(c1, lane);
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          best.s[jj] = jj == 0 ? c1.s[0] : -INFINITY;
          best.id[jj] = jj == 0 ? c1.id[0] : kEmptyId;
        }
      } else {
        RegList<4> c4;
        list_load(c4, cs, ci, cnt, lane);
        list_sort(c4, lane);
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          best.s[jj] = c4.s[jj];
          best.id[jj] = c4.id[jj];
        }
      }
      list_merge(top, best, lane);
    }
    list_store(top, ts, ti, N, lane);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      if (jj == (k - 1) >> 5 && lane == ((k - 1) & 31)) {
        sh.th_s[q] = top.s[jj];
        sh.th_i[q] = top.id[jj];
      }
    }
    if (lane == 0) sh.cnt[q] = 0;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_topk_kernel(const T* __restrict__ user, const int* __restrict__ idx,
                  const T* __restrict__ item,
                  const float* __restrict__ uscale,
                  const float* __restrict__ iscale, int B, int m, int n_rows,
                  int r, int k, int kp, int base, int n_items, int qb,
                  int chunk, int vec16, int splits,
                  float* __restrict__ part_s, int* __restrict__ part_i,
                  float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int row_bytes = r * static_cast<int>(sizeof(T));
  const int sw = stride_words(row_bytes);
  const int se = sw * 4 / static_cast<int>(sizeof(T));  // stride in elements
  Shared sh;
  sh.len = list_len(k);
  sh.chunk = chunk;
  sh.tile = smem;
  sh.user = sh.tile + 2 * chunk * sw;
  sh.uscale = reinterpret_cast<float*>(sh.user + qb * sw);
  sh.th_s = sh.uscale + qb;
  sh.th_i = reinterpret_cast<int*>(sh.th_s + qb);
  sh.cnt = sh.th_i + qb;
  sh.top_s = reinterpret_cast<float*>(sh.cnt + qb);
  sh.top_i = reinterpret_cast<int*>(sh.top_s + qb * sh.len);
  sh.cand_s = reinterpret_cast<float*>(sh.top_i + qb * sh.len);
  sh.cand_i = reinterpret_cast<int*>(sh.cand_s + qb * chunk);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * qb;
  const int nq = min(qb, B - q0);  // live queries of this block
  const int sx = blockIdx.y;

  // zeros under every K pad (and under dead queries' rows), once
  for (int e = tid; e < (2 * chunk + qb) * sw; e += kThreads) smem[e] = 0u;
  for (int e = tid; e < qb; e += kThreads) {
    float su = 1.f;
    if (e < nq && uscale != nullptr) {
      const int row = idx[q0 + e];
      if (row >= 0 && row < m) su = uscale[row];
    }
    sh.uscale[e] = su;
    sh.th_s[e] = e < nq ? -INFINITY : INFINITY;
    sh.th_i[e] = kEmptyId;
    sh.cnt[e] = 0;
  }
  for (int e = tid; e < qb * sh.len; e += kThreads) {
    sh.top_s[e] = -INFINITY;
    sh.top_i[e] = kEmptyId;
  }
  __syncthreads();
  // Gather this block's user rows by index, in the wire's type. A row
  // index outside [0, m) reads nothing and scores as a zero row.
  {
    T* s_user = reinterpret_cast<T*>(sh.user);
    for (int e = tid; e < nq * r; e += kThreads) {
      const int q = e / r;
      const int d = e - q * r;
      const int row = idx[q0 + q];
      if (row >= 0 && row < m) s_user[q * se + d] = user[(size_t)row * r + d];
    }
  }

  const int n_chunks = (n_rows + chunk - 1) / chunk;
  const int c_begin = static_cast<int>((long long)sx * n_chunks / splits);
  const int c_end = static_cast<int>((long long)(sx + 1) * n_chunks / splits);

  // Stage chunk c: 16-byte asynchronous copies where the rows allow them,
  // else element by element. Either way the chunk is one commit group.
  auto load_tile = [&](int c, int stage) {
    const int c0 = c * chunk;
    const int rows = min(chunk, n_rows - c0);
    uint32_t* dst = sh.tile + stage * chunk * sw;
    const T* src = item + (size_t)c0 * r;
    if (vec16) {
      const int per_row = row_bytes / 16;
      const char* bytes = reinterpret_cast<const char*>(src);
      for (int e = tid; e < rows * per_row; e += kThreads) {
        const int row = e / per_row;
        const int p = e - row * per_row;
        cp_async16(dst + row * sw + p * 4, bytes + (size_t)e * 16);
      }
    } else {
      T* d = reinterpret_cast<T*>(dst);
      for (int e = tid; e < rows * r; e += kThreads) {
        const int row = e / r;
        d[row * se + (e - row * r)] = src[e];
      }
    }
    cp_async_commit();
  };

  if (c_begin < c_end) load_tile(c_begin, 0);
  for (int c = c_begin; c < c_end; ++c) {
    const int stage = (c - c_begin) & 1;
    if (c + 1 < c_end) {
      load_tile(c + 1, stage ^ 1);  // lands while chunk c is scored
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c is in; the last selection is done

    const int c0 = c * chunk;
    const int rows = min(chunk, n_rows - c0);
    const uint32_t* tile = sh.tile + stage * chunk * sw;
    if constexpr (std::is_same<T, float>::value) {
      // f32 FMAs: lane scores items lane + 32a, warp w queries w + 8j
      const float4* tile4 = reinterpret_cast<const float4*>(tile);
      const float4* user4 = reinterpret_cast<const float4*>(sh.user);
      const int sw4 = sw / 4;
      const int k4 = (r + 3) / 4;
      const int na = chunk / 32;
      const int nj = nq > warp ? (nq - warp + kWarps - 1) / kWarps : 0;
      if (nj > 0) {
        float isc[4];
        int gid[4];
        bool live[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int jj = lane + 32 * a;
          live[a] = a < na && jj < rows;
          gid[a] = base + c0 + jj;
          isc[a] = (iscale != nullptr && live[a]) ? iscale[c0 + jj] : 1.f;
        }
        float acc[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int a = 0; a < 4; ++a) acc[j][a] = 0.f;
        }
        for (int d4 = 0; d4 < k4; ++d4) {
          float4 v[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            v[a] = a < na ? tile4[(lane + 32 * a) * sw4 + d4]
                          : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (j < nj) {
              const float4 u = user4[(warp + kWarps * j) * sw4 + d4];
#pragma unroll
              for (int a = 0; a < 4; ++a) {
                acc[j][a] = fmaf(u.x, v[a].x, acc[j][a]);
                acc[j][a] = fmaf(u.y, v[a].y, acc[j][a]);
                acc[j][a] = fmaf(u.z, v[a].z, acc[j][a]);
                acc[j][a] = fmaf(u.w, v[a].w, acc[j][a]);
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j < nj) {
            const int q = warp + kWarps * j;
            const float th = sh.th_s[q];
            const float su = sh.uscale[q];
            float sc[4];
            bool pass = false;
#pragma unroll
            for (int a = 0; a < 4; ++a) {
              sc[a] = gid[a] < n_items ? acc[j][a] * su * isc[a] : -INFINITY;
              pass |= live[a] && sc[a] >= th;
            }
            // one vote a query: most hold no candidate among these rows
            if (__any_sync(kFull, pass)) {
#pragma unroll
              for (int a = 0; a < 4; ++a) {
                if (live[a] && sc[a] >= th) consider(sh, q, sc[a], gid[a]);
              }
            }
          }
        }
      }
    } else {
      // tensor cores: warp w scores item rows 16w..16w+15 of the chunk
      // against every live tile of 8 queries
      using Acc = typename std::conditional<std::is_same<T, int8_t>::value,
                                            int, float>::type;
      const int g = lane >> 2;
      const int t = lane & 3;
      if (warp * 16 < chunk) {
        const int ntiles = (nq + 7) / 8;
        const int ksteps = (row_bytes + 31) / 32;
        float isc[2];
        int gid[2];
        bool live[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int jj = warp * 16 + g + 8 * h;
          live[h] = jj < rows;
          gid[h] = base + c0 + jj;
          isc[h] = (iscale != nullptr && live[h]) ? iscale[c0 + jj] : 1.f;
        }
        Acc acc[8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = 0;
        }
        const uint32_t* a_lo = tile + (warp * 16 + g) * sw + t;
        const uint32_t* a_hi = a_lo + 8 * sw;
        const uint32_t* b_row = sh.user + g * sw + t;
        for (int ks = 0; ks < ksteps; ++ks) {
          const uint32_t a0 = a_lo[ks * 8], a1 = a_hi[ks * 8];
          const uint32_t a2 = a_lo[ks * 8 + 4], a3 = a_hi[ks * 8 + 4];
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            if (nt < ntiles) {
              const uint32_t b0 = b_row[nt * 8 * sw + ks * 8];
              const uint32_t b1 = b_row[nt * 8 * sw + ks * 8 + 4];
              mma_tile(acc[nt], a0, a1, a2, a3, b0, b1);
            }
          }
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (nt < ntiles) {
            // this lane's two queries of the tile: 2t and 2t + 1
            const int qa = nt * 8 + 2 * t;
            const float2 th = *reinterpret_cast<const float2*>(sh.th_s + qa);
            const float2 su = *reinterpret_cast<const float2*>(sh.uscale + qa);
            float sc[4];
            bool pass = false;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int h = e >> 1;
              sc[e] = gid[h] < n_items
                  ? static_cast<float>(acc[nt][e]) * ((e & 1) ? su.y : su.x) *
                        isc[h]
                  : -INFINITY;
              pass |= live[h] && sc[e] >= ((e & 1) ? th.y : th.x);
            }
            // one vote a tile: most tiles hold no candidate
            if (__any_sync(kFull, pass)) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int h = e >> 1;
                if (live[h] && sc[e] >= ((e & 1) ? th.y : th.x)) {
                  consider(sh, qa + (e & 1), sc[e], gid[h]);
                }
              }
            }
          }
        }
      }
    }
    __syncthreads();  // the tile is consumed; every candidate is listed

    if (sh.len == 32) {
      select_chunk<1>(sh, warp, lane, nq, k);
    } else {
      select_chunk<4>(sh, warp, lane, nq, k);
    }
  }

  __syncwarp();
  for (int q = warp; q < nq; q += kWarps) {
    const float* ts = sh.top_s + q * sh.len;
    const int* ti = sh.top_i + q * sh.len;
    if (splits == 1) {
      const size_t o = (size_t)(q0 + q) * k;
      for (int e = lane; e < k; e += 32) {
        const bool empty = ti[e] == kEmptyId;
        out_s[o + e] = empty ? -INFINITY : ts[e];
        out_i[o + e] = empty ? 0 : ti[e];
      }
    } else {
      const size_t o = ((size_t)(q0 + q) * splits + sx) * kp;
      for (int e = lane; e < kp; e += 32) {
        part_s[o + e] = ts[e];
        part_i[o + e] = ti[e];
      }
    }
  }
}

// The second pass: one block merges the `splits` sorted lists of one
// query, [kp] each, into out[b]. Warp w folds lists w, w + nw, ... into
// its own list in registers, the next list on its way while the current
// one is merged; then the nw lists fold pairwise through shared memory, a
// level a barrier.
constexpr int kMergeWarps = 16;

template <int NJ>
__device__ __forceinline__ void merge_lists(const float* __restrict__ ps,
                                            const int* __restrict__ pi,
                                            int splits, int k, int kp,
                                            float (*s_s)[kMaxK],
                                            int (*s_i)[kMaxK],
                                            float* __restrict__ out_s,
                                            int* __restrict__ out_i) {
  constexpr int N = 32 * NJ;
  const int nw = blockDim.x >> 5;  // a power of two
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  RegList<NJ> top, next;
  list_load(top, ps + (size_t)warp * kp, pi + (size_t)warp * kp,
            warp < splits ? kp : 0, lane);
  if (warp + nw < splits) {
    list_load(next, ps + (size_t)(warp + nw) * kp,
              pi + (size_t)(warp + nw) * kp, kp, lane);
  }
  for (int s = warp + nw; s < splits; s += nw) {
    const RegList<NJ> cand = next;
    if (s + nw < splits) {
      list_load(next, ps + (size_t)(s + nw) * kp, pi + (size_t)(s + nw) * kp,
                kp, lane);
    }
    list_merge(top, cand, lane);
  }
  for (int half = nw >> 1; half > 0; half >>= 1) {
    if (warp >= half && warp < 2 * half) {
      list_store(top, s_s[warp], s_i[warp], N, lane);
    }
    __syncthreads();
    if (warp < half) {
      RegList<NJ> cand;
      list_load(cand, s_s[warp + half], s_i[warp + half], N, lane);
      list_merge(top, cand, lane);
    }
  }
  if (warp != 0) return;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int e = j * 32 + lane;
    if (e < k) {
      const bool empty = top.id[j] == kEmptyId;
      out_s[e] = empty ? -INFINITY : top.s[j];
      out_i[e] = empty ? 0 : top.id[j];
    }
  }
}

__global__ void __launch_bounds__(kMergeWarps * 32)
merge_topk_kernel(const float* __restrict__ part_s,
                  const int* __restrict__ part_i, int splits, int k, int kp,
                  float* __restrict__ out_s, int* __restrict__ out_i) {
  __shared__ float s_s[kMergeWarps][kMaxK];
  __shared__ int s_i[kMergeWarps][kMaxK];
  const size_t b = blockIdx.x;
  const float* ps = part_s + b * splits * kp;
  const int* pi = part_i + b * splits * kp;
  if (kp <= 32) {
    merge_lists<1>(ps, pi, splits, k, kp, s_s, s_i, out_s + b * k,
                   out_i + b * k);
  } else {
    merge_lists<4>(ps, pi, splits, k, kp, s_s, s_i, out_s + b * k,
                   out_i + b * k);
  }
}

template <typename T>
int launch(int device, const void* user, const void* idx, const void* item,
           const void* uscale, const void* iscale, int B, int m, int n_rows,
           int r, int k, int base, int n_items, int qb, int chunk, int splits,
           int vec16, void* part_s, void* part_i, void* out_s, void* out_i,
           void* stream) {
  if (B < 0 || m < 1 || n_rows < 1 || r < 1 || r > kMaxRank || k < 1 ||
      k > kMaxK || qb < 8 || qb > kMaxQB || qb % 8 != 0 ||
      (chunk != kMinChunk && chunk != 64 && chunk != kMaxChunk) ||
      splits < 1 ||
      splits > (n_rows + chunk - 1) / chunk || splits > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int row_bytes = r * static_cast<int>(sizeof(T));
  if (vec16 && (row_bytes % 16 != 0 ||
                (reinterpret_cast<uintptr_t>(item) & 15) != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (splits > 1 && (part_s == nullptr || part_i == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int kp = 1;
  while (kp < k) kp <<= 1;
  const size_t smem = smem_bytes(row_bytes, qb, chunk, k);
  if (smem > 48 * 1024) {  // past the default limit: raise it
    err = cudaFuncSetAttribute(fused_topk_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + qb - 1) / qb, splits);
  fused_topk_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(user), static_cast<const int*>(idx),
      static_cast<const T*>(item), static_cast<const float*>(uscale),
      static_cast<const float*>(iscale), B, m, n_rows, r, k, kp, base, n_items,
      qb, chunk, vec16, splits, static_cast<float*>(part_s),
      static_cast<int*>(part_i), static_cast<float*>(out_s),
      static_cast<int*>(out_i));
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  int merge_warps = 1;
  while (merge_warps < splits && merge_warps < kMergeWarps) merge_warps <<= 1;
  merge_topk_kernel<<<B, merge_warps * 32, 0, s>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_i),
      splits, k, kp, static_cast<float*>(out_s), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, one per wire type. Pointers and the stream are passed
// as addresses; uscale/iscale may be null. qb (queries a block), chunk
// (item rows a tile), splits (catalogue ranges) and vec16 (16-byte
// asynchronous staging) are ops/fused_topk.py::topk_plan's; part_s/part_i
// [B, splits, kp] are read and written only when splits > 1. Returns a
// cudaError_t.
#define FUSED_TOPK_ENTRY(NAME, T)                                            \
  extern "C" int NAME(int device, const void* user, const void* idx,         \
                      const void* item, const void* uscale,                  \
                      const void* iscale, int B, int m, int n_rows, int r,   \
                      int k, int base, int n_items, int qb, int chunk,       \
                      int splits, int vec16, void* part_s, void* part_i,     \
                      void* out_s, void* out_i, void* stream) {              \
    return launch<T>(device, user, idx, item, uscale, iscale, B, m, n_rows,  \
                     r, k, base, n_items, qb, chunk, splits, vec16, part_s,  \
                     part_i, out_s, out_i, stream);                          \
  }

FUSED_TOPK_ENTRY(fused_topk_f32, float)
FUSED_TOPK_ENTRY(fused_topk_bf16, __nv_bfloat16)
FUSED_TOPK_ENTRY(fused_topk_i8, int8_t)

// Host queries for the shared-memory audit. fused_topk_smem_bytes is
// smem_bytes above (ops/smem.py::topk_smem_bytes is the same sum), and
// fused_topk_static_smem writes the kernel's static shared memory for the
// f32 (wire 4), bf16 (2) or int8 (1) tables to *out. Returns a cudaError_t.
extern "C" long long fused_topk_smem_bytes(int row_bytes, int qb, int chunk,
                                           int k) {
  return static_cast<long long>(smem_bytes(row_bytes, qb, chunk, k));
}

extern "C" int fused_topk_static_smem(int wire, long long* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaErrorInvalidValue;
  if (wire == 4) err = cudaFuncGetAttributes(&a, fused_topk_kernel<float>);
  if (wire == 2) {
    err = cudaFuncGetAttributes(&a, fused_topk_kernel<__nv_bfloat16>);
  }
  if (wire == 1) err = cudaFuncGetAttributes(&a, fused_topk_kernel<int8_t>);
  if (err == cudaSuccess) *out = static_cast<long long>(a.sharedSizeBytes);
  return static_cast<int>(err);
}
