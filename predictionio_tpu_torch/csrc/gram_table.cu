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
// The same (A, b) as fused_gram.cu. Padding slots carry w = 0 and are
// multiplied, not skipped; an index outside [0, m) counts as a zero row.
// A is all of [r, r] and exactly symmetric.
//
// What the TPU kernel is for is residency: the whole fixed table sits in
// VMEM and only idx, wa and wb (12 B a slot) stream from HBM. Its pair-
// packing of two rows into one [L, 2r] MXU contraction is a TPU tiling
// and does not carry over.
//
// What bounds it: the products. Per slot r(r+1)/2 + 2r useful operations
// against 12 B of indices and weights: at r = 64, B = 8,192, L = 512 that
// is 18.8 GFLOP against 184 MB, 0.28 ms at the 67 TFLOP/s f32 peak of the
// CUDA cores. So the products run on the tensor cores, at f32 accuracy:
//
// - A row's A is (wa . F)^T F over its L slots, an [r x L] . [L x r]
//   product. A row worker of W warps computes only the 16 x 8 tiles on or
//   below the diagonal with mma.sync.m16n8k8 TF32, f32 sums in registers.
//   A's 16-row strips are paired (s, S - 1 - s), one pair a warp, so every
//   warp holds 2 S + 2 tiles (S strips, S = ceil(r / 16)).
// - Each operand x is split into big = tf32(x) (round to nearest) and
//   small = x - big (exact in f32; the mma reads its leading 11 bits), and
//   a tile takes small_A big_B + big_A small_B + big_A big_B: about 2^-20
//   relative a product. A bf16 value is a TF32 value, so on the bf16 wire
//   F is exact and only wa . F is split: two passes.
// - b = F^T wb is f32 FMAs beside the products, each warp the columns of
//   its own strips, summed over a quad by shuffles in a fixed order.
// - A leaves from registers: each lower-triangle entry is written with its
//   mirror image, and nothing past r.
//
// Where the gathered rows come from:
//
// - Path 1, the table in shared memory (when (m + 1) rows fit a block's
//   opt-in shared memory): a block of several row workers loads the table
//   once, with 16-byte copies where rows allow, plus a zero row for
//   indices outside the table, and each worker reads its rows where they
//   lie. Only indices and weights stream, 32 slots at a time, one lane a
//   slot, handed to the mma lanes by shuffles. No barrier after the load.
// - Path 2, larger tables (the ML-20M item table at r = 64 is 6.85 MB):
//   each worker gathers its next 32 rows into one of two buffers of its
//   own while it multiplies the last 32: each lane copies its own slot's
//   row (its warp's share of the row's 16-byte pieces) by cp.async
//   through L1, so a row's two halves of a 32-byte sector are one L2
//   read; the table stays where the 50 MB L2 puts it.
//
// Rows in shared memory take row_words(r) words: whole 16-column strips
// (the columns past r are read but reach only entries that are never
// stored, so no load is guarded), then up to a stride of 8 or 24 words
// past a multiple of 32, so the four slots of a k-step (lanes t = 0..3)
// read four different bank windows of a staged buffer, and resident rows
// land on four windows at random (two-way on average, not four).
//
// The launch is cut by ops/gram.py::table_plan (path, workers a block,
// splits): a persistent grid of one block an SM walks the (row, split)
// items. When B rows would leave workers idle, a row's slots are cut into
// ranges as fused_gram does, and gram_tile.cuh's sum_partials adds the
// partials in the order of the ranges: two runs give the same bits.

#include "gram_tile.cuh"  // cp.async helpers and sum_partials

namespace {

constexpr int kGroup = 32;      // slots of indices and weights a lane each
constexpr int kMaxStrips = 8;   // 16-row strips of A at the largest rank
constexpr int kMaxRank = 16 * kMaxStrips;  // 128
constexpr int kMaxBarrierWorkers = 15;     // named barriers 1..15
constexpr int kBuffers = 2;     // a path-2 worker's buffers of rows

// Warps of a row worker at `strips` strips: one a pair of strips.
__host__ __device__ constexpr int worker_warps(int strips) {
  return (strips + 1) / 2;
}

// Most threads of a block at `strips` strips: what the register file
// gives warps holding 2 S + 2 tiles of 4 sums each (an SM's four
// schedulers each hold a quarter of its registers and of a block's warps:
// 16 warps leave 128 registers a thread, 12 leave 168).
__host__ __device__ constexpr int max_threads(int strips) {
  return strips <= 2 ? 640 : strips <= 4 ? 512 : 384;
}

// 32-bit words a row takes in shared memory: whole 16-column strips, then
// up to a stride of 8 or 24 words past a multiple of 32.
__host__ __device__ constexpr int row_words(int r, int itemsize) {
  int w = (r + 15) / 16 * 16 * itemsize / 4;
  while (w % 32 != 8 && w % 32 != 24) w += 4;
  return w;
}

// Dynamic shared memory of a block: path 1 the table and its zero row,
// path 2 kBuffers buffers of kGroup rows a worker.
__host__ __device__ constexpr long long table_smem(int path, int m, int r,
                                                   int itemsize,
                                                   int workers) {
  return path == 1
             ? (long long)(m + 1) * row_words(r, itemsize) * 4
             : (long long)workers * kBuffers * kGroup *
                   row_words(r, itemsize) * 4;
}

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// 16 bytes global -> shared through L1 (the lane's next piece of the same
// row reads the other half of the sector there); zeros when src_bytes is 0.
__device__ __forceinline__ void cp_async16_ca(void* smem_dst, const void* src,
                                              int src_bytes) {
  const uint32_t dst =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// x = big + small exactly: big the nearest TF32 value (ties away from
// zero), small the rest in f32, of which a TF32 mma reads the leading 11
// bits (up to 2^-21 |x| lost).
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32_bits(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

// D += A B, A 16 x 8 (row), B 8 x 8 (col), TF32 in, f32 sums. Lane (g =
// lane / 4, t = lane % 4) holds A (g, t), (g + 8, t), (g, t + 4), (g + 8,
// t + 4); B (t, g), (t + 4, g); D (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A group's indices and weights, one slot a lane.
struct Meta {
  int row;  // the table row; outside the table: m (path 1) or -1
  float wa;
  float wb;
};

__device__ __forceinline__ Meta load_meta(const int* __restrict__ idx,
                                          const float* __restrict__ wa,
                                          const float* __restrict__ wb,
                                          size_t base, int slot, int end,
                                          int m, int outside) {
  Meta x{outside, 0.f, 0.f};
  if (slot < end) {
    const int g = idx[base + slot];
    x.row = (g >= 0 && g < m) ? g : outside;
    x.wa = wa[base + slot];
    x.wb = wb[base + slot];
  }
  return x;
}

// The tiles of one warp: strips S1 = NS - 1 - S0 and S0 of A (one strip
// when they are the same), and b at those strips' columns.
template <typename T, int NS, int S0>
struct Tiles {
  static constexpr int S1 = NS - 1 - S0;
  static constexpr bool kPair = S0 < S1;
  static constexpr int N1 = 2 * S1 + 2;              // tiles of strip S1
  static constexpr int N0 = kPair ? 2 * S0 + 2 : 1;  // of S0 (unused: 1)
  static constexpr bool kExactB = sizeof(T) == 2;    // bf16 is TF32-exact

  float acc1[N1][4];
  float acc0[N0][4];
  float bp[4];  // b at 16 S1 + g, 16 S1 + 8 + g, 16 S0 + g, 16 S0 + 8 + g

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int n = 0; n < N1; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc1[n][e] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < N0; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc0[n][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) bp[e] = 0.f;
  }

  __device__ __forceinline__ void product(float (&d)[4],
                                          const uint32_t (&ab)[4],
                                          const uint32_t (&as)[4],
                                          uint32_t bb0, uint32_t bb1,
                                          uint32_t bs0, uint32_t bs1) {
    mma_tf32(d, as, bb0, bb1);
    if (!kExactB) mma_tf32(d, ab, bs0, bs1);
    mma_tf32(d, ab, bb0, bb1);
  }

  // A strip's operand from its columns' values: wa . f split.
  __device__ __forceinline__ static void operand(const float (&x)[4],
                                                 float wa_a, float wa_b,
                                                 uint32_t (&big)[4],
                                                 uint32_t (&small)[4]) {
    split(wa_a * x[0], big[0], small[0]);
    split(wa_a * x[1], big[1], small[1]);
    split(wa_b * x[2], big[2], small[2]);
    split(wa_b * x[3], big[3], small[3]);
  }

  // One k-step: this lane's slots k = t and k = t + 4, whose rows start
  // at fa and fb in shared memory, and their weights.
  __device__ __forceinline__ void step(const T* fa, const T* fb, float wa_a,
                                       float wa_b, float wb_a, float wb_b,
                                       int g) {
    float x[4], y[4];
    x[0] = ld(fa + 16 * S1 + g);
    x[1] = ld(fa + 16 * S1 + 8 + g);
    x[2] = ld(fb + 16 * S1 + g);
    x[3] = ld(fb + 16 * S1 + 8 + g);
    uint32_t a1b[4], a1s[4], a0b[4], a0s[4];
    operand(x, wa_a, wa_b, a1b, a1s);
    bp[0] = fmaf(wb_b, x[2], fmaf(wb_a, x[0], bp[0]));
    bp[1] = fmaf(wb_b, x[3], fmaf(wb_a, x[1], bp[1]));
    if (kPair) {
      y[0] = ld(fa + 16 * S0 + g);
      y[1] = ld(fa + 16 * S0 + 8 + g);
      y[2] = ld(fb + 16 * S0 + g);
      y[3] = ld(fb + 16 * S0 + 8 + g);
      operand(y, wa_a, wa_b, a0b, a0s);
      bp[2] = fmaf(wb_b, y[2], fmaf(wb_a, y[0], bp[2]));
      bp[3] = fmaf(wb_b, y[3], fmaf(wb_a, y[1], bp[3]));
    }
#pragma unroll
    for (int nb = 0; nb < N1; ++nb) {
      float v0, v1;  // B's (t, g) and (t + 4, g) of N-block nb
      if (nb == 2 * S1) {
        v0 = x[0]; v1 = x[2];
      } else if (nb == 2 * S1 + 1) {
        v0 = x[1]; v1 = x[3];
      } else if (kPair && nb == 2 * S0) {
        v0 = y[0]; v1 = y[2];
      } else if (kPair && nb == 2 * S0 + 1) {
        v0 = y[1]; v1 = y[3];
      } else {
        v0 = ld(fa + 8 * nb + g);
        v1 = ld(fb + 8 * nb + g);
      }
      uint32_t bb0, bs0 = 0u, bb1, bs1 = 0u;
      if (kExactB) {
        bb0 = __float_as_uint(v0);
        bb1 = __float_as_uint(v1);
      } else {
        split(v0, bb0, bs0);
        split(v1, bb1, bs1);
      }
      product(acc1[nb], a1b, a1s, bb0, bb1, bs0, bs1);
      if (kPair && nb < N0) product(acc0[nb], a0b, a0s, bb0, bb1, bs0, bs1);
    }
  }

  template <int N>
  __device__ __forceinline__ static void store_strip(const float (&acc)[N][4],
                                                     int s, float* A, int r,
                                                     int g, int t) {
#pragma unroll
    for (int nb = 0; nb < N; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 16 * s + g + 8 * (e >> 1);
        const int j = 8 * nb + 2 * t + (e & 1);
        if (i < r && j <= i) {
          A[i * r + j] = acc[nb][e];
          if (j < i) A[j * r + i] = acc[nb][e];  // the mirror image
        }
      }
    }
  }

  __device__ __forceinline__ void store(float* A, float* bout, int r, int g,
                                        int t) {
    store_strip(acc1, S1, A, r, g, t);
    if (kPair) store_strip(acc0, S0, A, r, g, t);
    const int cols[4] = {16 * S1 + g, 16 * S1 + 8 + g, 16 * S0 + g,
                         16 * S0 + 8 + g};
#pragma unroll
    for (int q = 0; q < (kPair ? 4 : 2); ++q) {
      float v = bp[q];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (t == 0 && cols[q] < r) bout[cols[q]] = v;
    }
  }
};

// The (row, split) items of one worker, for the warp of strips S0 and
// NS - 1 - S0.
template <typename T, int NS, int S0, bool kResident>
__device__ __forceinline__ void worker_loop(
    const T* __restrict__ table, const int* __restrict__ idx,
    const float* __restrict__ wa, const float* __restrict__ wb, int B, int L,
    int m, int r, int splits, int vec16, float* __restrict__ scratch,
    float* __restrict__ A, float* __restrict__ bout, unsigned char* smem,
    int worker, int workers) {
  constexpr int W = worker_warps(NS);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rs = row_words(r, sizeof(T)) * 4 / static_cast<int>(sizeof(T));
  const int outside = kResident ? m : -1;
  const T* s_tab = reinterpret_cast<const T*>(smem);
  T* stage = reinterpret_cast<T*>(smem) +
             static_cast<size_t>(worker) * kBuffers * kGroup * rs;
  const int wt = S0 * 32 + lane;  // this thread within its worker
  // a gathered row's pieces: 16 bytes each, or elements when a row is
  // no whole number of 16 bytes (or the table is unaligned)
  const int per = vec16 ? r * static_cast<int>(sizeof(T)) / 16 : r;
  const int g_slot = wt / per, g_piece = wt - g_slot * per;
  const int g_dslot = W * 32 / per, g_dpiece = W * 32 - g_dslot * per;
  // 16-byte pieces: this warp's share [lo, hi) of the row of the lane's
  // own slot, started at a piece that turns with lane / 4 so that the
  // four lanes whose rows share banks write different banks
  const int lo = S0 * per / W, hi = (S0 + 1) * per / W;
  const int first = hi > lo ? lo + (lane >> 2) % (hi - lo) : lo;
  auto worker_sync = [&]() {
    if (W == 1) {
      __syncwarp();
    } else {
      asm volatile("bar.sync %0, %1;\n" ::"r"(worker + 1), "r"(W * 32)
                   : "memory");
    }
  };
  // A group's rows into buffer `buf` of this worker (path 2): every warp
  // holds the group's indices, and the worker's threads share the copies.
  auto gather = [&](const Meta& meta, int buf) {
    T* dst = stage + buf * kGroup * rs;
    if (vec16) {
      const char* src = reinterpret_cast<const char*>(
          table + static_cast<size_t>(meta.row < 0 ? 0 : meta.row) * r);
      char* to = reinterpret_cast<char*>(dst + lane * rs);
      const int bytes = meta.row < 0 ? 0 : 16;
      int piece = first;
      for (int k = lo; k < hi; ++k) {
        cp_async16_ca(to + piece * 16, src + piece * 16, bytes);
        piece = piece + 1 == hi ? lo : piece + 1;
      }
    } else {
      // element by element: this thread's first element and its row, then
      // W * 32 elements on a pass (the division is done once, above)
      int slot = g_slot, piece = g_piece;
      for (int e0 = 0; e0 < kGroup * per; e0 += W * 32) {
        const int row = __shfl_sync(0xffffffffu, meta.row,
                                    slot < kGroup ? slot : 0);
        if (slot < kGroup) {
          dst[slot * rs + piece] =
              row < 0 ? gram_tile::zero_of(table)
                      : table[static_cast<size_t>(row) * r + piece];
        }
        slot += g_dslot;
        piece += g_dpiece;
        if (piece >= per) { piece -= per; ++slot; }
      }
    }
    gram_tile::cp_async_commit();
  };
  // The four k-steps of a group whose rows start at `rows` (path 2) or lie
  // in the resident table (path 1).
  auto multiply = [&](Tiles<T, NS, S0>& tiles, const Meta& meta,
                      const T* rows) {
#pragma unroll 1
    for (int j = 0; j < kGroup / 8; ++j) {
      const int sa = 8 * j + t;
      const int sb = sa + 4;
      const float wa_a = __shfl_sync(0xffffffffu, meta.wa, sa);
      const float wa_b = __shfl_sync(0xffffffffu, meta.wa, sb);
      const float wb_a = __shfl_sync(0xffffffffu, meta.wb, sa);
      const float wb_b = __shfl_sync(0xffffffffu, meta.wb, sb);
      const T* fa;
      const T* fb;
      if (kResident) {
        fa = s_tab + __shfl_sync(0xffffffffu, meta.row, sa) * rs;
        fb = s_tab + __shfl_sync(0xffffffffu, meta.row, sb) * rs;
      } else {
        fa = rows + sa * rs;
        fb = rows + sb * rs;
      }
      tiles.step(fa, fb, wa_a, wa_b, wb_a, wb_b, g);
    }
  };

  const int groups = (L + kGroup - 1) / kGroup;
  const long long items = static_cast<long long>(B) * splits;
  for (long long item = static_cast<long long>(blockIdx.x) * workers + worker;
       item < items; item += static_cast<long long>(gridDim.x) * workers) {
    const long long row = item / splits;
    const int s = static_cast<int>(item - row * splits);
    const int l0 = static_cast<int>((long long)s * groups / splits) * kGroup;
    const int l1 = min(L, static_cast<int>((long long)(s + 1) * groups /
                                           splits) * kGroup);
    const size_t base = static_cast<size_t>(row) * L;
    Tiles<T, NS, S0> tiles;
    tiles.zero();
    Meta cur = load_meta(idx, wa, wb, base, l0 + lane, l1, m, outside);
    if (kResident) {
      for (int l = l0; l < l1; l += kGroup) {
        Meta nxt{outside, 0.f, 0.f};
        if (l + kGroup < l1) {
          nxt = load_meta(idx, wa, wb, base, l + kGroup + lane, l1, m,
                          outside);
        }
        multiply(tiles, cur, nullptr);
        cur = nxt;
      }
    } else {
      Meta nxt{outside, 0.f, 0.f};
      if (l0 + kGroup < l1) {
        nxt = load_meta(idx, wa, wb, base, l0 + kGroup + lane, l1, m,
                        outside);
      }
      if (l0 < l1) gather(cur, 0);
      int q = 0;
      for (int l = l0; l < l1; l += kGroup, ++q) {
        Meta after{outside, 0.f, 0.f};
        const bool more = l + kGroup < l1;
        if (more) gather(nxt, (q + 1) & 1);  // freed by the last barrier
        if (l + 2 * kGroup < l1) {
          after = load_meta(idx, wa, wb, base, l + 2 * kGroup + lane, l1, m,
                            outside);
        }
        if (more) {
          gram_tile::cp_async_wait<1>();
        } else {
          gram_tile::cp_async_wait<0>();
        }
        worker_sync();  // the group's rows are in
        multiply(tiles, cur, stage + (q & 1) * kGroup * rs);
        worker_sync();  // and its buffer free again
        cur = nxt;
        nxt = after;
      }
    }
    float* Ao = A + static_cast<size_t>(row) * r * r;
    float* bo = bout + static_cast<size_t>(row) * r;
    if (splits > 1) {
      Ao = scratch + static_cast<size_t>(item) * ((size_t)r * r + r);
      bo = Ao + (size_t)r * r;
    }
    tiles.store(Ao, bo, r, g, t);
  }
}

template <typename T, int NS, int S0, bool kResident, typename... Args>
__device__ __forceinline__ void dispatch(int role, Args... args) {
  if constexpr (S0 < worker_warps(NS)) {
    if (role == S0) {
      worker_loop<T, NS, S0, kResident>(args...);
    } else {
      dispatch<T, NS, S0 + 1, kResident>(role, args...);
    }
  }
}

template <typename T, int NS, bool kResident>
__global__ void __launch_bounds__(max_threads(NS), 1)
gram_table_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                  const float* __restrict__ wa, const float* __restrict__ wb,
                  int B, int L, int m, int r, int splits, int vec16,
                  float* __restrict__ scratch, float* __restrict__ A,
                  float* __restrict__ bout) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int W = worker_warps(NS);
  const int warp = threadIdx.x >> 5;
  const int worker = warp / W;
  const int workers = blockDim.x / (32 * W);
  if (kResident) {
    // the table, once a block, then the zero row
    T* s_tab = reinterpret_cast<T*>(smem);
    const int rs = row_words(r, sizeof(T)) * 4 / static_cast<int>(sizeof(T));
    if (vec16) {
      const int per = r * static_cast<int>(sizeof(T)) / 16;
      const int step = 16 / static_cast<int>(sizeof(T));
      for (int e = threadIdx.x; e < m * per; e += blockDim.x) {
        const int q = e / per;
        const int p = e - q * per;
        gram_tile::cp_async16(s_tab + q * rs + p * step,
                              table + static_cast<size_t>(q) * r + p * step,
                              16);
      }
      gram_tile::cp_async_commit();
      gram_tile::cp_async_wait<0>();
    } else {
      for (int e = threadIdx.x; e < m * r; e += blockDim.x) {
        const int q = e / r;
        s_tab[q * rs + (e - q * r)] = table[e];
      }
    }
    for (int c = threadIdx.x; c < r; c += blockDim.x) {
      s_tab[m * rs + c] = gram_tile::zero_of(table);
    }
    __syncthreads();
  }
  dispatch<T, NS, 0, kResident>(warp - worker * W, table, idx, wa, wb, B, L,
                                m, r, splits, vec16, scratch, A, bout, smem,
                                worker, workers);
}

template <typename T, int NS>
cudaError_t launch_strips(int path, const void* table, const void* idx,
                          const void* wa, const void* wb, int B, int L, int m,
                          int r, int workers, int splits, int vec16,
                          int blocks, size_t smem, void* scratch, void* A,
                          void* b, cudaStream_t stream) {
  auto kern = path == 1 ? gram_table_kernel<T, NS, true>
                        : gram_table_kernel<T, NS, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int threads = workers * worker_warps(NS) * 32;
  kern<<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(table), static_cast<const int*>(idx),
      static_cast<const float*>(wa), static_cast<const float*>(wb), B, L, m,
      r, splits, vec16, static_cast<float*>(scratch), static_cast<float*>(A),
      static_cast<float*>(b));
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t total = static_cast<size_t>(B) * ((size_t)r * r + r);
  const size_t want = (total + 255) / 256;
  const int sblocks = static_cast<int>(want < 4096 ? want : 4096);
  gram_tile::sum_partials<<<sblocks, 256, 0, stream>>>(
      static_cast<const float*>(scratch), static_cast<size_t>(B), r, splits,
      static_cast<float*>(A), static_cast<float*>(b));
  return cudaGetLastError();
}

template <typename T>
int launch(int device, const void* table, const void* idx, const void* wa,
           const void* wb, int B, int L, int m, int r, int path, int workers,
           int splits, long long smem_bytes, void* scratch, void* A, void* b,
           void* stream) {
  const int itemsize = static_cast<int>(sizeof(T));
  if (B < 0 || L < 0 || m < 1 || r < 1 || r > kMaxRank ||
      (path != 1 && path != 2) || workers < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int strips = (r + 15) / 16;
  const int warps = worker_warps(strips);
  const int groups = (L + kGroup - 1) / kGroup;
  if (workers * warps * 32 > max_threads(strips) ||
      (path == 2 && warps > 1 && workers > kMaxBarrierWorkers) ||
      splits < 1 || splits > 65535 || (splits > 1 && splits > groups) ||
      (splits > 1 && scratch == nullptr) ||
      smem_bytes != table_smem(path, m, r, itemsize, workers)) {
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
  if (smem_bytes > optin) return static_cast<int>(cudaErrorInvalidValue);
  const int vec16 = (r * itemsize) % 16 == 0 &&
                    (reinterpret_cast<uintptr_t>(table) & 15) == 0;
  const long long items = static_cast<long long>(B) * splits;
  const long long want = (items + workers - 1) / workers;
  const int blocks = static_cast<int>(want < n_sm ? want : n_sm);
  const size_t smem = static_cast<size_t>(smem_bytes);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (strips) {
#define GRAM_TABLE_STRIPS(NS)                                                \
  case NS:                                                                   \
    err = launch_strips<T, NS>(path, table, idx, wa, wb, B, L, m, r,         \
                               workers, splits, vec16, blocks, smem,         \
                               scratch, A, b, s);                            \
    break;
    GRAM_TABLE_STRIPS(1)
    GRAM_TABLE_STRIPS(2)
    GRAM_TABLE_STRIPS(3)
    GRAM_TABLE_STRIPS(4)
    GRAM_TABLE_STRIPS(5)
    GRAM_TABLE_STRIPS(6)
    GRAM_TABLE_STRIPS(7)
    GRAM_TABLE_STRIPS(8)
#undef GRAM_TABLE_STRIPS
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

template <typename T, int NS>
cudaError_t static_smem_of(long long* out) {
  cudaFuncAttributes a1, a2;
  cudaError_t err = cudaFuncGetAttributes(&a1, gram_table_kernel<T, NS, true>);
  if (err != cudaSuccess) return err;
  err = cudaFuncGetAttributes(&a2, gram_table_kernel<T, NS, false>);
  if (err != cudaSuccess) return err;
  const long long most = static_cast<long long>(
      a1.sharedSizeBytes > a2.sharedSizeBytes ? a1.sharedSizeBytes
                                              : a2.sharedSizeBytes);
  if (most > *out) *out = most;
  return cudaSuccess;
}

template <typename T>
cudaError_t static_smem(long long* out) {
  *out = 0;
  cudaError_t err = static_smem_of<T, 1>(out);
  if (err == cudaSuccess) err = static_smem_of<T, 2>(out);
  if (err == cudaSuccess) err = static_smem_of<T, 3>(out);
  if (err == cudaSuccess) err = static_smem_of<T, 4>(out);
  if (err == cudaSuccess) err = static_smem_of<T, 5>(out);
  if (err == cudaSuccess) err = static_smem_of<T, 6>(out);
  if (err == cudaSuccess) err = static_smem_of<T, 7>(out);
  if (err == cudaSuccess) err = static_smem_of<T, 8>(out);
  return err;
}

}  // namespace

// C entry points, one per table type. table [m, r], idx/wa/wb [B, L]
// (contiguous, int32 / f32 / f32), A [B, r, r] and b [B, r] f32 outputs,
// scratch [B, splits, r*r + r] f32 when splits > 1. path (1 the table in
// shared memory, 2 rows gathered through L2), workers a block, splits and
// smem_bytes are ops/gram.py::table_plan's; the launch refuses a plan
// whose bytes are not table_smem's or pass the card's opt-in limit.
// Pointers and the stream are passed as addresses. Returns a cudaError_t.
#define GRAM_TABLE_ENTRY(NAME, T)                                            \
  extern "C" int NAME(int device, const void* table, const void* idx,        \
                      const void* wa, const void* wb, int B, int L, int m,   \
                      int r, int path, int workers, int splits,              \
                      long long smem_bytes, void* scratch, void* A, void* b, \
                      void* stream) {                                        \
    return launch<T>(device, table, idx, wa, wb, B, L, m, r, path, workers,  \
                     splits, smem_bytes, scratch, A, b, stream);             \
  }

GRAM_TABLE_ENTRY(gram_table_f32, float)
GRAM_TABLE_ENTRY(gram_table_bf16, __nv_bfloat16)

// Host queries for the shared-memory audit. gram_table_smem_bytes is
// table_smem for f32 (itemsize 4) or bf16 (2) tables
// (ops/smem.py::gram_table_bytes is the same sum), -1 for another
// itemsize or path; gram_table_static_smem writes the most static shared
// memory of any of the wire's kernels to *out. Returns a cudaError_t.
extern "C" long long gram_table_smem_bytes(int path, int m, int r,
                                           int itemsize, int workers) {
  if ((itemsize != 4 && itemsize != 2) || (path != 1 && path != 2)) return -1;
  return table_smem(path, m, r, itemsize, workers);
}

extern "C" int gram_table_static_smem(int itemsize, long long* out) {
  cudaError_t err = cudaErrorInvalidValue;
  if (itemsize == 4) err = static_smem<float>(out);
  if (itemsize == 2) err = static_smem<__nv_bfloat16>(out);
  return static_cast<int>(err);
}
