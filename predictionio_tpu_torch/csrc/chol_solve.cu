// Batched Cholesky solve of small SPD systems for the ALS half-steps,
// written for Hopper (sm_90a), bound to PyTorch through a plain C
// interface (ctypes).
//
// Replaces both Pallas kernels that predictionio_tpu/ops/solve.py::
// _solve_spd_pallas (:152) launches: _chol_solve_kernel (:126, padded
// rank <= 88, pallas_call :184) and _chol_solve_kernel_inplace (:133,
// 88 < padded rank <= 128, pallas_call :212). They share _chol_body (:39)
// and differ only in how one 128-system block fits the TPU's VMEM.
//
// What it computes, for each system i of a batch of f32 [r, r] SPD
// matrices (r <= 128), reading only the lower triangle (row >= col):
//   M      = A[i] + jitter * I
//   M      = L L^T     in place, right-looking: pivot clamped as
//                      rsqrt(max(piv, 1e-30)), column k scaled by it and
//                      masked to the rows >= k, the trailing matrix
//                      updated by l l^T
//   L y    = b[i]      forward substitution (right-looking, as the TPU's),
//                      divisions by max(l_kk, 1e-30)
//   L^T x  = y         backward substitution (right-looking: the TPU's is
//                      left-looking, so sums go in another order), the
//                      same clamp
//   x[i]   = x
//
// What bounds it: the bytes. One system moves (r(r+1)/2 + 2r) * 4 bytes
// (8.8 KB at r = 64) for about r^3/3 + 2r^2 operations (95 kFLOP); at
// ML-20M width the 138,493 user systems at r = 64 move 1.22 GB: 0.365 ms
// at the H100's 3.35 TB/s (NVIDIA H100 80GB HBM3, 700 W). What keeps the
// kernel above that is instruction issue and the latency of the chain of
// column steps, not bytes (PERF.md).
//
// The design. One system's Cholesky is a chain of r dependent column
// steps. The chain is kept inside one warp, so no step waits on a
// block-wide barrier, and the trailing update is spread so that every
// lane does the same work each step:
//   * lanes own whole rows, paired from both ends: lane t holds rows t
//     and R-1-t (R the padded rank); at R > 64 also rows 32+t and
//     R-33-t. A lane's rows together are about R+1 entries long;
//     ops/solve.py::lane_rows is the same map, held by the tests.
//   * R <= 64 ("registers"): the two rows live in registers, R/2 lanes a
//     system, so a warp holds 4 systems at R = 16 and 2 at R = 32. The
//     rows are cut into chunks of kChunk columns; the column step k runs
//     in phase k / kChunk, a compile-time number, so the chunks left of
//     the phase are finished and skipped, the chunks right of it are
//     updated at fixed register indices, and the phase's own chunk
//     rotates by one slot a step (column k always at slot 0, L's value
//     entering at the last slot), which keeps every index static
//     although the step loop is not unrolled. Column k's multipliers go
//     to the lanes through a per-warp vector in shared memory and one
//     __syncwarp() a step (two buffers, alternating); the pivot and the
//     forward sweep's y_k go by __shfl_sync.
//   * R in {96, 128} ("shared"): four rows a lane would need ~260
//     registers, so the matrix stays in shared memory, one warp a system,
//     each lane updating its own rows in 16-byte chunks; the shared
//     route raises the block's dynamic shared-memory limit past 48 KB.
//   * the forward sweep runs inside the factorization (y_k as soon as
//     column k exists). The backward sweep runs right-looking: x_k leaves
//     row k's lane by one shuffle and each lane takes L[k][i] x_k off its
//     own rows i < k, reading row k of L from shared memory (in the
//     register route the rows of L are written there once, after the
//     factorization). A left-looking sweep needs a sum over the lanes
//     each step, a butterfly of five shuffles, and was measured slower
//     on the H100 (PERF.md).
//   * loads read the lower triangle only, as 16-byte words where rows
//     start 16-byte aligned (r % 4 == 0 and an aligned base), element by
//     element otherwise. A word may reach up to three entries past the
//     diagonal; they are masked to 0 before any arithmetic, so A's upper
//     triangle may hold any value. In registers each lane reads its own
//     two rows, every word in flight at once; the other half of each
//     32-byte sector is the same lane's next word, so memory moves the
//     triangle's bytes. Staging the rows through shared memory so that
//     neighbouring lanes read neighbouring words was measured slower on
//     the H100 (PERF.md): index arithmetic, two __syncwarp() and
//     one round trip to memory for every 8 rows. In the shared route the
//     warp reads each row on neighbouring words.
//   * identity rows and columns pad r to R, zeros pad b, and x leaves
//     once, lanes on neighbouring addresses. The padding adds only exact
//     zeros to the real part's sums.
// ops/solve.py::solve_plan chooses R, the route and the warps a block.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxRank = 128;
constexpr int kRegMaxRank = 64;
constexpr int kChunk = 8;          // columns a chunk; a phase is kChunk steps
constexpr int kWarpsPerBlock = 4;  // the most the plan asks for
constexpr unsigned kFull = 0xffffffffu;

// 1/sqrt(v) for v >= 1e-30, a normal number, so flushing subnormals
// changes nothing and saves rsqrtf's rescaling
__device__ __forceinline__ float rsqrt_normal(float v) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(v));
  return y;
}

__host__ __device__ constexpr int pow2ceil(int v) {
  return v <= 1 ? 1 : 2 * pow2ceil((v + 1) / 2);
}

// N floats of shared memory (16-byte aligned) into registers.
template <int N>
__device__ __forceinline__ void load_vec(float (&dst)[N], const float* src) {
#pragma unroll
  for (int s = 0; s < N; s += 4) {
    const float4 v = *reinterpret_cast<const float4*>(src + s);
    dst[s] = v.x;
    dst[s + 1] = v.y;
    dst[s + 2] = v.z;
    dst[s + 3] = v.w;
  }
}

// ---- route "registers": R in {16, 32, 48, 64} -----------------------------

// Where row i of L starts when each row i holds entries 0..i rounded up
// to whole 16-byte words: rows 4a+b follow 4a rows of 4, 8, ... 4a words.
__host__ __device__ constexpr int tri_offset(int i) {
  return 4 * (i / 4 + 1) * (2 * (i / 4) + i % 4);
}

template <int R>
struct Reg {
  static constexpr int G = R / 2;         // lanes a system
  static constexpr int GW = pow2ceil(G);  // lanes reserved a system
  static constexpr int S = 32 / GW;       // systems a warp
  static constexpr int C = R / kChunk;    // chunks of the long row
  static constexpr int CL = C / 2;        // chunks of the short row
  static constexpr int VEC = R + kChunk;  // multipliers: by row, rotated
  static constexpr int TRI = tri_offset(R);  // L's rows, 16-byte aligned
  static constexpr int SYS = 2 * VEC + TRI;  // floats a system
};

// two multiplier vectors and L's rows a system
__host__ __device__ constexpr size_t reg_smem_bytes(int R, int warps) {
  return (size_t)warps * (32 / pow2ceil(R / 2)) *
         (2 * (R + kChunk) + tri_offset(R)) * sizeof(float);
}

// Entry j of row i of M = A + jitter * I padded with the identity, from
// a value e loaded at (i, j) where j <= i < r (anything elsewhere): the
// entries past the diagonal are 0, whatever e holds.
__device__ __forceinline__ float masked(float e, int i, int j, int r,
                                        float jitter) {
  if (i < r) return j < i ? e : (j == i ? e + jitter : 0.f);
  return j == i ? 1.f : 0.f;
}

// Row i of one system, its first N entries masked, straight into one
// lane's registers (16-byte words where rows are aligned).
template <int N>
__device__ __forceinline__ void load_row(float (&row)[N], const float* Ag,
                                         int i, int r, bool vec16,
                                         float jitter) {
  const float* src = Ag + (size_t)i * r;
  if (vec16) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < r && 4 * q <= i) {
        v = __ldg(reinterpret_cast<const float4*>(src) + q);
      }
      row[4 * q] = v.x;
      row[4 * q + 1] = v.y;
      row[4 * q + 2] = v.z;
      row[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      row[j] = (i < r && j <= i) ? __ldg(src + j) : 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) row[j] = masked(row[j], i, j, r, jitter);
}

// Column steps k = P*kChunk ... P*kChunk + kChunk - 1 of the factorization,
// with the forward sweep. lo: row t (chunks 0..CL-1), hi: row R-1-t.
template <int R, int P>
__device__ __forceinline__ void reg_phase(float (&lo)[R / 2], float (&hi)[R],
                                          float& acc_lo, float& acc_hi,
                                          float* vec, int t, int gb,
                                          bool active) {
  using Q = Reg<R>;
  constexpr int W = kChunk;
  constexpr bool kLo = P < Q::CL;  // the short rows own column k
  const int rlo = t, rhi = R - 1 - t;
#pragma unroll 1
  for (int q = 0; q < W; ++q) {
    const int k = P * W + q;
    // column k sits at slot 0 of chunk P (it rotates one slot a step)
    float ck_lo = 0.f;
    if constexpr (kLo) ck_lo = lo[P * W];
    const float ck_hi = hi[P * W];
    const int owner = gb + (kLo ? k : R - 1 - k);
    const float piv = __shfl_sync(kFull, kLo ? ck_lo : ck_hi, owner);
    const float inv = rsqrt_normal(fmaxf(piv, 1e-30f));
    const float l_lo = (kLo && rlo >= k) ? ck_lo * inv : 0.f;
    const float l_hi = rhi >= k ? ck_hi * inv : 0.f;

    // forward sweep: y_k, then the rows below take l * y_k off
    const float acc_k = __shfl_sync(kFull, kLo ? acc_lo : acc_hi, owner);
    const float yk = acc_k / fmaxf(piv * inv, 1e-30f);
    if constexpr (kLo) {
      acc_lo = rlo == k ? yk : (rlo > k ? acc_lo - l_lo * yk : acc_lo);
    }
    acc_hi = rhi == k ? yk : (rhi > k ? acc_hi - l_hi * yk : acc_hi);

    // multipliers: v[j] = l_j by row; rel[s] = l of the column at slot s
    // of chunk P (rows < k carry l = 0, so finished slots stay)
    float* v = vec + (q & 1) * Q::VEC;
    float* rel = v + R;
    if (active) {
      if constexpr (kLo) {
        v[rlo] = l_lo;
        if (rlo / W == P) rel[(rlo - k) & (W - 1)] = l_lo;
      } else {
        if (rhi / W == P) rel[(rhi - k) & (W - 1)] = l_hi;
      }
      v[rhi] = l_hi;
    }
    __syncwarp();

    float m[W];
    load_vec<W>(m, rel);
    // the phase's chunk: update and rotate down one slot, L in at the top
    if constexpr (kLo) {
#pragma unroll
      for (int s = 1; s < W; ++s) {
        lo[P * W + s - 1] = lo[P * W + s] - l_lo * m[s];
      }
      lo[P * W + W - 1] = l_lo;
    }
#pragma unroll
    for (int s = 1; s < W; ++s) {
      hi[P * W + s - 1] = hi[P * W + s] - l_hi * m[s];
    }
    hi[P * W + W - 1] = l_hi;
    // the chunks right of it, in place
#pragma unroll
    for (int c = P + 1; c < Q::C; ++c) {
      float mm[W];
      load_vec<W>(mm, v + c * W);
#pragma unroll
      for (int s = 0; s < W; ++s) hi[c * W + s] -= l_hi * mm[s];
      if (c < Q::CL) {  // c is a constant once unrolled
#pragma unroll
        for (int s = 0; s < W; ++s) lo[c * W + s] -= l_lo * mm[s];
      }
    }
  }
}

template <int R, int P>
__device__ __forceinline__ void reg_factor(float (&lo)[R / 2], float (&hi)[R],
                                           float& acc_lo, float& acc_hi,
                                           float* vec, int t, int gb,
                                           bool active) {
  reg_phase<R, P>(lo, hi, acc_lo, acc_hi, vec, t, gb, active);
  if constexpr (P + 1 < Reg<R>::C) {
    reg_factor<R, P + 1>(lo, hi, acc_lo, acc_hi, vec, t, gb, active);
  }
}

template <int R>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, 4)
chol_solve_regs(const float* __restrict__ A, const float* __restrict__ b,
                float* __restrict__ x, int n, int r, float jitter,
                int vec16) {
  using P = Reg<R>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane / P::GW;
  const int t = lane - g * P::GW;
  const int gb = g * P::GW;
  const long long first = ((long long)blockIdx.x * (blockDim.x >> 5) + warp) *
                          P::S;
  if (first >= n) return;  // the whole warp: no lane waits on it
  const long long sys = first + g;
  const bool live = sys < n;
  const bool active = live && t < P::G;
  float* vec = smem + ((size_t)warp * P::S + g) * P::SYS;
  float* tri = vec + 2 * P::VEC;
  const int rlo = t, rhi = R - 1 - t;
  const float* Ag = A + (live ? sys : 0) * (size_t)r * r;

  float lo[R / 2], hi[R];
#pragma unroll
  for (int j = 0; j < R / 2; ++j) lo[j] = 0.f;
#pragma unroll
  for (int j = 0; j < R; ++j) hi[j] = 0.f;
  float acc_lo = 0.f, acc_hi = 0.f;
  if (active) {
    load_row(lo, Ag, rlo, r, vec16 != 0, jitter);
    load_row(hi, Ag, rhi, r, vec16 != 0, jitter);
    if (rlo < r) acc_lo = __ldg(b + sys * r + rlo);
    if (rhi < r) acc_hi = __ldg(b + sys * r + rhi);
  }

  reg_factor<R, 0>(lo, hi, acc_lo, acc_hi, vec, t, gb, active);

  // backward sweep, right-looking: the rows of L go to shared memory
  // (row i at tri_offset(i), starting on 16 bytes), x_k leaves row k's
  // lane by one shuffle, and every lane takes L[k][i] x_k off its rows
  // i < k. Per step one shuffle and three shared loads, against the
  // five-shuffle butterfly a left-looking sum over the lanes costs.
  if (active) {
#pragma unroll
    for (int q = 0; q < R / 8; ++q) {
      if (4 * q <= rlo) {
        *reinterpret_cast<float4*>(tri + tri_offset(rlo) + 4 * q) = make_float4(
            lo[4 * q], lo[4 * q + 1], lo[4 * q + 2], lo[4 * q + 3]);
      }
    }
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      if (4 * q <= rhi) {
        *reinterpret_cast<float4*>(tri + tri_offset(rhi) + 4 * q) = make_float4(
            hi[4 * q], hi[4 * q + 1], hi[4 * q + 2], hi[4 * q + 3]);
      }
    }
  }
  __syncwarp();
  float x_lo = 0.f, x_hi = 0.f;
#pragma unroll 4
  for (int k = R - 1; k >= 0; --k) {
    const float* Lk = tri + tri_offset(k);
    const bool kLo = k < R / 2;
    // x_k = (y_k - sum_{j>k} L[j][k] x_j) / L[k][k]: row k's lane holds
    // the difference in its acc
    const float xk = __shfl_sync(
        kFull, (kLo ? acc_lo : acc_hi) / fmaxf(Lk[k], 1e-30f),
        gb + (kLo ? k : R - 1 - k));
    if (rlo == k) x_lo = xk;
    if (rhi == k) x_hi = xk;
    if (rlo < k) acc_lo -= Lk[rlo] * xk;
    if (rhi < k) acc_hi -= Lk[rhi] * xk;
  }
  if (active) {
    if (rlo < r) x[sys * r + rlo] = x_lo;
    if (rhi < r) x[sys * r + rhi] = x_hi;
  }
}

// ---- route "shared": R in {96, 128}, one warp a system --------------------

template <int R>
struct Shm {
  static constexpr int NR = R / 32;  // rows a lane
  static constexpr int LD = R + 4;   // row stride (floats)
  static constexpr int MAT = R * LD;
  static constexpr int WARP = MAT + 2 * R;  // matrix + two multiplier rows
};

__host__ __device__ constexpr size_t shm_smem_bytes(int R, int warps) {
  return (size_t)warps * (R * (R + 4) + 2 * R) * sizeof(float);
}

// Slot m of lane t: rows t, R-1-t, 32+t, R-33-t (pairs from both ends).
template <int R>
__device__ __forceinline__ int slot_row(int m, int t) {
  return m == 0 ? t : m == 1 ? R - 1 - t : m == 2 ? 32 + t : R - 33 - t;
}

// One past the last row of slot m (every lane's row there is below it).
template <int R>
__host__ __device__ constexpr int slot_end(int m) {
  return m == 0 ? 32 : m == 1 ? R : m == 2 ? 64 : R - 32;
}

template <int R, int P>
__device__ __forceinline__ void shm_phase(float* M, float* vec,
                                          float (&acc)[Shm<R>::NR], int t) {
  using Q = Shm<R>;
  constexpr int W = kChunk;
  // the slot whose rows hold columns P*W ... P*W + W - 1 on the diagonal
  constexpr int kOwn = P * W < 32       ? 0
                       : P * W >= R - 32 ? 1
                       : P * W < 64      ? 2
                                         : 3;
#pragma unroll 1
  for (int q = 0; q < W; ++q) {
    const int k = P * W + q;
    float l[Q::NR];
    float own = 0.f;
#pragma unroll
    for (int m = 0; m < Q::NR; ++m) {
      l[m] = 0.f;
      if (slot_end<R>(m) > P * W) {
        const float v = M[slot_row<R>(m, t) * Q::LD + k];
        if (m == kOwn) own = v;
        l[m] = v;
      }
    }
    const int owner = kOwn == 0 ? k : kOwn == 1 ? R - 1 - k
                    : kOwn == 2 ? k - 32 : R - 33 - k;
    const float piv = __shfl_sync(kFull, own, owner);
    const float inv = rsqrt_normal(fmaxf(piv, 1e-30f));
    const float acc_k = __shfl_sync(kFull, acc[kOwn], owner);
    const float yk = acc_k / fmaxf(piv * inv, 1e-30f);
    float* v = vec + (q & 1) * R;
#pragma unroll
    for (int m = 0; m < Q::NR; ++m) {
      if (slot_end<R>(m) > P * W) {
        const int i = slot_row<R>(m, t);
        l[m] = i >= k ? l[m] * inv : 0.f;
        acc[m] = i == k ? yk : (i > k ? acc[m] - l[m] * yk : acc[m]);
        v[i] = l[m];
      }
    }
    __syncwarp();
    // trailing update of each open row, chunk by chunk from chunk P
#pragma unroll
    for (int c = P; c < R / W; ++c) {
      float mm[W];
      load_vec<W>(mm, v + c * W);
#pragma unroll
      for (int m = 0; m < Q::NR; ++m) {
        if (slot_end<R>(m) > c * W) {
          float* row = M + slot_row<R>(m, t) * Q::LD + c * W;
          float e[W];
          load_vec<W>(e, row);
#pragma unroll
          for (int s = 0; s < W; ++s) e[s] -= l[m] * mm[s];
#pragma unroll
          for (int s = 0; s < W; s += 4) {
            *reinterpret_cast<float4*>(row + s) =
                make_float4(e[s], e[s + 1], e[s + 2], e[s + 3]);
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < Q::NR; ++m) {
      if (slot_end<R>(m) > P * W) M[slot_row<R>(m, t) * Q::LD + k] = l[m];
    }
  }
}

template <int R, int P>
__device__ __forceinline__ void shm_factor(float* M, float* vec,
                                           float (&acc)[Shm<R>::NR], int t) {
  shm_phase<R, P>(M, vec, acc, t);
  if constexpr (P + 1 < R / kChunk) shm_factor<R, P + 1>(M, vec, acc, t);
}

template <int R>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
chol_solve_smem(const float* __restrict__ A, const float* __restrict__ b,
                float* __restrict__ x, int n, int r, float jitter,
                int vec16) {
  using Q = Shm<R>;
  extern __shared__ float4 smem4[];
  const int t = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long sys = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (sys >= n) return;
  float* M = reinterpret_cast<float*>(smem4) + (size_t)warp * Q::WARP;
  float* vec = M + Q::MAT;
  const float* Ag = A + sys * (size_t)r * r;

  // the lower triangle, a row at a time; zeros above the diagonal,
  // identity rows past r
#pragma unroll 4
  for (int i = 0; i < R; ++i) {
    float* dst = M + i * Q::LD;
    const float* src = Ag + (size_t)i * r;
    if (vec16) {
      for (int q = t; q < R / 4; q += 32) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < r && 4 * q <= i) {
          v = __ldg(reinterpret_cast<const float4*>(src) + q);
        }
        v.x = masked(v.x, i, 4 * q, r, jitter);
        v.y = masked(v.y, i, 4 * q + 1, r, jitter);
        v.z = masked(v.z, i, 4 * q + 2, r, jitter);
        v.w = masked(v.w, i, 4 * q + 3, r, jitter);
        reinterpret_cast<float4*>(dst)[q] = v;
      }
    } else {
      for (int j = t; j < R; j += 32) {
        dst[j] = masked((i < r && j <= i) ? __ldg(src + j) : 0.f, i, j, r,
                        jitter);
      }
    }
  }
  float acc[Q::NR];
#pragma unroll
  for (int m = 0; m < Q::NR; ++m) {
    const int i = slot_row<R>(m, t);
    acc[m] = i < r ? __ldg(b + sys * r + i) : 0.f;
  }
  __syncwarp();

  shm_factor<R, 0>(M, vec, acc, t);
  __syncwarp();

  // backward sweep, right-looking, as in the register route: x_k from
  // row k's lane by one shuffle, then every lane takes L[k][i] x_k off
  // its rows i < k, reading row k of L on neighbouring words
  float xs[Q::NR];
#pragma unroll
  for (int m = 0; m < Q::NR; ++m) xs[m] = 0.f;
#pragma unroll 1
  for (int k = R - 1; k >= 0; --k) {
    const float* Mk = M + k * Q::LD;
    float own = 0.f;
#pragma unroll
    for (int m = 0; m < Q::NR; ++m) {
      if (slot_row<R>(m, t) == k) own = acc[m];
    }
    const int owner = k < 32 ? k : k >= R - 32 ? R - 1 - k
                    : k < 64 ? k - 32 : R - 33 - k;
    const float xk = __shfl_sync(kFull, own / fmaxf(Mk[k], 1e-30f), owner);
#pragma unroll
    for (int m = 0; m < Q::NR; ++m) {
      const int i = slot_row<R>(m, t);
      if (i == k) xs[m] = xk;
      if (i < k) acc[m] -= Mk[i] * xk;
    }
  }
#pragma unroll
  for (int m = 0; m < Q::NR; ++m) {
    const int i = slot_row<R>(m, t);
    if (i < r) x[sys * r + i] = xs[m];
  }
}

template <typename K>
cudaError_t launch(K kernel, int threads, size_t smem, long long blocks,
                   cudaStream_t stream, const float* A, const float* b,
                   float* x, int n, int r, float jitter, int vec16) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      A, b, x, n, r, jitter, vec16);
  return cudaGetLastError();
}

}  // namespace

// C entry point: A [n, r, r] and b [n, r] f32 inputs (contiguous; only
// A's lower triangle is read, nothing is written to it), x [n, r] f32
// output, r <= 128. The launch is ops/solve.py::solve_plan's: padded
// rank rp (16, 32, 48 or 64 in registers; 96 or 128 in shared memory),
// warps a block, vec16 (16-byte loads) and the dynamic shared memory it
// computed, which must equal this file's. Pointers and the stream are
// passed as addresses. Returns a cudaError_t.
extern "C" int chol_solve_f32(int device, const void* A, const void* b,
                              void* x, int n, int r, int rp, int warps,
                              int vec16, long long smem_bytes, float jitter,
                              void* stream) {
  if (n < 0 || r < 1 || r > kMaxRank || rp < r || warps < 1 ||
      warps > kWarpsPerBlock) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool regs = rp <= kRegMaxRank;
  const size_t smem = regs ? reg_smem_bytes(rp, warps)
                           : shm_smem_bytes(rp, warps);
  if ((long long)smem != smem_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long per_block =
      (long long)warps * (regs ? 32 / pow2ceil(rp / 2) : 1);
  const long long blocks = (n + per_block - 1) / per_block;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* Af = static_cast<const float*>(A);
  const float* bf = static_cast<const float*>(b);
  float* xf = static_cast<float*>(x);
  const int threads = warps * 32;
  switch (rp) {
    case 16:
      err = launch(chol_solve_regs<16>, threads, smem, blocks, s, Af, bf, xf,
                   n, r, jitter, vec16);
      break;
    case 32:
      err = launch(chol_solve_regs<32>, threads, smem, blocks, s, Af, bf, xf,
                   n, r, jitter, vec16);
      break;
    case 48:
      err = launch(chol_solve_regs<48>, threads, smem, blocks, s, Af, bf, xf,
                   n, r, jitter, vec16);
      break;
    case 64:
      err = launch(chol_solve_regs<64>, threads, smem, blocks, s, Af, bf, xf,
                   n, r, jitter, vec16);
      break;
    case 96:
      err = launch(chol_solve_smem<96>, threads, smem, blocks, s, Af, bf, xf,
                   n, r, jitter, vec16);
      break;
    case 128:
      err = launch(chol_solve_smem<128>, threads, smem, blocks, s, Af, bf, xf,
                   n, r, jitter, vec16);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
