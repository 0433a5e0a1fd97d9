// Batched Cholesky solve of small SPD systems for the ALS half-steps,
// written for Hopper (sm_90a), bound to PyTorch through a plain C
// interface (ctypes).
//
// Replaces both Pallas kernels that predictionio_tpu/ops/solve.py::
// _solve_spd_pallas (:152) launches: _chol_solve_kernel (:126, padded
// rank <= 88, pallas_call :184) and _chol_solve_kernel_inplace (:133,
// 88 < padded rank <= 128, pallas_call :212). They share _chol_body (:39)
// and differ only in how one 128-system block fits the TPU's VMEM, so one
// kernel covers both.
//
// What it computes, for each system i of a batch of f32 [r, r] SPD
// matrices (r <= 128):
//   M      = A[i] + jitter * I
//   M      = L L^T     in place, right-looking: pivot clamped as
//                      rsqrt(max(piv, 1e-30)), column k scaled by it, the
//                      trailing lower triangle updated by l l^T
//   L y    = b[i]      forward substitution, divisions by max(l_kk, 1e-30)
//   L^T x  = y         backward substitution, the same clamp
//   x[i]   = x
// The TPU kernel updates the whole trailing block; only its lower
// triangle is ever read, and that is what this kernel updates, with the
// same operations. The substitutions run right-looking (the TPU's
// backward sweep is left-looking), so sums go in another order.
//
// What bounds it: the bytes. One system moves (r*r + 2r) * 4 bytes
// (16.9 KB at r = 64) for about r^3/3 + 2r^2 operations (95 kFLOP):
// ~5.6 operations per byte, under the ~20 at which the 67 TFLOP/s f32
// peak would take over from 3.35 TB/s. At ML-20M width the 138,493 user
// systems at r = 64 move 2.3 GB: 0.70 ms at the memory rate.
//
// What the design does about it: one block per system, the matrix read
// from device memory once into shared memory (r x (r|1) floats: 16.6 KB
// at r = 64, 66 KB at r = 128, past the 48 KB default, so the launch
// raises the block's dynamic shared-memory limit) and never written back;
// only x leaves. round32(r) threads, thread j owning column j of the
// trailing update; the odd row stride keeps both column walks (L[i][k]
// over i) and row walks (L[k][i] over i) free of bank conflicts. Two
// barriers per column step. The 128-lane batch layout, the rank padding
// to a multiple of 8 and the batch padding to 128 are TPU layouts and
// are not carried over.
// Left for later: several systems per block (one warp each) so the
// barriers become warp syncs, and fusing this solve into the Gramian
// kernel so A never round-trips through device memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxRank = 128;

__host__ __device__ __forceinline__ int row_stride(int r) { return r | 1; }

__host__ __device__ __forceinline__ size_t smem_bytes(int r) {
  return ((size_t)r * row_stride(r) + 2 * (size_t)r) * sizeof(float);
}

__global__ void chol_solve_kernel(const float* __restrict__ A,
                                  const float* __restrict__ b,
                                  float* __restrict__ x, int r,
                                  float jitter) {
  extern __shared__ float smem[];
  const int ld = row_stride(r);
  float* M = smem;            // [r][ld], lower triangle used
  float* lvec = M + r * ld;   // [r] scaled column of the current step
  float* acc = lvec + r;      // [r] b -> y -> x

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t sys = blockIdx.x;
  const float* Ag = A + sys * (size_t)r * (size_t)r;

  for (int e = tid; e < r * r; e += nt) {
    const int i = e / r;
    const int j = e - i * r;
    float v = Ag[e];
    if (i == j) v += jitter;
    M[i * ld + j] = v;
  }
  for (int i = tid; i < r; i += nt) acc[i] = b[sys * r + i];
  __syncthreads();

  // factor: after step k, column k of M (rows >= k) is column k of L
  for (int k = 0; k < r; ++k) {
    const float inv = rsqrtf(fmaxf(M[k * ld + k], 1e-30f));
    for (int i = tid; i < r; i += nt) {
      lvec[i] = i >= k ? M[i * ld + k] * inv : 0.f;
    }
    __syncthreads();  // every thread has read the pivot and column k
    for (int j = tid; j < r; j += nt) {
      if (j >= k) M[j * ld + k] = lvec[j];
      if (j > k) {
        const float lj = lvec[j];
        for (int i = j; i < r; ++i) M[i * ld + j] -= lvec[i] * lj;
      }
    }
    __syncthreads();
  }

  // forward: L y = b
  for (int k = 0; k < r; ++k) {
    const float yk = acc[k] / fmaxf(M[k * ld + k], 1e-30f);
    __syncthreads();  // every thread has read acc[k]
    for (int i = tid; i < r; i += nt) {
      if (i == k) {
        acc[i] = yk;
      } else if (i > k) {
        acc[i] -= M[i * ld + k] * yk;
      }
    }
    __syncthreads();
  }

  // backward: L^T x = y, row k of L feeding the rows above it
  for (int k = r - 1; k >= 0; --k) {
    const float xk = acc[k] / fmaxf(M[k * ld + k], 1e-30f);
    __syncthreads();
    for (int i = tid; i < r; i += nt) {
      if (i == k) {
        acc[i] = xk;
      } else if (i < k) {
        acc[i] -= M[k * ld + i] * xk;
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < r; i += nt) x[sys * r + i] = acc[i];
}

}  // namespace

// C entry point: A [n, r, r] and b [n, r] f32 inputs (contiguous; A is
// read, never written), x [n, r] f32 output, r <= 128. Pointers and the
// stream are passed as addresses. Returns a cudaError_t.
extern "C" int chol_solve_f32(int device, const void* A, const void* b,
                              void* x, int n, int r, float jitter,
                              void* stream) {
  if (n < 0 || r < 1 || r > kMaxRank) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(r);
  err = cudaFuncSetAttribute(chol_solve_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = ((r + 31) / 32) * 32;
  chol_solve_kernel<<<n, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), static_cast<const float*>(b),
      static_cast<float*>(x), r, jitter);
  return static_cast<int>(cudaGetLastError());
}
