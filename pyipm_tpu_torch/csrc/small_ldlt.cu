// Batched small LDL^T factorization and solve for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package's small-system
// path, pyipm_tpu/ops/pallas_ldlt.py:
//   - ldlt_factor_kernel  <- _factor_kernel (pallas_ldlt.py:49-89) via
//     batched_ldlt_factor / ldlt_factor_small;
//   - ldlt_solve_kernel   <- _solve_kernel  (pallas_ldlt.py:92-126) via
//     batched_ldlt_solve / ldlt_solve_small.
// They compute the same thing in the JAX package's public layout: B
// independent row-major (n, n) matrices, not the TPU's lane-transposed
// (n, n, B) layout.
//
// What bounds them: at B = 10,000 and n = 36 the factorization reads A and
// writes L, about 104 MB, and does about 0.16 GFLOP.  Neither the H100's
// bandwidth nor its arithmetic is the limit: the bound is the n-step
// dependency chain inside each instance (every column step needs the
// previous step's trailing update).  The design answers that with
// parallelism across instances: one 128-thread block per instance (a few
// instances per block when n <= 16), 10,000 independent blocks over the
// 132 SMs, each keeping its whole matrix in shared memory for the n steps.
// The solve is two n-step substitution chains; one warp per instance runs
// them, reducing each row's dot product with warp shuffles.
//
// Numerics match the plain PyTorch versions (pyipm_tpu_torch/ops/
// small_ldlt.py) column for column: the same right-looking column order,
// the same zero-pivot guard (a zero pivot divides by 1), and the trailing
// update rounded as (l_i * l_k) * d_j then subtracted, with the _rn
// intrinsics so the compiler does not contract it into an FMA.
//
// Build: see pyipm_tpu_torch/ops/_build.py (one object per source, linked
// into one shared library with a plain C interface, loaded with ctypes).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarp = 32;
constexpr int kMaxN = 128;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fadd_rn(a, -b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dadd_rn(a, -b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// Right-looking unpivoted LDL^T of `ipb` instances per block.  Each
// instance's matrix lives in shared memory with row stride n + 1 (odd for
// even n, so a column walk hits distinct banks).  Only the lower triangle
// is read or updated: L and d depend on nothing else.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ldlt_factor_kernel(const T* __restrict__ A, T* __restrict__ L,
                   T* __restrict__ d, int B, int n, int ipb) {
  extern __shared__ unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int ld = n + 1;
  const int tpi = kThreads / ipb;              // threads per instance
  const int local = threadIdx.x / tpi;
  const int lt = threadIdx.x % tpi;
  const long long inst = (long long)blockIdx.x * ipb + local;
  const bool valid = inst < B;
  const long long nn = (long long)n * n;
  T* a = sm + (long long)local * n * ld;

  if (valid) {
    const T* src = A + inst * nn;
    for (int t = lt; t < n * n; t += tpi) a[(t / n) * ld + (t % n)] = src[t];
  }
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    if (valid) {
      // pivot and scaled column: l_ij = a_ij / d_j for i > j, stored in
      // place of a_ij
      const T dj = a[j * ld + j];
      const T safe = (fabs(dj) > T(0)) ? dj : T(1);
      for (int i = j + 1 + lt; i < n; i += tpi)
        a[i * ld + j] = div_rn(a[i * ld + j], safe);
    }
    __syncthreads();
    if (valid) {
      // trailing rank-1 update of the lower triangle:
      // a_rc -= (l_r * l_c) * d_j for j < c <= r
      const T dj = a[j * ld + j];
      const int m = n - j - 1;
      for (int t = lt; t < m * m; t += tpi) {
        const int r = j + 1 + t / m;
        const int c = j + 1 + t % m;
        if (c <= r)
          a[r * ld + c] = sub_rn(a[r * ld + c],
                                 mul_rn(mul_rn(a[r * ld + j], a[c * ld + j]),
                                        dj));
      }
    }
    __syncthreads();
  }

  if (valid) {
    T* dst = L + inst * nn;
    for (int t = lt; t < n * n; t += tpi) {
      const int r = t / n, c = t % n;
      dst[t] = (r > c) ? a[r * ld + c] : (r == c ? T(1) : T(0));
    }
    for (int t = lt; t < n; t += tpi) d[inst * n + t] = a[t * ld + t];
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// x = L^-T diag(d)^-1 L^-1 b, one warp per instance; the running vector
// lives in shared memory.  No block-level barrier is used, so a warp past
// the batch end may return early.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ldlt_solve_kernel(const T* __restrict__ L, const T* __restrict__ d,
                  const T* __restrict__ b, T* __restrict__ x, int B, int n) {
  extern __shared__ unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long inst = (long long)blockIdx.x * (kThreads / kWarp) + warp;
  if (inst >= B) return;
  T* y = sm + warp * n;
  const T* Li = L + inst * (long long)n * n;
  const T* bi = b + inst * n;
  const T* di = d + inst * n;

  // forward substitution: y_j = b_j - sum_{k<j} L_jk y_k
  for (int j = 0; j < n; ++j) {
    T acc = T(0);
    for (int k = lane; k < j; k += kWarp) acc += Li[j * n + k] * y[k];
    acc = warp_sum(acc);
    if (lane == 0) y[j] = bi[j] - acc;
    __syncwarp();
  }
  // zero-guarded diagonal scale
  for (int j = lane; j < n; j += kWarp) {
    const T dj = di[j];
    y[j] = y[j] / ((fabs(dj) > T(0)) ? dj : T(1));
  }
  __syncwarp();
  // backward substitution in place: x_j = z_j - sum_{k>j} L_kj x_k
  for (int j = n - 1; j >= 0; --j) {
    T acc = T(0);
    for (int k = j + 1 + lane; k < n; k += kWarp) acc += Li[k * n + j] * y[k];
    acc = warp_sum(acc);
    if (lane == 0) y[j] = y[j] - acc;
    __syncwarp();
  }
  T* xi = x + inst * n;
  for (int j = lane; j < n; j += kWarp) xi[j] = y[j];
}

template <typename T>
int launch_factor(const void* A, void* L, void* d, int B, int n,
                  void* stream) {
  if (B <= 0 || n <= 0 || n > kMaxN) return (int)cudaErrorInvalidValue;
  const int ipb = (n <= 16) ? 4 : 1;
  const size_t smem = (size_t)ipb * n * (n + 1) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      ldlt_factor_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + ipb - 1) / ipb;
  ldlt_factor_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(A), static_cast<T*>(L), static_cast<T*>(d), B, n,
      ipb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_solve(const void* L, const void* d, const void* b, void* x, int B,
                 int n, void* stream) {
  if (B <= 0 || n <= 0 || n > kMaxN) return (int)cudaErrorInvalidValue;
  const int per_block = kThreads / kWarp;
  const size_t smem = (size_t)per_block * n * sizeof(T);
  const int grid = (B + per_block - 1) / per_block;
  ldlt_solve_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(L), static_cast<const T*>(d),
      static_cast<const T*>(b), static_cast<T*>(x), B, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pyipm_ldlt_factor_f32(const void* A, void* L, void* d, int B, int n,
                          void* stream) {
  return launch_factor<float>(A, L, d, B, n, stream);
}

int pyipm_ldlt_factor_f64(const void* A, void* L, void* d, int B, int n,
                          void* stream) {
  return launch_factor<double>(A, L, d, B, n, stream);
}

int pyipm_ldlt_solve_f32(const void* L, const void* d, const void* b, void* x,
                         int B, int n, void* stream) {
  return launch_solve<float>(L, d, b, x, B, n, stream);
}

int pyipm_ldlt_solve_f64(const void* L, const void* d, const void* b, void* x,
                         int B, int n, void* stream) {
  return launch_solve<double>(L, d, b, x, B, n, stream);
}

const char* pyipm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
