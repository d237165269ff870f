// LDL^T of one diagonal panel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _panel_kernel (pyipm_tpu/ops/pallas_ldlt.py:
// 198-227) reached through panel_ldlt (:230), which the blocked large-K
// factorization (pyipm_tpu/ops/linalg.py:ldlt_factor) calls once per
// 128-wide diagonal panel.  Input: one row-major symmetric n x n matrix
// (n <= 128); output: unit-lower L (zeros above the diagonal) and pivots d.
//
// Numerics follow the Pallas panel kernel, not the lane kernel of
// small_ldlt.cu: at step j the column is l_i = a_ij / safe (safe = d_j, or 1
// at an exact zero pivot) and the trailing update is
//     a_ik -= (l_i * safe) * l_k
// rounded in that order, with the _rn intrinsics so the compiler cannot
// contract it into an FMA.  At a zero pivot the panel kernel therefore
// still subtracts l l^T, where the lane kernel subtracts 0.  Only the lower
// triangle is read or updated: L and d depend on nothing else.
//
// What bounds it: the panel is 64 KB in f32 and the factorization does
// ~n^3/3 = 0.7 MFLOP, so neither bytes nor operations matter; the bound is
// the n-step dependency chain (every column needs the previous step's
// update).  The design: one CTA holds the whole panel in shared memory
// (stride n + 1, so a column walk hits distinct banks; 66 KB in f32, 132 KB
// in f64, above the 48 KB default, hence the opt-in attribute) and all its
// threads split each step's division and trailing update, two barriers per
// step.  The trailing update walks rows by warp and columns by lane, so the
// strict upper triangle costs nothing.
//
// Build: see pyipm_tpu_torch/ops/_build.py (one object per source, linked
// into one shared library with a plain C interface).

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kPanelThreads = 512;
constexpr int kWarp = 32;
constexpr int kMaxPanel = 128;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fadd_rn(a, -b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dadd_rn(a, -b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(kPanelThreads)
panel_ldlt_kernel(const T* __restrict__ A, T* __restrict__ L,
                  T* __restrict__ d, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* a = reinterpret_cast<T*>(smem_raw);
  const int ld = n + 1;
  T* lcol = a + n * ld;     // l_i of the current step
  T* lsaf = lcol + n;       // l_i * safe of the current step
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  const int nwarps = nt / kWarp;

  for (int t = tid; t < n * n; t += nt) a[(t / n) * ld + (t % n)] = A[t];
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    const T dj = a[j * ld + j];
    const T safe = (fabs(dj) > T(0)) ? dj : T(1);
    for (int i = j + 1 + tid; i < n; i += nt) {
      const T l = div_rn(a[i * ld + j], safe);
      a[i * ld + j] = l;
      lcol[i] = l;
      lsaf[i] = mul_rn(l, safe);
    }
    __syncthreads();
    // a_rc -= (l_r * safe) * l_c for j < c <= r
    for (int r = j + 1 + warp; r < n; r += nwarps) {
      const T lr = lsaf[r];
      for (int c = j + 1 + lane; c <= r; c += kWarp)
        a[r * ld + c] = sub_rn(a[r * ld + c], mul_rn(lr, lcol[c]));
    }
    __syncthreads();
  }

  for (int t = tid; t < n * n; t += nt) {
    const int r = t / n, c = t % n;
    L[t] = (r > c) ? a[r * ld + c] : (r == c ? T(1) : T(0));
  }
  for (int t = tid; t < n; t += nt) d[t] = a[t * ld + t];
}

template <typename T>
constexpr size_t panel_smem(int n) {
  return ((size_t)n * (n + 1) + 2 * (size_t)n) * sizeof(T);
}

// The shared-memory opt-in belongs to the function on one device.  It is set
// once per device and type, to the largest panel's size, so that the launches
// of a factorization (one per panel) make no driver call of their own.
constexpr int kMaxDevices = 64;

template <typename T>
cudaError_t opt_in_smem() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(panel_ldlt_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)panel_smem<T>(kMaxPanel));
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_release);
  return err;
}

template <typename T>
int launch_panel(const void* A, void* L, void* d, int n, void* stream) {
  if (n <= 0 || n > kMaxPanel) return (int)cudaErrorInvalidValue;
  cudaError_t err = opt_in_smem<T>();
  if (err != cudaSuccess) return (int)err;
  panel_ldlt_kernel<T><<<1, kPanelThreads, panel_smem<T>(n),
                         (cudaStream_t)stream>>>(
      static_cast<const T*>(A), static_cast<T*>(L), static_cast<T*>(d), n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pyipm_panel_ldlt_f32(const void* A, void* L, void* d, int n,
                         void* stream) {
  return launch_panel<float>(A, L, d, n, stream);
}

int pyipm_panel_ldlt_f64(const void* A, void* L, void* d, int n,
                         void* stream) {
  return launch_panel<double>(A, L, d, n, stream);
}

}  // extern "C"
