// Batched small LDL^T factorization and solve for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package's small-system
// path, pyipm_tpu/ops/pallas_ldlt.py:
//   - ldlt_factor_kernel  <- _factor_kernel (pallas_ldlt.py:49-89) via
//     batched_ldlt_factor / ldlt_factor_small;
//   - ldlt_solve_kernel   <- _solve_kernel  (pallas_ldlt.py:92-126, called
//     at :178) via batched_ldlt_solve / ldlt_solve_small.
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
//
// The solve moves B (n^2 + 3n) values for 2 n^2 flops each instance, so its
// bound is bytes (12.2 MB, 3.6 us at B = 10,000, n = 16, f32), and what
// stands in the way is again the chain: two substitutions of n dependent
// steps.  Its design: a CTA first stages the factors of all its instances
// (contiguous in memory) into shared memory with 16-byte loads, every load
// in flight before any chain starts; then a warp runs one instance (two at
// n <= 16, in half-warps) COLUMN-oriented: lane i owns entry i of the
// running vector (entries i, i + 32, .. above n = 32), and step j is one
// shuffle that broadcasts entry j and one fused multiply-subtract in every
// lane still to be updated, with L_ij read from the padded shared tile (a
// column read in the forward pass, a row read in the backward pass, both
// free of bank conflicts).  No reduction, no barrier, no global load inside
// the chain.  An optional row scale is folded in: x = s * solve(s * b).
//
// Numerics.  The factorization matches its plain PyTorch version
// (pyipm_tpu_torch/ops/small_ldlt.py) column for column: the same
// right-looking column order, the same zero-pivot guard (a zero pivot
// divides by 1), and the trailing update rounded as (l_i * l_k) * d_j then
// subtracted, with the _rn intrinsics so the compiler does not contract it
// into an FMA.  The solve subtracts its products one by one in step order
// (one FMA each) where the plain version sums a row and subtracts once, so
// the two differ by roundoff; every order is fixed, so a call is bitwise
// repeatable, and the two scale products are rounded on their own.
//
// Build: see pyipm_tpu_torch/ops/_build.py (one object per source, linked
// into one shared library with a plain C interface, loaded with ctypes).

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstdint>

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

__device__ __forceinline__ float fnma(float a, float b, float c) {
  return fmaf(-a, b, c);
}
__device__ __forceinline__ double fnma(double a, double b, double c) {
  return fma(-a, b, c);
}

template <typename T> struct Word16;
template <> struct Word16<float> { using type = float4; };
template <> struct Word16<double> { using type = double2; };

// x = s * (L^-T diag(d)^-1 L^-1 (s * b)), s = 1 without `scale`.  W lanes
// (16 or 32) run one instance, lane l owning entries l + 32 u, u < NT
// (NT = 1 at W = 16).  The CTA's instances are consecutive, so their
// factors are one contiguous run of L, staged into tiles of row stride
// ld = n | 1 (odd: lanes walking a column hit distinct banks).  Only
// shuffles order the chain, and every lane of a warp takes part in them,
// so lanes past the batch end run along on zeros and skip the loads and
// the store.
template <typename T, int NT, int W>
__global__ void __launch_bounds__(kThreads)
ldlt_solve_kernel(const T* __restrict__ L, const T* __restrict__ d,
                  const T* __restrict__ b, const T* __restrict__ scale,
                  T* __restrict__ x, int B, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  using Word = typename Word16<T>::type;
  constexpr int V = sizeof(Word) / sizeof(T);
  const int ld = n | 1;
  const int nn = n * n;
  const int ipb = (blockDim.x / kWarp) * (kWarp / W);
  const long long first = (long long)blockIdx.x * ipb;
  const int count = (int)min((long long)ipb, (long long)B - first);
  const int total = count * nn;
  const T* src = L + first * nn;

  // stage: flat entry e of the run is entry (r, c) of local instance li.
  // The run starts wherever this CTA's first instance lies, so a scalar
  // head brings it to the next 16-byte boundary, 16-byte words follow, and
  // a scalar tail ends it.
  const int head = min(
      total, (int)((16 - reinterpret_cast<uintptr_t>(src) % 16) % 16 /
                   sizeof(T)));
  const int nvec = (total - head) / V;
  const Word* words = reinterpret_cast<const Word*>(src + head);
  for (int q = threadIdx.x; q < nvec; q += blockDim.x) {
    const Word word = __ldg(words + q);
    const T* v = reinterpret_cast<const T*>(&word);
    const int e = head + q * V;
    int li = e / nn;
    int r = (e - li * nn) / n;
    int c = e - li * nn - r * n;
#pragma unroll
    for (int u = 0; u < V; ++u) {
      sm[(li * n + r) * ld + c] = v[u];
      if (++c == n) {
        c = 0;
        if (++r == n) { r = 0; ++li; }
      }
    }
  }
  // head entries [0, head) and tail entries [head + nvec V, total)
  const int body = nvec * V;
  for (int s = threadIdx.x; s < total - body; s += blockDim.x) {
    const int e = s < head ? s : s + body;
    const int li = e / nn;
    const int r = (e - li * nn) / n;
    sm[(li * n + r) * ld + (e - li * nn - r * n)] = src[e];
  }
  __syncthreads();

  const int lane = threadIdx.x % kWarp;
  const int sl = lane % W;
  const int li = (threadIdx.x / kWarp) * (kWarp / W) + lane / W;
  const bool valid = li < count;
  const long long row = (first + li) * n;
  const T* tile = sm + li * n * ld;

  T y[NT], sc[NT];
#pragma unroll
  for (int u = 0; u < NT; ++u) {
    const int i = sl + kWarp * u;
    const bool in = valid && i < n;
    sc[u] = (scale && in) ? scale[row + i] : T(1);
    y[u] = in ? b[row + i] : T(0);
    if (scale) y[u] = mul_rn(sc[u], y[u]);
  }

  // forward: after steps 0 .. j-1 entry j is final; broadcast it and
  // subtract L_ij y_j from every later entry i
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int steps = min(W, n - kWarp * t);
#pragma unroll 4
    for (int jj = 0; jj < steps; ++jj) {
      const int j = kWarp * t + jj;
      const T yj = __shfl_sync(0xffffffffu, y[t], jj, W);
#pragma unroll
      for (int u = t; u < NT; ++u) {
        const int i = sl + kWarp * u;
        if (i > j && i < n) y[u] = fnma(tile[i * ld + j], yj, y[u]);
      }
    }
  }
  // zero-guarded diagonal scale
#pragma unroll
  for (int u = 0; u < NT; ++u) {
    const int i = sl + kWarp * u;
    if (valid && i < n) {
      const T di = d[row + i];
      y[u] = y[u] / ((fabs(di) > T(0)) ? di : T(1));
    }
  }
  // backward: entry j is final once steps n-1 .. j+1 are done; broadcast it
  // and subtract L_ji x_j from every earlier entry i
#pragma unroll
  for (int t = NT - 1; t >= 0; --t) {
    const int steps = min(W, n - kWarp * t);
#pragma unroll 4
    for (int jj = steps - 1; jj >= 0; --jj) {
      const int j = kWarp * t + jj;
      const T xj = __shfl_sync(0xffffffffu, y[t], jj, W);
#pragma unroll
      for (int u = 0; u <= t; ++u) {
        const int i = sl + kWarp * u;
        if (i < j) y[u] = fnma(tile[j * ld + i], xj, y[u]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < NT; ++u) {
    const int i = sl + kWarp * u;
    if (valid && i < n) x[row + i] = scale ? mul_rn(sc[u], y[u]) : y[u];
  }
}

// The opt-in to more than 48 KB of dynamic shared memory belongs to a
// kernel on one device: set once per device (`done`, one static array per
// kernel instantiation) to `bytes`, the most the kernel ever asks for.
constexpr int kMaxDevices = 64;
constexpr size_t kOptInAbove = 48 * 1024;

template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, std::atomic<bool>* done, size_t bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_release);
  return err;
}

template <typename T>
int launch_factor(const void* A, void* L, void* d, int B, int n,
                  void* stream) {
  if (B <= 0 || n <= 0 || n > kMaxN) return (int)cudaErrorInvalidValue;
  const int ipb = (n <= 16) ? 4 : 1;
  const size_t smem = (size_t)ipb * n * (n + 1) * sizeof(T);
  if (smem > kOptInAbove) {
    static std::atomic<bool> done[kMaxDevices];
    cudaError_t err = opt_in_smem(ldlt_factor_kernel<T>, done,
                                  (size_t)kMaxN * (kMaxN + 1) * sizeof(T));
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (B + ipb - 1) / ipb;
  ldlt_factor_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(A), static_cast<T*>(L), static_cast<T*>(d), B, n,
      ipb);
  return (int)cudaGetLastError();
}

// Shared memory a solve CTA may take so that several fit on an SM; a tile
// larger than this gets a CTA (of one warp) to itself.
constexpr size_t kSolveSmem = 72 * 1024;

template <typename T, int NT, int W>
int launch_solve_as(const T* L, const T* d, const T* b, const T* scale, T* x,
                    int B, int n, cudaStream_t stream) {
  const size_t tile = (size_t)n * (n | 1) * sizeof(T);
  const int per_warp = kWarp / W;
  int warps = kThreads / kWarp;
  while (warps > 1 && warps * per_warp * tile > kSolveSmem) warps /= 2;
  const int ipb = warps * per_warp;
  const size_t smem = ipb * tile;
  if (smem > kOptInAbove) {
    static std::atomic<bool> done[kMaxDevices];
    cudaError_t err = opt_in_smem(
        ldlt_solve_kernel<T, NT, W>, done,
        std::max(kSolveSmem, (size_t)kMaxN * (kMaxN | 1) * sizeof(T)));
    if (err != cudaSuccess) return (int)err;
  }
  ldlt_solve_kernel<T, NT, W><<<(B + ipb - 1) / ipb, warps * kWarp, smem,
                                stream>>>(L, d, b, scale, x, B, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_solve(const void* L_, const void* d_, const void* b_,
                 const void* scale_, void* x_, int B, int n, void* stream_) {
  if (B <= 0 || n <= 0 || n > kMaxN) return (int)cudaErrorInvalidValue;
  const T* L = static_cast<const T*>(L_);
  const T* d = static_cast<const T*>(d_);
  const T* b = static_cast<const T*>(b_);
  const T* scale = static_cast<const T*>(scale_);
  T* x = static_cast<T*>(x_);
  cudaStream_t stream = (cudaStream_t)stream_;
#define PYIPM_SOLVE_AS(NT, W) \
  launch_solve_as<T, NT, W>(L, d, b, scale, x, B, n, stream)
  if (n <= 16) return PYIPM_SOLVE_AS(1, 16);
  if (n <= 32) return PYIPM_SOLVE_AS(1, 32);
  if (n <= 64) return PYIPM_SOLVE_AS(2, 32);
  if (n <= 96) return PYIPM_SOLVE_AS(3, 32);
  return PYIPM_SOLVE_AS(4, 32);
#undef PYIPM_SOLVE_AS
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

// `scale` may be null: no row scale.
int pyipm_ldlt_solve_f32(const void* L, const void* d, const void* b,
                         const void* scale, void* x, int B, int n,
                         void* stream) {
  return launch_solve<float>(L, d, b, scale, x, B, n, stream);
}

int pyipm_ldlt_solve_f64(const void* L, const void* d, const void* b,
                         const void* scale, void* x, int B, int n,
                         void* stream) {
  return launch_solve<double>(L, d, b, scale, x, B, n, stream);
}

const char* pyipm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
