// Backward panel sweep L^T x = z for Hopper (sm_90a), in one launch.
//
// Replaces the Pallas TPU kernel _bwd_sweep_panels_kernel
// (pyipm_tpu/ops/pallas_ldlt.py:523-576, called at :630 through
// bwd_sweep_panels), whose oracle is _bwd_sweep_panels_xla
// (pyipm_tpu/ops/linalg.py:603-622).  For k from the last 128-block down to
// 0 it computes
//     x_k = invp_k^T (z_k - sum_{i>k} L_ik^T x_i),
//     L_ik = Lp[i*128:(i+1)*128, k*128:(k+1)*128],
// from the grid-padded factor Lp (npad, npad) row-major, the diagonal-
// scaled forward-substituted z (npad,) and the inverses of the 128-wide
// diagonal panels invp (npad/128, 128, 128).
//
// What bounds it: the call reads the strict lower triangle of Lp once
// (~38 MB at K = 4352 in f32, ~11 us at 3.35 TB/s) for 2 flops per value,
// so bytes, not operations.  But x_k needs x_{k+1}: the recurrence is a
// chain of npad/128 dependent steps, each too small to fill the card, so
// the time is the chain's latency unless the factor's bytes stream beside
// it.
//
// The design: one launch.  The CTA that owns block column k (one column per
// CTA while npad/128 CTAs fit on the card, else every gridDim.x-th column,
// highest first) walks i = nsteps-1 down to k+1 in that fixed order.  For
// each i it waits on ready[i] (acquire), reads the 128 values of x_i and
// accumulates L_ik^T x_i from registers; the tile L_ik itself (128 rows of
// 128 contiguous values, 16-byte loads) was fetched right after the
// previous tile, while the CTA waited, since it does not depend on x.
// Every tile of the strict lower triangle is read exactly once.  After i =
// k+1 the CTA reduces its 16 warps' partial sums in a fixed order into t =
// z_k - acc, forms x_k = invp_k^T t from invp_k (staged in shared memory
// before the first wait), writes x_k and, after a CTA barrier, sets ready[k]
// (release).
// So the critical path per step is one flag hop, the product with one
// prefetched tile and the 128 x 128 product with invp_k.
//
// Deterministic: every sum runs in a fixed order and no floating-point
// atomics are used (the guarded refinements keep a step only if the
// residual falls, so run-to-run roundoff would change iteration counts).
// No hang: a CTA only waits for columns above its own, and the kernel is
// launched cooperatively with at most as many CTAs as the card holds at
// once, so every producer is resident.  The wrapper passes zeroed flags.
//
// Build: see pyipm_tpu_torch/ops/_build.py.

#include <algorithm>

#include "sweep_common.cuh"

namespace {

using namespace sweep;

// The tile at block row i, block column k of Lp.
template <typename T>
__device__ __forceinline__ const T* tile_at(const T* Lp, long long npad, int i,
                                            int k) {
  return Lp + (long long)i * kW * npad + k * kW;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
sweep_panels_kernel(const T* __restrict__ Lp, const T* __restrict__ z,
                    const T* __restrict__ invp, T* __restrict__ x,
                    int* __restrict__ ready, int npad) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* inv_s = reinterpret_cast<T*>(smem_raw);    // invp_k (128, 128)
  T* red = inv_s + kW * kW;                     // partial rows (16, 128)
  T* t_s = red + kWarps * kW;                   // t = z_k - acc (128,)
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int col = lane * kCols;
  const int nsteps = npad / kW;

  for (int k = nsteps - 1 - (int)blockIdx.x; k >= 0; k -= gridDim.x) {
    const int c0 = k * kW;
    const T* inv_k = invp + (long long)k * kW * kW;
    for (int e = tid * kCols; e < kW * kW; e += kThreads * kCols) {
      T v[4];
      load4(inv_k + e, v);
      put4(inv_s + e, v);
    }
    const T zk = tid < kW ? z[c0 + tid] : T(0);

    T acc[kCols] = {};
    T tile[kRows][kCols];
    if (k + 1 < nsteps)
      load_tile(tile_at(Lp, npad, nsteps - 1, k), npad, warp, lane, tile);
    for (int i = nsteps - 1; i > k; --i) {
      wait_at_least(ready + i, 1);
      T xv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        xv[r] = __ldcg(x + i * kW + warp + r * kWarps);
      tile_product(tile, xv, acc);
      if (i - 1 > k)
        load_tile(tile_at(Lp, npad, i - 1, k), npad, warp, lane, tile);
    }

    // t = z_k - acc, the 16 warps' partials summed in warp order
    put4(red + warp * kW + col, acc);
    __syncthreads();
    if (tid < kW) t_s[tid] = zk - sum_warps(red, tid);
    __syncthreads();
    // x_k = invp_k^T t: the same layout over the rows of invp_k
    T p[kCols] = {};
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int m = warp + r * kWarps;
      T v[4];
      shared4(inv_s + m * kW + col, v);
      const T tm = t_s[m];
#pragma unroll
      for (int c = 0; c < kCols; ++c) p[c] += v[c] * tm;
    }
    put4(red + warp * kW + col, p);
    __syncthreads();
    if (tid < kW) __stcg(x + c0 + tid, sum_warps(red, tid));
    // the barrier orders the CTA's writes of x_k before thread 0's release,
    // which is cumulative: a consumer that acquires flag k sees all of x_k
    __syncthreads();
    if (tid == 0) {
      cuda::atomic_ref<int, cuda::thread_scope_device> f(ready[k]);
      f.store(1, cuda::std::memory_order_release);
    }
  }
}

template <typename T>
constexpr size_t sweep_smem() {
  return (size_t)(kW * kW + kWarps * kW + kW) * sizeof(T);
}

template <typename T>
int launch_sweep_panels(const void* Lp_, const void* z_, const void* invp_,
                        void* x_, void* ready_, int npad, void* stream) {
  if (npad <= 0 || npad % kW) return (int)cudaErrorInvalidValue;
  static std::atomic<int> cached[kMaxDevices];
  int ctas = 0;
  cudaError_t err = resident_ctas(sweep_panels_kernel<T>, cached,
                                  sweep_smem<T>(), &ctas);
  if (err != cudaSuccess) return (int)err;
  const T* Lp = static_cast<const T*>(Lp_);
  const T* z = static_cast<const T*>(z_);
  const T* invp = static_cast<const T*>(invp_);
  T* x = static_cast<T*>(x_);
  int* ready = static_cast<int*>(ready_);
  void* args[] = {&Lp, &z, &invp, &x, &ready, &npad};
  err = cudaLaunchCooperativeKernel(
      (const void*)sweep_panels_kernel<T>, dim3(std::min(npad / kW, ctas)),
      dim3(kThreads), args, sweep_smem<T>(), (cudaStream_t)stream);
  return (int)err;
}

}  // namespace

extern "C" {

int pyipm_bwd_sweep_panels_f32(const void* Lp, const void* z,
                               const void* invp, void* x, void* ready,
                               int npad, void* stream) {
  return launch_sweep_panels<float>(Lp, z, invp, x, ready, npad, stream);
}

int pyipm_bwd_sweep_panels_f64(const void* Lp, const void* z,
                               const void* invp, void* x, void* ready,
                               int npad, void* stream) {
  return launch_sweep_panels<double>(Lp, z, invp, x, ready, npad, stream);
}

}  // extern "C"
