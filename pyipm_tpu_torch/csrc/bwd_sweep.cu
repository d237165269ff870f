// Backward superblock substitution L^T x = z for Hopper (sm_90a), from the
// inverses of the diagonal superblocks of a unit-lower factor.
//
// Replaces the Pallas TPU kernel _bwd_sweep_kernel (pyipm_tpu/ops/
// pallas_ldlt.py:386) via bwd_sweep_blocks (:452), which reads the
// superblock inverses invb (npad/w, w, w), w = group * 128 (1024 on the
// main path).  For k from the last block down to 0:
//     x_k = inv_k^T (z_k - Lp[(k+1)w:, kw:(k+1)w]^T x[(k+1)w:])
// Lp is the (npad, npad) row-major factor padded to the block grid and z
// the forward-substituted, diagonal-scaled right-hand side.  (The 128-wide
// panel form of the same recurrence is bwd_sweep_panels.cu, one launch
// chained by flags; at w = 1024 inv_k is 4 MB in f32 and fits no CTA, so
// that design does not carry over as it is.)
//
// What bounds it: each call reads the strictly-lower part of Lp once
// (~K^2/2 values) plus the inverses, so bytes, not operations (2 flops per
// value read), and at K = 4352 those bytes are ~38 MB + 21 MB (invb):
// ~18 us at 3.35 TB/s.  But the recurrence is a chain of npad/w dependent
// steps, so the design spreads each step over the card:
//   1. sweep_partial: the slab product Lp[(k+1)w:, kw:(k+1)w]^T x[(k+1)w:]
//      split over CTAs by row chunk (R rows) and column tile (128 columns),
//      one coalesced row read per warp group; each CTA writes its partial
//      sums to a scratch row, no atomics;
//   2. sweep_finish: each CTA sums the partials in a fixed order into
//      t = z_k - acc (in shared memory) and computes 32 entries of
//      inv_k^T t, its 8 warps splitting the rows and reducing in a fixed
//      order.
// The TPU kernel's in-kernel accumulator across grid steps (acc_ref) does
// not carry over: Hopper runs blocks in no order, so each step is two
// launches on the caller's stream.  Every sum runs in a fixed order, so a
// call gives the same bits on every run (the guarded refinements keep a
// step only if the residual falls, so run-to-run roundoff would change
// iteration counts).
//
// Build: see pyipm_tpu_torch/ops/_build.py.

#include <cuda_runtime.h>

namespace {

constexpr int kColTile = 128;      // columns per sweep_partial CTA
constexpr int kFinishCols = 32;    // columns per sweep_finish CTA
constexpr int kFinishGroups = 8;   // row groups per sweep_finish CTA
constexpr int kMaxW = 4096;

template <typename T>
__global__ void __launch_bounds__(kColTile)
sweep_partial_kernel(const T* __restrict__ Lp, const T* __restrict__ x,
                     T* __restrict__ partial, int npad, int r0, int c0,
                     int w, int R) {
  const int col = blockIdx.y * kColTile + threadIdx.x;
  if (col >= w) return;
  const int rb = r0 + blockIdx.x * R;
  const int re = min(rb + R, npad);
  const T* src = Lp + (long long)rb * npad + c0 + col;
  T acc = T(0);
#pragma unroll 8
  for (int r = rb; r < re; ++r) {
    acc += *src * x[r];
    src += npad;
  }
  partial[(long long)blockIdx.x * w + col] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kFinishCols * kFinishGroups)
sweep_finish_kernel(const T* __restrict__ partial, int nch,
                    const T* __restrict__ z, const T* __restrict__ inv,
                    T* __restrict__ x, int c0, int w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* t = reinterpret_cast<T*>(smem_raw);                  // (w,)
  __shared__ T red[kFinishGroups][kFinishCols];
  const int tid = threadIdx.x;
  for (int m = tid; m < w; m += blockDim.x) {
    T acc = T(0);
    for (int ch = 0; ch < nch; ++ch) acc += partial[(long long)ch * w + m];
    t[m] = z[c0 + m] - acc;
  }
  __syncthreads();
  const int lane = tid % kFinishCols;
  const int grp = tid / kFinishCols;
  const int i = blockIdx.x * kFinishCols + lane;
  T acc = T(0);
  if (i < w)
    for (int m = grp; m < w; m += kFinishGroups)
      acc += inv[(long long)m * w + i] * t[m];
  red[grp][lane] = acc;
  __syncthreads();
  if (grp == 0 && i < w) {
    T s = red[0][lane];
#pragma unroll
    for (int g = 1; g < kFinishGroups; ++g) s += red[g][lane];
    x[c0 + i] = s;
  }
}

template <typename T>
int launch_sweep(const void* Lp_, const void* z_, const void* inv_, void* x_,
                 void* partial_, int npad, int w, int R, void* stream_) {
  if (npad <= 0 || w <= 0 || w > kMaxW || npad % w || R <= 0)
    return (int)cudaErrorInvalidValue;
  const T* Lp = static_cast<const T*>(Lp_);
  const T* z = static_cast<const T*>(z_);
  const T* inv = static_cast<const T*>(inv_);
  T* x = static_cast<T*>(x_);
  T* partial = static_cast<T*>(partial_);
  cudaStream_t stream = (cudaStream_t)stream_;
  const int nsteps = npad / w;
  const dim3 finish_grid((w + kFinishCols - 1) / kFinishCols);
  const size_t finish_smem = (size_t)w * sizeof(T);
  for (int k = nsteps - 1; k >= 0; --k) {
    const int c0 = k * w;
    const int r0 = c0 + w;
    const int nch = (npad - r0 + R - 1) / R;
    if (nch > 0) {
      const dim3 grid(nch, (w + kColTile - 1) / kColTile);
      sweep_partial_kernel<T><<<grid, kColTile, 0, stream>>>(
          Lp, x, partial, npad, r0, c0, w, R);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    sweep_finish_kernel<T><<<finish_grid, kFinishCols * kFinishGroups,
                             finish_smem, stream>>>(
        partial, nch, z, inv + (long long)k * w * w, x, c0, w);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" {

int pyipm_bwd_sweep_f32(const void* Lp, const void* z, const void* inv,
                        void* x, void* partial, int npad, int w, int R,
                        void* stream) {
  return launch_sweep<float>(Lp, z, inv, x, partial, npad, w, R, stream);
}

int pyipm_bwd_sweep_f64(const void* Lp, const void* z, const void* inv,
                        void* x, void* partial, int npad, int w, int R,
                        void* stream) {
  return launch_sweep<double>(Lp, z, inv, x, partial, npad, w, R, stream);
}

}  // extern "C"
