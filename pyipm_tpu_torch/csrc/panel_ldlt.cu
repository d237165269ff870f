// LDL^T of one diagonal panel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _panel_kernel (pyipm_tpu/ops/pallas_ldlt.py:
// 198-227) reached through panel_ldlt (:230), which the blocked large-K
// factorization (pyipm_tpu/ops/linalg.py:ldlt_factor) calls once per
// 128-wide diagonal panel, and which the Schur solver's batched blocked
// factorization calls on the diagonal panels of all its blocks at once (the
// JAX package batches the Pallas kernel under vmap, linalg.py:1266).
// Input: a batch of row-major symmetric n x n matrices (n <= 128), one CTA
// per matrix (blockIdx.x); output: unit-lower L (zeros above the diagonal)
// and pivots d, per matrix.
//
// Numerics follow the Pallas panel kernel, not the lane kernel of
// small_ldlt.cu: at step j the column is l_i = a_ij / safe (safe = d_j, or 1
// at an exact zero pivot) and the trailing update is
//     a_ik -= (l_i * safe) * l_k
// rounded in that order, with the _rn intrinsics so the compiler cannot
// contract it into an FMA.  At a zero pivot the panel kernel therefore
// still subtracts l l^T, where the lane kernel subtracts 0.  Only the lower
// triangle is read for L and d.  Every entry sees the same operations in
// the same order as in the plain version (panel_ldlt_ref), so the two are
// bitwise equal.
//
// What bounds it: the panel is 64 KB in f32 and the factorization does
// ~n^3/3 = 0.7 MFLOP, so neither bytes nor operations: the bound is the
// n-step dependency chain (every column needs the previous step's update),
// one column update, a broadcast, a division and a hand-off per step.
//
// The design: one CTA of 16 warps keeps the lower triangle in registers,
// spread cyclically so that the shrinking trailing triangle stays balanced:
// warp w holds columns {w + 16 b, b < 8}, lane l rows {l + 32 s, s < 4},
// 32 entries a thread (column slots left of the trailing triangle, row
// slots above it and slot pairs wholly above the diagonal are skipped; the
// latter take no register).
// The input and the output pass once through shared memory (stride n + 1,
// conflict-free), so the global accesses coalesce.  Only the step's vectors
// l and l * safe go through shared memory, in a ring of 32 buffers, each
// with an mbarrier that the 32 lanes of its writer complete: the warp that
// owns column j+1 waits for step j, applies it to that column, broadcasts
// d_{j+1} by shuffle, divides the column, publishes step j+1 and only then
// updates its other columns.  No CTA-wide barrier in the loop: each warp
// waits only for the vectors it reads.
//
// On an H100 (PERF.md) that is ~0.25 us per step at n = 128, f32, about 3x
// faster than the panel in shared memory with two CTA barriers per step,
// but short of the ~0.1 us that one step's latencies add up to: the two
// operations of each update (no FMA, for the bitwise equality) and the
// per-step overhead of 16 warps keep the owner's partition of the SM busy
// while it walks the chain.
//
// A batch of panels (the Schur solver's diagonal panels of all its blocks,
// (256, 128, 128) on its large-block path) runs one CTA a panel.  Built as
// above, one CTA fills an SM (up to 128 registers for 512 threads), so 256
// panels on 132 SMs took two waves, 2.1x one panel.  Its shared memory
// (98.3 KB in f32) fits twice in an SM, so the kernel is a template on its
// warps W and on the CTAs an SM it is built for: a batch of more panels than
// SMs takes W = 8, two CTAs an SM (64 entries a thread, 105 registers), one
// wave; fewer take the 16 warps above, alone on their SM.  With 8 warps a
// warp owns one column in 8 and falls at most 9 steps behind, so the ring
// of 32 buffers still suffices.  A 16-warp build for two CTAs an SM (64
// registers) measured slower: two 16-warp chains share the SM's issue.
// f64 keeps one CTA an SM (its tile and ring take 193 KB).
//
// Build: see pyipm_tpu_torch/ops/_build.py (one object per source, linked
// into one shared library with a plain C interface).

#include <cuda_runtime.h>

#include <atomic>

#include "mbarrier.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kMaxPanel = 128;
constexpr int kRowSlots = kMaxPanel / kWarp;      // 4 rows per lane
constexpr int kBufs = 32;                         // ring of step vectors
constexpr int kVecs = kBufs * 2 * kMaxPanel;      // each (l, l * safe)

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fadd_rn(a, -b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dadd_rn(a, -b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// A pair of row slot s and column slot b that can reach the lower
// triangle (the others are wholly above the diagonal): known at compile
// time, so the registers of the other pairs are never touched and take no
// register.
template <int W>
__host__ __device__ constexpr bool live_pair(int s, int b) {
  return W * b < kWarp * (s + 1);
}

// A thread's entries of a CTA of W warps: row slot s, column slot b.
template <typename T, int W>
using Slots = T[kRowSlots][kMaxPanel / W];

// One step's update of this thread's entries of column slot b, row slots
// s0.. (the ones below are wholly above the trailing triangle):
// a_rc -= (l_r * safe) * l_c.  Row slot s holds rows < 32 s + 32, column
// slot b columns >= W b, so for W b >= 32 (s + 1) the pair is wholly above
// the diagonal and is skipped; the entries above the diagonal or past n
// that remain get harmless updates that are never read.
template <int W, typename T>
__device__ __forceinline__ void update_column(Slots<T, W>& a, int b, int s0,
                                              T lc,
                                              const T (&ls)[kRowSlots]) {
#pragma unroll
  for (int s = s0; s < kRowSlots; ++s)
    if (live_pair<W>(s, b)) a[s][b] = sub_rn(a[s][b], mul_rn(ls[s], lc));
}

// A step's vectors in one buffer: l_c of column c at [c], l_r * safe of
// row r at [kMaxPanel + r].
template <typename T>
__device__ __forceinline__ void load_lsaf(const T* v, int s0, int lane,
                                          T (&ls)[kRowSlots]) {
#pragma unroll
  for (int s = s0; s < kRowSlots; ++s)
    ls[s] = v[kMaxPanel + lane + kWarp * s];
}

// The step with vectors v (and this thread's l * safe, ls) applied to this
// warp's columns c > cmin (all in column slot b0 and above, cmin >= W b0
// - 1).
template <int W, typename T>
__device__ __forceinline__ void update_step(Slots<T, W>& a, const T* v,
                                            const T (&ls)[kRowSlots], int b0,
                                            int s0, int warp, int cmin) {
  if (warp + W * b0 > cmin)
    update_column<W>(a, b0, s0, v[warp + W * b0], ls);
#pragma unroll
  for (int b = b0 + 1; b < kMaxPanel / W; ++b)
    update_column<W>(a, b, s0, v[warp + W * b], ls);
}

// Pivot column c, held in column slot b and with its diagonal in row slot
// sd of the calling warp: broadcast d_c, divide the rows below it and
// write the step's vectors (0 off the column) into buffer v.  b and sd
// must be known at compile time (unrolled loop indices), or the register
// array goes to local memory.
template <int W, typename T>
__device__ __forceinline__ void pivot_column(Slots<T, W>& a, int b, int sd,
                                             int c, int n, int lane, T* v) {
  const T dc = __shfl_sync(0xffffffffu, a[sd][b], c % kWarp);
  const T safe = (fabs(dc) > T(0)) ? dc : T(1);
#pragma unroll
  for (int s = sd; s < kRowSlots; ++s) {
    const int r = lane + kWarp * s;
    const bool below = r > c && r < n;
    const T q = div_rn(below ? a[s][b] : safe, safe);
    if (below) a[s][b] = q;
    const T l = below ? q : T(0);
    v[r] = l;
    v[kMaxPanel + r] = mul_rn(l, safe);
  }
}

template <typename T, int W, int kPerSm>
__global__ void __launch_bounds__(W * kWarp, kPerSm)
panel_ldlt_kernel(const T* __restrict__ A, T* __restrict__ L,
                  T* __restrict__ d, int n) {
  // this CTA's panel of the batch
  A += (size_t)blockIdx.x * n * n;
  L += (size_t)blockIdx.x * n * n;
  d += (size_t)blockIdx.x * n;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* bars = reinterpret_cast<unsigned long long*>(smem_raw);  // (32,)
  T* vec = reinterpret_cast<T*>(smem_raw + kBufs * sizeof(*bars));
  T* s = vec + kVecs;                      // (n, n + 1): A in, L and d out
  constexpr int kColSlots = kMaxPanel / W;
  constexpr int kThreads = W * kWarp;
  const int ld = n + 1;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;

  if (tid < kBufs) mbar_init(bars + tid, kWarp);
  for (int r = warp; r < n; r += W)
    for (int c = lane; c < n; c += kWarp) s[r * ld + c] = A[r * n + c];
  for (int t = tid; t < kVecs; t += kThreads) vec[t] = T(0);
  __syncthreads();

  Slots<T, W> a;
#pragma unroll
  for (int sl = 0; sl < kRowSlots; ++sl)
#pragma unroll
    for (int b = 0; b < kColSlots; ++b) {
      const int r = lane + kWarp * sl, c = warp + W * b;
      if (live_pair<W>(sl, b)) a[sl][b] = (r < n && c < n) ? s[r * ld + c] : T(0);
    }

  // Pass nx pivots column nx = W b0 + w0, held by warp w0 in column slot
  // b0, its diagonal in row slot s0 = W b0 / 32.  Every warp waits for the
  // vectors of step nx - 1 (buffer (nx - 1) % 32); the owner applies them
  // to column nx, pivots, publishes step nx and only then updates its other
  // columns, so its path from one step's vectors to the next is one
  // column's update and the pivot.  No CTA barrier: a warp waits only for
  // the vectors it reads, and none falls more than W + 1 steps behind (it
  // owns one pass in W), so a ring of 32 buffers is never overwritten
  // while read.  Columns of slots below b0 and rows of row slots below s0
  // are done, so b0, an unrolled index, bounds every loop
  // statically and every register index is static.
#pragma unroll
  for (int b0 = 0; b0 < kColSlots; ++b0) {
    const int s0 = W * b0 / kWarp;      // row slot of the diagonal
    for (int w0 = 0; w0 < W; ++w0) {
      const int nx = W * b0 + w0;
      if (nx >= n) break;
      const int j = nx - 1;                          // the step applied
      const T* cur = vec + (j & (kBufs - 1)) * 2 * kMaxPanel;
      T ls[kRowSlots];
      if (nx > 0) {
        mbar_wait(bars + (j & (kBufs - 1)), (j / kBufs) & 1);
        load_lsaf(cur, s0, lane, ls);
      }
      if (warp == w0) {
        if (nx > 0) update_column<W>(a, b0, s0, cur[nx], ls);
        pivot_column<W>(a, b0, s0, nx, n, lane,
                     vec + (nx & (kBufs - 1)) * 2 * kMaxPanel);
        mbar_arrive(bars + (nx & (kBufs - 1)));
      }
      if (nx > 0) update_step<W>(a, cur, ls, b0, s0, warp, nx);
    }
  }
  __syncthreads();

  // lower triangle (L below, d on the diagonal) back through shared memory
#pragma unroll
  for (int sl = 0; sl < kRowSlots; ++sl)
#pragma unroll
    for (int b = 0; b < kColSlots; ++b) {
      const int r = lane + kWarp * sl, c = warp + W * b;
      if (live_pair<W>(sl, b) && r < n && c <= r) s[r * ld + c] = a[sl][b];
    }
  __syncthreads();
  for (int r = warp; r < n; r += W)
    for (int c = lane; c < n; c += kWarp)
      L[r * n + c] = (r > c) ? s[r * ld + c] : (r == c ? T(1) : T(0));
  for (int t = tid; t < n; t += kThreads) d[t] = s[t * ld + t];
}

template <typename T>
constexpr size_t panel_smem(int n) {
  return kBufs * sizeof(unsigned long long) +
         ((size_t)n * (n + 1) + kVecs) * sizeof(T);
}

// The shared-memory opt-in belongs to the function on one device.  It is set
// once per device, type and variant, to the largest panel's size (and, for
// two panels an SM, the SM's split of L1 and shared memory to the most
// shared memory), so that the launches of a factorization (one per panel
// step) make no driver call of their own.
constexpr int kMaxDevices = 64;

template <typename T, int W, int kPerSm>
cudaError_t opt_in_smem() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(panel_ldlt_kernel<T, W, kPerSm>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)panel_smem<T>(kMaxPanel));
  if (err == cudaSuccess && kPerSm > 1)
    err = cudaFuncSetAttribute(panel_ldlt_kernel<T, W, kPerSm>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_release);
  return err;
}

template <typename T, int W, int kPerSm>
int launch_as(const void* A, void* L, void* d, int n, int batch,
              void* stream) {
  cudaError_t err = opt_in_smem<T, W, kPerSm>();
  if (err != cudaSuccess) return (int)err;
  panel_ldlt_kernel<T, W, kPerSm><<<batch, W * kWarp, panel_smem<T>(n),
                                    (cudaStream_t)stream>>>(
      static_cast<const T*>(A), static_cast<T*>(L), static_cast<T*>(d), n);
  return (int)cudaGetLastError();
}

template <typename T, int W, int kPerSm>
int residency_as(int* out) {
  cudaError_t err = opt_in_smem<T, W, kPerSm>();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, panel_ldlt_kernel<T, W, kPerSm>, W * kWarp,
      panel_smem<T>(kMaxPanel));
}

// The variants by `per_sm`: 1, one panel an SM (16 warps, up to 128
// registers a thread); 2, two panels an SM (8 warps, 128 registers), f32
// only: f64's tile and ring do not fit twice in an SM's shared memory.
template <typename T>
int launch_panel(const void* A, void* L, void* d, int n, int batch,
                 int per_sm, void* stream) {
  if (n <= 0 || n > kMaxPanel || batch <= 0)
    return (int)cudaErrorInvalidValue;
  if (per_sm == 1) return launch_as<T, 16, 1>(A, L, d, n, batch, stream);
  if constexpr (sizeof(T) == 4)
    if (per_sm == 2) return launch_as<T, 8, 2>(A, L, d, n, batch, stream);
  return (int)cudaErrorInvalidValue;
}

// The variant's CTAs resident an SM at n = 128 (the occupancy calculator's
// answer, attributes set), into out[0].
template <typename T>
int panel_residency(int per_sm, int* out) {
  if (per_sm == 1) return residency_as<T, 16, 1>(out);
  if constexpr (sizeof(T) == 4)
    if (per_sm == 2) return residency_as<T, 8, 2>(out);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int pyipm_panel_ldlt_f32(const void* A, void* L, void* d, int n, int batch,
                         int per_sm, void* stream) {
  return launch_panel<float>(A, L, d, n, batch, per_sm, stream);
}

int pyipm_panel_ldlt_f64(const void* A, void* L, void* d, int n, int batch,
                         int per_sm, void* stream) {
  return launch_panel<double>(A, L, d, n, batch, per_sm, stream);
}

int pyipm_panel_ldlt_residency_f32(int per_sm, int* out) {
  return panel_residency<float>(per_sm, out);
}

int pyipm_panel_ldlt_residency_f64(int per_sm, int* out) {
  return panel_residency<double>(per_sm, out);
}

}  // extern "C"
