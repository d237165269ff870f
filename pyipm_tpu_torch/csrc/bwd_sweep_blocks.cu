// Backward superblock substitution L^T x = z for Hopper (sm_90a), in one
// launch, from the inverses of the diagonal superblocks of a unit-lower
// factor.
//
// Replaces the Pallas TPU kernel _bwd_sweep_kernel (pyipm_tpu/ops/
// pallas_ldlt.py:386-504, called at :478 through bwd_sweep_blocks), whose
// oracle is _bwd_sweep_xla (pyipm_tpu/ops/linalg.py:579-600).  For k from the
// last superblock down to 0 it computes
//     x_k = inv_k^T (z_k - Lp[(k+1)w:, kw:(k+1)w]^T x[(k+1)w:])
// from the grid-padded factor Lp (npad, npad) row-major, the diagonal-scaled
// forward-substituted z (npad,) and the superblock inverses invb
// (npad/w, w, w), w a multiple of 128 (1024 on the main path); the wrapper
// refuses any other width.
//
// What bounds it: bytes.  A call reads the strict lower block triangle of Lp
// and the lower triangles of the inverses once, 2 flops per value: ~54 MB at
// npad 5120, w 1024 in f32, ~16 us at 3.35 TB/s.  But the recurrence is a
// chain of npad/w dependent steps, each of two products, so the time is the
// chain's latency unless the bytes stream beside it.
//
// The design: all work is cut into 128 x 128 tiles, each a product
// tile^T v of a tile held in the registers of one 512-thread CTA with a
// 128-vector v, and every tile's CTA fetches it BEFORE it waits for v, since
// neither Lp nor invb depends on x.  With g = w/128:
//   - inverse tiles I(k, r, c), r >= c (the g(g+1)/2 sub-blocks of inv_k on
//     and below the diagonal; those above are exact zeros and are skipped):
//     v = t_k[r] = z_k[r] - (the sum of the slab partials of column group
//     (k, r)), the product is one partial of x_k[c];
//   - slab tiles S(j, r, k, c), k < j: the sweep is right-looking, so as soon
//     as x_j[r] is complete (the sum of its g - r partials) its contribution
//     Lp[jw + 128 r.., kw + 128 c..]^T x_j[r] to EVERY earlier superblock k is
//     a product with contiguous rows of the factor.  Only k = j - 1 is needed
//     by the next step; the rest overlap the chain;
//   - x tiles X(k, c): sum the partials of x_k[c] and write x.
// Partials go to scratch rows, one writer each, and are summed by their
// reader in a fixed order: no floating-point atomics, so a call gives the
// same bits on every run (the guarded refinements keep a step only if the
// residual falls, so run-to-run roundoff would change iteration counts).
// Ordering is by integer counters in device memory (zeroed by the wrapper):
// a tile's CTA writes its partial, passes a CTA barrier and adds one to the
// counter of its target (release); a reader spins until the counter reaches
// the number of partials (acquire).
//
// Persistent CTAs in two groups, each CTA walking its tiles in list order:
//   - chain CTAs take the critical list, round robin: I(n-1, ..), then for
//     j = n-1 .. 1 the slab tiles S(j, .., j-1, ..) and I(j-1, ..), then the
//     X tiles.  One step's g^2 + g(g+1)/2 tiles (100 at g = 8) fit the chain
//     CTAs at one tile each, so its tile is in registers when v arrives and a
//     step costs two counter hops and two small products;
//   - stream CTAs take the other slab tiles, for j = n-1 .. 2 and k = j-2 ..
//     0, which have one to n-2 steps of slack.
// No hang: a tile waits only for tiles earlier in the order (step, then
// I before S), every CTA's list is sorted by it, and the cooperative launch
// keeps every CTA resident; a wait of seconds traps.
//
// Build: see pyipm_tpu_torch/ops/_build.py.

#include <algorithm>

#include "sweep_common.cuh"

namespace {

using namespace sweep;

constexpr int kGroups = kThreads / kW;          // row groups of a row sum: 4
constexpr int kMaxW = 4096;

// One tile of work: out = tile^T v (or out = v when there is no tile), with
// v = (zsrc ? zsrc - s : s), s = the sum of `nrows` scratch rows of 128
// spaced `stride` apart, read once `*wait >= nrows`.
template <typename T>
struct Tile {
  const T* origin;      // first entry of the tile, or nullptr (an X tile)
  long long ld;
  int* wait;
  const T* rows;
  int nrows;
  long long stride;
  const T* zsrc;
  T* out;
  int* done;            // counter to add one to, or nullptr
};

template <typename T>
struct Sweep {
  const T* Lp;
  const T* z;
  const T* invb;
  T* x;
  T* px;                // x partials   (n, g, g, 128): [k][r][c]
  T* pacc;              // slab partials (n, g, (n-1) g, 128): [k][c][slot]
  int* cnt_x;           // (n, g): partials of x_k[c] written
  int* cnt_acc;         // (n, g): slab partials of column group (k, c) written
  int npad, w, n, g;

  __device__ Tile<T> inverse(int k, int idx) const {
    int c = 0;
    while (idx >= g - c) { idx -= g - c; ++c; }
    const int r = c + idx;
    const int slots = (n - 1 - k) * g;
    Tile<T> t;
    t.origin = invb + (long long)k * w * w + (long long)r * kW * w + c * kW;
    t.ld = w;
    t.wait = cnt_acc + k * g + r;
    t.rows = pacc + (long long)(k * g + r) * (n - 1) * g * kW;
    t.nrows = slots;
    t.stride = kW;
    t.zsrc = z + (long long)k * w + r * kW;
    t.out = px + (long long)((k * g + r) * g + c) * kW;
    t.done = cnt_x + k * g + c;
    return t;
  }

  // v = x_j[r]: the partials px[j][r..g-1][r]
  __device__ void x_rows(Tile<T>& t, int j, int r) const {
    t.wait = cnt_x + j * g + r;
    t.rows = px + (long long)((j * g + r) * g + r) * kW;
    t.nrows = g - r;
    t.stride = (long long)g * kW;
    t.zsrc = nullptr;
  }

  __device__ Tile<T> slab(int j, int r, int k, int c) const {
    Tile<T> t;
    t.origin = Lp + ((long long)j * w + r * kW) * npad + (long long)k * w +
               c * kW;
    t.ld = npad;
    x_rows(t, j, r);
    const int slot = (n - 1 - j) * g + r;
    t.out = pacc + ((long long)(k * g + c) * (n - 1) * g + slot) * kW;
    t.done = cnt_acc + k * g + c;
    return t;
  }

  __device__ Tile<T> finish(int k, int c) const {
    Tile<T> t;
    t.origin = nullptr;
    t.ld = 0;
    x_rows(t, k, c);
    t.out = x + (long long)k * w + c * kW;
    t.done = nullptr;
    return t;
  }

  __device__ int critical_count() const {
    return g * (g + 1) / 2 + (n - 1) * (g * g + g * (g + 1) / 2) + n * g;
  }
  __device__ int stream_count() const {
    return g * g * ((n - 1) * (n - 2) / 2);
  }

  __device__ Tile<T> critical(int p) const {
    const int ntri = g * (g + 1) / 2, nsq = g * g;
    if (p < ntri) return inverse(n - 1, p);
    p -= ntri;
    const int round = p / (nsq + ntri);
    if (round < n - 1) {
      const int o = p - round * (nsq + ntri);
      const int k = n - 2 - round;
      if (o < nsq) return slab(k + 1, o / g, k, o % g);
      return inverse(k, o - nsq);
    }
    p -= (n - 1) * (nsq + ntri);
    return finish(n - 1 - p / g, p % g);
  }

  __device__ Tile<T> stream(int p) const {
    const int nsq = g * g;
    int j = n - 1;
    while (p >= (j - 1) * nsq) { p -= (j - 1) * nsq; --j; }
    const int k = j - 2 - p / nsq;
    const int o = p % nsq;
    return slab(j, o / g, k, o % g);
  }
};

template <typename T>
__device__ __forceinline__ void run_tile(const Tile<T>& t, T* red, T* v_s) {
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  T tile[kRows][kCols];
  if (t.origin) load_tile(t.origin, t.ld, warp, lane, tile);
  if (tid == 0) wait_at_least(t.wait, t.nrows);
  __syncthreads();

  // v: the scratch rows summed in a fixed order (4 groups of every 4th row,
  // then the groups pairwise)
  const int grp = tid / kW;
  const int col = tid % kW;
  T s = T(0);
  for (int r = grp; r < t.nrows; r += kGroups)
    s += __ldcg(t.rows + r * t.stride + col);
  red[tid] = s;
  __syncthreads();
  if (tid < kW) {
    const T tot = (red[tid] + red[kW + tid]) +
                  (red[2 * kW + tid] + red[3 * kW + tid]);
    const T v = t.zsrc ? t.zsrc[tid] - tot : tot;
    if (t.origin) v_s[tid] = v;
    else __stcg(t.out + tid, v);
  }
  // (red and v_s are next written after the next tile's first barrier)
  if (!t.origin) return;
  __syncthreads();

  T xv[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) xv[r] = v_s[warp + r * kWarps];
  T acc[kCols] = {};
  tile_product(tile, xv, acc);
  put4(red + warp * kW + lane * kCols, acc);
  __syncthreads();
  if (tid < kW) __stcg(t.out + tid, sum_warps(red, tid));
  // the barrier orders the CTA's writes before thread 0's release, which is
  // cumulative: a reader that acquires the counter sees the whole partial
  __syncthreads();
  if (tid == 0) {
    cuda::atomic_ref<int, cuda::thread_scope_device> f(*t.done);
    f.fetch_add(1, cuda::std::memory_order_release);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : 1)
sweep_blocks_kernel(Sweep<T> sw, int chain_ctas) {
  __shared__ __align__(16) T red[kWarps * kW];
  __shared__ T v_s[kW];
  const int cta = blockIdx.x;
  if (cta < chain_ctas) {
    const int count = sw.critical_count();
    for (int p = cta; p < count; p += chain_ctas)
      run_tile(sw.critical(p), red, v_s);
  } else {
    const int count = sw.stream_count();
    const int stream_ctas = gridDim.x - chain_ctas;
    for (int p = cta - chain_ctas; p < count; p += stream_ctas)
      run_tile(sw.stream(p), red, v_s);
  }
}

template <typename T>
int launch_sweep_blocks(const void* Lp, const void* z, const void* invb,
                        void* x, void* partials, void* counts, int npad,
                        int w, void* stream) {
  if (npad <= 0 || w <= 0 || w > kMaxW || w % kW || npad % w)
    return (int)cudaErrorInvalidValue;
  static std::atomic<int> cached[kMaxDevices];
  int ctas = 0;
  cudaError_t err = resident_ctas(sweep_blocks_kernel<T>, cached, 0, &ctas);
  if (err != cudaSuccess) return (int)err;
  Sweep<T> sw;
  sw.npad = npad;
  sw.w = w;
  sw.n = npad / w;
  sw.g = w / kW;
  sw.Lp = static_cast<const T*>(Lp);
  sw.z = static_cast<const T*>(z);
  sw.invb = static_cast<const T*>(invb);
  sw.x = static_cast<T*>(x);
  sw.px = static_cast<T*>(partials);
  sw.pacc = sw.px + (long long)sw.n * sw.g * sw.g * kW;
  sw.cnt_x = static_cast<int*>(counts);
  sw.cnt_acc = sw.cnt_x + sw.n * sw.g;
  // chain CTAs: enough for one step's tiles at a tile each, at least half
  // and at most three quarters of the card; all of it when no tile has slack
  const int step_tiles = sw.g * sw.g + sw.g * (sw.g + 1) / 2;
  int chain_ctas = sw.n > 2 ? std::min(std::max(step_tiles, ctas / 2),
                                       ctas - std::max(1, ctas / 4))
                            : ctas;
  if (chain_ctas <= 0) return (int)cudaErrorInvalidConfiguration;
  void* args[] = {&sw, &chain_ctas};
  err = cudaLaunchCooperativeKernel((const void*)sweep_blocks_kernel<T>,
                                    dim3(ctas), dim3(kThreads), args, 0,
                                    (cudaStream_t)stream);
  return (int)err;
}

}  // namespace

extern "C" {

int pyipm_bwd_sweep_blocks_f32(const void* Lp, const void* z,
                               const void* invb, void* x, void* partials,
                               void* counts, int npad, int w, void* stream) {
  return launch_sweep_blocks<float>(Lp, z, invb, x, partials, counts, npad,
                                    w, stream);
}

int pyipm_bwd_sweep_blocks_f64(const void* Lp, const void* z,
                               const void* invb, void* x, void* partials,
                               void* counts, int npad, int w, void* stream) {
  return launch_sweep_blocks<double>(Lp, z, invb, x, partials, counts, npad,
                                     w, stream);
}

}  // extern "C"
