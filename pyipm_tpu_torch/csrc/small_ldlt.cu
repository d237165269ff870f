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
// writes L and d, about 104 MB, and does about 0.16 GFLOP; the solve moves
// B (n^2 + 3n) values for 2 n^2 flops each instance (12.2 MB, 3.6 us at
// B = 10,000, n = 16, f32).  So the bound is bytes, and what stands in the
// way is the chain of dependent steps inside each instance: n column steps
// of the factorization (each needs the previous step's trailing update),
// 2n substitution steps of the solve.  Both answer it the same way: no
// CTA-wide barrier and no global access inside the chain.  The factor's
// wide branch (64 < n <= 128) is bound by issue as much as by bytes: each
// trailing update is three rounded operations (no FMA, for the bitwise
// equality below), n^3 / 2 instructions an instance, 0.54 G at
// (512, 128), about 16 us at the card's non-FMA rate against 15 us for
// the bytes.
//
// Staging (copy_run, shared by both kernels).  A CTA's instances are
// consecutive, so their matrices are one contiguous run of global memory.
// It is copied in one pass of 16-byte words, every load in flight before
// any chain starts, into shared tiles of odd row stride ld = n | 1 (lanes
// walking a column hit distinct banks); the run starts wherever the CTA's
// first instance lies (a batch slice, or any CTA at odd n), so a scalar
// head brings it to the next 16-byte boundary and a scalar tail ends it.
// The factorization writes L (unit diagonal and zeros included) and d back
// the same way.  The wide kernel stages one instance into a packed lower
// triangle instead (row r at r (r + 1) / 2; the upper entries are
// dropped), which its pivots then fill with L.
//
// The factorization at n <= 64: one warp per instance (two, in half-warps,
// at n <= 16).  Lane l owns rows l and l + 32 (above n = 32) of the lower
// triangle in registers; the kernel is a template on the size bucket (16,
// 32, 48, 64).  A row's registers are a window that slides one column a
// step, so that every register index is a constant while the column loop
// stays a loop (fully unrolled, the code grows with n^2, ~100 KB at 48, and
// is fetched from L2 anew each step: ~1.3 us a step at n = 36 on an NVIDIA
// H100 80GB HBM3 at 700 W).
// Step j: the pivot's owner broadcasts d_j by shuffle, every lane scales
// its own l_ij (and stores it to the tile), the scaled column goes through
// a warp-private shared column (two of them, alternating, so one
// __syncwarp per step orders both the write after the reads and the reads
// after the write), read back in 16-byte broadcasts, and every lane updates
// its own entries (i, c), j < c < n.  A warp does ~n^2/2 updates per
// instance, the longest row each step.
//
// The factorization at 64 < n <= 128 (ldlt_factor_kernel_wide).  Every
// application family of the fleet reaches it each iteration: portfolios of
// 64 assets (n = 65), maximum entropy over 64 states (67, and 67 for the
// SOC normal matrices), SVM duals of 96 points (97), MPC's SOC normal
// matrices (80), 2,048 instances a bucket; so do the condensed KKT solve,
// batched_reg_factor's Schur blocks, lstsq_minnorm's normal matrices and
// the L-BFGS rcond test at those sizes (ops/linalg.py, core/lbfgs.py).
// One instance's rows no longer fit one warp's registers, so a CTA of W
// warps (4 in f32, 8 in f64) runs it: the lower triangle in registers,
// spread cyclically by column over the warps (warp w holds columns
// w + W b) and by row over the lanes (rows l + 32 s), as kernel 3
// (panel_ldlt.cu) spreads its panel, so each step's shrinking trailing
// update is shared evenly; a template on the size bucket (96, 128).  The
// owner of column j + 1 applies step j to it, pivots and publishes it
// through a ring of shared buffers guarded by mbarriers before it updates
// its other columns: no CTA barrier in the column loop.  Many instances
// stay resident: 4 CTAs (16 warps) an SM in f32 at N = 128, in at most 128
// registers a thread.  It replaces an earlier CTA scheme (thread i owning
// row i in shared memory, two CTA barriers a step, the longest row on one
// thread): 0.090 against 0.523 ms at (512, 128) in f32 on an NVIDIA H100
// 80GB HBM3 at 700 W (scripts/time_small_ldlt.py), 6x the bytes' bound.
// A look-ahead that deferred the next owner's other columns until after
// its pivot measured slower there (more code, 128 registers): the kernel
// is held by issue more than by the chain.
//
// The solve: a warp runs one instance (two at n <= 16, in half-warps)
// column-oriented: lane i owns entry i of the running vector (entries i,
// i + 32, .. above n = 32), and step j is one shuffle that broadcasts entry
// j and one fused multiply-subtract in every lane still to be updated, with
// L_ij read from the staged tile (a column read in the forward pass, a row
// read in the backward pass, both free of bank conflicts).  No reduction,
// no barrier, no global load inside the chain.  An optional row scale is
// folded in: x = s * solve(s * b).  Above n = 64 (ldlt_solve_kernel_wide)
// each warp stages only its own factor's strict lower triangle, packed,
// and waits for no other warp.
//
// Numerics.  The factorization equals its plain PyTorch version
// (pyipm_tpu_torch/ops/small_ldlt.py) bit for bit: the same right-looking
// column order, the same zero-pivot guard (fabs(d_j) > 0, else divide by 1:
// a NaN pivot divides by 1 too), l = a / safe rounded, and the trailing
// update rounded as (l_i * l_k) * d_j then subtracted, with the _rn
// intrinsics so the compiler does not contract it into an FMA.  The solve
// subtracts its products one by one in step order (one FMA each) where the
// plain version sums a row and subtracts once, so the two differ by
// roundoff; every order is fixed, so a call is bitwise repeatable, and the
// two scale products are rounded on their own.
//
// Build: see pyipm_tpu_torch/ops/_build.py (one object per source, linked
// into one shared library with a plain C interface, loaded with ctypes).

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstdint>

#include "mbarrier.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarp = 32;
constexpr int kMaxN = 128;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fadd_rn(a, -b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dadd_rn(a, -b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

template <typename T> struct Word16;
template <> struct Word16<float> { using type = float4; };
template <> struct Word16<double> { using type = double2; };

// copy_run's views of a shared tile, entry (r, c): a tile of row stride ld
// at sm[r * ld + c]; and the packed lower triangle of the wide kernel, row
// r at tri[r (r + 1) / 2], which keeps only the entries c <= r of what is
// put and gives back L (its strict lower part, 1 on the diagonal, 0 above).
template <typename T>
struct StridedTile {
  T* sm;
  int ld;
  __device__ __forceinline__ void put(int r, int c, T v) const {
    sm[r * ld + c] = v;
  }
  __device__ __forceinline__ T get(int r, int c) const {
    return sm[r * ld + c];
  }
};

__device__ __forceinline__ int tri_row(int r) { return r * (r + 1) / 2; }

template <typename T>
struct LowerTile {
  T* tri;
  __device__ __forceinline__ void put(int r, int c, T v) const {
    if (c <= r) tri[tri_row(r) + c] = v;
  }
  __device__ __forceinline__ T get(int r, int c) const {
    return c < r ? tri[tri_row(r) + c] : T(c == r);
  }
};

// Copy `total` consecutive entries of global memory at g, rows of `cols`
// entries, to (kLoad) or from the shared tile: entry e is (row e / cols,
// column e % cols).  All threads of the CTA take part; a scalar head up to
// g's next 16-byte boundary, 16-byte words, a scalar tail.  The caller
// orders it with __syncthreads.
template <bool kLoad, typename T, typename Tile>
__device__ __forceinline__ void copy_run(T* g, Tile tile, int total,
                                         int cols) {
  using Word = typename Word16<T>::type;
  constexpr int V = sizeof(Word) / sizeof(T);
  const int head = min(
      total,
      (int)((16 - reinterpret_cast<uintptr_t>(g) % 16) % 16 / sizeof(T)));
  const int nvec = (total - head) / V;
  Word* words = reinterpret_cast<Word*>(g + head);
  // kDepth words a thread in flight before the first is used
  constexpr int kDepth = 4;
  for (int q0 = threadIdx.x; q0 < nvec; q0 += kDepth * blockDim.x) {
    Word word[kDepth];
    if (kLoad) {
#pragma unroll
      for (int t = 0; t < kDepth; ++t) {
        const int q = q0 + t * blockDim.x;
        if (q < nvec) word[t] = __ldg(words + q);
      }
    }
#pragma unroll
    for (int t = 0; t < kDepth; ++t) {
      const int q = q0 + t * blockDim.x;
      if (q >= nvec) break;
      const int e = head + q * V;
      int r = e / cols;
      int c = e - r * cols;
      T* v = reinterpret_cast<T*>(&word[t]);
#pragma unroll
      for (int u = 0; u < V; ++u) {
        if (kLoad) tile.put(r, c, v[u]);
        else v[u] = tile.get(r, c);
        if (++c == cols) { c = 0; ++r; }
      }
      if (!kLoad) words[q] = word[t];
    }
  }
  // head entries [0, head) and tail entries [head + nvec V, total)
  const int body = nvec * V;
  for (int s = threadIdx.x; s < total - body; s += blockDim.x) {
    const int e = s < head ? s : s + body;
    const int r = e / cols;
    const int c = e - r * cols;
    if (kLoad) tile.put(r, c, __ldg(g + e));
    else g[e] = tile.get(r, c);
  }
}

template <bool kLoad, typename T>
__device__ __forceinline__ void copy_run(T* g, T* sm, int total, int cols,
                                         int ld) {
  copy_run<kLoad>(g, StridedTile<T>{sm, ld}, total, cols);
}

// A lane's row windows at step j: r0[k] and r1[k] hold entries (i0, j + k)
// and (i1, j + k).  Steps them on: a_ic -= (l_i * l_c) * d_j for c = j + k,
// 1 <= k < live, the result written to place k - 1, with l_c = col[k]
// read in 16-byte broadcasts, each word loaded one ahead of its use.  The
// places past a row's own end (columns past n, or past the group's last
// row) get harmless updates and are never read again.  Without a second
// row, r1 is one entry that is never updated.
template <typename T, int K0, int K1>
__device__ __forceinline__ void slide_rows(T (&r0)[K0], T (&r1)[K1], T l0,
                                           T l1, T dj, const T* col,
                                           int live) {
  using Word = typename Word16<T>::type;
  constexpr int V = sizeof(Word) / sizeof(T);
  constexpr int Q = ((K0 > K1 ? K0 : K1) + V - 1) / V;
  const Word* words = reinterpret_cast<const Word*>(col);
  Word next = words[0];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    if (q * V >= live) break;
    const Word word = next;
    if (q + 1 < Q) next = words[q + 1];
    const T* lc = reinterpret_cast<const T*>(&word);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int k = q * V + v;
      if (k >= 1 && k < K0)
        r0[k - 1] = sub_rn(r0[k], mul_rn(mul_rn(l0, lc[v]), dj));
      if (k >= 1 && k < K1)
        r1[k - 1] = sub_rn(r1[k], mul_rn(mul_rn(l1, lc[v]), dj));
    }
  }
}

// Right-looking unpivoted LDL^T, n <= N, of the CTA's instances: W lanes
// (16 or 32) run one instance, lane l owning row i0 = l as r0 (W columns)
// and, at N > 32, row i1 = l + 32 as r1 (N columns), each a window that
// slides one column a step (slide_rows), so every register index is a
// constant while the column loop stays a loop.  The finished l_ij goes to
// the tile at once, d_j to the shared d.  Shared memory: per instance two
// columns of N entries (16-byte aligned, first), then the tiles, then d.
// Lanes past the batch end or past row n run along (the shuffles and
// __syncwarp need every lane) and store nothing.
template <typename T, int W, int N>
__global__ void __launch_bounds__(kThreads)
ldlt_factor_kernel(const T* __restrict__ A, T* __restrict__ L,
                   T* __restrict__ d, int B, int n) {
  constexpr bool kTwo = N > kWarp;      // a second row per lane
  constexpr int K0 = kTwo ? kWarp : N;  // columns of row i0
  constexpr int K1 = kTwo ? N : 1;      // columns of row i1
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = n | 1;
  const int nn = n * n;
  const int ipb = (blockDim.x / kWarp) * (kWarp / W);
  const long long first = (long long)blockIdx.x * ipb;
  const int count = (int)min((long long)ipb, (long long)B - first);
  T* cols = reinterpret_cast<T*>(smem_raw);
  T* tiles = cols + ipb * 2 * N;
  T* dsm = tiles + ipb * n * ld;

  copy_run<true>(const_cast<T*>(A) + first * nn, tiles, count * nn, n, ld);
  __syncthreads();

  const int lane = threadIdx.x % kWarp;
  const int sl = lane % W;
  const int li = (threadIdx.x / kWarp) * (kWarp / W) + lane / W;
  const bool valid = li < count;
  T* tile = tiles + li * n * ld;
  T* colpair = cols + li * 2 * N;
  const int i0 = sl, i1 = sl + kWarp;

  T r0[K0], r1[K1];
#pragma unroll
  for (int k = 0; k < K0; ++k)
    r0[k] = (valid && i0 < n && k < n) ? tile[i0 * ld + k] : T(0);
#pragma unroll
  for (int k = 0; k < K1; ++k)
    r1[k] = (kTwo && valid && i1 < n && k < n) ? tile[i1 * ld + k] : T(0);

#pragma unroll 1
  for (int j = 0; j < n; ++j) {
    // the pivot: place 0 of row j, in lane j % 32
    const T dj = __shfl_sync(kFull, (kTwo && j >= kWarp) ? r1[0] : r0[0],
                             j % W, W);
    const T safe = (fabs(dj) > T(0)) ? dj : T(1);
    if (valid && sl == 0) dsm[li * n + j] = dj;
    // the scaled column, l_ij at col[i - j].  Only live rows divide: a
    // finished row's window holds leftovers (a padding row, zeros), and a
    // division whose operands leave the fast path's range takes the slow
    // path for the whole warp.
    T* col = colpair + (j & 1) * N;
    T l0 = T(0), l1 = T(0);
    if (valid && i0 > j && i0 < n) {
      l0 = div_rn(r0[0], safe);
      col[i0 - j] = l0;
      tile[i0 * ld + j] = l0;
    }
    if (kTwo && valid && i1 > j && i1 < n) {
      l1 = div_rn(r1[0], safe);
      col[i1 - j] = l1;
      tile[i1 * ld + j] = l1;
    }
    __syncwarp();
    slide_rows(r0, r1, l0, l1, dj, col, (kTwo ? n : min(n, K0)) - j);
  }

  // the unit diagonal and the zeros above it
  if (valid && i0 < n)
    for (int c = i0; c < n; ++c) tile[i0 * ld + c] = T(c == i0);
  if (kTwo && valid && i1 < n)
    for (int c = i1; c < n; ++c) tile[i1 * ld + c] = T(c == i1);
  __syncthreads();
  copy_run<false>(L + first * nn, tiles, count * nn, n, ld);
  copy_run<false>(d + first * n, dsm, count * n, n, n);
}

// ---- the factorization at 64 < n <= 128: the wide kernel ----
//
// One CTA of W warps per instance (W = 4 in f32, 8 in f64), the lower
// triangle in registers: warp w holds the columns w + W b, lane l the rows
// l + 32 s (row slot s < S = N / 32), entry (l + 32 s, w + W b) in a[s][b],
// only the column slots b < (32 / W)(s + 1) of row slot s that reach the
// triangle.  The kernel is a template on the size bucket N (96, 128).
//
// A pass is the W steps that pivot column slot b0 of every warp.  The
// register windows slide one column slot a pass: a[s][k] holds column slot
// b0 + k, so the pivot column is always k = 0 and every register index is a
// constant while the step loop stays a loop.  A phase is the 32 steps that
// finish row slot p; the phases are unrolled (template P), so each phase's
// code touches only row slots s >= P and its window bounds are constants.
// A row slot's window shrinks one slot a pass; the tail it leaves (columns
// past the slot's last row) gets harmless updates and is never read again.
//
// Iteration nx applies step nx - 1 and pivots column nx, owned by warp
// nx % W (kernel 3's hand-off, panel_ldlt.cu): every warp waits on the
// step's mbarrier and reads its row values l_r and d_j from the step's
// buffer; the owner updates column nx first, broadcasts d_nx by shuffle,
// divides its rows below the diagonal, writes the scaled column and d_nx to
// the next buffer (l_r by row, zeros at and above the diagonal, d at
// [N + 32]) and to the packed triangle in shared memory, arrives, and only
// then updates its other columns.  No CTA barrier in the loop.  A ring of
// 2W buffers suffices: a warp writes step m only after waiting for step
// m - 1, so after steps j + 2 .. j + W + 1 (one per warp) every warp has
// read step j, and step j + 2W is written after those.  The column values
// l_c are broadcast loads of buffer entries w + W (b0 + k); in a window's
// dead tail they read up to entry N + 31 - W, so a buffer has N + 32
// entries before d (zeroed once; never written there).
template <int W, int N>
struct Wide {
  static constexpr int kS = N / kWarp;       // row slots of a lane
  static constexpr int kC = N / W;           // column slots of a warp
  static constexpr int kPasses = kWarp / W;  // passes a phase
  static constexpr int kRing = 2 * W;        // step buffers
  static constexpr int kDj = N + kWarp;      // d_j's place in a buffer
  static constexpr int kBuf = kDj + 4;       // a buffer's entries
};

// the trailing update of one entry: a - (l_r * l_c) * d_j, rounded in
// that order
template <typename T>
__device__ __forceinline__ T ldl_update(T a, T lr, T lc, T dj) {
  return sub_rn(a, mul_rn(mul_rn(lr, lc), dj));
}

// Step j's update (row values ls, pivot dj, buffer cur) of this warp's
// window in phase P: column slot k at column col0 + W k.  Slot 0 only where
// `with0` (a warp past the pivot's owner).  kShift, the pass's last step:
// the result of slot k goes to k - 1 (slot 0 is finished in every warp).
template <typename T, int W, int N, int P, bool kShift>
__device__ __forceinline__ void wide_update(
    T (&a)[Wide<W, N>::kS][Wide<W, N>::kC], const T (&ls)[Wide<W, N>::kS],
    T dj, const T* cur, int col0, bool with0) {
  using G = Wide<W, N>;
  if (!kShift && with0) {
    const T lc = cur[col0];
#pragma unroll
    for (int s = P; s < G::kS; ++s)
      a[s][0] = ldl_update(a[s][0], ls[s], lc, dj);
  }
#pragma unroll
  for (int k = 1; k < G::kPasses * (G::kS - P); ++k) {
    const T lc = cur[col0 + W * k];
#pragma unroll
    for (int s = P; s < G::kS; ++s)
      if (k < G::kPasses * (s - P + 1))
        a[s][k - kShift] = ldl_update(a[s][k], ls[s], lc, dj);
  }
}

// Phase P: iterations nx = 32 P .. min(32 P + 32, n) - 1, then the next
// phase.
template <typename T, int W, int N, int P>
__device__ __forceinline__ void wide_phase(
    T (&a)[Wide<W, N>::kS][Wide<W, N>::kC], unsigned long long* bars,
    T* ring, T* tri, T* dsm, int n, int warp, int lane) {
  using G = Wide<W, N>;
  const int end = min(kWarp * (P + 1), n);
#pragma unroll 1
  for (int nx = kWarp * P; nx < end; ++nx) {
    const int w0 = nx % W;
    const int col0 = warp + W * (nx / W);
    T ls[G::kS];
    T dj = T(0);
    const T* cur = ring;
    if (nx > 0) {
      const int j = nx - 1;
      cur = ring + (j % G::kRing) * G::kBuf;
      mbar_wait(bars + j % G::kRing, (j / G::kRing) & 1);
#pragma unroll
      for (int s = P; s < G::kS; ++s) ls[s] = cur[lane + kWarp * s];
      dj = cur[G::kDj];
      if (warp == w0) {
        const T lc = cur[nx];
#pragma unroll
        for (int s = P; s < G::kS; ++s)
          a[s][0] = ldl_update(a[s][0], ls[s], lc, dj);
      }
    }
    if (warp == w0) {
      // the pivot: entry (nx, nx), row slot P, column slot 0, lane nx % 32
      const T dn = __shfl_sync(kFull, a[P][0], nx % kWarp);
      const T safe = (fabs(dn) > T(0)) ? dn : T(1);
      T* nxt = ring + (nx % G::kRing) * G::kBuf;
#pragma unroll
      for (int s = P; s < G::kS; ++s) {
        const int r = lane + kWarp * s;
        const bool below = r > nx && r < n;
        // only live rows divide: a finished row's leftovers might take
        // the division's slow path for the whole warp
        const T q = div_rn(below ? a[s][0] : safe, safe);
        nxt[r] = below ? q : T(0);
        if (below) tri[tri_row(r) + nx] = q;
      }
      if (lane == 0) {
        nxt[G::kDj] = dn;
        dsm[nx] = dn;
      }
      mbar_arrive(bars + nx % G::kRing);
    }
    if (nx > 0) {
      if (w0 == W - 1)
        wide_update<T, W, N, P, true>(a, ls, dj, cur, col0, false);
      else
        wide_update<T, W, N, P, false>(a, ls, dj, cur, col0, warp > w0);
    }
  }
  if constexpr (P + 1 < G::kS)
    if (n > kWarp * (P + 1))
      wide_phase<T, W, N, P + 1>(a, bars, ring, tri, dsm, n, warp, lane);
}

template <typename T> struct WideWarps;
template <> struct WideWarps<float> { static constexpr int value = 4; };
template <> struct WideWarps<double> { static constexpr int value = 8; };

// Shared memory: the ring's barriers, the ring, the packed lower triangle
// (A's lower triangle in, L's strict lower part out), d.
template <typename T, int W, int N>
constexpr size_t wide_smem(int n) {
  return Wide<W, N>::kRing * sizeof(unsigned long long) +
         ((size_t)Wide<W, N>::kRing * Wide<W, N>::kBuf +
          (size_t)n * (n + 1) / 2 + n) * sizeof(T);
}

// LDL^T of one instance (blockIdx.x) at 64 < n <= N: A's lower triangle is
// staged into the packed triangle (copy_run), each thread takes its entries,
// the phases run, and L and d go out through copy_run.  At most 16 / W CTAs
// an SM are asked for, so a thread keeps its window (80 f32 registers at
// N = 128, W = 4) in at most 128 registers.
template <typename T, int W, int N>
__global__ void __launch_bounds__(W * kWarp, 16 / W)
ldlt_factor_kernel_wide(const T* __restrict__ A, T* __restrict__ L,
                        T* __restrict__ d, int n) {
  using G = Wide<W, N>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* bars = reinterpret_cast<unsigned long long*>(smem_raw);
  T* ring = reinterpret_cast<T*>(bars + G::kRing);
  T* tri = ring + G::kRing * G::kBuf;
  T* dsm = tri + n * (n + 1) / 2;
  const long long nn = (long long)n * n;
  const long long inst = blockIdx.x;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;

  if (threadIdx.x < G::kRing) mbar_init(bars + threadIdx.x, kWarp);
  for (int e = threadIdx.x; e < G::kRing * G::kBuf; e += blockDim.x)
    ring[e] = T(0);
  copy_run<true>(const_cast<T*>(A) + inst * nn, LowerTile<T>{tri}, (int)nn,
                 n);
  __syncthreads();
  T a[G::kS][G::kC];
#pragma unroll
  for (int s = 0; s < G::kS; ++s)
#pragma unroll
    for (int k = 0; k < G::kPasses * (s + 1); ++k) {
      const int r = lane + kWarp * s, c = warp + W * k;
      a[s][k] = (r < n && c <= r) ? tri[tri_row(r) + c] : T(0);
    }
  __syncthreads();  // the pivots overwrite the triangle
  wide_phase<T, W, N, 0>(a, bars, ring, tri, dsm, n, warp, lane);
  __syncthreads();
  copy_run<false>(L + inst * nn, LowerTile<T>{tri}, (int)nn, n);
  copy_run<false>(d + inst * n, dsm, n, n, n);
}

__device__ __forceinline__ float fnma(float a, float b, float c) {
  return fmaf(-a, b, c);
}
__device__ __forceinline__ double fnma(double a, double b, double c) {
  return fma(-a, b, c);
}

// x = s * (L^-T diag(d)^-1 L^-1 (s * b)), s = 1 without `scale`.  W lanes
// (16 or 32) run one instance, lane l owning entries l + 32 u, u < NT
// (NT = 1 at W = 16).  The CTA's factors are staged by copy_run into
// tiles of row stride ld = n | 1.  Only shuffles order the chain, and every lane of a warp takes part in them,
// so lanes past the batch end run along on zeros and skip the loads and
// the store.
template <typename T, int NT, int W>
__global__ void __launch_bounds__(kThreads)
ldlt_solve_kernel(const T* __restrict__ L, const T* __restrict__ d,
                  const T* __restrict__ b, const T* __restrict__ scale,
                  T* __restrict__ x, int B, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int ld = n | 1;
  const int nn = n * n;
  const int ipb = (blockDim.x / kWarp) * (kWarp / W);
  const long long first = (long long)blockIdx.x * ipb;
  const int count = (int)min((long long)ipb, (long long)B - first);

  copy_run<true>(const_cast<T*>(L) + first * nn, sm, count * nn, n, ld);
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

// ---- the solve at 64 < n <= 128: the wide solve kernel ----
//
// A warp an instance, as ldlt_solve_kernel, with the same arithmetic in the
// same order, so bit for bit the same x; what changes is the staging and the
// launch.  At these sizes the tile of row stride n | 1 took 37.6 KB an
// instance at n = 97 in f32, so a CTA shrank to one warp, six an SM, each
// loading its whole tile (the zeros above the diagonal included) before its
// chain began.  Here each warp stages only the strict lower triangle of its
// own L, packed (row r at r (r - 1) / 2, r >= 1: 18.6 KB at n = 97, twelve
// instances an SM), and waits for no other warp: no CTA barrier, so while
// some warps of an SM stage, others run their chains.  Row r's entries
// 0 .. r-1 start wherever r n falls, so the warp reads the 16-byte words
// that cover each row (a word a lane, kDepth words a lane in flight) and
// scatters their entries below the diagonal into the packing.  The forward
// pass reads entry (i, j) at i (i - 1) / 2 + j across the lanes i: lanes l
// and l' share a bank only for {l, l'} = {0, 1} at i >= 32 (triangular
// numbers mod 32), a two-way conflict; the backward pass reads row j,
// lane i at j (j - 1) / 2 + i, consecutive.  Two ways of staging by
// cp.async (no registers, every copy in flight at once) measured slower
// overall on an H100: 4-byte copies straight into the packing stage at
// well under the memory's rate; 16-byte copies need each row at its own
// 16-byte offset in shared memory, which costs room (10 instances an SM at
// n = 97) and, at n = 0 mod 4, where every row starts on the same offset,
// 4-way bank conflicts on the forward pass's column reads.  What bounds
// this design: at n = 97, 2,048 instances are 15.5 an SM, 12 fit, so an
// SM runs two rounds of staging and chain (2n = 194 shuffle steps).

// Entries of a warp's region: the packed triangle, rounded to 16 bytes.
template <typename T>
__host__ __device__ constexpr int wide_solve_words(int n) {
  return (n * (n - 1) / 2 + 16 / (int)sizeof(T) - 1) &
         ~(16 / (int)sizeof(T) - 1);
}

// x = s * (L^-T diag(d)^-1 L^-1 (s * b)) for the instance of each warp,
// 64 < n <= 32 NT.  A warp past the batch end leaves at once: nothing waits
// for another warp.
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
ldlt_solve_kernel_wide(const T* __restrict__ L, const T* __restrict__ d,
                       const T* __restrict__ b, const T* __restrict__ scale,
                       T* __restrict__ x, int B, int n) {
  using Word = typename Word16<T>::type;
  constexpr int V = sizeof(Word) / sizeof(T);
  constexpr int kDepth = 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const long long inst =
      (long long)blockIdx.x * (blockDim.x / kWarp) + warp;
  if (inst >= B) return;
  T* tri = reinterpret_cast<T*>(smem_raw) + warp * wide_solve_words<T>(n);

  // b, the scale and d, in flight while the factor is staged
  const long long row = inst * n;
  T y[NT], sc[NT], dv[NT];
  int pr[NT];  // where row i of the triangle starts (row 0 past n)
#pragma unroll
  for (int u = 0; u < NT; ++u) {
    const int i = lane + kWarp * u;
    const bool in = i < n;
    sc[u] = (scale && in) ? scale[row + i] : T(1);
    y[u] = in ? b[row + i] : T(0);
    if (scale) y[u] = mul_rn(sc[u], y[u]);
    dv[u] = in ? d[row + i] : T(1);
    pr[u] = in ? i * (i - 1) / 2 : 0;
  }
  // Word g of row r: from the 16-byte boundary at or before the row's
  // start (its entry offset `sh` back), entries V g - sh .. of the row;
  // q = the words that cover entries 0 .. r-1.  The lanes take the rows'
  // words in order, a word a lane.
  {
    const T* Lg = L + inst * n * n;
    const int shift0 =
        (int)(reinterpret_cast<uintptr_t>(Lg) % 16 / sizeof(T));
    int r = 1, g = lane, sh = (shift0 + n) & (V - 1);
    int q = (sh + 1 + V - 1) / V;
    auto next_row = [&]() {
      while (r < n && g >= q) {
        g -= q;
        ++r;
        sh = (shift0 + r * n) & (V - 1);
        q = (sh + r + V - 1) / V;
      }
    };
    next_row();
    while (r < n) {
      Word w[kDepth];
      int wr[kDepth], wc[kDepth];  // the word's row and first column
#pragma unroll
      for (int t = 0; t < kDepth; ++t) {
        wr[t] = r;
        wc[t] = V * g - sh;
        if (r < n) w[t] = __ldg(reinterpret_cast<const Word*>(
                                    Lg + r * n - sh) + g);
        g += kWarp;
        next_row();
      }
#pragma unroll
      for (int t = 0; t < kDepth; ++t) {
        const T* v = reinterpret_cast<const T*>(&w[t]);
        T* dst = tri + wr[t] * (wr[t] - 1) / 2;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const int c = wc[t] + k;
          if (wr[t] < n && c >= 0 && c < wr[t]) dst[c] = v[k];
        }
      }
    }
  }
  __syncwarp();

  // forward: after steps 0 .. j-1 entry j is final; broadcast it and
  // subtract L_ij y_j from every later entry i.  Entries of a later slot
  // (u > t) are all below j: no test.  Entries past n compute on the
  // region's first words, are never broadcast and never stored.
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int steps = min(kWarp, n - kWarp * t);
#pragma unroll 4
    for (int jj = 0; jj < steps; ++jj) {
      const int j = kWarp * t + jj;
      const T yj = __shfl_sync(kFull, y[t], jj);
      if (lane > jj) y[t] = fnma(tri[pr[t] + j], yj, y[t]);
#pragma unroll
      for (int u = t + 1; u < NT; ++u)
        y[u] = fnma(tri[pr[u] + j], yj, y[u]);
    }
  }
  // zero-guarded diagonal scale
#pragma unroll
  for (int u = 0; u < NT; ++u)
    if (lane + kWarp * u < n)
      y[u] = y[u] / ((fabs(dv[u]) > T(0)) ? dv[u] : T(1));
  // backward: entry j is final once steps n-1 .. j+1 are done; broadcast it
  // and subtract L_ji x_j from every earlier entry i (all of an earlier
  // slot, u < t: no test)
#pragma unroll
  for (int t = NT - 1; t >= 0; --t) {
    const int steps = min(kWarp, n - kWarp * t);
#pragma unroll 4
    for (int jj = steps - 1; jj >= 0; --jj) {
      const int j = kWarp * t + jj;
      const T xj = __shfl_sync(kFull, y[t], jj);
      const T* rowj = tri + j * (j - 1) / 2;
      if (lane < jj) y[t] = fnma(rowj[lane + kWarp * t], xj, y[t]);
#pragma unroll
      for (int u = 0; u < t; ++u)
        y[u] = fnma(rowj[lane + kWarp * u], xj, y[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < NT; ++u) {
    const int i = lane + kWarp * u;
    if (i < n) x[row + i] = scale ? mul_rn(sc[u], y[u]) : y[u];
  }
}

// The opt-in to more than 48 KB of dynamic shared memory belongs to a
// kernel on one device: set once per device (`done`, one static array per
// kernel instantiation) to `bytes`, the most the kernel ever asks for;
// with `max_carveout` also the SM's split of L1 and shared memory to the
// most shared memory, so that as many CTAs stay resident as their shared
// memory allows.
constexpr int kMaxDevices = 64;
constexpr size_t kOptInAbove = 48 * 1024;

template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, std::atomic<bool>* done, size_t bytes,
                        bool max_carveout = false) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && max_carveout)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_release);
  return err;
}

// Shared memory a CTA of the batched kernels (n <= 64) may take so that
// several fit on an SM.
constexpr size_t kCtaSmem = 72 * 1024;

// Warps of a batched CTA: four, halved until the CTA's shared memory (at
// `per_warp` bytes a warp) fits kCtaSmem.
int cta_warps(size_t per_warp) {
  int warps = kThreads / kWarp;
  while (warps > 1 && warps * per_warp > kCtaSmem) warps /= 2;
  return warps;
}

template <typename T, int W, int N>
int launch_factor_as(const T* A, T* L, T* d, int B, int n,
                     cudaStream_t stream) {
  // per instance: two columns, the tile, d
  const size_t inst = (2 * N + (size_t)n * (n | 1) + n) * sizeof(T);
  const int per_warp = kWarp / W;
  const int warps = cta_warps(per_warp * inst);
  const int ipb = warps * per_warp;
  const size_t smem = ipb * inst;
  if (smem > kOptInAbove) {
    static std::atomic<bool> done[kMaxDevices];
    cudaError_t err = opt_in_smem(ldlt_factor_kernel<T, W, N>, done,
                                  kCtaSmem);
    if (err != cudaSuccess) return (int)err;
  }
  ldlt_factor_kernel<T, W, N><<<(B + ipb - 1) / ipb, warps * kWarp, smem,
                                stream>>>(A, L, d, B, n);
  return (int)cudaGetLastError();
}

template <typename T, int W, int N>
int launch_factor_wide(const T* A, T* L, T* d, int B, int n,
                       cudaStream_t stream) {
  if (wide_smem<T, W, N>(N) > kOptInAbove) {
    static std::atomic<bool> done[kMaxDevices];
    cudaError_t err = opt_in_smem(ldlt_factor_kernel_wide<T, W, N>, done,
                                  wide_smem<T, W, N>(N));
    if (err != cudaSuccess) return (int)err;
  }
  ldlt_factor_kernel_wide<T, W, N><<<B, W * kWarp, wide_smem<T, W, N>(n),
                                     stream>>>(A, L, d, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_factor(const void* A_, void* L_, void* d_, int B, int n,
                  void* stream_) {
  if (B <= 0 || n <= 0 || n > kMaxN) return (int)cudaErrorInvalidValue;
  const T* A = static_cast<const T*>(A_);
  T* L = static_cast<T*>(L_);
  T* d = static_cast<T*>(d_);
  cudaStream_t stream = (cudaStream_t)stream_;
  if (n <= 16) return launch_factor_as<T, 16, 16>(A, L, d, B, n, stream);
  if (n <= 32) return launch_factor_as<T, 32, 32>(A, L, d, B, n, stream);
  if (n <= 48) return launch_factor_as<T, 32, 48>(A, L, d, B, n, stream);
  if (n <= 64) return launch_factor_as<T, 32, 64>(A, L, d, B, n, stream);
  if (n <= 96)
    return launch_factor_wide<T, WideWarps<T>::value, 96>(A, L, d, B, n,
                                                          stream);
  return launch_factor_wide<T, WideWarps<T>::value, 128>(A, L, d, B, n,
                                                         stream);
}

template <typename T, int NT, int W>
int launch_solve_as(const T* L, const T* d, const T* b, const T* scale, T* x,
                    int B, int n, cudaStream_t stream) {
  const size_t tile = (size_t)n * (n | 1) * sizeof(T);
  const int per_warp = kWarp / W;
  const int warps = cta_warps(per_warp * tile);
  const int ipb = warps * per_warp;
  const size_t smem = ipb * tile;
  if (smem > kOptInAbove) {
    static std::atomic<bool> done[kMaxDevices];
    cudaError_t err = opt_in_smem(
        ldlt_solve_kernel<T, NT, W>, done, kCtaSmem);
    if (err != cudaSuccess) return (int)err;
  }
  ldlt_solve_kernel<T, NT, W><<<(B + ipb - 1) / ipb, warps * kWarp, smem,
                                stream>>>(L, d, b, scale, x, B, n);
  return (int)cudaGetLastError();
}

// Hopper's SM: 228 KB of shared memory, of which each resident CTA takes
// 1 KB for the system; at most 32 CTAs and 64 warps an SM, 227 KB a CTA.
constexpr size_t kSmSmem = 228 * 1024;
constexpr size_t kCtaReserved = 1024;
constexpr size_t kCtaSmemMax = 227 * 1024;

// Warps of a wide-solve CTA (4, 2 or 1, at `per_warp` bytes a warp): the
// most warps resident an SM, the larger CTA on a tie.
int wide_solve_warps(size_t per_warp) {
  int best = 1, resident = 0;
  for (int w = kThreads / kWarp; w >= 1; w /= 2) {
    const size_t cta = w * per_warp;
    if (cta > kCtaSmemMax) continue;
    const int ctas = std::min((int)(kSmSmem / (cta + kCtaReserved)),
                              std::min(32, 64 / w));
    if (ctas * w > resident) {
      resident = ctas * w;
      best = w;
    }
  }
  return best;
}

template <typename T, int NT>
cudaError_t prepare_solve_wide() {
  static std::atomic<bool> done[kMaxDevices];
  return opt_in_smem(ldlt_solve_kernel_wide<T, NT>, done, kCtaSmemMax, true);
}

template <typename T, int NT>
int launch_solve_wide(const T* L, const T* d, const T* b, const T* scale,
                      T* x, int B, int n, cudaStream_t stream) {
  cudaError_t err = prepare_solve_wide<T, NT>();
  if (err != cudaSuccess) return (int)err;
  const size_t per_warp = (size_t)wide_solve_words<T>(n) * sizeof(T);
  const int warps = wide_solve_warps(per_warp);
  ldlt_solve_kernel_wide<T, NT><<<(B + warps - 1) / warps, warps * kWarp,
                                  warps * per_warp, stream>>>(
      L, d, b, scale, x, B, n);
  return (int)cudaGetLastError();
}

// The wide solve's launch at size n: out[0] warps a CTA, out[1] CTAs
// resident an SM (the occupancy calculator's answer, attributes set).
template <typename T, int NT>
int residency_solve_wide(int n, int* out) {
  cudaError_t err = prepare_solve_wide<T, NT>();
  if (err != cudaSuccess) return (int)err;
  const size_t per_warp = (size_t)wide_solve_words<T>(n) * sizeof(T);
  out[0] = wide_solve_warps(per_warp);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out + 1, ldlt_solve_kernel_wide<T, NT>, out[0] * kWarp,
      out[0] * per_warp);
}

template <typename T>
int solve_residency(int n, int* out) {
  if (n <= 64 || n > kMaxN) return (int)cudaErrorInvalidValue;
  return n <= 96 ? residency_solve_wide<T, 3>(n, out)
                 : residency_solve_wide<T, 4>(n, out);
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
#undef PYIPM_SOLVE_AS
  if (n <= 96)
    return launch_solve_wide<T, 3>(L, d, b, scale, x, B, n, stream);
  return launch_solve_wide<T, 4>(L, d, b, scale, x, B, n, stream);
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

// The wide solve's launch at 64 < n <= 128: out[0] warps a CTA, out[1]
// CTAs resident an SM.
int pyipm_ldlt_solve_residency_f32(int n, int* out) {
  return solve_residency<float>(n, out);
}

int pyipm_ldlt_solve_residency_f64(int n, int* out) {
  return solve_residency<double>(n, out);
}

const char* pyipm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
