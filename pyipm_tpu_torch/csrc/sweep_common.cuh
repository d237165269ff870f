// What the one-launch backward sweeps (bwd_sweep_panels.cu,
// bwd_sweep_blocks.cu) share: a 128 x 128 tile of a row-major matrix held in
// the registers of a 512-thread CTA, the fixed-order reductions over its 16
// warps, a bounded acquire wait on a counter in device memory, and the
// number of CTAs the card holds at once (for the cooperative launch).

#pragma once

#include <cuda/atomic>
#include <cuda_runtime.h>

#include <atomic>

namespace sweep {

constexpr int kW = 128;                         // tile width and height
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;           // 16
constexpr int kRows = kW / kWarps;              // tile rows per thread: 8
constexpr int kCols = kW / 32;                  // tile columns per lane: 4

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double v[4]) {
  const double2 q0 = __ldg(reinterpret_cast<const double2*>(p));
  const double2 q1 = __ldg(reinterpret_cast<const double2*>(p) + 1);
  v[0] = q0.x; v[1] = q0.y; v[2] = q1.x; v[3] = q1.y;
}
__device__ __forceinline__ void shared4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void shared4(const double* p, double v[4]) {
  const double2 q0 = reinterpret_cast<const double2*>(p)[0];
  const double2 q1 = reinterpret_cast<const double2*>(p)[1];
  v[0] = q0.x; v[1] = q0.y; v[2] = q1.x; v[3] = q1.y;
}
__device__ __forceinline__ void put4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void put4(double* p, const double v[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

// This thread's part of the 128 x 128 tile whose first entry is `origin`, in
// a row-major matrix of leading dimension ld: rows warp + 16 r (r < 8),
// columns 4 lane .. 4 lane + 3.  A warp reads 512 contiguous bytes (f32) of
// one row per load, 16 bytes a lane.
template <typename T>
__device__ __forceinline__ void load_tile(const T* origin, long long ld,
                                          int warp, int lane,
                                          T tile[kRows][kCols]) {
  const T* p = origin + warp * ld + lane * kCols;
#pragma unroll
  for (int r = 0; r < kRows; ++r) load4(p + r * kWarps * ld, tile[r]);
}

// acc (this lane's 4 columns) += tile^T v over this thread's 8 rows; v holds
// the 128 row multipliers.
template <typename T>
__device__ __forceinline__ void tile_product(const T tile[kRows][kCols],
                                             const T v[kRows],
                                             T acc[kCols]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] += tile[r][c] * v[r];
}

// Sum over the 16 warps' partial rows red (16, 128), in warp order, for
// column tid < 128.
template <typename T>
__device__ __forceinline__ T sum_warps(const T* red, int tid) {
  T s = red[tid];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) s += red[w * kW + tid];
  return s;
}

// A legitimate wait is a few steps of the chain (microseconds).  A wait of
// ~2^24 polls (seconds) means a producer that never ran: trap, so that the
// launch fails with an error instead of holding the card.
constexpr unsigned kMaxPolls = 1u << 24;

// Spin until *counter >= want (acquire, device scope).
__device__ __forceinline__ void wait_at_least(int* counter, int want) {
  cuda::atomic_ref<int, cuda::thread_scope_device> f(*counter);
  for (unsigned polls = 0; f.load(cuda::std::memory_order_acquire) < want;)
    if (++polls == kMaxPolls) __trap();
}

// The shared-memory opt-in and the number of CTAs the card holds at once
// belong to a kernel on one device: found once per device (`cached`, one
// static array per kernel instantiation), so that a call makes no CUDA
// runtime query of its own.
constexpr int kMaxDevices = 64;

template <typename Kernel>
cudaError_t resident_ctas(Kernel kernel, std::atomic<int>* cached,
                          size_t smem, int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices) {
    *out = cached[dev].load(std::memory_order_acquire);
    if (*out > 0) return cudaSuccess;
  }
  if (smem > 0) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm * sms <= 0) return cudaErrorInvalidConfiguration;
  *out = per_sm * sms;
  if (dev < kMaxDevices) cached[dev].store(*out, std::memory_order_release);
  return cudaSuccess;
}

}  // namespace sweep
