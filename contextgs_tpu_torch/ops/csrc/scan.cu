// K3: lane prefix sum for Hopper (sm_90a).
//
// Replaces contextgs_tpu/ops/scan.py::lane_cumsum (the Pallas TPU kernel
// _cumsum_kernel): an inclusive or exclusive prefix sum along the last axis of
// a row-major [R, N] array of int32 (also uint32, by the same bits) or
// float32. It computes what the plain version ops/scan.py::
// lane_cumsum_reference computes (torch.cumsum with the input's dtype).
//
// Design: reduce, then scan, in three launches on the current stream, so that
// one long row spreads over many SMs (R = 1, N = 1M gives 256 blocks):
//   1. block_sums: one 256-thread block per (row, 4096-element block) sums
//      its block (16 strided loads a thread, a warp __shfl_down_sync sum, the
//      8 warp totals) into partial[row, block];
//   2. block_carries: one block per row scans that row's block sums in
//      place into exclusive carries, 256 at a time with a running carry;
//   3. scan_blocks: every (row, block) loads its 4096 elements coalesced
//      into padded shared memory, each thread scans its 16 consecutive
//      elements, a warp scan (__shfl_up_sync) and one scan of the warp totals
//      give each thread its offset, the block's carry is added, and the
//      result is stored coalesced.
// The TPU kernel instead walks the blocks in order with a carry across its
// sequential grid; blocks on the GPU run in no order, hence the second pass.
// int32 is added as unsigned int: signed overflow is undefined in C++, and
// the reference's exact-i32 contract includes two's complement wrap-around.
//
// Float32 adds run in another order than torch.cumsum's. An element of an
// earlier block goes through at most 16 + 5 + 8 additions in its block sum,
// 5 + 5 + 1 + 1 + ceil(N / 2^20) in the carries and 1 + 16 in the block scan;
// one of the same block through at most 16 + 5 + 5 + 1 + 16. So with
// D = 64 + ceil(N / 2^20) every output is within D * 2^-24 *
// sum_{j<=i} |x_j| of the exact prefix (to first order).
//
// Bound: bytes. The function reads each input once and writes each output
// once (8 bytes an element for 32-bit types) at 3.35 TB/s; this design reads
// the input twice. Left for later: a single-pass decoupled look-back scan
// (one read), vectorized 16-byte loads, TMA staging of the blocks.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                        // elements a thread
constexpr int kBlock = kThreads * kItems;         // 4096, the TPU LANE_BLOCK
constexpr int kPadded = kBlock + kBlock / 32;     // one pad word per 32
constexpr unsigned kFull = 0xffffffffu;

// Shared-memory index with one pad word every 32, so that thread t reading
// element t * 16 + i meets no bank conflict.
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

template <typename T>
__device__ __forceinline__ T warp_inclusive_scan(T v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T up = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += up;
  }
  return v;
}

// The exclusive prefix of `v` over the block's threads; *total gets the sum
// of all of them. `warp_off` holds kWarps + 1 values. Ends with a barrier,
// so `warp_off` can be used again right after.
template <typename T>
__device__ __forceinline__ T block_exclusive_scan(T v, T* warp_off,
                                                  T* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T inc = warp_inclusive_scan(v, lane);
  T exc = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) exc = T(0);
  if (lane == 31) warp_off[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const T w = lane < kWarps ? warp_off[lane] : T(0);
    const T winc = warp_inclusive_scan(w, lane);
    T wexc = __shfl_up_sync(kFull, winc, 1);
    if (lane == 0) wexc = T(0);
    if (lane < kWarps) warp_off[lane] = wexc;
    if (lane == kWarps - 1) warp_off[kWarps] = winc;
  }
  __syncthreads();
  const T out = warp_off[warp] + exc;
  *total = warp_off[kWarps];
  __syncthreads();
  return out;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
block_sums(const T* __restrict__ x, T* __restrict__ partial, long long n,
           int n_blocks) {
  __shared__ T warp_tot[kWarps];
  const T* xr = x + static_cast<long long>(blockIdx.y) * n;
  const long long base = static_cast<long long>(blockIdx.x) * kBlock;
  T s = T(0);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long j = base + i * kThreads + threadIdx.x;
    if (j < n) s += xr[j];
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) s += __shfl_down_sync(kFull, s, d);
  if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    T t = T(0);
    for (int w = 0; w < kWarps; ++w) t += warp_tot[w];
    partial[static_cast<long long>(blockIdx.y) * n_blocks + blockIdx.x] = t;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
block_carries(T* __restrict__ partial, int n_blocks) {
  __shared__ T warp_off[kWarps + 1];
  T* p = partial + static_cast<long long>(blockIdx.x) * n_blocks;
  T carry = T(0);
  for (int base = 0; base < n_blocks; base += kThreads) {
    const int j = base + threadIdx.x;
    const T v = j < n_blocks ? p[j] : T(0);
    T total;
    const T exc = block_exclusive_scan(v, warp_off, &total);
    if (j < n_blocks) p[j] = carry + exc;
    carry += total;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_blocks(const T* __restrict__ x, T* __restrict__ out,
            const T* __restrict__ carries, long long n, int n_blocks,
            int exclusive) {
  __shared__ T s[kPadded];
  __shared__ T warp_off[kWarps + 1];
  const long long row = blockIdx.y;
  const T* xr = x + row * n;
  T* outr = out + row * n;
  const long long base = static_cast<long long>(blockIdx.x) * kBlock;

#pragma unroll
  for (int i = 0; i < kItems; ++i) {               // coalesced, striped
    const int k = i * kThreads + threadIdx.x;
    const long long j = base + k;
    s[pad(k)] = j < n ? xr[j] : T(0);
  }
  __syncthreads();

  const int first = threadIdx.x * kItems;          // this thread's run
  T v[kItems];
  T sum = T(0);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    v[i] = s[pad(first + i)];
    sum += v[i];
  }
  T total;
  const T offset = block_exclusive_scan(sum, warp_off, &total);
  T run = carries[row * n_blocks + blockIdx.x] + offset;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (exclusive) {
      s[pad(first + i)] = run;
      run += v[i];
    } else {
      run += v[i];
      s[pad(first + i)] = run;
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int k = i * kThreads + threadIdx.x;
    const long long j = base + k;
    if (j < n) outr[j] = s[pad(k)];
  }
}

template <typename T>
int run(const void* x, void* out, void* partial, int rows, long long n,
        int exclusive, void* stream) {
  const int n_blocks = static_cast<int>((n + kBlock - 1) / kBlock);
  const dim3 grid(n_blocks, rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  T* pt = static_cast<T*>(partial);
  block_sums<T><<<grid, kThreads, 0, s>>>(xt, pt, n, n_blocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  block_carries<T><<<rows, kThreads, 0, s>>>(pt, n_blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_blocks<T><<<grid, kThreads, 0, s>>>(xt, static_cast<T*>(out), pt, n,
                                           n_blocks, exclusive);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: [rows, n] row-major; partial: [rows, ceil(n / 4096)] scratch of the
// same type. Returns the CUDA error of the launches (0 on success).
extern "C" int lane_cumsum_i32(const void* x, void* out, void* partial,
                               int rows, long long n, int exclusive,
                               void* stream) {
  return run<unsigned int>(x, out, partial, rows, n, exclusive, stream);
}

extern "C" int lane_cumsum_f32(const void* x, void* out, void* partial,
                               int rows, long long n, int exclusive,
                               void* stream) {
  return run<float>(x, out, partial, rows, n, exclusive, stream);
}
