// K3: lane prefix sum for Hopper (sm_90a).
//
// Replaces contextgs_tpu/ops/scan.py::lane_cumsum (the Pallas TPU kernel
// _cumsum_kernel): an inclusive or exclusive prefix sum along the last axis of
// a row-major [R, N] array of int32 (also uint32, by the same bits) or
// float32. It computes what the plain version ops/scan.py::
// lane_cumsum_reference computes (torch.cumsum with the input's dtype).
//
// Design: one single-pass decoupled look-back scan, one launch on the
// current stream, reading each input once. The R rows are cut into tiles
// of 8192 elements; a 256-thread block scans one tile (32 elements a
// thread: a larger tile takes fewer look-backs a byte):
//   1. it takes its tile from an atomic ticket, not from blockIdx, so a
//      block only ever waits on tiles whose blocks started before it, and
//      the look-back always makes progress;
//   2. it loads the tile into padded shared memory, 16 bytes a thread where
//      the row's alignment allows (a scalar edge for a ragged last tile or a
//      misaligned row), and each thread scans its 32 consecutive elements; a
//      warp scan (__shfl_up_sync) and one scan of the warp totals give each
//      thread its offset and the tile its aggregate;
//   3. it publishes the aggregate in its 64-bit status word (flag in the
//      high half, the value's 32 bits in the low half, one release store),
//      and warp 0 looks back over the preceding tiles of the row, 32 at a
//      time, each lane spinning on one word with an acquire load: it sums
//      aggregates until it meets an inclusive prefix, adds that, and
//      publishes the tile's own inclusive prefix. A row's first tile
//      publishes its inclusive prefix at once. A flag is never seen
//      without its value: both are one word.
//   4. each block then counts itself done; the last one, when every block
//      has finished its look-back, zeroes the status words and the two
//      counters, so the scratch is left as it was found: all zero.
// The scratch is the caller's, zeroed once when it is allocated and kept
// for later calls on the same stream (ops/scan.py keeps one per stream);
// calls on one stream run one after another, so each finds it zeroed and
// no memset is needed before a launch.
// The TPU kernel instead walks the blocks in order with a carry across its
// sequential grid; blocks on the GPU run in no order, hence the look-back.
// int32 is added as unsigned int: signed overflow is undefined in C++, and
// the reference's exact-i32 contract includes two's complement wrap-around.
//
// Float32 adds run in another order than torch.cumsum's, and the look-back
// chain depends on timing. Count the additions an element x_j passes on its
// way to output i (additions of an exact 0 round nothing and are not
// counted). Same tile: 32 in its thread's run, 5 + 5 in the warp and
// warp-total scans, 1 for the warp's offset, 1 for the tile's carry, 32 in
// the output's run: 76. Earlier tile: 32 + 5 + 5 = 42 into its tile's
// aggregate; at most 5 in the look-back warp's sum of the window that takes
// it; then one hop of the chain of inclusive prefixes per tile at most (a
// hop over g tiles adds a lane-masked window sum of depth ceil(log2 g), one
// running add per extra window of 32 and the inclusive add: at most g);
// then 1 + 32 in the output's tile. So with T = ceil(N / 8192) tiles a row,
// D = 80 + T bounds them all, and every output is within D * 2^-24 *
// sum_{j<=i} |x_j| of the exact prefix (to first order).
//
// Bound: bytes. The function reads each input once and writes each output
// once (8 bytes an element for 32-bit types) at 3.35 TB/s, and so does this
// design; the status words add 8 bytes per 8192 elements. Left for later:
// TMA staging of the tiles, several tiles a block for short rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 32;                        // elements a thread
constexpr int kBlock = kThreads * kItems;         // 8192 a tile
constexpr int kVecs = kBlock / 4 / kThreads;      // 16-byte loads a thread
constexpr int kPadded = kBlock + kBlock / 32;     // one pad word per 32
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kAggregate = 1ull << 32;   // status flags
constexpr unsigned long long kInclusive = 2ull << 32;

// Shared-memory index with one pad word every 32, so that thread t reading
// element t * 32 + i, and thread t storing elements 4t .. 4t + 3, meet no
// bank conflict.
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

template <typename T> __device__ __forceinline__ T from_bits(unsigned u);
template <>
__device__ __forceinline__ unsigned from_bits<unsigned>(unsigned u) {
  return u;
}
template <>
__device__ __forceinline__ float from_bits<float>(unsigned u) {
  return __uint_as_float(u);
}
__device__ __forceinline__ unsigned to_bits(unsigned v) { return v; }
__device__ __forceinline__ unsigned to_bits(float v) {
  return __float_as_uint(v);
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

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

// Warp 0 of tile `blk` (> 0) of a row: the sum of the row's tiles before it,
// from their status words `st[0 .. blk)`.
template <typename T>
__device__ __forceinline__ T look_back(const unsigned long long* st, int blk,
                                       int lane) {
  T exclusive = T(0);
  for (int last = blk - 1;; last -= 32) {
    const int t = last - lane;                    // lane 0 the nearest
    unsigned long long s = kInclusive;            // before the row: 0
    if (t >= 0) {
      do {
        s = load_acquire(st + t);
      } while ((s >> 32) == 0);
    }
    const unsigned inclusive = __ballot_sync(kFull, (s >> 32) == 2);
    // lanes past the nearest inclusive prefix add nothing
    const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
    T v = lane <= stop ? from_bits<T>(static_cast<unsigned>(s)) : T(0);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(kFull, v, d);
    exclusive += __shfl_sync(kFull, v, 0);
    if (inclusive) return exclusive;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_tiles(const T* __restrict__ x, T* __restrict__ out,
           unsigned long long* __restrict__ status,
           unsigned* __restrict__ counters, long long n, int n_blocks,
           int exclusive) {
  __shared__ T s[kPadded];
  __shared__ T warp_off[kWarps + 1];
  __shared__ int s_tile;
  __shared__ T s_carry;
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {                          // the ticket
    s_tile = static_cast<int>(atomicAdd(counters, 1u));
  }
  __syncthreads();
  const int tile = s_tile;
  const long long row = tile / n_blocks;
  const int blk = tile - static_cast<int>(row) * n_blocks;
  const T* xr = x + row * n;
  T* outr = out + row * n;
  unsigned long long* st = status + row * n_blocks;
  const long long base = static_cast<long long>(blk) * kBlock;
  const bool vec = base + kBlock <= n &&
                   ((reinterpret_cast<uintptr_t>(xr + base) |
                     reinterpret_cast<uintptr_t>(outr + base)) & 15) == 0;

  if (vec) {                                       // coalesced, 16 bytes
    const uint4* xv = reinterpret_cast<const uint4*>(xr + base);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int k = i * kThreads + threadIdx.x;
      const uint4 v = __ldg(xv + k);
      T* d = s + pad(4 * k);
      d[0] = from_bits<T>(v.x);
      d[1] = from_bits<T>(v.y);
      d[2] = from_bits<T>(v.z);
      d[3] = from_bits<T>(v.w);
    }
  } else {                                         // the scalar edge
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int k = i * kThreads + threadIdx.x;
      const long long j = base + k;
      s[pad(k)] = j < n ? xr[j] : T(0);
    }
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

  if (threadIdx.x < 32) {
    T carry = T(0);
    if (blk == 0) {
      if (lane == 0) store_release(st, kInclusive | to_bits(total));
    } else {
      if (lane == 0) store_release(st + blk, kAggregate | to_bits(total));
      carry = look_back<T>(st, blk, lane);
      if (lane == 0) {
        store_release(st + blk, kInclusive | to_bits(carry + total));
      }
    }
    if (lane == 0) s_carry = carry;
  }
  __syncthreads();

  T run = s_carry + offset;
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

  if (vec) {
    uint4* ov = reinterpret_cast<uint4*>(outr + base);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int k = i * kThreads + threadIdx.x;
      const T* d = s + pad(4 * k);
      ov[k] = make_uint4(to_bits(d[0]), to_bits(d[1]), to_bits(d[2]),
                         to_bits(d[3]));
    }
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int k = i * kThreads + threadIdx.x;
      const long long j = base + k;
      if (j < n) outr[j] = s[pad(k)];
    }
  }

  // the last block done leaves the scratch zeroed for the next call
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(counters + 1, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (s_last) {
    for (unsigned t = threadIdx.x; t < gridDim.x; t += kThreads) {
      status[t] = 0;
    }
    if (threadIdx.x == 0) counters[0] = counters[1] = 0;
  }
}

template <typename T>
int run(const void* x, void* out, void* scratch, int rows, long long n,
        int exclusive, void* stream) {
  const int n_blocks = static_cast<int>((n + kBlock - 1) / kBlock);
  const long long n_tiles = static_cast<long long>(rows) * n_blocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* words = static_cast<unsigned long long*>(scratch);
  scan_tiles<T><<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), words + 1,
      reinterpret_cast<unsigned*>(words), n, n_blocks, exclusive);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: [rows, n] row-major; scratch: at least rows * ceil(n / 8192) + 1
// 64-bit words, all zero (the ticket and the done count, then the tiles'
// status words), left all zero. Returns the CUDA error of the launch (0 on
// success).
extern "C" int lane_cumsum_i32(const void* x, void* out, void* scratch,
                               int rows, long long n, int exclusive,
                               void* stream) {
  return run<unsigned int>(x, out, scratch, rows, n, exclusive, stream);
}

extern "C" int lane_cumsum_f32(const void* x, void* out, void* scratch,
                               int rows, long long n, int exclusive,
                               void* stream) {
  return run<float>(x, out, scratch, rows, n, exclusive, stream);
}
