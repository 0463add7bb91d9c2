// The carry: a segmented forward fill for Hopper (sm_90a).
//
// Replaces no Pallas kernel. It stands in for the XLA associative scan of
// contextgs_tpu/models/levels.py::segmented_carry (:39-49) and computes what
// the plain version models/levels.py::segmented_carry_plain computes:
//   out[i] = values[last(i)], last(i) = max_{j <= i} (is_start[j] ? j : 0),
// so keys before the first start carry values[0], as the reference's scan
// gives. is_start is bool [n], values and out int32 or int64 [n], n < 2^31.
//
// Why it was added: the plain version's chain (arange, where, torch.cummax,
// gather: four launches and two int64 arrays over every key) was the top
// device operation of both training cells with densify rounds on an H100.
// PyTorch scans an innermost dimension one row per thread block, and a 1-D
// tensor is one row, so one SM of 132 scanned every key: ~74 ms a call over
// the 24M keys of a BungeeNeRF-scale densify grouping, ~6.9 ms over the 2.4M
// slots of a level map.
//
// Design: K3's single-pass decoupled look-back (ops/csrc/scan.cu) with max in
// place of +, taken over the int32 key index is_start[i] ? i : 0, one launch
// on the current stream. The keys are cut into tiles of 8192; a 256-thread
// block takes one (32 consecutive keys a thread):
//   1. it takes its tile from an atomic ticket, not from blockIdx, so a
//      block only ever waits on tiles whose blocks started before it, and
//      the look-back always makes progress;
//   2. each thread reads its 32 flags (two 16-byte loads where they lie
//      whole and aligned, a scalar edge otherwise) into a 32-bit mask; a
//      warp max-scan and one scan of the warp maxima give each thread the
//      last start before its run and the tile its last start (0 if none);
//   3. a tile that holds a start knows its inclusive result at once (its
//      last start lies past every earlier tile's keys) and publishes it as
//      an inclusive prefix before anything else; a tile without one
//      publishes an aggregate of 0. The status word is 64 bits, the flag in
//      the high half and the index in the low half, one release store, so a
//      flag is never seen without its value. Warp 0 then looks back over
//      the preceding tiles, 32 at a time, each lane spinning on one word
//      with an acquire load, to the nearest inclusive prefix; only a tile
//      whose first key is not a start needs it, and a tile without a start
//      publishes what it found as its inclusive prefix;
//   4. the gather is fused: each thread writes its keys' last starts into
//      padded shared memory, and the block then writes out[i] =
//      values[last(i)] in coalesced rows, so no per-key index array reaches
//      device memory;
//   5. each block then counts itself done; the last one zeroes the status
//      words and the two counters, so the scratch is left as it was found:
//      all zero (the wrapper keeps one per stream and never zeroes it).
// Long runs without a start (the sentinel group of invalid keys at the end
// of a densify grouping spans thousands of tiles): each such tile publishes
// its aggregate before it waits and its inclusive prefix as soon as it has
// one, so a look-back passes only tiles whose blocks are still in flight
// (at most the card's resident blocks, a few windows of 32) before it meets
// an inclusive prefix.
// The output is exact: every step is an integer max or a copy, so it is
// bit-equal to the plain version's, whatever order the blocks run in.
//
// Bound: bytes. At most 17 bytes a key: the flag (1), the carried value (at
// most 8, read once where every key starts a group, from cache where a group
// is long) and the output (at most 8); the status words add 8 bytes per 8192
// keys. At 3.35 TB/s that is 0.12 ms for 24M keys and 0.012 ms for 2.4M.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 32;                        // keys a thread
constexpr int kBlock = kThreads * kItems;         // 8192 a tile
constexpr int kPadded = kBlock + kBlock / 32;     // one pad word per 32
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kAggregate = 1ull << 32;   // status flags
constexpr unsigned long long kInclusive = 2ull << 32;

// Shared-memory index with one pad word every 32, so that thread t storing
// key t * 32 + i, and thread t reading key k * 256 + t, meet no bank
// conflict.
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

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

// Four flag bytes as four bits, byte b to bit b: __vcmpne4 makes each nonzero
// byte 0xff, the mask keeps its low bit, and the product gathers the four
// low bits into the top byte (no two partial products meet there).
__device__ __forceinline__ unsigned flag_bits(unsigned w) {
  return ((__vcmpne4(w, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

__device__ __forceinline__ int warp_inclusive_max(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = max(v, up);
  }
  return v;
}

// The exclusive max of `v` over the block's threads (0 for thread 0); *total
// gets the max of all of them. `warp_max` holds kWarps + 1 values. Ends with
// a barrier.
__device__ __forceinline__ int block_exclusive_max(int v, int* warp_max,
                                                   int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int inc = warp_inclusive_max(v, lane);
  int exc = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) exc = 0;
  if (lane == 31) warp_max[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? warp_max[lane] : 0;
    const int winc = warp_inclusive_max(w, lane);
    int wexc = __shfl_up_sync(kFull, winc, 1);
    if (lane == 0) wexc = 0;
    if (lane < kWarps) warp_max[lane] = wexc;
    if (lane == kWarps - 1) warp_max[kWarps] = winc;
  }
  __syncthreads();
  const int out = max(warp_max[warp], exc);
  *total = warp_max[kWarps];
  __syncthreads();
  return out;
}

// Warp 0 of tile `blk` (> 0): the last start before the tile, from the
// status words st[0 .. blk).
__device__ __forceinline__ int look_back(const unsigned long long* st,
                                         int blk, int lane) {
  int prefix = 0;
  for (int last = blk - 1;; last -= 32) {
    const int t = last - lane;                    // lane 0 the nearest
    unsigned long long s = kInclusive;            // before the first tile: 0
    if (t >= 0) {
      do {
        s = load_acquire(st + t);
      } while ((s >> 32) == 0);
    }
    const unsigned inclusive = __ballot_sync(kFull, (s >> 32) == 2);
    // lanes past the nearest inclusive prefix add nothing
    const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
    int v = lane <= stop ? static_cast<int>(static_cast<unsigned>(s)) : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v = max(v, __shfl_down_sync(kFull, v, d));
    prefix = max(prefix, __shfl_sync(kFull, v, 0));
    if (inclusive) return prefix;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
carry_tiles(const uint8_t* __restrict__ is_start, const T* __restrict__ values,
            T* __restrict__ out, unsigned long long* __restrict__ status,
            unsigned* __restrict__ counters, long long n) {
  __shared__ int s_last[kPadded];
  __shared__ int warp_max[kWarps + 1];
  __shared__ int s_tile;
  __shared__ int s_carry;
  __shared__ bool s_done;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {                          // the ticket
    s_tile = static_cast<int>(atomicAdd(counters, 1u));
  }
  __syncthreads();
  const int blk = s_tile;
  const long long base = static_cast<long long>(blk) * kBlock;
  const long long first = base + threadIdx.x * kItems;   // this thread's run

  unsigned mask = 0;                               // bit i: key first + i
  if (first + kItems <= n &&
      (reinterpret_cast<uintptr_t>(is_start) & 15) == 0) {
    const uint4* p = reinterpret_cast<const uint4*>(is_start + first);
    const uint4 a = __ldg(p);
    const uint4 b = __ldg(p + 1);
    mask = flag_bits(a.x) | flag_bits(a.y) << 4 | flag_bits(a.z) << 8 |
           flag_bits(a.w) << 12 | flag_bits(b.x) << 16 |
           flag_bits(b.y) << 20 | flag_bits(b.z) << 24 |
           flag_bits(b.w) << 28;
  } else {                                         // the scalar edge
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (first + i < n && is_start[first + i]) mask |= 1u << i;
    }
  }
  const int thread_last =
      mask ? static_cast<int>(first) + 31 - __clz(static_cast<int>(mask)) : 0;
  int tile_last;
  const int before = block_exclusive_max(thread_last, warp_max, &tile_last);

  if (threadIdx.x < 32) {
    int carry = 0;
    const bool head = __shfl_sync(kFull, mask & 1u, 0) != 0;  // key `base`
    if (blk == 0) {
      if (lane == 0) {
        store_release(status, kInclusive | static_cast<unsigned>(tile_last));
      }
    } else {
      if (lane == 0) {
        store_release(status + blk, (tile_last ? kInclusive : kAggregate) |
                                        static_cast<unsigned>(tile_last));
      }
      if (!head) {                 // keys before the tile's first start
        carry = look_back(status, blk, lane);
        if (!tile_last && lane == 0) {
          store_release(status + blk,
                        kInclusive | static_cast<unsigned>(carry));
        }
      }
    }
    if (lane == 0) s_carry = carry;
  }
  __syncthreads();

  int run = max(s_carry, before);
  const int own = threadIdx.x * kItems;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if ((mask >> i) & 1u) run = static_cast<int>(first) + i;
    s_last[pad(own + i)] = run;
  }
  __syncthreads();

#pragma unroll 4
  for (int k = 0; k < kItems; ++k) {               // coalesced rows
    const int j = k * kThreads + threadIdx.x;
    if (base + j < n) out[base + j] = __ldg(values + s_last[pad(j)]);
  }

  // the last block done leaves the scratch zeroed for the next call
  if (threadIdx.x == 0) {
    __threadfence();
    s_done = atomicAdd(counters + 1, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (s_done) {
    for (unsigned t = threadIdx.x; t < gridDim.x; t += kThreads) {
      status[t] = 0;
    }
    if (threadIdx.x == 0) counters[0] = counters[1] = 0;
  }
}

template <typename T>
int run(const void* is_start, const void* values, void* out, void* scratch,
        long long n, void* stream) {
  if (n <= 0) return 0;
  const long long n_tiles = (n + kBlock - 1) / kBlock;
  unsigned long long* words = static_cast<unsigned long long*>(scratch);
  carry_tiles<T><<<static_cast<unsigned>(n_tiles), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(is_start), static_cast<const T*>(values),
      static_cast<T*>(out), words + 1, reinterpret_cast<unsigned*>(words), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// is_start: [n] bool (one byte a key); values, out: [n] of the function's
// type; n < 2^31; scratch: at least ceil(n / 8192) + 1 64-bit words, all
// zero (the ticket and the done count, then the tiles' status words), left
// all zero. Returns the CUDA error of the launch (0 on success).
extern "C" int segmented_carry_i32(const void* is_start, const void* values,
                                   void* out, void* scratch, long long n,
                                   void* stream) {
  return run<int>(is_start, values, out, scratch, n, stream);
}

extern "C" int segmented_carry_i64(const void* is_start, const void* values,
                                   void* out, void* scratch, long long n,
                                   void* stream) {
  return run<long long>(is_start, values, out, scratch, n, stream);
}
