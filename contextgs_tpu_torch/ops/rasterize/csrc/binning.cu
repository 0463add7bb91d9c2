// The tile binning for Hopper (sm_90a): every gaussian's tile instances,
// sorted by (tile, depth), and each tile's range in that list.
//
// Replaces no Pallas kernel: the JAX package leaves the binning to XLA's
// sorts and gathers (contextgs_tpu/ops/rasterize/sorting.py::
// expand_and_sort). Its plain version in this package is
// ops/rasterize/sorting.py::expand_and_sort_plain, about fifty PyTorch ops
// over int64 arrays with a row per tile instance, three read-backs (the
// demand, and bincount's least and greatest tile), a gather of the rects
// that PyTorch runs one block per row, and a second sort over 64-bit keys.
// The outputs here are the chain's, equal as integers: gauss_ids,
// tile_bounds, the demand and n_vis.
//
// The design is 3DGS's own rasterizer (duplicateWithKeys, a radix sort over
// the bits the keys use, identifyTileRanges) in this port's two-sort order:
//   depth pass (bin_depth_pass), one read-back after it:
//     1. depth_keys_kernel: key = depth where n_tiles > 0, +inf elsewhere
//        (NaN made one NaN, -0 made +0, so the order is torch.sort's), and
//        the gaussian ids 0..G-1 as int32 values;
//     2. CUB's DeviceRadixSort::SortPairs over the 32-bit float keys: a
//        stable LSD sort, so ties keep index order, as torch.sort(stable)
//        does;
//     3. depth_counts_kernel: n_tiles gathered into depth order, and the
//        number of gaussians with tiles (n_vis) and of instances (the
//        demand, 64-bit) summed by one atomic each a block;
//     4. CUB's DeviceScan::InclusiveSum of the counts in int32 (the caller
//        reads the 64-bit demand back and refuses one that int32 cannot
//        address, so the scan never wraps).
//   tile pass (bin_tile_pass):
//     5. duplicate_kernel: each instance's local tile id and gaussian id
//        (int32 both) written at its offset, the rect walked row-major as
//        the chain's k walks it;
//     6. CUB's SortPairs over the low `bits` bits of the tile ids only
//        (ceil(log2(n_tiles)): 13 at 1920x1080, 12 at 1237x822 and 980x545,
//        two 8-bit passes): stable, so the depth order holds within a
//        tile, and its values are gauss_ids;
//     7. ranges_kernel: tile_bounds from the sorted tile ids; instance i is
//        the start of every tile in (key[i-1], key[i]], instance 0 of every
//        tile up to key[0], and B ends every tile after key[B-1]. No
//        histogram, no atomics, no read-back; B = 0 gives all zeros.
//
// What bounds it. The work a view needs is to read each gaussian slot once
// (depth, tile count, both rects: 24 B) and to write each instance once
// (4 B of gauss_ids) and each tile's bound: 0.05 ms at 3.35 TB/s for the
// fly-in's top view (5.8M slots, 7.38M instances). The two sorts add their
// passes on top: four over the slots (32-bit depth keys) and two over the
// instances, each reading and writing key and value. The chain's costs were
// not bytes: its rect gather ran one block (one thread) per instance row,
// and its histogram piled atomics on the hot centre tiles. Here every pass
// is coalesced, 32-bit, and one thread an element; the duplicate balances
// long rects by giving a warp 32 consecutive gaussians in depth order and
// walking their instances 32 at a time, each lane finding its instance's
// gaussian by a binary search over the warp's 32 offsets (5 shuffles), so
// no thread walks a whole rect and every store is coalesced.
//
// Tile ids must lie in [0, n_tiles): the projection clamps every rect to
// the image or band, as the chain requires too (its bincount would grow
// past n_tiles otherwise). ranges_kernel clamps its writes to the bounds
// array whatever the keys hold.
//
// Each pass runs on the caller's stream, allocates nothing (the caller
// hands in one workspace, sized by the same function called with `need`),
// and never synchronises.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include <cub/device/device_radix_sort.cuh>
#include <cub/device/device_scan.cuh>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

inline unsigned blocks(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

inline size_t align_up(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

// The depth pass's arrays, one after another in the caller's workspace; the
// tile pass reads order, counts and incl from the same workspace.
struct DepthWork {
  float* keys;          // [G] depth keys, index order
  float* keys_sorted;   // [G]
  int* ids;             // [G] 0..G-1
  int* order;           // [G] gaussian id of each depth rank
  int* counts;          // [G] its tile count
  int* incl;            // [G] inclusive prefix sum of counts
  void* temp;           // CUB's scratch
};

DepthWork depth_layout(void* base, int n) {
  const size_t arr = align_up(static_cast<size_t>(n) * 4);
  char* p = static_cast<char*>(base);
  return DepthWork{reinterpret_cast<float*>(p),
                   reinterpret_cast<float*>(p + arr),
                   reinterpret_cast<int*>(p + 2 * arr),
                   reinterpret_cast<int*>(p + 3 * arr),
                   reinterpret_cast<int*>(p + 4 * arr),
                   reinterpret_cast<int*>(p + 5 * arr),
                   p + 6 * arr};
}

struct TileWork {
  unsigned* tiles;         // [B] tile id of each instance, depth order
  unsigned* tiles_sorted;  // [B]
  int* ids;                // [B] its gaussian id
  void* temp;              // CUB's scratch
};

TileWork tile_layout(void* base, int n) {
  const size_t arr = align_up(static_cast<size_t>(n) * 4);
  char* p = static_cast<char*>(base);
  return TileWork{reinterpret_cast<unsigned*>(p),
                  reinterpret_cast<unsigned*>(p + arr),
                  reinterpret_cast<int*>(p + 2 * arr), p + 3 * arr};
}

// torch.sort's order of the chain's key where(n_tiles > 0, depth, inf):
// every NaN above +inf, -0 tied with +0 (CUB orders the bits).
__device__ __forceinline__ float depth_key(float d, int c) {
  if (c <= 0) return INFINITY;
  if (isnan(d)) return __int_as_float(0x7fc00000);
  return d == 0.0f ? 0.0f : d;
}

__global__ void __launch_bounds__(kThreads)
depth_keys_kernel(const float* __restrict__ depths, long long ds,
                  const int* __restrict__ n_tiles, long long ns, int n,
                  float* __restrict__ keys, int* __restrict__ ids) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  keys[i] = depth_key(depths[i * ds], n_tiles[i * ns]);
  ids[i] = i;
}

// counts[i] = n_tiles[order[i]]; stats[0] += gaussians with tiles,
// stats[1] += instances, one atomic each a block
__global__ void __launch_bounds__(kThreads)
depth_counts_kernel(const int* __restrict__ order,
                    const int* __restrict__ n_tiles, long long ns, int n,
                    int* __restrict__ counts,
                    unsigned long long* __restrict__ stats) {
  __shared__ unsigned long long warp_sum[kWarps];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  int c = 0;
  if (i < n) {
    c = max(n_tiles[static_cast<long long>(order[i]) * ns], 0);
    counts[i] = c;
  }
  const int vis = __syncthreads_count(c > 0);
  unsigned long long s = static_cast<unsigned long long>(c);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) s += __shfl_down_sync(kFull, s, d);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += warp_sum[w];
    if (vis) atomicAdd(stats, static_cast<unsigned long long>(vis));
    if (t) atomicAdd(stats + 1, t);
  }
}

// A warp takes depth ranks base..base+31 and writes their instances, 32 at
// a time: instance j belongs to the first lane whose inclusive end exceeds
// j, found by a binary search over the lanes' ends (which never decrease).
__global__ void __launch_bounds__(kThreads)
duplicate_kernel(const int* __restrict__ order, const int* __restrict__ counts,
                 const int* __restrict__ incl, int n,
                 const int* __restrict__ rect_min, long long rmin_s,
                 const int* __restrict__ rect_max, long long rmax_s,
                 int tiles_x, int row_offset, unsigned* __restrict__ tiles,
                 int* __restrict__ ids) {
  const int lane = threadIdx.x & 31;
  const long long base =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) - lane;
  if (base >= n) return;                    // whole warps leave together
  const long long i = base + lane;
  const bool in = i < n;
  const int c = in ? counts[i] : 0;
  const int end = in ? incl[i] : INT_MAX;   // past the last rank: never <= j
  int g = 0, rx = 0, ry = 0, w = 1;
  if (c > 0) {
    g = order[i];
    rx = rect_min[g * rmin_s];
    ry = rect_min[g * rmin_s + 1] - row_offset;
    w = rect_max[g * rmax_s] - rx;
  }
  const int last = static_cast<int>(min(31LL, n - 1 - base));
  const int start = __shfl_sync(kFull, end - c, 0);
  const int stop = __shfl_sync(kFull, end, last);
  for (int j0 = start; j0 < stop; j0 += 32) {
    const int j = j0 + lane;
    int owner = 0;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1) {
      const int e = __shfl_sync(kFull, end, owner + step - 1);
      if (e <= j) owner += step;
    }
    const int o_end = __shfl_sync(kFull, end, owner);
    const int o_c = __shfl_sync(kFull, c, owner);
    const int o_g = __shfl_sync(kFull, g, owner);
    const int o_rx = __shfl_sync(kFull, rx, owner);
    const int o_ry = __shfl_sync(kFull, ry, owner);
    const int o_w = __shfl_sync(kFull, w, owner);
    if (j < stop) {
      const int k = j - (o_end - o_c);      // the cell in the owner's rect
      const int ty = k / o_w;
      tiles[j] = static_cast<unsigned>((o_ry + ty) * tiles_x + o_rx +
                                       (k - ty * o_w));
      ids[j] = o_g;
    }
  }
}

// Thread i in [0, B] writes i into bounds[t] for every tile t in
// (key[i-1], key[i]] (t from 0 for i = 0, up to n_tiles for i = B).
__global__ void __launch_bounds__(kThreads)
ranges_kernel(const unsigned* __restrict__ keys, int n, int n_tiles,
              int* __restrict__ bounds) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i > n) return;
  const long long lo = i == 0 ? 0 : static_cast<long long>(keys[i - 1]) + 1;
  const long long hi =
      i == n ? n_tiles : min(static_cast<long long>(keys[i]),
                             static_cast<long long>(n_tiles));
  for (long long t = lo; t <= hi; ++t) bounds[t] = static_cast<int>(i);
}

}  // namespace

// The depth pass over G gaussian slots. With `need` set: writes the
// workspace bytes it takes and launches nothing. Else: stats [2] int64 (n_vis,
// demand) zeroed and summed, and the workspace's order, counts and incl
// filled for bin_tile_pass.
extern "C" int bin_depth_pass(const float* depths, long long ds,
                              const int* n_tiles, long long ns, int n,
                              void* work, long long* need,
                              unsigned long long* stats,
                              cudaStream_t stream) {
  size_t sort_bytes = 0, scan_bytes = 0;
  if (n > 0) {
    cudaError_t err = cub::DeviceRadixSort::SortPairs(
        nullptr, sort_bytes, static_cast<const float*>(nullptr),
        static_cast<float*>(nullptr), static_cast<const int*>(nullptr),
        static_cast<int*>(nullptr), n);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cub::DeviceScan::InclusiveSum(nullptr, scan_bytes,
                                        static_cast<const int*>(nullptr),
                                        static_cast<int*>(nullptr), n);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t temp = std::max(sort_bytes, scan_bytes);
  if (need) {
    *need = static_cast<long long>(
        6 * align_up(static_cast<size_t>(n) * 4) + align_up(temp));
    return 0;
  }
  cudaError_t err = cudaMemsetAsync(stats, 0, 2 * sizeof(*stats), stream);
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  DepthWork w = depth_layout(work, n);
  depth_keys_kernel<<<blocks(n), kThreads, 0, stream>>>(depths, ds, n_tiles,
                                                        ns, n, w.keys, w.ids);
  err = cub::DeviceRadixSort::SortPairs(w.temp, sort_bytes, w.keys,
                                        w.keys_sorted, w.ids, w.order, n, 0,
                                        32, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  depth_counts_kernel<<<blocks(n), kThreads, 0, stream>>>(
      w.order, n_tiles, ns, n, w.counts, stats);
  err = cub::DeviceScan::InclusiveSum(w.temp, scan_bytes, w.counts, w.incl,
                                      n, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The tile pass over the B instances the depth pass counted. With `need`
// set: writes the workspace bytes it takes and launches nothing. Else:
// gauss_ids [B] and tile_bounds [n_tiles + 1], both int32.
extern "C" int bin_tile_pass(const void* depth_work, int n,
                             const int* rect_min, long long rmin_s,
                             const int* rect_max, long long rmax_s,
                             int tiles_x, int row_offset, int n_tiles,
                             int bits, int n_inst, void* work,
                             long long* need, int* gauss_ids,
                             int* tile_bounds, cudaStream_t stream) {
  size_t sort_bytes = 0;
  if (n_inst > 0) {
    cudaError_t err = cub::DeviceRadixSort::SortPairs(
        nullptr, sort_bytes, static_cast<const unsigned*>(nullptr),
        static_cast<unsigned*>(nullptr), static_cast<const int*>(nullptr),
        static_cast<int*>(nullptr), n_inst, 0, bits);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (need) {
    *need = static_cast<long long>(
        3 * align_up(static_cast<size_t>(n_inst) * 4) + align_up(sort_bytes));
    return 0;
  }
  if (n_inst > 0) {
    const DepthWork d = depth_layout(const_cast<void*>(depth_work), n);
    TileWork w = tile_layout(work, n_inst);
    duplicate_kernel<<<blocks(n), kThreads, 0, stream>>>(
        d.order, d.counts, d.incl, n, rect_min, rmin_s, rect_max, rmax_s,
        tiles_x, row_offset, w.tiles, w.ids);
    cudaError_t err = cub::DeviceRadixSort::SortPairs(
        w.temp, sort_bytes, w.tiles, w.tiles_sorted, w.ids, gauss_ids,
        n_inst, 0, bits, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    ranges_kernel<<<blocks(static_cast<long long>(n_inst) + 1), kThreads, 0,
                    stream>>>(w.tiles_sorted, n_inst, n_tiles, tile_bounds);
  } else {
    ranges_kernel<<<1, kThreads, 0, stream>>>(nullptr, 0, n_tiles,
                                              tile_bounds);
  }
  return static_cast<int>(cudaGetLastError());
}
