// K4: the tile-blend forward K1 in five cumulative stages, for Hopper
// (sm_90a).
//
// Replaces scripts/kvariants.py::make_kernel (run by run_variant), the TPU
// lab that builds the Pallas forward up stage by stage to see where its time
// goes. Here each level is a stage of K1's design as it stands
// (ops/rasterize/csrc/blend_forward.cu): one 256-thread block per 16x16
// tile, each warp 8x4 of its pixels, the tile's instances staged 256 at a
// time into 48-byte shared records; the thread that stages an instance
// computes its alpha footprint and tau and from the box the mask of the
// warps it meets; each warp compacts the batch into its own list (one
// ballot and popcount per 32 instances) and walks that list only, skipping
// the exp where power < -tau.
//   level 0  reads the tile's bounds; writes rgb 0, T 1 and last_contrib 0.
//   level 1  + the batch loop and the row gather into the staged records.
//            Sink: rgb[c] += 1e-30 row[c] (mean x, mean y, conic a) of the
//            first instance of every 128-instance chunk of the tile: the
//            lab's chunk size, whatever the batch size.
//   level 2  + the footprint, the warp masks, the per-warp lists, and power,
//            expf and alpha on the listed pairs, with no early exit. Sink:
//            1e-30 sum(alpha) into each channel.
//   level 3  + T, the t_eps test, done, the block vote and last_contrib (the
//            list position). Sink: 1e-30 sum(alpha T) into each channel; T
//            and last_contrib are K1's.
//   level 4  + the colour: K1's function by K1's walk.
// Every pair the cull drops has alpha < 1/255, which each level skips
// anyway, and each pixel meets its pairs in list order, so every level
// computes bit for bit what the same level of the previous design did (one
// thread a pixel, each walking every listed instance). The loop is a copy of
// K1's, not a shared header: the build hashes only this file, so an edited
// header would not rebuild it. chip_smoke.py holds level 4 equal to K1 bit
// for bit, which catches drift between the copies.
//
// Staging: the one change from K1. K1 starts each batch with a barrier and
// then has every thread wait on a dependent gather (id, then row) before
// the walk can start. Here the gather is asynchronous and double-buffered,
// the Pallas lab's chunk DMA (scripts/kvariants.py:62-67, 78-84) on this
// card: while the warps walk batch b, the row gather of batch b+1 lands in
// the other buffer by cp.async (cp.async.ca.shared.global, 4 bytes; nine
// copies an instance, straight into the fields of its record). Batch b+1's
// ids are loaded a whole walk earlier, so their loads do not serialise with
// the copies. After its copies land the staging thread computes tau and the
// warp mask from the record. The copies into a buffer start only after the
// barrier that ends the walk of the batch that last used it, and the block
// waits for all its copies before it ends. TMA and cp.async.bulk do not fit:
// a row is 36 bytes, gathered by id, and they need 16-byte-aligned
// addresses and sizes and strides that are multiples of 16 bytes.
// Shared memory: two buffers of 256 records and 256 masks and one set of
// warp lists, 27,136 bytes a block, so that 8 blocks (2048 threads) fit in
// the SM's 228 KB with the 1 KB each block reserves, as K1 keeps.
//
// Bound: levels 0-1 by bytes (the bounds and the outputs; level 1 also the
// listed ids and the rows they name); levels 2-4 by the work of the pairs
// that reach alpha >= 1/255, as K1's bound counts it: their power and, on
// the special-function units, their exp.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;      // pixels of a tile, threads a block
constexpr int kRow = 9;                  // mean xy, conic abc, opacity, rgb
constexpr int kBatch = 256;              // instances staged at a time
constexpr int kChunk = 128;              // the TPU lab's chunk of instances
constexpr unsigned kFull = 0xffffffffu;
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kMaxAlpha = 0.99f;
constexpr float kSink = 1e-30f;
// alpha_footprint's margins, as ops/rasterize/common.py's FOOTPRINT_*
constexpr float kTauSlack = 1e-4f;
constexpr float kDetShrink = 0.99999f;   // 1 - FOOTPRINT_DET_SLACK
constexpr float kMargin = 1.0f;
// K1's warp geometry: a warp's pixels are kWarpW wide and kWarpH tall
constexpr int kWarpW = 8;
constexpr int kWarpH = 32 / kWarpW;
constexpr int kWarps = kPix / 32;
constexpr int kWarpCols = kTile / kWarpW;
constexpr int kMinBlocks = 2048 / kPix;  // blocks an SM keeps, as K1
static_assert(kWarps <= 8, "a warp mask is one byte");

// power = -1/2 (a dx^2 + c dy^2) - b dx dy in the plain version's order,
// each product and sum rounded on its own (ops/rasterize/common.py::
// gaussian_power, one torch op at a time). Written as it reads, nvcc
// contracts it into FMAs, and a power an ulp apart flips alpha >= 1/255
// against the plain version: a pixel of a trained scene then moved by up to
// alpha·T (1.8e-3 on an H100). In this form alpha equals the plain
// version's.
__device__ __forceinline__ float gaussian_power(float dx, float dy, float a,
                                                float b, float c) {
  return __fsub_rn(
      __fmul_rn(-0.5f, __fadd_rn(__fmul_rn(__fmul_rn(a, dx), dx),
                                 __fmul_rn(__fmul_rn(c, dy), dy))),
      __fmul_rn(__fmul_rn(b, dx), dy));
}

// The box (x lo, x hi, y lo, y hi) of the pixels a splat may blend with
// alpha >= 1/255, and tau: a copy of ops/rasterize/common.py::
// alpha_footprint in the same float32 arithmetic. An empty box for an
// opacity under 1/255, an unbounded one for a conic that is not positive
// definite; NaN compares false, so it culls nothing.
__device__ __forceinline__ float4 alpha_footprint(float mx, float my,
                                                  float a, float b, float c,
                                                  float op, float* tau) {
  const float l = logf(255.0f * op);
  const float t = (l < 0.0f ? 0.0f : l) * (1.0f + kTauSlack) + kTauSlack;
  const float det = a * c * kDetShrink - b * b;
  float rx = sqrtf(2.0f * t * c / det) + kMargin;
  float ry = sqrtf(2.0f * t * a / det) + kMargin;
  if (!(det > 0.0f && a > 0.0f)) rx = ry = INFINITY;
  if (op < kAlphaEps) rx = ry = -INFINITY;
  *tau = t;
  return make_float4(mx - rx, mx + rx, my - ry, my + ry);
}

// An instance as the walk reads it: two 16-byte loads from one base for the
// power and the exp, a third for the colour of a blended pair.
struct alignas(16) Staged {
  float4 at;        // mean x, mean y, -tau, opacity
  float4 conic;     // a, b, c, (unused)
  float4 color;     // r, g, b, (unused)
};

// One of the two staging buffers.
struct Batch {
  Staged inst[kBatch];
  unsigned char warps[kBatch];          // bit w: the box meets warp w
};

// A block's shared memory, one base for the walk's loads.
struct Shared {
  Batch batch[2];
  unsigned char list[kWarps][kBatch];   // each warp's batch positions
};

__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `Pending` of this thread's committed groups are in
// flight
template <int Pending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

__device__ __forceinline__ void wait_all_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The nine values of row `id` into the fields of record `s`; at.z (-tau)
// is the staging thread's to write once they land.
__device__ __forceinline__ void stage_row(Staged* s, const float* rows,
                                          int id) {
  const float* r = rows + static_cast<long long>(id) * kRow;
  copy_async(&s->at.x, r);
  copy_async(&s->at.y, r + 1);
  copy_async(&s->conic.x, r + 2);
  copy_async(&s->conic.y, r + 3);
  copy_async(&s->conic.z, r + 4);
  copy_async(&s->at.w, r + 5);
  copy_async(&s->color.x, r + 6);
  copy_async(&s->color.y, r + 7);
  copy_async(&s->color.z, r + 8);
}

template <int Level>
__global__ void __launch_bounds__(kPix, kMinBlocks)
blend_variant_kernel(const float* __restrict__ rows,
                     const int* __restrict__ gauss_ids,
                     const int* __restrict__ tile_bounds,
                     int width, int height, int tiles_x, float t_eps,
                     float* __restrict__ rgb, float* __restrict__ final_t,
                     int* __restrict__ last_contrib) {
  __shared__ Shared sh;

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int wl = tid & 31;
  const int warp = tid >> 5;
  const int start = tile_bounds[tile];
  const int end = tile_bounds[tile + 1];
  const int tile_y0 = (tile / tiles_x) * kTile;

  const int px0 = (tile % tiles_x) * kTile + kWarpW * (warp % kWarpCols) +
                  wl % kWarpW;
  const int py0 = tile_y0 + kWarpH * (warp / kWarpCols) + wl / kWarpW;
  bool done = !(px0 < width && py0 < height);
  const float fx = static_cast<float>(px0);
  const float fy = static_cast<float>(py0);
  float T = 1.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  float sink = 0.0f;                     // levels 2 and 3
  int last_at = start - 1;               // index in gauss_ids of the last

  if constexpr (Level == 0) {
    last_at += min(end - start, 0);      // 0 for any list; reads the bounds
  } else {
    // batch 0 into buffer 0, and the ids of batch 1
    int id = start + tid < end ? gauss_ids[start + tid] : 0;
    if (start + tid < end) stage_row(&sh.batch[0].inst[tid], rows, id);
    commit_copies();
    id = start + kBatch + tid < end ? gauss_ids[start + kBatch + tid] : 0;

    int buf = 0;
    for (int base = start; base < end; base += kBatch, buf ^= 1) {
      // the barrier that ends the walk of the previous batch, which frees
      // the other buffer and the lists
      if constexpr (Level >= 3) {
        if (__syncthreads_count(done) == kPix) break;
      } else {
        __syncthreads();
      }
      // batch b+1 into the other buffer, in flight while this one is
      // walked; then the ids of batch b+2
      const int next = base + kBatch + tid;
      if (next < end) stage_row(&sh.batch[buf ^ 1].inst[tid], rows, id);
      commit_copies();
      id = next + kBatch < end ? gauss_ids[next + kBatch] : 0;
      wait_copies<1>();                  // this thread's batch b has landed
      Batch& cur = sh.batch[buf];
      if constexpr (Level >= 2) {
        if (base + tid < end) {
          Staged& s = cur.inst[tid];
          float tau;
          const float4 box = alpha_footprint(s.at.x, s.at.y, s.conic.x,
                                             s.conic.y, s.conic.z, s.at.w,
                                             &tau);
          const float x0 = static_cast<float>((tile % tiles_x) * kTile);
          const float y0 = static_cast<float>(tile_y0);
          unsigned warps = 0;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) {
            const float wx = x0 + kWarpW * (w % kWarpCols);
            const float wy = y0 + kWarpH * (w / kWarpCols);
            if (!(box.y < wx || box.x > wx + (kWarpW - 1) || box.w < wy ||
                  box.z > wy + (kWarpH - 1))) {
              warps |= 1u << w;
            }
          }
          cur.warps[tid] = static_cast<unsigned char>(warps);
          s.at.z = -tau;
        }
      }
      __syncthreads();
      const int n = min(kBatch, end - base);
      if constexpr (Level == 1) {
#pragma unroll
        for (int j = 0; j < kBatch; j += kChunk) {
          if (j < n) {
            cr += kSink * cur.inst[j].at.x;
            cg += kSink * cur.inst[j].at.y;
            cb += kSink * cur.inst[j].conic.x;
          }
        }
      } else {
        if (__all_sync(kFull, done)) continue;

        // this warp's list: the batch positions whose box meets its pixels
        unsigned char* list = sh.list[warp];
        int count = 0;
        for (int k = 0; k < n; k += 32) {
          const int j = k + wl;
          const bool hit = j < n && ((cur.warps[j] >> warp) & 1u);
          const unsigned ballot = __ballot_sync(kFull, hit);
          if (hit) {
            list[count + __popc(ballot & ((1u << wl) - 1u))] =
                static_cast<unsigned char>(j);
          }
          count += __popc(ballot);
        }
        __syncwarp();

        for (int t = 0; t < count; ++t) {
          if (done) break;               // the warp leaves with its last lane
          const int j = list[t];
          const float4 at = cur.inst[j].at;
          const float4 co = cur.inst[j].conic;
          const float dx = at.x - fx;
          const float dy = at.y - fy;
          const float power = gaussian_power(dx, dy, co.x, co.y, co.z);
          if (power > 0.0f || power < at.z) continue;
          const float alpha = fminf(kMaxAlpha, at.w * expf(power));
          if (alpha < kAlphaEps) continue;
          if constexpr (Level == 2) {
            sink += alpha;
          } else {
            const float test_t = T * (1.0f - alpha);
            if (test_t < t_eps) {
              done = true;
              continue;
            }
            const float w = alpha * T;
            if constexpr (Level == 3) {
              sink += w;
            } else {
              const float4 col = cur.inst[j].color;
              cr += col.x * w;
              cg += col.y * w;
              cb += col.z * w;
            }
            T = test_t;
            last_at = base + j;
          }
        }
      }
    }
    wait_all_copies();                   // no copy in flight at the end
  }
  if constexpr (Level == 2 || Level == 3) {
    cr = cg = cb = kSink * sink;
  }

  // the pixel again from its coordinates, exact in float32
  const int px = static_cast<int>(fx);
  const int py = static_cast<int>(fy);
  if (px < width && py < height) {
    const int i = py * width + px;
    const int plane = width * height;
    rgb[i] = cr;
    rgb[plane + i] = cg;
    rgb[2 * plane + i] = cb;
    final_t[i] = T;
    last_contrib[i] = last_at - start + 1;   // 1-based; 0 if none
  }
}

template <int Level>
int launch(const float* rows, const int* gauss_ids, const int* tile_bounds,
           int width, int height, int tiles_x, int n_tiles, float t_eps,
           float* rgb, float* final_t, int* last_contrib,
           cudaStream_t stream) {
  blend_variant_kernel<Level><<<n_tiles, kPix, 0, stream>>>(
      rows, gauss_ids, tile_bounds, width, height, tiles_x, t_eps, rgb,
      final_t, last_contrib);
  return static_cast<int>(cudaGetLastError());
}

template <int Level>
int blocks_per_sm(int* blocks) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, blend_variant_kernel<Level>, kPix, 0));
}

}  // namespace

// Launches level `level` (0-4) of K4 on `stream`; returns the cudaError_t of
// the launch (0 = ok). The arguments are K1's: rows [G,9] f32, gauss_ids [B]
// i32, tile_bounds [n_tiles+1] i32; rgb [3,H,W] f32, final_t [H,W] f32,
// last_contrib [H,W] i32.
extern "C" int blend_variant(int level, const float* rows,
                             const int* gauss_ids, const int* tile_bounds,
                             int width, int height, int tiles_x, int n_tiles,
                             float t_eps, float* rgb, float* final_t,
                             int* last_contrib, cudaStream_t stream) {
  switch (level) {
    case 0:
      return launch<0>(rows, gauss_ids, tile_bounds, width, height, tiles_x,
                       n_tiles, t_eps, rgb, final_t, last_contrib, stream);
    case 1:
      return launch<1>(rows, gauss_ids, tile_bounds, width, height, tiles_x,
                       n_tiles, t_eps, rgb, final_t, last_contrib, stream);
    case 2:
      return launch<2>(rows, gauss_ids, tile_bounds, width, height, tiles_x,
                       n_tiles, t_eps, rgb, final_t, last_contrib, stream);
    case 3:
      return launch<3>(rows, gauss_ids, tile_bounds, width, height, tiles_x,
                       n_tiles, t_eps, rgb, final_t, last_contrib, stream);
    case 4:
      return launch<4>(rows, gauss_ids, tile_bounds, width, height, tiles_x,
                       n_tiles, t_eps, rgb, final_t, last_contrib, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The blocks of level `level` an SM can hold, by the occupancy calculator,
// into *blocks; returns the cudaError_t of the query (0 = ok).
extern "C" int blend_variant_blocks_per_sm(int level, int* blocks) {
  switch (level) {
    case 0: return blocks_per_sm<0>(blocks);
    case 1: return blocks_per_sm<1>(blocks);
    case 2: return blocks_per_sm<2>(blocks);
    case 3: return blocks_per_sm<3>(blocks);
    case 4: return blocks_per_sm<4>(blocks);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
