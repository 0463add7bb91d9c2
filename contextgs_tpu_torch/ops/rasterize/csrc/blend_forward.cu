// K1: tile-blend forward for Hopper (sm_90a).
//
// Replaces contextgs_tpu/ops/rasterize/tile_kernel.py::blend_forward_pallas
// (:317; the Pallas TPU kernel _fwd_kernel / _fwd_one_tile). It computes what
// the plain version ops/rasterize/reference.py::blend_tiles_reference
// computes, which follows the CUDA reference rasterizer's renderCUDA: per
// pixel, walk the tile's depth-ordered instances front to back,
//   power = -1/2 (a dx^2 + c dy^2) - b dx dy,   skip if power > 0
//   alpha = min(0.99, opacity * exp(power)),    skip if alpha < 1/255
//   if T (1 - alpha) < t_eps the pixel is done for good (instance excluded)
//   rgb += color alpha T;  T *= 1 - alpha.
// Unlike the Pallas kernel, T is never reset, so a done pixel stays done.
//
// What bounds it. The result needs only the pairs whose alpha reaches 1/255
// (22% of a full-width serve view's listed (pixel, instance) pairs): their
// power, exp and blend. The previous design (one thread a pixel, its power
// rounded as here) walked every listed pair with every pixel of the tile,
// so it was held by the instruction rate of the walked pairs' power and exp
// (about 2.3 pairs an SM a clock against 16 exps), at 4.5% of the needed
// pairs' bound.
//
// Design. One 256-thread block per 16x16 tile, one thread a pixel; each warp
// covers kWarpW x kWarpH pixels (8x4: the tile is 2 x 4 such blocks), which
// a small splat meets fewer of than rows of 16x2. The tile's instances are
// staged in batches of 256 (gauss id -> row gather) into shared memory, one
// 48-byte record each, so that the walk reads a pair's inputs with two
// 16-byte loads from one base (a third, the colour, where it blends); and
// the thread that stages an instance also computes its alpha footprint
// (alpha_footprint below, a copy of ops/rasterize/common.py::
// alpha_footprint, as csrc/blend_backward.cu has it): a conservative pixel
// box of its alpha >= 1/255 region and tau, such that every pixel this
// kernel blends lies inside the box at a power >= -tau; and from the box a
// mask of the warps whose pixels it meets (a NaN box meets every warp).
// Each warp then compacts the batch into its own list: the positions of the
// instances whose mask holds its bit, in list order, by one ballot and
// popcount per 32 instances. It walks that list only, so it spends nothing
// on the instances that miss it. Inside the list a lane skips the exp where
// power < -tau. A lane leaves the walk when its pixel is done, a warp when
// its last lane does, and the block vote (__syncthreads_count) ends the
// tile once all its pixels are done.
//
// Registers. __launch_bounds__(256, 8) keeps 2048 threads an SM, as the
// previous design did, which caps a thread at 32 registers. Under that cap the
// walk's cost is its instruction count. With separate shared arrays, nvcc
// recomputed their addresses and the pixel's coordinates in every step of
// the walk (seen in the SASS). So the instances share one record array, one
// shared base with the lists, and the pixel's coordinates live only as
// floats, which leaves fewer values to keep across the walk.
//
// What must not change. Every pair culled is one the previous design
// skipped (alpha < 1/255: it went on without touching T), each pixel runs
// the same float32 expressions on the same instances in the same order (the
// power rounded op by op, plain expf, no fast math), and last_contrib is the
// list position (1-based) of the last instance blended, taken from the
// position and not from a count of instances walked. So rgb, final_T and
// last_contrib equal the previous design's bit for bit; chip_smoke.py holds
// them equal to K4's level 4 (scripts/csrc/kvariants.cu: this design with
// its row gather staged by cp.async, double-buffered).
//
// Left for later: a faster exp (changes bits), cp.async staging of the row
// gather, balancing tiles of very different list lengths.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;      // pixels of a tile
constexpr int kRow = 9;                  // mean xy, conic abc, opacity, rgb
constexpr int kBatch = 256;              // instances staged at a time
constexpr unsigned kFull = 0xffffffffu;
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kMaxAlpha = 0.99f;
// alpha_footprint's margins, as ops/rasterize/common.py's FOOTPRINT_*
constexpr float kTauSlack = 1e-4f;
constexpr float kDetShrink = 0.99999f;   // 1 - FOOTPRINT_DET_SLACK
constexpr float kMargin = 1.0f;
// The warp geometry: a warp's pixels are kWarpW wide; each thread takes
// kPerThread of them, kLaneRows rows and kWarpW / 2 columns (cyclically)
// apart. Two pixels of a thread share no dx or dy: a shared product would
// let nvcc contract their powers otherwise than a lone pixel's, and change
// the bits.
constexpr int kWarpW = 8;
constexpr int kPerThread = 1;
constexpr int kLaneRows = 32 / kWarpW;
constexpr int kWarpH = kLaneRows * kPerThread;
constexpr int kThreads = kPix / kPerThread;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpCols = kTile / kWarpW;
// blocks an SM keeps: 2048 threads, as many as the previous design kept
constexpr int kMinBlocks = 2048 / kThreads;
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

// A block's shared memory, one base for the walk's loads.
struct Shared {
  Staged inst[kBatch];
  unsigned char list[kWarps][kBatch];   // each warp's batch positions
  unsigned char warps[kBatch];          // bit w: the box meets warp w
};

__global__ void __launch_bounds__(kThreads, kMinBlocks)
blend_forward_kernel(const float* __restrict__ rows,
                     const int* __restrict__ gauss_ids,
                     const int* __restrict__ tile_bounds,
                     int width, int height, int tiles_x, int row_offset,
                     float t_eps, float* __restrict__ rgb,
                     float* __restrict__ final_t,
                     int* __restrict__ last_contrib) {
  __shared__ Shared sh;

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int wl = tid & 31;
  const int warp = tid >> 5;
  const int start = tile_bounds[tile];
  const int end = tile_bounds[tile + 1];
  // the tile's pixel rows in the image: a band's tiles start at tile row
  // row_offset, in integers, so that a pixel's float coordinates and its
  // dx, dy are those of the same pixel rendered without a band
  const int tile_y0 = (row_offset + tile / tiles_x) * kTile;
  const int band_y0 = row_offset * kTile;

  bool done[kPerThread];
  float fx[kPerThread], fy[kPerThread], T[kPerThread];
  float cr[kPerThread], cg[kPerThread], cb[kPerThread];
  int last_at[kPerThread];    // index in gauss_ids of the last blended
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int px = (tile % tiles_x) * kTile + kWarpW * (warp % kWarpCols) +
                   (wl + k * (kWarpW / 2)) % kWarpW;
    const int py = tile_y0 + kWarpH * (warp / kWarpCols) + wl / kWarpW +
                   k * kLaneRows;
    done[k] = !(px < width && py - band_y0 < height);
    fx[k] = static_cast<float>(px);
    fy[k] = static_cast<float>(py);
    T[k] = 1.0f;
    cr[k] = cg[k] = cb[k] = 0.0f;
    last_at[k] = start - 1;
  }

  for (int base = start; base < end; base += kBatch) {
    bool all_done = true;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) all_done = all_done && done[k];
    // also the barrier that protects the previous batch in shared memory
    if (__syncthreads_count(all_done) == kThreads) break;
#pragma unroll
    for (int s = 0; s < kBatch / kThreads; ++s) {
      const int j = tid + s * kThreads;
      if (base + j < end) {
        const float* r = rows + static_cast<long long>(gauss_ids[base + j]) *
                                    kRow;
        const float mx = r[0], my = r[1];
        const float a = r[2], b = r[3], c = r[4], op = r[5];
        float tau;
        const float4 box = alpha_footprint(mx, my, a, b, c, op, &tau);
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
        sh.warps[j] = static_cast<unsigned char>(warps);
        sh.inst[j].at = make_float4(mx, my, -tau, op);
        sh.inst[j].conic = make_float4(a, b, c, 0.0f);
        sh.inst[j].color = make_float4(r[6], r[7], r[8], 0.0f);
      }
    }
    __syncthreads();
    if (__all_sync(kFull, all_done)) continue;

    // this warp's list: the batch positions whose box meets its pixels
    const int n = min(kBatch, end - base);
    unsigned char* list = sh.list[warp];
    int count = 0;
    for (int k = 0; k < n; k += 32) {
      const int j = k + wl;
      const bool hit = j < n && ((sh.warps[j] >> warp) & 1u);
      const unsigned ballot = __ballot_sync(kFull, hit);
      if (hit) {
        list[count + __popc(ballot & ((1u << wl) - 1u))] =
            static_cast<unsigned char>(j);
      }
      count += __popc(ballot);
    }
    __syncwarp();

    for (int t = 0; t < count; ++t) {
      bool finished = true;
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) finished = finished && done[k];
      if (finished) break;               // the warp leaves with its last lane
      const int j = list[t];
      const float4 at = sh.inst[j].at;
      const float4 co = sh.inst[j].conic;
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        if (done[k]) continue;
        const float dx = at.x - fx[k];
        const float dy = at.y - fy[k];
        const float power = gaussian_power(dx, dy, co.x, co.y, co.z);
        if (power > 0.0f || power < at.z) continue;
        const float alpha = fminf(kMaxAlpha, at.w * expf(power));
        if (alpha < kAlphaEps) continue;
        const float test_t = T[k] * (1.0f - alpha);
        if (test_t < t_eps) {
          done[k] = true;
          continue;
        }
        const float w = alpha * T[k];
        const float4 col = sh.inst[j].color;
        cr[k] += col.x * w;
        cg[k] += col.y * w;
        cb[k] += col.z * w;
        T[k] = test_t;
        last_at[k] = base + j;
      }
    }
  }

  const int plane = width * height;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    // the pixel again from its coordinates, exact in float32; its row in
    // the band's outputs
    const int px = static_cast<int>(fx[k]);
    const int py = static_cast<int>(fy[k]) - band_y0;
    if (px < width && py < height) {
      const int i = py * width + px;
      rgb[i] = cr[k];
      rgb[plane + i] = cg[k];
      rgb[2 * plane + i] = cb[k];
      final_t[i] = T[k];
      last_contrib[i] = last_at[k] - start + 1;   // 1-based; 0 if none
    }
  }
}

}  // namespace

// Launches K1 on `stream`; returns the cudaError_t of the launch (0 = ok).
// rows [G,9] f32, gauss_ids [B] i32, tile_bounds [n_tiles+1] i32;
// rgb [3,H,W] f32, final_t [H,W] f32, last_contrib [H,W] i32. With a band
// (the Pallas kernel's row_offset), the tiles are the band's, starting at
// tile row `row_offset` of the image, and H is the band's height.
extern "C" int blend_forward(const float* rows, const int* gauss_ids,
                             const int* tile_bounds, int width, int height,
                             int tiles_x, int n_tiles, int row_offset,
                             float t_eps, float* rgb, float* final_t,
                             int* last_contrib, cudaStream_t stream) {
  blend_forward_kernel<<<n_tiles, kThreads, 0, stream>>>(
      rows, gauss_ids, tile_bounds, width, height, tiles_x, row_offset, t_eps,
      rgb, final_t, last_contrib);
  return static_cast<int>(cudaGetLastError());
}
