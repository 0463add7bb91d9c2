// K2: tile-blend backward for Hopper (sm_90a).
//
// Replaces contextgs_tpu/ops/rasterize/tile_kernel.py::blend_backward_pallas
// (the Pallas TPU kernel _bwd_kernel / _bwd_one_tile). It computes the
// gradient of what K1 (csrc/blend_forward.cu) computes, which is the plain
// version ops/rasterize/reference.py::blend_tiles_reference: given the
// cotangents dL/d rgb [3,H,W] and dL/d final_T [H,W], it accumulates
// dL/d rows [G,9] (mean x, y, conic a, b, c, opacity, r, g, b). It does not
// follow the Pallas kernel's chunk-reset semantics: a pixel done is done.
//
// Per pixel and instance i of the tile's list, with T_i the transmittance
// before i, w_i = alpha_i T_i, C the pixel's rgb and S_i = sum_{j>i} c_j w_j:
//   dL/dc_i     = dL/dC w_i
//   dL/dalpha_i = T_i (c_i . dL/dC) - (S_i . dL/dC) / (1 - alpha_i)
//                 - dL/dT_final T_final / (1 - alpha_i)
// and through alpha = min(0.99, op exp(power)),
//   power = -1/2 (a dx^2 + c dy^2) - b dx dy,   dx = mean_x - px:
//   dL/dop = dL/dalpha G, dL/dpower = dL/dalpha op G, zero where the 0.99
//   clamp holds (op G > 0.99): these are the derivatives of the plain
//   version's formulas (ops/rasterize/common.py), not of the CUDA reference
//   rasterizer, which ignores the clamp and splits b symmetrically.
// Instances skipped by the forward (power > 0 or alpha < 1/255) and those
// after the pixel's last_contrib (excluded by the T test, or never reached)
// get no gradient.
//
// Design: one 256-thread block per 16x16 tile, one thread per pixel, as K1;
// each warp covers two pixel rows of the tile. The block walks its list up
// to the largest last_contrib of its pixels, staging instances 256 at a
// time in shared memory. Each pixel replays its list FRONT TO BACK with
// K1's exact product T *= 1 - alpha, so T_i equals K1's bit for bit, and
// takes S_i . dL/dC as (C . dL/dC) minus the running prefix of
// (c_j . dL/dC) w_j, with C the rgb K1 saved. The alternative, a
// back-to-front walk recovering T by division from final_T (the CUDA
// reference's way), divides by 1 - alpha down to 0.01 at every step and
// compounds the rounding of every later instance into T; the forward walk
// keeps T exact and puts the rounding in one subtraction whose error is
// bounded by |C . dL/dC| times float32 epsilon.
//
// The cull. Staging an instance also computes its alpha footprint
// (alpha_footprint below, a copy of ops/rasterize/common.py::
// alpha_footprint): a conservative pixel box of its alpha >= 1/255 region,
// and tau, such that every pixel K1 blends lies inside the box at a power
// >= -tau; and from the box, a mask of the warps whose 16x2 pixels it
// meets. A warp skips an instance whose bit is clear without a power, an
// exp or a vote (the test is warp-uniform); inside the box a lane skips the
// exp where power < -tau. K1 skips every such pair (alpha < 1/255: it
// continues without touching T), so the replay of T stays bit-equal to
// K1's and last_contrib keeps its meaning.
//
// The reduction. Where any lane of a warp blends, the warp sums the nine
// values of its 32 pixels by a reduce-scatter: at each of five steps a lane
// keeps half of the values it carries and sends its partner the other half
// (5 + 3 + 2 + 1 + 1 = 12 shuffles, against 9 x 5 for nine butterflies),
// so the nine sums end on nine lanes (kLeaders). Those store them in the
// warp's own slots of a shared [8 warps][64 instances][9] table: a plain
// store, since a warp meets an instance once (shared-memory float atomics
// are a compare-and-swap loop on this card). Every 64 instances the block
// flushes the table: each (instance, component) summed over the 8 warps
// and added to d_rows by one global atomicAdd where the sum is not 0, so a
// block adds an instance once where each of its warps used to.
//
// Bound: the float32 operations and exps of the blended pairs, the only
// pairs whose work the result needs (about 60 operations and one exp each),
// and the bytes; the walk still takes the power of the pairs inside the
// boxes up to last_contrib. Left for later: cp.async or TMA staging of the
// row gather, and balancing tiles of very different list lengths.
//
// Atomics add in a different order on every run, so d_rows is not
// bit-reproducible on the card.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;      // threads per block, one per pixel
constexpr int kRow = 9;                  // mean xy, conic abc, opacity, rgb
constexpr int kWarps = kPix / 32;        // each covers two rows of the tile
constexpr int kSub = 64;                 // instances between two flushes
constexpr unsigned kFull = 0xffffffffu;
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kMaxAlpha = 0.99f;
// alpha_footprint's margins, as ops/rasterize/common.py's FOOTPRINT_*
constexpr float kTauSlack = 1e-4f;
constexpr float kDetShrink = 0.99999f;   // 1 - FOOTPRINT_DET_SLACK
constexpr float kMargin = 1.0f;
// the lanes that end the reduce-scatter holding a sum: 0, 2, 4, 8, 10, 16,
// 18, 20 and 24, for components 0 to 8
constexpr unsigned kLeaders = 0x01150515u;

// power = -1/2 (a dx^2 + c dy^2) - b dx dy rounded as K1
// (csrc/blend_forward.cu) and the plain version round it, each product and
// sum on its own, so that the replay takes K1's alpha >= 1/255 decisions.
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

// One step of the reduce-scatter over lanes D apart: of the S values a
// lane carries in v[0 .. S), the lane with bit D clear keeps the first
// H = ceil(S / 2) and its partner the rest (padded with 0); each sends the
// half the other keeps and adds what it receives. H shuffles.
template <int S, int D>
__device__ __forceinline__ void halve(float (&v)[kRow], bool upper) {
  constexpr int H = (S + 1) / 2;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float hi = H + k < S ? v[H + k] : 0.0f;
    const float send = upper ? v[k] : hi;
    const float keep = upper ? hi : v[k];
    v[k] = keep + __shfl_xor_sync(kFull, send, D);
  }
}

__global__ void __launch_bounds__(kPix)
blend_backward_kernel(const float* __restrict__ rows,
                      const int* __restrict__ gauss_ids,
                      const int* __restrict__ tile_bounds,
                      const float* __restrict__ rgb,
                      const float* __restrict__ final_t,
                      const int* __restrict__ last_contrib,
                      const float* __restrict__ d_rgb,
                      const float* __restrict__ d_final_t,
                      int width, int height, int tiles_x, int row_offset,
                      float* __restrict__ d_rows) {
  __shared__ int s_id[kPix];
  __shared__ float2 s_xy[kPix];
  __shared__ float4 s_conic_op[kPix];
  __shared__ float s_col[3][kPix];
  __shared__ float s_ntau[kPix];
  __shared__ unsigned s_warps[kPix];     // bit w: the box meets warp w
  __shared__ float s_part[kWarps][kSub * kRow];   // each warp's sums
  __shared__ int s_range;

  const int tile = blockIdx.x;
  const int lane = threadIdx.x;
  const int wl = lane & 31;
  const int warp = lane >> 5;
  // a band's tiles start at tile row row_offset of the image (as K1's);
  // ly is the pixel's row in the band's cotangents and outputs
  const int x0 = (tile % tiles_x) * kTile;
  const int y0 = (row_offset + tile / tiles_x) * kTile;
  const int px = x0 + lane % kTile;
  const int py = y0 + lane / kTile;
  const int ly = py - row_offset * kTile;
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);
  // the component a leader lane sums in the reduce-scatter
  const int comp = 5 * ((wl >> 4) & 1) + 3 * ((wl >> 3) & 1) +
                   2 * ((wl >> 2) & 1) + ((wl >> 1) & 1);
  const bool leader = (kLeaders >> wl) & 1u;

  // per-pixel cotangents; pixels outside the image walk nothing
  int last = 0;
  float dr = 0.0f, dg = 0.0f, db = 0.0f;
  float q = 0.0f;     // C . dL/dC
  float gtf = 0.0f;   // dL/dT_final T_final
  if (px < width && ly < height) {
    const int p = ly * width + px;
    const int plane = width * height;
    last = last_contrib[p];
    dr = d_rgb[p];
    dg = d_rgb[plane + p];
    db = d_rgb[2 * plane + p];
    q = rgb[p] * dr + rgb[plane + p] * dg + rgb[2 * plane + p] * db;
    gtf = d_final_t[p] * final_t[p];
  }
  for (int k = lane; k < kWarps * kSub * kRow; k += kPix) {
    (&s_part[0][0])[k] = 0.0f;
  }

  // the block's range: the largest last_contrib of its pixels
  if (lane == 0) s_range = 0;
  __syncthreads();
  const int warp_last = __reduce_max_sync(kFull, last);
  if (wl == 0) atomicMax(&s_range, warp_last);
  __syncthreads();
  const int start = tile_bounds[tile];
  const int end = min(start + s_range, tile_bounds[tile + 1]);

  float T = 1.0f;
  float prefix = 0.0f;   // sum over blended j <= i of (c_j . dL/dC) w_j

  for (int base = start; base < end; base += kPix) {
    __syncthreads();     // the previous batch is consumed and flushed
    const int i = base + lane;
    if (i < end) {
      const int id = gauss_ids[i];
      const float* r = rows + static_cast<long long>(id) * kRow;
      const float mx = r[0], my = r[1];
      const float a = r[2], b = r[3], c = r[4], op = r[5];
      float tau;
      const float4 box = alpha_footprint(mx, my, a, b, c, op, &tau);
      // the warps whose pixels the box meets (the tile's columns, and
      // each warp's two rows)
      unsigned warps = 0;
      if (!(box.y < static_cast<float>(x0) ||
            box.x > static_cast<float>(x0 + kTile - 1))) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const float wy0 = static_cast<float>(y0 + 2 * w);
          if (!(box.w < wy0 || box.z > wy0 + 1.0f)) warps |= 1u << w;
        }
      }
      s_id[lane] = id;
      s_warps[lane] = warps;
      s_ntau[lane] = -tau;
      s_xy[lane] = make_float2(mx, my);
      s_conic_op[lane] = make_float4(a, b, c, op);
      s_col[0][lane] = r[6];
      s_col[1][lane] = r[7];
      s_col[2][lane] = r[8];
    }
    __syncthreads();
    const int n = min(kPix, end - base);
    for (int j0 = 0; j0 < n; j0 += kSub) {
      const int jn = min(n, j0 + kSub);
      for (int j = j0; j < jn; ++j) {
        if (!((s_warps[j] >> warp) & 1u)) continue;     // warp-uniform
        float g[kRow];
#pragma unroll
        for (int k = 0; k < kRow; ++k) g[k] = 0.0f;
        bool blended = false;
        if (base - start + j < last) {      // list position j+1 <= last
          const float dx = s_xy[j].x - fx;
          const float dy = s_xy[j].y - fy;
          const float4 co = s_conic_op[j];
          const float power = gaussian_power(dx, dy, co.x, co.y, co.z);
          if (power <= 0.0f && !(power < s_ntau[j])) {
            const float gauss = expf(power);
            const float raw = co.w * gauss;
            const float alpha = fminf(kMaxAlpha, raw);
            if (alpha >= kAlphaEps) {
              blended = true;
              const float w = alpha * T;
              const float u =
                  s_col[0][j] * dr + s_col[1][j] * dg + s_col[2][j] * db;
              prefix += u * w;
              const float one_m = 1.0f - alpha;
              const float inv = 1.0f / one_m;
              const float d_alpha = T * u - (q - prefix) * inv - gtf * inv;
              g[6] = dr * w;
              g[7] = dg * w;
              g[8] = db * w;
              if (raw <= kMaxAlpha) {
                const float d_power = d_alpha * raw;
                g[0] = d_power * (-co.x * dx - co.y * dy);
                g[1] = d_power * (-co.z * dy - co.y * dx);
                g[2] = -0.5f * d_power * dx * dx;
                g[3] = -d_power * dx * dy;
                g[4] = -0.5f * d_power * dy * dy;
                g[5] = d_alpha * gauss;
              }
              T = T * one_m;
            }
          }
        }
        if (__any_sync(kFull, blended)) {
          halve<9, 16>(g, wl & 16);
          halve<5, 8>(g, wl & 8);
          halve<3, 4>(g, wl & 4);
          halve<2, 2>(g, wl & 2);
          halve<1, 1>(g, wl & 1);
          if (leader) s_part[warp][(j - j0) * kRow + comp] = g[0];
        }
      }
      __syncthreads();   // every warp has written its sums of j0 .. jn
      // flush: each (instance, component) summed over the warps, one
      // global atomic where the sum is not 0; the slots are zeroed again
      for (int e = lane; e < (jn - j0) * kRow; e += kPix) {
        float v = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          v += s_part[w][e];
          s_part[w][e] = 0.0f;
        }
        if (v != 0.0f) {
          atomicAdd(d_rows + static_cast<long long>(s_id[j0 + e / kRow]) *
                                 kRow + e % kRow,
                    v);
        }
      }
      __syncthreads();   // the slots are zero before the next warps write
    }
  }
}

}  // namespace

// Launches K2 on `stream`; returns the cudaError_t of the launch (0 = ok).
// rows [G,9] f32, gauss_ids [B] i32, tile_bounds [n_tiles+1] i32; K1's
// rgb [3,H,W] f32, final_t [H,W] f32, last_contrib [H,W] i32; cotangents
// d_rgb [3,H,W] f32, d_final_t [H,W] f32; d_rows [G,9] f32, zeroed by the
// caller and accumulated here. With a band, the tiles start at tile row
// `row_offset` and H is the band's height, as in blend_forward.
extern "C" int blend_backward(const float* rows, const int* gauss_ids,
                              const int* tile_bounds, const float* rgb,
                              const float* final_t, const int* last_contrib,
                              const float* d_rgb, const float* d_final_t,
                              int width, int height, int tiles_x, int n_tiles,
                              int row_offset, float* d_rows,
                              cudaStream_t stream) {
  blend_backward_kernel<<<n_tiles, kPix, 0, stream>>>(
      rows, gauss_ids, tile_bounds, rgb, final_t, last_contrib, d_rgb,
      d_final_t, width, height, tiles_x, row_offset, d_rows);
  return static_cast<int>(cudaGetLastError());
}
