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
// Design: one 256-thread block per 16x16 tile, one thread per pixel, as K1.
// The block walks its list up to the largest last_contrib of its pixels,
// staging instances 256 at a time in shared memory. Each pixel replays its
// list FRONT TO BACK with K1's exact product T *= 1 - alpha, so T_i equals
// K1's bit for bit, and takes S_i . dL/dC as (C . dL/dC) minus the running
// prefix of (c_j . dL/dC) w_j, with C the rgb K1 saved. The alternative, a
// back-to-front walk recovering T by division from final_T (the CUDA
// reference's way), divides by 1 - alpha down to 0.01 at every step and
// compounds the rounding of every later instance into T; the forward walk
// keeps T exact and puts the rounding in one subtraction whose error is
// bounded by |C . dL/dC| times float32 epsilon. The nine per-pixel values of
// an instance are summed across each warp with __shfl_down_sync, and lane 0
// adds them to d_rows with one atomicAdd per component; a warp whose pixels
// all skip the instance adds nothing.
//
// Bound: the float32 operations over the (pixel, instance) pairs up to
// last_contrib (11 for each pair, about 50 more for a blended one) bound it
// on this card, ahead of the exps (one a pair, on the special-function
// units) and the bytes; the atomics into d_rows (nine per warp and instance
// blended) come on top of that bound. Left for later:
// cp.async or TMA staging of the row gather, fewer atomics (a block-level
// reduction, or a per-instance gradient table reduced by gaussian), and
// balancing tiles of very different list lengths.
//
// Atomics add in a different order on every run, so d_rows is not
// bit-reproducible on the card.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;      // threads per block, one per pixel
constexpr int kRow = 9;                  // mean xy, conic abc, opacity, rgb
constexpr unsigned kFull = 0xffffffffu;
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kMaxAlpha = 0.99f;

__global__ void __launch_bounds__(kPix)
blend_backward_kernel(const float* __restrict__ rows,
                      const int* __restrict__ gauss_ids,
                      const int* __restrict__ tile_bounds,
                      const float* __restrict__ rgb,
                      const float* __restrict__ final_t,
                      const int* __restrict__ last_contrib,
                      const float* __restrict__ d_rgb,
                      const float* __restrict__ d_final_t,
                      int width, int height, int tiles_x,
                      float* __restrict__ d_rows) {
  __shared__ int s_id[kPix];
  __shared__ float2 s_xy[kPix];
  __shared__ float4 s_conic_op[kPix];
  __shared__ float s_col[3][kPix];
  __shared__ int s_range;

  const int tile = blockIdx.x;
  const int lane = threadIdx.x;
  const int px = (tile % tiles_x) * kTile + lane % kTile;
  const int py = (tile / tiles_x) * kTile + lane / kTile;
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);

  // per-pixel cotangents; pixels outside the image walk nothing
  int last = 0;
  float dr = 0.0f, dg = 0.0f, db = 0.0f;
  float q = 0.0f;     // C . dL/dC
  float gtf = 0.0f;   // dL/dT_final T_final
  if (px < width && py < height) {
    const int p = py * width + px;
    const int plane = width * height;
    last = last_contrib[p];
    dr = d_rgb[p];
    dg = d_rgb[plane + p];
    db = d_rgb[2 * plane + p];
    q = rgb[p] * dr + rgb[plane + p] * dg + rgb[2 * plane + p] * db;
    gtf = d_final_t[p] * final_t[p];
  }

  // the block's range: the largest last_contrib of its pixels
  if (lane == 0) s_range = 0;
  __syncthreads();
  const int warp_last = __reduce_max_sync(kFull, last);
  if ((lane & 31) == 0) atomicMax(&s_range, warp_last);
  __syncthreads();
  const int start = tile_bounds[tile];
  const int end = min(start + s_range, tile_bounds[tile + 1]);

  float T = 1.0f;
  float prefix = 0.0f;   // sum over blended j <= i of (c_j . dL/dC) w_j

  for (int base = start; base < end; base += kPix) {
    __syncthreads();     // the previous batch is consumed
    const int i = base + lane;
    if (i < end) {
      const int id = gauss_ids[i];
      const float* r = rows + static_cast<long long>(id) * kRow;
      s_id[lane] = id;
      s_xy[lane] = make_float2(r[0], r[1]);
      s_conic_op[lane] = make_float4(r[2], r[3], r[4], r[5]);
      s_col[0][lane] = r[6];
      s_col[1][lane] = r[7];
      s_col[2][lane] = r[8];
    }
    __syncthreads();
    const int n = min(kPix, end - base);
    for (int j = 0; j < n; ++j) {
      float g[kRow];
#pragma unroll
      for (int k = 0; k < kRow; ++k) g[k] = 0.0f;
      bool blended = false;
      if (base - start + j < last) {        // list position j+1 <= last
        const float dx = s_xy[j].x - fx;
        const float dy = s_xy[j].y - fy;
        const float4 co = s_conic_op[j];
        const float power =
            -0.5f * (co.x * dx * dx + co.z * dy * dy) - co.y * dx * dy;
        if (power <= 0.0f) {
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
#pragma unroll
        for (int k = 0; k < kRow; ++k) {
          float v = g[k];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v += __shfl_down_sync(kFull, v, off);
          g[k] = v;
        }
        if ((lane & 31) == 0) {
          float* out = d_rows + static_cast<long long>(s_id[j]) * kRow;
#pragma unroll
          for (int k = 0; k < kRow; ++k) atomicAdd(out + k, g[k]);
        }
      }
    }
  }
}

}  // namespace

// Launches K2 on `stream`; returns the cudaError_t of the launch (0 = ok).
// rows [G,9] f32, gauss_ids [B] i32, tile_bounds [n_tiles+1] i32; K1's
// rgb [3,H,W] f32, final_t [H,W] f32, last_contrib [H,W] i32; cotangents
// d_rgb [3,H,W] f32, d_final_t [H,W] f32; d_rows [G,9] f32, zeroed by the
// caller and accumulated here.
extern "C" int blend_backward(const float* rows, const int* gauss_ids,
                              const int* tile_bounds, const float* rgb,
                              const float* final_t, const int* last_contrib,
                              const float* d_rgb, const float* d_final_t,
                              int width, int height, int tiles_x, int n_tiles,
                              float* d_rows, cudaStream_t stream) {
  blend_backward_kernel<<<n_tiles, kPix, 0, stream>>>(
      rows, gauss_ids, tile_bounds, rgb, final_t, last_contrib, d_rgb,
      d_final_t, width, height, tiles_x, d_rows);
  return static_cast<int>(cudaGetLastError());
}
