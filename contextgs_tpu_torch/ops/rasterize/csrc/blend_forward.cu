// K1: tile-blend forward for Hopper (sm_90a).
//
// Replaces contextgs_tpu/ops/rasterize/tile_kernel.py::blend_forward_pallas
// (the Pallas TPU kernel _fwd_kernel / _fwd_one_tile). It computes what the
// plain version ops/rasterize/reference.py::blend_tiles_reference computes,
// which follows the CUDA reference rasterizer's renderCUDA: per pixel, walk
// the tile's depth-ordered instances front to back,
//   power = -1/2 (a dx^2 + c dy^2) - b dx dy,   skip if power > 0
//   alpha = min(0.99, opacity * exp(power)),    skip if alpha < 1/255
//   if T (1 - alpha) < t_eps the pixel is done for good (instance excluded)
//   rgb += color alpha T;  T *= 1 - alpha.
// Unlike the Pallas kernel, T is never reset, so a done pixel stays done.
//
// Design: one 256-thread block per 16x16 tile, one thread per pixel. The
// tile's instances are staged in batches of 256 (gauss id -> row gather, one
// instance per thread) into shared memory; every thread then walks the batch.
// A block-wide vote (__syncthreads_count) ends the tile once all its pixels
// are done. Plain expf, no fast math, so the result stays within float32
// rounding of the plain version.
//
// Bound: exp and FMA throughput over the (pixel, instance) pairs the tile
// lists give (one exp and up to 22 float32 operations per pair), and the
// gather of 36-byte rows by gauss id. Faster staging (cp.async or TMA), a
// better work split across tiles of very different lengths, and fewer
// registers are left to a later change.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;      // threads per block, one per pixel
constexpr int kRow = 9;                  // mean xy, conic abc, opacity, rgb
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kMaxAlpha = 0.99f;

__global__ void __launch_bounds__(kPix)
blend_forward_kernel(const float* __restrict__ rows,
                     const int* __restrict__ gauss_ids,
                     const int* __restrict__ tile_bounds,
                     int width, int height, int tiles_x, float t_eps,
                     float* __restrict__ rgb, float* __restrict__ final_t,
                     int* __restrict__ last_contrib) {
  __shared__ float2 s_xy[kPix];
  __shared__ float4 s_conic_op[kPix];
  __shared__ float s_col[3][kPix];

  const int tile = blockIdx.x;
  const int lane = threadIdx.x;
  const int px = (tile % tiles_x) * kTile + lane % kTile;
  const int py = (tile / tiles_x) * kTile + lane / kTile;
  const bool inside = px < width && py < height;
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);

  const int start = tile_bounds[tile];
  const int end = tile_bounds[tile + 1];

  bool done = !inside;
  float T = 1.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  int contributor = 0;
  int last = 0;

  for (int base = start; base < end; base += kPix) {
    // also the barrier that protects the previous batch in shared memory
    if (__syncthreads_count(done) == kPix) break;
    const int i = base + lane;
    if (i < end) {
      const float* r = rows + static_cast<long long>(gauss_ids[i]) * kRow;
      s_xy[lane] = make_float2(r[0], r[1]);
      s_conic_op[lane] = make_float4(r[2], r[3], r[4], r[5]);
      s_col[0][lane] = r[6];
      s_col[1][lane] = r[7];
      s_col[2][lane] = r[8];
    }
    __syncthreads();
    const int n = min(kPix, end - base);
    for (int j = 0; !done && j < n; ++j) {
      ++contributor;
      const float dx = s_xy[j].x - fx;
      const float dy = s_xy[j].y - fy;
      const float4 co = s_conic_op[j];
      const float power =
          -0.5f * (co.x * dx * dx + co.z * dy * dy) - co.y * dx * dy;
      if (power > 0.0f) continue;
      const float alpha = fminf(kMaxAlpha, co.w * expf(power));
      if (alpha < kAlphaEps) continue;
      const float test_t = T * (1.0f - alpha);
      if (test_t < t_eps) {
        done = true;
        break;
      }
      const float w = alpha * T;
      cr += s_col[0][j] * w;
      cg += s_col[1][j] * w;
      cb += s_col[2][j] * w;
      T = test_t;
      last = contributor;
    }
  }

  if (inside) {
    const int p = py * width + px;
    const int plane = width * height;
    rgb[p] = cr;
    rgb[plane + p] = cg;
    rgb[2 * plane + p] = cb;
    final_t[p] = T;
    last_contrib[p] = last;
  }
}

}  // namespace

// Launches K1 on `stream`; returns the cudaError_t of the launch (0 = ok).
// rows [G,9] f32, gauss_ids [B] i32, tile_bounds [n_tiles+1] i32;
// rgb [3,H,W] f32, final_t [H,W] f32, last_contrib [H,W] i32.
extern "C" int blend_forward(const float* rows, const int* gauss_ids,
                             const int* tile_bounds, int width, int height,
                             int tiles_x, int n_tiles, float t_eps, float* rgb,
                             float* final_t, int* last_contrib,
                             cudaStream_t stream) {
  blend_forward_kernel<<<n_tiles, kPix, 0, stream>>>(
      rows, gauss_ids, tile_bounds, width, height, tiles_x, t_eps, rgb,
      final_t, last_contrib);
  return static_cast<int>(cudaGetLastError());
}
