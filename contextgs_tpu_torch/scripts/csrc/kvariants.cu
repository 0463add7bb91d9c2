// K4: the tile-blend forward K1 in five cumulative stages, for Hopper
// (sm_90a).
//
// Replaces scripts/kvariants.py::make_kernel (run by run_variant), the TPU
// lab that builds the Pallas forward up stage by stage to see where its time
// goes. Here each level is a stage of K1's own loop
// (ops/rasterize/csrc/blend_forward.cu): one 256-thread block per 16x16
// tile, one thread per pixel, the tile's instances staged 256 at a time in
// shared memory.
//   level 0  reads the tile's bounds; writes rgb 0, T 1 and last_contrib 0.
//   level 1  + the batch loop and the row gather into shared memory. Sink:
//            rgb[c] += 1e-30 row[c] (mean x, mean y, conic a) of the first
//            instance of every 128-instance chunk of the tile: the lab's
//            chunk size, whatever the batch size.
//   level 2  + power, expf and alpha for every pair, with K1's skip rules.
//            Sink: 1e-30 sum(alpha) into each channel.
//   level 3  + T, the t_eps test, done, the block vote and last_contrib.
//            Sink: 1e-30 sum(alpha T) into each channel; T and
//            last_contrib are K1's.
//   level 4  + the colour: K1, instruction for instruction.
// The loop is a copy of K1's, not a shared header: the build hashes only
// this file, so an edited header would not rebuild it. chip_smoke.py holds
// level 4 equal to K1 bit for bit, which catches drift between the copies.
//
// Each sink costs one add per instance or chunk and keeps its level's work
// alive under -O3. Levels 1-3 also hand the shared arrays' addresses to an
// empty asm statement, so that the staging stores of fields the level never
// reads (the colours below level 4) are kept and every level gathers the
// whole row. Level 0 writes last_contrib = min(end - start, 0), which is 0
// for every list, so that the bounds are read: ptxas deletes a load whose
// value only an empty asm statement takes.
//
// Bound: level 0 by the bytes of the bounds and the outputs, level 1 by
// those and the gathered rows and ids; levels 2-4 by the exps on the
// special-function units, as K1.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;      // threads per block, one per pixel
constexpr int kRow = 9;                  // mean xy, conic abc, opacity, rgb
constexpr int kChunk = 128;              // the TPU lab's chunk of instances
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kMaxAlpha = 0.99f;
constexpr float kSink = 1e-30f;

// power = -1/2 (a dx^2 + c dy^2) - b dx dy rounded as K1
// (ops/rasterize/csrc/blend_forward.cu) rounds it, each product and sum on
// its own, so that level 4 stays bit-equal to K1.
__device__ __forceinline__ float gaussian_power(float dx, float dy, float a,
                                                float b, float c) {
  return __fsub_rn(
      __fmul_rn(-0.5f, __fadd_rn(__fmul_rn(__fmul_rn(a, dx), dx),
                                 __fmul_rn(__fmul_rn(c, dy), dy))),
      __fmul_rn(__fmul_rn(b, dx), dy));
}

template <int Level>
__global__ void __launch_bounds__(kPix)
blend_variant_kernel(const float* __restrict__ rows,
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
  float sink = 0.0f;                     // levels 2 and 3
  int contributor = 0;
  int last = 0;

  if constexpr (Level == 0) {
    last = min(end - start, 0);          // 0 for any list; reads the bounds
  } else {
    for (int base = start; base < end; base += kPix) {
      if constexpr (Level >= 3) {
        // also the barrier that protects the previous batch in shared memory
        if (__syncthreads_count(done) == kPix) break;
      } else {
        __syncthreads();
      }
      const int i = base + lane;
      if (i < end) {
        const float* r = rows + static_cast<long long>(gauss_ids[i]) * kRow;
        s_xy[lane] = make_float2(r[0], r[1]);
        s_conic_op[lane] = make_float4(r[2], r[3], r[4], r[5]);
        s_col[0][lane] = r[6];
        s_col[1][lane] = r[7];
        s_col[2][lane] = r[8];
      }
      if constexpr (Level < 4) {
        asm volatile("" ::"l"(reinterpret_cast<unsigned long long>(s_xy)),
                     "l"(reinterpret_cast<unsigned long long>(s_conic_op)),
                     "l"(reinterpret_cast<unsigned long long>(s_col))
                     : "memory");
      }
      __syncthreads();
      const int n = min(kPix, end - base);
      if constexpr (Level == 1) {
#pragma unroll
        for (int j = 0; j < kPix; j += kChunk) {
          if (j < n) {
            cr += kSink * s_xy[j].x;
            cg += kSink * s_xy[j].y;
            cb += kSink * s_conic_op[j].x;
          }
        }
      } else {
        for (int j = 0; !done && j < n; ++j) {
          if constexpr (Level >= 3) ++contributor;
          const float dx = s_xy[j].x - fx;
          const float dy = s_xy[j].y - fy;
          const float4 co = s_conic_op[j];
          const float power = gaussian_power(dx, dy, co.x, co.y, co.z);
          if (power > 0.0f) continue;
          const float alpha = fminf(kMaxAlpha, co.w * expf(power));
          if (alpha < kAlphaEps) continue;
          if constexpr (Level == 2) {
            sink += alpha;
          } else {
            const float test_t = T * (1.0f - alpha);
            if (test_t < t_eps) {
              done = true;
              break;
            }
            const float w = alpha * T;
            if constexpr (Level == 3) {
              sink += w;
            } else {
              cr += s_col[0][j] * w;
              cg += s_col[1][j] * w;
              cb += s_col[2][j] * w;
            }
            T = test_t;
            last = contributor;
          }
        }
      }
    }
  }
  if constexpr (Level == 2 || Level == 3) {
    cr = cg = cb = kSink * sink;
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
