// The projection of 3D gaussians to the screen, its anchor-cull mode and its
// backward, for Hopper (sm_90a).
//
// Replaces the op chain of contextgs_tpu/ops/rasterize/projection.py::
// project_gaussians and visible_filter (plain jnp that XLA fuses on the TPU;
// there is no Pallas kernel). Its plain version in this package is
// ops/rasterize/projection.py::project_gaussians_plain, some 285 PyTorch
// ops a call (270 for the cull), each a kernel launch of its own on the
// card; the backward of that chain is some 456 more. Per gaussian it
// computes the view and clip products, the EWA covariance T Sigma T^T with
// the 1.3 tanfov clamp, the +0.3 dilation, det, conic and 3-sigma radius,
// ndc2Pix, the tile rect (opacity-aware ellipse bbox where opacities are
// given, else the 3-sigma square), the band clamp, and keep.
//
// What bounds it. One thread a gaussian, no reuse between gaussians: the
// forward reads about 45 B and writes 48 B a gaussian (93 MB at 1M
// gaussians, 28 us at 3.35 TB/s); the cull reads 25 B an anchor and writes
// one (5 MB over 200k anchors: the launch costs more); the backward reads
// about 60 B and writes 40 B. The work is a few hundred float operations a
// gaussian, far under the card's rate. So a call costs its launch, and the
// chain's hundreds of launches are what this design removes: one launch a
// call on each path (forward, cull, backward).
//
// Design. 256-thread blocks; the two camera matrices (transposed W2V and
// world->clip, row-vector convention [p,1] @ M) are read from device memory,
// through their strides, once a block into shared memory, so the host reads
// nothing back. Rows of
// means, scales and quats (and of the backward's cotangents) are read
// through a row stride, so a column slice such as scaling[:, :3] needs no
// copy. Every output goes straight into its own tensor.
//
// Rounding. The forward rounds op by op in the plain chain's order
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn: no contraction), with the
// plain chain's constants rounded to float32 as PyTorch rounds a Python
// scalar; a division by the tile size is a product with its reciprocal, as
// PyTorch divides by a host scalar on the card. The two [G,4] @ [4,4]
// products take the order of torch.matmul's float32 result on the card:
// the first product rounded, then one fma a term in k order (row_dot). So
// every integer decision (cull, radius, rect, tile count) is the plain
// chain's. The backward recomputes the forward's intermediates from the
// inputs (nothing is saved) and follows autograd of the plain chain: a
// clamp passes the gradient only inside [min, max], bounds included; a
// where() only to the branch it chose (safe z, safe det); the rect, radius
// and opacity paths carry none. Each gaussian's gradient is its own: no
// atomics.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// The plain chain's scalars, rounded to float32 on the host.
struct Consts {
  float focal_x, focal_y;      // width / (2 tanfovx), height / (2 tanfovy)
  float lim_x, lim_y;          // 1.3 tanfov
  float width, height;         // as floats
  float scale_mod;
  float tile, inv_tile;        // tile size and its float32 reciprocal
  int tiles_x, row_lo, row_hi; // rect clamps: x in [0, tiles_x], y band
};

struct Rows {
  const float* ptr;
  long long stride;            // elements between rows (columns contiguous)
  __device__ __forceinline__ float at(long long i, int j) const {
    return ptr[i * stride + j];
  }
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp with scalar bounds: NaN passes through
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
// torch.minimum: NaN wins
__device__ __forceinline__ float minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// column j of [x, y, z, 1] @ m (m row-major 4x4), in torch.matmul's order
__device__ __forceinline__ float row_dot(float x, float y, float z,
                                         const float* m, int j) {
  float acc = __fmul_rn(x, m[j]);
  acc = __fmaf_rn(y, m[4 + j], acc);
  acc = __fmaf_rn(z, m[8 + j], acc);
  return __fadd_rn(acc, m[12 + j]);
}

// The forward's values up to the 2D covariance, rounded as the plain chain.
struct Ewa {
  float v0, v1, z;             // view-space point
  float c0, c1, c3;            // clip-space x, y, w
  float pw;                    // 1 / (c3 + 1e-7)
  float safe_z, ux, uy, cx, cy, inv_z, inv_z2;
  float tx, ty;                // clamped view x, y
  float T[2][3];               // J Rv
  float q[4];                  // w, x, y, z
  float R[3][3], s[3], M[3][3];
  float C[3][3];               // Sigma (symmetric, full)
  float a, b, c, det;          // 2D covariance (+0.3) and its det
};

// quad(Ta, Tb) = Ta Sigma Tb^T written out as the plain chain sums it
__device__ __forceinline__ float quad(const float* Ta, const float* Tb,
                                      const float (*C)[3]) {
  float t = mul(mul(Ta[0], Tb[0]), C[0][0]);
  t = add(t, mul(mul(Ta[1], Tb[1]), C[1][1]));
  t = add(t, mul(mul(Ta[2], Tb[2]), C[2][2]));
  t = add(t, mul(add(mul(Ta[0], Tb[1]), mul(Ta[1], Tb[0])), C[0][1]));
  t = add(t, mul(add(mul(Ta[0], Tb[2]), mul(Ta[2], Tb[0])), C[0][2]));
  t = add(t, mul(add(mul(Ta[1], Tb[2]), mul(Ta[2], Tb[1])), C[1][2]));
  return t;
}

__device__ __forceinline__ void ewa(float px, float py, float pz,
                                    const float sc[3], const float q[4],
                                    const float* wv, const float* fp,
                                    const Consts& k, Ewa& e) {
  e.v0 = row_dot(px, py, pz, wv, 0);
  e.v1 = row_dot(px, py, pz, wv, 1);
  e.z = row_dot(px, py, pz, wv, 2);
  e.c0 = row_dot(px, py, pz, fp, 0);
  e.c1 = row_dot(px, py, pz, fp, 1);
  e.c3 = row_dot(px, py, pz, fp, 3);
  e.pw = dvd(1.0f, add(e.c3, 1e-7f));

  const float z = e.z;
  e.safe_z = fabsf(z) < 1e-6f ? 1e-6f : z;
  e.ux = dvd(e.v0, e.safe_z);
  e.uy = dvd(e.v1, e.safe_z);
  e.cx = clampf(e.ux, -k.lim_x, k.lim_x);
  e.cy = clampf(e.uy, -k.lim_y, k.lim_y);
  e.tx = mul(e.cx, z);
  e.ty = mul(e.cy, z);
  e.inv_z = dvd(1.0f, e.safe_z);
  e.inv_z2 = mul(e.inv_z, e.inv_z);
  const float fxi = mul(k.focal_x, e.inv_z);
  const float fyi = mul(k.focal_y, e.inv_z);
  const float gx = mul(mul(-k.focal_x, e.tx), e.inv_z2);
  const float gy = mul(mul(-k.focal_y, e.ty), e.inv_z2);
  // Rv[i][j] = wv[j][i]
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    e.T[0][j] = add(mul(fxi, wv[4 * j + 0]), mul(gx, wv[4 * j + 2]));
    e.T[1][j] = add(mul(fyi, wv[4 * j + 1]), mul(gy, wv[4 * j + 2]));
  }

  const float w = q[0], x = q[1], y = q[2], zq = q[3];
#pragma unroll
  for (int j = 0; j < 4; ++j) e.q[j] = q[j];
  e.R[0][0] = sub(1.0f, mul(2.0f, add(mul(y, y), mul(zq, zq))));
  e.R[0][1] = mul(2.0f, sub(mul(x, y), mul(w, zq)));
  e.R[0][2] = mul(2.0f, add(mul(x, zq), mul(w, y)));
  e.R[1][0] = mul(2.0f, add(mul(x, y), mul(w, zq)));
  e.R[1][1] = sub(1.0f, mul(2.0f, add(mul(x, x), mul(zq, zq))));
  e.R[1][2] = mul(2.0f, sub(mul(y, zq), mul(w, x)));
  e.R[2][0] = mul(2.0f, sub(mul(x, zq), mul(w, y)));
  e.R[2][1] = mul(2.0f, add(mul(y, zq), mul(w, x)));
  e.R[2][2] = sub(1.0f, mul(2.0f, add(mul(x, x), mul(y, y))));
#pragma unroll
  for (int j = 0; j < 3; ++j) e.s[j] = mul(sc[j], k.scale_mod);
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int j = 0; j < 3; ++j) e.M[r][j] = mul(e.R[r][j], e.s[j]);
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int l = r; l < 3; ++l) {
      const float v = add(add(mul(e.M[r][0], e.M[l][0]),
                              mul(e.M[r][1], e.M[l][1])),
                          mul(e.M[r][2], e.M[l][2]));
      e.C[r][l] = v;
      e.C[l][r] = v;
    }

  e.a = add(quad(e.T[0], e.T[0], e.C), 0.3f);
  e.b = quad(e.T[0], e.T[1], e.C);
  e.c = add(quad(e.T[1], e.T[1], e.C), 0.3f);
  e.det = sub(mul(e.a, e.c), mul(e.b, e.b));
}

// The forward after the covariance: conic, means2d, radius, rect, keep.
// `op` is NaN where no opacities are given (the 3-sigma rect).
struct Screen {
  float m0, m1, r;
  float conic[3];
  int rmin[2], rmax[2], n_tiles, radius;
  bool keep;
};

__device__ __forceinline__ void screen(const Ewa& e, const Consts& k,
                                       bool has_op, float op, bool valid,
                                       float op_min, Screen& o) {
  const bool det_ok = e.det > 0.0f;
  const float inv_det = dvd(1.0f, det_ok ? e.det : 1.0f);
  o.conic[0] = mul(e.c, inv_det);
  o.conic[1] = mul(-e.b, inv_det);
  o.conic[2] = mul(e.a, inv_det);

  const float mid = mul(0.5f, add(e.a, e.c));
  const float lam = add(mid, __fsqrt_rn(clamp_min(sub(mul(mid, mid), e.det),
                                                  0.1f)));
  o.r = ceilf(mul(3.0f, __fsqrt_rn(lam)));

  o.m0 = mul(sub(mul(add(mul(e.c0, e.pw), 1.0f), k.width), 1.0f), 0.5f);
  o.m1 = mul(sub(mul(add(mul(e.c1, e.pw), 1.0f), k.height), 1.0f), 0.5f);

  float rx = o.r, ry = o.r;
  if (has_op) {
    const float kk = __fsqrt_rn(clamp_min(
        mul(2.0f, logf(clamp_min(mul(255.0f, op), 1e-30f))), 0.0f));
    rx = minimum(ceilf(mul(kk, __fsqrt_rn(clamp_min(e.a, 0.0f)))), o.r);
    ry = minimum(ceilf(mul(kk, __fsqrt_rn(clamp_min(e.c, 0.0f)))), o.r);
  }
  // float -> int32 truncates toward zero (NaN gives 0), as .to(torch.int32)
  o.rmin[0] = clampi(static_cast<int>(mul(sub(o.m0, rx), k.inv_tile)), 0,
                     k.tiles_x);
  o.rmin[1] = clampi(static_cast<int>(mul(sub(o.m1, ry), k.inv_tile)),
                     k.row_lo, k.row_hi);
  o.rmax[0] = clampi(static_cast<int>(mul(
                         sub(add(add(o.m0, rx), k.tile), 1.0f), k.inv_tile)),
                     0, k.tiles_x);
  o.rmax[1] = clampi(static_cast<int>(mul(
                         sub(add(add(o.m1, ry), k.tile), 1.0f), k.inv_tile)),
                     k.row_lo, k.row_hi);

  bool keep = det_ok && e.z > 0.2f && valid;
  if (has_op) keep = keep && op >= op_min;
  const int n = keep ? (o.rmax[0] - o.rmin[0]) * (o.rmax[1] - o.rmin[1]) : 0;
  keep = keep && n > 0;
  o.keep = keep;
  o.radius = static_cast<int>(keep ? o.r : 0.0f);
  o.n_tiles = keep ? n : 0;
}

// a 4x4 camera matrix through its strides (a transposed array is a view)
struct Matrix {
  const float* ptr;
  long long s0, s1;
  __device__ __forceinline__ float at(int r, int c) const {
    return ptr[r * s0 + c * s1];
  }
};

struct Inputs {
  Rows means, scales, quats;   // quats.ptr null: identity rotation (cull)
  const float* opac;           // [G] or null
  long long opac_stride;
  const uint8_t* valid;        // [G] bool or null
  long long valid_stride;
  Matrix world_view, full_proj;
  long long n;
  float op_min;                // float32(1/255)
};

struct Outputs {
  float *means2d, *conics, *depths;      // [G,2], [G,3], [G]
  int *radii, *rect_min, *rect_max, *n_tiles;
  uint8_t* mask;                          // cull mode: [G] bool
};

__device__ __forceinline__ void load_camera(const Inputs& in, float* cam) {
  const int t = threadIdx.x;
  if (t < 32) {
    const Matrix& m = t < 16 ? in.world_view : in.full_proj;
    cam[t] = m.at((t & 15) >> 2, t & 3);
  }
  __syncthreads();
}

__device__ __forceinline__ void load_gaussian(const Inputs& in, long long i,
                                              float p[3], float sc[3],
                                              float q[4]) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    p[j] = in.means.at(i, j);
    sc[j] = in.scales.at(i, j);
  }
  if (in.quats.ptr) {
#pragma unroll
    for (int j = 0; j < 4; ++j) q[j] = in.quats.at(i, j);
  } else {
    q[0] = 1.0f;
    q[1] = q[2] = q[3] = 0.0f;
  }
}

template <bool kCull>
__global__ void __launch_bounds__(kThreads)
project_forward_kernel(Inputs in, Consts k, Outputs out) {
  __shared__ float cam[32];
  load_camera(in, cam);
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= in.n) return;
  float p[3], sc[3], q[4];
  load_gaussian(in, i, p, sc, q);
  Ewa e;
  ewa(p[0], p[1], p[2], sc, q, cam, cam + 16, k, e);
  const bool has_op = in.opac != nullptr;
  const float op = has_op ? in.opac[i * in.opac_stride] : 0.0f;
  const bool valid = in.valid ? in.valid[i * in.valid_stride] != 0 : true;
  Screen o;
  screen(e, k, has_op, op, valid, in.op_min, o);
  if (kCull) {
    out.mask[i] = o.radius > 0;
    return;
  }
  out.means2d[2 * i] = o.m0;
  out.means2d[2 * i + 1] = o.m1;
#pragma unroll
  for (int j = 0; j < 3; ++j) out.conics[3 * i + j] = o.conic[j];
  out.depths[i] = e.z;
  out.radii[i] = o.radius;
  out.rect_min[2 * i] = o.rmin[0];
  out.rect_min[2 * i + 1] = o.rmin[1];
  out.rect_max[2 * i] = o.rmax[0];
  out.rect_max[2 * i + 1] = o.rmax[1];
  out.n_tiles[i] = o.n_tiles;
}

struct Cotangents {
  Rows d_means2d, d_conics;    // [G,2], [G,3]; ptr null: no gradient
  const float* d_depths;       // [G] or null
  long long d_depths_stride;
};

struct Grads {
  float *means3d, *scales, *quats;  // [G,3], [G,3], [G,4]
};

// The gradient of means2d, conics and depths with respect to means3d,
// scales and quats, as autograd carries it through the plain chain.
__global__ void __launch_bounds__(kThreads)
project_backward_kernel(Inputs in, Consts k, Cotangents d, Grads g) {
  __shared__ float cam[32];
  load_camera(in, cam);
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= in.n) return;
  const float* wv = cam;
  const float* fp = cam + 16;
  float p[3], sc[3], q[4];
  load_gaussian(in, i, p, sc, q);
  Ewa e;
  ewa(p[0], p[1], p[2], sc, q, wv, fp, k, e);

  float g_v[3] = {0.0f, 0.0f, 0.0f};     // view x, y, z
  float g_c0 = 0.0f, g_c1 = 0.0f, g_c3 = 0.0f;
  float gT[2][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
  float gC[3][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f},
                    {0.0f, 0.0f, 0.0f}};
  bool any_cov = false;

  if (d.d_conics.ptr) {
    const float gA = d.d_conics.at(i, 0);
    const float gB = d.d_conics.at(i, 1);
    const float gCc = d.d_conics.at(i, 2);
    const bool det_ok = e.det > 0.0f;
    const float inv_det = 1.0f / (det_ok ? e.det : 1.0f);
    // conic = (c, -b, a) * inv_det
    float ga = gCc * inv_det, gb = -(gB * inv_det), gc = gA * inv_det;
    if (det_ok) {
      const float g_inv = gA * e.c - gB * e.b + gCc * e.a;
      const float g_det = -g_inv * (inv_det * inv_det);
      ga += g_det * e.c;
      gc += g_det * e.a;
      gb -= 2.0f * (g_det * e.b);
    }
    // a = T0 C T0^T + 0.3, b = T0 C T1^T, c = T1 C T1^T + 0.3
    float CT[2][3];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        CT[r][j] = e.C[j][0] * e.T[r][0] + e.C[j][1] * e.T[r][1] +
                   e.C[j][2] * e.T[r][2];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      gT[0][j] = 2.0f * ga * CT[0][j] + gb * CT[1][j];
      gT[1][j] = gb * CT[0][j] + 2.0f * gc * CT[1][j];
    }
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int l = r; l < 3; ++l) {
        float v;
        if (r == l) {
          v = ga * e.T[0][r] * e.T[0][r] + gb * e.T[0][r] * e.T[1][r] +
              gc * e.T[1][r] * e.T[1][r];
        } else {
          v = 2.0f * ga * e.T[0][r] * e.T[0][l] +
              gb * (e.T[0][r] * e.T[1][l] + e.T[0][l] * e.T[1][r]) +
              2.0f * gc * e.T[1][r] * e.T[1][l];
        }
        gC[r][l] = v;
        gC[l][r] = v;
      }
    any_cov = true;
  }

  // Sigma = M M^T, M = R diag(s): dM = Gs M with Gs_kk = 2 gC_kk and
  // Gs_kl = gC_kl (each unique entry appears once in the plain chain)
  float g_s[3] = {0.0f, 0.0f, 0.0f};
  float g_q[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (any_cov) {
    float gR[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        float gm = 0.0f;
#pragma unroll
        for (int l = 0; l < 3; ++l)
          gm += (r == l ? 2.0f * gC[r][r] : gC[r][l]) * e.M[l][j];
        gR[r][j] = gm * e.s[j];
        g_s[j] += gm * e.R[r][j];
      }
    const float w = e.q[0], x = e.q[1], y = e.q[2], z = e.q[3];
    g_q[0] = 2.0f * (-z * gR[0][1] + y * gR[0][2] + z * gR[1][0] -
                     x * gR[1][2] - y * gR[2][0] + x * gR[2][1]);
    g_q[1] = 2.0f * (y * gR[0][1] + z * gR[0][2] + y * gR[1][0] -
                     2.0f * x * gR[1][1] - w * gR[1][2] + z * gR[2][0] +
                     w * gR[2][1] - 2.0f * x * gR[2][2]);
    g_q[2] = 2.0f * (-2.0f * y * gR[0][0] + x * gR[0][1] + w * gR[0][2] +
                     x * gR[1][0] + z * gR[1][2] - w * gR[2][0] +
                     z * gR[2][1] - 2.0f * y * gR[2][2]);
    g_q[3] = 2.0f * (-2.0f * z * gR[0][0] - w * gR[0][1] + x * gR[0][2] +
                     w * gR[1][0] - 2.0f * z * gR[1][1] + y * gR[1][2] +
                     x * gR[2][0] + y * gR[2][1]);

    // T0j = fxi Rv0j + gx Rv2j, T1j = fyi Rv1j + gy Rv2j, Rv[i][j] = wv[j][i]
    float g_fxi = 0.0f, g_gx = 0.0f, g_fyi = 0.0f, g_gy = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      g_fxi += gT[0][j] * wv[4 * j + 0];
      g_gx += gT[0][j] * wv[4 * j + 2];
      g_fyi += gT[1][j] * wv[4 * j + 1];
      g_gy += gT[1][j] * wv[4 * j + 2];
    }
    // gx = (-fx tx) inv_z2, fxi = fx inv_z, inv_z2 = inv_z inv_z
    const float g_tx = g_gx * (-k.focal_x) * e.inv_z2;
    const float g_ty = g_gy * (-k.focal_y) * e.inv_z2;
    const float g_inv_z2 = g_gx * (-k.focal_x * e.tx) +
                           g_gy * (-k.focal_y * e.ty);
    const float g_inv_z = g_fxi * k.focal_x + g_fyi * k.focal_y +
                          2.0f * (g_inv_z2 * e.inv_z);
    // inv_z = 1 / safe_z
    float g_safe_z = -g_inv_z * (e.inv_z * e.inv_z);
    // tx = clamp(v0 / safe_z, -lim_x, lim_x) z, likewise ty
    float g_z = g_tx * e.cx + g_ty * e.cy;
    const float g_ux = (e.ux >= -k.lim_x && e.ux <= k.lim_x) ? g_tx * e.z : 0.0f;
    const float g_uy = (e.uy >= -k.lim_y && e.uy <= k.lim_y) ? g_ty * e.z : 0.0f;
    g_v[0] = g_ux / e.safe_z;
    g_v[1] = g_uy / e.safe_z;
    g_safe_z += -g_ux * ((e.v0 / e.safe_z) / e.safe_z) -
                g_uy * ((e.v1 / e.safe_z) / e.safe_z);
    if (!(fabsf(e.z) < 1e-6f)) g_z += g_safe_z;
    g_v[2] = g_z;
  }
  if (d.d_depths) g_v[2] += d.d_depths[i * d.d_depths_stride];
  if (d.d_means2d.ptr) {
    // means2d = ((c01 pw + 1) wh - 1) / 2, pw = 1 / (c3 + 1e-7)
    const float g_p0 = d.d_means2d.at(i, 0) * (0.5f * k.width);
    const float g_p1 = d.d_means2d.at(i, 1) * (0.5f * k.height);
    g_c0 = g_p0 * e.pw;
    g_c1 = g_p1 * e.pw;
    const float g_pw = g_p0 * e.c0 + g_p1 * e.c1;
    g_c3 = -g_pw * (e.pw * e.pw);
  }
#pragma unroll
  for (int r = 0; r < 3; ++r)
    g.means3d[3 * i + r] = g_v[0] * wv[4 * r + 0] + g_v[1] * wv[4 * r + 1] +
                           g_v[2] * wv[4 * r + 2] + g_c0 * fp[4 * r + 0] +
                           g_c1 * fp[4 * r + 1] + g_c3 * fp[4 * r + 3];
#pragma unroll
  for (int j = 0; j < 3; ++j) g.scales[3 * i + j] = g_s[j] * k.scale_mod;
#pragma unroll
  for (int j = 0; j < 4; ++j) g.quats[4 * i + j] = g_q[j];
}

inline Consts consts(float focal_x, float focal_y, float lim_x, float lim_y,
                     float width, float height, float scale_mod, float tile,
                     float inv_tile, int tiles_x, int row_lo, int row_hi) {
  return Consts{focal_x, focal_y, lim_x, lim_y, width, height, scale_mod,
                tile, inv_tile, tiles_x, row_lo, row_hi};
}

inline unsigned blocks(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// One launch: every output of the projection (mask null), or with `mask`
// the cull mode's bool mask alone (quats may then be null: identity).
extern "C" int project_forward(
    const float* means, long long means_stride, const float* scales,
    long long scales_stride, const float* quats, long long quats_stride,
    const float* opac, long long opac_stride, const uint8_t* valid,
    long long valid_stride, const float* world_view, long long wv_s0,
    long long wv_s1, const float* full_proj, long long fp_s0, long long fp_s1,
    long long n, float focal_x, float focal_y, float lim_x, float lim_y,
    float width, float height, float scale_mod, float tile, float inv_tile,
    int tiles_x, int row_lo, int row_hi, float op_min, float* means2d,
    float* conics, float* depths, int* radii, int* rect_min, int* rect_max,
    int* n_tiles, uint8_t* mask, cudaStream_t stream) {
  const Inputs in{{means, means_stride}, {scales, scales_stride},
                  {quats, quats_stride}, opac, opac_stride, valid,
                  valid_stride, {world_view, wv_s0, wv_s1},
                  {full_proj, fp_s0, fp_s1}, n, op_min};
  const Consts k = consts(focal_x, focal_y, lim_x, lim_y, width, height,
                          scale_mod, tile, inv_tile, tiles_x, row_lo, row_hi);
  const Outputs out{means2d, conics, depths, radii, rect_min, rect_max,
                    n_tiles, mask};
  if (mask)
    project_forward_kernel<true><<<blocks(n), kThreads, 0, stream>>>(in, k,
                                                                     out);
  else
    project_forward_kernel<false><<<blocks(n), kThreads, 0, stream>>>(in, k,
                                                                      out);
  return static_cast<int>(cudaGetLastError());
}

// One launch: d means3d, d scales, d quats from the cotangents of means2d,
// conics and depths (each null where autograd gives none).
extern "C" int project_backward(
    const float* means, long long means_stride, const float* scales,
    long long scales_stride, const float* quats, long long quats_stride,
    const float* world_view, long long wv_s0, long long wv_s1,
    const float* full_proj, long long fp_s0, long long fp_s1, long long n,
    float focal_x, float focal_y, float lim_x, float lim_y, float width,
    float height, float scale_mod, const float* d_means2d,
    long long d_means2d_stride, const float* d_conics,
    long long d_conics_stride, const float* d_depths,
    long long d_depths_stride, float* g_means, float* g_scales,
    float* g_quats, cudaStream_t stream) {
  const Inputs in{{means, means_stride}, {scales, scales_stride},
                  {quats, quats_stride}, nullptr, 0, nullptr, 0,
                  {world_view, wv_s0, wv_s1}, {full_proj, fp_s0, fp_s1}, n,
                  0.0f};
  const Consts k = consts(focal_x, focal_y, lim_x, lim_y, width, height,
                          scale_mod, 16.0f, 0.0625f, 0, 0, 0);
  const Cotangents d{{d_means2d, d_means2d_stride},
                     {d_conics, d_conics_stride}, d_depths, d_depths_stride};
  project_backward_kernel<<<blocks(n), kThreads, 0, stream>>>(
      in, k, d, Grads{g_means, g_scales, g_quats});
  return static_cast<int>(cudaGetLastError());
}
