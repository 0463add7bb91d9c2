// Adam over every leaf of the model in one launch, for Hopper (sm_90a).
//
// Replaces no TPU kernel: contextgs_tpu/train/optim.py::adam_update is a
// jnp tree map that XLA fuses. The port's plain version is the op chain of
// contextgs_tpu_torch/train/optim.py::chain_update, fourteen PyTorch ops a leaf
// (about 660 launches a step over the 46 leaves, and a zeros_like for each
// leaf without a gradient), which the CPU runs.
//
// What bounds it. Per element it reads p, g, m and v and writes p, m and v:
// 28 bytes (24 where the leaf has no gradient), a dozen float operations.
// The 400k-slot pool's 46 leaves are 46.5M elements, 1.27 GB in a plain
// step, 0.38 ms at 3.35 TB/s; the op chain moves about 128 bytes an element. So the card's memory bounds
// the kernel, and the chain's launches bound the chain.
//
// Design. One table of the leaves (pointers, element count, lr, the first
// chunk) passed by value as the kernel's parameter, under 4 KB for 64
// leaves, so nothing is copied to the card before the launch. Each block
// takes one chunk of kChunk elements of one leaf: it finds the leaf by a
// binary search over the chunk starts, so a 10-element bias and a 20M-
// element feature table share one grid. A leaf whose four pointers are
// 16-byte aligned and whose size is a multiple of 4 is read and written as
// float4; any other leaf element by element. A leaf without a gradient
// reads none and is updated with g = 0, as the chain updates it.
//
// Rounding. Every op rounds as the chain's op on the card rounds it, with
// no contraction (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn):
// the Python scalars are float32 operands, and a tensor divided by a host
// scalar is a product with the float32 reciprocal, as PyTorch divides by a
// CPU scalar on a CUDA tensor. Frozen leaves (lr 0) and the pool's empty
// slots are updated like every other element, so p, m and v are bit-equal
// to the chain's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 64;
constexpr int kThreads = 256;
constexpr int kChunk = 8192;   // elements a block: 8 float4 a thread

struct Table {
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];  // null: no gradient, updated with g = 0
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
  long long numel[kMaxLeaves];
  float lr[kMaxLeaves];
  int vec[kMaxLeaves];         // 1: float4 loads and stores
  int chunk0[kMaxLeaves + 1];  // first chunk of each leaf; [n] the total
  int n;
};

struct Scalars {
  float b1, omb1, b2, omb2;    // b1, 1 - b1, b2, 1 - b2 as float32
  float inv_bc1, inv_bc2;      // 1 / bias correction, rounded to float32
  float eps;
};

// m.mul_(b1).add_((1 - b1) * g); v.mul_(b2).add_((1 - b2) * (g * g));
// p.sub_(lr * (m / bc1) / (sqrt(v / bc2) + eps)), op by op
__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       float lr, const Scalars& s) {
  m = __fadd_rn(__fmul_rn(m, s.b1), __fmul_rn(g, s.omb1));
  v = __fadd_rn(__fmul_rn(v, s.b2), __fmul_rn(__fmul_rn(g, g), s.omb2));
  const float num = __fmul_rn(__fmul_rn(m, s.inv_bc1), lr);
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, s.inv_bc2)), s.eps);
  p = __fsub_rn(p, __fdiv_rn(num, den));
}

__device__ __forceinline__ void update4(float4& p, float4 g, float4& m,
                                        float4& v, float lr,
                                        const Scalars& s) {
  update(p.x, g.x, m.x, v.x, lr, s);
  update(p.y, g.y, m.y, v.y, lr, s);
  update(p.z, g.z, m.z, v.z, lr, s);
  update(p.w, g.w, m.w, v.w, lr, s);
}

__global__ void __launch_bounds__(kThreads)
    adam_kernel(const Table t, const Scalars s) {
  const int chunk = blockIdx.x;
  int lo = 0, hi = t.n - 1;    // the last leaf whose first chunk <= chunk
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.chunk0[mid] <= chunk) lo = mid;
    else hi = mid - 1;
  }
  const int leaf = lo;
  const long long begin =
      static_cast<long long>(chunk - t.chunk0[leaf]) * kChunk;
  const long long end = min(begin + kChunk, t.numel[leaf]);
  float* p = t.p[leaf];
  const float* g = t.g[leaf];
  float* m = t.m[leaf];
  float* v = t.v[leaf];
  const float lr = t.lr[leaf];
  if (t.vec[leaf]) {
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 2
    for (long long i = begin / 4 + threadIdx.x; i < end / 4; i += kThreads) {
      float4 pi = p4[i], mi = m4[i], vi = v4[i];
      const float4 gi = g4 ? g4[i] : zero;
      update4(pi, gi, mi, vi, lr, s);
      p4[i] = pi;
      m4[i] = mi;
      v4[i] = vi;
    }
  } else {
    for (long long i = begin + threadIdx.x; i < end; i += kThreads) {
      float pi = p[i], mi = m[i], vi = v[i];
      update(pi, g ? g[i] : 0.0f, mi, vi, lr, s);
      p[i] = pi;
      m[i] = mi;
      v[i] = vi;
    }
  }
}

bool aligned16(const void* x) {
  return (reinterpret_cast<uintptr_t>(x) & 15) == 0;
}

}  // namespace

// One launch: Adam over n leaves (1 <= n <= 64, each with at least one
// element). ptrs: four pointers a leaf, p, g, m, v (g null for a leaf
// without a gradient); numel, lr: each leaf's size and learning rate; b1,
// omb1, b2, omb2, bc1, bc2, eps: the chain's host scalars rounded to
// float32.
extern "C" int adam_leaves(int n, float* const* ptrs, const long long* numel,
                           const float* lr, float b1, float omb1, float b2,
                           float omb2, float bc1, float bc2, float eps,
                           cudaStream_t stream) {
  if (n < 1 || n > kMaxLeaves) return static_cast<int>(cudaErrorInvalidValue);
  Table t;
  t.n = n;
  long long chunks = 0;
  for (int i = 0; i < n; ++i) {
    float* const* leaf = ptrs + 4 * i;
    if (numel[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
    t.p[i] = leaf[0];
    t.g[i] = leaf[1];
    t.m[i] = leaf[2];
    t.v[i] = leaf[3];
    t.numel[i] = numel[i];
    t.lr[i] = lr[i];
    t.vec[i] = numel[i] % 4 == 0 && aligned16(leaf[0]) &&
               aligned16(leaf[2]) && aligned16(leaf[3]) &&
               (leaf[1] == nullptr || aligned16(leaf[1]));
    t.chunk0[i] = static_cast<int>(chunks);
    chunks += (numel[i] + kChunk - 1) / kChunk;
  }
  if (chunks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  t.chunk0[n] = static_cast<int>(chunks);
  // PyTorch divides a CUDA tensor by a CPU scalar as a product with
  // opmath_t(1) / scalar, computed on the host in float
  const Scalars s{b1, omb1, b2, omb2, 1.0f / bc1, 1.0f / bc2, eps};
  adam_kernel<<<static_cast<unsigned>(chunks), kThreads, 0, stream>>>(t, s);
  return static_cast<int>(cudaGetLastError());
}
