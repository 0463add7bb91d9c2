// K5 and K6: the slab transpose out[s][c][r] = in[s][r][c] of a contiguous
// [nc,128,16] float32 tensor into a new [nc,16,128] one, for Hopper
// (sm_90a).
//
// Replace the two in-kernel transposes of a [C,16] block in
// scripts/xpose_lab.py::main, inkernel_T (a_ref[0].T; K5) and inkernel_T2
// (jnp.swapaxes; K6): the TPU lab's question of what an in-kernel transpose
// costs, asked of this card with two designs.
//
//   K5, transpose_slab_smem: one 256-thread block per slab. The block reads
//   its slab's 8 KB into shared memory [128][17] with consecutive threads on
//   consecutive 4-byte words, then writes the output the same way. The pad
//   word of each row puts the 32 words a warp reads in the write pass (one
//   column, 32 rows) on 32 different banks.
//   K6, transpose_slab_vec: no shared memory. A thread loads a 4x4 block as
//   four float4 rows, transposes it in registers and stores four float4
//   columns; 128 threads a slab and 8 slabs a 256-thread block, so each
//   thread has 4 slabs' 16 loads in flight. Slabs past nc are masked.
//
// Bound: bytes, each element read once and written once (2 x nc x 8 KB) at
// the HBM rate; neither design does arithmetic.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;               // the lab's C
constexpr int kCols = 16;
constexpr int kSlab = kRows * kCols;     // floats a slab
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
transpose_slab_smem_kernel(const float* __restrict__ in,
                           float* __restrict__ out) {
  __shared__ float tile[kRows][kCols + 1];
  const long long base = static_cast<long long>(blockIdx.x) * kSlab;
#pragma unroll
  for (int k = 0; k < kSlab / kThreads; ++k) {
    const int i = k * kThreads + threadIdx.x;      // row-major in [128][16]
    tile[i / kCols][i % kCols] = in[base + i];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kSlab / kThreads; ++k) {
    const int o = k * kThreads + threadIdx.x;      // row-major in [16][128]
    out[base + o] = tile[o % kRows][o / kRows];
  }
}

constexpr int kVecPerSlab = kSlab / 16;            // threads a slab: 128
constexpr int kVecSlabs = 8;                       // slabs a block
constexpr int kVecPasses = kVecSlabs * kVecPerSlab / kThreads;   // 4
constexpr int kInRow4 = kCols / 4;                 // float4 an input row
constexpr int kOutRow4 = kRows / 4;                // float4 an output row

__global__ void __launch_bounds__(kThreads)
transpose_slab_vec_kernel(const float4* __restrict__ in,
                          float4* __restrict__ out, int nc) {
  const int q = threadIdx.x % kVecPerSlab;
  const int cb = q % kInRow4;            // columns 4cb..4cb+3
  const int rb = q / kInRow4;            // rows 4rb..4rb+3
  const int first = blockIdx.x * kVecSlabs + threadIdx.x / kVecPerSlab;
  float4 v[kVecPasses][4];
#pragma unroll
  for (int p = 0; p < kVecPasses; ++p) {
    const int s = first + p * (kThreads / kVecPerSlab);
    if (s < nc) {
      const float4* src = in + static_cast<long long>(s) * (kSlab / 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) v[p][i] = src[(4 * rb + i) * kInRow4 + cb];
    }
  }
#pragma unroll
  for (int p = 0; p < kVecPasses; ++p) {
    const int s = first + p * (kThreads / kVecPerSlab);
    if (s < nc) {
      float4* dst = out + static_cast<long long>(s) * (kSlab / 4) + rb;
      dst[(4 * cb + 0) * kOutRow4] =
          make_float4(v[p][0].x, v[p][1].x, v[p][2].x, v[p][3].x);
      dst[(4 * cb + 1) * kOutRow4] =
          make_float4(v[p][0].y, v[p][1].y, v[p][2].y, v[p][3].y);
      dst[(4 * cb + 2) * kOutRow4] =
          make_float4(v[p][0].z, v[p][1].z, v[p][2].z, v[p][3].z);
      dst[(4 * cb + 3) * kOutRow4] =
          make_float4(v[p][0].w, v[p][1].w, v[p][2].w, v[p][3].w);
    }
  }
}

}  // namespace

// Each launches its kernel on `stream` for nc >= 1 slabs and returns the
// cudaError_t of the launch (0 = ok). in [nc,128,16] f32, out [nc,16,128]
// f32, both contiguous; K6 needs both 16-byte aligned.
extern "C" int transpose_slab_smem(const float* in, float* out, int nc,
                                   cudaStream_t stream) {
  transpose_slab_smem_kernel<<<nc, kThreads, 0, stream>>>(in, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int transpose_slab_vec(const float* in, float* out, int nc,
                                  cudaStream_t stream) {
  const int blocks = (nc + kVecSlabs - 1) / kVecSlabs;
  transpose_slab_vec_kernel<<<blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(in), reinterpret_cast<float4*>(out),
      nc);
  return static_cast<int>(cudaGetLastError());
}
