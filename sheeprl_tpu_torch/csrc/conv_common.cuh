// Shared by csrc/conv_ln_silu.cu and csrc/deconv_ln_silu.cu: the type
// helpers, the implicit-GEMM tile and its inner product, and the pixel pass
// that turns the f32 partial sums of a (de)convolution into LayerNorm ->
// SiLU outputs.
//
// The tile: a block owns 64 output pixels x 64 output channels and steps
// through its slice of the reduction axis 16 at a time, staging a [16 x 64]
// im2col tile and a [16 x 64] weight tile in shared memory. Each of the 256
// threads accumulates a 4 x 4 block of outputs in registers, reading one
// float4 of each tile per reduction step: two shared loads for 16 FMAs.
//
// The pixel pass: one warp per output pixel sums the split-K partials
// [splits, P, Cout] in a fixed order, reduces the mean and then the
// variance of the centred values over Cout (the two-pass order of the TPU
// kernels' `_ln_stats`) with warp shuffles, applies scale/offset and SiLU
// in f32, and writes NHWC in the output dtype. With `pre_out` set it also
// writes the summed pre-activation [P, Cout] in f32: the residual the
// backward recomputes the LayerNorm statistics from. Cout is bounded by the
// registers a lane holds (16 channels a lane: 512).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace conv_common {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

constexpr int kRows = 64;     // output pixels per block
constexpr int kCols = 64;     // output channels per block
constexpr int kDepth = 16;    // reduction depth per shared stage
constexpr int kThreads = 256;
constexpr int kPad = 4;       // keeps each tile row 16-byte aligned for float4 reads
constexpr int kPerLane = 16;  // channels per lane in the pixel pass
constexpr int kMaxCout = 32 * kPerLane;

// One reduction step's operands: xs[k][pixel] (im2col) and ws[k][channel].
struct __align__(16) Tile {
  float xs[kDepth][kRows + kPad];
  float ws[kDepth][kCols + kPad];
};

// acc[i][j] += sum_k xs[k][4*ty + i] * ws[k][4*tx + j] over the tile's depth.
__device__ __forceinline__ void tile_fma(const Tile& t, float (&acc)[4][4], int ty, int tx) {
#pragma unroll
  for (int k = 0; k < kDepth; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(&t.xs[k][4 * ty]);
    const float4 b = *reinterpret_cast<const float4*>(&t.ws[k][4 * tx]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_silu_kernel(const float* __restrict__ pre, const float* __restrict__ scale,
               const float* __restrict__ offset, T* __restrict__ y,
               float* __restrict__ pre_out, int P, int Cout, int splits, float eps) {
  const int p = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (p >= P) return;  // warp-uniform: a whole warp owns one pixel
  float v[kPerLane];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int c = lane + 32 * i;
    v[i] = 0.f;
    if (c < Cout) {
      for (int sp = 0; sp < splits; ++sp) v[i] += pre[((size_t)sp * P + p) * Cout + c];
      s += v[i];
      if (pre_out != nullptr) pre_out[(size_t)p * Cout + c] = v[i];
    }
  }
  const float mean = warp_sum(s) / Cout;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int c = lane + 32 * i;
    if (c < Cout) {
      const float d = v[i] - mean;
      q += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / Cout + eps);
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int c = lane + 32 * i;
    if (c < Cout) {
      const float z = (v[i] - mean) * rstd * scale[c] + offset[c];
      y[(size_t)p * Cout + c] = from_f<T>(z / (1.f + expf(-z)));
    }
  }
}

// Launch the pixel pass over P output pixels; returns a cudaError_t.
template <typename T>
int launch_ln_silu(const float* pre, const float* scale, const float* offset, void* y,
                   float* pre_out, int P, int Cout, int splits, float eps,
                   cudaStream_t stream) {
  const int warps_per_block = kThreads / 32;
  ln_silu_kernel<T><<<(P + warps_per_block - 1) / warps_per_block, kThreads, 0, stream>>>(
      pre, scale, offset, static_cast<T*>(y), pre_out, P, Cout, splits, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace conv_common
