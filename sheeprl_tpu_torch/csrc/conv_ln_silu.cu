// DreamerV3 encoder stage for Hopper (sm_90a): Conv2d(k4, s2, SAME, no bias)
// -> LayerNorm over channels (f32 statistics) -> SiLU, NHWC input, HWIO
// weight, NHWC output.
//
// Replaces the TPU kernel sheeprl_tpu/ops/pallas_cnn.py:_enc_call
// (`conv_ln_silu`, forward without residuals). SAME padding for k4/s2 on
// even H and W is one pixel on each side, as `_enc_taps` pads (1, 1):
//   pre[p, co] = sum_{k = (ky*4 + kx)*Cin + ci} x[n, 2oy-1+ky, 2ox-1+kx, ci] * w[k, co]
// an implicit GEMM [P, 16*Cin] x [16*Cin, Cout], P = N*(H/2)*(W/2) pixels
// (the HWIO weight is already the [16*Cin, Cout] matrix).
//
// What bounds it on an H100: at DreamerV3 width and serving batch the
// stages are small (3->32 @64^2 ... 128->256 @8^2): their bytes take
// microseconds at 3.35 TB/s and their multiply-adds (at most 67 MFLOP a
// stage at batch 8) about a microsecond at the f32 rate, so the time is
// filling the card with enough independent work and the launches.
//
// Design (two launches, no library call):
//  1. conv_proj_kernel: a block owns 16 pixels x 64 output channels and one
//     split of the reduction axis. Per step it gathers a [16 x 32] tile of
//     the im2col matrix (consecutive reduction indices are consecutive input
//     channels, so the reads coalesce; padding reads as zero) and a
//     [32 x 64] tile of the weight into shared memory and accumulates in
//     f32 registers (4 pixels x 1 channel a thread). The reduction axis is
//     split until the grid holds two blocks per SM, so the deep late stages
//     (K = 2048 at 128->256) run on the whole card; partial sums go to an
//     f32 scratch [splits, P, Cout].
//  2. ln_silu_kernel: one warp per pixel sums the partials in a fixed order,
//     reduces the mean and then the variance of the centred values over
//     Cout (the TPU kernel's two-pass order) with warp shuffles, applies
//     scale/offset and SiLU in f32, and writes NHWC in x's dtype.
// Cout is bounded by the pixel pass (16 channels a lane: 512); wider stages
// stay on the module's plain path. Tensor cores are left to a later
// revision.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

constexpr int kCols = 64;     // output channels per block
constexpr int kRows = 16;     // output pixels per block
constexpr int kDepth = 32;    // reduction depth per shared stage
constexpr int kThreads = 256;
constexpr int kRowsPerThread = kRows / (kThreads / kCols);  // 4
constexpr int kPerLane = 16;  // channels per lane in the pixel pass
constexpr int kMaxCout = 32 * kPerLane;

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_proj_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 float* __restrict__ pre, int N, int H, int W, int Cin, int Cout,
                 int k_per_split) {
  const int Ho = H / 2, Wo = W / 2;
  const int P = N * Ho * Wo;
  const int K = 16 * Cin;
  __shared__ float ws[kDepth][kCols + 1];
  __shared__ float xs[kRows][kDepth + 1];
  __shared__ int pn[kRows], py[kRows], px[kRows];
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kCols;
  const int p0 = blockIdx.y * kRows;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int col = tid % kCols;
  const int rg = tid / kCols;

  if (tid < kRows) {
    const int p = p0 + tid;
    const int rem = (p < P ? p : 0) % (Ho * Wo);
    pn[tid] = p < P ? p / (Ho * Wo) : -1;  // -1: a pixel past the end
    py[tid] = 2 * (rem / Wo) - 1;
    px[tid] = 2 * (rem % Wo) - 1;
  }
  __syncthreads();

  float acc[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) acc[j] = 0.f;

  for (int kc = k_begin; kc < k_end; kc += kDepth) {
    for (int e = tid; e < kDepth * kCols; e += kThreads) {
      const int kk = e / kCols, c = e % kCols;
      const int gk = kc + kk, gc = c0 + c;
      ws[kk][c] = (gk < k_end && gc < Cout) ? to_f(w[(size_t)gk * Cout + gc]) : 0.f;
    }
    for (int e = tid; e < kRows * kDepth; e += kThreads) {
      const int r = e / kDepth, kk = e % kDepth;
      const int gk = kc + kk;
      float v = 0.f;
      if (gk < k_end && pn[r] >= 0) {
        const int tap = gk / Cin, ci = gk - tap * Cin;
        const int iy = py[r] + tap / 4, ix = px[r] + tap % 4;
        if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
          v = to_f(x[(((size_t)pn[r] * H + iy) * W + ix) * Cin + ci]);
        }
      }
      xs[r][kk] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kDepth; ++kk) {
      const float wv = ws[kk][col];
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) acc[j] += xs[rg * kRowsPerThread + j][kk] * wv;
    }
    __syncthreads();
  }

  const int gc = c0 + col;
  if (gc < Cout) {
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int p = p0 + rg * kRowsPerThread + j;
      if (p < P) pre[((size_t)blockIdx.z * P + p) * Cout + gc] = acc[j];
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
               const float* __restrict__ offset, T* __restrict__ y, int P, int Cout,
               int splits, float eps) {
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

template <typename T>
int launch(const void* x, const void* w, const float* scale, const float* offset,
           float* pre, void* y, int N, int H, int W, int Cin, int Cout, int splits,
           float eps, cudaStream_t stream) {
  const int P = N * (H / 2) * (W / 2);
  const int K = 16 * Cin;
  const int per = (K + splits - 1) / splits;
  const int k_per_split = (per + kDepth - 1) / kDepth * kDepth;
  const dim3 grid((Cout + kCols - 1) / kCols, (P + kRows - 1) / kRows, splits);
  conv_proj_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), pre, N, H, W, Cin, Cout, k_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps_per_block = kThreads / 32;
  ln_silu_kernel<T><<<(P + warps_per_block - 1) / warps_per_block, kThreads, 0, stream>>>(
      pre, scale, offset, static_cast<T*>(y), P, Cout, splits, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and y); scale/offset and the
// scratch `pre` [splits, P, Cout] are float32. H and W even, Cout <= 512.
// Returns a cudaError_t.
extern "C" int conv_ln_silu_forward(int dtype, const void* x, const void* w,
                                    const void* scale, const void* offset, void* pre,
                                    void* y, int N, int H, int W, int Cin, int Cout,
                                    int splits, float eps, void* stream) {
  if (Cout > kMaxCout || (H % 2) != 0 || (W % 2) != 0 || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* sc = static_cast<const float*>(scale);
  const auto* of = static_cast<const float*>(offset);
  auto* pp = static_cast<float*>(pre);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, sc, of, pp, y, N, H, W, Cin, Cout, splits, eps, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, sc, of, pp, y, N, H, W, Cin, Cout, splits, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
