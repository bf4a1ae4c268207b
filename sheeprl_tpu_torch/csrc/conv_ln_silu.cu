// DreamerV3 encoder stage for Hopper (sm_90a): Conv2d(k4, s2, SAME, no bias)
// -> LayerNorm over channels (f32 statistics) -> SiLU, NHWC input, HWIO
// weight, NHWC output.
//
// Replaces the TPU kernel sheeprl_tpu/ops/pallas_cnn.py:_enc_call
// (`conv_ln_silu`), both its forward and its forward with residuals (which
// also writes the f32 pre-activation for the backward). SAME padding for k4/s2 on
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
//  1. conv_proj_kernel: a block owns 64 pixels x 64 output channels and one
//     split of the reduction axis, the register-blocked tile of
//     csrc/conv_common.cuh (4 x 4 outputs a thread, f32). Per step it
//     gathers a [16 x 64] tile of the im2col matrix (consecutive reduction
//     indices are consecutive input channels, so the reads coalesce; padding
//     reads as zero) and a [16 x 64] tile of the weight, the next step's
//     read into registers while the current one multiplies. The reduction axis
//     is split until the grid holds two blocks per SM, so the deep late
//     stages (K = 2048 at 128->256) run on the whole card at serving batch;
//     partial sums go to an f32 scratch [splits, P, Cout].
//  2. the pixel pass of csrc/conv_common.cuh: one warp per pixel sums the
//     partials, LayerNorm over Cout with f32 statistics, SiLU, NHWC in x's
//     dtype, and the summed pre-activation when residuals are asked for.
// Cout is bounded by the pixel pass (16 channels a lane: 512); the wrapper
// raises on a wider stage. At training batch (N = 1,024 images) a stage is
// 3.2 to 17.2 GFLOP, so the bound there is the f32 rate; tensor cores
// (wgmma) are left to a later revision.

#include "conv_common.cuh"

namespace {

using namespace conv_common;

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_proj_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 float* __restrict__ pre, int N, int H, int W, int Cin, int Cout,
                 int k_per_split) {
  const int Ho = H / 2, Wo = W / 2;
  const int P = N * Ho * Wo;
  const int K = 16 * Cin;
  __shared__ Tile tile;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int p0 = blockIdx.x * kRows;  // x: the pixel tiles outnumber gridDim.y's 65,535
  const int c0 = blockIdx.y * kCols;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);

  // the im2col rows this thread gathers (ty + 16 i) at reduction lane tx:
  // image and top-left corner of the 4x4 window (SAME pads one pixel)
  int gn[4], gy[4], gx[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty + 16 * i;
    const int rem = (p < P ? p : 0) % (Ho * Wo);
    gn[i] = p < P ? p / (Ho * Wo) : -1;  // -1: a pixel past the end
    gy[i] = 2 * (rem / Wo) - 1;
    gx[i] = 2 * (rem % Wo) - 1;
  }

  // the next step's operands are read into registers while the current
  // step multiplies, so the global loads' latency hides behind the FMAs
  float wreg[4], xreg[4];
  auto load = [&](int kc) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gk = kc + tid / kCols + 4 * i, gc = c0 + tid % kCols;
      wreg[i] = (gk < k_end && gc < Cout) ? to_f(w[(size_t)gk * Cout + gc]) : 0.f;
    }
    const int gk = kc + tx;
    const int tap = gk / Cin, ci = gk - tap * Cin;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      xreg[i] = 0.f;
      if (gk < k_end && gn[i] >= 0) {
        const int iy = gy[i] + tap / 4, ix = gx[i] + tap % 4;
        if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
          xreg[i] = to_f(x[(((size_t)gn[i] * H + iy) * W + ix) * Cin + ci]);
        }
      }
    }
  };

  float acc[4][4] = {};
  if (k_begin < k_end) load(k_begin);
  for (int kc = k_begin; kc < k_end; kc += kDepth) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      tile.ws[tid / kCols + 4 * i][tid % kCols] = wreg[i];
      tile.xs[tx][ty + 16 * i] = xreg[i];
    }
    __syncthreads();
    if (kc + kDepth < k_end) load(kc + kDepth);
    tile_fma(tile, acc, ty, tx);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + 4 * ty + i;
    if (p >= P) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = c0 + 4 * tx + j;
      if (gc < Cout) pre[((size_t)blockIdx.z * P + p) * Cout + gc] = acc[i][j];
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const float* scale, const float* offset,
           float* pre, void* y, float* pre_out, int N, int H, int W, int Cin, int Cout,
           int splits, float eps, cudaStream_t stream) {
  const int P = N * (H / 2) * (W / 2);
  const int K = 16 * Cin;
  const int per = (K + splits - 1) / splits;
  const int k_per_split = (per + kDepth - 1) / kDepth * kDepth;
  const dim3 grid((P + kRows - 1) / kRows, (Cout + kCols - 1) / kCols, splits);
  conv_proj_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), pre, N, H, W, Cin, Cout, k_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_ln_silu<T>(pre, scale, offset, y, pre_out, P, Cout, splits, eps, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and y); scale/offset, the
// scratch `pre` [splits, P, Cout] and the optional residual `pre_out`
// [P, Cout] (null for the plain forward) are float32. H and W even,
// Cout <= 512. Returns a cudaError_t.
extern "C" int conv_ln_silu_forward(int dtype, const void* x, const void* w,
                                    const void* scale, const void* offset, void* pre,
                                    void* y, void* pre_out, int N, int H, int W, int Cin,
                                    int Cout, int splits, float eps, void* stream) {
  if (Cout > kMaxCout || (H % 2) != 0 || (W % 2) != 0 || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* sc = static_cast<const float*>(scale);
  const auto* of = static_cast<const float*>(offset);
  auto* pp = static_cast<float*>(pre);
  auto* po = static_cast<float*>(pre_out);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, sc, of, pp, y, po, N, H, W, Cin, Cout, splits, eps, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, sc, of, pp, y, po, N, H, W, Cin, Cout, splits, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
