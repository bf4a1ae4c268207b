// DreamerV3 decoder stage for Hopper (sm_90a): ConvTranspose2d(k4, s2, SAME,
// no bias) -> LayerNorm over channels (f32 statistics) -> SiLU, NHWC input,
// HWIO kernel, NHWC output at twice the input's height and width.
//
// Replaces the TPU kernel sheeprl_tpu/ops/pallas_cnn.py:_dec_call
// (`deconv_ln_silu`), its forward and its forward with residuals (which also
// writes the f32 pre-activation for the backward). The transposed conv is
// the reference's subpixel form (`_subpixel_k4s2` / `_dec_deconv`:
// `lax.conv_transpose` regrouped into four 2x2 phase kernels), written per
// output pixel (n, 2i+dh, 2j+dw):
//   pre[., co] = sum_{a, b in {0,1}, ci} x[n, i+dh+a-1, j+dw+b-1, ci] * k[2a+dh, 2b+dw, ci, co]
// (out-of-range input pixels read as zero). For one phase (dh, dw) that is
// an implicit GEMM [N*H*W, 4*Cin] x [4*Cin, Cout].
//
// What bounds it on an H100: at training batch (N = 1,024 latents) each of
// the three LayerNorm stages is 2 * N*4HW * Cout * 4Cin = 17.2 GFLOP, about
// 0.26 ms at the 67 TFLOP/s f32 rate; their bytes (at most 0.34 GB, the last
// stage with its residual) take 0.1 ms. The bound is the operations.
//
// Design (two launches, no library call):
//  1. deconv_proj_kernel: blockIdx.z picks the phase (dh, dw) and the split
//     of the reduction axis, so every block multiplies by one phase's
//     weight rows of the HWIO kernel. A block owns 64 input-grid pixels x 64
//     output channels, the register-blocked tile of csrc/conv_common.cuh
//     (4 x 4 outputs a thread, f32); per step it gathers a [16 x 64] tile of
//     the phase's im2col matrix (consecutive reduction indices are
//     consecutive input channels) and a [16 x 64] tile of the weight (the
//     next step's read into registers while the current one multiplies),
//     and at the end writes its partial sums straight to the interleaved output
//     pixels of an f32 scratch [splits, N*2H*2W, Cout]: the JAX package's
//     XLA-side interleave (`_interleave_phases`) is the addressing here.
//  2. the pixel pass of csrc/conv_common.cuh over the N*2H*2W output pixels.
// Tensor cores (wgmma) and TMA are left to a later revision.

#include "conv_common.cuh"

namespace {

using namespace conv_common;

template <typename T>
__global__ void __launch_bounds__(kThreads)
deconv_proj_kernel(const T* __restrict__ x, const T* __restrict__ k,
                   float* __restrict__ pre, int N, int H, int W, int Cin, int Cout,
                   int splits, int k_per_split) {
  const int P = N * H * W;  // pixels of one phase (the input grid)
  const size_t P_out = 4 * (size_t)P;
  const int K = 4 * Cin;
  const int phase = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  const int dh = phase / 2, dw = phase % 2;
  __shared__ Tile tile;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int p0 = blockIdx.x * kRows;
  const int c0 = blockIdx.y * kCols;
  const int k_begin = split * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);

  // the im2col rows this thread gathers (ty + 16 i) at reduction lane tx:
  // image and input-grid position of the output pixel (2i+dh, 2j+dw)
  int gn[4], gi[4], gj[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty + 16 * i;
    const int rem = (p < P ? p : 0) % (H * W);
    gn[i] = p < P ? p / (H * W) : -1;  // -1: a pixel past the end
    gi[i] = rem / W;
    gj[i] = rem % W;
  }

  // the next step's operands are read into registers while the current
  // step multiplies, so the global loads' latency hides behind the FMAs
  float wreg[4], xreg[4];
  auto load = [&](int kc) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gk = kc + tid / kCols + 4 * i, gc = c0 + tid % kCols;
      wreg[i] = 0.f;
      if (gk < k_end && gc < Cout) {
        const int tap = gk / Cin, ci = gk - tap * Cin;
        const int kh = 2 * (tap / 2) + dh, kw = 2 * (tap % 2) + dw;
        wreg[i] = to_f(k[((size_t)(kh * 4 + kw) * Cin + ci) * Cout + gc]);
      }
    }
    const int gk = kc + tx;
    const int tap = gk / Cin, ci = gk - tap * Cin;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      xreg[i] = 0.f;
      if (gk < k_end && gn[i] >= 0) {
        const int iy = gi[i] + dh + tap / 2 - 1, ix = gj[i] + dw + tap % 2 - 1;
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
    const int n = p / (H * W), rem = p % (H * W);
    const size_t out_pixel = ((size_t)n * 2 * H + 2 * (rem / W) + dh) * (2 * W) + 2 * (rem % W) + dw;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = c0 + 4 * tx + j;
      if (gc < Cout) pre[((size_t)split * P_out + out_pixel) * Cout + gc] = acc[i][j];
    }
  }
}

template <typename T>
int launch(const void* x, const void* k, const float* scale, const float* offset,
           float* pre, void* y, float* pre_out, int N, int H, int W, int Cin, int Cout,
           int splits, float eps, cudaStream_t stream) {
  const int P = N * H * W;
  const int K = 4 * Cin;
  const int per = (K + splits - 1) / splits;
  const int k_per_split = (per + kDepth - 1) / kDepth * kDepth;
  const dim3 grid((P + kRows - 1) / kRows, (Cout + kCols - 1) / kCols, 4 * splits);
  deconv_proj_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(k), pre, N, H, W, Cin, Cout, splits,
      k_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_ln_silu<T>(pre, scale, offset, y, pre_out, 4 * P, Cout, splits, eps, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, k and y); scale/offset, the scratch
// `pre` [splits, N*2H*2W, Cout] and the optional residual `pre_out`
// [N*2H*2W, Cout] (null for the plain forward) are float32. Cout <= 512.
// Returns a cudaError_t.
extern "C" int deconv_ln_silu_forward(int dtype, const void* x, const void* k,
                                      const void* scale, const void* offset, void* pre,
                                      void* y, void* pre_out, int N, int H, int W, int Cin,
                                      int Cout, int splits, float eps, void* stream) {
  if (Cout > kMaxCout || splits < 1 || 4 * splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* sc = static_cast<const float*>(scale);
  const auto* of = static_cast<const float*>(offset);
  auto* pp = static_cast<float*>(pre);
  auto* po = static_cast<float*>(pre_out);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, k, sc, of, pp, y, po, N, H, W, Cin, Cout, splits, eps, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, k, sc, of, pp, y, po, N, H, W, Cin, Cout, splits, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
