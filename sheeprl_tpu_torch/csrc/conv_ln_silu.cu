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
// What bounds it on an H100: at training batch (N = 1,024 images) a
// DreamerV3 stage is 3.2 to 17.2 GFLOP against at most ~0.3 GB of bytes
// (input, output and the f32 residual), so the bound is the operations:
// about 0.1 ms a stage at 165 TFLOP/s for f32-accurate products on the
// tensor cores (3xTF32), 0.02 ms in bf16. At serving batch (N = 8) a stage
// is at most 67 MFLOP, and the time is filling the card and the launches.
//
// Design (two launches, no library call; csrc/conv_common.cuh):
//  1. the implicit GEMM on the tensor cores: a 128 x 64 (or 256 x 32) tile
//     a block, eight warps of 32 x 32 on mma.sync (bf16, or 3xTF32 for
//     f32), the im2col gather and the weight rows fed by a four-stage
//     cp.async ring; K is split across blocks only where the tiles alone
//     leave the card idle (serving batch, the deep late stages);
//  2. the pixel pass: one warp per pixel sums the splits, LayerNorm over
//     any Cout with f32 statistics in two passes, SiLU, NHWC in x's dtype.
// With one split and the residual asked for, the product writes the
// residual and the pixel pass reads it back: no scratch.

#include "conv_common.cuh"

// dtype: 0 = float32, 1 = bfloat16 (x, w and y); scale/offset, the
// scratch `pre` [splits, P, Cout] (may be null with one split and a
// residual) and the optional residual `pre_out` [P, Cout] (null for the
// plain forward) are float32. H and W even. wm, splits, k_per_split, stages
// and smem are ops/kernels/cnn.py:launch_plan's. Returns a cudaError_t.
extern "C" int conv_ln_silu_forward(int dtype, const void* x, const void* w,
                                    const void* scale, const void* offset, void* pre,
                                    void* y, void* pre_out, int N, int H, int W, int Cin,
                                    int Cout, int wm, int splits, int k_per_split, int stages,
                                    int smem, float eps, void* stream) {
  using namespace conv_common;
  if ((H % 2) != 0 || (W % 2) != 0 || N < 1 || Cin < 1 || Cout < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* sc = static_cast<const float*>(scale);
  const auto* of = static_cast<const float*>(offset);
  auto* pp = static_cast<float*>(pre);
  auto* po = static_cast<float*>(pre_out);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, false>(x, w, sc, of, pp, y, po, N, H, W, Cin, Cout, wm, splits, k_per_split, stages,
                                smem, eps, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(x, w, sc, of, pp, y, po, N, H, W, Cin, Cout, wm, splits, k_per_split,
                                        stages, smem, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
