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
// 0.10 ms at 165 TFLOP/s for f32-accurate products on the tensor cores
// (3xTF32); their bytes (at most 0.34 GB, the last stage with its
// residual) take 0.1 ms. The bound is the operations.
//
// Design (two launches, no library call; csrc/conv_common.cuh): the
// implicit GEMM on the tensor cores with blockIdx.z = phase * splits +
// split, so every block multiplies by one phase's weight rows of the HWIO
// kernel (a 128 x 64 or 256 x 32 tile, eight warps on mma.sync, a
// four-stage cp.async ring), and writes its sums straight to the
// interleaved output pixels: the JAX package's XLA-side interleave
// (`_interleave_phases`) is the addressing here. Then the pixel pass over
// the N*2H*2W output pixels (any Cout).

#include "conv_common.cuh"

// dtype: 0 = float32, 1 = bfloat16 (x, k and y); scale/offset, the scratch
// `pre` [splits, N*2H*2W, Cout] (may be null with one split and a residual)
// and the optional residual `pre_out` [N*2H*2W, Cout] (null for the plain
// forward) are float32. wm, splits, k_per_split, stages and smem are
// ops/kernels/deconv.py:launch_plan's. Returns a cudaError_t.
extern "C" int deconv_ln_silu_forward(int dtype, const void* x, const void* k,
                                      const void* scale, const void* offset, void* pre,
                                      void* y, void* pre_out, int N, int H, int W, int Cin,
                                      int Cout, int wm, int splits, int k_per_split, int stages,
                                      int smem, float eps, void* stream) {
  using namespace conv_common;
  if (N < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* sc = static_cast<const float*>(scale);
  const auto* of = static_cast<const float*>(offset);
  auto* pp = static_cast<float*>(pre);
  auto* po = static_cast<float*>(pre_out);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, true>(x, k, sc, of, pp, y, po, N, H, W, Cin, Cout, wm, splits, k_per_split, stages,
                               smem, eps, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, true>(x, k, sc, of, pp, y, po, N, H, W, Cin, Cout, wm, splits, k_per_split,
                                       stages, smem, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
