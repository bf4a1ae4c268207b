// LayerNorm-GRU cell forward for Hopper (sm_90a).
//
// Replaces the TPU kernels sheeprl_tpu/ops/pallas_kernels.py:_gru_forward
// (`layernorm_gru_cell`) and _gru_forward_with_residuals (its forward under
// autodiff, which also writes the normalised parts `hat` [B, 3H] and the
// per-row `rstd` [B, 1] for the backward): parts = [x, h] @ W, LayerNorm over the 3H parts
// with f32 statistics, then the DreamerV3 gates
//   r, c, u = split(parts)   update = sigmoid(u - 1)   cand = tanh(sigmoid(r) * c)
//   h' = update * cand + (1 - update) * h
// The weight arrives in the port's Linear layout, [3H, Dx + H] (out, in).
//
// What bounds it on an H100: at serving batch (B <= 8) the work is a
// matrix-vector product, so the time is reading W once (1536 x 1024 x 4 B =
// 6.3 MB in f32 at DreamerV3 width) at 3.35 TB/s. At training batch
// (B = 1024) it is the 2*B*K*3H multiply-adds.
//
// Design (two launches, no library call):
//  1. gru_proj_kernel: a block owns 64 output columns x 16 rows and one
//     split of the reduction axis. It stages a [32 x 64] tile of W and a
//     [16 x 32] tile of [x, h] in shared memory per step (W rows are read
//     along K, so a warp reads 32 consecutive elements), accumulates in f32
//     registers, and writes its partial sums to an f32 scratch
//     [splits, B, 3H]. At small B the reduction axis is split so that the
//     grid still covers every SM and W is streamed by the whole card.
//  2. gru_row_kernel: one block per row sums the partials in a fixed order,
//     keeps the 3H row in shared memory, block-reduces the mean and then the
//     variance of the centred values (the two-pass order of the TPU
//     kernel), and applies scale/offset and the gates in f32. h' is written
//     in x's dtype; with residuals requested it also writes hat and rstd
//     (f32), which costs 3H + 1 floats a row more than the plain forward.
// Tensor cores (wgmma) and TMA are left to a later revision.

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

__device__ __forceinline__ float sigmoid_f(float v) { return 1.f / (1.f + expf(-v)); }

constexpr int kCols = 64;                   // output columns per block
constexpr int kRows = 16;                   // batch rows per block
constexpr int kDepth = 32;                  // reduction depth per shared stage
constexpr int kProjThreads = 256;
constexpr int kRowsPerThread = kRows / (kProjThreads / kCols);  // 4
constexpr int kRowThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kProjThreads)
gru_proj_kernel(const T* __restrict__ x, const T* __restrict__ h,
                const T* __restrict__ w, float* __restrict__ parts, int B,
                int Dx, int H, int k_per_split) {
  const int N = 3 * H;
  const int K = Dx + H;
  __shared__ float ws[kDepth][kCols + 1];
  __shared__ float xs[kRows][kDepth + 1];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kCols;
  const int b0 = blockIdx.y * kRows;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int col = tid % kCols;
  const int rg = tid / kCols;

  float acc[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) acc[j] = 0.f;

  for (int kc = k_begin; kc < k_end; kc += kDepth) {
    for (int e = tid; e < kCols * kDepth; e += kProjThreads) {
      const int n = e / kDepth, kk = e % kDepth;
      const int gn = n0 + n, gk = kc + kk;
      ws[kk][n] = (gn < N && gk < k_end) ? to_f(w[(size_t)gn * K + gk]) : 0.f;
    }
    for (int e = tid; e < kRows * kDepth; e += kProjThreads) {
      const int r = e / kDepth, kk = e % kDepth;
      const int gb = b0 + r, gk = kc + kk;
      float v = 0.f;
      if (gb < B && gk < k_end) {
        v = gk < Dx ? to_f(x[(size_t)gb * Dx + gk]) : to_f(h[(size_t)gb * H + (gk - Dx)]);
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

  const int gn = n0 + col;
  if (gn < N) {
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int gb = b0 + rg * kRowsPerThread + j;
      if (gb < B) parts[((size_t)blockIdx.z * B + gb) * N + gn] = acc[j];
    }
  }
}

// Sum of `v` over the block; every thread gets the result. `red` holds one
// float per warp and is free again when this returns.
__device__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float total = 0.f;
  for (int i = 0; i < nwarps; ++i) total += red[i];
  __syncthreads();
  return total;
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
gru_row_kernel(const float* __restrict__ parts, const T* __restrict__ h,
               const float* __restrict__ scale, const float* __restrict__ offset,
               T* __restrict__ out, float* __restrict__ hat, float* __restrict__ rstd_out,
               int B, int H, int splits, float eps) {
  extern __shared__ float row[];  // the 3H parts of this batch row
  __shared__ float red[kRowThreads / 32];
  const int b = blockIdx.x;
  const int N = 3 * H;

  float s = 0.f;
  for (int j = threadIdx.x; j < N; j += kRowThreads) {
    float v = 0.f;
    for (int sp = 0; sp < splits; ++sp) v += parts[((size_t)sp * B + b) * N + j];
    row[j] = v;
    s += v;
  }
  const float mean = block_sum(s, red) / N;
  float q = 0.f;
  for (int j = threadIdx.x; j < N; j += kRowThreads) {
    const float c = row[j] - mean;
    q += c * c;
  }
  const float var = block_sum(q, red) / N;
  const float rstd = rsqrtf(var + eps);
  if (rstd_out != nullptr && threadIdx.x == 0) rstd_out[b] = rstd;

  for (int i = threadIdx.x; i < H; i += kRowThreads) {
    const float hr = (row[i] - mean) * rstd;
    const float hc = (row[H + i] - mean) * rstd;
    const float hu = (row[2 * H + i] - mean) * rstd;
    if (hat != nullptr) {
      hat[(size_t)b * N + i] = hr;
      hat[(size_t)b * N + H + i] = hc;
      hat[(size_t)b * N + 2 * H + i] = hu;
    }
    const float r = hr * scale[i] + offset[i];
    const float c = hc * scale[H + i] + offset[H + i];
    const float u = hu * scale[2 * H + i] + offset[2 * H + i];
    const float update = sigmoid_f(u - 1.f);
    const float cand = tanhf(sigmoid_f(r) * c);
    const float hv = to_f(h[(size_t)b * H + i]);
    out[(size_t)b * H + i] = from_f<T>(update * cand + (1.f - update) * hv);
  }
}

template <typename T>
int launch(const void* x, const void* h, const void* w, const float* scale,
           const float* offset, float* parts, void* out, float* hat, float* rstd, int B,
           int Dx, int H, int splits, float eps, cudaStream_t stream) {
  const int N = 3 * H;
  const int K = Dx + H;
  const int per = (K + splits - 1) / splits;
  const int k_per_split = (per + kDepth - 1) / kDepth * kDepth;
  const dim3 grid((N + kCols - 1) / kCols, (B + kRows - 1) / kRows, splits);
  gru_proj_kernel<T><<<grid, kProjThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(h), static_cast<const T*>(w),
      parts, B, Dx, H, k_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(N) * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(gru_row_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gru_row_kernel<T><<<B, kRowThreads, smem, stream>>>(
      parts, static_cast<const T*>(h), scale, offset, static_cast<T*>(out), hat, rstd, B, H,
      splits, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, h, w and out); scale/offset, the
// scratch `parts` [splits, B, 3H] and the residuals `hat` [B, 3H] and `rstd`
// [B] are float32. `hat` and `rstd` are both null (the plain forward) or
// both set (the forward under autodiff). Returns a cudaError_t.
extern "C" int ln_gru_forward(int dtype, const void* x, const void* h, const void* w,
                              const void* scale, const void* offset, void* parts,
                              void* out, void* hat, void* rstd, int B, int Dx, int H,
                              int splits, float eps, void* stream) {
  if ((hat == nullptr) != (rstd == nullptr) || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* sc = static_cast<const float*>(scale);
  const auto* of = static_cast<const float*>(offset);
  auto* pp = static_cast<float*>(parts);
  auto* ht = static_cast<float*>(hat);
  auto* rs = static_cast<float*>(rstd);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, h, w, sc, of, pp, out, ht, rs, B, Dx, H, splits, eps, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, h, w, sc, of, pp, out, ht, rs, B, Dx, H, splits, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
