// Two-hot log-probability for Hopper (sm_90a): the DreamerV3 reward and
// critic losses' log p(x) under a categorical over `bins` with a two-hot
// target, without materialising the [N, K] target.
//
// Replaces the TPU kernel sheeprl_tpu/ops/pallas_kernels.py:_two_hot_forward
// (`_two_hot_log_prob_kernel`). Per row, exactly as the reference:
//   log_z = logsumexp(logits)                    (max-shifted, f32)
//   below = clip(#(bins <= x) - 1, 0, K-1)       above = clip(K - #(bins > x), 0, K-1)
//   equal = below == above
//   d_below = equal ? 1 : |bins[below] - x|      d_above = equal ? 1 : |bins[above] - x|
//   out = d_above/(d_b+d_a) * (logits[below] - log_z) + d_below/(d_b+d_a) * (logits[above] - log_z)
//
// What bounds it on an H100: one pass over the logits, N*K*4 bytes (15.7 MB
// at the critic loss's N = 15,360, K = 255: about 5 us at 3.35 TB/s) against
// some 5 operations an element. The bound is the bytes.
//
// Design (one launch, no library call): one warp per row. Each lane holds
// ceil(K/32) logits in registers (K <= 1024), the warp reduces the max and
// then the sum of exponentials with shuffles, counts its lanes' bin
// comparisons and sums the counts the same way, and lane 0 reads the two
// bracketing logits back (they are in L1 from the row's load) and writes
// the row's f32 result. Eight warps a block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

constexpr int kThreads = 256;
constexpr int kMaxPerLane = 32;  // K <= 1024

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ int warp_sum_int(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int kPerLane>
__global__ void __launch_bounds__(kThreads)
two_hot_kernel(const float* __restrict__ x, const T* __restrict__ logits,
               const float* __restrict__ bins, float* __restrict__ out, int N, int K) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= N) return;  // warp-uniform: a whole warp owns one row
  const T* lrow = logits + (size_t)row * K;
  const float xv = x[row];
  float v[kPerLane];
  const float neg_inf = __int_as_float(0xff800000);
  float m = neg_inf;
  int le = 0, gt = 0;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int c = lane + 32 * i;
    v[i] = neg_inf;
    if (c < K) {
      v[i] = to_f(lrow[c]);
      m = fmaxf(m, v[i]);
      const float b = bins[c];
      le += b <= xv;
      gt += b > xv;
    }
  }
  m = warp_max(m);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    if (lane + 32 * i < K) s += expf(v[i] - m);
  }
  s = warp_sum(s);
  le = warp_sum_int(le);
  gt = warp_sum_int(gt);
  if (lane != 0) return;
  const float log_z = m + logf(s);
  const int below = min(max(le - 1, 0), K - 1);
  const int above = min(max(K - gt, 0), K - 1);
  const bool equal = below == above;
  const float d_below = equal ? 1.f : fabsf(bins[below] - xv);
  const float d_above = equal ? 1.f : fabsf(bins[above] - xv);
  const float total = d_below + d_above;
  const float lp_below = to_f(lrow[below]) - log_z;
  const float lp_above = to_f(lrow[above]) - log_z;
  out[row] = (d_above / total) * lp_below + (d_below / total) * lp_above;
}

template <typename T, int kPerLane>
int launch_rows(const float* x, const void* logits, const float* bins, float* out, int N,
                int K, cudaStream_t stream) {
  const int rows_per_block = kThreads / 32;
  two_hot_kernel<T, kPerLane><<<(N + rows_per_block - 1) / rows_per_block, kThreads, 0, stream>>>(
      x, static_cast<const T*>(logits), bins, out, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const float* x, const void* logits, const float* bins, float* out, int N, int K,
           cudaStream_t stream) {
  // registers a lane holds: the smallest of 8, 16, 32 that covers the row
  if (K <= 256) return launch_rows<T, 8>(x, logits, bins, out, N, K, stream);
  if (K <= 512) return launch_rows<T, 16>(x, logits, bins, out, N, K, stream);
  return launch_rows<T, kMaxPerLane>(x, logits, bins, out, N, K, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (logits); x [N], bins [K] and out [N]
// are float32. 1 <= K <= 1024. Returns a cudaError_t.
extern "C" int two_hot_log_prob_forward(int dtype, const void* x, const void* logits,
                                        const void* bins, void* out, int N, int K,
                                        void* stream) {
  if (K < 1 || K > 32 * kMaxPerLane) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xp = static_cast<const float*>(x);
  const auto* bp = static_cast<const float*>(bins);
  auto* op = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(xp, logits, bp, op, N, K, st);
  if (dtype == 1) return launch<__nv_bfloat16>(xp, logits, bp, op, N, K, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
