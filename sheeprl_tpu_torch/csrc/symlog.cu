// symlog and symexp for Hopper (sm_90a), elementwise:
//   symlog(x) = sign(x) * log1p(|x|)        symexp(x) = sign(x) * (exp(|x|) - 1)
//
// Replaces the TPU kernel sheeprl_tpu/ops/pallas_kernels.py:_elementwise
// (`_symlog_kernel`, `_symexp_kernel`). float32 and bfloat16; bf16 computes
// in f32 and rounds once. log1pf / expf (the accurate library functions, not
// the fast intrinsics), and sign as torch.sign computes it, (0 < x) - (x < 0):
// +0 for +-0 and for NaN (whose result stays NaN through the product).
//
// What bounds it on an H100: one read and one write per element, a handful
// of operations: the bytes, 8 per f32 element (about 1.2 us for [1024, 255]
// at 3.35 TB/s).
//
// Design: one grid-stride loop per function, 256 threads a block, enough
// blocks for two waves of the 132 SMs at most.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 2 * 132 * 8;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T, bool kExp>
__global__ void __launch_bounds__(kThreads) symlog_kernel(const T* __restrict__ x, T* __restrict__ out,
                                                          long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float v = to_f(x[i]);
    const float a = fabsf(v);
    const float sign = static_cast<float>((0.f < v) - (v < 0.f));
    store(out + i, sign * (kExp ? expf(a) - 1.f : log1pf(a)));
  }
}

template <typename T, bool kExp>
int launch(const void* x, void* out, long long n, cudaStream_t stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  symlog_kernel<T, kExp><<<static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fn: 0 = symlog, 1 = symexp; dtype: 0 = float32, 1 = bfloat16. x and out
// hold n contiguous elements (n >= 1). Returns a cudaError_t.
extern "C" int symlog_forward(int fn, int dtype, const void* x, void* out, long long n, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (fn == 0 && dtype == 0) return launch<float, false>(x, out, n, st);
  if (fn == 0 && dtype == 1) return launch<__nv_bfloat16, false>(x, out, n, st);
  if (fn == 1 && dtype == 0) return launch<float, true>(x, out, n, st);
  if (fn == 1 && dtype == 1) return launch<__nv_bfloat16, true>(x, out, n, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
