// symlog and symexp for Hopper (sm_90a), elementwise:
//   symlog(x) = sign(x) * log1p(|x|)        symexp(x) = sign(x) * (exp(|x|) - 1)
//
// Replaces the TPU kernel sheeprl_tpu/ops/pallas_kernels.py:_elementwise
// (`_symlog_kernel`, `_symexp_kernel`), one launch per call as there.
// float32 and bfloat16; bf16 computes in f32 and rounds once. log1pf / expf
// (the accurate library functions, not the fast intrinsics), and sign as
// torch.sign computes it, (0 < x) - (x < 0): +0 for +-0 and for NaN (whose
// result stays NaN through the product).
//
// What bounds it on an H100: one read and one write of every element, so
// the bytes (8 per f32 element, 4 per bf16 one, at 3.35 TB/s). In bf16 the
// bytes leave about 36 instructions an element at the card's issue rate.
// The SASS holds at most ~48 an element in bf16 symlog (the accurate
// log1pf is a polynomial) and ~25 in bf16 symexp (one MUFU.EX2), counts
// that include the head, the tail and every store width; how many the loop
// executes, and so whether bf16 symlog is bound by its instructions, is not
// measured.
//
// Design (the launch plan is `ops/kernels/symlog.py:plan`, which this file
// checks):
//   * a scalar head of fewer than one vector takes x to 16-byte alignment, a
//     body of 16-byte vectors (4 f32 or 8 bf16 a lane) follows, then a scalar
//     tail of fewer than one vector;
//   * each thread has kUnroll vectors in flight (64 bytes) before it
//     computes; loads bypass L1 (`ld.global.nc.L1::no_allocate`) and stores
//     stream (`st.global.cs`): every byte is touched once;
//   * a persistent grid of occupancy x SMs blocks (`symlog_max_blocks`)
//     walks the body in strides, each block over contiguous 16 KB; a body
//     too small to give every thread of that grid four vectors takes fewer
//     a thread (`unroll`), down to one and one block per 256 vectors, so a
//     small call still spreads over the SMs;
//   * x may start at any element offset while out is a fresh allocation, so
//     the two can differ in alignment mod 16. The loads keep their 16-byte
//     width, since loads are what must be in flight to hide the memory's
//     latency; the stores, which retire without waiting, go out at the
//     widest width out's alignment allows (16, 8, 4 or 2 bytes: `store_bytes`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ uint4 load_stream(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ void store_stream(char* p, uint4 v, int store_bytes) {
  switch (store_bytes) {
    case 16:
      asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p), "r"(v.x), "r"(v.y), "r"(v.z),
                   "r"(v.w)
                   : "memory");
      break;
    case 8:
      asm volatile("st.global.cs.v2.u32 [%0], {%1, %2};" ::"l"(p), "r"(v.x), "r"(v.y) : "memory");
      asm volatile("st.global.cs.v2.u32 [%0], {%1, %2};" ::"l"(p + 8), "r"(v.z), "r"(v.w) : "memory");
      break;
    case 4: {
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) asm volatile("st.global.cs.u32 [%0], %1;" ::"l"(p + 4 * i), "r"(w[i]) : "memory");
      break;
    }
    default: {  // 2: bf16 rows at an odd multiple of 2 bytes
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned short lo = static_cast<unsigned short>(w[i] & 0xffffu);
        const unsigned short hi = static_cast<unsigned short>(w[i] >> 16);
        asm volatile("st.global.cs.u16 [%0], %1;" ::"l"(p + 4 * i), "h"(lo) : "memory");
        asm volatile("st.global.cs.u16 [%0], %1;" ::"l"(p + 4 * i + 2), "h"(hi) : "memory");
      }
    }
  }
}

template <bool kExp>
__device__ __forceinline__ float apply(float v) {
  const float a = fabsf(v);
  const float sign = static_cast<float>((0.f < v) - (v < 0.f));
  return sign * (kExp ? expf(a) - 1.f : log1pf(a));
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

// one 16-byte vector of elements in, the same vector of results out
template <typename T, bool kExp>
__device__ __forceinline__ uint4 apply_vector(uint4 v);

template <>
__device__ __forceinline__ uint4 apply_vector<float, false>(uint4 v) {
  return make_uint4(__float_as_uint(apply<false>(__uint_as_float(v.x))),
                    __float_as_uint(apply<false>(__uint_as_float(v.y))),
                    __float_as_uint(apply<false>(__uint_as_float(v.z))),
                    __float_as_uint(apply<false>(__uint_as_float(v.w))));
}

template <>
__device__ __forceinline__ uint4 apply_vector<float, true>(uint4 v) {
  return make_uint4(__float_as_uint(apply<true>(__uint_as_float(v.x))),
                    __float_as_uint(apply<true>(__uint_as_float(v.y))),
                    __float_as_uint(apply<true>(__uint_as_float(v.z))),
                    __float_as_uint(apply<true>(__uint_as_float(v.w))));
}

// two bf16 in one word, the lower-addressed element in the low half
template <bool kExp>
__device__ __forceinline__ uint32_t apply_pair(uint32_t w) {
  const float lo = apply<kExp>(__uint_as_float(w << 16));
  const float hi = apply<kExp>(__uint_as_float(w & 0xffff0000u));
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}

template <>
__device__ __forceinline__ uint4 apply_vector<__nv_bfloat16, false>(uint4 v) {
  return make_uint4(apply_pair<false>(v.x), apply_pair<false>(v.y), apply_pair<false>(v.z), apply_pair<false>(v.w));
}

template <>
__device__ __forceinline__ uint4 apply_vector<__nv_bfloat16, true>(uint4 v) {
  return make_uint4(apply_pair<true>(v.x), apply_pair<true>(v.y), apply_pair<true>(v.z), apply_pair<true>(v.w));
}

template <typename T, bool kExp>
__global__ void __launch_bounds__(kThreads) symlog_kernel(const T* __restrict__ x, T* __restrict__ out, long long n,
                                                          int head, int store_bytes, int unroll) {
  constexpr int kVec = 16 / sizeof(T);
  const long long vectors = (n - head) / kVec;
  const long long body_end = head + vectors * kVec;
  const long long tail = n - body_end;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  // the scalar ends: element tid of the head and of the tail
  if (tid < head) store(out + tid, apply<kExp>(to_f(x[tid])));
  if (tid < tail) store(out + body_end + tid, apply<kExp>(to_f(x[body_end + tid])));

  // a block takes `unroll` (1 ... kUnroll) contiguous slabs of one vector a
  // thread per iteration: vector j = ((k * grid + block) * unroll + u) *
  // kThreads + thread. A small call takes unroll 1 and one block per
  // kThreads vectors, so it still spreads over the SMs.
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  char* ov = reinterpret_cast<char*>(out + head);
  const long long per_block = static_cast<long long>(kThreads) * unroll;
  const long long stride = static_cast<long long>(gridDim.x) * per_block;
  for (long long base = blockIdx.x * per_block + threadIdx.x; base < vectors; base += stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = base + u * kThreads;
      if (u < unroll && j < vectors) v[u] = load_stream(xv + j);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = base + u * kThreads;
      if (u < unroll && j < vectors) store_stream(ov + 16 * j, apply_vector<T, kExp>(v[u]), store_bytes);
    }
  }
}

template <typename T, bool kExp>
int max_blocks() {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, symlog_kernel<T, kExp>, kThreads, 0);
  return err == cudaSuccess ? sms * per_sm : -static_cast<int>(err);
}

template <typename T, bool kExp>
int launch(const void* x, void* out, long long n, int head, int store_bytes, int unroll, int blocks,
           cudaStream_t stream) {
  symlog_kernel<T, kExp><<<blocks, kThreads, 0, stream>>>(static_cast<const T*>(x), static_cast<T*>(out), n, head,
                                                          store_bytes, unroll);
  return static_cast<int>(cudaGetLastError());
}

// The plan's head and store width, recomputed from the pointers: fewer than
// one vector of head elements takes x to 16 bytes; the body's stores go at
// the largest power of two (up to 16) that out's address there divides.
bool plan_holds(std::uintptr_t x, std::uintptr_t out, long long n, int item, int head, int store_bytes) {
  const long long want_head = ((16 - static_cast<long long>(x % 16)) % 16) / item;
  if (x % item || out % item || head != (want_head < n ? want_head : n)) return false;
  const unsigned off = static_cast<unsigned>((out + static_cast<std::uintptr_t>(head) * item) % 16);
  return store_bytes == (off == 0 ? 16 : static_cast<int>(off & (~off + 1)));
}

}  // namespace

// fn: 0 = symlog, 1 = symexp; dtype: 0 = float32, 1 = bfloat16.
// The persistent grid's limit: blocks an SM holds x SMs (or -cudaError_t).
extern "C" int symlog_max_blocks(int fn, int dtype) {
  if (fn == 0 && dtype == 0) return max_blocks<float, false>();
  if (fn == 0 && dtype == 1) return max_blocks<__nv_bfloat16, false>();
  if (fn == 1 && dtype == 0) return max_blocks<float, true>();
  if (fn == 1 && dtype == 1) return max_blocks<__nv_bfloat16, true>();
  return -static_cast<int>(cudaErrorInvalidValue);
}

// x and out hold n contiguous elements (n >= 1); head, store_bytes, unroll
// and blocks come from the plan (`ops/kernels/symlog.py:plan`); head and
// store_bytes are checked against the pointers. Returns a cudaError_t.
extern "C" int symlog_forward(int fn, int dtype, const void* x, void* out, long long n, int head, int store_bytes,
                              int unroll, int blocks, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int item = dtype == 0 ? 4 : 2;
  if (n < 1 || blocks < 1 || unroll < 1 || unroll > kUnroll || (dtype != 0 && dtype != 1) ||
      !plan_holds(reinterpret_cast<std::uintptr_t>(x), reinterpret_cast<std::uintptr_t>(out), n, item, head,
                  store_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  if (fn == 0 && dtype == 0) return launch<float, false>(x, out, n, head, store_bytes, unroll, blocks, st);
  if (fn == 0 && dtype == 1) return launch<__nv_bfloat16, false>(x, out, n, head, store_bytes, unroll, blocks, st);
  if (fn == 1 && dtype == 0) return launch<float, true>(x, out, n, head, store_bytes, unroll, blocks, st);
  if (fn == 1 && dtype == 1) return launch<__nv_bfloat16, true>(x, out, n, head, store_bytes, unroll, blocks, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
