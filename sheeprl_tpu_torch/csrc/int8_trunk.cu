// The fused int8 SAC trunk for Hopper (sm_90a): three W8A8 linears with
// ReLU between them, `serve --algo sac --quant int8`'s policy step.
//
// Replaces the TPU kernel sheeprl_tpu/ops/pallas_kernels.py:fused_int8_trunk
// (`_fused_int8_kernel` over `_int8_trunk_math`). Per layer, exactly as the
// plain version (`ops/kernels/int8_trunk.py:int8_trunk_reference`):
//   x_q = int8(clip(round_half_even(x / in_scale), -127, 127))   per input channel
//   acc = sum_k x_q[k] * w_q[n, k]                               int32
//   y   = float(acc) * w_scale[n] + bias[n]                      two f32 roundings
//   a   = relu(y)                                                trunk layers only
// Every step is the IEEE operation the plain version runs, in its order: a
// correctly rounded division (never a multiply by the reciprocal), rint's
// half-to-even, and the dequant's multiply and add as two roundings
// (__fmul_rn/__fadd_rn, which nvcc never contracts into an FMA). A one-ulp
// difference in a layer's output could move the next layer's quantized value
// across a .5, so the kernel matches the plain version bit for bit.
//
// What bounds it on an H100: at the serving path's shapes (B <= 8 rows,
// 3 -> 256 -> 256 -> 1) the work is ~66 K int8 weights and ~1 M int8
// operations: 0.02 us of bytes, 0.5 ns of operations. The kernel is set by
// its launch and by the three dependent layers' latency.
//
// Design: one launch for the three layers. A block owns 16 rows and 256
// threads; each thread owns one output column of a 256-column block and
// keeps its 16 rows' int32 accumulators in registers. Each layer walks K in
// tiles of 128: the block stages the input tile (16 x 128 int8, quantized
// from x for layer 0) and the weight tile (256 x 128 int8, rows padded to
// 132 bytes so the column reads hit 32 different banks) in shared memory,
// zero-padded past K to a multiple of 4, and the products take four int8
// pairs at a time with __dp4a. A weight tile's loads are all issued before
// its first store (32 four-byte loads a thread in flight), so the block
// waits on L2 once a tile: the first design, one load then one store in a
// loop, waited once a load and measured 40 us at the serving rung. A trunk layer's epilogue applies the dequant and ReLU and
// quantizes straight into the next layer's int8 input (only the int8 image
// is ever needed), which stays in shared memory between layers; the head's
// epilogue writes f32 to `out`. Weights stream from device memory / L2 in
// tiles, so nothing assumes they fit shared memory; where the two hidden
// images do not fit beside the tiles (hidden widths summing above ~12,000),
// the wrapper passes a device-memory scratch that takes their place.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 16;
constexpr int kThreads = 256;
constexpr int kKT = 128;            // K tile
constexpr int kWStride = kKT + 4;   // bytes a staged weight row takes
constexpr int kTileBytes = kRows * kKT + kThreads * kWStride;
constexpr int kSmemLimit = 232448;  // the H100's 227 KB a block

struct Layer {
  const float* in_scale;  // [K]
  const int8_t* w;        // [N, K]
  const float* w_scale;   // [N]
  const float* bias;      // [N]
  int K, N;
};

__device__ __forceinline__ int8_t quantize(float v, float scale) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.f), 127.f);
  return static_cast<int8_t>(__float2int_rn(q));
}

// One layer for the block's rows [row0, row0 + rows). The input is x (f32,
// quantized while staged) when `x` is set, else the int8 image `img_in`
// [kRows, K]. A trunk layer (next_scale set) writes relu(y) quantized by the
// next layer's in_scale into `img_out` [kRows, N]; the head writes y to out.
__device__ void layer(const Layer L, const float* __restrict__ x, const int8_t* img_in,
                      const float* __restrict__ next_scale, int8_t* img_out,
                      float* __restrict__ out, int row0, int rows, int8_t* xs, int8_t* ws) {
  const int t = threadIdx.x;
  const bool vec = L.K % 4 == 0 && (reinterpret_cast<uintptr_t>(L.w) & 3) == 0;
  for (int n0 = 0; n0 < L.N; n0 += kThreads) {
    const int nv = min(kThreads, L.N - n0);
    int acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0;
    for (int k0 = 0; k0 < L.K; k0 += kKT) {
      const int kv = min(kKT, L.K - k0);
      const int kv4 = (kv + 3) & ~3;  // the products read no further than this
      // the input tile, the block's rows only (the accumulators of the
      // rows past B are never stored, so their stale tile rows are harmless)
      for (int i = t; i < rows * kv4; i += kThreads) {
        const int r = i / kv4, c = i - r * kv4;
        int8_t q = 0;
        if (c < kv) {
          q = x ? quantize(__ldg(x + (size_t)(row0 + r) * L.K + k0 + c), __ldg(L.in_scale + k0 + c))
                : img_in[r * L.K + k0 + c];
        }
        xs[r * kKT + c] = q;
      }
      if (vec) {
        // four weights a load (rows are 4-byte aligned when K % 4 == 0),
        // every load of the tile issued before the first store, so the
        // block waits on L2 once a tile rather than once a load
        int v[kKT / 4];
#pragma unroll
        for (int u = 0; u < kKT / 4; ++u) {
          const int i = t + u * kThreads, j = i / (kKT / 4), c = 4 * (i % (kKT / 4));
          v[u] = j < nv && c < kv ? __ldg(reinterpret_cast<const int*>(L.w + (size_t)(n0 + j) * L.K + k0 + c)) : 0;
        }
#pragma unroll
        for (int u = 0; u < kKT / 4; ++u) {
          const int i = t + u * kThreads, j = i / (kKT / 4), c = 4 * (i % (kKT / 4));
          if (j < nv) *reinterpret_cast<int*>(ws + j * kWStride + c) = v[u];
        }
      } else {
#pragma unroll 4
        for (int i = t; i < nv * kv4; i += kThreads) {
          const int j = i / kv4, c = i - j * kv4;
          ws[j * kWStride + c] = c < kv ? __ldg(L.w + (size_t)(n0 + j) * L.K + k0 + c) : int8_t(0);
        }
      }
      __syncthreads();
      if (t < nv) {
        const int* wrow = reinterpret_cast<const int*>(ws + t * kWStride);
        for (int kk = 0; kk < kv4 / 4; ++kk) {
          const int wv = wrow[kk];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            acc[r] = __dp4a(reinterpret_cast<const int*>(xs + r * kKT)[kk], wv, acc[r]);
        }
      }
      __syncthreads();
    }
    if (t < nv) {
      const int n = n0 + t;
      const float s = L.w_scale[n], b = L.bias[n];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          const float y = __fadd_rn(__fmul_rn(__int2float_rn(acc[r]), s), b);
          if (next_scale) {
            img_out[r * L.N + n] = quantize(fmaxf(y, 0.f), next_scale[n]);
          } else {
            out[(size_t)(row0 + r) * L.N + n] = y;
          }
        }
      }
    }
  }
  __syncthreads();  // img_out complete before the next layer stages it
}

__global__ void __launch_bounds__(kThreads)
int8_trunk_kernel(const float* __restrict__ x, Layer l0, Layer l1, Layer lm, float* __restrict__ out,
                  int8_t* scratch, int B) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* xs = smem;
  int8_t* ws = smem + kRows * kKT;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, B - row0);
  int8_t* img0 = scratch ? scratch + (size_t)blockIdx.x * kRows * (l0.N + l1.N) : smem + kTileBytes;
  int8_t* img1 = img0 + kRows * l0.N;
  layer(l0, x, nullptr, l1.in_scale, img0, nullptr, row0, rows, xs, ws);
  layer(l1, nullptr, img0, lm.in_scale, img1, nullptr, row0, rows, xs, ws);
  layer(lm, nullptr, img1, nullptr, nullptr, out, row0, rows, xs, ws);
}

// the block's two hidden int8 images fit shared memory beside the tiles
bool images_fit(int H0, int H1) {
  return kTileBytes + static_cast<long long>(kRows) * (H0 + H1) <= kSmemLimit;
}

}  // namespace

// The device-memory scratch fused_int8_trunk_forward needs for B rows and
// hidden widths H0, H1: 0 when the hidden images fit shared memory.
extern "C" long long fused_int8_trunk_scratch_bytes(int B, int H0, int H1) {
  if (images_fit(H0, H1)) return 0;
  return static_cast<long long>((B + kRows - 1) / kRows) * kRows * (H0 + H1);
}

// x [B, Dx] f32; per layer in_scale [in] f32, w_q [out, in] int8, w_scale
// [out] f32, bias [out] f32; out [B, A] f32. `scratch` holds
// fused_int8_trunk_scratch_bytes(B, H0, H1) bytes of device memory, or is
// null when that is 0. Returns a cudaError_t.
extern "C" int fused_int8_trunk_forward(const void* x, const void* s0, const void* w0,
                                        const void* ws0, const void* b0, const void* s1,
                                        const void* w1, const void* ws1, const void* b1,
                                        const void* sm, const void* wm, const void* wsm,
                                        const void* bm, void* out, void* scratch, int B, int Dx,
                                        int H0, int H1, int A, void* stream) {
  if (B < 1 || Dx < 1 || H0 < 1 || H1 < 1 || A < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Layer l0{static_cast<const float*>(s0), static_cast<const int8_t*>(w0),
                 static_cast<const float*>(ws0), static_cast<const float*>(b0), Dx, H0};
  const Layer l1{static_cast<const float*>(s1), static_cast<const int8_t*>(w1),
                 static_cast<const float*>(ws1), static_cast<const float*>(b1), H0, H1};
  const Layer lm{static_cast<const float*>(sm), static_cast<const int8_t*>(wm),
                 static_cast<const float*>(wsm), static_cast<const float*>(bm), H1, A};
  if ((scratch == nullptr) != images_fit(H0, H1)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kTileBytes + (scratch ? 0 : static_cast<size_t>(kRows) * (H0 + H1));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_trunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (B + kRows - 1) / kRows;
  int8_trunk_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), l0, l1, lm, static_cast<float*>(out),
      static_cast<int8_t*>(scratch), B);
  return static_cast<int>(cudaGetLastError());
}
