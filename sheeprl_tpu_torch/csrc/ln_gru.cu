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
// What bounds it on an H100: at serving and scan batch (B <= 16) the work
// is a matrix-vector product, so the time is reading W once (1536 x 1024 x
// 4 B = 6.3 MB in f32 at DreamerV3 width) at 3.35 TB/s. At training batch
// (B = 1024) it is the 2*B*K*3H multiply-adds: in f32 three TF32 tensor-core
// products each (3xTF32, csrc/mma_common.cuh), in bf16 one bf16 product.
//
// Design (two launches, no library call):
//  1. gru_proj_kernel: a block owns BM rows (16 at B <= 16, else 64) x 128
//     output columns of parts and one split of the reduction axis. K steps
//     through a ring of four shared-memory stages, 128 bytes of K a row
//     each, filled with 16-byte cp.async copies: the next three stages load
//     while the current one is multiplied. The [x, h] operand is read from
//     the two tensors, K split at Dx. Eight warps own m16n8 sub-tiles
//     (32 x 32 a warp at BM = 64, 16 x 16 at BM = 16) and multiply on the
//     tensor cores: mma.sync m16n8k16 bf16 with ldmatrix fragments, or
//     m16n8k8 3xTF32 in f32. Ragged rows, columns and K are zero-filled in
//     shared memory; a row whose byte length is not a multiple of 16 is
//     copied 4 bytes at a time, or an element at a time where 4 bytes do not
//     divide it either. At small B the reduction axis is split so that the
//     grid covers every SM and W is streamed by the whole card; partial sums
//     go to an f32 scratch [splits, B, 3H]. The launch plan (BM, splits,
//     each split's K, shared memory) is ops/kernels/gru.py:launch_plan.
//  2. gru_row_kernel, launched as a programmatic dependent of the
//     projection (its launch overlaps the projection's tail; it waits for
//     the partial sums with griddepcontrol.wait): one block per row (1,024
//     threads at B <= 64, else 256) sums the partials in a fixed order,
//     keeps the 3H row in shared memory, block-reduces the mean and then the
//     variance of the centred values (the two-pass order of the TPU
//     kernel), and applies scale/offset and the gates in f32. h' is written
//     in x's dtype; with residuals requested it also writes hat and rstd
//     (f32), which costs 3H + 1 floats a row more than the plain forward.
// Measured (chip_smoke.py phase 3, NVIDIA H100 80GB HBM3 at 700 W): f32
// 13.8 us at B = 8, 14.4 us at B = 16, 104.4 us at B = 1,024 (the CUDA-core
// version before it: 21.3 us at B = 8); bf16 11.1, 11.7 and 43.7 us. At
// B <= 16 it is two launches (the phase-5 profile: projection 6.5 us, row
// pass 5.2 us) against 1.9 us of weight bytes; at B = 1,024 the copy loop's
// instructions and mma.sync's rate against 19.5 us of 3xTF32 operations
// (wgmma fed by TMA is the next step).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "mma_common.cuh"

namespace {

using namespace mma_common;

__device__ __forceinline__ float sigmoid_f(float v) { return 1.f / (1.f + expf(-v)); }

constexpr int kCols = 128;          // output columns per block
constexpr int kStages = 4;          // shared-memory ring depth
constexpr int kRowBytes = 128;      // bytes of K per stage and row
constexpr int kLdBytes = kRowBytes + 16;  // padded row: conflict-free fragment reads
constexpr int kProjThreads = 256;   // eight warps
constexpr int kRowThreads = 1024;    // at most; 256 a row at large B

template <typename T, int BM>
__global__ void __launch_bounds__(kProjThreads)
gru_proj_kernel(const T* __restrict__ x, const T* __restrict__ h,
                const T* __restrict__ w, float* __restrict__ parts, int B,
                int Dx, int H, int k_per_split, int mode_a, int mode_w) {
  constexpr int kE = 16 / sizeof(T);         // elements of a 16-byte chunk
  constexpr int kBK = kRowBytes / sizeof(T);  // K per stage: 32 f32, 64 bf16
  constexpr int kLd = kLdBytes / sizeof(T);
  constexpr int kChunks = kBK / kE;           // chunks per row and stage: 8
  constexpr int kWarpsM = BM >= 32 ? BM / 32 : 1;
  constexpr int kWarpsN = 8 / kWarpsM;
  constexpr int kMT = BM / (16 * kWarpsM);    // m16 tiles a warp
  constexpr int kNT = kCols / (8 * kWarpsN);  // n8 tiles a warp
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static_assert(kNT % 2 == 0, "B fragments are loaded two n8 tiles at a time");

  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);  // [kStages][BM][kLd]
  T* Ws = As + kStages * BM * kLd;     // [kStages][kCols][kLd]

  const int N = 3 * H;
  const int K = Dx + H;
  const int n0 = blockIdx.x * kCols;
  const int b0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int ktiles = (k_end - k_begin + kBK - 1) / kBK;

  // one stage: rows b0 ... b0 + BM - 1 of [x, h] and rows n0 ... n0 + 127
  // of W, K from kc, each as 16-byte chunks (zeros past the edges)
  auto load_tile = [&](int stage, int kt) {
    const int kc = k_begin + kt * kBK;
    T* as = As + stage * BM * kLd;
    T* ws = Ws + stage * kCols * kLd;
    const int kk = (threadIdx.x % kChunks) * kE, gk = kc + kk;  // a thread keeps its column of chunks
    constexpr int kStride = kProjThreads / kChunks;  // rows a pass
#pragma unroll
    for (int i = 0; i < (BM + kCols + kStride - 1) / kStride; ++i) {
      const int r = threadIdx.x / kChunks + i * kStride;
      if (r >= BM + kCols) break;
      if (r < BM) {
        const int b = b0 + r;
        T* dst = as + r * kLd + kk;
        if (mode_a == kCopyScalar) {  // a chunk may straddle Dx
#pragma unroll
          for (int e = 0; e < kE; ++e) {
            const int k = gk + e;
            dst[e] = (b < B && k < k_end)
                         ? (k < Dx ? x[(size_t)b * Dx + k] : h[(size_t)b * H + (k - Dx)])
                         : from_f<T>(0.f);
          }
        } else if (b >= B || gk >= k_end) {
          copy_chunk(dst, x, 0, mode_a);
        } else if (gk < Dx) {  // Dx is a multiple of kE: the chunk lies in x
          copy_chunk(dst, x + (size_t)b * Dx + gk, min(kE, min(Dx, k_end) - gk), mode_a);
        } else {
          copy_chunk(dst, h + (size_t)b * H + (gk - Dx), min(kE, k_end - gk), mode_a);
        }
      } else {
        const int n = n0 + r - BM;
        const bool live = n < N && gk < k_end;
        copy_chunk(ws + (r - BM) * kLd + kk, live ? w + (size_t)n * K + gk : w,
                   live ? min(kE, k_end - gk) : 0, mode_w);
      }
    }
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = (warp / kWarpsN) * kMT * 16;
  const int col0 = (warp % kWarpsN) * kNT * 8;

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_tile(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt has landed; stage kt - 1 is free again
    if (kt + kStages - 1 < ktiles) load_tile((kt + kStages - 1) % kStages, kt + kStages - 1);
    cp_async_commit();

    const T* as = As + (kt % kStages) * BM * kLd;
    const T* ws = Ws + (kt % kStages) * kCols * kLd;
    if constexpr (kBf16) {
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        uint32_t a[kMT][4], b[kNT][2];
#pragma unroll
        for (int i = 0; i < kMT; ++i)
          ldmatrix_x4(a[i], as + (row0 + 16 * i + lane % 16) * kLd + kk + (lane / 16) * 8);
#pragma unroll
        for (int j = 0; j < kNT; j += 2) {
          uint32_t r[4];
          ldmatrix_x4(r, ws + (col0 + 8 * j + lane % 8 + (lane / 16) * 8) * kLd + kk + ((lane / 8) % 2) * 8);
          b[j][0] = r[0]; b[j][1] = r[1]; b[j + 1][0] = r[2]; b[j + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j) mma_bf16(acc[i][j], a[i], b[j]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 8) {
        uint32_t ah[kMT][4], al[kMT][4], bh[kNT][2], bl[kNT][2];
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          const float* p = reinterpret_cast<const float*>(as) + (row0 + 16 * i + g) * kLd + kk + t;
          const float v[4] = {p[0], p[8 * kLd], p[4], p[8 * kLd + 4]};
          split_tf32(v, ah[i], al[i]);
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const float* p = reinterpret_cast<const float*>(ws) + (col0 + 8 * j + g) * kLd + kk + t;
          const float v[2] = {p[0], p[4]};
          split_tf32(v, bh[j], bl[j]);
        }
        // each 3xTF32 term for every sub-tile before the next term, so that
        // consecutive MMAs write different accumulators
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j) mma_tf32(acc[i][j], al[i], bh[j]);
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j) mma_tf32(acc[i][j], ah[i], bl[j]);
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j) mma_tf32(acc[i][j], ah[i], bh[j]);
      }
    }
  }
  cp_async_wait<0>();
  // the row pass may launch now (programmatic dependent launch): its blocks
  // start while these finish, and wait for this grid's results
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  float* out = parts + (size_t)blockIdx.z * B * N;
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int col = n0 + col0 + 8 * j + 2 * t;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = b0 + row0 + 16 * i + g + 8 * (q / 2);
        const int cq = col + q % 2;
        if (row < B && cq < N) out[(size_t)row * N + cq] = acc[i][j][q];
      }
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

// kResiduals names the instantiation that writes `hat` and `rstd` (the
// forward under autodiff); the code is the same, so a profile can tell the
// two wrappers' launches apart by the kernel's name alone
template <typename T, bool kResiduals>
__global__ void __launch_bounds__(kRowThreads)
gru_row_kernel(const float* __restrict__ parts, const T* __restrict__ h,
               const float* __restrict__ scale, const float* __restrict__ offset,
               T* __restrict__ out, float* __restrict__ hat, float* __restrict__ rstd_out,
               int B, int H, int splits, float eps) {
  extern __shared__ float row[];  // the 3H parts of this batch row
  __shared__ float red[kRowThreads / 32];
  const int threads = blockDim.x;
  const int b = blockIdx.x;
  // launched as a programmatic dependent of the projection: wait until it
  // has finished and its partial sums are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int N = 3 * H;

  float s = 0.f;
  for (int j = threadIdx.x; j < N; j += threads) {
    float v = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < splits; ++sp) v += parts[((size_t)sp * B + b) * N + j];
    row[j] = v;
    s += v;
  }
  const float mean = block_sum(s, red) / N;
  float q = 0.f;
  for (int j = threadIdx.x; j < N; j += threads) {
    const float c = row[j] - mean;
    q += c * c;
  }
  const float var = block_sum(q, red) / N;
  const float rstd = rsqrtf(var + eps);
  if (rstd_out != nullptr && threadIdx.x == 0) rstd_out[b] = rstd;

  for (int i = threadIdx.x; i < H; i += threads) {
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

template <typename T, int BM>
int launch_proj(const T* x, const T* h, const T* w, float* parts, int B, int Dx, int H,
                int splits, int k_per_split, cudaStream_t stream) {
  constexpr int kE = 16 / sizeof(T);
  const int smem = kStages * (BM + kCols) * kLdBytes;
  const cudaError_t err = cudaFuncSetAttribute(gru_proj_kernel<T, BM>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int mode_a = copy_mode<T>(x, Dx);
  const int mode_h = copy_mode<T>(h, H);
  if (mode_h > mode_a) mode_a = mode_h;
  if (Dx % kE != 0) mode_a = kCopyScalar;  // a chunk would straddle x and h
  const int mode_w = copy_mode<T>(w, static_cast<long long>(Dx) + H);
  const dim3 grid((3 * H + kCols - 1) / kCols, (B + BM - 1) / BM, splits);
  gru_proj_kernel<T, BM><<<grid, kProjThreads, smem, stream>>>(x, h, w, parts, B, Dx, H, k_per_split,
                                                               mode_a, mode_w);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* h, const void* w, const float* scale,
           const float* offset, float* parts, void* out, float* hat, float* rstd, int B,
           int Dx, int H, int bm, int splits, int k_per_split, float eps, cudaStream_t stream) {
  const int K = Dx + H;
  constexpr int kBK = kRowBytes / sizeof(T);
  // the plan must cover K exactly, in whole stages, with no empty split
  if (k_per_split < 1 || k_per_split % kBK != 0 || (long long)(splits - 1) * k_per_split >= K ||
      (long long)splits * k_per_split < K)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xt = static_cast<const T*>(x);
  const auto* ht = static_cast<const T*>(h);
  const auto* wt = static_cast<const T*>(w);
  int err;
  if (bm == 16) {
    err = launch_proj<T, 16>(xt, ht, wt, parts, B, Dx, H, splits, k_per_split, stream);
  } else if (bm == 64) {
    err = launch_proj<T, 64>(xt, ht, wt, parts, B, Dx, H, splits, k_per_split, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return err;
  const int N = 3 * H;
  const size_t smem = static_cast<size_t>(N) * sizeof(float);
  const auto row_kernel = hat != nullptr ? gru_row_kernel<T, true> : gru_row_kernel<T, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(row_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // a row's split sums are L2 round trips: at small B (few blocks) more
  // threads a row keep more of them in flight
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B);
  cfg.blockDim = dim3(B <= 64 ? kRowThreads : 256);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;  // overlap its launch with the projection
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, row_kernel, static_cast<const float*>(parts), ht, scale,
                                           offset, static_cast<T*>(out), hat, rstd, B, H, splits, eps);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, h, w and out); scale/offset, the
// scratch `parts` [splits, B, 3H] and the residuals `hat` [B, 3H] and `rstd`
// [B] are float32. `hat` and `rstd` are both null (the plain forward) or
// both set (the forward under autodiff). The plan (bm 16 or 64, splits,
// k_per_split, a multiple of the stage depth) comes from
// ops/kernels/gru.py:launch_plan. Returns a cudaError_t.
extern "C" int ln_gru_forward(int dtype, const void* x, const void* h, const void* w,
                              const void* scale, const void* offset, void* parts,
                              void* out, void* hat, void* rstd, int B, int Dx, int H,
                              int bm, int splits, int k_per_split, float eps, void* stream) {
  if ((hat == nullptr) != (rstd == nullptr) || splits < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* sc = static_cast<const float*>(scale);
  const auto* of = static_cast<const float*>(offset);
  auto* pp = static_cast<float*>(parts);
  auto* ht = static_cast<float*>(hat);
  auto* rs = static_cast<float*>(rstd);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, h, w, sc, of, pp, out, ht, rs, B, Dx, H, bm, splits, k_per_split, eps, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, h, w, sc, of, pp, out, ht, rs, B, Dx, H, bm, splits, k_per_split, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
