// The DreamerV3 RSSM dynamic step as one kernel, for Hopper (sm_90a).
//
// Replaces the TPU kernel sheeprl_tpu/ops/pallas_kernels.py:_fused_rssm_forward
// (`fused_rssm_step`), which computes `_rssm_step_math`:
//   z     = act(LN(x @ Wm))                        RecurrentModel.mlp, eps 1e-3
//   h'    = LayerNormGRU(z, h; Wg)                 LN over 3R (eps 1e-5), then
//           update = sigmoid(u - 1), cand = tanh(sigmoid(r) * c),
//           h' = update * cand + (1 - update) * h
//   prior = act(LN(h' @ Wt1)) @ Wt2 + bt2          transition head, eps 1e-3
//   post  = act(LN([h', emb] @ Wr1)) @ Wr2 + br2   representation head
// Matrix operands are in the compute dtype (float32 or bfloat16) and every
// product accumulates in f32; z, h', t1 and r1 are rounded to the compute
// dtype exactly where the reference rounds them, and the heads read the
// rounded h'. prior_raw and post_raw stay f32 with their biases added in
// f32. Weights arrive in the port's Linear layout, [out, in], so each
// output column reads one contiguous weight row.
//
// What bounds it on an H100: at the training path's shape (B = 16 rows,
// R = E = hidden = 512, S*D = 1024, 2 actions) one step reads 3.93 M
// weights (7.9 MB in bf16) and does 2 * 16 * 3.93 M operations: 2.35 us of
// bytes at 3.35 TB/s against 0.13 us of bf16 tensor-core operations, so
// reading the weights bounds it. 7.9 MB stays resident in the 50 MB L2
// across the 64 steps of a sequence. This version is far from that bound
// (about 70 us a launch on an H100 80GB HBM3 at 700 W, chip_smoke.py phase
// 3): each stage's operand rebuild and the products' shared-memory reads
// are latency one block waits on in series; tensor-core MMA on the bf16
// tile and a reduction split across warps are the next steps.
//
// Design: one cooperative launch (a grid that is co-resident, sized from
// the occupancy calculator) in four stages separated by grid-wide syncs:
//   1. x @ Wm                     -> z_pre  [B, D]   f32 scratch
//   2. [z, h] @ Wg                -> g_pre  [B, 3R]  f32 scratch
//   3. h' @ Wt1, [h', emb] @ Wr1  -> t1_pre, r1_pre  f32 scratch
//   4. t1 @ Wt2 + bt2, r1 @ Wr2 + br2 -> prior_raw, post_raw
// Every stage splits its output columns into units of 32 columns x 16 rows
// (one row tile), spread over the grid in contiguous ranges. Before its
// first unit of a row tile a block builds that tile's left operand in
// shared memory as f32 (values already rounded to the compute dtype):
// after a sync the whole block copies the previous stage's f32
// pre-activations of the tile from L2 into shared memory, a warp a row
// recomputes the LayerNorm statistics (the reference's two-pass order: the
// mean, then the mean of squared deviations), and a thread a column applies
// the affine, the activation or the GRU gates. In the products each of the
// 16 warps owns two output columns: its lanes stride the reduction axis
// (coalesced weight reads, conflict-free shared reads), each lane keeps
// 2 x 16 partial sums, and a transposing butterfly of 31 shuffles leaves
// one finished output in each lane. The products run on the CUDA cores in
// f32 in both dtypes.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 16;                          // rows per tile
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kColsPerWarp = 2;
constexpr int kCols = kWarps * kColsPerWarp;       // output columns per unit
constexpr int kUnroll = 4;                         // reduction steps in flight
static_assert(kWarps == kRows, "the statistics pass gives each row a warp");

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

// the value as the compute dtype holds it
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

// the hardware's exp2 (a few ulp from expf) and a correctly rounded
// reciprocal, in a fraction of the instructions of expf and a division
__device__ __forceinline__ float sigmoid_f(float v) { return __frcp_rn(1.f + __expf(-v)); }

// activation codes, as ops/kernels/rssm.py:ACT_CODES numbers them
__device__ __forceinline__ float apply_act(float v, int act) {
  switch (act) {
    case 0: return v * sigmoid_f(v);                          // silu
    case 1: return fmaxf(v, 0.f);                             // relu
    case 2: return tanhf(v);                                  // tanh
    case 3: return v > 0.f ? v : expm1f(v);                   // elu, alpha 1
    case 4: {                                                 // gelu, tanh form
      const float k = 0.7978845608028654f;                    // sqrt(2 / pi)
      return 0.5f * v * (1.f + tanhf(k * (v + 0.044715f * v * v * v)));
    }
    default: return v;                                        // identity
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Params {
  const void* x; const void* h; const void* emb;
  const void* wm; const float* sm; const float* om;
  const void* wg; const float* sg; const float* og;
  const void* wt1; const float* st1; const float* ot1;
  const void* wt2; const float* bt2;
  const void* wr1; const float* sr1; const float* or1;
  const void* wr2; const float* br2;
  void* h_out; float* prior; float* post;
  float* z_pre; float* g_pre; float* t1_pre; float* r1_pre;  // f32 scratch
  int B, Dx, R, D, Hd, E, SD;
  int lda, ldp;  // row strides of the operand tile A and the pre-activation tile P
  bool vec;      // 16-byte copies of the scratch rows (D, R, Hd % 4 == 0)
  float mlp_eps, gru_eps, head_eps;
  int act;
};

// One matrix product of a stage: out[:, :n] = A[:, a_off : a_off + k] @ w^T
// (+ bias), w [n, k] row-major.
struct Segment {
  const void* w;
  int n, k, a_off;
  float* out;
  const float* bias;
};

// Staging a tile is latency-bound: every loop below keeps each thread's
// loads independent of one another and of any branch, so that an unrolled
// loop issues them back to back (a first version paid an L2 latency per
// element). Each code path runs only a few times a launch, so the helpers
// are not inlined: one copy each, shared by the stages, keeps the code
// small.

// Copy the tile's rows (rt * 16 ... + 15) of a row-major [B, n] f32 array
// written earlier in this launch by other blocks (so read through L2,
// `__ldcg`) into shared memory at dst (row stride ld), rows past B zero.
// With `vec` (n % 4 == 0, the array and dst 16-byte aligned, ld % 4 == 0)
// the copy moves 16 bytes a load.
__device__ __noinline__ void load_pre(const float* __restrict__ src, int n, int rt, int B,
                                      float* __restrict__ dst, int ld, bool vec) {
  if (vec) {
    const int nv = n >> 2;
#pragma unroll 8
    for (int e = threadIdx.x; e < kRows * nv; e += kThreads) {
      const int r = e / nv, k = (e - r * nv) << 2;
      const int row = rt * kRows + r;
      const float4 v = row < B ? __ldcg(reinterpret_cast<const float4*>(src + (size_t)row * n + k))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(dst + r * ld + k) = v;
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < kRows * n; e += kThreads) {
      const int r = e / n, k = e - r * n;
      const int row = rt * kRows + r;
      dst[r * ld + k] = row < B ? __ldcg(src + (size_t)row * n + k) : 0.f;
    }
  }
}

// The same for an input in the compute dtype (x, h, emb; read-only), as f32.
template <typename T>
__device__ __noinline__ void load_input(const T* __restrict__ src, int n, int rt, int B,
                                        float* __restrict__ dst, int ld) {
#pragma unroll 8
  for (int e = threadIdx.x; e < kRows * n; e += kThreads) {
    const int r = e / n, k = e - r * n;
    const int row = rt * kRows + r;
    dst[r * ld + k] = row < B ? to_f(__ldg(src + (size_t)row * n + k)) : 0.f;
  }
}

// LayerNorm statistics {mean, rstd} of n f32 values in shared memory, in
// the reference's two-pass order (the mean, then the mean of squared
// deviations), by one warp.
__device__ __noinline__ float2 row_stats(const float* row, int n, float eps) {
  const int lane = threadIdx.x % 32;
  float s = 0.f;
#pragma unroll 8
  for (int k = lane; k < n; k += 32) s += row[k];
  const float mean = warp_sum(s) / n;
  float q = 0.f;
#pragma unroll 8
  for (int k = lane; k < n; k += 32) {
    const float c = row[k] - mean;
    q += c * c;
  }
  return make_float2(mean, rsqrtf(warp_sum(q) / n + eps));
}

// A[r, :n] = act(LN(pre[r, :n])) rounded to T for the tile's 16 rows (rows
// past B zero), a thread per column: the column's scale and offset are read
// once, the rows come from shared memory.
template <typename T>
__device__ __noinline__ void ln_act_tile(const float* pre, int ldp, const float2* st, int n,
                                         const float* scale, const float* offset, int act, int live,
                                         float* A, int lda) {
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const float sc = __ldg(scale + k), of = __ldg(offset + k);
#pragma unroll 2
    for (int r = 0; r < kRows; ++r) {
      const float v = (pre[r * ldp + k] - st[2 * r].x) * st[2 * r].y * sc + of;
      A[r * lda + k] = r < live ? round_to<T>(apply_act(v, act)) : 0.f;
    }
  }
}

// Build the left operand of STAGE for row tile `rt` in shared memory: row r
// of the tile at A + r * lda, rows past B zero. In three block-wide steps:
//   1. copy the previous stage's f32 pre-activations of the tile into P
//      (row stride ldp) and the tile's inputs (h, emb) into A;
//   2. the LayerNorm statistics of each row (and segment), a warp a row,
//      into stats;
//   3. a thread per column: the affine, the activation or the GRU gates,
//      rounded to T, into A.
template <typename T, int STAGE>
__device__ void stage_operand(const Params& p, float* A, float* P, float2 (*stats)[2], int rt) {
  if constexpr (STAGE == 1) {
    load_input(static_cast<const T*>(p.x), p.Dx, rt, p.B, A, p.lda);
  } else {
    if constexpr (STAGE == 2) {  // [z, h]: z_pre -> P, h -> A[:, D:]
      load_pre(p.z_pre, p.D, rt, p.B, P, p.ldp, p.vec);
      load_input(static_cast<const T*>(p.h), p.R, rt, p.B, A + p.D, p.lda);
    } else if constexpr (STAGE == 3) {  // [h', emb]: g_pre -> P, h -> A[:, :R], emb -> A[:, R:]
      load_pre(p.g_pre, 3 * p.R, rt, p.B, P, p.ldp, p.vec);
      load_input(static_cast<const T*>(p.h), p.R, rt, p.B, A, p.lda);
      load_input(static_cast<const T*>(p.emb), p.E, rt, p.B, A + p.R, p.lda);
    } else {  // [t1, r1]: t1_pre -> P[:, :Hd], r1_pre -> P[:, Hd:]
      load_pre(p.t1_pre, p.Hd, rt, p.B, P, p.ldp, p.vec);
      load_pre(p.r1_pre, p.Hd, rt, p.B, P + p.Hd, p.ldp, p.vec);
    }
    __syncthreads();
    {
      const int r = threadIdx.x / 32;  // one warp a row
      const float* pre = P + r * p.ldp;
      if constexpr (STAGE == 2) {
        stats[r][0] = row_stats(pre, p.D, p.mlp_eps);
      } else if constexpr (STAGE == 3) {
        stats[r][0] = row_stats(pre, 3 * p.R, p.gru_eps);
      } else {
        const float2 a = row_stats(pre, p.Hd, p.head_eps);
        const float2 b = row_stats(pre + p.Hd, p.Hd, p.head_eps);
        stats[r][0] = a;
        stats[r][1] = b;
      }
    }
    __syncthreads();
    const int live = min(kRows, p.B - rt * kRows);  // rows of the tile below B
    if constexpr (STAGE == 2) {
      ln_act_tile<T>(P, p.ldp, &stats[0][0], p.D, p.sm, p.om, p.act, live, A, p.lda);
    } else if constexpr (STAGE == 3) {  // the LN-GRU gates; A[r, i] holds h and becomes h'
      for (int i = threadIdx.x; i < p.R; i += kThreads) {
        const int c = p.R + i, u = 2 * p.R + i;
        const float sr = __ldg(p.sg + i), orr = __ldg(p.og + i);
        const float sc = __ldg(p.sg + c), oc = __ldg(p.og + c);
        const float su = __ldg(p.sg + u), ou = __ldg(p.og + u);
#pragma unroll 2
        for (int r = 0; r < kRows; ++r) {
          const float* pre = P + r * p.ldp;
          const float2 st = stats[r][0];
          const float r_ = (pre[i] - st.x) * st.y * sr + orr;
          const float c_ = (pre[c] - st.x) * st.y * sc + oc;
          const float u_ = (pre[u] - st.x) * st.y * su + ou;
          const float update = sigmoid_f(u_ - 1.f);
          const float cand = tanhf(sigmoid_f(r_) * c_);
          float* a = A + r * p.lda + i;
          *a = r < live ? round_to<T>(update * cand + (1.f - update) * *a) : 0.f;
        }
      }
    } else {
      ln_act_tile<T>(P, p.ldp, &stats[0][0], p.Hd, p.st1, p.ot1, p.act, live, A, p.lda);
      ln_act_tile<T>(P + p.Hd, p.ldp, &stats[0][1], p.Hd, p.sr1, p.or1, p.act, live, A + p.Hd, p.lda);
    }
  }
}

// One step of the transposing butterfly over the lanes' 32 partial sums:
// the lower half of the values stays with the lanes whose bit OFF is clear,
// the upper half with the others, each summed with its partner's. Every
// index is a compile-time constant, so v stays in registers (a select
// between two array elements would be an address select, which puts v in
// local memory).
template <int OFF>
__device__ __forceinline__ void butterfly_step(float (&v)[2 * 16], int lane) {
  const bool upper = (lane & OFF) != 0;
#pragma unroll
  for (int j = 0; j < OFF; ++j) {
    const float lo = v[j], hi = v[j + OFF];
    const float send = upper ? lo : hi;
    const float keep = upper ? hi : lo;
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

// One unit: kCols output columns of segment `s` for row tile `rt`; warp w owns
// columns c0 + 2w and c0 + 2w + 1.
template <typename T>
__device__ __noinline__ void product_unit(const Segment& s, const float* A, int lda, int rt, int chunk, int B) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = chunk * kCols + warp * kColsPerWarp;
  if (n0 >= s.n) return;  // warp-uniform: the whole warp has no column
  const T* w = static_cast<const T*>(s.w);
  const T* w0 = w + (size_t)n0 * s.k;
  const T* w1 = w + (size_t)min(n0 + 1, s.n - 1) * s.k;  // a ragged last column repeats
  const float* a = A + s.a_off;

  float v[kColsPerWarp * kRows];
#pragma unroll
  for (int i = 0; i < kColsPerWarp * kRows; ++i) v[i] = 0.f;

  int k = lane;
  for (; k + 32 * (kUnroll - 1) < s.k; k += 32 * kUnroll) {
    float wv0[kUnroll], wv1[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      wv0[q] = to_f(__ldg(w0 + k + 32 * q));
      wv1[q] = to_f(__ldg(w1 + k + 32 * q));
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float av = a[r * lda + k + 32 * q];
        v[r] = fmaf(av, wv0[q], v[r]);
        v[kRows + r] = fmaf(av, wv1[q], v[kRows + r]);
      }
    }
  }
  for (; k < s.k; k += 32) {
    const float wv0 = to_f(__ldg(w0 + k));
    const float wv1 = to_f(__ldg(w1 + k));
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float av = a[r * lda + k];
      v[r] = fmaf(av, wv0, v[r]);
      v[kRows + r] = fmaf(av, wv1, v[kRows + r]);
    }
  }

  // transposing butterfly: afterwards lane i holds the warp's total of
  // value i (column i / 16, row i % 16) in v[0]
  butterfly_step<16>(v, lane);
  butterfly_step<8>(v, lane);
  butterfly_step<4>(v, lane);
  butterfly_step<2>(v, lane);
  butterfly_step<1>(v, lane);
  const int col = n0 + lane / kRows;
  const int row = rt * kRows + lane % kRows;
  if (col < s.n && row < B) {
    const float out = s.bias != nullptr ? v[0] + s.bias[col] : v[0];
    s.out[(size_t)row * s.n + col] = out;
  }
}

__device__ __forceinline__ int chunks(int n) { return (n + kCols - 1) / kCols; }

template <typename T, int STAGE>
__device__ void run_stage(const Params& p, float* A, float* P, float2 (*stats)[2],
                          const Segment& s0, const Segment& s1, int nseg) {
  const int c0 = chunks(s0.n);
  const int per_tile = c0 + (nseg > 1 ? chunks(s1.n) : 0);
  const int tiles = (p.B + kRows - 1) / kRows;
  const long long units = (long long)tiles * per_tile;
  const long long begin = units * blockIdx.x / gridDim.x;
  const long long end = units * (blockIdx.x + 1) / gridDim.x;
  int staged = -1;
  for (long long u = begin; u < end; ++u) {
    const int rt = static_cast<int>(u / per_tile);
    int c = static_cast<int>(u % per_tile);
    if (rt != staged) {
      __syncthreads();  // every warp is done with the previous tile
      stage_operand<T, STAGE>(p, A, P, stats, rt);
      __syncthreads();
      staged = rt;
    }
    if (STAGE == 3 && c == 0) {  // h' leaves the kernel once per row tile
      T* h_out = static_cast<T*>(p.h_out);
      for (int e = threadIdx.x; e < kRows * p.R; e += kThreads) {
        const int r = e / p.R, i = e % p.R;
        const int row = rt * kRows + r;
        if (row < p.B) h_out[(size_t)row * p.R + i] = from_f<T>(A[r * p.lda + i]);
      }
    }
    if (c < c0) {
      product_unit<T>(s0, A, p.lda, rt, c, p.B);
    } else {
      product_unit<T>(s1, A, p.lda, rt, c - c0, p.B);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) fused_rssm_kernel(const Params p) {
  extern __shared__ float4 smem[];
  float* A = reinterpret_cast<float*>(smem);  // the left operand: kRows x lda, f32
  float* P = A + kRows * p.lda;               // pre-activations: kRows x ldp, f32
  __shared__ float2 stats[kRows][2];          // each row's LayerNorm {mean, rstd}, two segments
  cg::grid_group grid = cg::this_grid();

  const Segment s1{p.wm, p.D, p.Dx, 0, p.z_pre, nullptr};
  run_stage<T, 1>(p, A, P, stats, s1, s1, 1);
  grid.sync();
  const Segment s2{p.wg, 3 * p.R, p.D + p.R, 0, p.g_pre, nullptr};
  run_stage<T, 2>(p, A, P, stats, s2, s2, 1);
  grid.sync();
  const Segment s3t{p.wt1, p.Hd, p.R, 0, p.t1_pre, nullptr};
  const Segment s3r{p.wr1, p.Hd, p.R + p.E, 0, p.r1_pre, nullptr};
  run_stage<T, 3>(p, A, P, stats, s3t, s3r, 2);
  grid.sync();
  const Segment s4t{p.wt2, p.SD, p.Hd, 0, p.prior, p.bt2};
  const Segment s4r{p.wr2, p.SD, p.Hd, p.Hd, p.post, p.br2};
  run_stage<T, 4>(p, A, P, stats, s4t, s4r, 2);
}

int max_units_per_tile(const Params& p) {
  auto ch = [](int n) { return (n + kCols - 1) / kCols; };
  int m = ch(p.D);
  if (ch(3 * p.R) > m) m = ch(3 * p.R);
  if (2 * ch(p.Hd) > m) m = 2 * ch(p.Hd);
  if (2 * ch(p.SD) > m) m = 2 * ch(p.SD);
  return m;
}

template <typename T>
int launch(Params p, cudaStream_t stream) {
  int lda = p.Dx;
  if (p.D + p.R > lda) lda = p.D + p.R;
  if (p.R + p.E > lda) lda = p.R + p.E;
  if (2 * p.Hd > lda) lda = 2 * p.Hd;
  p.lda = lda;
  int ldp = p.D;
  if (3 * p.R > ldp) ldp = 3 * p.R;
  if (2 * p.Hd > ldp) ldp = 2 * p.Hd;
  p.ldp = ldp;
  const size_t smem = static_cast<size_t>(kRows) * (lda + ldp) * sizeof(float);
  const void* fn = reinterpret_cast<const void*>(fused_rssm_kernel<T>);
  cudaError_t err = cudaFuncSetAttribute(fused_rssm_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_rssm_kernel<T>, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const long long tiles = (p.B + kRows - 1) / kRows;
  const long long units = tiles * max_units_per_tile(p);
  long long grid = static_cast<long long>(sms) * per_sm;
  if (units < grid) grid = units;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(fn, dim3(static_cast<unsigned>(grid)), dim3(kThreads), args,
                                    smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, h, emb, the six weight matrices and
// h_out); act: 0 silu, 1 relu, 2 tanh, 3 elu, 4 gelu (tanh form), 5
// identity. The LN scales and offsets, the head biases, prior_raw and
// post_raw [B, SD] and the scratch [B, D + 3R + 2Hd] are float32. Weights
// are [out, in]: wm [D, Dx], wg [3R, D + R], wt1 [Hd, R], wt2 [SD, Hd],
// wr1 [Hd, R + E], wr2 [SD, Hd]. Returns a cudaError_t; a grid that cannot
// be co-resident is refused (cudaErrorCooperativeLaunchTooLarge), never
// run another way.
extern "C" int fused_rssm_forward(
    int dtype, int act, const void* x, const void* h, const void* emb, const void* wm,
    const void* sm, const void* om, const void* wg, const void* sg, const void* og,
    const void* wt1, const void* st1, const void* ot1, const void* wt2, const void* bt2,
    const void* wr1, const void* sr1, const void* or1, const void* wr2, const void* br2,
    void* h_out, void* prior, void* post, void* scratch, int B, int Dx, int R, int D, int Hd,
    int E, int SD, float mlp_eps, float gru_eps, float head_eps, void* stream) {
  if (B < 1 || act < 0 || act > 5) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x; p.h = h; p.emb = emb;
  p.wm = wm; p.sm = static_cast<const float*>(sm); p.om = static_cast<const float*>(om);
  p.wg = wg; p.sg = static_cast<const float*>(sg); p.og = static_cast<const float*>(og);
  p.wt1 = wt1; p.st1 = static_cast<const float*>(st1); p.ot1 = static_cast<const float*>(ot1);
  p.wt2 = wt2; p.bt2 = static_cast<const float*>(bt2);
  p.wr1 = wr1; p.sr1 = static_cast<const float*>(sr1); p.or1 = static_cast<const float*>(or1);
  p.wr2 = wr2; p.br2 = static_cast<const float*>(br2);
  p.h_out = h_out;
  p.prior = static_cast<float*>(prior);
  p.post = static_cast<float*>(post);
  float* s = static_cast<float*>(scratch);
  p.z_pre = s;
  p.g_pre = p.z_pre + (size_t)B * D;
  p.t1_pre = p.g_pre + (size_t)B * 3 * R;
  p.r1_pre = p.t1_pre + (size_t)B * Hd;
  p.B = B; p.Dx = Dx; p.R = R; p.D = D; p.Hd = Hd; p.E = E; p.SD = SD; p.lda = p.ldp = 0;
  p.vec = D % 4 == 0 && R % 4 == 0 && Hd % 4 == 0 && reinterpret_cast<uintptr_t>(scratch) % 16 == 0;
  p.mlp_eps = mlp_eps; p.gru_eps = gru_eps; p.head_eps = head_eps;
  p.act = act;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, st);
  if (dtype == 1) return launch<__nv_bfloat16>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
