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
// across the 64 steps of a sequence. Measured (chip_smoke.py phase 3,
// NVIDIA H100 80GB HBM3 at 700 W): bf16 42.6 us at B = 16 (73.8 us for the
// CUDA-core version before it), f32 59.0 us. What keeps a launch ~18x above
// its bound is latency, not the products: four dependent stages, three
// grid-wide syncs, and in each stage an L2 round trip for the operand tile,
// its LayerNorm statistics and activations before the first product.
//
// Design: one cooperative launch (a grid that is co-resident, sized from
// the occupancy calculator) in four stages separated by grid-wide syncs:
//   1. x @ Wm                     -> z_pre  [B, D]   f32 scratch
//   2. [z, h] @ Wg                -> g_pre  [B, 3R]  f32 scratch
//   3. h' @ Wt1, [h', emb] @ Wr1  -> t1_pre, r1_pre  f32 scratch
//   4. t1 @ Wt2 + bt2, r1 @ Wr2 + br2 -> prior_raw, post_raw
// Every stage splits its output columns into units of 16 columns x 16 rows
// (one m16 row tile, two n8 tiles), spread over the grid in contiguous
// ranges. Before its first unit of a row tile a block builds that tile's
// left operand A in shared memory in the compute dtype (the values the
// reference rounds to it, so nothing is lost): after a sync the whole block
// copies the previous stage's f32 pre-activations of the tile from L2 into
// shared memory (16-byte loads where the widths allow), a warp a row
// recomputes the LayerNorm statistics (the reference's two-pass order: the
// mean, then the mean of squared deviations), and a thread a column applies
// the affine, the activation or the GRU gates. Each segment's operand
// starts at a 16-byte boundary and is zero-padded to whole chunks.
//
// The products run on the tensor cores. The 16 warps of a block are two n8
// tiles x eight slices of the reduction axis; a slice's partial 16 x 8
// tile goes through shared memory, and 256 threads sum the eight slices in
// a fixed order and write the unit. A lane copies 16 contiguous bytes of
// its weight row per chunk with cp.async into a ring of four chunk slots
// that belongs to its warp; the ring runs ahead across unit and row-tile
// boundaries, and the first chunks of a stage are issued before the grid
// sync that precedes it, so weight loads overlap the sync, the operand
// rebuild and the previous unit's products. Because a lane's 16 bytes are
// 8 (bf16) or 4 (f32) consecutive k, the product takes the reduction axis
// in a lane-permuted order: for bf16, the MMA k index 2t + j (j < 2) and
// 2t + 8 + j stand for k 8t + j and 8t + 2 + j (and a second MMA for
// 8t + 4 ... 8t + 7), and A's fragments are read in the same order with
// one 16-byte shared load a row; the sum over k is the same. bf16 takes
// mma.sync m16n8k16, f32 m16n8k8 3xTF32 (csrc/mma_common.cuh). A weight
// whose row is not a multiple of 16 bytes (wm is [512, 1026] on CartPole:
// rows 2,052 bytes apart) is copied 4 bytes at a time into the same slots,
// so the kernel takes every row stride as it is.
//
// Wide steps. Staging a row tile's whole operand and pre-activation rows
// needs 16 x (the widest operand row + the widest f32 pre-activation row)
// in shared memory, which passes 227 KB at widths the reference's 10 MiB
// guard admits (E = 2,048 on pixels at multiplier 16, R = 512 in bf16).
// There (ops/kernels/rssm.py:launch_plan says which, `wide`) the kernel
// takes a second form, with shared memory fixed at the weight rings and the
// reduction tile, whatever the widths: each stage first builds its whole
// operand [B, lda] once, in the compute dtype, into a device scratch that
// stays in L2 (a warp a row: the statistics in the same two-pass order, then
// the same affine, activation or gates, reading the pre-activations from
// L2), a grid-wide sync, then the same products with A's fragments read
// from L2 (16-byte loads past L1). Seven grid syncs instead of three, and
// no operand rebuilt per block.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "mma_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace mma_common;

constexpr int kRows = 16;                          // rows per tile
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kUnitTiles = 2;                      // n8 tiles a unit
constexpr int kUnitCols = 8 * kUnitTiles;          // output columns a unit
constexpr int kSlices = kWarps / kUnitTiles;       // reduction slices a unit
// chunk slots a warp: enough in bf16 for a whole share of the CartPole
// path's widest product (K = 1,026: five chunks) to be in flight
template <typename T>
__host__ __device__ constexpr int ring_slots() { return sizeof(T) == 2 ? 6 : 4; }
constexpr int kChunkBytes = 32 * 16;               // a warp's chunk: 16 bytes a lane
constexpr int kRedFloats = kSlices * kUnitTiles * kRows * 8;
static_assert(kWarps == kRows, "the statistics pass gives each row a warp");
static_assert(kUnitTiles * kRows * 8 <= kThreads, "a thread per output of a unit");

// K covered by one chunk (4 lanes of 16 bytes along a weight row)
template <typename T>
__host__ __device__ constexpr int chunk_k() { return 4 * (16 / static_cast<int>(sizeof(T))); }

template <typename T>
__device__ __forceinline__ int pad_k(int n) { return (n + chunk_k<T>() - 1) / chunk_k<T>() * chunk_k<T>(); }

// The hardware's exp2 and reciprocal (a few ulp each, no branch): each
// block recomputes the LayerNorm and the activations of its whole 16-row
// tile, so these element-wise passes are issue-bound and every instruction
// counts. tanh(v) = 1 - 2 / (1 + e^(2v)), exact at the limits and within
// about 1e-7 absolute near 0, far inside the 1e-4 tolerance.
__device__ __forceinline__ float rcp_f(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ float sigmoid_f(float v) { return rcp_f(1.f + __expf(-v)); }
__device__ __forceinline__ float tanh_f(float v) { return 1.f - 2.f * rcp_f(1.f + __expf(2.f * v)); }

// activation codes, as ops/kernels/rssm.py:ACT_CODES numbers them
template <int ACT>
__device__ __forceinline__ float act_of(float v) {
  if constexpr (ACT == 0) return v * sigmoid_f(v);                     // silu
  if constexpr (ACT == 1) return fmaxf(v, 0.f);                        // relu
  if constexpr (ACT == 2) return tanh_f(v);                            // tanh
  if constexpr (ACT == 3) return v > 0.f ? v : expm1f(v);              // elu, alpha 1
  if constexpr (ACT == 4) {                                            // gelu, tanh form
    const float k = 0.7978845608028654f;                               // sqrt(2 / pi)
    return 0.5f * v * (1.f + tanh_f(k * (v + 0.044715f * v * v * v)));
  }
  return v;                                                            // identity
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
  int lda, ldp;  // row strides of the operand tile A (elements) and the pre-activation tile P (floats)
  void* a_wide;  // wide steps: the operand [16 ceil(B / 16), lda] in the compute dtype (else null)
  float mlp_eps, gru_eps, head_eps;
};

// One matrix product of a stage: out[:, :n] = A[:, a_off : a_off + k] @ w^T
// (+ bias), w [n, k] row-major; `mode` how its rows are copied (CopyMode).
struct Segment {
  const void* w;
  int n, k, a_off, mode;
  float* out;
  const float* bias;
};

// Staging a tile is latency-bound: every copy of a stage's operand (the
// previous stage's pre-activations, the inputs, the LayerNorm affines) is
// issued as cp.async before the block waits once, so the tile costs about
// one L2 round trip. A row whose bytes or address do not allow 16-byte
// copies takes 4-byte copies, or plain loads; rows past B are zeros.

// Columns [0, n_pad) of the tile's 16 rows at dst (row stride ld) from rows
// rt * 16 ... of a row-major [B, n] array of T in global memory, zeros past
// n. Read-only inputs (x, h, emb): .ca copies are fine where 16 bytes do
// not fit.
template <typename T>
__device__ __noinline__ void copy_rows(T* dst, int ld, const T* __restrict__ src, int n, int n_pad, int rt,
                                       int B) {
  constexpr int kE = 16 / sizeof(T);
  int mode = copy_mode<T>(src, n);
  const int dmode = copy_mode<T>(dst, ld);
  if (dmode > mode) mode = dmode;
  const int chunks = n_pad / kE;  // whole chunks; the rest of n_pad element by element
  for (int e = threadIdx.x; e < kRows * chunks; e += kThreads) {
    const int r = e / chunks, k = (e - r * chunks) * kE;
    const int row = rt * kRows + r;
    const int valid = row < B ? min(max(n - k, 0), kE) : 0;
    copy_chunk(dst + r * ld + k, valid > 0 ? src + (size_t)row * n + k : src, valid, mode);
  }
  const int tail = n_pad - chunks * kE;
  for (int e = threadIdx.x; e < kRows * tail; e += kThreads) {
    const int r = e / tail, k = chunks * kE + e - r * tail;
    const int row = rt * kRows + r;
    dst[r * ld + k] = row < B && k < n ? src[(size_t)row * n + k] : from_f<T>(0.f);
  }
}

// n floats a row of a [B, n] f32 array written earlier in this launch by
// other blocks, so read through L2 only: 16-byte cp.async.cg where n and
// the addresses allow, else __ldcg.
__device__ __noinline__ void copy_pre(float* dst, int ld, const float* __restrict__ src, int n, int rt, int B) {
  const bool vec = copy_mode<float>(src, n) == kCopy16 && copy_mode<float>(dst, ld) == kCopy16;
  if (vec) {
    const int nv = n / 4;
    for (int e = threadIdx.x; e < kRows * nv; e += kThreads) {
      const int r = e / nv, k = (e - r * nv) * 4;
      const int row = rt * kRows + r;
      cp_async16(dst + r * ld + k, row < B ? src + (size_t)row * n + k : src, row < B ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kRows * n; e += kThreads) {
      const int r = e / n, k = e - r * n;
      const int row = rt * kRows + r;
      dst[r * ld + k] = row < B ? __ldcg(src + (size_t)row * n + k) : 0.f;
    }
  }
}

// n f32 values (a LayerNorm scale or offset) into shared memory.
__device__ __noinline__ void copy_vec(float* dst, const float* __restrict__ src, int n) {
  if (copy_mode<float>(src, n) == kCopy16 && copy_mode<float>(dst, n) == kCopy16) {
    for (int e = threadIdx.x; e < n / 4; e += kThreads) cp_async16(dst + 4 * e, src + 4 * e, 16);
  } else {
    for (int e = threadIdx.x; e < n; e += kThreads) dst[e] = __ldg(src + e);
  }
}

// Columns [c0, c1) of A's 16 rows become zeros.
template <typename T>
__device__ __noinline__ void zero_cols(T* A, int ld, int c0, int c1) {
  const int n = c1 - c0;
  for (int e = threadIdx.x; e < kRows * n; e += kThreads) {
    const int r = e / n;
    A[r * ld + c0 + (e - r * n)] = from_f<T>(0.f);
  }
}

// a value of a row in shared memory, or (kL2) of a global array written
// earlier in this launch, read through L2 only
template <bool kL2>
__device__ __forceinline__ float ld_row(const float* row, int k) {
  if constexpr (kL2) return __ldcg(row + k);
  return row[k];
}

// LayerNorm statistics {mean, rstd} of n f32 values in shared memory (or,
// kL2, in global memory), in the reference's two-pass order (the mean, then
// the mean of squared deviations), by one warp.
template <bool kL2>
__device__ __noinline__ float2 row_stats(const float* row, int n, float eps) {
  const int lane = threadIdx.x % 32;
  // four running sums a lane, so that the adds are not one dependent chain
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int k = lane;
  for (; k + 96 < n; k += 128) {
    s0 += ld_row<kL2>(row, k);
    s1 += ld_row<kL2>(row, k + 32);
    s2 += ld_row<kL2>(row, k + 64);
    s3 += ld_row<kL2>(row, k + 96);
  }
  for (; k < n; k += 32) s0 += ld_row<kL2>(row, k);
  const float mean = warp_sum((s0 + s1) + (s2 + s3)) / n;
  float q0 = 0.f, q1 = 0.f, q2 = 0.f, q3 = 0.f;
  for (k = lane; k + 96 < n; k += 128) {
    const float c0 = ld_row<kL2>(row, k) - mean, c1 = ld_row<kL2>(row, k + 32) - mean,
                c2 = ld_row<kL2>(row, k + 64) - mean, c3 = ld_row<kL2>(row, k + 96) - mean;
    q0 += c0 * c0;
    q1 += c1 * c1;
    q2 += c2 * c2;
    q3 += c3 * c3;
  }
  for (; k < n; k += 32) {
    const float c = ld_row<kL2>(row, k) - mean;
    q0 += c * c;
  }
  return make_float2(mean, rsqrtf(warp_sum((q0 + q1) + (q2 + q3)) / n + eps));
}

// A[r, :n] = act(LN(pre[r, :n])) in T for the tile's 16 rows (rows past B
// zero), a thread per column; scale and offset come from shared memory.
// The 16 rows are loaded, then computed, then stored: stores to A cannot be
// moved above loads from P, so a row at a time would be one dependent chain
// of shared-memory and SFU latencies after another.
template <typename T, int ACT>
__device__ __noinline__ void ln_act_tile(const float* __restrict__ pre, int ldp, const float2* __restrict__ st, int n,
                            const float* __restrict__ scale, const float* __restrict__ offset, int live,
                            T* __restrict__ A, int lda) {
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const float sc = scale[k], of = offset[k];
    float v[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) v[r] = pre[r * ldp + k];
#pragma unroll
    for (int r = 0; r < kRows; ++r) v[r] = act_of<ACT>((v[r] - st[2 * r].x) * st[2 * r].y * sc + of);
#pragma unroll
    for (int r = 0; r < kRows; ++r) A[r * lda + k] = r < live ? from_f<T>(v[r]) : from_f<T>(0.f);
  }
}

// The LN-GRU gates of the tile: A[r, i] holds h and becomes h' (rows past
// B zero), a thread per column i, loads before stores as above.
template <typename T>
__device__ __noinline__ void gru_gates(const float* __restrict__ P, int ldp, const float2* __restrict__ st, int R,
                                       const float* __restrict__ sg, const float* __restrict__ og, int live,
                                       T* __restrict__ A, int lda) {
  for (int i = threadIdx.x; i < R; i += kThreads) {
    const int c = R + i, u = 2 * R + i;
    const float sr = sg[i], orr = og[i], sc = sg[c], oc = og[c], su = sg[u], ou = og[u];
    float pr[kRows], pc[kRows], pu[kRows], hv[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      pr[r] = P[r * ldp + i];
      pc[r] = P[r * ldp + c];
      pu[r] = P[r * ldp + u];
      hv[r] = to_f(A[r * lda + i]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float m = st[2 * r].x, rs = st[2 * r].y;
      const float update = sigmoid_f((pu[r] - m) * rs * su + ou - 1.f);
      const float cand = tanh_f(sigmoid_f((pr[r] - m) * rs * sr + orr) * ((pc[r] - m) * rs * sc + oc));
      hv[r] = update * cand + (1.f - update) * hv[r];
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) A[r * lda + i] = r < live ? from_f<T>(hv[r]) : from_f<T>(0.f);
  }
}

// Build the left operand of `stage` for row tile `rt` in shared memory: row r
// of the tile at A + r * lda in T, rows past B zero, each segment's operand
// zero-padded to whole chunks. In three block-wide steps:
//   1. copy the previous stage's f32 pre-activations of the tile into P
//      (row stride ldp), the tile's inputs (x, h, emb) into A and the
//      LayerNorm affines into V (scale then offset, of each segment);
//   2. the LayerNorm statistics of each row (and segment), a warp a row,
//      into stats;
//   3. a thread per column: the affine, the activation or the GRU gates,
//      rounded to T, into A.
// The wait for step 1's copies also waits for the weight chunks in flight,
// which were issued earlier.
template <typename T, int ACT>
__device__ __noinline__ void stage_operand(const Params& p, int stage, T* A, float* P, float* V,
                                           float2 (*stats)[2], int rt) {
  const int lda = p.lda;
  if (stage == 1) {
    copy_rows(A, lda, static_cast<const T*>(p.x), p.Dx, pad_k<T>(p.Dx), rt, p.B);
  } else if (stage == 2) {  // [z, h]: z_pre -> P, h -> A[:, D:]
    copy_pre(P, p.ldp, p.z_pre, p.D, rt, p.B);
    copy_rows(A + p.D, lda, static_cast<const T*>(p.h), p.R, pad_k<T>(p.D + p.R) - p.D, rt, p.B);
    copy_vec(V, p.sm, p.D);
    copy_vec(V + p.D, p.om, p.D);
  } else if (stage == 3) {  // [h', emb]: g_pre -> P, h -> A[:, :R], emb -> A[:, R:]
    copy_pre(P, p.ldp, p.g_pre, 3 * p.R, rt, p.B);
    copy_rows(A, lda, static_cast<const T*>(p.h), p.R, p.R, rt, p.B);
    copy_rows(A + p.R, lda, static_cast<const T*>(p.emb), p.E, pad_k<T>(p.R + p.E) - p.R, rt, p.B);
    copy_vec(V, p.sg, 3 * p.R);
    copy_vec(V + 3 * p.R, p.og, 3 * p.R);
  } else {  // [t1, r1]: t1_pre -> P[:, :Hd], r1_pre -> P[:, Hd:]; r1 at A[:, pad(Hd):]
    copy_pre(P, p.ldp, p.t1_pre, p.Hd, rt, p.B);
    copy_pre(P + p.Hd, p.ldp, p.r1_pre, p.Hd, rt, p.B);
    copy_vec(V, p.st1, p.Hd);
    copy_vec(V + p.Hd, p.ot1, p.Hd);
    copy_vec(V + 2 * p.Hd, p.sr1, p.Hd);
    copy_vec(V + 3 * p.Hd, p.or1, p.Hd);
    const int off = pad_k<T>(p.Hd);
    zero_cols(A, lda, p.Hd, off);
    zero_cols(A, lda, off + p.Hd, 2 * off);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (stage == 1) return;
  {
    const int r = threadIdx.x / 32;  // one warp a row
    const float* pre = P + r * p.ldp;
    if (stage == 2) {
      stats[r][0] = row_stats<false>(pre, p.D, p.mlp_eps);
    } else if (stage == 3) {
      stats[r][0] = row_stats<false>(pre, 3 * p.R, p.gru_eps);
    } else {
      const float2 a = row_stats<false>(pre, p.Hd, p.head_eps);
      const float2 b = row_stats<false>(pre + p.Hd, p.Hd, p.head_eps);
      stats[r][0] = a;
      stats[r][1] = b;
    }
  }
  __syncthreads();
  const int live = min(kRows, p.B - rt * kRows);  // rows of the tile below B
  if (stage == 2) {
    ln_act_tile<T, ACT>(P, p.ldp, &stats[0][0], p.D, V, V + p.D, live, A, lda);
  } else if (stage == 3) {
    gru_gates<T>(P, p.ldp, &stats[0][0], p.R, V, V + 3 * p.R, live, A, lda);
  } else {
    ln_act_tile<T, ACT>(P, p.ldp, &stats[0][0], p.Hd, V, V + p.Hd, live, A, lda);
    ln_act_tile<T, ACT>(P + p.Hd, p.ldp, &stats[0][1], p.Hd, V + 2 * p.Hd, V + 3 * p.Hd, live,
                   A + pad_k<T>(p.Hd), lda);
  }
}

// The wide steps' operand of `stage`, whole, into p.a_wide: row r of
// [16 ceil(B / 16), lda] in T, the same values stage_operand builds in
// shared memory (rows past B and the padding columns zero), a warp a row
// over the grid. Stage 3 also writes h' to h_out.
template <typename T, int ACT>
__device__ __noinline__ void wide_operand(const Params& p, int stage) {
  const int lane = threadIdx.x % 32;
  const int rows = (p.B + kRows - 1) / kRows * kRows;
  const T zero = from_f<T>(0.f);
  for (int r = blockIdx.x * kWarps + threadIdx.x / 32; r < rows; r += gridDim.x * kWarps) {
    T* out = static_cast<T*>(p.a_wide) + (size_t)r * p.lda;
    if (r >= p.B) {
      for (int k = lane; k < p.lda; k += 32) out[k] = zero;
      continue;
    }
    if (stage == 1) {  // [x]
      const T* x = static_cast<const T*>(p.x) + (size_t)r * p.Dx;
      for (int k = lane; k < p.lda; k += 32) out[k] = k < p.Dx ? x[k] : zero;
    } else if (stage == 2) {  // [z, h]
      const float* pre = p.z_pre + (size_t)r * p.D;
      const float2 st = row_stats<true>(pre, p.D, p.mlp_eps);
      const T* h = static_cast<const T*>(p.h) + (size_t)r * p.R;
      for (int k = lane; k < p.lda; k += 32) {
        if (k < p.D)
          out[k] = from_f<T>(act_of<ACT>((__ldcg(pre + k) - st.x) * st.y * __ldg(p.sm + k) + __ldg(p.om + k)));
        else
          out[k] = k < p.D + p.R ? h[k - p.D] : zero;
      }
    } else if (stage == 3) {  // [h', emb]; h' also to h_out
      const float* pre = p.g_pre + (size_t)r * 3 * p.R;
      const float2 st = row_stats<true>(pre, 3 * p.R, p.gru_eps);
      const T* h = static_cast<const T*>(p.h) + (size_t)r * p.R;
      const T* emb = static_cast<const T*>(p.emb) + (size_t)r * p.E;
      T* h_out = static_cast<T*>(p.h_out) + (size_t)r * p.R;
      for (int k = lane; k < p.lda; k += 32) {
        if (k < p.R) {
          const int c = p.R + k, u = 2 * p.R + k;
          const float m = st.x, rs = st.y;
          const float update = sigmoid_f((__ldcg(pre + u) - m) * rs * __ldg(p.sg + u) + __ldg(p.og + u) - 1.f);
          const float cand = tanh_f(sigmoid_f((__ldcg(pre + k) - m) * rs * __ldg(p.sg + k) + __ldg(p.og + k)) *
                                    ((__ldcg(pre + c) - m) * rs * __ldg(p.sg + c) + __ldg(p.og + c)));
          const T hn = from_f<T>(update * cand + (1.f - update) * to_f(h[k]));
          out[k] = hn;
          h_out[k] = hn;
        } else {
          out[k] = k < p.R + p.E ? emb[k - p.R] : zero;
        }
      }
    } else {  // [t1, pad, r1]
      const float* t1 = p.t1_pre + (size_t)r * p.Hd;
      const float* r1 = p.r1_pre + (size_t)r * p.Hd;
      const float2 sa = row_stats<true>(t1, p.Hd, p.head_eps);
      const float2 sb = row_stats<true>(r1, p.Hd, p.head_eps);
      const int off = pad_k<T>(p.Hd);
      for (int k = lane; k < p.lda; k += 32) {
        if (k < p.Hd) {
          out[k] = from_f<T>(act_of<ACT>((__ldcg(t1 + k) - sa.x) * sa.y * __ldg(p.st1 + k) + __ldg(p.ot1 + k)));
        } else if (k >= off && k < off + p.Hd) {
          const int i = k - off;
          out[k] = from_f<T>(act_of<ACT>((__ldcg(r1 + i) - sb.x) * sb.y * __ldg(p.sr1 + i) + __ldg(p.or1 + i)));
        } else {
          out[k] = zero;
        }
      }
    }
  }
}

// A stage's units: per row tile, ceil(n0 / 16) units of segment 0, then
// those of segment 1; this block's contiguous range [begin, end).
struct StageDesc {
  Segment s0, s1;
  int c0, per_tile;
  int begin, end;
};

__device__ __forceinline__ int unit_cols(int n) { return (n + kUnitCols - 1) / kUnitCols; }

__device__ __forceinline__ StageDesc make_stage(const Segment& a, const Segment& b, int nseg, int B) {
  StageDesc d;
  d.s0 = a;
  d.s1 = b;
  d.c0 = unit_cols(a.n);
  d.per_tile = d.c0 + (nseg > 1 ? unit_cols(b.n) : 0);
  const int units = (B + kRows - 1) / kRows * d.per_tile;  // the host keeps units * grid in int
  d.begin = units * blockIdx.x / gridDim.x;
  d.end = units * (blockIdx.x + 1) / gridDim.x;
  return d;
}

// This warp's share of unit u: its segment's fields (each picked by value,
// so that nothing here needs an address and all of it stays in registers),
// the first column of its n8 tile, and its chunks [lo, hi) of the
// segment's reduction axis.
struct Share {
  const void* w;
  float* out;
  const float* bias;
  int n, k, a_off, mode;
  int col, lo, hi;
};

template <typename T>
__device__ __forceinline__ Share share_of(const StageDesc& d, int u) {
  const int warp = threadIdx.x / 32;
  const int cu = u % d.per_tile;
  const bool second = cu >= d.c0;
  Share sh;
  sh.w = second ? d.s1.w : d.s0.w;
  sh.out = second ? d.s1.out : d.s0.out;
  sh.bias = second ? d.s1.bias : d.s0.bias;
  sh.n = second ? d.s1.n : d.s0.n;
  sh.k = second ? d.s1.k : d.s0.k;
  sh.a_off = second ? d.s1.a_off : d.s0.a_off;
  sh.mode = second ? d.s1.mode : d.s0.mode;
  sh.col = (second ? cu - d.c0 : cu) * kUnitCols + (warp % kUnitTiles) * 8;
  const int nck = (sh.k + chunk_k<T>() - 1) / chunk_k<T>();
  const int slice = warp / kUnitTiles;
  sh.lo = slice * nck / kSlices;
  sh.hi = (slice + 1) * nck / kSlices;
  return sh;
}

// The weight chunks of this warp over the block's units of one stage, in
// the order the products take them, copied by cp.async into the warp's
// ring of kSlots slots. Every issue() commits one group (an empty one past
// the last chunk), so that waiting for all but kSlots - 2 groups always
// means "the oldest chunk not yet taken has landed".
template <typename T>
struct WeightStream {
  StageDesc d;
  static constexpr int kSlots = ring_slots<T>();
  unsigned char* ring;  // this warp's kSlots slots
  int u;                // the next chunk to issue: unit u, chunk c of its share
  int c;
  Share sh;
  int issued, taken;    // chunks issued and taken, counting from 0

  __device__ __forceinline__ void start(const StageDesc& desc, unsigned char* warp_ring) {
    d = desc;
    ring = warp_ring;
    u = desc.begin;
    c = 0;
    issued = taken = 0;
    seek();
#pragma unroll
    for (int i = 0; i < kSlots - 1; ++i) issue();
  }

  // move to the first unit from u on in which this warp has a chunk c
  __device__ __forceinline__ void seek() {
    for (; u < d.end; ++u, c = 0) {
      sh = share_of<T>(d, u);
      if (sh.lo + c < sh.hi) return;
    }
  }

  __device__ __forceinline__ void issue() {
    if (u < d.end) {
      constexpr int kE = 16 / sizeof(T);
      const int lane = threadIdx.x % 32;
      const int n = sh.col + lane / 4;
      const int k = (sh.lo + c) * chunk_k<T>() + kE * (lane % 4);
      const int valid = n < sh.n ? min(max(sh.k - k, 0), kE) : 0;
      const T* w = static_cast<const T*>(sh.w);
      copy_chunk(reinterpret_cast<T*>(ring + (issued % kSlots) * kChunkBytes + 16 * lane),
                 valid > 0 ? w + (size_t)n * sh.k + k : w, valid, sh.mode);
      ++issued;
      ++c;
      seek();
    }
    cp_async_commit();
  }

  // the lane's 16 bytes of the oldest chunk not yet taken (issuing the next)
  __device__ __forceinline__ uint4 take() {
    cp_async_wait<kSlots - 2>();
    __syncwarp();
    const uint4 v = *reinterpret_cast<const uint4*>(ring + (taken % kSlots) * kChunkBytes + 16 * (threadIdx.x % 32));
    ++taken;
    __syncwarp();  // every lane has read the slot the next issue overwrites
    issue();
    return v;
  }
};

// acc += A[:, a_off + chunk] @ W-chunk^T for one chunk, K in the lane order
// described at the top: a lane's 16 bytes of A rows g and g + 8 pair with
// its own 16 bytes of the weight row. kL2: A is the wide steps' operand in
// global memory, written earlier in this launch.
template <typename T, bool kL2>
__device__ __forceinline__ void chunk_mma(float (&acc0)[4], float (&acc1)[4], const T* A, int lda, int a_col,
                                          uint4 b) {
  // the chunk's two MMAs go to two accumulators, so that they do not wait
  // on each other (summed once, at the end of the unit)
  const int lane = threadIdx.x % 32;
  const int col = a_col + (16 / static_cast<int>(sizeof(T))) * (lane % 4);
  uint4 lo, hi;
  if constexpr (kL2) {
    lo = __ldcg(reinterpret_cast<const uint4*>(A + (size_t)(lane / 4) * lda + col));
    hi = __ldcg(reinterpret_cast<const uint4*>(A + (size_t)(lane / 4 + 8) * lda + col));
  } else {
    lo = *reinterpret_cast<const uint4*>(A + (lane / 4) * lda + col);
    hi = *reinterpret_cast<const uint4*>(A + (lane / 4 + 8) * lda + col);
  }
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const uint32_t a0[4] = {lo.x, hi.x, lo.y, hi.y}, b0[2] = {b.x, b.y};
    const uint32_t a1[4] = {lo.z, hi.z, lo.w, hi.w}, b1[2] = {b.z, b.w};
    mma_bf16(acc0, a0, b0);
    mma_bf16(acc1, a1, b1);
  } else {
    const float a0[4] = {__uint_as_float(lo.x), __uint_as_float(hi.x), __uint_as_float(lo.y), __uint_as_float(hi.y)};
    const float a1[4] = {__uint_as_float(lo.z), __uint_as_float(hi.z), __uint_as_float(lo.w), __uint_as_float(hi.w)};
    const float b0[2] = {__uint_as_float(b.x), __uint_as_float(b.y)};
    const float b1[2] = {__uint_as_float(b.z), __uint_as_float(b.w)};
    uint32_t ah0[4], al0[4], bh0[2], bl0[2], ah1[4], al1[4], bh1[2], bl1[2];
    split_tf32(a0, ah0, al0);
    split_tf32(b0, bh0, bl0);
    split_tf32(a1, ah1, al1);
    split_tf32(b1, bh1, bl1);
    mma_tf32(acc0, al0, bh0);  // the 3xTF32 terms, alternating accumulators
    mma_tf32(acc1, al1, bh1);
    mma_tf32(acc0, ah0, bl0);
    mma_tf32(acc1, ah1, bl1);
    mma_tf32(acc0, ah0, bh0);
    mma_tf32(acc1, ah1, bh1);
  }
}

template <typename T, int ACT, bool WIDE>
__device__ __forceinline__ void run_stage(const Params& p, int stage, const StageDesc& d, WeightStream<T>& ws, T* A,
                                       float* P, float* V, float* red, float2 (*stats)[2]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int staged = -1;
  for (int u = d.begin; u < d.end; ++u) {
    const int rt = u / d.per_tile;
    if constexpr (WIDE) {  // the operand is whole in p.a_wide, h' already in h_out
      A = static_cast<T*>(p.a_wide) + (size_t)rt * kRows * p.lda;
    } else if (rt != staged) {
      __syncthreads();  // every warp is done with the previous tile
      stage_operand<T, ACT>(p, stage, A, P, V, stats, rt);
      __syncthreads();
      staged = rt;
    }
    if (!WIDE && stage == 3 && u % d.per_tile == 0) {  // h' leaves the kernel once per row tile
      T* h_out = static_cast<T*>(p.h_out);
      const int live = min(kRows, p.B - rt * kRows);
      if (copy_mode<T>(h_out, p.R) == kCopy16) {  // 16 bytes a store
        constexpr int kE = 16 / sizeof(T);
        const int per_row = p.R / kE;
        for (int e = threadIdx.x; e < live * per_row; e += kThreads) {
          const int r = e / per_row, i = (e - r * per_row) * kE;
          *reinterpret_cast<uint4*>(h_out + (size_t)(rt * kRows + r) * p.R + i) =
              *reinterpret_cast<const uint4*>(A + r * p.lda + i);
        }
      } else {
        for (int r = 0; r < live; ++r)
          for (int i = threadIdx.x; i < p.R; i += kThreads) h_out[(size_t)(rt * kRows + r) * p.R + i] = A[r * p.lda + i];
      }
    }
    const Share sh = share_of<T>(d, u);
    float acc[4] = {0.f, 0.f, 0.f, 0.f}, acc1[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c = sh.lo; c < sh.hi; ++c) chunk_mma<T, WIDE>(acc, acc1, A, p.lda, sh.a_off + c * chunk_k<T>(), ws.take());
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] += acc1[q];

    // the eight slices' partial tiles -> red[slice][tile][row][col]
    const int g = lane / 4, t = lane % 4;
    float* mine = red + warp * kRows * 8;  // warp = slice * kUnitTiles + tile
    mine[g * 8 + 2 * t] = acc[0];
    mine[g * 8 + 2 * t + 1] = acc[1];
    mine[(g + 8) * 8 + 2 * t] = acc[2];
    mine[(g + 8) * 8 + 2 * t + 1] = acc[3];
    __syncthreads();
    if (threadIdx.x < kUnitTiles * kRows * 8) {
      const int tile = threadIdx.x / (kRows * 8), rem = threadIdx.x % (kRows * 8);
      float v = 0.f;
#pragma unroll
      for (int sl = 0; sl < kSlices; ++sl) v += red[(sl * kUnitTiles + tile) * kRows * 8 + rem];
      const int col = sh.col - (warp % kUnitTiles) * 8 + tile * 8 + rem % 8;
      const int row = rt * kRows + rem / 8;
      if (col < sh.n && row < p.B) sh.out[(size_t)row * sh.n + col] = sh.bias != nullptr ? v + sh.bias[col] : v;
    }
    __syncthreads();  // red is free again
  }
}

template <typename T>
__device__ __forceinline__ Segment segment(const void* w, int n, int k, int a_off, float* out, const float* bias) {
  return Segment{w, n, k, a_off, copy_mode<T>(w, k), out, bias};
}

// The products of `stage` and this block's units of it.
template <typename T>
__device__ __forceinline__ StageDesc stage_desc(const Params& p, int stage) {
  if (stage == 1) {
    const Segment s = segment<T>(p.wm, p.D, p.Dx, 0, p.z_pre, nullptr);
    return make_stage(s, s, 1, p.B);
  }
  if (stage == 2) {
    const Segment s = segment<T>(p.wg, 3 * p.R, p.D + p.R, 0, p.g_pre, nullptr);
    return make_stage(s, s, 1, p.B);
  }
  if (stage == 3)
    return make_stage(segment<T>(p.wt1, p.Hd, p.R, 0, p.t1_pre, nullptr),
                      segment<T>(p.wr1, p.Hd, p.R + p.E, 0, p.r1_pre, nullptr), 2, p.B);
  return make_stage(segment<T>(p.wt2, p.SD, p.Hd, 0, p.prior, p.bt2),
                    segment<T>(p.wr2, p.SD, p.Hd, pad_k<T>(p.Hd), p.post, p.br2), 2, p.B);
}

template <typename T, int ACT, bool WIDE>
__global__ void __launch_bounds__(kThreads, 1) fused_rssm_kernel(const __grid_constant__ Params p) {
  extern __shared__ float4 smem[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem);         // kWarps x ring_slots chunk slots
  float* red = reinterpret_cast<float*>(ring + kWarps * ring_slots<T>() * kChunkBytes);  // a unit's partial tiles
  // staged steps only: the left operand (kRows x lda, T), the
  // pre-activations (kRows x ldp, f32) and a stage's LayerNorm affines (f32)
  T* A = WIDE ? nullptr : reinterpret_cast<T*>(red + kRedFloats);
  float* P = WIDE ? nullptr : reinterpret_cast<float*>(A + kRows * p.lda);
  float* V = WIDE ? nullptr : P + kRows * p.ldp;
  __shared__ float2 stats[kRows][2];  // each row's LayerNorm {mean, rstd}, two segments
  cg::grid_group grid = cg::this_grid();
  unsigned char* warp_ring = ring + (threadIdx.x / 32) * ring_slots<T>() * kChunkBytes;
  // one copy of the stage code for all four stages (the loop is not
  // unrolled): the instruction cache holds it after the first
  WeightStream<T> ws;
  StageDesc d;
#pragma unroll 1
  for (int stage = 1; stage <= 4; ++stage) {
    d = stage_desc<T>(p, stage);
    ws.start(d, warp_ring);  // the first weight chunks load across the sync
    if (stage > 1) grid.sync();
    if constexpr (WIDE) {
      wide_operand<T, ACT>(p, stage);
      grid.sync();
    }
    run_stage<T, ACT, WIDE>(p, stage, d, ws, A, P, V, red, stats);
  }
  cp_async_wait<0>();
}

int max_units_per_tile(const Params& p) {
  auto ch = [](int n) { return (n + kUnitCols - 1) / kUnitCols; };
  int m = ch(p.D);
  if (ch(3 * p.R) > m) m = ch(3 * p.R);
  if (2 * ch(p.Hd) > m) m = 2 * ch(p.Hd);
  if (2 * ch(p.SD) > m) m = 2 * ch(p.SD);
  return m;
}

template <typename T, int ACT, bool WIDE>
int launch(Params p, size_t smem, cudaStream_t stream) {
  // the tile strides and the shared memory come from
  // ops/kernels/rssm.py:launch_plan; check that every stage's padded
  // operand fits, that A's rows keep 16-byte chunks and that the shared
  // memory is what this form of the kernel lays out
  auto pad = [](int n) { return (n + chunk_k<T>() - 1) / chunk_k<T>() * chunk_k<T>(); };
  const int need_a = max(max(pad(p.Dx), pad(p.D + p.R)), max(pad(p.R + p.E), 2 * pad(p.Hd)));
  const int need_p = max(max(p.D, 3 * p.R), 2 * p.Hd);
  if (p.lda < need_a || (p.lda * static_cast<int>(sizeof(T))) % 16 != 0 || p.ldp < need_p || p.ldp % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (WIDE != (p.a_wide != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = max(max(2 * p.D, 6 * p.R), 4 * p.Hd);  // the affines of the widest stage
  size_t want = static_cast<size_t>(kWarps) * ring_slots<T>() * kChunkBytes + kRedFloats * sizeof(float);
  if (!WIDE)
    want += static_cast<size_t>(kRows) * p.lda * sizeof(T) + (static_cast<size_t>(kRows) * p.ldp + vec) * sizeof(float);
  if (smem != want) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = reinterpret_cast<const void*>(fused_rssm_kernel<T, ACT, WIDE>);
  cudaError_t err = cudaFuncSetAttribute(fused_rssm_kernel<T, ACT, WIDE>,
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
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_rssm_kernel<T, ACT, WIDE>, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const long long tiles = (p.B + kRows - 1) / kRows;
  const long long units = tiles * max_units_per_tile(p);
  long long grid = static_cast<long long>(sms) * per_sm;
  if (units < grid) grid = units;
  if (units * (grid + 1) > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);  // int unit arithmetic
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(fn, dim3(static_cast<unsigned>(grid)), dim3(kThreads), args,
                                    smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// one kernel per activation: the element-wise passes carry no switch, and
// each kernel's code holds only its own activation
template <typename T, bool WIDE>
int launch_act(int act, const Params& p, size_t smem, cudaStream_t stream) {
  switch (act) {
    case 0: return launch<T, 0, WIDE>(p, smem, stream);
    case 1: return launch<T, 1, WIDE>(p, smem, stream);
    case 2: return launch<T, 2, WIDE>(p, smem, stream);
    case 3: return launch<T, 3, WIDE>(p, smem, stream);
    case 4: return launch<T, 4, WIDE>(p, smem, stream);
    default: return launch<T, 5, WIDE>(p, smem, stream);
  }
}

template <typename T>
int launch_form(int act, const Params& p, size_t smem, cudaStream_t stream) {
  return p.a_wide != nullptr ? launch_act<T, true>(act, p, smem, stream) : launch_act<T, false>(act, p, smem, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, h, emb, the six weight matrices and
// h_out); act: 0 silu, 1 relu, 2 tanh, 3 elu, 4 gelu (tanh form), 5
// identity. The LN scales and offsets, the head biases, prior_raw and
// post_raw [B, SD] and the scratch [B, D + 3R + 2Hd] are float32. Weights
// are [out, in]: wm [D, Dx], wg [3R, D + R], wt1 [Hd, R], wt2 [SD, Hd],
// wr1 [Hd, R + E], wr2 [SD, Hd]. lda and ldp are the shared tiles' row
// strides from ops/kernels/rssm.py:launch_plan, as are `smem` (the dynamic
// shared memory in bytes) and `a_wide`: null for the staged form, else the
// wide steps' operand scratch [16 ceil(B / 16), lda] in the compute dtype.
// Returns a cudaError_t; a grid that cannot be co-resident is refused
// (cudaErrorCooperativeLaunchTooLarge), never run another way.
extern "C" int fused_rssm_forward(
    int dtype, int act, const void* x, const void* h, const void* emb, const void* wm,
    const void* sm, const void* om, const void* wg, const void* sg, const void* og,
    const void* wt1, const void* st1, const void* ot1, const void* wt2, const void* bt2,
    const void* wr1, const void* sr1, const void* or1, const void* wr2, const void* br2,
    void* h_out, void* prior, void* post, void* scratch, void* a_wide, int B, int Dx, int R, int D, int Hd,
    int E, int SD, int lda, int ldp, int smem, float mlp_eps, float gru_eps, float head_eps, void* stream) {
  if (B < 1 || act < 0 || act > 5 || smem < 1) return static_cast<int>(cudaErrorInvalidValue);
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
  p.B = B; p.Dx = Dx; p.R = R; p.D = D; p.Hd = Hd; p.E = E; p.SD = SD; p.lda = lda; p.ldp = ldp;
  p.a_wide = a_wide;
  p.mlp_eps = mlp_eps; p.gru_eps = gru_eps; p.head_eps = head_eps;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_form<float>(act, p, static_cast<size_t>(smem), st);
  if (dtype == 1) return launch_form<__nv_bfloat16>(act, p, static_cast<size_t>(smem), st);
  return static_cast<int>(cudaErrorInvalidValue);
}
