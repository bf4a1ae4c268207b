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
// The bracketing bins come from the two comparison counts, not a search:
// the bins need not be sorted, and a NaN x lands where the reference puts it.
//
// What bounds it on an H100: one pass over the logits, N*K*itemsize bytes
// (15.7 MB at the critic loss's N = 15,360, K = 255 in f32: 4.7 us at
// 3.35 TB/s) against about seven operations an element. The bound is the
// bytes, so the design moves each logit byte once, at full width, and keeps
// the per-row work off the copy's path.
//
// Design (one launch at any N and K >= 1; the plan is
// ops/kernels/two_hot.py:launch_plan, checked here):
// - A persistent grid of up to three blocks an SM walks over units of the
//   logits. A unit is a run of up to 32 whole consecutive rows (about
//   32 KB), or, where one row's image passes 48 KB, a chunk of one row with
//   its slice of the bins. A unit's bytes are contiguous: warp 0 brings each
//   into a two-stage shared-memory ring with one 1-D bulk copy
//   (cp.async.bulk ... mbarrier::complete_tx) of its 16-byte-aligned body
//   and element loads of its unaligned head and tail, so a 1,020-byte row
//   costs no narrow loads. The copy of unit j + 1 is in flight while the
//   block reduces unit j.
// - Whole rows: the bins are staged in shared memory once a block, with the
//   count of NaN bins. A warp takes four rows at once (where a run has fewer
//   than 32 rows, the warps of a group of four split its columns and merge
//   through shared memory): each lane runs over its columns keeping, per
//   row, a (max, rescaled sum) pair and #(bins <= x) (one read of a bin
//   serves the four rows); #(bins > x) follows exactly, as K - #NaN bins -
//   #(bins <= x), or 0 for a NaN x. One butterfly merges the four rows'
//   pairs and counts, halving the rows a lane holds at its first two steps,
//   so lanes 8q ... 8q + 7 end with row q; lanes 0, 8, 16 and 24 then do the
//   four rows' tails at once, reading bins[below|above] and
//   logits[below|above] from shared memory.
// - Long rows: every thread folds its columns of each chunk into one
//   running pair and both counts; at the row's last chunk the block merges
//   them and thread 0 does the tail, reading the two bracketing logits and
//   bins back from global memory (the row has just passed through L2).
// - exp(v - m) is one FFMA and one ex2.approx (2^(v log2 e - m log2 e)).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeader = 640;  // two mbarriers, eight warps' four rows' parts, the bins' NaN count
constexpr int kGroup = 4;     // rows a warp reduces at once
constexpr int kTile = 8;      // logits a lane folds into its pair at a time
constexpr int kMaxStage = 49152;
constexpr int kSmemLimit = 232448;

__device__ __forceinline__ float to_f(uint32_t v) { return __uint_as_float(v); }
__device__ __forceinline__ float to_f(uint16_t v) { return __uint_as_float(static_cast<uint32_t>(v) << 16); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// global -> shared, `bytes` (a multiple of 16, both addresses 16-byte
// aligned) by the copy engine, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the 16-byte-aligned body of a staged range, for one bulk copy
struct Body {
  const void* src;
  void* dst;
  uint32_t bytes;
};

// Stage elements [src, src + count) at dst + (src % 16), dst 16-byte
// aligned: lanes lane0 ... lane0 + 7 load the unaligned head (under 16
// bytes), lanes lane0 + 8 ... lane0 + 15 the unaligned tail, and the
// 16-byte-aligned body is returned for one bulk copy.
template <typename E>
__device__ __forceinline__ Body stage_range(unsigned char* dst, const E* src, long long count, int lane,
                                            int lane0) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t e = a + static_cast<uintptr_t>(count) * sizeof(E);
  const uintptr_t up = (a + 15) & ~uintptr_t(15), down = e & ~uintptr_t(15);
  const uintptr_t head_end = up < e ? up : e;
  const uintptr_t tail_start = down > head_end ? down : head_end;
  E* image = reinterpret_cast<E*>(dst + (a & 15));
  const int j = lane - lane0;
  if (j >= 0 && j < 8 && j < static_cast<int>((head_end - a) / sizeof(E))) image[j] = src[j];
  const long long t0 = static_cast<long long>((tail_start - a) / sizeof(E));
  if (j >= 8 && j < 16 && t0 + (j - 8) < count) image[t0 + j - 8] = src[t0 + j - 8];
  return Body{reinterpret_cast<const void*>(head_end), reinterpret_cast<unsigned char*>(image) + (head_end - a),
              static_cast<uint32_t>(tail_start - head_end)};
}

// a row's partial log-sum-exp, as (max m, sum of exp(v - m)), and the
// bins' comparison counts #(bins <= x), #(bins > x)
struct Part {
  float m, s;
  int le, gt;
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ Part empty_part() { return Part{neg_inf(), 0.f, 0, 0}; }

// exp shifted by m, with an empty (-inf) maximum shifting by 0 so that an
// empty side contributes exp(-inf) = 0 rather than NaN
__device__ __forceinline__ float shift(float m) { return m == neg_inf() ? 0.f : m; }

constexpr float kLog2e = 1.4426950408889634f;

// exp(v - c) as 2^(v log2 e - c log2 e): one FFMA and one ex2, given
// cl = c * log2 e
__device__ __forceinline__ float exp_shifted(float v, float cl) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(fmaf(v, kLog2e, -cl)));
  return r;
}

__device__ __forceinline__ Part merge(const Part& a, const Part& b) {
  const float m = fmaxf(a.m, b.m), cl = shift(m) * kLog2e;
  return Part{m, a.s * exp_shifted(a.m, cl) + b.s * exp_shifted(b.m, cl), a.le + b.le, a.gt + b.gt};
}

__device__ __forceinline__ Part shfl(const Part& p, int offset) {
  return Part{__shfl_xor_sync(0xffffffffu, p.m, offset), __shfl_xor_sync(0xffffffffu, p.s, offset),
              __shfl_xor_sync(0xffffffffu, p.le, offset), __shfl_xor_sync(0xffffffffu, p.gt, offset)};
}

__device__ __forceinline__ Part pick(bool c, const Part& a, const Part& b) { return c ? a : b; }

// fold a tile of kTile values (-inf where absent) into p
__device__ __forceinline__ void fold(Part& p, const float (&v)[kTile]) {
  float mt = v[0];
#pragma unroll
  for (int j = 1; j < kTile; ++j) mt = fmaxf(mt, v[j]);
  const float cl = shift(mt) * kLog2e;
  float st = 0.f;
#pragma unroll
  for (int j = 0; j < kTile; ++j) st += exp_shifted(v[j], cl);
  p = merge(p, Part{mt, st, 0, 0});
}

// the reference's tail for one row from its merged part
__device__ __forceinline__ float tail(const Part& p, float x, float bin_below, float bin_above, float logit_below,
                                      float logit_above, int below, int above) {
  const float log_z = p.m + logf(p.s);
  const bool equal = below == above;
  const float d_below = equal ? 1.f : fabsf(bin_below - x);
  const float d_above = equal ? 1.f : fabsf(bin_above - x);
  const float total = d_below + d_above;
  return (d_above / total) * (logit_below - log_z) + (d_below / total) * (logit_above - log_z);
}

// A warp's share of a run of whole rows [r0, r0 + nrows), nrows <= 32: the
// rows go four to a group, and a group's `wpg` warps (8 / the groups,
// rounded to a power of two) take interleaved 32-column blocks of it. The
// rows' targets are loaded here, before the run's copy is waited on.
struct RowsJob {
  int r0, g0, ng, wpg, slice;  // ng <= 0: an idle warp
  float xv[kGroup];
};

__device__ __forceinline__ RowsJob rows_job(const float* __restrict__ x, int r0, int nrows, int warp) {
  RowsJob j;
  const int groups = (nrows + kGroup - 1) / kGroup;
  j.r0 = r0;
  j.wpg = groups > 4 ? 1 : groups > 2 ? 2 : groups > 1 ? 4 : 8;
  j.slice = warp % j.wpg;
  j.g0 = (warp / j.wpg) * kGroup;
  j.ng = min(kGroup, nrows - j.g0);
#pragma unroll
  for (int i = 0; i < kGroup; ++i) j.xv[i] = i < j.ng ? __ldg(x + r0 + j.g0 + i) : 0.f;
  return j;
}

// The warp's rows of a run staged at `img` (row-major, K a row), the bins
// at `sbins`, `nan_bins` of them NaN; where wpg > 1 the group's warps merge
// through `red`. Only #(bins <= x) is counted: a bin that is not NaN is
// either <= x or > x when x is not NaN, and a NaN x is neither, so
// #(bins > x) = K - nan_bins - #(bins <= x), or 0 for a NaN x.
template <typename E>
__device__ __forceinline__ void rows_pass(const RowsJob& job, const E* img, const float* sbins, int nan_bins,
                                          float* __restrict__ out, Part* red, int K, int warp, int lane) {
  const int ng = job.ng, wpg = job.wpg, slice = job.slice, g0 = job.g0;
  const float* xv = job.xv;
  const E* rows = img + static_cast<long long>(max(g0, 0)) * K;
  Part p[kGroup];
#pragma unroll
  for (int i = 0; i < kGroup; ++i) p[i] = empty_part();
  const float nan = __int_as_float(0x7fffffff);
  for (int cb = slice; ng > 0 && cb * 32 < K; cb += kTile * wpg) {
    // kTile 32-column blocks cb, cb + wpg, ...; a bin past K is NaN, which
    // neither count takes
    float b[kTile];
    int col[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      col[j] = (cb + j * wpg) * 32 + lane;
      b[j] = col[j] < K ? sbins[col[j]] : nan;
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      if (i < ng) {
        float v[kTile];
#pragma unroll
        for (int j = 0; j < kTile; ++j) {
          v[j] = col[j] < K ? to_f(rows[i * K + col[j]]) : neg_inf();
          p[i].le += b[j] <= xv[i];
        }
        fold(p[i], v);
      }
    }
  }
  // one butterfly for the four rows: rows 0, 1 to lanes < 16 and 2, 3 to
  // lanes >= 16, then one row to each half of those, then within eight
  // lanes; lanes 8q ... 8q + 7 end with row q
  const bool hi16 = lane & 16, hi8 = lane & 8;
  const Part q0 = merge(pick(hi16, p[2], p[0]), shfl(pick(hi16, p[0], p[2]), 16));
  const Part q1 = merge(pick(hi16, p[3], p[1]), shfl(pick(hi16, p[1], p[3]), 16));
  Part r = merge(pick(hi8, q1, q0), shfl(pick(hi8, q0, q1), 8));
  r = merge(r, shfl(r, 4));
  r = merge(r, shfl(r, 2));
  r = merge(r, shfl(r, 1));
  const int q = lane >> 3;
  if (wpg > 1) {  // the group's warps merge their slices' parts
    if ((lane & 7) == 0) red[warp * kGroup + q] = r;
    __syncthreads();
    if (slice != 0) return;
    for (int w = 1; w < wpg; ++w) r = merge(r, red[(warp + w) * kGroup + q]);
  }
  if ((lane & 7) == 0 && q < ng) {
    const float xq = q == 0 ? xv[0] : q == 1 ? xv[1] : q == 2 ? xv[2] : xv[3];
    const int gt = isnan(xq) ? 0 : K - nan_bins - r.le;
    const int below = min(max(r.le - 1, 0), K - 1);
    const int above = min(max(K - gt, 0), K - 1);
    const E* row = rows + q * K;
    out[job.r0 + g0 + q] = tail(r, xq, sbins[below], sbins[above], to_f(row[below]), to_f(row[above]), below, above);
  }
}

template <typename E>
__global__ void __launch_bounds__(kThreads, 3)
two_hot_kernel(const float* __restrict__ x, const E* __restrict__ logits, const float* __restrict__ bins,
               float* __restrict__ out, int N, int K, int rows_per_run, int cols, int chunks, int stage_bytes,
               int runs) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  Part* red = reinterpret_cast<Part*>(smem + 16);
  unsigned char* ring = smem + kHeader;
  float* sbins = reinterpret_cast<float*>(ring + 2 * stage_bytes);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool long_rows = chunks > 1;
  const int items = (runs - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x * chunks;
  // the bins' image in a long row's stage, after the logits' image
  const int bins_at = (cols * static_cast<int>(sizeof(E)) + 15) / 16 * 16 + 16;

  // warp 0 stages item j (the block's j-th unit) into ring stage j % 2
  auto stage_item = [&](int j) {
    const int run = blockIdx.x + (j / chunks) * gridDim.x, chunk = j % chunks;
    unsigned char* st = ring + (j & 1) * stage_bytes;
    Body body_l, body_b{nullptr, nullptr, 0};
    if (!long_rows) {
      const long long r0 = static_cast<long long>(run) * rows_per_run;
      body_l = stage_range(st, logits + r0 * K, min(static_cast<long long>(rows_per_run), N - r0) * K, lane, 0);
    } else {
      const int c0 = chunk * cols, len = min(cols, K - c0);
      body_l = stage_range(st, logits + static_cast<long long>(run) * K + c0, len, lane, 0);
      body_b = stage_range(st + bins_at, bins + c0, len, lane, 16);
    }
    if (lane == 0) {
      // this stage's last readers are behind the barrier that ended item
      // j - 2; order their reads before the copy engine's writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive_expect_tx(&bar[j & 1], body_l.bytes + body_b.bytes);
      if (body_l.bytes) bulk_copy(body_l.dst, body_l.src, body_l.bytes, &bar[j & 1]);
      if (body_b.bytes) bulk_copy(body_b.dst, body_b.src, body_b.bytes, &bar[j & 1]);
    }
  };

  if (tid == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) stage_item(0);
  int* nan_count = reinterpret_cast<int*>(smem + 8 * kGroup * sizeof(Part) + 16);
  if (!long_rows) {
    int nans = 0;
    for (int c = tid; c < K; c += kThreads) {
      const float b = __ldg(bins + c);
      sbins[c] = b;
      nans += isnan(b);
    }
    if (tid == 0) *nan_count = 0;
    __syncthreads();
    if (nans) atomicAdd(nan_count, nans);
  }
  __syncthreads();  // the bins, their NaN count and item 0's head and tail are in place
  const int nan_bins = long_rows ? 0 : *nan_count;

  Part p = empty_part();  // a long row's running part, across its chunks
  float xr = 0.f;
  for (int j = 0; j < items; ++j) {
    if (warp == 0 && j + 1 < items) stage_item(j + 1);
    const int run = blockIdx.x + (j / chunks) * gridDim.x, chunk = j % chunks;
    const unsigned char* st = ring + (j & 1) * stage_bytes;
    if (!long_rows) {
      const int r0 = run * rows_per_run;
      const RowsJob job = rows_job(x, r0, min(rows_per_run, N - r0), warp);
      const E* src = logits + static_cast<long long>(r0) * K;
      mbar_wait(&bar[j & 1], (j >> 1) & 1);
      rows_pass(job, reinterpret_cast<const E*>(st + (reinterpret_cast<uintptr_t>(src) & 15)), sbins, nan_bins, out,
                red, K, warp, lane);
    } else {
      mbar_wait(&bar[j & 1], (j >> 1) & 1);
      const int c0 = chunk * cols, len = min(cols, K - c0);
      const E* src = logits + static_cast<long long>(run) * K + c0;
      const E* lg = reinterpret_cast<const E*>(st + (reinterpret_cast<uintptr_t>(src) & 15));
      const float* bn = reinterpret_cast<const float*>(st + bins_at + (reinterpret_cast<uintptr_t>(bins + c0) & 15));
      if (chunk == 0) {
        xr = __ldg(x + run);
        p = empty_part();
      }
      for (int c = tid; c < len; c += kThreads * kTile) {
        float v[kTile];
#pragma unroll
        for (int t = 0; t < kTile; ++t) {
          const int cc = c + kThreads * t;
          const bool ok = cc < len;
          const float b = ok ? bn[cc] : 0.f;
          v[t] = ok ? to_f(lg[cc]) : neg_inf();
          p.le += ok && b <= xr;
          p.gt += ok && b > xr;
        }
        fold(p, v);
      }
      if (chunk == chunks - 1) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) p = merge(p, shfl(p, off));
        if (lane == 0) red[warp] = p;
        __syncthreads();
        if (tid == 0) {
          Part r = red[0];
          for (int w = 1; w < kWarps; ++w) r = merge(r, red[w]);
          const int below = min(max(r.le - 1, 0), K - 1);
          const int above = min(max(K - r.gt, 0), K - 1);
          const E* row = logits + static_cast<long long>(run) * K;
          out[run] = tail(r, xr, __ldg(bins + below), __ldg(bins + above), to_f(row[below]), to_f(row[above]),
                          below, above);
        }
      }
    }
    __syncthreads();  // every thread is done with this stage before it is refilled
  }
}

long long image_bytes(long long nbytes) { return (nbytes + 15) / 16 * 16 + 16; }

template <typename E>
int launch(const float* x, const void* logits, const float* bins, float* out, int N, int K, int rows_per_run,
           int cols, int stage_bytes, int blocks, cudaStream_t stream) {
  const long long item = sizeof(E);
  const int chunks = (K + cols - 1) / cols;
  // the plan (ops/kernels/two_hot.py:launch_plan): whole rows in runs, or
  // one row at a time in chunks whose bins ride in the same stage
  long long need, bins_bytes;
  if (chunks == 1) {
    if (cols != K || rows_per_run > kWarps * kGroup) return static_cast<int>(cudaErrorInvalidValue);
    need = image_bytes(item * rows_per_run * K);
    bins_bytes = (4LL * K + 15) / 16 * 16;
  } else {
    if (rows_per_run != 1 || cols % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
    need = image_bytes(item * cols) + image_bytes(4LL * cols);
    bins_bytes = 0;
  }
  const int runs = (N + rows_per_run - 1) / rows_per_run;
  const long long smem = kHeader + 2LL * stage_bytes + bins_bytes;
  if (stage_bytes % 16 != 0 || need > stage_bytes || stage_bytes > kMaxStage || smem > kSmemLimit ||
      blocks < 1 || blocks > runs)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(two_hot_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  two_hot_kernel<E><<<blocks, kThreads, smem, stream>>>(x, static_cast<const E*>(logits), bins, out, N, K,
                                                         rows_per_run, cols, chunks, stage_bytes, runs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (logits); x [N], bins [K] and out [N]
// are float32. N, K >= 1; rows_per_run, chunk_cols, stage_bytes and blocks
// are ops/kernels/two_hot.py:launch_plan's. Returns a cudaError_t.
extern "C" int two_hot_log_prob_forward(int dtype, const void* x, const void* logits, const void* bins, void* out,
                                        int N, int K, int rows_per_run, int chunk_cols, int stage_bytes, int blocks,
                                        void* stream) {
  if (N < 1 || K < 1 || rows_per_run < 1 || chunk_cols < 1 || chunk_cols > K)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xp = static_cast<const float*>(x);
  const auto* bp = static_cast<const float*>(bins);
  auto* op = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<uint32_t>(xp, logits, bp, op, N, K, rows_per_run, chunk_cols, stage_bytes, blocks, st);
  if (dtype == 1) return launch<uint16_t>(xp, logits, bp, op, N, K, rows_per_run, chunk_cols, stage_bytes, blocks, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
