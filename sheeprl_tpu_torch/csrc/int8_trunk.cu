// The fused int8 SAC trunk for Hopper (sm_90a): three W8A8 linears with
// ReLU between them, `serve --algo sac --quant int8`'s policy step.
//
// Replaces the TPU kernel sheeprl_tpu/ops/pallas_kernels.py:fused_int8_trunk
// (`_fused_int8_kernel` over `_int8_trunk_math`). Per layer, exactly as the
// plain version (`ops/kernels/int8_trunk.py:int8_trunk_reference`):
//   x_q = int8(clip(round_half_even(x / in_scale), -127, 127))   per input channel
//   acc = sum_k x_q[k] * w_q[n, k]                               int32, wrapping
//   y   = float(acc) * w_scale[n] + bias[n]                      two f32 roundings
//   a   = relu(y)                                                trunk layers only
// Every f32 step is the IEEE operation the plain version runs, in its order:
// a correctly rounded division (never a multiply by the reciprocal), rint's
// half-to-even, and the dequant's multiply and add as two roundings
// (__fmul_rn/__fadd_rn, which nvcc never contracts into an FMA). The integer
// sum may be taken in any order and split in any way: two's-complement
// addition wraps modulo 2^32 and is associative, so the wrapped int32 sum is
// the same. A one-ulp difference in a layer's output could move the next
// layer's quantized value across a .5, so the kernel matches the plain
// version bit for bit.
//
// What bounds it on an H100: at the serving path's shapes (B <= 8 rows,
// 3 -> 256 -> 256 -> 1) the work is ~66 K int8 weights and ~1 M int8
// operations: 0.02 us of bytes, 0.5 ns of operations. The kernel is set by
// its launch and by the three dependent layers' latency; at the widest trunk
// the 10 MiB guard admits (3 -> 3,224 -> 3,224 -> 1) by its weight bytes.
//
// Design (one launch; the plan is ops/kernels/int8_trunk.py:launch_plan,
// checked here):
// - A thread-block cluster of 8 blocks a 16-row tile, so every layer of a
//   serving batch runs on 8 SMs; where the row tiles' clusters would not fit
//   the card at once (B > 256), a cluster of one block a row tile. A block
//   has 8 warps, or 16 where the layers hold more than 1,024 k-blocks of
//   work. Each layer's 8-column tiles (and, where K is long, their splits of
//   K) are dealt round-robin to the cluster's warps.
// - The products are mma.sync.m16n8k32.row.col.s32.s8.s8.s32 (no
//   .satfinite, which would clamp) on the int8 tensor cores. Lane (g, t)
//   takes 16 bytes [16t, 16t + 16) of each 64-byte k-block of its A rows g,
//   g + 8 and of its B row g (the weight row, K contiguous: the `.col`
//   operand as it lies): two MMAs a k-block, each over the same permutation
//   of K for A and B, which leaves the sum unchanged; the two MMAs feed two
//   accumulator chains, so they do not wait on each other. No chain runs
//   past 2,048 k-blocks (2^17 products of |x_q| <= 127 and |w_q| <= 128 stay
//   inside int32); chains and the splits' partials (summed by the tile's
//   owner rank) are added with wrapping adds.
// - Weights are read once: each warp streams its k-blocks' 16-byte slices
//   through a cp.async ring, 128 k-blocks a block (zero-filled past N and K; 4-byte or
//   byte loads where K is ragged), the next layer's first blocks already in
//   flight while a layer finishes. A warp's first tile's epilogue operands
//   (scales, biases, the next layer's input scales) are loaded at the start,
//   so a narrow layer's epilogue waits on no load.
// - Each layer's output is quantized in its epilogue straight into the next
//   layer's int8 image, which every rank holds in shared memory: a warp
//   writes its tile into its own rank's copy, then pushes the tile's rows,
//   8 bytes each, into the other ranks' copies through distributed shared
//   memory, and a cluster barrier separates the layers. Where the
//   three images do not fit beside the ring, one copy a cluster lives in a
//   device-memory scratch instead.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;  // blocks a cluster (1 where many row tiles fill the card)
// warps a block, 8 or 16 (the plan's choice: 16 where the layers hold
// enough k-blocks to keep them busy); each warp keeps kRingBlocks / warps
// weight k-blocks in flight
constexpr int kRows = 16;           // a row tile: mma.sync's m16
constexpr int kKB = 64;             // bytes of K a k-block
constexpr int kSlot = 8 * kKB;      // one k-block of an 8-column tile
constexpr int kRingBlocks = 128;   // weight k-blocks in flight a block
constexpr int kRing = kRingBlocks * kSlot;
constexpr int kChunkBlocks = 2048;  // the longest product chain, in k-blocks
constexpr int kSmemLimit = 232448 - 1024;

struct Layer {
  const float* in_scale;    // [K]
  const int8_t* w;          // [N, K]
  const float* w_scale;     // [N]
  const float* bias;        // [N]
  const float* next_scale;  // the next layer's in_scale [N]; null for the head
  int K, N, tiles, kblocks, splits, kps, stride, mode;  // mode: bytes a weight load (16, 4 or 1)
};

struct Trunk {
  Layer l[3];
  const float* x;  // [B, Dx]
  float* out;      // [B, A]
  int8_t* scratch; // the images a row tile, or null where they are in shared memory
  int B, cluster, image_bytes, partial_bytes;
};

__device__ __forceinline__ int8_t quantize(float v, float scale) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.f), 127.f);
  return static_cast<int8_t>(__float2int_rn(q));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a @ b, m16n8k32, s8 operands, s32 sums that wrap. Fragments (g =
// lane / 4, t = lane % 4): a = {A[g][4t..], A[g+8][4t..], A[g][16+4t..],
// A[g+8][16+4t..]}, b = {B[4t..][g], B[16+4t..][g]}, d = {D[g][2t],
// D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}.
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int kDepth>
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kDepth - 1) : "memory");
}

// 8 bytes to the copy in rank `rank`'s shared memory of this block's
// shared-memory address `local`
__device__ __forceinline__ void st_cluster_u64(const void* local, int rank, uint64_t v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(local)), "r"(rank));
  asm volatile("st.shared::cluster.u64 [%0], %1;\n" ::"r"(remote), "l"(v) : "memory");
}

// the split cluster barrier: arrive (release) and wait (acquire)
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait;\n" ::: "memory"); }

// A warp's place in its sequence of weight k-blocks: layer by layer, its
// items (tile, split) gw, gw + cw, ..., each split's k-blocks in order (cw:
// the warps of its cluster). The
// fields of its layer that a copy needs are held here, so that a k-block
// costs an add, not a reload and a division.
struct Feed {
  int layer, item, kb, kb_end, k, K, mode;
  bool in_n;
  const int8_t* row;  // weight row tile * 8 + g of the layer
};

__device__ __forceinline__ void feed_seek(Feed& f, const Layer* L, int gw, int lane) {
  for (; f.layer < 3; ++f.layer, f.item = gw) {
    const Layer& l = L[f.layer];
    if (f.item < l.tiles * l.splits) {
      const int split = f.item % l.splits, n = (f.item / l.splits) * 8 + (lane >> 2);
      f.kb = split * l.kps;
      f.kb_end = min(l.kblocks, f.kb + l.kps);
      f.k = f.kb * kKB + 16 * (lane & 3);
      f.K = l.K;
      f.mode = l.mode;
      f.in_n = n < l.N;
      f.row = l.w + (f.in_n ? static_cast<long long>(n) * l.K : 0);
      return;
    }
  }
}

__device__ __forceinline__ void feed_next(Feed& f, const Layer* L, int gw, int cw, int lane) {
  if (f.layer == 3) return;
  f.k += kKB;
  if (++f.kb < f.kb_end) return;
  f.item += cw;
  feed_seek(f, L, gw, lane);
}

// Lane (g, t) stages bytes [16t, 16t + 16) of k-block f.kb of its weight
// row into its 16 bytes of `slot` (zeros past N and K), then moves `f` on;
// one commit group a call, empty past the warp's last k-block.
__device__ __forceinline__ void feed_step(Feed& f, const Layer* L, unsigned char* slot, int gw, int cw, int lane) {
  if (f.layer < 3) {
    unsigned char* dst = slot + 16 * lane;
    const int8_t* src = f.row + f.k;
    if (f.mode == 16) {
      const bool ok = f.in_n && f.k < f.K;
      cp_async16(dst, ok ? src : f.row, ok ? 16 : 0);
    } else if (f.mode == 4) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool ok = f.in_n && f.k + 4 * q < f.K;
        cp_async4(dst + 4 * q, ok ? src + 4 * q : f.row, ok ? 4 : 0);
      }
    } else {
      uint32_t v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q] = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if (f.in_n && f.k + 4 * q + b < f.K) v[q] |= static_cast<uint32_t>(static_cast<uint8_t>(src[4 * q + b])) << (8 * b);
        }
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
  cp_async_commit();
  feed_next(f, L, gw, cw, lane);
}

// the epilogue's f32 operands for columns n, n + 1 (zeros past N)
struct Epi {
  float s0, s1, b0, b1, q0, q1;
};

__device__ __forceinline__ Epi load_epi(const Layer& l, int n) {
  Epi e{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (n < l.N) {
    e.s0 = __ldg(l.w_scale + n);
    e.b0 = __ldg(l.bias + n);
    if (l.next_scale) e.q0 = __ldg(l.next_scale + n);
  }
  if (n + 1 < l.N) {
    e.s1 = __ldg(l.w_scale + n + 1);
    e.b1 = __ldg(l.bias + n + 1);
    if (l.next_scale) e.q1 = __ldg(l.next_scale + n + 1);
  }
  return e;
}

__device__ __forceinline__ float dequant(int acc, float scale, float bias) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
}

__device__ __forceinline__ uint32_t wrap_add(int a, int b) {
  return static_cast<uint32_t>(a) + static_cast<uint32_t>(b);
}

template <int kWarps>
__global__ void __launch_bounds__(32 * kWarps)
int8_trunk_kernel(const Trunk P) {
  constexpr int kThreads = 32 * kWarps, kDepth = kRingBlocks / kWarps;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Layer L[3];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank()), cs = P.cluster, cw = cs * kWarps;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int gw = rank * kWarps + warp;
  const int tile_row = blockIdx.x / cs;
  const int row0 = tile_row * kRows, rows = min(kRows, P.B - row0);
  const bool scratch = P.scratch != nullptr;
  unsigned char* ring = smem + warp * kDepth * kSlot;
  int* part = reinterpret_cast<int*>(smem + kRing);
  // the three layers' input images, one after another: this rank's
  // copies, or the cluster's in the scratch
  int8_t* in = scratch ? P.scratch + static_cast<long long>(tile_row) * P.image_bytes
                       : reinterpret_cast<int8_t*>(smem + kRing + P.partial_bytes);
  if (tid < 3) L[tid] = P.l[tid];
  __syncthreads();

  // layer 0's input: each thread's first element of x goes out first, so
  // that its load overlaps the weights' (a ragged first layer's weight
  // bytes are loaded synchronously)
  const int dx = L[0].K, x_total = rows * dx;
  const int x_first = scratch ? rank * kThreads + tid : tid, x_step = scratch ? cs * kThreads : kThreads;
  float x0 = 0.f, s0 = 1.f;
  if (x_first < x_total) {
    const int r = x_first / dx, k = x_first - r * dx;
    x0 = __ldg(P.x + static_cast<long long>(row0 + r) * dx + k);
    s0 = __ldg(L[0].in_scale + k);
  }
  // then the first kDepth weight k-blocks, then the epilogue operands of
  // the warp's first tile in each layer
  Feed feed{0, gw};
  feed_seek(feed, L, gw, lane);
#pragma unroll
  for (int i = 0; i < kDepth; ++i) feed_step(feed, L, ring + i * kSlot, gw, cw, lane);
  const Epi first0 = load_epi(L[0], gw * 8 + 2 * t), first1 = load_epi(L[1], gw * 8 + 2 * t),
            first2 = load_epi(L[2], gw * 8 + 2 * t);

  // layer 0's image: x quantized, by this block alone into its own copy,
  // or by the cluster's ranks together into the scratch
  for (int e = x_first; e < x_total; e += x_step) {
    const int r = e / dx, k = e - r * dx;
    const float v = e == x_first ? x0 : __ldg(P.x + static_cast<long long>(row0 + r) * dx + k);
    in[r * L[0].stride + k] = quantize(v, e == x_first ? s0 : __ldg(L[0].in_scale + k));
  }
  if (scratch) __threadfence();
  // every rank must be running before another writes into its shared
  // memory: arrive now, and wait before the first remote write
  cluster_arrive();
  bool waiting = true;
  if (scratch) {
    cluster_wait();
    waiting = false;
  } else {
    __syncthreads();
  }

  int step = 0;  // k-blocks consumed: the ring slot is step % kDepth
#pragma unroll
  for (int li = 0; li < 3; ++li) {
    const int N = L[li].N, stride = L[li].stride, splits = L[li].splits, kps = L[li].kps;
    const int kblocks = L[li].kblocks, items = L[li].tiles * splits;
    int8_t* next = li < 2 ? in + kRows * stride : nullptr;
    const int next_stride = li < 2 ? L[li + 1].stride : 0;
    for (int item = gw; item < items; item += cw) {
      const int tile = item / splits, split = item % splits;
      const int kb0 = split * kps, kb1 = min(kblocks, kb0 + kps);
      // the two MMAs of a k-block feed two chains, summed (wrapping) after
      int ca[4] = {0, 0, 0, 0}, cb[4] = {0, 0, 0, 0};
      const int8_t* a_row = in + g * stride + kb0 * kKB + 16 * t;
#pragma unroll 2
      for (int kb = kb0; kb < kb1; ++kb, ++step, a_row += kKB) {
        unsigned char* slot = ring + (step % kDepth) * kSlot;
        // the scratch is written by other blocks of this launch: read it past L1
        const auto* a_lo = reinterpret_cast<const uint4*>(a_row);
        const auto* a_hi = reinterpret_cast<const uint4*>(a_row + 8 * stride);
        const uint4 lo = scratch ? __ldcg(a_lo) : *a_lo;
        const uint4 hi = rows <= 8 ? make_uint4(0, 0, 0, 0) : scratch ? __ldcg(a_hi) : *a_hi;
        cp_async_wait_ring<kDepth>();
        const uint4 b = *reinterpret_cast<const uint4*>(slot + 16 * lane);
        mma_s8(ca, lo.x, hi.x, lo.y, hi.y, b.x, b.y);
        mma_s8(cb, lo.z, hi.z, lo.w, hi.w, b.z, b.w);
        feed_step(feed, L, slot, gw, cw, lane);  // the slot is free: refill it kDepth k-blocks ahead
      }
      int c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) c[i] = static_cast<int>(wrap_add(ca[i], cb[i]));
      if (waiting) {
        cluster_wait();
        waiting = false;
      }
      if (splits > 1) {
        // the split's partial to the tile's owner rank
        int* dst = cluster.map_shared_rank(part, tile % cs) + ((tile / cs) * splits + split) * 128;
        *reinterpret_cast<int2*>(dst + g * 8 + 2 * t) = make_int2(c[0], c[1]);
        *reinterpret_cast<int2*>(dst + (g + 8) * 8 + 2 * t) = make_int2(c[2], c[3]);
        continue;
      }
      const int n = tile * 8 + 2 * t;
      const Epi e = item != gw ? load_epi(L[li], n) : li == 0 ? first0 : li == 1 ? first1 : first2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = g + 8 * h;
        if (r >= rows || n >= N) continue;
        const bool two = n + 1 < N;
        const float y0 = dequant(c[2 * h], e.s0, e.b0), y1 = dequant(c[2 * h + 1], e.s1, e.b1);
        if (next == nullptr) {
          float* o = P.out + static_cast<long long>(row0 + r) * N + n;
          o[0] = y0;
          if (two) o[1] = y1;
          continue;
        }
        const uint8_t q0 = static_cast<uint8_t>(quantize(fmaxf(y0, 0.f), e.q0));
        const uint8_t q1 = two ? static_cast<uint8_t>(quantize(fmaxf(y1, 0.f), e.q1)) : 0;
        int8_t* at = next + r * next_stride + n;  // this rank's copy, or the scratch
        if (two) {
          *reinterpret_cast<uint16_t*>(at) = static_cast<uint16_t>(q0 | (q1 << 8));
        } else {
          *reinterpret_cast<uint8_t*>(at) = q0;
        }
      }
      if (next != nullptr && !scratch && cs > 1) {
        // the tile's rows, 8 bytes each, pushed to the other ranks' copies
        // (the columns past N among them are zero-weighted by the next layer)
        __syncwarp();
        const int pairs = min(rows, kRows) * (cs - 1);
        for (int i = lane; i < pairs; i += 32) {
          const int r = i % rows, d = i / rows;
          const int8_t* src = next + r * next_stride + tile * 8;
          st_cluster_u64(src, d < rank ? d : d + 1, *reinterpret_cast<const uint64_t*>(src));
        }
      }
    }
    if (waiting) {
      cluster_wait();
      waiting = false;
    }
    if (splits > 1) {
      // the owner sums each of its tiles' split partials (wrapping int32
      // adds, in split order) and runs the epilogue
      if (scratch) __threadfence();
      cluster.sync();
      const Layer& l = L[li];
      const int owned = (l.tiles + cs - 1) / cs;
      for (int e = tid; e < owned * 128; e += kThreads) {
        const int lt = e >> 7, tile = lt * cs + rank, r = (e & 127) >> 3, n = tile * 8 + (e & 7);
        if (tile >= l.tiles || r >= rows || n >= N) continue;
        uint32_t acc = 0;
        for (int s = 0; s < splits; ++s) acc += static_cast<uint32_t>(part[(lt * splits + s) * 128 + (e & 127)]);
        const float y = dequant(static_cast<int>(acc), __ldg(l.w_scale + n), __ldg(l.bias + n));
        if (next == nullptr) {
          P.out[static_cast<long long>(row0 + r) * N + n] = y;
          continue;
        }
        const int8_t q = quantize(fmaxf(y, 0.f), __ldg(l.next_scale + n));
        int8_t* at = next + r * next_stride + n;
        for (int dst_rank = 0; dst_rank < (scratch ? 1 : cs); ++dst_rank)
          *(scratch ? at : cluster.map_shared_rank(at, dst_rank)) = q;
      }
    }
    if (next != nullptr) {
      // the next layer's image is complete in every rank (or the scratch);
      // for the head nothing follows, and no rank touches another's
      // shared memory after the last barrier
      if (scratch) __threadfence();
      cluster.sync();
    }
    in = next;
  }
}

long long stride_of(int K) {
  const long long kb = (K + kKB - 1) / kKB;
  return kb * kKB + (kb % 2 == 0 ? 64 : 0);
}

int load_mode(const void* w, int K) {
  const auto a = reinterpret_cast<uintptr_t>(w);
  if (K % 16 == 0 && a % 16 == 0) return 16;
  if (K % 4 == 0 && a % 4 == 0) return 4;
  return 1;
}

template <int kWarps>
int launch(const Trunk& P, size_t smem, int cluster, int B, void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(int8_trunk_kernel<kWarps>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * ((B + kRows - 1) / kRows));
  cfg.blockDim = dim3(32 * kWarps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, int8_trunk_kernel<kWarps>, P);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B, Dx] f32; per layer in_scale [in] f32, w_q [out, in] int8, w_scale
// [out] f32, bias [out] f32; out [B, A] f32. cluster (1 or 8), warps (8 or
// 16) and splits0..2 are ops/kernels/int8_trunk.py:launch_plan's; `scratch` holds its
// scratch_bytes of device memory, or is null when that is 0. Returns a
// cudaError_t.
extern "C" int fused_int8_trunk_forward(const void* x, const void* s0, const void* w0, const void* ws0,
                                        const void* b0, const void* s1, const void* w1, const void* ws1,
                                        const void* b1, const void* sm, const void* wm, const void* wsm,
                                        const void* bm, void* out, void* scratch, int B, int Dx, int H0, int H1,
                                        int A, int cluster, int warps, int splits0, int splits1, int splits2,
                                        void* stream) {
  if (B < 1 || Dx < 1 || H0 < 1 || H1 < 1 || A < 1 || (cluster != 1 && cluster != kMaxCluster) ||
      (warps != 8 && warps != 16))
    return static_cast<int>(cudaErrorInvalidValue);
  Trunk P{};
  const int dims[4] = {Dx, H0, H1, A}, splits[3] = {splits0, splits1, splits2};
  const void* tensors[3][4] = {{s0, w0, ws0, b0}, {s1, w1, ws1, b1}, {sm, wm, wsm, bm}};
  long long images = 0, partial = 0;
  for (int i = 0; i < 3; ++i) {
    Layer& l = P.l[i];
    l.in_scale = static_cast<const float*>(tensors[i][0]);
    l.w = static_cast<const int8_t*>(tensors[i][1]);
    l.w_scale = static_cast<const float*>(tensors[i][2]);
    l.bias = static_cast<const float*>(tensors[i][3]);
    l.next_scale = i < 2 ? static_cast<const float*>(tensors[i + 1][0]) : nullptr;
    l.K = dims[i];
    l.N = dims[i + 1];
    l.tiles = (l.N + 7) / 8;
    l.kblocks = (l.K + kKB - 1) / kKB;
    l.splits = splits[i];
    // the plan: splits cover K with none empty, no chain past kChunkBlocks
    if (l.splits < 1 || l.splits > l.kblocks) return static_cast<int>(cudaErrorInvalidValue);
    l.kps = (l.kblocks + l.splits - 1) / l.splits;
    if ((l.splits - 1) * l.kps >= l.kblocks || l.kps > kChunkBlocks) return static_cast<int>(cudaErrorInvalidValue);
    l.stride = static_cast<int>(stride_of(l.K));
    l.mode = load_mode(l.w, l.K);
    images += kRows * static_cast<long long>(l.stride);
    if (l.splits > 1) {
      const long long bytes = static_cast<long long>((l.tiles + cluster - 1) / cluster) * l.splits * 128 * 4;
      partial = bytes > partial ? bytes : partial;
    }
  }
  const bool fit = kRing + partial + images <= kSmemLimit;
  if ((scratch == nullptr) != fit || kRing + partial > kSmemLimit || images > (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  P.x = static_cast<const float*>(x);
  P.out = static_cast<float*>(out);
  P.scratch = static_cast<int8_t*>(scratch);
  P.B = B;
  P.cluster = cluster;
  P.image_bytes = static_cast<int>(images);
  P.partial_bytes = static_cast<int>(partial);
  const size_t smem = kRing + partial + (fit ? images : 0);
  return warps == 16 ? launch<16>(P, smem, cluster, B, stream) : launch<8>(P, smem, cluster, B, stream);
}
