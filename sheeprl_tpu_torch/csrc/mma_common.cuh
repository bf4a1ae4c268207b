// Shared by csrc/ln_gru.cu, csrc/fused_rssm.cu and csrc/conv_common.cuh
// (the conv and deconv): tensor-core products with mma.sync, ldmatrix
// fragment loads, cp.async copies into shared memory, and the TF32 split
// behind the f32 path.
//
// The GRU and the RSSM step compute row tiles of [rows, K] @ W^T with f32
// sums, W in the port's Linear layout [out, in] (K contiguous). That layout
// is the `.col` B operand of mma.sync as it stands, so a weight row is
// copied as it lies in memory, 16 bytes at a time. The conv's HWIO weight
// is [K, Cout] (Cout contiguous), a `.row` tile: bf16 fragments come
// through ldmatrix.trans, TF32 ones through 32-bit shared loads.
//
// f32 numerics (3xTF32). A single TF32 product keeps about 11 significant
// bits of each operand, too few for the f32 kernels' 1e-4 tolerance. Each
// operand is split as hi = tf32(a), lo = tf32(a - hi), and a*b is taken as
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi with f32 accumulation (CUTLASS's
// 3xTF32): the dropped a_lo*b_lo term and the rounding of lo leave an error
// near f32's own. The kernels issue the three terms as three mma_tf32, each
// term for all their accumulators before the next, so that consecutive
// MMAs do not wait on each other. bf16 operands take one bf16 MMA with f32
// accumulation.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace mma_common {

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mma.sync
// ---------------------------------------------------------------------------

// The MMAs touch registers only (no volatile): the compiler may interleave
// MMAs on different accumulators, which hides each one's latency.
//
// d += a @ b, m16n8k16, bf16 operands, f32 sums. Fragments as the PTX ISA
// lays them out (g = lane / 4, t = lane % 4): a = {A[g][2t..], A[g+8][2t..],
// A[g][2t+8..], A[g+8][2t+8..]}, b = {B[2t..][g], B[2t+8..][g]}, d =
// {D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a @ b, m16n8k8, TF32 operands, f32 sums: a = {A[g][t], A[g+8][t],
// A[g][t+4], A[g+8][t+4]}, b = {B[t][g], B[t+4][g]}, d as for mma_bf16.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// hi = tf32(v) (round to nearest, ties away), lo = tf32(v - hi)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  const float rest = v - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

template <int N>
__device__ __forceinline__ void split_tf32(const float (&v)[N], uint32_t (&hi)[N], uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(v[i], hi[i], lo[i]);
}

// Four 8x8 b16 matrices from shared memory: lanes 8j .. 8j+7 give the row
// addresses of matrix j (16-byte aligned), and r[j] receives row lane / 4,
// columns 2 (lane % 4) and 2 (lane % 4) + 1 of matrix j.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// The same four matrices transposed: lanes 8j .. 8j+7 give the addresses of
// rows 0 ... 7 of matrix j as it lies in shared memory, and r[j] receives
// its elements [2 (lane % 4)][lane / 4] and [2 (lane % 4) + 1][lane / 4]:
// from a [k][n] tile that is the `.col` B fragment of an n8 x k8 slice.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// ---------------------------------------------------------------------------
// cp.async
// ---------------------------------------------------------------------------

// 16 bytes global -> shared, through L2 only (.cg); bytes past `src_bytes`
// (0 ... 16) are written as zeros and not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared (.ca: the only cache mode for copies under 16
// bytes); `src_bytes` 0 writes zeros.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// How a contiguous run of T can be copied 16 bytes at a time: its row
// length in bytes and its base address decide it.
enum CopyMode : int { kCopy16 = 0, kCopy4 = 1, kCopyScalar = 2 };

template <typename T>
__host__ __device__ __forceinline__ int copy_mode(const void* base, long long row_elems) {
  const long long bytes = row_elems * static_cast<long long>(sizeof(T));
  const auto addr = reinterpret_cast<uintptr_t>(base);
  if (bytes % 16 == 0 && addr % 16 == 0) return kCopy16;
  if (bytes % 4 == 0 && addr % 4 == 0) return kCopy4;
  return kCopyScalar;
}

// One 16-byte chunk of shared memory from `valid` (0 ... 16 / sizeof(T))
// elements at src, zeros after them. kCopy16 needs src 16-byte aligned,
// kCopy4 needs src 4-byte aligned and valid * sizeof(T) a multiple of 4;
// kCopyScalar loads and stores element by element, in this thread's order
// (visible after the next barrier, like the asynchronous copies after
// their wait).
template <typename T>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src, int valid, int mode) {
  constexpr int kElems = 16 / sizeof(T);
  const int bytes = valid * static_cast<int>(sizeof(T));
  if (mode == kCopy16) {
    cp_async16(dst, src, bytes);
  } else if (mode == kCopy4) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int b = min(max(bytes - 4 * p, 0), 4);
      cp_async4(reinterpret_cast<char*>(dst) + 4 * p,
                b > 0 ? reinterpret_cast<const char*>(src) + 4 * p : reinterpret_cast<const char*>(src), b);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kElems; ++e) dst[e] = e < valid ? src[e] : from_f<T>(0.f);
  }
}

}  // namespace mma_common
