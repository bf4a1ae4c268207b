// Shared by csrc/conv_ln_silu.cu and csrc/deconv_ln_silu.cu: the implicit
// GEMM of a k4/s2 (transposed) convolution on the tensor cores, and the
// pixel pass that turns its f32 sums into LayerNorm -> SiLU outputs.
//
// The product. Both stages are C[P, Cout] = A[P, K] @ B[K, Cout] with A the
// im2col matrix of the NHWC input (never materialised) and B rows of the
// HWIO weight. A row's K index is tap * Cin + ci, so the K slice of one tap
// is Cin contiguous input channels of one input pixel, and a weight row is
// Cout contiguous values.
//
//  - A block owns a tile of BM output pixels x BN output channels, 128 x 64
//    (WM = 4) or 256 x 32 (WM = 8, for Cout <= 32), and one split of K; its
//    eight warps each compute 32 x 32 outputs: two m16 by four n8 mma.sync
//    tiles (csrc/mma_common.cuh), bf16 m16n8k16 with f32 sums, or f32 as
//    m16n8k8 3xTF32 (three TF32 products a pair, so the sums keep f32
//    accuracy).
//  - K advances 128 bytes at a time (64 bf16 or 32 f32; 64 bytes for the
//    256 x 32 tile) through a ring of kStages shared-memory stages filled
//    by cp.async. A thread copies the same one or two 16-byte columns of K
//    from two or four pixels (and one or two 16-byte chunks of the
//    weight): their taps and channels advance by kBK a stage without a
//    division, and a pixel outside the image, past P or past the split is
//    zero-filled by the copy itself. An input whose channels
//    are not whole 16-byte chunks (Cin = 3, or 37) or whose address is not
//    16-byte aligned is gathered element by element into the same tile; a
//    weight whose Cout is not whole chunks likewise.
//  - Shared tiles: A [BM][BK + 16 bytes], rows 144 (or 80) bytes apart, so
//    the eight 16-byte rows of each ldmatrix fall in distinct banks; B [BK][BN + 8]
//    with Cout contiguous (the `.row` layout of HWIO): bf16 takes its
//    fragments with ldmatrix.trans, f32 with 32-bit loads, which the padded
//    stride (BN + 8 floats: 8 banks a row) keeps conflict-free.
//  - Where one block holds a pixel's whole Cout (Cout <= BN) and K is not
//    split, the LayerNorm -> SiLU runs in the product's epilogue: the row
//    statistics reduce over the lanes (and, for two warps along the
//    channels, through shared memory), and y and the f32 residual are
//    written from the accumulators, so the pre-activation stays on chip as
//    the TPU kernel keeps it (one launch, no scratch).
//  - Otherwise the sums go to an f32 array [splits, pixels, Cout] for the
//    pixel pass. With one split and the residual asked for, that array is
//    the residual itself.
//
// The pixel pass: one warp per output pixel sums the split partials in a
// fixed order, reduces the mean and then the variance of the centred values
// over Cout (the two-pass order of the TPU kernels' `_ln_stats`) with warp
// shuffles, applies scale/offset and SiLU in f32, and writes NHWC in the
// output dtype (and, when asked for and not already there, the summed f32
// pre-activation). The first 512 channels of a pixel stay in registers;
// wider pixels read the rest again from L2 for each pass, so any Cout works.
// The two give the same statistics up to the order of f32 sums.
//
// The launch plan (tile, splits, ring depth, shared memory) comes from
// ops/kernels/cnn.py:launch_plan and is checked here (check_plan).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "mma_common.cuh"

namespace conv_common {

using namespace mma_common;

constexpr int kThreads = 256;  // eight warps
constexpr int kStages = 4;     // the cp.async ring
constexpr int kPerLane = 16;   // channels a lane keeps in registers in the pixel pass

// The tile of WM warps along the pixels (and 8 / WM along the channels),
// and its stage of K: 128 bytes for the 128 x 64 tile, 64 bytes for the
// 256 x 32 one (whose A tile is twice as tall), so that two blocks fit an SM.
template <typename T, int WM>
struct Tile {
  static constexpr int kBM = 32 * WM;
  static constexpr int kBN = 32 * (8 / WM);
  static constexpr int kE = 16 / sizeof(T);       // elements of a 16-byte chunk
  static constexpr int kSub = WM == 4 ? 2 : 1;    // 64-byte halves of a stage's K
  static constexpr int kBK = 4 * kE * kSub;       // 128 or 64 bytes of K a stage
  static constexpr int kLdA = kBK + kE;           // rows 144 or 80 bytes apart
  static constexpr int kLdB = kBN + 8;
  static constexpr int kAElems = kBM * kLdA;
  static constexpr int kStageElems = kAElems + kBK * kLdB;
  static constexpr int kSmem = kStages * kStageElems * static_cast<int>(sizeof(T));
};

// One (transposed) convolution as an implicit GEMM. DECONV picks the
// geometry of csrc/deconv_ln_silu.cu: phase (dh, dw) = blockIdx.z / splits,
// four 2 x 2 taps over the input grid, outputs interleaved.
struct Gemm {
  const void* x;
  const void* w;
  float* out;    // [splits, out pixels, Cout] f32
  int N, H, W, Cin, Cout;
  int P;         // pixels of one product: conv N*H/2*W/2, deconv N*H*W (one phase)
  int K;         // 16 Cin or 4 Cin
  int splits, k_per_split;
  int a_vec, b_vec;  // 16-byte copies of A's and B's chunks (else element by element)
  long long split_stride;  // floats between two splits' slabs of `out`
  // the fused epilogue (one split, Cout <= BN): LayerNorm -> SiLU into y,
  // and the f32 residual into pre_out where asked for (else null)
  int fuse;
  void* y;
  float* pre_out;
  const float* scale;
  const float* offset;
  float eps;
};

template <typename T>
__device__ __forceinline__ void store2(T* at, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* at, float a, float b) {
  *reinterpret_cast<float2*>(at) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* at, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(a, b);
}

// The warp's 32 x 32 outputs += this stage's A rows x B columns.
template <typename T, int WM>
__device__ __forceinline__ void stage_mma(const T* As, const T* Bs, float (&acc)[2][4][4], int wm, int wn) {
  using TL = Tile<T, WM>;
  const int lane = threadIdx.x % 32;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
    for (int ks = 0; ks < TL::kBK; ks += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], As + (wm * 32 + mi * 16 + (lane & 15)) * TL::kLdA + ks + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, Bs + (ks + (lane & 7) + ((lane >> 3) & 1) * 8) * TL::kLdB + wn * 32 + nj * 16 +
                                 (lane >> 4) * 8);
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
    }
  } else {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int ks = 0; ks < TL::kBK; ks += 8) {
      uint32_t ar[2][4], ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        // f32 rows through ldmatrix: an 8 x 8 b16 matrix is 8 rows x 4
        // floats, and lane l receives float l % 4 of row l / 4
        ldmatrix_x4(ar[mi], As + (wm * 32 + mi * 16 + (lane & 15)) * TL::kLdA + ks + (lane >> 4) * 4);
#pragma unroll
        for (int q = 0; q < 4; ++q) split_tf32(__uint_as_float(ar[mi][q]), ah[mi][q], al[mi][q]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const T* col = Bs + wn * 32 + ni * 8 + g;
        split_tf32(col[(ks + t) * TL::kLdB], bh[ni][0], bl[ni][0]);
        split_tf32(col[(ks + t + 4) * TL::kLdB], bh[ni][1], bl[ni][1]);
      }
      // the 3xTF32 terms, each for all eight accumulators before the next
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_tf32(acc[mi][ni], al[mi], bh[ni]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_tf32(acc[mi][ni], ah[mi], bl[ni]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_tf32(acc[mi][ni], ah[mi], bh[ni]);
    }
  }
}

// two blocks an SM: at most 128 registers a thread
// RES names the instantiation launched for the residual-writing forward
// (`pre_out` set); the code is the same, so a profile can tell
// conv_ln_silu_residuals' launches from conv_ln_silu's by the name alone
template <typename T, int WM, bool DECONV, bool RES>
__global__ void __launch_bounds__(kThreads, 2)
conv_gemm_kernel(const __grid_constant__ Gemm q) {
  using TL = Tile<T, WM>;
  constexpr int kE = TL::kE, kBK = TL::kBK, kBM = TL::kBM, kBN = TL::kBN;
  constexpr int kRowsPerThread = kBM / 64;  // A rows a thread copies: tid / 4 + 64 i
  constexpr int kSub = TL::kSub;             // ... at K columns kc + 4 s, s < kSub
  constexpr int kTapW = DECONV ? 2 : 4;     // taps along a window row
  extern __shared__ float4 smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp % WM, wn = warp / WM;
  const int split = DECONV ? blockIdx.z % q.splits : blockIdx.z;
  const int phase = DECONV ? blockIdx.z / q.splits : 0;
  const int dh = phase / 2, dw = phase % 2;
  const int p0 = blockIdx.x * kBM;  // x: pixel tiles may outnumber gridDim.y's 65,535
  const int c0 = blockIdx.y * kBN;
  const int k_begin = split * q.k_per_split;
  const int k_end = min(q.K, k_begin + q.k_per_split);
  const int ktiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;
  const T* x = static_cast<const T*>(q.x);
  const T* w = static_cast<const T*>(q.w);

  // the A rows this thread copies: image (-1 past P) and the input pixel of
  // tap 0 (conv: the 4 x 4 window's corner, SAME pads one pixel; deconv:
  // the 2 x 2 window of phase (dh, dw) over the input padded by one)
  const int kc = tid % 4;  // this thread's 16-byte column of each 64 bytes of A's rows
  // each row's tap-0 input pixel: row gy, column gx (gy far below 0 for a
  // row past P, so that no tap of it is in the image) and its index gpix
  int gy[kRowsPerThread], gx[kRowsPerThread];
  long long gpix[kRowsPerThread];
  {
    const int Ho = DECONV ? q.H : q.H / 2, Wo = DECONV ? q.W : q.W / 2;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int p = p0 + tid / 4 + 64 * i;
      const int rem = (p < q.P ? p : 0) % (Ho * Wo), n = (p < q.P ? p : 0) / (Ho * Wo);
      gy[i] = DECONV ? rem / Wo + dh - 1 : 2 * (rem / Wo) - 1;
      gx[i] = DECONV ? rem % Wo + dw - 1 : 2 * (rem % Wo) - 1;
      gpix[i] = ((long long)n * q.H + gy[i]) * q.W + gx[i];
      if (p >= q.P) gy[i] = -(1 << 28);
    }
  }

  // the weight row of reduction index k = tap * Cin + ci
  auto w_row = [&](int tap, int ci) -> int {
    if constexpr (DECONV) {
      return (8 * (tap / 2) + 4 * dh + 2 * (tap % 2) + dw) * q.Cin + ci;  // k[2a + dh, 2b + dw, ci]
    } else {
      return tap * q.Cin + ci;
    }
  };

  // The chunks a thread copies move by kBK along K from one stage to the
  // next, in order, so their (tap, channel) advance by an add and a compare
  // or two rather than a division a stage: A's at k = (kc + 4 s) * kE (+
  // k_begin), B's (the 16-byte copies) at rows k = b_row + s * kBStride.
  constexpr int kPerRow = kBN / kE;
  constexpr int kBStride = kThreads / kPerRow;  // weight rows a pass of the block copies
  constexpr int kBSub = (kBK + kBStride - 1) / kBStride;
  const int b_row = tid / kPerRow, b_col = (tid % kPerRow) * kE;
  int a_tap[kSub], a_ci[kSub], b_tap[kBSub], b_ci[kBSub];
#pragma unroll
  for (int sub = 0; sub < kSub; ++sub) {
    const int ka = k_begin + (kc + 4 * sub) * kE;
    a_tap[sub] = ka / q.Cin;
    a_ci[sub] = ka - a_tap[sub] * q.Cin;
  }
#pragma unroll
  for (int sub = 0; sub < kBSub; ++sub) {
    const int kb = k_begin + b_row + sub * kBStride;
    b_tap[sub] = kb / q.Cin;
    b_ci[sub] = kb - b_tap[sub] * q.Cin;
  }
  auto advance = [&](int& tap, int& ci) {
    ci += kBK;
    while (ci >= q.Cin) {
      ci -= q.Cin;
      ++tap;
    }
  };

  auto load_stage = [&](int slot, int k0) {
    T* As = smem + slot * TL::kStageElems;
    T* Bs = As + TL::kAElems;
    // A: this thread's 16-byte columns of its rows
    if (q.a_vec) {
#pragma unroll
      for (int sub = 0; sub < kSub; ++sub) {
        const int col = (kc + 4 * sub) * kE, k = k0 + col;
        const int dy = a_tap[sub] / kTapW, dx = a_tap[sub] % kTapW;
        const int shift = dy * q.W + dx;
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const bool ok = k < k_end && static_cast<unsigned>(gy[i] + dy) < static_cast<unsigned>(q.H) &&
                          static_cast<unsigned>(gx[i] + dx) < static_cast<unsigned>(q.W);
          const T* src = ok ? x + (gpix[i] + shift) * q.Cin + a_ci[sub] : x;
          cp_async16(As + (tid / 4 + 64 * i) * TL::kLdA + col, src, ok ? 16 : 0);
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < kE * kSub; ++e) {
        const int col = (kc + 4 * (e / kE)) * kE + e % kE;
        const int k = k0 + col;
        const int tap = k / q.Cin, ci = k - tap * q.Cin;
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const int dy = tap / kTapW, dx = tap % kTapW;
          const bool ok = k < k_end && static_cast<unsigned>(gy[i] + dy) < static_cast<unsigned>(q.H) &&
                          static_cast<unsigned>(gx[i] + dx) < static_cast<unsigned>(q.W);
          As[(tid / 4 + 64 * i) * TL::kLdA + col] = ok ? x[(gpix[i] + dy * q.W + dx) * q.Cin + ci] : from_f<T>(0.f);
        }
      }
    }
    // B: rows k0 ... k0 + kBK - 1 of the weight, columns c0 ... c0 + kBN - 1
    if (q.b_vec) {
#pragma unroll
      for (int sub = 0; sub < kBSub; ++sub) {
        const int r = b_row + sub * kBStride;
        if (r < kBK) {
          const int k = k0 + r, col = c0 + b_col;
          const bool ok = k < k_end && col < q.Cout;
          const int row = DECONV ? w_row(b_tap[sub], b_ci[sub]) : k;
          cp_async16(Bs + r * TL::kLdB + b_col, ok ? w + (size_t)row * q.Cout + col : w, ok ? 16 : 0);
        }
      }
    } else {
      for (int e = tid; e < kBK * kBN; e += kThreads) {
        const int r = e / kBN, col = c0 + e % kBN;
        const int k = k0 + r;
        const int tap = k / q.Cin;
        Bs[r * TL::kLdB + e % kBN] =
            k < k_end && col < q.Cout ? w[(size_t)w_row(tap, k - tap * q.Cin) * q.Cout + col] : from_f<T>(0.f);
      }
    }
    if (q.a_vec) {
#pragma unroll
      for (int sub = 0; sub < kSub; ++sub) advance(a_tap[sub], a_ci[sub]);
    }
    if (DECONV && q.b_vec) {
#pragma unroll
      for (int sub = 0; sub < kBSub; ++sub) advance(b_tap[sub], b_ci[sub]);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

  // the ring: stages 0 ... kStages - 2 in flight before the first product;
  // every iteration commits one group (empty past the end), so waiting for
  // all but kStages - 2 groups means stage kt has landed
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_stage(s, k_begin + s * kBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt is visible; every warp is done with stage kt - 1
    const int next = kt + kStages - 1;
    if (next < ktiles) load_stage(next % kStages, k_begin + next * kBK);
    cp_async_commit();
    const T* As = smem + (kt % kStages) * TL::kStageElems;
    stage_mma<T, WM>(As, As + TL::kAElems, acc, wm, wn);
  }
  cp_async_wait<0>();

  // d = {D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}: this lane holds
  // rows wm*32 + mi*16 + g + 8h, columns wn*32 + ni*8 + 2t (+1)
  const int g = lane / 4, t = lane % 4;
  auto out_pixel = [&](int p) -> size_t {
    if constexpr (DECONV) {  // output pixel (2i + dh, 2j + dw) of image n
      const int n = p / (q.H * q.W), rem = p % (q.H * q.W);
      return ((size_t)n * 2 * q.H + 2 * (rem / q.W) + dh) * (2 * q.W) + 2 * (rem % q.W) + dw;
    } else {
      return p;
    }
  };
  if (q.fuse) {  // the whole Cout is in this block: LayerNorm -> SiLU here
    constexpr int kWN = 8 / WM;
    float* red = reinterpret_cast<float*>(smem_raw);  // [2][kBM][kWN], the ring is free
    if (kWN > 1) __syncthreads();                     // every warp is done with the ring
    float mean[2][2], rstd[2][2];
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {  // the mean, then the mean of squared deviations
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v = 0.f;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float a = acc[mi][ni][2 * h + j];
              const float d = pass == 0 ? a : a - mean[mi][h];
              // columns past Cout hold exact zeros (B is zero-filled there)
              v += pass == 0 ? d : (wn * 32 + ni * 8 + 2 * t + j < q.Cout ? d * d : 0.f);
            }
          }
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          const int row = wm * 32 + mi * 16 + g + 8 * h;
          if (kWN > 1 && t == 0) red[(pass * kBM + row) * kWN + wn] = v;
          if (kWN == 1) {
            if (pass == 0) mean[mi][h] = v / q.Cout;
            else rstd[mi][h] = rsqrtf(v / q.Cout + q.eps);
          }
        }
      }
      if (kWN > 1) {
        __syncthreads();
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float* r = red + (pass * kBM + wm * 32 + mi * 16 + g + 8 * h) * kWN;
            float v = 0.f;
#pragma unroll
            for (int i = 0; i < kWN; ++i) v += r[i];
            if (pass == 0) mean[mi][h] = v / q.Cout;
            else rstd[mi][h] = rsqrtf(v / q.Cout + q.eps);
          }
        }
      }
    }
    T* y = static_cast<T*>(q.y);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + wm * 32 + mi * 16 + g + 8 * h;
        if (p >= q.P) continue;
        const size_t base = out_pixel(p) * q.Cout;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int col = wn * 32 + ni * 8 + 2 * t;
          float v[2], z[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            v[j] = acc[mi][ni][2 * h + j];
            const int c = min(col + j, q.Cout - 1);
            z[j] = (v[j] - mean[mi][h]) * rstd[mi][h] * q.scale[c] + q.offset[c];
            z[j] = z[j] / (1.f + expf(-z[j]));
          }
          if (q.Cout % 2 == 0) {
            if (col < q.Cout) {
              store2<T>(y + base + col, z[0], z[1]);
              if (q.pre_out != nullptr) store2<float>(q.pre_out + base + col, v[0], v[1]);
            }
          } else {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              if (col + j < q.Cout) {
                y[base + col + j] = from_f<T>(z[j]);
                if (q.pre_out != nullptr) q.pre_out[base + col + j] = v[j];
              }
            }
          }
        }
      }
    }
    return;
  }

  // the split's partial sums
  float* out = q.out + (size_t)split * q.split_stride;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + wm * 32 + mi * 16 + g + 8 * h;
      if (p >= q.P) continue;
      float* row = out + out_pixel(p) * q.Cout;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = c0 + wn * 32 + ni * 8 + 2 * t;
        const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (q.Cout % 2 == 0) {
          if (col < q.Cout) *reinterpret_cast<float2*>(row + col) = make_float2(v0, v1);
        } else {
          if (col < q.Cout) row[col] = v0;
          if (col + 1 < q.Cout) row[col + 1] = v1;
        }
      }
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// channel c of pixel p summed over the splits, in split order
__device__ __forceinline__ float summed(const float* __restrict__ pre, size_t stride, int splits, size_t at) {
  float v = 0.f;
  for (int sp = 0; sp < splits; ++sp) v += pre[sp * stride + at];
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_silu_kernel(const float* __restrict__ pre, const float* __restrict__ scale,
               const float* __restrict__ offset, T* __restrict__ y,
               float* __restrict__ pre_out, int P, int Cout, int splits, float eps) {
  const int p = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (p >= P) return;  // warp-uniform: a whole warp owns one pixel
  const size_t stride = (size_t)P * Cout, base = (size_t)p * Cout;
  constexpr int kCached = 32 * kPerLane;
  // slots i < live hold channels (warp-uniform), so the unrolled loops
  // below stop at the first slot past Cout
  const int live = min(kPerLane, (Cout + 31) / 32);
  float v[kPerLane];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    if (i >= live) break;
    const int c = lane + 32 * i;
    v[i] = 0.f;
    if (c < Cout) {
      v[i] = summed(pre, stride, splits, base + c);
      s += v[i];
      if (pre_out != nullptr) pre_out[base + c] = v[i];
    }
  }
  for (int c = kCached + lane; c < Cout; c += 32) {
    const float u = summed(pre, stride, splits, base + c);
    s += u;
    if (pre_out != nullptr) pre_out[base + c] = u;
  }
  const float mean = warp_sum(s) / Cout;
  float qv = 0.f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    if (i >= live) break;
    const int c = lane + 32 * i;
    if (c < Cout) {
      const float d = v[i] - mean;
      qv += d * d;
    }
  }
  for (int c = kCached + lane; c < Cout; c += 32) {
    const float d = summed(pre, stride, splits, base + c) - mean;
    qv += d * d;
  }
  const float rstd = rsqrtf(warp_sum(qv) / Cout + eps);
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    if (i >= live) break;
    const int c = lane + 32 * i;
    if (c < Cout) {
      const float z = (v[i] - mean) * rstd * scale[c] + offset[c];
      y[base + c] = from_f<T>(z / (1.f + expf(-z)));
    }
  }
  for (int c = kCached + lane; c < Cout; c += 32) {
    const float z = (summed(pre, stride, splits, base + c) - mean) * rstd * scale[c] + offset[c];
    y[base + c] = from_f<T>(z / (1.f + expf(-z)));
  }
}

// The plan of ops/kernels/cnn.py:launch_plan for a product of P pixels,
// reduction K and Cout channels (`phases` products side by side): the
// split covers K in whole stages with none empty, the grid fits its
// limits and the shared memory is what the tile needs.
template <typename T>
bool check_plan(int P, int K, int Cout, int phases, int wm, int splits, int k_per_split, int stages, int smem) {
  if (wm != 4 && wm != 8) return false;
  const int kBK = wm == 4 ? Tile<T, 4>::kBK : Tile<T, 8>::kBK;
  if (stages != kStages || splits < 1 || k_per_split < kBK || k_per_split % kBK != 0) return false;
  if ((long long)(splits - 1) * k_per_split >= K || (long long)splits * k_per_split < K) return false;
  if ((long long)phases * splits > 65535 || (Cout + 32 * (8 / wm) - 1) / (32 * (8 / wm)) > 65535) return false;
  if ((P + 32LL * wm - 1) / (32 * wm) > 0x7fffffffLL) return false;
  return smem == (wm == 4 ? Tile<T, 4>::kSmem : Tile<T, 8>::kSmem);
}

// Launch the product and, unless the epilogue fuses it, the pixel pass;
// returns a cudaError_t. `pre` is the scratch [splits, out pixels, Cout]
// (unused, and may be null, when the epilogue is fused, or when there is
// one split and the residual `pre_out` is asked for: the product then
// writes the residual itself).
template <typename T, int WM, bool DECONV>
int launch_gemm(Gemm q, int phases, int smem, cudaStream_t stream) {
  const auto kernel = q.pre_out != nullptr ? conv_gemm_kernel<T, WM, DECONV, true>
                                           : conv_gemm_kernel<T, WM, DECONV, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kBM = Tile<T, WM>::kBM, kBN = Tile<T, WM>::kBN;
  const dim3 grid((q.P + kBM - 1) / kBM, (q.Cout + kBN - 1) / kBN, phases * q.splits);
  kernel<<<grid, kThreads, smem, stream>>>(q);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool DECONV>
int launch(const void* x, const void* w, const float* scale, const float* offset, float* pre, void* y,
           float* pre_out, int N, int H, int W, int Cin, int Cout, int wm, int splits, int k_per_split,
           int stages, int smem, float eps, cudaStream_t stream) {
  const int phases = DECONV ? 4 : 1;
  Gemm q;
  q.x = x;
  q.w = w;
  q.N = N; q.H = H; q.W = W; q.Cin = Cin; q.Cout = Cout;
  q.P = DECONV ? N * H * W : N * (H / 2) * (W / 2);
  q.K = (DECONV ? 4 : 16) * Cin;
  q.splits = splits;
  q.k_per_split = k_per_split;
  if (!check_plan<T>(q.P, q.K, Cout, phases, wm, splits, k_per_split, stages, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long out_pixels = (long long)phases * q.P;
  // one split and the whole Cout in a block: LayerNorm -> SiLU in the epilogue
  q.fuse = splits == 1 && Cout <= 32 * (8 / wm);
  const bool direct = splits == 1 && pre_out != nullptr;  // the product writes the residual
  if (!q.fuse && !direct && pre == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  q.out = direct ? pre_out : pre;
  q.split_stride = out_pixels * Cout;
  q.y = y;
  q.pre_out = pre_out;
  q.scale = scale;
  q.offset = offset;
  q.eps = eps;
  q.a_vec = copy_mode<T>(x, Cin) == kCopy16;
  q.b_vec = copy_mode<T>(w, Cout) == kCopy16;
  const int err = wm == 4 ? launch_gemm<T, 4, DECONV>(q, phases, smem, stream)
                          : launch_gemm<T, 8, DECONV>(q, phases, smem, stream);
  if (err != 0 || q.fuse) return err;
  const int warps_per_block = kThreads / 32;
  ln_silu_kernel<T><<<static_cast<unsigned>((out_pixels + warps_per_block - 1) / warps_per_block), kThreads, 0,
                       stream>>>(
      q.out, scale, offset, static_cast<T*>(y), direct ? nullptr : pre_out, static_cast<int>(out_pixels), Cout,
      splits, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace conv_common
