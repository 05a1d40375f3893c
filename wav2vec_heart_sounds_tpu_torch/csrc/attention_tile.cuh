// Tile machinery of the attention kernels (attention_qkv_fwd.cu, attention_qkv_bwd.cu).
//
// Every piece is templated on the head width D (on_head_dim: 16, 32, 64, 80 and 128;
// wav2vec2-base and -large take 64, XLS-R 1B 80, the test config 16). A block has 4 warps;
// each warp owns 16 rows of one side (queries, or keys in the dk/dv kernel) and walks 64-row
// tiles of the other side,
// staged as padded tiles in shared memory in the input dtype by cp.async. Score-shaped
// products leave each warp with its 16 x N block in the m16n8 accumulator layout of
// mma.sync: lane (g = lane >> 2, t = lane & 3) holds columns 8 n + 2 t and 8 n + 2 t + 1 of
// rows g and g + 8 in acc[n][0..1] and acc[n][2..3]. bfloat16 runs the products on the tensor
// cores (m16n8k16, float32 accumulators); float32 runs them as FMAs that fill the same layout
// (no TF32), so the softmax, the masks and the epilogues are one code for both dtypes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "gelu.cuh"       // to_float
#include "mma_tile.cuh"
#include "philox.cuh"

namespace w2v {
namespace attn {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16 * kWarps;      // rows a block owns
constexpr int kTile = 64;               // rows of a staged tile of the other side
constexpr unsigned kFull = 0xffffffffu;

// Blocks an SM for __launch_bounds__: bf16 kernels are held to 128 registers so four blocks
// (16 warps) share an SM and hide each other's latency; float32 kernels, whose shared
// memory allows two, keep their registers.
template <typename T>
constexpr int min_blocks() {
  return sizeof(T) == 2 ? 4 : 1;
}

// Element strides of a [B, H, T, d] view over (b, h, t); d is contiguous.
struct View {
  long long b, h, t;
};

// A padded tile: 64 rows of the head width D, each row 16 bytes longer than its data so the
// eight rows of an ldmatrix (and the FMA path's row reads) fall in distinct banks.
template <typename T, int D>
struct Tile {
  static_assert(D % 16 == 0 && D >= 16 && D <= 128, "head widths of whole k16 steps");
  static constexpr int S = D + 16 / static_cast<int>(sizeof(T));    // row stride, elements
  static constexpr int ELEMS = kTile * S;
};

// float32 products take their probability operand from shared memory: 16 rows of KT + 4.
template <typename T, int KT>
constexpr int p_buffer_floats() {
  return std::is_same<T, float>::value ? kWarps * 16 * (KT + 4) : 0;
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// Rows r0 .. r0 + 63 of a view (row stride ld elements) into a padded tile by cp.async,
// 16 bytes a chunk, every thread of the block; rows at or past `rows` are zero-filled and
// never read. The wrapper guarantees 16-byte aligned rows.
template <typename T, int D>
__device__ __forceinline__ void stage(T* tile, const T* __restrict__ src, long long ld, int r0,
                                      int rows) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  constexpr int PER_ROW = D / E;
  constexpr int CHUNKS = kTile * PER_ROW;
  static_assert(CHUNKS % kThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int i0 = 0; i0 < CHUNKS; i0 += kThreads) {
    const int i = i0 + static_cast<int>(threadIdx.x);
    const int r = i / PER_ROW, c = (i % PER_ROW) * E;
    const bool ok = r0 + r < rows;
    cp_async16(tile + r * Tile<T, D>::S + c, src + (ok ? (r0 + r) * ld : 0) + c, ok);
  }
}

// acc[n] += A B^T over the head width D: A the warp's 16 rows at As, B the 8 NT rows at Bs
// (both in padded tiles). B is the mma "col" operand, read by ldmatrix without transpose.
template <int NT, int D>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const __nv_bfloat16* As,
                                        const __nv_bfloat16* Bs, int lane) {
  constexpr int S = Tile<__nv_bfloat16, D>::S;
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, As + (lane & 15) * S + kk + (lane >> 4) * 8);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, Bs + (n * 8 + (lane & 7) + ((lane >> 4) << 3)) * S + kk +
                         ((lane >> 3) & 1) * 8);
      mma_bf16(acc[n], a, b[0], b[1]);
      mma_bf16(acc[n + 1], a, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int NT, int D>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const float* As, const float* Bs,
                                        int lane) {
  constexpr int S = Tile<float, D>::S;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll 2
  for (int k = 0; k < D; k += 4) {
    const float4 a0 = *reinterpret_cast<const float4*>(As + g * S + k);
    const float4 a1 = *reinterpret_cast<const float4*>(As + (g + 8) * S + k);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + (n * 8 + t2) * S + k);
      const float4 b1 = *reinterpret_cast<const float4*>(Bs + (n * 8 + t2 + 1) * S + k);
      acc[n][0] = dot4(a0, b0, acc[n][0]);
      acc[n][1] = dot4(a0, b1, acc[n][1]);
      acc[n][2] = dot4(a1, b0, acc[n][2]);
      acc[n][3] = dot4(a1, b1, acc[n][3]);
    }
  }
}

// acc[n] (the D / 8 n8 tiles of the head width) += P B: P the warp's 16 x KT block in the
// accumulator layout, B the KT rows at Bs (a padded tile, read transposed). bfloat16: P is
// rounded to bf16 in registers, where an m16n8 accumulator pair is already the m16n8k16 A
// fragment, so it never goes through shared memory. `pbuf` (the warp's 16 x (KT + 4)
// floats) is used by the float32 path only.
template <int KT, int D>
__device__ __forceinline__ void mma_pv(float (&acc)[D / 8][4], const float (&p)[KT / 8][4],
                                       const __nv_bfloat16* Bs, float* /*pbuf*/, int lane) {
  constexpr int S = Tile<__nv_bfloat16, D>::S;
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, Bs + (kk * 16 + (lane & 15)) * S + n * 8 + (lane >> 4) * 8);
      mma_bf16(acc[n], a, b[0], b[1]);
      mma_bf16(acc[n + 1], a, b[2], b[3]);
    }
  }
}

template <int KT, int D>
__device__ __forceinline__ void mma_pv(float (&acc)[D / 8][4], const float (&p)[KT / 8][4],
                                       const float* Bs, float* pbuf, int lane) {
  constexpr int S = Tile<float, D>::S, PS = KT + 4;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < KT / 8; ++n) {
    *reinterpret_cast<float2*>(pbuf + g * PS + n * 8 + t2) = make_float2(p[n][0], p[n][1]);
    *reinterpret_cast<float2*>(pbuf + (g + 8) * PS + n * 8 + t2) = make_float2(p[n][2], p[n][3]);
  }
  __syncwarp();
#pragma unroll 4
  for (int k = 0; k < KT; ++k) {
    const float pg = pbuf[g * PS + k], pg8 = pbuf[(g + 8) * PS + k];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float2 b = *reinterpret_cast<const float2*>(Bs + k * S + n * 8 + t2);
      acc[n][0] = fmaf(pg, b.x, acc[n][0]);
      acc[n][1] = fmaf(pg, b.y, acc[n][1]);
      acc[n][2] = fmaf(pg8, b.x, acc[n][2]);
      acc[n][3] = fmaf(pg8, b.y, acc[n][3]);
    }
  }
  __syncwarp();                                 // pbuf is free for the next product
}

// ---- dropout masks: one Philox run per lane, bits handed to their owners by shuffle ----
//
// The mask of element (row, column) sits at a Philox index; along one axis of the tile the
// indices are consecutive (keys, in the forward's and dq kernel's rows; also keys, down the
// dk/dv kernel's columns). Each lane draws one run of consecutive elements with
// philox_keep_run (one call per four elements, plus one when the run is misaligned, which
// T odd makes common), and the owners in the accumulator layout take their bits by shuffle.

// Rows consecutive along columns: the warp's 16 rows x 64 columns, `index0` the index of
// (row 0, column 0) and `row_step` the index distance of one row. Lane L draws row L >> 1,
// columns 32 (L & 1) .. + 31; 9 calls a lane for 32 elements.
__device__ __forceinline__ uint32_t draw_row_runs(uint32_t seed, uint32_t site, uint32_t thr,
                                                  unsigned long long index0,
                                                  unsigned long long row_step, int lane) {
  return philox_keep_run<32>(seed, site, index0 + (lane >> 1) * row_step + 32 * (lane & 1),
                             thr);
}

// The row runs of rows g and g + 8 over columns 32 h .. 32 h + 31: bit 8 n + 2 t + e is the
// keep of accumulator column 32 h + 8 n + 2 t + e.
__device__ __forceinline__ void row_keep(uint32_t runs, int lane, int h, uint32_t (&keep)[2]) {
  const int g = lane >> 2;
  keep[0] = __shfl_sync(kFull, runs, 2 * g + h);
  keep[1] = __shfl_sync(kFull, runs, 2 * (g + 8) + h);
}

// Columns consecutive along rows: the warp's 16 rows x 64 columns, `index0` the index of
// (row 0, column 0) and `col_step` the index distance of one column. Lane L draws columns
// L (low 16 bits) and L + 32 (high 16 bits), rows 0 .. 15; 10 calls a lane for 32 elements.
__device__ __forceinline__ uint32_t draw_col_runs(uint32_t seed, uint32_t site, uint32_t thr,
                                                  unsigned long long index0,
                                                  unsigned long long col_step, int lane) {
  const unsigned long long base = index0 + lane * col_step;
  return philox_keep_run<16>(seed, site, base, thr) |
         philox_keep_run<16>(seed, site, base + 32 * col_step, thr) << 16;
}

// The column run of accumulator column 32 h + c (c = 8 n + 2 t + e): bit r is the keep of
// row r.
__device__ __forceinline__ uint32_t col_keep(uint32_t runs, int c, int h) {
  return __shfl_sync(kFull, runs, c) >> (16 * h);
}

// f(std::integral_constant<int, D>{}) for a head width D the kernels are built for; false
// (and no call) for any other.
template <class F>
bool on_head_dim(int head_dim, F&& f) {
  switch (head_dim) {
    case 16: f(std::integral_constant<int, 16>{}); return true;
    case 32: f(std::integral_constant<int, 32>{}); return true;
    case 64: f(std::integral_constant<int, 64>{}); return true;
    case 80: f(std::integral_constant<int, 80>{}); return true;
    case 128: f(std::integral_constant<int, 128>{}); return true;
    default: return false;
  }
}

}  // namespace attn
}  // namespace w2v
