// Tensor-core tile machinery shared by the GEMM-shaped kernels (ffn_mega.cu, conv_gelu.cu):
// cp.async copies, ldmatrix, mma.sync m16n8k16 bf16 with float32 accumulators, a block
// tiling of 8 warps, one warp's k-tile of products (bf16 on the tensor cores; float32 as
// FMAs that fill the same accumulator layout, so epilogues are shared), and a tile copy
// into padded shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace w2v {

constexpr int kTileThreads = 256;               // 8 warps

// ---- copies and tensor-core primitives ------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;               // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- tiling ---------------------------------------------------------------------------

// A block tile of BM x BN outputs over k steps of BK, 8 warps of WM x WN. A is [rows, K]
// row-major; B is [N, K] (kBKN false: nn.Linear's [out, in], the mma "col" operand) or
// [K, N] (kBKN true: loaded transposed). Shared-memory rows are padded by 16 bytes so the
// eight 16-byte rows of every ldmatrix (and the FMA path's column reads) hit distinct banks.
template <typename T, int BM_, int BN_, int BK_, int WM_, int WN_, bool kBKN_, int STAGES_>
struct Tiling {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_, STAGES = STAGES_;
  static constexpr bool kBKN = kBKN_;
  static constexpr int PAD = 16 / static_cast<int>(sizeof(T));
  static constexpr int SA = BK + PAD;
  static constexpr int SB = (kBKN ? BN : BK) + PAD;
  static constexpr int A_ELEMS = BM * SA;
  static constexpr int B_ELEMS = (kBKN ? BK : BN) * SB;
  static constexpr int STAGE = A_ELEMS + B_ELEMS;
  static constexpr int SMEM = STAGES * STAGE * static_cast<int>(sizeof(T));
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr int WARPS_N = BN / WN;
  static_assert((BM / WM) * (BN / WN) == kTileThreads / 32, "8 warps per block");
  static_assert(NT % 2 == 0 && BK % 16 == 0, "mma tiles");
};

// R x C elements from src (leading dimension ld) at (r0, c0) into smem (row stride S);
// rows at or past `rows` and columns at or past `cols` (a multiple of 16 bytes) are
// zero-filled.
template <typename T, int R, int C, int S>
__device__ __forceinline__ void load_tile(T* smem, const T* __restrict__ src, int ld, int r0,
                                          int rows, int c0, int cols = INT_MAX) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  constexpr int PER_ROW = C / E;
  constexpr int CHUNKS = R * PER_ROW;
#pragma unroll
  for (int i0 = 0; i0 < CHUNKS; i0 += kTileThreads) {
    const int i = i0 + static_cast<int>(threadIdx.x);
    if (CHUNKS % kTileThreads == 0 || i < CHUNKS) {
      const int r = i / PER_ROW, c = (i % PER_ROW) * E;
      const bool ok = r0 + r < rows && c0 + c < cols;
      cp_async16(smem + r * S + c, ok ? src + static_cast<size_t>(r0 + r) * ld + c0 + c : src, ok);
    }
  }
}

// One k-tile of the warp's MT x NT mma tiles, tensor cores (bf16).
template <class G>
__device__ __forceinline__ void warp_tile(float (&acc)[G::MT][G::NT][4],
                                          const __nv_bfloat16* As, const __nv_bfloat16* Bs,
                                          int wm0, int wn0, int lane) {
#pragma unroll
  for (int kk = 0; kk < G::BK; kk += 16) {
    uint32_t a[G::MT][4];
#pragma unroll
    for (int i = 0; i < G::MT; ++i)
      ldmatrix_x4(a[i], As + (wm0 + i * 16 + (lane & 15)) * G::SA + kk + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < G::NT; j += 2) {
      uint32_t b[4];
      if (G::kBKN)
        ldmatrix_x4_trans(b, Bs + (kk + (lane & 15)) * G::SB + wn0 + j * 8 + (lane >> 4) * 8);
      else
        ldmatrix_x4(b, Bs + (wn0 + j * 8 + (lane & 7) + ((lane >> 4) << 3)) * G::SB + kk +
                           ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int i = 0; i < G::MT; ++i) {
        mma_bf16(acc[i][j], a[i], b[0], b[1]);
        mma_bf16(acc[i][j + 1], a[i], b[2], b[3]);
      }
    }
  }
}

// The same k-tile in float32 FMAs, each thread computing exactly the accumulator elements
// the mma layout gives it (rows g, g+8 of each m16 tile; columns 2t, 2t+1 of each n8 tile),
// so the epilogues are shared.
template <class G>
__device__ __forceinline__ void warp_tile(float (&acc)[G::MT][G::NT][4], const float* As,
                                          const float* Bs, int wm0, int wn0, int lane) {
  const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll 4
  for (int k = 0; k < G::BK; ++k) {
    float a[G::MT][2], b[G::NT][2];
#pragma unroll
    for (int i = 0; i < G::MT; ++i) {
      a[i][0] = As[(wm0 + i * 16 + g) * G::SA + k];
      a[i][1] = As[(wm0 + i * 16 + g + 8) * G::SA + k];
    }
#pragma unroll
    for (int j = 0; j < G::NT; ++j) {
      const int c = wn0 + j * 8 + t2;
      b[j][0] = G::kBKN ? Bs[k * G::SB + c] : Bs[c * G::SB + k];
      b[j][1] = G::kBKN ? Bs[k * G::SB + c + 1] : Bs[(c + 1) * G::SB + k];
    }
#pragma unroll
    for (int i = 0; i < G::MT; ++i)
#pragma unroll
      for (int j = 0; j < G::NT; ++j) {
        acc[i][j][0] = fmaf(a[i][0], b[j][0], acc[i][j][0]);
        acc[i][j][1] = fmaf(a[i][0], b[j][1], acc[i][j][1]);
        acc[i][j][2] = fmaf(a[i][1], b[j][0], acc[i][j][2]);
        acc[i][j][3] = fmaf(a[i][1], b[j][1], acc[i][j][3]);
      }
  }
}

}  // namespace w2v
