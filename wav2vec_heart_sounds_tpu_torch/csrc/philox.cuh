// Philox4x32-10 dropout bits, shared by every training kernel of the port.
//
// The same function as wav2vec_heart_sounds_tpu_torch/ops/philox.py (the plain version,
// held to Random123's known-answer vector by the CPU tests): key (seed, site), counter
// (g mod 2^32, g div 2^32, 0, 0) with g = index >> 2, and element `index` takes word
// index & 3. `index` is the element's row-major position in the real tensor, so a kernel's
// tiling never changes the mask, the plain version gives the same bits, and a backward
// regenerates its forward's mask. keep = bits >= threshold, threshold = uint32(rate *
// (2^32 - 1)); threshold 0 keeps everything (rate 0).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace w2v {

__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1, uint32_t c2,
                                               uint32_t c3, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// The bits of elements 4g .. 4g+3.
__device__ __forceinline__ uint4 philox_group(uint32_t seed, uint32_t site,
                                              unsigned long long g) {
  return philox4x32_10(static_cast<uint32_t>(g), static_cast<uint32_t>(g >> 32), 0u, 0u,
                       seed, site);
}

// The keep mask of N consecutive elements base .. base + N - 1 (N a multiple of 4, at most
// 32): bit i is philox_bits(seed, site, base + i) >= thr. One Philox call per group the run
// touches: N / 4 of them when base is a multiple of 4, N / 4 + 1 otherwise, so a lane that
// owns a run pays one call per four elements (plus one for the misaligned end) where
// philox_bits pays one per element. A kernel whose fragments hold scattered elements lets
// each lane draw one run and hands the bits to their owners with warp shuffles.
template <int N>
__device__ __forceinline__ uint32_t philox_keep_run(uint32_t seed, uint32_t site,
                                                    unsigned long long base, uint32_t thr) {
  static_assert(N % 4 == 0 && N > 0 && N <= 32, "runs of 4 .. 32 elements");
  const unsigned long long g0 = base >> 2;
  const int a = static_cast<int>(base & 3);     // position of base within its group
  uint32_t mask = 0;
#pragma unroll
  for (int s = 0; s <= N / 4; ++s) {
    if (s == N / 4 && a == 0) break;            // an aligned run ends on a group boundary
    const uint4 w = philox_group(seed, site, g0 + s);
    const uint32_t keep = static_cast<uint32_t>(w.x >= thr) |
                          static_cast<uint32_t>(w.y >= thr) << 1 |
                          static_cast<uint32_t>(w.z >= thr) << 2 |
                          static_cast<uint32_t>(w.w >= thr) << 3;
    // word i of group s is element 4 s + i - a of the run
    mask |= s == 0 ? keep >> a : keep << (4 * s - a);
  }
  return N == 32 ? mask : mask & ((1u << N) - 1u);
}

// philox_keep_run for a `base` that is a multiple of 4 (a run that starts on a group): N / 4
// calls and no shifts that depend on `base`.
template <int N>
__device__ __forceinline__ uint32_t philox_keep_aligned(uint32_t seed, uint32_t site,
                                                        unsigned long long base, uint32_t thr) {
  static_assert(N % 4 == 0 && N > 0 && N <= 32, "runs of 4 .. 32 elements");
  uint32_t mask = 0;
#pragma unroll
  for (int s = 0; s < N / 4; ++s) {
    const uint4 w = philox_group(seed, site, (base >> 2) + s);
    mask |= (static_cast<uint32_t>(w.x >= thr) | static_cast<uint32_t>(w.y >= thr) << 1 |
             static_cast<uint32_t>(w.z >= thr) << 2 | static_cast<uint32_t>(w.w >= thr) << 3)
            << (4 * s);
  }
  return mask;
}

// The bits of one element.
__device__ __forceinline__ uint32_t philox_bits(uint32_t seed, uint32_t site,
                                                unsigned long long index) {
  const uint4 w = philox_group(seed, site, index >> 2);
  switch (index & 3) {
    case 0: return w.x;
    case 1: return w.y;
    case 2: return w.z;
    default: return w.w;
  }
}

}  // namespace w2v
