// Residual tail LayerNorm(x + dropout(h)) for NVIDIA Hopper (sm_90a): forward and backward.
//
// Replaces the TPU kernel wav2vec_heart_sounds_tpu/ops/pallas/resid.py::
// dropout_add_layernorm (K2), which ends the attention sublayer of every encoder layer (and
// the FFN sublayer on the decomposed FFN route). The kernels and their contract live in
// resid.cuh, shared with the FFN-sublayer backward (ffn_mega.cu). The mask is
// Philox4x32-10 over the row-major element index (philox.cuh), the same in both passes and
// in the plain version.
//
// What bounds it on this card: bytes (forward reads h, x and writes out, s; backward reads
// g, s and writes dh, dx: 4 x 29 MB per pass at [96*199, 768] bf16, ~35 us at HBM speed).

#include "resid.cuh"

using w2v::kResidThreads;

// C entry points, bound with ctypes. dtype: 0 = float32, 1 = bfloat16; gamma, beta and the
// partials are float32. `blocks` is the grid (the partials have `blocks` rows). Each
// returns the cudaError_t of its launch (0 = launched).
extern "C" int resid_fwd(const void* h, const void* x, const void* gamma, const void* beta,
                         void* out, void* s, int rows, int cols, float eps, uint32_t seed,
                         uint32_t site, uint32_t thr, float scale, int blocks, int dtype,
                         void* stream) {
  if (w2v::resid_bad_shape(rows, cols, blocks)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  switch (dtype) {
    case 0:
      w2v::resid_fwd_kernel<float><<<blocks, kResidThreads, 0, st>>>(
          static_cast<const float*>(h), static_cast<const float*>(x), ga, be,
          static_cast<float*>(out), static_cast<float*>(s), rows, cols, eps, seed, site, thr,
          scale);
      break;
    case 1:
      w2v::resid_fwd_kernel<__nv_bfloat16><<<blocks, kResidThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(x), ga, be,
          static_cast<__nv_bfloat16*>(out), static_cast<__nv_bfloat16*>(s), rows, cols, eps,
          seed, site, thr, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int resid_bwd(const void* g, const void* s, const void* gamma, void* dh, void* dx,
                         void* dgamma_part, void* dbeta_part, int rows, int cols, float eps,
                         uint32_t seed, uint32_t site, uint32_t thr, float scale, int blocks,
                         int dtype, void* stream) {
  if (w2v::resid_bad_shape(rows, cols, blocks)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ga = static_cast<const float*>(gamma);
  float* dgp = static_cast<float*>(dgamma_part);
  float* dbp = static_cast<float*>(dbeta_part);
  switch (dtype) {
    case 0:
      w2v::resid_bwd_kernel<float, false><<<blocks, kResidThreads, 0, st>>>(
          static_cast<const float*>(g), static_cast<const float*>(s), ga,
          static_cast<float*>(dh), static_cast<float*>(dx), dgp, dbp, nullptr, rows, cols, eps,
          seed, site, thr, scale);
      break;
    case 1:
      w2v::resid_bwd_kernel<__nv_bfloat16, false><<<blocks, kResidThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(s), ga,
          static_cast<__nv_bfloat16*>(dh), static_cast<__nv_bfloat16*>(dx), dgp, dbp, nullptr,
          rows, cols, eps, seed, site, thr, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
