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
// The design (resid.cuh): a persistent grid, 16-byte accesses per lane, the backward's rows
// streamed by 1D bulk copies through a ring in shared memory, one partial row per block in
// the backward.

#include "resid.cuh"

namespace {

using bf16 = __nv_bfloat16;

// f(T{}) for the dtype code (0 = float32, 1 = bfloat16); nothing for another code.
template <class F>
void on_dtype(int dtype, F&& f) {
  if (dtype == 0) f(float{});
  if (dtype == 1) f(bf16{});
}

}  // namespace

// C entry points, bound with ctypes. dtype: 0 = float32, 1 = bfloat16; gamma, beta and the
// partials are float32. cols is a whole number of 16-byte runs (a multiple of 8 in bfloat16,
// of 4 in float32), at most 1024, or 1280. `blocks` is the grid (the backward's partials have
// `blocks` rows), from resid_blocks for the same rows, cols, dtype and pass. Every [rows, cols]
// pointer is 16-byte aligned (the bulk copies and 16-byte accesses). Each returns the
// cudaError_t of its launch (0 = launched).

// The persistent grid for `sms` SMs (negative on error). backward: 0 the forward, 1 the
// backward, 2 the pre-norm backward.
extern "C" int resid_blocks(int rows, int cols, int sms, int dtype, int backward) {
  if (sms <= 0) return -1;
  int blocks = -1;
  on_dtype(dtype, [&](auto t) {
    using T = decltype(t);
    if (w2v::resid_bad_shape<T>(rows, cols, 1)) return;
    blocks = backward == 2 ? w2v::ResidBwd<T, false, true>::grid(rows, cols, sms)
             : backward    ? w2v::ResidBwd<T, false>::grid(rows, cols, sms)
                           : w2v::ResidFwd<T>::grid(rows, cols, sms);
  });
  return blocks;
}

extern "C" int resid_fwd(const void* h, const void* x, const void* gamma, const void* beta,
                         void* out, void* s, int rows, int cols, float eps, uint32_t seed,
                         uint32_t site, uint32_t thr, float scale, int blocks, int dtype,
                         void* stream) {
  cudaError_t err = cudaErrorInvalidValue;
  on_dtype(dtype, [&](auto t) {
    using T = decltype(t);
    if (w2v::resid_bad_shape<T>(rows, cols, blocks)) return;
    err = w2v::ResidFwd<T>::launch(
        cols, blocks, static_cast<cudaStream_t>(stream), static_cast<const T*>(h),
        static_cast<const T*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<T*>(out), static_cast<T*>(s), rows, cols,
        eps, seed, site, thr, scale);
  });
  return static_cast<int>(err);
}

extern "C" int resid_bwd(const void* g, const void* s, const void* gamma, void* dh, void* dx,
                         void* dgamma_part, void* dbeta_part, int rows, int cols, float eps,
                         uint32_t seed, uint32_t site, uint32_t thr, float scale, int blocks,
                         int dtype, void* stream) {
  cudaError_t err = cudaErrorInvalidValue;
  on_dtype(dtype, [&](auto t) {
    using T = decltype(t);
    if (w2v::resid_bad_shape<T>(rows, cols, blocks)) return;
    err = w2v::ResidBwd<T, false>::launch(
        cols, blocks, static_cast<cudaStream_t>(stream), static_cast<const T*>(g),
        static_cast<const T*>(s), static_cast<const float*>(gamma), static_cast<T*>(dh),
        static_cast<T*>(dx), static_cast<float*>(dgamma_part), static_cast<float*>(dbeta_part),
        static_cast<float*>(nullptr), rows, cols, eps, seed, site, thr, scale,
        static_cast<const T*>(nullptr));
  });
  return static_cast<int>(err);
}

// The pre-norm backward: g is the gradient of out (the next sublayer's input), gs that of s
// (the residual stream); ds = the LayerNorm's gradient + gs, dx = ds, dh = keep ? ds * scale
// : 0. `blocks` from resid_blocks(..., backward = 2).
extern "C" int resid_prenorm_bwd(const void* g, const void* gs, const void* s, const void* gamma,
                                 void* dh, void* dx, void* dgamma_part, void* dbeta_part,
                                 int rows, int cols, float eps, uint32_t seed, uint32_t site,
                                 uint32_t thr, float scale, int blocks, int dtype, void* stream) {
  cudaError_t err = cudaErrorInvalidValue;
  on_dtype(dtype, [&](auto t) {
    using T = decltype(t);
    if (w2v::resid_bad_shape<T>(rows, cols, blocks)) return;
    err = w2v::ResidBwd<T, false, true>::launch(
        cols, blocks, static_cast<cudaStream_t>(stream), static_cast<const T*>(g),
        static_cast<const T*>(s), static_cast<const float*>(gamma), static_cast<T*>(dh),
        static_cast<T*>(dx), static_cast<float*>(dgamma_part), static_cast<float*>(dbeta_part),
        static_cast<float*>(nullptr), rows, cols, eps, seed, site, thr, scale,
        static_cast<const T*>(gs));
  });
  return static_cast<int>(err);
}
