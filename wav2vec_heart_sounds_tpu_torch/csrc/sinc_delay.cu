// Time-varying windowed-sinc fractional delay (the beamformer's hot op) for NVIDIA Hopper
// (sm_90a): forward, and the two halves of its analytic gradient.
//
// Replaces the TPU kernel wav2vec_heart_sounds_tpu/ops/pallas/beamformer.py::sinc_delay
// (_forward_kernel, _grad_d_kernel and _grad_x_kernel through _call). For each row r of
// x [R, T] (one microphone of one window; every microphone of a batch in ONE launch) and
// its per-sample delays d [R, T], with half = K / 2, c_k = k - half, the Hamming taps w_k,
// and xpad the row reflect-padded by half on both sides:
//
//     u[t, k] = sinc(c_k - d[t]) w_k          s[t] = sum_k u[t, k]
//     y[t]    = sum_k u[t, k] xpad[t + k] / s[t]
//     dd[t]   = g[t] / s[t] * sum_k u'[t, k] (xpad[t + k] - y[t]),  u' = -sinc'(c_k - d) w_k
//     dxpad[p] = sum_k g[p - k] u[p - k, k] / s[p - k]       (p over the padded axis)
//
// sinc(0) = 1 and sinc'(z) = (cos(pi z) - sinc(z)) / z with sinc'(z) = 0 for |z| < 1e-6, as
// _sinc_grad (beamformer.py:42-45). The caller folds dxpad's pad entries back into the
// interior (beamformer.py:180-185). Inputs and outputs are float32.
//
// Two forms of the same weights. sin(pi (c_k - d)) = -(-1)^c_k sin(pi d) for integer c_k,
// so u[t, k] = sin(pi d) e_k with e_k = (-1)^(c_k + 1) w_k / (pi (c_k - d)), and the common
// factor sin(pi d) cancels in y. When the integer nearest d lies inside the taps
// (|rint(d)| <= K / 2, the near form) the kernel uses u, s and u' exactly as the TPU kernel
// (one sinpif and one cospif per sample, the sign alternating per tap), the weights float32
// products (sinpif against the plain version's reduced sin: ~2e-6 apart) summed in float64.
// Beyond (the far form: the beamformer clips delays to 0.01 fs = 41.25 samples at 4125 Hz,
// past the 20 taps of half a window) no tap holds the sinc peak: s = sin(pi d) sum_k e_k
// vanishes at every integer d, so u / s is 0 / 0 there and ill-conditioned near it. There
// the kernel uses the e form, the same function without the factor: weights e_k, normaliser
// sum_k e_k, derivative de_k / dd = e_k / (c_k - d); |c_k - d| >= 0.5, so nothing vanishes.
// The e_k still alternate in sign and their sum cancels (sum |e_k xpad| / |sum e_k| reaches
// ~290 on unit inputs), so the far weights (e_k, e_k w_k, e_k w_k / z) are float64, every
// sum (y's two, grad_d's four) is float64 in tap order, and each result is rounded to
// float32 once, with contraction forbidden (__dmul_rn, __dadd_rn): beyond the taps y and s
// equal the plain version's (ops/kernels/sinc_delay.py, the same operations) bit for bit.
//
// What bounds it on this card: instruction issue and the float64 pipe, not bytes. At the
// vest shapes (R = 96 rows of T = 8250) a pass moves 3-4 arrays of 3.2 MB (~4 us at 3.35
// TB/s), while every sample spends ~25 instructions a tap: beyond the taps 12 of them float64
// (a multiply for pi z, the reciprocal's special-function seed and FMAs, the weight, the step
// of z and the two sums; grad_d a division more), inside them a float32 quotient, a
// conversion and three float64 operations. chip_smoke.py counts them in the built SASS
// for the bound. The design:
//   * each block stages its samples (x as float64, with the K - 1 samples of halo; the
//     reflect padding done there, by index, so no padded copy exists in device memory; d, and
//     g / s where a pass needs it) and sorts them by form, far first (warp ballots and a
//     block prefix sum): a warp runs one form, where one thread per sample in sample order
//     ran both branches in nearly every warp of delays drawn independently per sample;
//   * the tap loop stays a loop, eight taps a trip (41 taps unrolled took 166-190 registers,
//     one block an SM), and steps its state, c as a float, its parity and the far form's
//     z = c - d (exact), so no tap converts an integer; the taps' float32 and float64 weights
//     sit in __constant__ memory (a broadcast: every thread reads the same tap at the same
//     time); sin(pi d) and cos(pi d) once per sample;
//   * beyond the taps e_k = RN(+-1 / RN(pi z)) is the correctly rounded reciprocal
//     __drcp_rn, negated for even c_k: the division's bits (round to nearest is symmetric)
//     for fewer float64 operations; inside them the float32 quotients are __fdividef (within
//     2 ulp of the IEEE quotient, far inside the 1e-5 bars there);
//   * the gradient over x first computes each staged sample's K weights once, in its form,
//     into shared memory, then gathers dxpad[p] = sum_k (g / s)[p - k] u[p - k, k] from
//     there in tap order, where the gather used to recompute u (a float64 division beyond the
//     taps) for every (p, k) with lanes of mixed forms.
// The taps a trip of the tap loop (W2V_SINC_UNROLL) and, for the count of each form's
// instructions in chip_smoke.py's bound, a build in which every sample takes one form
// (W2V_SINC_FORM) are fixed when the library is built; scripts/torch_kernel_check.py --k7
// builds this file again with other values. No tensor cores: nothing here is a matrix
// product.

#include <cuda_runtime.h>
#include <math.h>

#include <cstring>

// The build's configuration (the defaults are what the port runs).
#ifndef W2V_SINC_UNROLL
#define W2V_SINC_UNROLL 8       // taps a trip of the tap loop
#endif
#ifndef W2V_SINC_FORM
#define W2V_SINC_FORM 0         // 1 / 2: every sample near / far (a build whose SASS is counted)
#endif

namespace {

constexpr int kMaxTaps = 64;
constexpr int kThreads = 256;                  // forward / grad_d: one output sample a thread
constexpr int kWarps = kThreads / 32;
constexpr int kGxThreads = 256;                // grad_x: one staged sample a thread
constexpr int kUnroll = W2V_SINC_UNROLL;
constexpr float kPi = 3.14159265358979f;
constexpr double kPi64 = 3.141592653589793;

__constant__ float c_window[kMaxTaps];
__constant__ double c_window64[kMaxTaps];      // the same taps, exactly, in float64

__device__ __forceinline__ int reflect(int i, int n) {
  i = i < 0 ? -i : i;
  return i >= n ? 2 * (n - 1) - i : i;
}

// The e form (no tap within reach of the sinc peak): |rint(d)| > K / 2.
__device__ __forceinline__ bool far_form(float dt, int half) {
  return fabsf(rintf(dt)) > static_cast<float>(half);
}

// The form a branch takes for a sample of form `far` (a W2V_SINC_FORM build compiles one).
__device__ __forceinline__ bool takes_far(bool far) {
  return W2V_SINC_FORM ? W2V_SINC_FORM == 2 : far;
}

// The tap loop's state: c = k - half as a float (exact) and its parity, stepped per tap, so
// no tap converts an integer. sin(pi z) and cos(pi z) for z = c - d are -(-1)^c sin(pi d) and
// (-1)^c cos(pi d).
struct Tap {
  float c;
  bool odd;
  __device__ __forceinline__ explicit Tap(int half) : c(static_cast<float>(-half)), odd(half & 1) {}
  __device__ __forceinline__ void next() {
    c += 1.f;
    odd = !odd;
  }
  __device__ __forceinline__ float sin_shift(float sd) const { return odd ? sd : -sd; }
  __device__ __forceinline__ float cos_shift(float cd) const { return odd ? -cd : cd; }
  // Inside the taps, for z = c - d: sinc(z) (sd = sin(pi d)), and its d/dd, -sinc'(z) with
  // the |z| < 1e-6 branch.
  __device__ __forceinline__ float value(float z, float sd) const {
    return z == 0.f ? 1.f : quotient(sin_shift(sd), kPi * z);
  }
  __device__ __forceinline__ float slope(float z, float v, float cd) const {
    return fabsf(z) < 1e-6f ? 0.f : quotient(-(cos_shift(cd) - v), z);
  }
  static __device__ __forceinline__ float quotient(float a, float b) { return __fdividef(a, b); }
  // Beyond the taps, in float64, for z = c - d: e_c = (-1)^(c + 1) / (pi z), before the
  // window weight. z is exact (|d| >= K / 2 + 1/2 and d is a float32), and so is each step
  // z + 1 of it. RN(-1 / x) = -RN(1 / x): the correctly rounded reciprocal gives the
  // division's bits.
  __device__ __forceinline__ double far_value(double z) const {
    const double r = __drcp_rn(__dmul_rn(kPi64, z));
    return odd ? r : -r;
  }
};

// sum += a * b in float64, the product rounded first, as the plain version's two operations.
__device__ __forceinline__ double add_product(double sum, double a, double b) {
  return __dadd_rn(sum, __dmul_rn(a, b));
}

// The block's samples (sample i = threadIdx.x) as a job list: the far ones first and then the
// other valid ones, each group in sample order (warp ballots and a prefix over the block's
// warps). far_of[i] keeps each sample's form. Returns (far count, valid count).
template <int kBlockWarps>
__device__ int2 sort_by_form(bool far, bool valid, short* jobs, bool* far_of) {
  __shared__ int counts[2 * kBlockWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const bool f = valid && far;
  const unsigned far_bits = __ballot_sync(0xffffffffu, f);
  const unsigned near_bits = __ballot_sync(0xffffffffu, valid && !f);
  if (lane == 0) {
    counts[warp] = __popc(far_bits);
    counts[kBlockWarps + warp] = __popc(near_bits);
  }
  far_of[threadIdx.x] = f;
  __syncthreads();
  int n_far = 0, n_near = 0, far_base = 0, near_base = 0;
  for (int w = 0; w < kBlockWarps; ++w) {      // warps in sample order
    if (w == warp) {
      far_base = n_far;
      near_base = n_near;
    }
    n_far += counts[w];
    n_near += counts[kBlockWarps + w];
  }
  const short i = static_cast<short>(threadIdx.x);
  if (f) jobs[far_base + __popc(far_bits & below)] = i;
  else if (valid) jobs[n_far + near_base + __popc(near_bits & below)] = i;
  __syncthreads();
  return make_int2(n_far, n_far + n_near);
}

// The forward's sums of one sample (its delay dt, its staged x window at xs) in its form.
template <bool kFar>
__device__ __forceinline__ void fwd_sums(const double* xs, float dt, int K, double& acc,
                                         double& norm) {
  const int half = K / 2;
  double z = __dsub_rn(static_cast<double>(-half), static_cast<double>(dt));
  const float sd = kFar ? 0.f : sinpif(dt);
  acc = norm = 0.0;
  Tap tap(half);
#pragma unroll (kUnroll)
  for (int k = 0; k < K; ++k, tap.next()) {
    double u;
    if (kFar) {
      u = __dmul_rn(tap.far_value(z), c_window64[k]);
      z = __dadd_rn(z, 1.0);
    } else {
      u = static_cast<double>(tap.value(tap.c - dt, sd) * c_window[k]);
    }
    norm = __dadd_rn(norm, u);
    acc = add_product(acc, u, static_cast<double>(xs[k]));
  }
}

// grad_d's four sums of one sample in its form: acc, norm, moment, dnorm.
template <bool kFar>
__device__ __forceinline__ void grad_d_sums(const double* xs, float dt, int K, double (&sums)[4]) {
  const int half = K / 2;
  double z = __dsub_rn(static_cast<double>(-half), static_cast<double>(dt));
  float sd = 0.f, cd = 0.f;
  if (!kFar) sincospif(dt, &sd, &cd);
#pragma unroll
  for (int j = 0; j < 4; ++j) sums[j] = 0.0;
  Tap tap(half);
#pragma unroll (kUnroll)
  for (int k = 0; k < K; ++k, tap.next()) {
    const float w = c_window[k];
    double u, du;
    if (kFar) {
      const double e = tap.far_value(z);
      u = __dmul_rn(e, c_window64[k]);
      du = __dmul_rn(__ddiv_rn(e, z), c_window64[k]);
      z = __dadd_rn(z, 1.0);
    } else {
      const float zf = tap.c - dt;
      const float v = tap.value(zf, sd);
      u = static_cast<double>(v * w);
      du = static_cast<double>(tap.slope(zf, v, cd) * w);
    }
    const double xk = xs[k];
    sums[0] = add_product(sums[0], u, xk);         // acc
    sums[1] = __dadd_rn(sums[1], u);               // norm
    sums[2] = add_product(sums[2], du, xk);        // moment
    sums[3] = __dadd_rn(sums[3], du);              // dnorm
  }
}

// Stages the block's x tile with its halo (reflect padding by index) and its delays, and
// sorts its samples by form. Sample i of the block is t0 + i.
__device__ int2 stage_rows(const float* x, const float* d, size_t base, int t0, int T, int K,
                           double* xs, float* ds, short* jobs, bool* far_of) {
  const int half = K / 2;
  for (int i = threadIdx.x; i < kThreads + K - 1; i += kThreads) {
    const int p = t0 + i;                       // padded-axis position
    xs[i] = p < T + 2 * half ? static_cast<double>(x[base + reflect(p - half, T)]) : 0.0;
  }
  const int t = t0 + static_cast<int>(threadIdx.x);
  const bool valid = t < T;
  const float dt = valid ? d[base + t] : 0.f;
  ds[threadIdx.x] = dt;
  return sort_by_form<kWarps>(far_form(dt, half), valid, jobs, far_of);
}

// Thread j of the block takes job j of the sorted list: with the far samples first, every warp
// but the one at the far ones' end runs one form.
__global__ void __launch_bounds__(kThreads)
sinc_delay_fwd_kernel(const float* __restrict__ x, const float* __restrict__ d,
                      float* __restrict__ y, float* __restrict__ s, int T, int K) {
  __shared__ double xs[kThreads + kMaxTaps - 1];
  __shared__ float ds[kThreads];
  __shared__ short jobs[kThreads];
  __shared__ bool far_of[kThreads];
  const int t0 = blockIdx.x * kThreads;
  const size_t base = static_cast<size_t>(blockIdx.y) * T;
  const int2 n = stage_rows(x, d, base, t0, T, K, xs, ds, jobs, far_of);
  if (static_cast<int>(threadIdx.x) < n.y) {
    const int i = jobs[threadIdx.x];
    double acc, norm;
    if (takes_far(far_of[i])) fwd_sums<true>(xs + i, ds[i], K, acc, norm);
    else fwd_sums<false>(xs + i, ds[i], K, acc, norm);
    y[base + t0 + i] = __double2float_rn(__ddiv_rn(acc, norm));
    s[base + t0 + i] = __double2float_rn(norm);
  }
}

__global__ void __launch_bounds__(kThreads)
sinc_delay_grad_d_kernel(const float* __restrict__ x, const float* __restrict__ d,
                         const float* __restrict__ g, float* __restrict__ dd, int T, int K) {
  __shared__ double xs[kThreads + kMaxTaps - 1];
  __shared__ float ds[kThreads];
  __shared__ short jobs[kThreads];
  __shared__ bool far_of[kThreads];
  const int t0 = blockIdx.x * kThreads;
  const size_t base = static_cast<size_t>(blockIdx.y) * T;
  const int2 n = stage_rows(x, d, base, t0, T, K, xs, ds, jobs, far_of);
  if (static_cast<int>(threadIdx.x) < n.y) {
    const int i = jobs[threadIdx.x];
    double v[4];
    if (takes_far(far_of[i])) grad_d_sums<true>(xs + i, ds[i], K, v);
    else grad_d_sums<false>(xs + i, ds[i], K, v);
    const double acc = v[0], norm = v[1], moment = v[2], dnorm = v[3];
    const double yt = __ddiv_rn(acc, norm);
    dd[base + t0 + i] = __double2float_rn(__dmul_rn(
        __ddiv_rn(static_cast<double>(g[base + t0 + i]), norm),
        __dsub_rn(moment, __dmul_rn(yt, dnorm))));
  }
}

// The K weights u[t, k] (float32; beyond the taps rounded once from the float64 e form) of
// one staged sample into us[k].
template <bool kFar>
__device__ __forceinline__ void sample_weights(float dt, int K, float* us) {
  const int half = K / 2;
  double z = __dsub_rn(static_cast<double>(-half), static_cast<double>(dt));
  const float sd = kFar ? 0.f : sinpif(dt);
  Tap tap(half);
#pragma unroll (kUnroll)
  for (int k = 0; k < K; ++k, tap.next()) {
    if (kFar) {
      us[k] = __double2float_rn(__dmul_rn(tap.far_value(z), c_window64[k]));
      z = __dadd_rn(z, 1.0);
    } else {
      us[k] = tap.value(tap.c - dt, sd) * c_window[k];
    }
  }
}

// dxpad over the padded axis P = T + K - 1: sample t = p - k feeds position p through tap
// k. The block stages kGxThreads samples t0 .. t0 + kGxThreads - 1, t0 = p0 - (K - 1), one a
// thread (d and g / s; zero outside [0, T), so those terms vanish), computes each one's K
// weights, sorted by form, into shared memory (dynamic: kGxThreads K floats), then gathers
// the kGxThreads - (K - 1) outputs p0 .. from them in tap order. s is the forward's
// normaliser of the same form.
__global__ void __launch_bounds__(kGxThreads)
sinc_delay_grad_x_kernel(const float* __restrict__ d, const float* __restrict__ g,
                         const float* __restrict__ s, float* __restrict__ dxpad, int T, int K) {
  extern __shared__ float us[];                 // [kGxThreads, K]
  __shared__ float ds[kGxThreads], gs[kGxThreads];
  __shared__ short jobs[kGxThreads];
  __shared__ bool far_of[kGxThreads];
  const int half = K / 2;
  const int P = T + K - 1, outs = kGxThreads - (K - 1);
  const int p0 = blockIdx.x * outs, t0 = p0 - (K - 1);
  const size_t base = static_cast<size_t>(blockIdx.y) * T;
  const int t = t0 + threadIdx.x;
  const bool ok = t >= 0 && t < T;
  const float dt = ok ? d[base + t] : 0.f;
  ds[threadIdx.x] = dt;
  gs[threadIdx.x] = ok ? g[base + t] / s[base + t] : 0.f;
  // outside [0, T): d = 0 (finite weights) and g = 0
  sort_by_form<kGxThreads / 32>(far_form(dt, half), true, jobs, far_of);
  const int i = jobs[threadIdx.x];
  if (takes_far(far_of[i])) sample_weights<true>(ds[i], K, us + i * K);
  else sample_weights<false>(ds[i], K, us + i * K);
  __syncthreads();
  const int o = threadIdx.x;
  if (o < outs && p0 + o < P) {
    float acc = 0.f;
    for (int k = 0; k < K; ++k) {
      const int j = o + (K - 1) - k;            // staged index of t = p - k
      acc = fmaf(gs[j], us[j * K + k], acc);
    }
    dxpad[static_cast<size_t>(blockIdx.y) * P + p0 + o] = acc;
  }
}

// Copies the taps (float32 and their float64 values) to __constant__ memory when they differ
// from the ones already there (a copy from pageable host memory waits for the stream, so it
// is done once, not per launch).
int set_window(const float* window, int K, cudaStream_t stream) {
  static float loaded[kMaxTaps];
  static int loaded_k = 0, loaded_device = -1;
  int device = 0;
  if (cudaError_t err = cudaGetDevice(&device)) return static_cast<int>(err);
  if (device == loaded_device && K == loaded_k &&
      memcmp(loaded, window, K * sizeof(float)) == 0)
    return 0;
  static double wide[kMaxTaps];
  for (int k = 0; k < K; ++k) wide[k] = static_cast<double>(window[k]);
  if (cudaError_t err = cudaMemcpyToSymbolAsync(c_window, window, K * sizeof(float), 0,
                                                cudaMemcpyHostToDevice, stream))
    return static_cast<int>(err);
  if (cudaError_t err = cudaMemcpyToSymbolAsync(c_window64, wide, K * sizeof(double), 0,
                                                cudaMemcpyHostToDevice, stream))
    return static_cast<int>(err);
  memcpy(loaded, window, K * sizeof(float));
  loaded_k = K;
  loaded_device = device;
  return 0;
}

bool bad_shape(int rows, int T, int K) {
  return rows <= 0 || rows > 65535 || K < 1 || K > kMaxTaps || K % 2 == 0 || T <= K / 2;
}

}  // namespace

// C entry points, bound with ctypes. x, d, g, s, y, dd are float32 [rows, T]; dxpad is
// float32 [rows, T + K - 1]; window is a HOST pointer to the K float32 taps (copied to
// __constant__ memory when they change). K is odd and at most 64; T > K / 2
// (reflect padding). Each returns the cudaError_t of its copy and launch (0 = launched).
extern "C" int sinc_delay_fwd(const void* x, const void* d, void* y, void* s, int rows, int T,
                              const float* window, int K, void* stream) {
  if (bad_shape(rows, T, K)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int err = set_window(window, K, st)) return err;
  sinc_delay_fwd_kernel<<<dim3((T + kThreads - 1) / kThreads, rows), kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(d), static_cast<float*>(y),
      static_cast<float*>(s), T, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sinc_delay_grad_d(const void* x, const void* d, const void* g, void* dd,
                                 int rows, int T, const float* window, int K, void* stream) {
  if (bad_shape(rows, T, K)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int err = set_window(window, K, st)) return err;
  sinc_delay_grad_d_kernel<<<dim3((T + kThreads - 1) / kThreads, rows), kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(d), static_cast<const float*>(g),
      static_cast<float*>(dd), T, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sinc_delay_grad_x(const void* d, const void* g, const void* s, void* dxpad,
                                 int rows, int T, const float* window, int K, void* stream) {
  if (bad_shape(rows, T, K)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int err = set_window(window, K, st)) return err;
  const int P = T + K - 1, outs = kGxThreads - (K - 1);
  const int bytes = kGxThreads * K * static_cast<int>(sizeof(float));
  // Above 48 KB at K > 47: opted into at every call, for the largest K (the attribute is the
  // current device's).
  if (cudaError_t err = cudaFuncSetAttribute(
          sinc_delay_grad_x_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kGxThreads * kMaxTaps * static_cast<int>(sizeof(float))))
    return static_cast<int>(err);
  sinc_delay_grad_x_kernel<<<dim3((P + outs - 1) / outs, rows), kGxThreads, bytes, st>>>(
      static_cast<const float*>(d), static_cast<const float*>(g), static_cast<const float*>(s),
      static_cast<float*>(dxpad), T, K);
  return static_cast<int>(cudaGetLastError());
}
