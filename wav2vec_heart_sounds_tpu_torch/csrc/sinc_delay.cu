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
// interior (beamformer.py:180-185). Everything is float32.
//
// Two forms of the same weights. sin(pi (c_k - d)) = -(-1)^c_k sin(pi d) for integer c_k,
// so u[t, k] = sin(pi d) e_k with e_k = (-1)^(c_k + 1) w_k / (pi (c_k - d)), and the common
// factor sin(pi d) cancels in y. When the integer nearest d lies inside the taps
// (|rint(d)| <= K / 2) the kernel uses u, s and u' exactly as the TPU kernel (one sinpif and
// one cospif per sample, the sign alternating per tap). Beyond (the beamformer clips delays
// to 0.01 fs = 41.25 samples at 4125 Hz, past the 20 taps of half a window) no tap holds the
// sinc peak: s = sin(pi d) sum_k e_k vanishes at every integer d, so u / s is 0 / 0 there and
// ill-conditioned near it (float32 against float64: up to 7 in y for d in [20.5, 41.25]).
// There the kernel uses the e form, the same function without the factor: weights e_k,
// normaliser sum_k e_k, derivative de_k / dd = e_k / (c_k - d); |c_k - d| >= 0.5, so nothing
// vanishes. The e_k still alternate in sign and their sum cancels (sum |e_k xpad| /
// |sum e_k| reaches ~290 on unit inputs), so float32 weights and sums leave y ~7e-4 from
// its float64 value there, and the order of the operations decides the last bits. So the
// e-form weights (e_k, e_k w_k, e_k w_k / z) are float64, every sum (y's two, grad_d's four)
// is float64 in tap order, and each result is rounded to float32 once, with contraction
// forbidden (__dmul_rn, __dadd_rn): beyond the taps y and s equal the plain version's
// (ops/kernels/sinc_delay.py, the same operations) bit for bit. Inside the taps the weights
// stay float32 products (sinpif against the plain version's reduced sin: ~2e-6 apart).
//
// What bounds it on this card: at the vest shapes (R = 96 rows of T = 8250) a pass moves
// 3-4 arrays of 3.2 MB (a few microseconds at 3.35 TB/s) and computes 41 taps per sample:
// a division and a few FMAs each (float64 beyond the taps), no per-tap sine. The design:
//   * one thread per output sample, 256 per block, grid (sample tiles, rows);
//   * each block stages its x tile plus the K - 1 samples of halo in shared memory (the
//     reflect padding is done there, by index, so no padded copy exists in device memory);
//     the gradient over x stages d, sin(pi d) and g / s over its tile and halo instead;
//   * the K window taps live in __constant__ memory (every thread reads the same tap at
//     the same time: a broadcast).
// No tensor cores: nothing here is a matrix product.

#include <cuda_runtime.h>
#include <math.h>

#include <cstring>

namespace {

constexpr int kMaxTaps = 64;
constexpr int kThreads = 256;                  // output samples per block
constexpr int kTile = kThreads + kMaxTaps - 1; // staged samples: the tile and its halo
constexpr float kPi = 3.14159265358979f;
constexpr double kPi64 = 3.141592653589793;

__constant__ float c_window[kMaxTaps];

__device__ __forceinline__ int reflect(int i, int n) {
  i = i < 0 ? -i : i;
  return i >= n ? 2 * (n - 1) - i : i;
}

// sin(pi z) and cos(pi z) for z = c - d, c an integer: -(-1)^c sin(pi d), (-1)^c cos(pi d).
__device__ __forceinline__ float sin_shift(int c, float sd) { return (c & 1) ? sd : -sd; }
__device__ __forceinline__ float cos_shift(int c, float cd) { return (c & 1) ? -cd : cd; }

// The e form (no tap within reach of the sinc peak): |rint(d)| > K / 2.
__device__ __forceinline__ bool far_form(float dt, int half) {
  return fabsf(rintf(dt)) > static_cast<float>(half);
}

// A tap's value before its window weight inside the taps, for z = c - d: sinc(z)
// (sd = sin(pi d)), and its d/dd, -sinc'(z) with the |z| < 1e-6 branch.
__device__ __forceinline__ float tap(int c, float z, float sd) {
  return z == 0.f ? 1.f : sin_shift(c, sd) / (kPi * z);
}

__device__ __forceinline__ float dtap(int c, float z, float v, float cd) {
  return fabsf(z) < 1e-6f ? 0.f : -(cos_shift(c, cd) - v) / z;
}

// The e form beyond the taps, in float64: e_c = (-1)^(c + 1) / (pi (c - d)) (before the
// window weight), z = c - d exact.
__device__ __forceinline__ double far_z(int c, float dt) {
  return __dsub_rn(static_cast<double>(c), static_cast<double>(dt));
}
__device__ __forceinline__ double far_tap(int c, double z) {
  return __ddiv_rn((c & 1) ? 1.0 : -1.0, __dmul_rn(kPi64, z));
}

// The weighted tap u_k in float64: e_k w_k beyond the taps, else the float32 sinc(z) w_k.
__device__ __forceinline__ double weight(int c, float dt, float sd, float w, bool far) {
  if (far) return __dmul_rn(far_tap(c, far_z(c, dt)), static_cast<double>(w));
  return static_cast<double>(tap(c, static_cast<float>(c) - dt, sd) * w);
}

// sum += a * b in float64, the product rounded first, as the plain version's two operations.
__device__ __forceinline__ double add_product(double sum, double a, double b) {
  return __dadd_rn(sum, __dmul_rn(a, b));
}

__global__ void __launch_bounds__(kThreads)
sinc_delay_fwd_kernel(const float* __restrict__ x, const float* __restrict__ d,
                      float* __restrict__ y, float* __restrict__ s, int T, int K) {
  __shared__ float xs[kTile];
  const int half = K / 2;
  const int t0 = blockIdx.x * kThreads;
  const size_t base = static_cast<size_t>(blockIdx.y) * T;
  for (int i = threadIdx.x; i < kThreads + K - 1; i += kThreads) {
    const int p = t0 + i;                       // padded-axis position
    xs[i] = p < T + 2 * half ? x[base + reflect(p - half, T)] : 0.f;
  }
  __syncthreads();
  const int t = t0 + threadIdx.x;
  if (t >= T) return;
  const float dt = d[base + t];
  const float sd = sinpif(dt);
  const bool far = far_form(dt, half);
  double acc = 0.0, norm = 0.0;
  for (int k = 0; k < K; ++k) {
    const double u = weight(k - half, dt, sd, c_window[k], far);
    norm = __dadd_rn(norm, u);
    acc = add_product(acc, u, xs[threadIdx.x + k]);
  }
  y[base + t] = __double2float_rn(__ddiv_rn(acc, norm));
  s[base + t] = __double2float_rn(norm);
}

__global__ void __launch_bounds__(kThreads)
sinc_delay_grad_d_kernel(const float* __restrict__ x, const float* __restrict__ d,
                         const float* __restrict__ g, float* __restrict__ dd, int T, int K) {
  __shared__ float xs[kTile];
  const int half = K / 2;
  const int t0 = blockIdx.x * kThreads;
  const size_t base = static_cast<size_t>(blockIdx.y) * T;
  for (int i = threadIdx.x; i < kThreads + K - 1; i += kThreads) {
    const int p = t0 + i;
    xs[i] = p < T + 2 * half ? x[base + reflect(p - half, T)] : 0.f;
  }
  __syncthreads();
  const int t = t0 + threadIdx.x;
  if (t >= T) return;
  const float dt = d[base + t];
  const float sd = sinpif(dt), cd = cospif(dt);
  const bool far = far_form(dt, half);
  double acc = 0.0, norm = 0.0, moment = 0.0, dnorm = 0.0;
  for (int k = 0; k < K; ++k) {
    const int c = k - half;
    const float w = c_window[k];
    double u, du;
    if (far) {
      const double z = far_z(c, dt), e = far_tap(c, z);
      u = __dmul_rn(e, static_cast<double>(w));
      du = __dmul_rn(__ddiv_rn(e, z), static_cast<double>(w));
    } else {
      const float z = static_cast<float>(c) - dt;
      const float v = tap(c, z, sd);
      u = static_cast<double>(v * w);
      du = static_cast<double>(dtap(c, z, v, cd) * w);
    }
    const double xk = xs[threadIdx.x + k];
    acc = add_product(acc, u, xk);
    norm = __dadd_rn(norm, u);
    moment = add_product(moment, du, xk);
    dnorm = __dadd_rn(dnorm, du);
  }
  const double yt = __ddiv_rn(acc, norm);
  dd[base + t] = __double2float_rn(__dmul_rn(
      __ddiv_rn(static_cast<double>(g[base + t]), norm),
      __dsub_rn(moment, __dmul_rn(yt, dnorm))));
}

// dxpad over the padded axis P = T + K - 1: sample t = p - k feeds position p through tap
// k. The block stages d, sin(pi d) and g / s for t in [p0 - (K - 1), p0 + kThreads), zero
// outside [0, T) (g = 0 there, so those terms vanish); s is the forward's normaliser of
// the same form.
__global__ void __launch_bounds__(kThreads)
sinc_delay_grad_x_kernel(const float* __restrict__ d, const float* __restrict__ g,
                         const float* __restrict__ s, float* __restrict__ dxpad, int T, int K) {
  __shared__ float ds[kTile], sds[kTile], gs[kTile];
  const int half = K / 2;
  const int P = T + K - 1;
  const int p0 = blockIdx.x * kThreads;
  const size_t base = static_cast<size_t>(blockIdx.y) * T;
  for (int i = threadIdx.x; i < kThreads + K - 1; i += kThreads) {
    const int t = p0 - (K - 1) + i;
    const bool ok = t >= 0 && t < T;
    const float dt = ok ? d[base + t] : 0.f;
    ds[i] = dt;
    sds[i] = sinpif(dt);
    gs[i] = ok ? g[base + t] / s[base + t] : 0.f;
  }
  __syncthreads();
  const int p = p0 + threadIdx.x;
  if (p >= P) return;
  float acc = 0.f;
  for (int k = 0; k < K; ++k) {
    const int i = threadIdx.x + (K - 1) - k;    // staged index of t = p - k
    const int c = k - half;
    const float u = __double2float_rn(weight(c, ds[i], sds[i], c_window[k],
                                             far_form(ds[i], half)));
    acc = fmaf(gs[i], u, acc);
  }
  dxpad[static_cast<size_t>(blockIdx.y) * P + p] = acc;
}

// Copies the taps to __constant__ memory when they differ from the ones already there (a
// copy from pageable host memory waits for the stream, so it is done once, not per launch).
int set_window(const float* window, int K, cudaStream_t stream) {
  static float loaded[kMaxTaps];
  static int loaded_k = 0, loaded_device = -1;
  int device = 0;
  if (cudaError_t err = cudaGetDevice(&device)) return static_cast<int>(err);
  if (device == loaded_device && K == loaded_k &&
      memcmp(loaded, window, K * sizeof(float)) == 0)
    return 0;
  if (cudaError_t err = cudaMemcpyToSymbolAsync(c_window, window, K * sizeof(float), 0,
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
  const int P = T + K - 1;
  sinc_delay_grad_x_kernel<<<dim3((P + kThreads - 1) / kThreads, rows), kThreads, 0, st>>>(
      static_cast<const float*>(d), static_cast<const float*>(g), static_cast<const float*>(s),
      static_cast<float*>(dxpad), T, K);
  return static_cast<int>(cudaGetLastError());
}
