// LRN backward over NHWC rows of C contiguous channels, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel ops/lrn_pallas.py:_bwd_kernel.
// It takes x (the forward's only residual) and g = dL/dy, recomputes the
// normalizer, and writes dx. For every element e with channel c:
//   d_j = bias + a * sum_{k=j-r..j+r, 0<=k<C} x_k^2      (fp32)
//   p_j = d_j^-beta
//   t_j = g_j * x_j * (p_j / d_j)                       (= g x d^-(beta+1))
//   u_c = sum_{j=c-r..c+r, 0<=j<C} t_j
//   dx  = g_c * p_c - (2 a beta) * x_c * u_c           (stored in x's dtype)
// with d^-beta = rsqrt(d)*sqrt(rsqrt(d)) for beta=0.75, rsqrt(d) for 0.5,
// powf(d, -beta) otherwise, as in the forward kernel.
//
// Bound by device-memory bytes: x and g are read once and dx written once
// (6 bytes an element in bf16) against ~30 fp32 operations an element. The
// design extends the forward kernel's flat span with a halo: a block owns
// kTile consecutive elements and stages x over the span plus a 2r halo on
// each side in shared memory as fp32 (u_c needs t_j for j up to c +- r, and
// t_j needs x up to j +- r). Phase 1 forms t over the span plus r on each
// side, and g*p for the owned elements; phase 2 sums t over each clipped
// window. A window never leaves its row and rows are contiguous, so the flat
// span covers every window for any C; elements outside [0, n) stage as 0
// and are never inside a window.
//
// C interface (ctypes): dvggf_lrn_bwd returns cudaGetLastError() after the
// launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;  // elements per block (ops/lrn_cuda.py _TILE)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// mode 0: beta == 0.75, mode 1: beta == 0.5, mode 2: any other beta
__device__ __forceinline__ float pow_neg_beta(float d, float beta, int mode) {
  if (mode == 0) {
    const float inv = rsqrtf(d);
    return inv * sqrtf(inv);
  }
  if (mode == 1) return rsqrtf(d);
  return powf(d, -beta);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lrn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   T* __restrict__ dx, int64_t n, int channels, int radius,
                   float bias, float a, float beta, float coef, int mode) {
  // shared layout: xs[kTile + 4r] | ts[kTile + 2r] | gp[kTile]
  extern __shared__ float smem[];
  float* xs = smem;
  float* ts = xs + kTile + 4 * radius;
  float* gp = ts + kTile + 2 * radius;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kTile;

  // stage x over [start - 2r, start + kTile + 2r)
  const int xspan = kTile + 4 * radius;
  for (int i = threadIdx.x; i < xspan; i += kThreads) {
    const int64_t e = start - 2 * radius + i;
    xs[i] = (e >= 0 && e < n) ? to_f32(x[e]) : 0.0f;
  }
  __syncthreads();

  // phase 1: t over [start - r, start + kTile + r); g*p for owned elements
  const int64_t base = start - radius;
  const int cb = static_cast<int>(((base % channels) + channels) % channels);
  const int tspan = kTile + 2 * radius;
  for (int i = threadIdx.x; i < tspan; i += kThreads) {
    const int64_t e = base + i;
    if (e < 0 || e >= n) {
      ts[i] = 0.0f;
      continue;
    }
    const int c = (cb + i) % channels;
    const int lo = -min(c, radius);
    const int hi = min(channels - 1 - c, radius);
    const float* w = xs + radius + i;  // xs index of element e
    float s = 0.0f;
    for (int k = lo; k <= hi; ++k) s += w[k] * w[k];
    const float d = bias + a * s;
    const float p = pow_neg_beta(d, beta, mode);
    const float gf = to_f32(g[e]);
    ts[i] = gf * w[0] * (p / d);
    const int own = i - radius;
    if (own >= 0 && own < kTile) gp[own] = gf * p;
  }
  __syncthreads();

  // phase 2: dx = g*p - coef * x * (clipped window sum of t)
  const int c0 = static_cast<int>(start % channels);
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int64_t e = start + i;
    if (e >= n) break;
    const int c = (c0 + i) % channels;
    const int lo = -min(c, radius);
    const int hi = min(channels - 1 - c, radius);
    const float* w = ts + radius + i;
    float u = 0.0f;
    for (int k = lo; k <= hi; ++k) u += w[k];
    dx[e] = from_f32<T>(gp[i] - coef * xs[2 * radius + i] * u);
  }
}

}  // namespace

extern "C" int dvggf_lrn_bwd(const void* x, const void* g, void* dx,
                             long long n, int channels, int radius,
                             float bias, float a, float beta, float coef,
                             int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || channels < 1 || radius < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>((n + kTile - 1) / kTile);
  const size_t smem =
      static_cast<size_t>(3 * kTile + 6 * radius) * sizeof(float);
  const int mode = beta == 0.75f ? 0 : (beta == 0.5f ? 1 : 2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    lrn_bwd_kernel<float><<<blocks, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<float*>(dx), n, channels, radius, bias, a, beta, coef,
        mode);
  } else if (dtype == 1) {
    lrn_bwd_kernel<__nv_bfloat16><<<blocks, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(g),
        static_cast<__nv_bfloat16*>(dx), n, channels, radius, bias, a, beta,
        coef, mode);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
