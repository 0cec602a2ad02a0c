// LRN forward over NHWC rows of C contiguous channels, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel ops/lrn_pallas.py:_fwd_kernel.
// For every element e with channel c:
//   S = sum_{j=c-r..c+r, 0<=j<C} x_j^2   (fp32)
//   d = bias + a*S
//   y = x * d^-beta                      (stored in x's dtype)
// with d^-beta = rsqrt(d)*sqrt(rsqrt(d)) for beta=0.75, rsqrt(d) for 0.5,
// powf(d, -beta) otherwise.
//
// Bound by device-memory bytes: x is read once and y written once. A block
// stages a contiguous span of kTile elements plus an r-element halo on each
// side in shared memory as fp32, then each thread forms its window sums from
// shared memory. A window never leaves its row and rows are contiguous, so
// the flat span plus halo covers every window for any C.
//
// C interface (ctypes): dvggf_lrn_fwd returns cudaGetLastError() after the
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
    lrn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n,
                   int channels, int radius, float bias, float a, float beta,
                   int mode) {
  extern __shared__ float xs[];  // kTile + 2*radius values
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kTile;
  const int span = kTile + 2 * radius;
  for (int i = threadIdx.x; i < span; i += kThreads) {
    const int64_t e = start - radius + i;
    xs[i] = (e >= 0 && e < n) ? to_f32(x[e]) : 0.0f;
  }
  __syncthreads();
  const int c0 = static_cast<int>(start % channels);
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int64_t e = start + i;
    if (e >= n) break;
    const int c = (c0 + i) % channels;
    const int lo = -min(c, radius);
    const int hi = min(channels - 1 - c, radius);
    const float* w = xs + radius + i;
    float s = 0.0f;
    for (int k = lo; k <= hi; ++k) s += w[k] * w[k];
    y[e] = from_f32<T>(w[0] * pow_neg_beta(bias + a * s, beta, mode));
  }
}

}  // namespace

extern "C" int dvggf_lrn_fwd(const void* x, void* y, long long n,
                             int channels, int radius, float bias, float a,
                             float beta, int dtype, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || channels < 1 || radius < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>((n + kTile - 1) / kTile);
  const size_t smem = static_cast<size_t>(kTile + 2 * radius) * sizeof(float);
  const int mode = beta == 0.75f ? 0 : (beta == 0.5f ? 1 : 2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    lrn_fwd_kernel<float><<<blocks, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), n, channels,
        radius, bias, a, beta, mode);
  } else if (dtype == 1) {
    lrn_fwd_kernel<__nv_bfloat16><<<blocks, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
        n, channels, radius, bias, a, beta, mode);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
