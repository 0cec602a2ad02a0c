// LRN forward over NHWC rows of C contiguous channels, for Hopper (sm_90a),
// with the preceding ReLU fused on request.
//
// Replaces the JAX package's Pallas TPU kernel ops/lrn_pallas.py:_fwd_kernel.
// For every element e with channel c, r = max(x, 0) when `relu` is set and
// r = x otherwise:
//   S = sum_{j=c-R..c+R, 0<=j<C} r_j^2   (fp32)
//   d = bias + a*S
//   y = r * d^-beta                      (stored in x's dtype)
// with d^-beta = rsqrt(d)*sqrt(rsqrt(d)) for beta=0.75, rsqrt(d) for 0.5,
// powf(d, -beta) otherwise.
//
// Bound by device-memory bytes: x is read once and y written once (4 bytes
// an element in bf16) against ~15 fp32 operations an element. Fusing the
// ReLU saves a whole read-and-write pass over the tensor before this one.
//
// Two variants, chosen by the shape alone (ops/lrn_cuda.py variant()):
//
// vector (lrn_fwd_vec_kernel): C/8 lanes a power of two <= 32 and radius
//   <= 4 (csrc/lrn_common.cuh). A group of L lanes holds a row in
//   registers as whole 16-byte vectors, so a warp's load moves 512 bytes
//   in one instruction; a window's neighbours come from the adjacent
//   lanes by warp shuffles, so there is no shared memory, no barrier, no
//   channel modulo and no loop with runtime bounds (the 2R+1 taps are
//   unrolled). A grid-stride walk sized to fill every SM loads the group's
//   next row before it works on this one, so each warp keeps a row in
//   flight while it computes (Little's law: 3.35 TB/s x ~0.7 us is ~2.3 MB
//   in flight across 132 SMs).
// general (lrn_fwd_kernel): any C >= 1 and any radius whose span fits in
//   shared memory. A block stages a contiguous span of kTile elements plus
//   an R-element halo each side in shared memory as fp32, then each thread
//   forms its clipped window sums from there. A window never leaves its
//   row and rows are contiguous, so the flat span plus halo covers every
//   window for any C.
//
// C interface (ctypes): dvggf_lrn_fwd returns cudaGetLastError() after the
// launch, 0 on success; cudaErrorInvalidValue for what it does not take.

#include "lrn_common.cuh"

namespace {

using namespace lrn;

constexpr int kTile = 2048;  // elements per block of the general variant

template <typename T, bool kRelu>
__global__ void __launch_bounds__(kThreads)
    lrn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n,
                   int channels, int radius, float bias, float a, float beta,
                   int mode) {
  extern __shared__ float xs[];  // kTile + 2*radius values
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kTile;
  const int span = kTile + 2 * radius;
  for (int i = threadIdx.x; i < span; i += kThreads) {
    const int64_t e = start - radius + i;
    const float v = (e >= 0 && e < n) ? to_f32(x[e]) : 0.0f;
    xs[i] = kRelu ? relu(v) : v;
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

template <typename T, int E, int R, bool kRelu>
__global__ void __launch_bounds__(kThreads)
    lrn_fwd_vec_kernel(const T* __restrict__ x, T* __restrict__ y,
                       int64_t rows, int lane_shift, float bias, float a,
                       float beta, int mode) {
  using V = Lane<T, E>;
  constexpr int W = V::kWords;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  RowWalk walk(lane_shift);
  uint4 cur[W];
  load_row<W>(xv, walk.row, rows, walk.lanes, walk.lane, cur);
  for (; walk.base < rows; walk.base += walk.stride) {
    // the next row's load is in flight while this row is worked on
    const int64_t next = walk.row + walk.stride;
    uint4 nxt[W];
    load_row<W>(xv, next, rows, walk.lanes, walk.lane, nxt);

    float v[E];
    V::unpack(cur, v);
    float sq[E];
#pragma unroll
    for (int i = 0; i < E; ++i) {
      if (kRelu) v[i] = relu(v[i]);
      sq[i] = v[i] * v[i];
    }
    float ext[E + 2 * R];
    with_halo<E, R>(sq, ext, walk);
    float out[E];
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const float s = window_sum<E, R>(ext, i);
      out[i] = v[i] * pow_neg_beta(bias + a * s, beta, mode);
    }
    if (walk.row < rows) {
      uint4 o[W];
      V::pack(out, o);
      store_row<W>(yv, walk.row, walk.lanes, walk.lane, o);
    }
#pragma unroll
    for (int i = 0; i < W; ++i) cur[i] = nxt[i];
    walk.row = next;
  }
}

template <typename T, bool kRelu>
int launch_general(const void* x, void* y, int64_t n, int channels,
                   int radius, float bias, float a, float beta,
                   cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((n + kTile - 1) / kTile);
  const size_t smem = static_cast<size_t>(kTile + 2 * radius) * sizeof(float);
  lrn_fwd_kernel<T, kRelu><<<blocks, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n, channels, radius, bias,
      a, beta, beta_mode(beta));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int E, int R, bool kRelu>
int launch_vec(const void* x, void* y, int64_t rows, int lane_shift,
               float bias, float a, float beta, int device, cudaStream_t s) {
  auto kernel = lrn_fwd_vec_kernel<T, E, R, kRelu>;
  static const int per_sm = blocks_per_sm(kernel);
  const unsigned blocks = vec_blocks(per_sm, rows, lane_shift, device);
  kernel<<<blocks, kThreads, 0, s>>>(static_cast<const T*>(x),
                                     static_cast<T*>(y), rows, lane_shift,
                                     bias, a, beta, beta_mode(beta));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int E, bool kRelu>
int launch_vec_radius(int radius, const void* x, void* y, int64_t rows,
                      int lane_shift, float bias, float a, float beta,
                      int device, cudaStream_t s) {
  switch (radius) {
    case 0:
      return launch_vec<T, E, 0, kRelu>(x, y, rows, lane_shift, bias, a, beta,
                                        device, s);
    case 1:
      return launch_vec<T, E, 1, kRelu>(x, y, rows, lane_shift, bias, a, beta,
                                        device, s);
    case 2:
      return launch_vec<T, E, 2, kRelu>(x, y, rows, lane_shift, bias, a, beta,
                                        device, s);
    case 3:
      return launch_vec<T, E, 3, kRelu>(x, y, rows, lane_shift, bias, a, beta,
                                        device, s);
    case 4:
      return launch_vec<T, E, 4, kRelu>(x, y, rows, lane_shift, bias, a, beta,
                                        device, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kRelu>
int launch_vec_dtype(int dtype, int radius, const void* x, void* y,
                     int64_t rows, int lane_shift, float bias, float a,
                     float beta, int device, cudaStream_t s) {
  if (dtype == 1) {
    return launch_vec_radius<__nv_bfloat16, kLaneElems, kRelu>(
        radius, x, y, rows, lane_shift, bias, a, beta, device, s);
  }
  return launch_vec_radius<float, kLaneElems, kRelu>(
      radius, x, y, rows, lane_shift, bias, a, beta, device, s);
}

}  // namespace

// vector 0 launches the general variant, 1 the vector variant (16-byte
// aligned x and y).
extern "C" int dvggf_lrn_fwd(const void* x, void* y, long long n,
                             int channels, int radius, float bias, float a,
                             float beta, int relu, int vector, int dtype,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || channels < 1 || radius < 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!vector) {
    if (dtype == 0) {
      return relu ? launch_general<float, true>(x, y, n, channels, radius,
                                                bias, a, beta, s)
                  : launch_general<float, false>(x, y, n, channels, radius,
                                                 bias, a, beta, s);
    }
    return relu ? launch_general<__nv_bfloat16, true>(x, y, n, channels,
                                                      radius, bias, a, beta, s)
                : launch_general<__nv_bfloat16, false>(x, y, n, channels,
                                                       radius, bias, a, beta,
                                                       s);
  }
  const int lane_shift = vec_lane_shift(channels, radius);
  if (lane_shift < 0 || n % channels != 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t rows = n / channels;
  return relu ? launch_vec_dtype<true>(dtype, radius, x, y, rows, lane_shift,
                                       bias, a, beta, device, s)
              : launch_vec_dtype<false>(dtype, radius, x, y, rows, lane_shift,
                                        bias, a, beta, device, s);
}
