// LRN backward over NHWC rows of C contiguous channels, for Hopper (sm_90a),
// with the backward of the preceding ReLU fused on request.
//
// Replaces the JAX package's Pallas TPU kernel ops/lrn_pallas.py:_bwd_kernel.
// It takes x (the forward's only residual: the LRN input, or with `relu` the
// ReLU's input z, from which it recomputes x = max(z, 0)) and g = dL/dy,
// recomputes the normalizer, and writes dx. For every element e with
// channel c:
//   d_j = bias + a * sum_{k=j-R..j+R, 0<=k<C} x_k^2      (fp32)
//   p_j = d_j^-beta
//   t_j = g_j * x_j * (p_j / d_j)                       (= g x d^-(beta+1))
//   u_c = sum_{j=c-R..c+R, 0<=j<C} t_j
//   dx  = g_c * p_c - (2 a beta) * x_c * u_c           (stored in x's dtype)
// and with `relu`, dz = dx rounded to x's dtype where z > 0, else 0 (the
// mask of torch's and JAX's ReLU gradients). d^-beta is rsqrt(d)*sqrt(
// rsqrt(d)) for beta=0.75, rsqrt(d) for 0.5, powf(d, -beta) otherwise, as
// in the forward kernel.
//
// Bound by device-memory bytes: x and g are read once and dx written once
// (6 bytes an element in bf16) against ~30 fp32 operations an element.
// Fusing the ReLU's backward saves the whole threshold_backward pass
// (read g and the mask's input, write dz) that would follow this one.
//
// Two variants, chosen by the shape alone (ops/lrn_cuda.py variant()):
//
// vector (lrn_bwd_vec_kernel): the forward's lane layout
//   (csrc/lrn_common.cuh). A lane loads x and g as 16-byte vectors, takes
//   the R squares nearest each edge from its neighbour lanes by shuffles,
//   forms d, p and t for its own E elements, shuffles the R values of t
//   nearest each edge the same way, sums each window of t and stores dx
//   as 16-byte vectors. For beta = 0.75, p/d is p * inv * inv with
//   inv = rsqrt(d): no IEEE division. No shared memory, no barrier, no
//   channel modulo, no atomics: every output is one lane's arithmetic, the
//   same bits from run to run. The grid-stride walk loads the next row's x
//   and g before this row's arithmetic, as in the forward.
// general (lrn_bwd_kernel): any C >= 1 and any radius whose span fits in
//   shared memory. A block owns kTile consecutive elements and stages x
//   over the span plus a 2R halo on each side in shared memory as fp32
//   (u_c needs t_j for j up to c +- R, and t_j needs x up to j +- R).
//   Phase 1 forms t over the span plus R on each side, and g*p for the
//   owned elements; phase 2 sums t over each clipped window. A window never
//   leaves its row and rows are contiguous, so the flat span covers every
//   window for any C; elements outside [0, n) stage as 0 and are never
//   inside a window.
//
// C interface (ctypes): dvggf_lrn_bwd returns cudaGetLastError() after the
// launch, 0 on success; cudaErrorInvalidValue for what it does not take.

#include "lrn_common.cuh"

namespace {

using namespace lrn;

constexpr int kTile = 2048;  // elements per block of the general variant

template <typename T, bool kRelu>
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
    const float v = (e >= 0 && e < n) ? to_f32(x[e]) : 0.0f;
    xs[i] = kRelu ? relu(v) : v;
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
    const float xe = xs[2 * radius + i];
    const float out = gp[i] - coef * xe * u;
    dx[e] = from_f32<T>(kRelu && !(xe > 0.0f) ? 0.0f : out);
  }
}

template <typename T, int E, int R, bool kRelu>
__global__ void __launch_bounds__(kThreads)
    lrn_bwd_vec_kernel(const T* __restrict__ x, const T* __restrict__ g,
                       T* __restrict__ dx, int64_t rows, int lane_shift,
                       float bias, float a, float beta, float coef, int mode) {
  using V = Lane<T, E>;
  constexpr int W = V::kWords;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* gv = reinterpret_cast<const uint4*>(g);
  uint4* dxv = reinterpret_cast<uint4*>(dx);
  RowWalk walk(lane_shift);
  uint4 cx[W], cg[W];
  load_row<W>(xv, walk.row, rows, walk.lanes, walk.lane, cx);
  load_row<W>(gv, walk.row, rows, walk.lanes, walk.lane, cg);
  for (; walk.base < rows; walk.base += walk.stride) {
    // the next row's x and g are in flight while this row is worked on
    const int64_t next = walk.row + walk.stride;
    uint4 nx[W], ng[W];
    load_row<W>(xv, next, rows, walk.lanes, walk.lane, nx);
    load_row<W>(gv, next, rows, walk.lanes, walk.lane, ng);

    float xf[E], gf[E], sq[E];
    V::unpack(cx, xf);
    V::unpack(cg, gf);
#pragma unroll
    for (int i = 0; i < E; ++i) {
      if (kRelu) xf[i] = relu(xf[i]);
      sq[i] = xf[i] * xf[i];
    }
    float ext[E + 2 * R];
    with_halo<E, R>(sq, ext, walk);
    float t[E], gp[E];
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const float d = bias + a * window_sum<E, R>(ext, i);
      float p, q;  // q = p / d
      if (mode == 0) {
        const float inv = rsqrtf(d);
        p = inv * sqrtf(inv);
        q = p * inv * inv;
      } else {
        p = pow_neg_beta(d, beta, mode);
        q = p / d;
      }
      t[i] = gf[i] * xf[i] * q;
      gp[i] = gf[i] * p;
    }
    with_halo<E, R>(t, ext, walk);
    float out[E];
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const float o = gp[i] - coef * xf[i] * window_sum<E, R>(ext, i);
      out[i] = kRelu && !(xf[i] > 0.0f) ? 0.0f : o;
    }
    if (walk.row < rows) {
      uint4 o[W];
      V::pack(out, o);
      store_row<W>(dxv, walk.row, walk.lanes, walk.lane, o);
    }
#pragma unroll
    for (int i = 0; i < W; ++i) {
      cx[i] = nx[i];
      cg[i] = ng[i];
    }
    walk.row = next;
  }
}

struct Args {
  const void* x;
  const void* g;
  void* dx;
  float bias, a, beta, coef;
  int device;
  cudaStream_t s;
};

template <typename T, bool kRelu>
int launch_general(const Args& p, int64_t n, int channels, int radius) {
  const unsigned blocks = static_cast<unsigned>((n + kTile - 1) / kTile);
  const size_t smem =
      static_cast<size_t>(3 * kTile + 6 * radius) * sizeof(float);
  lrn_bwd_kernel<T, kRelu><<<blocks, kThreads, smem, p.s>>>(
      static_cast<const T*>(p.x), static_cast<const T*>(p.g),
      static_cast<T*>(p.dx), n, channels, radius, p.bias, p.a, p.beta, p.coef,
      beta_mode(p.beta));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int E, int R, bool kRelu>
int launch_vec(const Args& p, int64_t rows, int lane_shift) {
  auto kernel = lrn_bwd_vec_kernel<T, E, R, kRelu>;
  static const int per_sm = blocks_per_sm(kernel);
  const unsigned blocks = vec_blocks(per_sm, rows, lane_shift, p.device);
  kernel<<<blocks, kThreads, 0, p.s>>>(
      static_cast<const T*>(p.x), static_cast<const T*>(p.g),
      static_cast<T*>(p.dx), rows, lane_shift, p.bias, p.a, p.beta, p.coef,
      beta_mode(p.beta));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int E, bool kRelu>
int launch_vec_radius(const Args& p, int radius, int64_t rows,
                      int lane_shift) {
  switch (radius) {
    case 0:
      return launch_vec<T, E, 0, kRelu>(p, rows, lane_shift);
    case 1:
      return launch_vec<T, E, 1, kRelu>(p, rows, lane_shift);
    case 2:
      return launch_vec<T, E, 2, kRelu>(p, rows, lane_shift);
    case 3:
      return launch_vec<T, E, 3, kRelu>(p, rows, lane_shift);
    case 4:
      return launch_vec<T, E, 4, kRelu>(p, rows, lane_shift);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kRelu>
int launch_vec_dtype(const Args& p, int dtype, int radius, int64_t rows,
                     int lane_shift) {
  if (dtype == 1) {
    return launch_vec_radius<__nv_bfloat16, kLaneElems, kRelu>(p, radius, rows,
                                                               lane_shift);
  }
  return launch_vec_radius<float, kLaneElems, kRelu>(p, radius, rows,
                                                     lane_shift);
}

}  // namespace

// vector 0 launches the general variant, 1 the vector variant (16-byte
// aligned x, g and dx).
extern "C" int dvggf_lrn_bwd(const void* x, const void* g, void* dx,
                             long long n, int channels, int radius,
                             float bias, float a, float beta, float coef,
                             int relu, int vector, int dtype, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || channels < 1 || radius < 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args p{x, g, dx, bias, a, beta, coef, device,
               static_cast<cudaStream_t>(stream)};
  if (!vector) {
    if (dtype == 0) {
      return relu ? launch_general<float, true>(p, n, channels, radius)
                  : launch_general<float, false>(p, n, channels, radius);
    }
    return relu ? launch_general<__nv_bfloat16, true>(p, n, channels, radius)
                : launch_general<__nv_bfloat16, false>(p, n, channels, radius);
  }
  const int lane_shift = vec_lane_shift(channels, radius);
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(dx);
  if (lane_shift < 0 || n % channels != 0 || ptrs % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t rows = n / channels;
  return relu ? launch_vec_dtype<true>(p, dtype, radius, rows, lane_shift)
              : launch_vec_dtype<false>(p, dtype, radius, rows, lane_shift);
}
