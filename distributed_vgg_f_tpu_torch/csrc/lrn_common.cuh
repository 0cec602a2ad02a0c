// Shared pieces of the LRN kernels (csrc/lrn_fwd.cu, csrc/lrn_bwd.cu):
// conversions, the fused ReLU, d^-beta, the 16-byte lane vectors of the
// vector variant and its grid.
//
// The vector variant holds a row of C contiguous channels (one NHWC pixel)
// in a group of L = C/E lanes of one warp, L a power of two <= 32. Each lane
// holds E = 8 contiguous channels as whole 16-byte vectors (one of bf16, two
// of fp32), so the channel of every value is lane-in-group * E + k, known at
// compile time up to the lane. A window of radius R <= 4 < E reaches at most
// one lane to each side: the R values nearest each edge
// come from the adjacent lane by one warp shuffle each, and a lane at the
// group's edge takes zeros instead, which is the clip at the row's edge.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace lrn {

constexpr int kThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;
// elements a lane of the vector variant holds (ops/lrn_cuda.py _LANE_ELEMS)
constexpr int kLaneElems = 8;
// the largest radius the vector variant is instantiated for
constexpr int kMaxVecRadius = 4;

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

// The ReLU fused in front of LRN: +0 for z <= 0 (-0 included), z above 0,
// NaN kept. A value at or below 0 gets +0, as torch's and JAX's relu give.
__device__ __forceinline__ float relu(float v) { return v <= 0.0f ? 0.0f : v; }

// mode 0: beta == 0.75, mode 1: beta == 0.5, mode 2: any other beta
__device__ __forceinline__ float pow_neg_beta(float d, float beta, int mode) {
  if (mode == 0) {
    const float inv = rsqrtf(d);
    return inv * sqrtf(inv);
  }
  if (mode == 1) return rsqrtf(d);
  return powf(d, -beta);
}

inline int beta_mode(float beta) {
  return beta == 0.75f ? 0 : (beta == 0.5f ? 1 : 2);
}

// E values of T in a lane, as kWords 16-byte vectors, unpacked to fp32 and
// packed back (round to nearest even for bf16, as __float2bfloat16).
template <typename T, int E>
struct Lane;

template <int E>
struct Lane<float, E> {
  static_assert(E % 4 == 0, "fp32 lanes hold whole 16-byte vectors");
  static constexpr int kWords = E / 4;
  __device__ __forceinline__ static void unpack(const uint4 (&w)[kWords],
                                                float (&v)[E]) {
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      v[4 * i + 0] = __uint_as_float(w[i].x);
      v[4 * i + 1] = __uint_as_float(w[i].y);
      v[4 * i + 2] = __uint_as_float(w[i].z);
      v[4 * i + 3] = __uint_as_float(w[i].w);
    }
  }
  __device__ __forceinline__ static void pack(const float (&v)[E],
                                              uint4 (&w)[kWords]) {
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      w[i] = make_uint4(__float_as_uint(v[4 * i + 0]),
                        __float_as_uint(v[4 * i + 1]),
                        __float_as_uint(v[4 * i + 2]),
                        __float_as_uint(v[4 * i + 3]));
    }
  }
};

__device__ __forceinline__ float2 bf16x2_to_float2(unsigned u) {
  __nv_bfloat162 h;
  static_assert(sizeof(h) == sizeof(u), "bf16x2 is one 32-bit word");
  memcpy(&h, &u, sizeof(u));
  return __bfloat1622float2(h);
}

__device__ __forceinline__ unsigned float2_to_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  unsigned u;
  memcpy(&u, &h, sizeof(u));
  return u;
}

template <int E>
struct Lane<__nv_bfloat16, E> {
  static_assert(E % 8 == 0, "bf16 lanes hold whole 16-byte vectors");
  static constexpr int kWords = E / 8;
  __device__ __forceinline__ static void unpack(const uint4 (&w)[kWords],
                                                float (&v)[E]) {
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      const unsigned u[4] = {w[i].x, w[i].y, w[i].z, w[i].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = bf16x2_to_float2(u[j]);
        v[8 * i + 2 * j] = f.x;  // the lower address is the low half
        v[8 * i + 2 * j + 1] = f.y;
      }
    }
  }
  __device__ __forceinline__ static void pack(const float (&v)[E],
                                              uint4 (&w)[kWords]) {
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      w[i] = make_uint4(float2_to_bf16x2(v[8 * i + 0], v[8 * i + 1]),
                        float2_to_bf16x2(v[8 * i + 2], v[8 * i + 3]),
                        float2_to_bf16x2(v[8 * i + 4], v[8 * i + 5]),
                        float2_to_bf16x2(v[8 * i + 6], v[8 * i + 7]));
    }
  }
};

// One lane group's place in the grid-stride walk over rows. A warp holds
// 32/L rows; the walk steps every warp by all the grid's rows at once, so
// its loop bound is the same for all 32 lanes (the shuffles need them all).
struct RowWalk {
  int lanes;       // L
  int lane;        // lane in group
  int64_t row;     // this group's row in the current step
  int64_t base;    // the warp's first row in the current step
  int64_t stride;  // rows the whole grid covers in one step

  __device__ __forceinline__ explicit RowWalk(int lane_shift) {
    lanes = 1 << lane_shift;
    const int l = threadIdx.x & 31;
    lane = l & (lanes - 1);
    const int per_warp = 32 >> lane_shift;
    const int64_t warp =
        (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
    base = warp * per_warp;
    row = base + (l >> lane_shift);
    stride = (static_cast<int64_t>(gridDim.x) * kThreads >> 5) * per_warp;
  }
  __device__ __forceinline__ bool left_edge() const { return lane == 0; }
  __device__ __forceinline__ bool right_edge() const {
    return lane == lanes - 1;
  }
};

// The lane's kWords vectors of row `row` (zeros past the last row).
template <int kWords>
__device__ __forceinline__ void load_row(const uint4* __restrict__ p,
                                         int64_t row, int64_t rows,
                                         int lanes, int lane,
                                         uint4 (&w)[kWords]) {
  if (row < rows) {
    const uint4* q = p + (row * lanes + lane) * kWords;
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = __ldg(q + i);
  } else {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int kWords>
__device__ __forceinline__ void store_row(uint4* __restrict__ p, int64_t row,
                                          int lanes, int lane,
                                          const uint4 (&w)[kWords]) {
  uint4* q = p + (row * lanes + lane) * kWords;
#pragma unroll
  for (int i = 0; i < kWords; ++i) q[i] = w[i];
}

// v[0..E) extended by the R values each side from the adjacent lanes of
// the group: ext[R + i] = v[i], ext[k] = left lane's v[E - R + k],
// ext[R + E + k] = right lane's v[k]; zeros past the group's edges.
template <int E, int R>
__device__ __forceinline__ void with_halo(const float (&v)[E],
                                          float (&ext)[E + 2 * R],
                                          const RowWalk& w) {
#pragma unroll
  for (int i = 0; i < E; ++i) ext[R + i] = v[i];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const float l = __shfl_up_sync(kFullMask, v[E - R + k], 1, w.lanes);
    const float r = __shfl_down_sync(kFullMask, v[k], 1, w.lanes);
    ext[k] = w.left_edge() ? 0.0f : l;
    ext[R + E + k] = w.right_edge() ? 0.0f : r;
  }
}

// sum_{k=0..2R} ext[i + k], in window order (channel c-R first), as the
// plain version adds its shifted slices.
template <int E, int R>
__device__ __forceinline__ float window_sum(const float (&ext)[E + 2 * R],
                                           int i) {
  float s = ext[i];
#pragma unroll
  for (int k = 1; k <= 2 * R; ++k) s += ext[i + k];
  return s;
}

// Blocks for the vector variant's grid-stride walk: enough to hold every
// row at once, at most what fills every SM at the kernel's occupancy
// (`per_sm` resident blocks, from cudaOccupancyMaxActiveBlocksPerMultiprocessor).
inline unsigned vec_blocks(int per_sm, int64_t rows, int lane_shift,
                           int device) {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t rows_per_block = (kThreads / 32) * (32 >> lane_shift);
  const int64_t need = (rows + rows_per_block - 1) / rows_per_block;
  const int64_t full = static_cast<int64_t>(sms > 0 ? sms : 1) *
                       (per_sm > 0 ? per_sm : 1);
  return static_cast<unsigned>(need < full ? need : full);
}

template <typename Kernel>
inline int blocks_per_sm(Kernel kernel) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return per_sm;
}

// log2 of L = channels / kLaneElems when the vector variant takes the
// shape (L a power of two <= 32, radius <= kMaxVecRadius), else -1.
// ops/lrn_cuda.py variant() applies the same rule.
inline int vec_lane_shift(int channels, int radius) {
  if (channels % kLaneElems != 0) return -1;
  if (radius < 0 || radius > kMaxVecRadius) return -1;
  const int lanes = channels / kLaneElems;
  for (int s = 0; s <= 5; ++s) {
    if (lanes == (1 << s)) return s;
  }
  return -1;
}

}  // namespace lrn
