// Shared pieces of the flash attention kernels (flash_fwd.cu, flash_dq.cu,
// flash_dkv.cu and the ring block kernels), for Hopper (sm_90a).
//
// Head dims: every kernel takes any D from 1 to 256. It is instantiated
// for the padded widths 16, 32, 64, 128 and 256 (padded_dim) and runs a
// smaller D on the next one up: the padding columns are zero-filled in
// shared memory, so they add nothing to q.k, and are never written out.
//
// Grid of the fp32 kernels: a block's (b*h, row tile) pair is one index
// on the grid's x axis (tile_of), which allows 2^31 - 1 blocks, so B*H is
// not limited by the y axis's 65535. The bf16 forward, dQ and dK/dV and
// the three ring block kernels walk work tiles persistently instead (the
// end of this file).
//
// The fp32 versions run on the CUDA cores: a block of kThreads = 256
// threads is a 16 x 16 grid, thread (ty, tx) owning rows ty*(R/16) ..
// ty*(R/16) + R/16 - 1 of an R-row tile and columns tx + 16*j (j < R/16)
// of an R x R product, or columns tx + 16*j (j < D/16) of an R x D one.
// R is 64 up to D = 128 and 32 at D = 256 (rows_fp32: four 64 x 257 fp32
// tiles would not fit in shared memory). Tiles live in shared memory as
// fp32 with a row stride of D+1 (or R+1), so the column reads of one
// half-warp hit 16 distinct banks and the two half-warps of a warp read
// either the same word or distinct banks. Products are fp32 fused
// multiply-adds. In bf16 the forward, dQ and dK/dV and the three ring
// block kernels run wgmma (hopper.cuh).
//
// q, k and v are (B, T, H, D) with a contiguous D axis and any strides
// over (B, T, H): the model passes the three slices of its fused QKV
// projection's (B, T, 3, H, D) output without a copy. o, dO, dq, dk and
// dv are contiguous (B, T, H, D); lse and delta are contiguous (B, H, T)
// fp32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace flash {

constexpr int kThreads = 256;
constexpr int kMaxHeadDim = 256;

// The padded width a head dim d runs at; 0 when d is outside [1, 256].
__host__ __device__ __forceinline__ int padded_dim(int d) {
  return d < 1 ? 0 : d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64
       : d <= 128 ? 128 : d <= kMaxHeadDim ? 256 : 0;
}

// Row tile of the fp32 kernels at padded head dim D.
template <int D>
constexpr int rows_fp32() {
  return D <= 128 ? 64 : 32;
}

// One block's row tile and (b*h) from the grid's x axis: blocks run over
// the row tiles of a (b, h) first.
struct Tile {
  int r0;
  int bh;
};

__device__ __forceinline__ Tile tile_of(int rows, int T_len) {
  const int n = (T_len + rows - 1) / rows;
  const int x = static_cast<int>(blockIdx.x);
  return Tile{(x % n) * rows, x / n};
}

// The grid of ceil(T / rows) * BH blocks, or an error past 2^31 - 1.
inline cudaError_t grid_of(int T_len, int rows, int BH, dim3* grid) {
  const long long n =
      static_cast<long long>((T_len + rows - 1) / rows) * BH;
  if (n > 2147483647LL) return cudaErrorInvalidConfiguration;
  *grid = dim3(static_cast<unsigned>(n));
  return cudaSuccess;
}

// Dynamic shared memory, one declaration for every kernel of a source.
template <typename T>
__device__ __forceinline__ T* dyn_smem() {
  extern __shared__ __align__(16) unsigned char flash_smem[];
  return reinterpret_cast<T*>(flash_smem);
}

// Runs CALL with the compile-time padded width DP of head dim d.
#define FLASH_PADDED_DIMS(d, CALL)              \
  switch (flash::padded_dim(d)) {               \
    case 16: { constexpr int DP = 16; CALL; }   \
    case 32: { constexpr int DP = 32; CALL; }   \
    case 64: { constexpr int DP = 64; CALL; }   \
    case 128: { constexpr int DP = 128; CALL; } \
    case 256: { constexpr int DP = 256; CALL; } \
    default: return cudaErrorInvalidValue;      \
  }

// Element strides of a (B, T, H, D) tensor whose D axis is contiguous.
struct Strides {
  long long b, t, h;
};

__host__ __device__ __forceinline__ Strides dense_strides(int T, int H,
                                                          int D) {
  return Strides{static_cast<long long>(T) * H * D,
                 static_cast<long long>(H) * D, static_cast<long long>(D)};
}

// Rows row0 .. row0+R-1 of x for one (b, h) at `base` into dst
// (R x (D+1) fp32); rows at or past T and columns at or past d read as
// zeros.
template <int D, int R>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ x,
                                          long long base, Strides s,
                                          int row0, int T_len, int d) {
  for (int idx = threadIdx.x; idx < R * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx % D;
    const int t = row0 + r;
    dst[r * (D + 1) + c] =
        t < T_len && c < d ? x[base + t * s.t + c] : 0.0f;
  }
}

// acc[i][j] = sum_d A[ty*R/16+i][d] * B[tx+16j][d]: one thread's share
// of an R x R product contracting D (A and B are R x (D+1)).
template <int D, int R>
__device__ __forceinline__ void dot_tile(float (&acc)[R / 16][R / 16],
                                         const float* A, const float* B,
                                         int ty, int tx) {
  constexpr int kR = R / 16;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
#pragma unroll
    for (int j = 0; j < kR; ++j) acc[i][j] = 0.0f;
  }
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[kR], b[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) a[i] = A[(ty * kR + i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < kR; ++j) b[j] = B[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
#pragma unroll
      for (int j = 0; j < kR; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// acc[i][j] += sum_c P[ty*R/16+i][c] * M[c][tx+16j]: one thread's share
// of an R x D product contracting the tile (P is R x (R+1), M is
// R x (D+1)).
template <int D, int R>
__device__ __forceinline__ void accumulate_rows(float (&acc)[R / 16][D / 16],
                                                const float* P,
                                                const float* M, int ty,
                                                int tx) {
  constexpr int kR = R / 16;
#pragma unroll 4
  for (int c = 0; c < R; ++c) {
    float p[kR], m[D / 16];
#pragma unroll
    for (int i = 0; i < kR; ++i) p[i] = P[(ty * kR + i) * (R + 1) + c];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) m[j] = M[c * (D + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(p[i], m[j], acc[i][j]);
    }
  }
}

// Reductions over the 16 lanes of a half-warp (the threads of one ty).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// Shared memory of a kernel with `tiles` R x (D+1) tiles, `squares`
// R x (R+1) tiles and `vectors` R-long vectors, in bytes.
template <int D, int R>
constexpr size_t smem_bytes(int tiles, int squares, int vectors) {
  return sizeof(float) *
         (static_cast<size_t>(tiles) * R * (D + 1) +
          static_cast<size_t>(squares) * R * (R + 1) +
          static_cast<size_t>(vectors) * R);
}

// Opt a kernel into `bytes` of dynamic shared memory (above the 48 KB a
// launch gets without asking).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// ---------------------------------------------------------------------------
// Pieces of the bf16 kernels' epilogues and launchers.

// Two fp32 values rounded to bf16 and packed, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(hi)))
          << 16);
}

// x[0] += v0 and, when `two`, x[1] += v1: one float2 access when `pairs`
// (x on 8 bytes).
__device__ __forceinline__ void add_pair(float* x, float v0, float v1,
                                         bool pairs, bool two) {
  if (pairs) {
    float2 a = *reinterpret_cast<float2*>(x);
    a.x += v0;
    a.y += v1;
    *reinterpret_cast<float2*>(x) = a;
  } else {
    x[0] += v0;
    if (two) x[1] += v1;
  }
}

// Whether a tensor map can read bf16 (B, T, H, D) tensors with element
// strides s in place: bases on 16 bytes and the (B, T, H) strides
// multiples of 8 elements (TMA's 16-byte rules).
template <typename... Ptr>
inline bool tma_rows(Strides s, Ptr... ptrs) {
  const auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  return s.b % 8 == 0 && s.t % 8 == 0 && s.h % 8 == 0 && (al(ptrs) && ...);
}

// Reductions over the 4 lanes of a quad (the lanes holding one C row).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------------------
// The ring block kernels (flash_block_fwd.cu, flash_block_dq.cu,
// flash_block_dkv.cu) take q and dO as (B*H, Tq, D) and the visiting block's
// k and v as (B*H, Tk, D), all contiguous: one (b, h) is `bh` with stride
// T*D. Causal masking is by global position — local query row i sits at
// q_off + i, local key j at k_off + j — and keys at or past the block-local
// kv_len are padding. The helpers below depend on q_off - k_off alone: the
// bf16 block dQ and dK/dV pass (q_off - k_off, 0).
__host__ __device__ __forceinline__ Strides rows_strides(int T_len, int D) {
  return Strides{static_cast<long long>(T_len) * D, D, 0};
}

// Whether local query row qi attends to local key kj of the visiting block
// (rows at or past Tq are the caller's to mask).
__device__ __forceinline__ bool block_live(int qi, int kj, int q_off,
                                           int k_off, int causal,
                                           int kv_len) {
  return kj < kv_len && (!causal || k_off + kj <= q_off + qi);
}

// One past the last key that any of the query rows q0 .. q0+rows-1 may
// see; <= 0 when none may.
__device__ __forceinline__ int block_key_end(int q0, int rows, int Tq,
                                             int q_off, int k_off,
                                             int causal, int kv_len) {
  return causal ? min(kv_len, q_off + min(q0 + rows, Tq) - k_off) : kv_len;
}

// The first rows-aligned query tile holding a row that may see key k0.
__device__ __forceinline__ int block_query_start(int k0, int rows, int q_off,
                                                 int k_off, int causal) {
  const int first = k_off + k0 - q_off;  // local row at key k0's position
  return causal && first > 0 ? first / rows * rows : 0;
}

// ---------------------------------------------------------------------------
// The persistent bf16 kernels (flash_fwd.cu, flash_dq.cu, flash_dkv.cu,
// and the ring block kernels' in flash_block_fwd.cu, flash_block_dq.cu and
// flash_block_dkv.cu): one block an SM takes work tiles t = blockIdx.x,
// blockIdx.x + gridDim.x, ... A work tile is rows r0 .. r0 + kM - 1 of
// one (b, h) — query rows in the forward and dQ, key rows in dK/dV — and
// the n tiles of the other operand that it walks.
struct Work {
  int b, h, bh, r0, n;
};

// The walk of the forward and dQ: kM query rows walk the K/V tiles of kN
// keys that any of them may see. Causal tiles go longest first; otherwise
// a (b, h)'s tiles sit side by side, so its K/V is read again from L2.
__device__ __forceinline__ Work query_walk(long long t, int BH, int H,
                                          int nq, int kM, int kN,
                                          int causal, int kv_len) {
  int qb, bh;
  if (causal) {
    qb = nq - 1 - static_cast<int>(t / BH);
    bh = static_cast<int>(t % BH);
  } else {
    bh = static_cast<int>(t / nq);
    qb = static_cast<int>(t % nq);
  }
  const int q0 = qb * kM;
  const int k_end = causal ? min(kv_len, q0 + kM) : kv_len;
  return Work{bh / H, bh % H, bh, q0, (k_end + kN - 1) / kN};
}

// The walk of the block fold and the block dQ, query_walk's for a ring
// block step: kM query rows of one bh walk the K/V tiles of kN keys up to
// block_key_end (the diagonal shifted by shift = q_off - k_off), none
// when that is <= 0. Causal tiles go longest first; otherwise a bh's
// tiles sit side by side, so its K/V is read again from L2.
__device__ __forceinline__ Work block_query_walk(long long t, int BH, int nq,
                                                 int kM, int kN, int Tq,
                                                 int shift, int causal,
                                                 int kv_len) {
  int qb, bh;
  if (causal) {
    qb = nq - 1 - static_cast<int>(t / BH);
    bh = static_cast<int>(t % BH);
  } else {
    bh = static_cast<int>(t / nq);
    qb = static_cast<int>(t % nq);
  }
  const int q0 = qb * kM;
  const int k_end = block_key_end(q0, kM, Tq, shift, 0, causal, kv_len);
  return Work{bh, 0, bh, q0, k_end > 0 ? (k_end + kN - 1) / kN : 0};
}

}  // namespace flash
