// Flash attention backward, dQ, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// ops/flash_attention.py:_dq_kernel (with _dq_update). From the forward's
// residuals (q, k, v, lse) and dO with delta_i = sum_d dO_id * O_id
// (fp32, computed by the caller), for each (b, h) and query row i:
//   s_ij  = (q_i . k_j) * scale, p_ij = exp(s_ij - lse_i)   (0 if masked)
//   dp_ij = dO_i . v_j
//   ds_ij = p_ij * (dp_ij - delta_i)
//   dq_i  = scale * sum_j round(ds_ij) k_j              (stored in q's dtype)
// with the forward's masks (j >= kv_len; j > i when causal) and round()
// the cast of dS to k's dtype before the product.
//
// Bound: device-memory bytes (q, k, v and dO read and dq written, 10*D
// bytes a row in bf16, against 6*T*D FLOP a row: ~118 FLOP a byte at
// T = 197, below the card's ~295). bf16 runs the products on the tensor
// cores (flash_dq_mma_kernel), fp32 on the CUDA cores (flash_dq_kernel),
// at any head dim from 1 to 256 (padded as flash_common.cuh says).
//
// Design: the TPU kernel's sequential KV grid axis, with dq accumulated in
// scratch, becomes a loop inside the block. A block owns kTile query rows
// of one (b, h): their q, dO, lse and delta stay in shared memory and
// registers while the K/V tiles stream through shared memory; p is
// recomputed from lse (the (T, T) matrix is never stored). Masked pairs
// get p = 0 explicitly, so lse = -inf (a row with no live key) gives no
// NaN. Rows at or past T, and keys at or past kv_len, are masked in the
// kernel instead of padded.
//
// C interface (ctypes): dvggf_flash_dq returns cudaGetLastError() after
// the launch, 0 on success.

#include "flash_common.cuh"

namespace {

using flash::kThreads;
using flash::kTile;

template <int D, int R>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const float* __restrict__ q,
                    const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int H, int T_len, int d, flash::Strides s, int causal,
                    int kv_len, float scale) {
  constexpr int kR = R / 16;
  float* Qs = flash::dyn_smem<float>();  // R x (D+1)
  float* dOs = Qs + R * (D + 1);          // R x (D+1)
  float* Ks = dOs + R * (D + 1);          // R x (D+1)
  float* Vs = Ks + R * (D + 1);           // R x (D+1)
  float* dSs = Vs + R * (D + 1);          // R x (R+1)
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const flash::Tile tile = flash::tile_of(R, T_len);
  const int q0 = tile.r0;
  const int bh = tile.bh;
  const int b = bh / H;
  const int h = bh % H;
  const long long base = b * s.b + h * s.h;
  const flash::Strides ds_ = flash::dense_strides(T_len, H, d);
  const long long dbase = b * ds_.b + h * ds_.h;
  flash::load_tile<D, R>(Qs, q, base, s, q0, T_len, d);
  flash::load_tile<D, R>(dOs, dout, dbase, ds_, q0, T_len, d);

  float row_lse[kR], row_delta[kR], acc[kR][D / 16];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = q0 + ty * kR + i;
    const long long at = static_cast<long long>(bh) * T_len + row;
    row_lse[i] = row < T_len ? lse[at] : 0.0f;
    row_delta[i] = row < T_len ? delta[at] : 0.0f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.0f;
  }
  const int k_end = causal ? min(kv_len, q0 + R) : kv_len;
  for (int k0 = 0; k0 < k_end; k0 += R) {
    __syncthreads();  // the last tile's readers of Ks, Vs and dSs are done
    flash::load_tile<D, R>(Ks, k, base, s, k0, T_len, d);
    flash::load_tile<D, R>(Vs, v, base, s, k0, T_len, d);
    __syncthreads();
    float sc[kR][kR], dp[kR][kR];
    flash::dot_tile<D, R>(sc, Qs, Ks, ty, tx);
    flash::dot_tile<D, R>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int qp = q0 + ty * kR + i;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool live =
            qp < T_len && kp < kv_len && (!causal || kp <= qp);
        const float p = live ? expf(sc[i][j] * scale - row_lse[i]) : 0.0f;
        dSs[(ty * kR + i) * (R + 1) + tx + 16 * j] =
            p * (dp[i][j] - row_delta[i]);
      }
    }
    __syncthreads();
    flash::accumulate_rows<D, R>(acc, dSs, Ks, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = q0 + ty * kR + i;
    if (row >= T_len) continue;
    const long long at = dbase + row * ds_.t;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      if (tx + 16 * j < d) dq[at + tx + 16 * j] = scale * acc[i][j];
    }
  }
}

// The bf16 version of the same function, on the tensor cores: a
// block of 4 warps owns kTile query rows, 16 a warp, with q's and dO's
// fragments, lse, delta and dq in registers. Each K/V tile is staged in
// shared memory as bf16 — K row-major (for S = Q K^T) and transposed (for
// dQ += dS K), V row-major (for dP = dO V^T) — and dS goes to the dQ
// product as a fragment rounded to bf16.
template <int D>
__global__ void __launch_bounds__(flash::kMmaThreads)
    flash_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int H, int T_len,
                        int d, flash::Strides s, int causal, int kv_len,
                        float scale, bool vec) {
  uint16_t* Qs = flash::dyn_smem<uint16_t>();  // kTile x (D+8), then K
  uint16_t* dOs = Qs + kTile * (D + 8);         // kTile x (D+8), then V
  uint16_t* Kt = dOs + kTile * (D + 8);         // D x (kTile+8)
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16;
  const int g = lane / 4;
  const int tq = lane % 4;
  const flash::Tile tile = flash::tile_of(kTile, T_len);
  const int q0 = tile.r0;
  const int bh = tile.bh;
  const int b = bh / H;
  const int h = bh % H;
  const long long base = b * s.b + h * s.h;
  const flash::Strides ds_ = flash::dense_strides(T_len, H, d);
  const long long dbase = b * ds_.b + h * ds_.h;
  flash::load_tile_bf16<D, false>(Qs, q, base, s, q0, T_len, d, vec);
  flash::load_tile_bf16<D, false>(dOs, dout, dbase, ds_, q0, T_len, d,
                                  vec);
  __syncthreads();
  uint32_t qa[D / 16][4], da[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    flash::load_a<D + 8>(qa[ks], Qs, r0, 16 * ks, lane);
    flash::load_a<D + 8>(da[ks], dOs, r0, 16 * ks, lane);
  }
  float row_lse[2], row_delta[2], acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + 8 * i;
    const long long at = static_cast<long long>(bh) * T_len + row;
    row_lse[i] = row < T_len ? lse[at] : 0.0f;
    row_delta[i] = row < T_len ? delta[at] : 0.0f;
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  }
  uint16_t* Ks = Qs;
  uint16_t* Vs = dOs;
  const int k_end = causal ? min(kv_len, q0 + kTile) : kv_len;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // fragments loaded; the last tile's readers are done
    flash::load_tile_bf16<D, false>(Ks, k, base, s, k0, T_len, d, vec);
    flash::load_tile_bf16<D, true>(Kt, k, base, s, k0, T_len, d, vec);
    flash::load_tile_bf16<D, false>(Vs, v, base, s, k0, T_len, d, vec);
    __syncthreads();
    // no mask when every key is live for every row and no row is past T
    const bool mask = k0 + kTile > kv_len || q0 + kTile > T_len ||
                      (causal && k0 + kTile - 1 > q0);
    float sc[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t bf[2];
        flash::load_b<D + 8>(bf, Ks, 8 * nt, 16 * ks, lane);
        flash::mma_16816(sc[nt], qa[ks], bf);
        flash::load_b<D + 8>(bf, Vs, 8 * nt, 16 * ks, lane);
        flash::mma_16816(dp[nt], da[ks], bf);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int qp = q0 + r0 + g + 8 * i;
        const int kp = k0 + 8 * nt + 2 * tq + (e & 1);
        const bool live = !mask || (qp < T_len && kp < kv_len &&
                                    (!causal || kp <= qp));
        const float p =
            live ? __expf(sc[nt][e] * scale - row_lse[i]) : 0.0f;
        sc[nt][e] = p * (dp[nt][e] - row_delta[i]);  // dS
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t sa[4];
      flash::c_to_a(sa, sc, kk);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t bf[2];
        flash::load_b<kTile + 8>(bf, Kt, 8 * n, 16 * kk, lane);
        flash::mma_16816(acc[n], sa, bf);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + 8 * i;
    if (row >= T_len) continue;
    const long long at = dbase + row * ds_.t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = 8 * n + 2 * tq + j;
        if (c < d) dq[at + c] = __float2bfloat16(scale * acc[n][2 * i + j]);
      }
    }
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dq, int B, int T_len, int H, int d,
                       flash::Strides s, int causal, int kv_len, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem = flash::smem_bytes_bf16<D>(2, 1);
  static const cudaError_t opt_in =
      flash::allow_smem(flash_dq_mma_kernel<D>, smem);
  if (opt_in != cudaSuccess) return opt_in;
  dim3 grid;
  const cudaError_t err = flash::grid_of(T_len, kTile, B * H, &grid);
  if (err != cudaSuccess) return err;
  flash_dq_mma_kernel<D><<<grid, flash::kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), lse, delta,
      static_cast<__nv_bfloat16*>(dq), H, T_len, d, s, causal, kv_len, scale,
      flash::rows_aligned16(d, s, q, k, v, dout));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int B, int T_len, int H, int d, flash::Strides s,
                   int causal, int kv_len, float scale, cudaStream_t stream) {
  constexpr int R = flash::rows_fp32<D>();
  constexpr size_t smem = flash::smem_bytes<D, R>(4, 1, 0);
  static const cudaError_t opt_in =
      flash::allow_smem(flash_dq_kernel<D, R>, smem);
  if (opt_in != cudaSuccess) return opt_in;
  dim3 grid;
  const cudaError_t err = flash::grid_of(T_len, R, B * H, &grid);
  if (err != cudaSuccess) return err;
  flash_dq_kernel<D, R><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dq), H, T_len, d, s, causal, kv_len, scale);
  return cudaGetLastError();
}

// fp32 on the CUDA cores, bf16 on the tensor cores, at d's padded width.
cudaError_t dispatch(int dtype, int d, const void* q, const void* k,
                     const void* v, const void* dout, const float* lse,
                     const float* delta, void* dq, int B, int T_len, int H,
                     flash::Strides s, int causal, int kv_len, float scale,
                     cudaStream_t stream) {
  FLASH_PADDED_DIMS(
      d, return dtype == 0
                 ? launch<DP>(q, k, v, dout, lse, delta, dq, B, T_len, H, d,
                              s, causal, kv_len, scale, stream)
                 : launch_mma<DP>(q, k, v, dout, lse, delta, dq, B, T_len,
                                  H, d, s, causal, kv_len, scale, stream))
}

}  // namespace

extern "C" int dvggf_flash_dq(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, void* dq, int B, int T_len,
                              int H, int D, long long sb, long long st,
                              long long sh, int causal, int kv_len,
                              float scale, int dtype, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B < 1 || T_len < 1 || H < 1 || kv_len < 1 || kv_len > T_len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(dispatch(dtype, D, q, k, v, dout, lse, delta, dq,
                                   B, T_len, H, flash::Strides{sb, st, sh},
                                   causal, kv_len, scale,
                                   static_cast<cudaStream_t>(stream)));
}
