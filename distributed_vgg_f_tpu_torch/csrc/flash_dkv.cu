// Flash attention backward, dK and dV, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// ops/flash_attention.py:_dkv_kernel (with _dkv_update). From the
// forward's residuals (q, k, v, lse), dO and delta_i = sum_d dO_id * O_id
// (fp32, computed by the caller), for each (b, h) and key row j:
//   s_ij  = (q_i . k_j) * scale, p_ij = exp(s_ij - lse_i)   (0 if masked)
//   dv_j  = sum_i round(p_ij) dO_i                       (in v's dtype)
//   ds_ij = p_ij * (dO_i . v_j - delta_i)
//   dk_j  = scale * sum_i round(ds_ij) q_i               (in k's dtype)
// with the forward's masks (j >= kv_len; j > i when causal) and round()
// the casts of p to dO's dtype and of dS to q's dtype before the products.
// A masked key gets p = 0 for every query, so dk and dv are exactly 0.
//
// Bound: device-memory bytes (q, k, v and dO read and dk and dv written,
// 12*D bytes a row in bf16, against 8*T*D FLOP a row: ~131 FLOP a byte at
// T = 197, below the card's ~295). bf16 runs the products on the tensor
// cores (flash_dkv_mma_kernel), fp32 on the CUDA cores (flash_dkv_kernel),
// at any head dim from 1 to 256 (padded as flash_common.cuh says).
//
// Design: the transposed loop of the dQ kernel, as the TPU kernel runs
// the transposed grid. A block owns kTile key rows of one (b, h): their k
// and v stay in shared memory, dk and dv accumulate in registers, and the
// Q tiles (q, dO, lse, delta) stream through shared memory. P^T and then
// dS^T of the step go through one shared tile. Under causal masking the Q
// tiles wholly before the block's first key are skipped; a block whose
// keys all lie at or past kv_len writes zeros and stops.
//
// C interface (ctypes): dvggf_flash_dkv returns cudaGetLastError() after
// the launch, 0 on success.

#include "flash_common.cuh"

namespace {

using flash::kThreads;
using flash::kTile;

template <int D, int R>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int T_len, int d,
                     flash::Strides s, int causal, int kv_len, float scale) {
  constexpr int kR = R / 16;
  float* Ks = flash::dyn_smem<float>();  // R x (D+1)
  float* Vs = Ks + R * (D + 1);           // R x (D+1)
  float* Qs = Vs + R * (D + 1);           // R x (D+1)
  float* dOs = Qs + R * (D + 1);          // R x (D+1)
  float* Ts = dOs + R * (D + 1);          // R x (R+1): P^T, then dS^T
  float* lse_s = Ts + R * (R + 1);        // R
  float* delta_s = lse_s + R;             // R
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const flash::Tile tile = flash::tile_of(R, T_len);
  const int k0 = tile.r0;
  const int bh = tile.bh;
  const int b = bh / H;
  const int h = bh % H;
  const long long base = b * s.b + h * s.h;
  const flash::Strides ds_ = flash::dense_strides(T_len, H, d);
  const long long dbase = b * ds_.b + h * ds_.h;

  float dk_acc[kR][D / 16], dv_acc[kR][D / 16];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.0f;
  }
  if (k0 < kv_len) {
    flash::load_tile<D, R>(Ks, k, base, s, k0, T_len, d);
    flash::load_tile<D, R>(Vs, v, base, s, k0, T_len, d);
    // causal: query rows before k0 see none of these keys
    const int q_start = causal ? k0 : 0;
    for (int q0 = q_start; q0 < T_len; q0 += R) {
      __syncthreads();  // the last tile's readers of Qs, dOs and Ts are done
      flash::load_tile<D, R>(Qs, q, base, s, q0, T_len, d);
      flash::load_tile<D, R>(dOs, dout, dbase, ds_, q0, T_len, d);
      if (threadIdx.x < R) {
        const int row = q0 + threadIdx.x;
        const long long at = static_cast<long long>(bh) * T_len + row;
        lse_s[threadIdx.x] = row < T_len ? lse[at] : 0.0f;
        delta_s[threadIdx.x] = row < T_len ? delta[at] : 0.0f;
      }
      __syncthreads();
      // rows of these tiles are keys (ty*kR+i), columns queries (tx+16j)
      float st[kR][kR], ds[kR][kR];
      flash::dot_tile<D, R>(st, Ks, Qs, ty, tx);
      flash::dot_tile<D, R>(ds, Vs, dOs, ty, tx);  // dP^T, then dS^T
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int kp = k0 + ty * kR + i;
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          const int c = tx + 16 * j;
          const int qp = q0 + c;
          const bool live =
              qp < T_len && kp < kv_len && (!causal || kp <= qp);
          const float p = live ? expf(st[i][j] * scale - lse_s[c]) : 0.0f;
          ds[i][j] = p * (ds[i][j] - delta_s[c]);
          Ts[(ty * kR + i) * (R + 1) + c] = p;
        }
      }
      __syncthreads();
      flash::accumulate_rows<D, R>(dv_acc, Ts, dOs, ty, tx);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kR; ++i) {
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          Ts[(ty * kR + i) * (R + 1) + tx + 16 * j] = ds[i][j];
        }
      }
      __syncthreads();
      flash::accumulate_rows<D, R>(dk_acc, Ts, Qs, ty, tx);
    }
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = k0 + ty * kR + i;
    if (row >= T_len) continue;
    const long long at = dbase + row * ds_.t;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      if (tx + 16 * j >= d) continue;
      dk[at + tx + 16 * j] = scale * dk_acc[i][j];
      dv[at + tx + 16 * j] = dv_acc[i][j];
    }
  }
}

// The bf16 version of the same function, on the tensor cores: a
// block of 4 warps owns kTile key rows, 16 a warp, with k's and v's
// fragments and dk, dv in registers. Each Q tile is staged in shared
// memory as bf16 — q and dO row-major (for S^T = K Q^T and dP^T = V dO^T)
// and transposed (for dK += dS^T Q and dV += P^T dO) — and P^T and dS^T go
// to their products as fragments rounded to bf16.
template <int D>
__global__ void __launch_bounds__(flash::kMmaThreads)
    flash_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int H, int T_len,
                         int d, flash::Strides s, int causal, int kv_len,
                         float scale, bool vec) {
  uint16_t* Qs = flash::dyn_smem<uint16_t>();  // kTile x (D+8), K first
  uint16_t* dOs = Qs + kTile * (D + 8);         // kTile x (D+8), V first
  uint16_t* Qt = dOs + kTile * (D + 8);         // D x (kTile+8)
  uint16_t* dOt = Qt + D * (kTile + 8);         // D x (kTile+8)
  float* lse_s = reinterpret_cast<float*>(dOt + D * (kTile + 8));  // kTile
  float* delta_s = lse_s + kTile;                                  // kTile
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16;
  const int g = lane / 4;
  const int tq = lane % 4;
  const flash::Tile tile = flash::tile_of(kTile, T_len);
  const int k0 = tile.r0;
  const int bh = tile.bh;
  const int b = bh / H;
  const int h = bh % H;
  const long long base = b * s.b + h * s.h;
  const flash::Strides ds_ = flash::dense_strides(T_len, H, d);
  const long long dbase = b * ds_.b + h * ds_.h;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.0f;
  }
  if (k0 < kv_len) {
    flash::load_tile_bf16<D, false>(Qs, k, base, s, k0, T_len, d, vec);
    flash::load_tile_bf16<D, false>(dOs, v, base, s, k0, T_len, d, vec);
    __syncthreads();
    uint32_t ka[D / 16][4], va[D / 16][4];
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      flash::load_a<D + 8>(ka[ks], Qs, r0, 16 * ks, lane);
      flash::load_a<D + 8>(va[ks], dOs, r0, 16 * ks, lane);
    }
    const int q_start = causal ? k0 : 0;
    for (int q0 = q_start; q0 < T_len; q0 += kTile) {
      __syncthreads();  // fragments loaded; the last tile's readers are done
      flash::load_tile_bf16<D, false>(Qs, q, base, s, q0, T_len, d, vec);
      flash::load_tile_bf16<D, true>(Qt, q, base, s, q0, T_len, d, vec);
      flash::load_tile_bf16<D, false>(dOs, dout, dbase, ds_, q0, T_len, d,
                                      vec);
      flash::load_tile_bf16<D, true>(dOt, dout, dbase, ds_, q0, T_len, d,
                                     vec);
      if (threadIdx.x < kTile) {
        const int row = q0 + threadIdx.x;
        const long long at = static_cast<long long>(bh) * T_len + row;
        lse_s[threadIdx.x] = row < T_len ? lse[at] : 0.0f;
        delta_s[threadIdx.x] = row < T_len ? delta[at] : 0.0f;
      }
      __syncthreads();
      // rows of these C tiles are keys, columns queries; no mask when
      // every pair is live and no query is past T
      const bool mask = k0 + kTile > kv_len || q0 + kTile > T_len ||
                        (causal && k0 + kTile - 1 > q0);
      float pt[8][4], dst[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) pt[nt][e] = dst[nt][e] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          uint32_t bf[2];
          flash::load_b<D + 8>(bf, Qs, 8 * nt, 16 * ks, lane);
          flash::mma_16816(pt[nt], ka[ks], bf);
          flash::load_b<D + 8>(bf, dOs, 8 * nt, 16 * ks, lane);
          flash::mma_16816(dst[nt], va[ks], bf);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + r0 + g + 8 * (e >> 1);
          const int c = 8 * nt + 2 * tq + (e & 1);
          const int qp = q0 + c;
          const bool live = !mask || (qp < T_len && kp < kv_len &&
                                      (!causal || kp <= qp));
          const float p =
              live ? __expf(pt[nt][e] * scale - lse_s[c]) : 0.0f;
          pt[nt][e] = p;
          dst[nt][e] = p * (dst[nt][e] - delta_s[c]);  // dS^T
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t pa[4], sa[4];
        flash::c_to_a(pa, pt, kk);
        flash::c_to_a(sa, dst, kk);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          uint32_t bf[2];
          flash::load_b<kTile + 8>(bf, dOt, 8 * n, 16 * kk, lane);
          flash::mma_16816(dv_acc[n], pa, bf);
          flash::load_b<kTile + 8>(bf, Qt, 8 * n, 16 * kk, lane);
          flash::mma_16816(dk_acc[n], sa, bf);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + r0 + g + 8 * i;
    if (row >= T_len) continue;
    const long long at = dbase + row * ds_.t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = 8 * n + 2 * tq + j;
        if (c >= d) continue;
        dk[at + c] = __float2bfloat16(scale * dk_acc[n][2 * i + j]);
        dv[at + c] = __float2bfloat16(dv_acc[n][2 * i + j]);
      }
    }
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int B, int T_len, int H, int d,
                       flash::Strides s, int causal, int kv_len, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem =
      flash::smem_bytes_bf16<D>(2, 2) + 2 * kTile * sizeof(float);
  static const cudaError_t opt_in =
      flash::allow_smem(flash_dkv_mma_kernel<D>, smem);
  if (opt_in != cudaSuccess) return opt_in;
  dim3 grid;
  const cudaError_t err = flash::grid_of(T_len, kTile, B * H, &grid);
  if (err != cudaSuccess) return err;
  flash_dkv_mma_kernel<D><<<grid, flash::kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), lse, delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H,
      T_len, d, s, causal, kv_len, scale,
      flash::rows_aligned16(d, s, q, k, v, dout));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, int B, int T_len, int H, int d,
                   flash::Strides s, int causal, int kv_len, float scale,
                   cudaStream_t stream) {
  constexpr int R = flash::rows_fp32<D>();
  constexpr size_t smem = flash::smem_bytes<D, R>(4, 1, 2);
  static const cudaError_t opt_in =
      flash::allow_smem(flash_dkv_kernel<D, R>, smem);
  if (opt_in != cudaSuccess) return opt_in;
  dim3 grid;
  const cudaError_t err = flash::grid_of(T_len, R, B * H, &grid);
  if (err != cudaSuccess) return err;
  flash_dkv_kernel<D, R><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dk), static_cast<float*>(dv), H, T_len, d, s,
      causal, kv_len, scale);
  return cudaGetLastError();
}

// fp32 on the CUDA cores, bf16 on the tensor cores, at d's padded width.
cudaError_t dispatch(int dtype, int d, const void* q, const void* k,
                     const void* v, const void* dout, const float* lse,
                     const float* delta, void* dk, void* dv, int B,
                     int T_len, int H, flash::Strides s, int causal,
                     int kv_len, float scale, cudaStream_t stream) {
  FLASH_PADDED_DIMS(
      d, return dtype == 0
                 ? launch<DP>(q, k, v, dout, lse, delta, dk, dv, B, T_len, H,
                              d, s, causal, kv_len, scale, stream)
                 : launch_mma<DP>(q, k, v, dout, lse, delta, dk, dv, B,
                                  T_len, H, d, s, causal, kv_len, scale,
                                  stream))
}

}  // namespace

extern "C" int dvggf_flash_dkv(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, void* dk, void* dv, int B,
                               int T_len, int H, int D, long long sb,
                               long long st, long long sh, int causal,
                               int kv_len, float scale, int dtype,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B < 1 || T_len < 1 || H < 1 || kv_len < 1 || kv_len > T_len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(dispatch(dtype, D, q, k, v, dout, lse, delta, dk,
                                   dv, B, T_len, H,
                                   flash::Strides{sb, st, sh}, causal,
                                   kv_len, scale,
                                   static_cast<cudaStream_t>(stream)));
}
