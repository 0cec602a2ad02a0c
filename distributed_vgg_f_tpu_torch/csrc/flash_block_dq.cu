// Ring block backward, dQ, for Hopper (sm_90a): add one visiting K/V
// block's contribution to the fp32 dQ accumulator of the local rows.
//
// Replaces the JAX package's Pallas TPU kernel
// ops/flash_attention.py:_ring_dq_kernel (reached through
// flash_block_grads), which parallel/ring_flash.py's backward calls once
// per ring step. From the forward's lse and delta_i = sum_d dO_id * O_id
// (both fp32, (B*H, Tq, 1)), for each bh and local query row i, with keys
// j of the visiting block:
//   s_ij  = (q_i . k_j) * scale, p_ij = exp(s_ij - lse_i)   (0 if masked)
//   ds_ij = p_ij * (dO_i . v_j - delta_i)
//   dq_i += scale * sum_j round(ds_ij) k_j                  (fp32)
// with the masks of flash_block_fwd.cu (j >= kv_len, block-local; when
// causal, k_off + j > q_off + i by global position) and round() the cast
// of dS to k's dtype before the product.
//
// Bound: at the ring's local shape (B*H = 24, Tq = Tk = 2048, D = 64) the
// step does 6*D FLOP per live pair against q, k, v and dO read once, lse
// and delta read once and dq (fp32) read and written once — operations,
// not bytes, set the least time (~39 us in bf16 for a fully live block).
// bf16 runs its products on the tensor cores (block_dq_mma_kernel), fp32
// on the CUDA cores (block_dq_kernel), as flash_dq.cu does, at any head
// dim from 1 to 256 (padded as flash_common.cuh says).
//
// Design: flash_dq.cu's loop with the offsets and kv_len as arguments: a
// block owns kTile query rows of one bh, keeps q, dO, lse and delta in
// shared memory or registers, and streams the visiting block's K/V tiles
// through shared memory up to its rows' causal bound (block_key_end); a
// block whose bound is <= 0 leaves its rows untouched. It adds its sum to
// dq IN PLACE (each block owns its rows: no atomics). Masked pairs get
// p = 0 explicitly, so lse = -inf (a row with no live key) gives no NaN.
//
// C interface (ctypes): dvggf_flash_block_dq returns cudaGetLastError()
// after the launch, 0 on success.

#include "flash_common.cuh"

namespace {

using flash::kThreads;
using flash::kTile;

template <int D, int R>
__global__ void __launch_bounds__(kThreads)
    block_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* dq_io, int Tq,
                    int Tk, int d, int q_off, int k_off, int causal,
                    int kv_len, float scale) {
  constexpr int kR = R / 16;
  float* Qs = flash::dyn_smem<float>();  // R x (D+1)
  float* dOs = Qs + R * (D + 1);          // R x (D+1)
  float* Ks = dOs + R * (D + 1);          // R x (D+1)
  float* Vs = Ks + R * (D + 1);           // R x (D+1)
  float* dSs = Vs + R * (D + 1);          // R x (R+1)
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const flash::Tile tile = flash::tile_of(R, Tq);
  const int q0 = tile.r0;
  const int bh = tile.bh;
  const int k_end =
      flash::block_key_end(q0, R, Tq, q_off, k_off, causal, kv_len);
  if (k_end <= 0) return;  // every key lies in these rows' future
  const flash::Strides qs = flash::rows_strides(Tq, d);
  const flash::Strides ks = flash::rows_strides(Tk, d);
  const long long qbase = bh * qs.b;
  const long long kbase = bh * ks.b;
  flash::load_tile<D, R>(Qs, q, qbase, qs, q0, Tq, d);
  flash::load_tile<D, R>(dOs, dout, qbase, qs, q0, Tq, d);

  float row_lse[kR], row_delta[kR], acc[kR][D / 16];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = q0 + ty * kR + i;
    const long long at = static_cast<long long>(bh) * Tq + row;
    row_lse[i] = row < Tq ? lse[at] : 0.0f;
    row_delta[i] = row < Tq ? delta[at] : 0.0f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.0f;
  }
  for (int k0 = 0; k0 < k_end; k0 += R) {
    __syncthreads();  // the last tile's readers of Ks, Vs and dSs are done
    flash::load_tile<D, R>(Ks, k, kbase, ks, k0, Tk, d);
    flash::load_tile<D, R>(Vs, v, kbase, ks, k0, Tk, d);
    __syncthreads();
    float sc[kR][kR], dp[kR][kR];
    flash::dot_tile<D, R>(sc, Qs, Ks, ty, tx);
    flash::dot_tile<D, R>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int qi = q0 + ty * kR + i;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool live = qi < Tq && flash::block_live(qi, kj, q_off, k_off,
                                                       causal, kv_len);
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
    if (row >= Tq) continue;
    const long long at = qbase + static_cast<long long>(row) * d;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      if (tx + 16 * j < d) dq_io[at + tx + 16 * j] += scale * acc[i][j];
    }
  }
}

// The bf16 version of the same function, on the tensor cores, as
// flash_dq.cu's flash_dq_mma_kernel: a block of 4 warps owns kTile query
// rows, 16 a warp, with q's and dO's fragments, lse, delta and the dq sum
// in registers. Each K/V tile is staged in shared memory as bf16 — K
// row-major (for S = Q K^T) and transposed (for dQ += dS K), V row-major
// (for dP = dO V^T) — and dS goes to the dQ product as a fragment rounded
// to bf16.
template <int D>
__global__ void __launch_bounds__(flash::kMmaThreads)
    block_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, float* dq_io,
                        int Tq, int Tk, int d, int q_off, int k_off,
                        int causal, int kv_len, float scale, bool vec) {
  uint16_t* Qs = flash::dyn_smem<uint16_t>();  // kTile x (D+8), then K
  uint16_t* dOs = Qs + kTile * (D + 8);         // kTile x (D+8), then V
  uint16_t* Kt = dOs + kTile * (D + 8);         // D x (kTile+8)
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16;
  const int g = lane / 4;
  const int tq = lane % 4;
  const flash::Tile tile = flash::tile_of(kTile, Tq);
  const int q0 = tile.r0;
  const int bh = tile.bh;
  const int k_end =
      flash::block_key_end(q0, kTile, Tq, q_off, k_off, causal, kv_len);
  if (k_end <= 0) return;  // every key lies in these rows' future
  const flash::Strides qs = flash::rows_strides(Tq, d);
  const flash::Strides ks = flash::rows_strides(Tk, d);
  const long long qbase = bh * qs.b;
  const long long kbase = bh * ks.b;
  flash::load_tile_bf16<D, false>(Qs, q, qbase, qs, q0, Tq, d, vec);
  flash::load_tile_bf16<D, false>(dOs, dout, qbase, qs, q0, Tq, d, vec);
  __syncthreads();
  uint32_t qa[D / 16][4], da[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    flash::load_a<D + 8>(qa[kc], Qs, r0, 16 * kc, lane);
    flash::load_a<D + 8>(da[kc], dOs, r0, 16 * kc, lane);
  }
  float row_lse[2], row_delta[2], acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + 8 * i;
    const long long at = static_cast<long long>(bh) * Tq + row;
    row_lse[i] = row < Tq ? lse[at] : 0.0f;
    row_delta[i] = row < Tq ? delta[at] : 0.0f;
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  }
  uint16_t* Ks = Qs;
  uint16_t* Vs = dOs;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // fragments loaded; the last tile's readers are done
    flash::load_tile_bf16<D, false>(Ks, k, kbase, ks, k0, Tk, d, vec);
    flash::load_tile_bf16<D, true>(Kt, k, kbase, ks, k0, Tk, d, vec);
    flash::load_tile_bf16<D, false>(Vs, v, kbase, ks, k0, Tk, d, vec);
    __syncthreads();
    // no mask when every key is live for every row and no row is past Tq
    const bool mask = k0 + kTile > kv_len || q0 + kTile > Tq ||
                      (causal && k_off + k0 + kTile - 1 > q_off + q0);
    float sc[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.0f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t bf[2];
        flash::load_b<D + 8>(bf, Ks, 8 * nt, 16 * kc, lane);
        flash::mma_16816(sc[nt], qa[kc], bf);
        flash::load_b<D + 8>(bf, Vs, 8 * nt, 16 * kc, lane);
        flash::mma_16816(dp[nt], da[kc], bf);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int qi = q0 + r0 + g + 8 * i;
        const int kj = k0 + 8 * nt + 2 * tq + (e & 1);
        const bool live =
            !mask || (qi < Tq && flash::block_live(qi, kj, q_off, k_off,
                                                   causal, kv_len));
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
    if (row >= Tq) continue;
    const long long at = qbase + static_cast<long long>(row) * d;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = 8 * n + 2 * tq + j;
        if (c < d) dq_io[at + c] += scale * acc[n][2 * i + j];
      }
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  float* dq;
  int BH, Tq, Tk, d, q_off, k_off, causal, kv_len;
  float scale;
};

template <int D>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = flash::smem_bytes_bf16<D>(2, 1);
  static const cudaError_t opt_in =
      flash::allow_smem(block_dq_mma_kernel<D>, smem);
  if (opt_in != cudaSuccess) return opt_in;
  dim3 grid;
  const cudaError_t err = flash::grid_of(a.Tq, kTile, a.BH, &grid);
  if (err != cudaSuccess) return err;
  block_dq_mma_kernel<D><<<grid, flash::kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.dout), a.lse, a.delta, a.dq, a.Tq,
      a.Tk, a.d, a.q_off, a.k_off, a.causal, a.kv_len, a.scale,
      // row strides Tq*d and Tk*d are multiples of 8 values when d is
      flash::rows_aligned16(a.d, flash::rows_strides(a.Tq, a.d), a.q, a.k,
                            a.v, a.dout));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int R = flash::rows_fp32<D>();
  constexpr size_t smem = flash::smem_bytes<D, R>(4, 1, 0);
  static const cudaError_t opt_in =
      flash::allow_smem(block_dq_kernel<D, R>, smem);
  if (opt_in != cudaSuccess) return opt_in;
  dim3 grid;
  const cudaError_t err = flash::grid_of(a.Tq, R, a.BH, &grid);
  if (err != cudaSuccess) return err;
  block_dq_kernel<D, R><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, a.dq, a.Tq, a.Tk, a.d, a.q_off, a.k_off, a.causal,
      a.kv_len, a.scale);
  return cudaGetLastError();
}

// fp32 on the CUDA cores, bf16 on the tensor cores, at d's padded width.
cudaError_t dispatch(int dtype, const Args& a, cudaStream_t stream) {
  FLASH_PADDED_DIMS(a.d, return dtype == 0 ? launch<DP>(a, stream)
                                           : launch_mma<DP>(a, stream))
}

}  // namespace

extern "C" int dvggf_flash_block_dq(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* delta,
                                    float* dq, int BH, int Tq, int Tk, int D,
                                    int q_off, int k_off, int causal,
                                    int kv_len, float scale, int dtype,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (BH < 1 || Tq < 1 || Tk < 1 || kv_len < 1 || kv_len > Tk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q,  k,  v,     dout,  lse,    delta,  dq,   BH,
               Tq, Tk, D,     q_off, k_off,  causal, kv_len, scale};
  return static_cast<int>(
      dispatch(dtype, a, static_cast<cudaStream_t>(stream)));
}
