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
// on the CUDA cores (block_dq_kernel), as flash_dq.cu does.
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

template <int D>
__global__ void __launch_bounds__(kThreads)
    block_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* dq_io, int Tq,
                    int Tk, int q_off, int k_off, int causal, int kv_len,
                    float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                   // kTile x (D+1)
  float* dOs = Qs + kTile * (D + 1);  // kTile x (D+1)
  float* Ks = dOs + kTile * (D + 1);  // kTile x (D+1)
  float* Vs = Ks + kTile * (D + 1);   // kTile x (D+1)
  float* dSs = Vs + kTile * (D + 1);  // kTile x (kTile+1)
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int q0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const int k_end =
      flash::block_key_end(q0, Tq, q_off, k_off, causal, kv_len);
  if (k_end <= 0) return;  // every key lies in these rows' future
  const flash::Strides qs = flash::rows_strides(Tq, D);
  const flash::Strides ks = flash::rows_strides(Tk, D);
  const long long qbase = bh * qs.b;
  const long long kbase = bh * ks.b;
  flash::load_tile<D>(Qs, q, qbase, qs, q0, Tq);
  flash::load_tile<D>(dOs, dout, qbase, qs, q0, Tq);

  float row_lse[4], row_delta[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const long long at = static_cast<long long>(bh) * Tq + row;
    row_lse[i] = row < Tq ? lse[at] : 0.0f;
    row_delta[i] = row < Tq ? delta[at] : 0.0f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.0f;
  }
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the last tile's readers of Ks, Vs and dSs are done
    flash::load_tile<D>(Ks, k, kbase, ks, k0, Tk);
    flash::load_tile<D>(Vs, v, kbase, ks, k0, Tk);
    __syncthreads();
    float sc[4][4], dp[4][4];
    flash::dot_tile<D>(sc, Qs, Ks, ty, tx);
    flash::dot_tile<D>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool live = qi < Tq && flash::block_live(qi, kj, q_off, k_off,
                                                       causal, kv_len);
        const float p = live ? expf(sc[i][j] * scale - row_lse[i]) : 0.0f;
        dSs[(ty * 4 + i) * (kTile + 1) + tx + 16 * j] =
            p * (dp[i][j] - row_delta[i]);
      }
    }
    __syncthreads();
    flash::accumulate_rows<D>(acc, dSs, Ks, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Tq) continue;
    const long long at = qbase + static_cast<long long>(row) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      dq_io[at + tx + 16 * j] += scale * acc[i][j];
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
                        int Tq, int Tk, int q_off, int k_off, int causal,
                        int kv_len, float scale, bool vec) {
  __shared__ __align__(16) uint16_t Qs[kTile * (D + 8)];   // then K
  __shared__ __align__(16) uint16_t dOs[kTile * (D + 8)];  // then V
  __shared__ __align__(16) uint16_t Kt[D * (kTile + 8)];
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int q0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const int k_end =
      flash::block_key_end(q0, Tq, q_off, k_off, causal, kv_len);
  if (k_end <= 0) return;  // every key lies in these rows' future
  const flash::Strides qs = flash::rows_strides(Tq, D);
  const flash::Strides ks = flash::rows_strides(Tk, D);
  const long long qbase = bh * qs.b;
  const long long kbase = bh * ks.b;
  flash::load_tile_bf16<D, false>(Qs, q, qbase, qs, q0, Tq, vec);
  flash::load_tile_bf16<D, false>(dOs, dout, qbase, qs, q0, Tq, vec);
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
    flash::load_tile_bf16<D, false>(Ks, k, kbase, ks, k0, Tk, vec);
    flash::load_tile_bf16<D, true>(Kt, k, kbase, ks, k0, Tk, vec);
    flash::load_tile_bf16<D, false>(Vs, v, kbase, ks, k0, Tk, vec);
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
    const long long at = qbase + static_cast<long long>(row) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        dq_io[at + 8 * n + 2 * tq + j] += scale * acc[n][2 * i + j];
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
  int BH, Tq, Tk, q_off, k_off, causal, kv_len;
  float scale;
};

template <int D>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.Tq + kTile - 1) / kTile, a.BH);
  block_dq_mma_kernel<D><<<grid, flash::kMmaThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.dout), a.lse, a.delta, a.dq, a.Tq,
      a.Tk, a.q_off, a.k_off, a.causal, a.kv_len, a.scale,
      // every row stride (T*D) is a multiple of 8 values at D = 32 or 64
      flash::rows_aligned16(flash::rows_strides(a.Tq, D), a.q, a.k, a.v,
                            a.dout));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = flash::smem_bytes<D>(4, 1, 0);
  static const cudaError_t opt_in =
      flash::allow_smem(block_dq_kernel<D>, smem);
  if (opt_in != cudaSuccess) return opt_in;
  const dim3 grid((a.Tq + kTile - 1) / kTile, a.BH);
  block_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, a.dq, a.Tq, a.Tk, a.q_off, a.k_off, a.causal,
      a.kv_len, a.scale);
  return cudaGetLastError();
}

// fp32 on the CUDA cores, bf16 on the tensor cores; D = 32 or 64.
cudaError_t dispatch(int dtype, int D, const Args& a, cudaStream_t stream) {
  if (dtype == 0 && D == 32) return launch<32>(a, stream);
  if (dtype == 0 && D == 64) return launch<64>(a, stream);
  if (dtype == 1 && D == 32) return launch_mma<32>(a, stream);
  if (dtype == 1 && D == 64) return launch_mma<64>(a, stream);
  return cudaErrorInvalidValue;
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
  const Args a{q, k, v, dout, lse, delta, dq, BH, Tq, Tk, q_off, k_off,
               causal, kv_len, scale};
  return static_cast<int>(
      dispatch(dtype, D, a, static_cast<cudaStream_t>(stream)));
}
