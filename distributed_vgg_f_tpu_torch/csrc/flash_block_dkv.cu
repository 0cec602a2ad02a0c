// Ring block backward, dK and dV, for Hopper (sm_90a): add this rank's
// contribution to the fp32 dK/dV accumulators that travel the ring with
// the visiting K/V block.
//
// Replaces the JAX package's Pallas TPU kernel
// ops/flash_attention.py:_ring_dkv_kernel (reached through
// flash_block_grads), which parallel/ring_flash.py's backward calls once
// per ring step. From the forward's lse and delta_i = sum_d dO_id * O_id
// (fp32, (B*H, Tq, 1)), for each bh and key j of the visiting block, over
// the local query rows i:
//   s_ij  = (q_i . k_j) * scale, p_ij = exp(s_ij - lse_i)   (0 if masked)
//   dv_j += sum_i round(p_ij) dO_i                         (fp32)
//   ds_ij = p_ij * (dO_i . v_j - delta_i)
//   dk_j += scale * sum_i round(ds_ij) q_i                 (fp32)
// with the masks of flash_block_fwd.cu and round() the casts of p to dO's
// dtype and of dS to q's dtype before the products. A padded key
// (j >= kv_len) gets p = 0 for every query, so its accumulator rows stay
// exactly as they came (zero, when the block's owner started them at zero).
//
// Bound: at the ring's local shape (B*H = 24, Tq = Tk = 2048, D = 64) the
// step does 8*D FLOP per live pair against q, k, v and dO read once, lse
// and delta read once and dk, dv (fp32) read and written once — operations
// set the least time (~52 us in bf16 for a fully live block). bf16 runs
// its products on the tensor cores (block_dkv_mma_kernel), fp32 on the
// CUDA cores (block_dkv_kernel), as flash_dkv.cu does, at any head dim
// from 1 to 256 (padded as flash_common.cuh says).
//
// Design: flash_dkv.cu's transposed loop with the offsets and kv_len as
// arguments: a block owns kTile keys of the visiting block for one bh,
// keeps their k and v in shared memory or registers, and streams the local
// Q tiles (q, dO, lse, delta) through shared memory from the first tile
// whose rows may see its keys (block_query_start); tiles wholly before
// that are never read. A block whose keys are all padding, or all in the
// future of every local row, leaves its rows untouched. It adds its sums
// to dk and dv IN PLACE (each block owns its keys: no atomics).
//
// C interface (ctypes): dvggf_flash_block_dkv returns cudaGetLastError()
// after the launch, 0 on success.

#include "flash_common.cuh"

namespace {

using flash::kThreads;
using flash::kTile;

template <int D, int R>
__global__ void __launch_bounds__(kThreads)
    block_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* dk_io,
                     float* dv_io, int Tq, int Tk, int d, int q_off,
                     int k_off, int causal, int kv_len, float scale) {
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
  const flash::Tile tile = flash::tile_of(R, Tk);
  const int k0 = tile.r0;
  const int bh = tile.bh;
  const int q_start = flash::block_query_start(k0, R, q_off, k_off, causal);
  if (k0 >= kv_len || q_start >= Tq) return;  // no live pair: untouched
  const flash::Strides qs = flash::rows_strides(Tq, d);
  const flash::Strides ks = flash::rows_strides(Tk, d);
  const long long qbase = bh * qs.b;
  const long long kbase = bh * ks.b;

  float dk_acc[kR][D / 16], dv_acc[kR][D / 16];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.0f;
  }
  flash::load_tile<D, R>(Ks, k, kbase, ks, k0, Tk, d);
  flash::load_tile<D, R>(Vs, v, kbase, ks, k0, Tk, d);
  for (int q0 = q_start; q0 < Tq; q0 += R) {
    __syncthreads();  // the last tile's readers of Qs, dOs and Ts are done
    flash::load_tile<D, R>(Qs, q, qbase, qs, q0, Tq, d);
    flash::load_tile<D, R>(dOs, dout, qbase, qs, q0, Tq, d);
    if (threadIdx.x < R) {
      const int row = q0 + threadIdx.x;
      const long long at = static_cast<long long>(bh) * Tq + row;
      lse_s[threadIdx.x] = row < Tq ? lse[at] : 0.0f;
      delta_s[threadIdx.x] = row < Tq ? delta[at] : 0.0f;
    }
    __syncthreads();
    // rows of these tiles are keys (ty*kR+i), columns queries (tx+16j)
    float st[kR][kR], ds[kR][kR];
    flash::dot_tile<D, R>(st, Ks, Qs, ty, tx);
    flash::dot_tile<D, R>(ds, Vs, dOs, ty, tx);  // dP^T, then dS^T
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int kj = k0 + ty * kR + i;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const int c = tx + 16 * j;
        const int qi = q0 + c;
        const bool live = qi < Tq && flash::block_live(qi, kj, q_off, k_off,
                                                       causal, kv_len);
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

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = k0 + ty * kR + i;
    if (row >= Tk) continue;
    const long long at = kbase + static_cast<long long>(row) * d;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      if (tx + 16 * j >= d) continue;
      dk_io[at + tx + 16 * j] += scale * dk_acc[i][j];
      dv_io[at + tx + 16 * j] += dv_acc[i][j];
    }
  }
}

// The bf16 version of the same function, on the tensor cores, as
// flash_dkv.cu's flash_dkv_mma_kernel: a block of 4 warps owns kTile keys,
// 16 a warp, with k's and v's fragments and the dk, dv sums in registers.
// Each Q tile is staged in shared memory as bf16 — q and dO row-major (for
// S^T = K Q^T and dP^T = V dO^T) and transposed (for dK += dS^T Q and
// dV += P^T dO) — and P^T and dS^T go to their products as fragments
// rounded to bf16.
template <int D>
__global__ void __launch_bounds__(flash::kMmaThreads)
    block_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, float* dk_io,
                         float* dv_io, int Tq, int Tk, int d, int q_off,
                         int k_off, int causal, int kv_len, float scale,
                         bool vec) {
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
  const flash::Tile tile = flash::tile_of(kTile, Tk);
  const int k0 = tile.r0;
  const int bh = tile.bh;
  const int q_start =
      flash::block_query_start(k0, kTile, q_off, k_off, causal);
  if (k0 >= kv_len || q_start >= Tq) return;  // no live pair: untouched
  const flash::Strides qs = flash::rows_strides(Tq, d);
  const flash::Strides ks = flash::rows_strides(Tk, d);
  const long long qbase = bh * qs.b;
  const long long kbase = bh * ks.b;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.0f;
  }
  flash::load_tile_bf16<D, false>(Qs, k, kbase, ks, k0, Tk, d, vec);
  flash::load_tile_bf16<D, false>(dOs, v, kbase, ks, k0, Tk, d, vec);
  __syncthreads();
  uint32_t ka[D / 16][4], va[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    flash::load_a<D + 8>(ka[kc], Qs, r0, 16 * kc, lane);
    flash::load_a<D + 8>(va[kc], dOs, r0, 16 * kc, lane);
  }
  for (int q0 = q_start; q0 < Tq; q0 += kTile) {
    __syncthreads();  // fragments loaded; the last tile's readers are done
    flash::load_tile_bf16<D, false>(Qs, q, qbase, qs, q0, Tq, d, vec);
    flash::load_tile_bf16<D, true>(Qt, q, qbase, qs, q0, Tq, d, vec);
    flash::load_tile_bf16<D, false>(dOs, dout, qbase, qs, q0, Tq, d, vec);
    flash::load_tile_bf16<D, true>(dOt, dout, qbase, qs, q0, Tq, d, vec);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      const long long at = static_cast<long long>(bh) * Tq + row;
      lse_s[threadIdx.x] = row < Tq ? lse[at] : 0.0f;
      delta_s[threadIdx.x] = row < Tq ? delta[at] : 0.0f;
    }
    __syncthreads();
    // rows of these C tiles are keys, columns queries; no mask when every
    // pair is live and no query is past Tq
    const bool mask = k0 + kTile > kv_len || q0 + kTile > Tq ||
                      (causal && k_off + k0 + kTile - 1 > q_off + q0);
    float pt[8][4], dst[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) pt[nt][e] = dst[nt][e] = 0.0f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t bf[2];
        flash::load_b<D + 8>(bf, Qs, 8 * nt, 16 * kc, lane);
        flash::mma_16816(pt[nt], ka[kc], bf);
        flash::load_b<D + 8>(bf, dOs, 8 * nt, 16 * kc, lane);
        flash::mma_16816(dst[nt], va[kc], bf);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + r0 + g + 8 * (e >> 1);
        const int c = 8 * nt + 2 * tq + (e & 1);
        const int qi = q0 + c;
        const bool live =
            !mask || (qi < Tq && flash::block_live(qi, kj, q_off, k_off,
                                                   causal, kv_len));
        const float p = live ? __expf(pt[nt][e] * scale - lse_s[c]) : 0.0f;
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

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + r0 + g + 8 * i;
    if (row >= Tk) continue;
    const long long at = kbase + static_cast<long long>(row) * d;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = 8 * n + 2 * tq + j;
        if (c >= d) continue;
        dk_io[at + c] += scale * dk_acc[n][2 * i + j];
        dv_io[at + c] += dv_acc[n][2 * i + j];
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
  float* dk;
  float* dv;
  int BH, Tq, Tk, d, q_off, k_off, causal, kv_len;
  float scale;
};

template <int D>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  constexpr size_t smem =
      flash::smem_bytes_bf16<D>(2, 2) + 2 * kTile * sizeof(float);
  static const cudaError_t opt_in =
      flash::allow_smem(block_dkv_mma_kernel<D>, smem);
  if (opt_in != cudaSuccess) return opt_in;
  dim3 grid;
  const cudaError_t err = flash::grid_of(a.Tk, kTile, a.BH, &grid);
  if (err != cudaSuccess) return err;
  block_dkv_mma_kernel<D><<<grid, flash::kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.dout), a.lse, a.delta, a.dk, a.dv,
      a.Tq, a.Tk, a.d, a.q_off, a.k_off, a.causal, a.kv_len, a.scale,
      // row strides Tq*d and Tk*d are multiples of 8 values when d is
      flash::rows_aligned16(a.d, flash::rows_strides(a.Tq, a.d), a.q, a.k,
                            a.v, a.dout));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int R = flash::rows_fp32<D>();
  constexpr size_t smem = flash::smem_bytes<D, R>(4, 1, 2);
  static const cudaError_t opt_in =
      flash::allow_smem(block_dkv_kernel<D, R>, smem);
  if (opt_in != cudaSuccess) return opt_in;
  dim3 grid;
  const cudaError_t err = flash::grid_of(a.Tk, R, a.BH, &grid);
  if (err != cudaSuccess) return err;
  block_dkv_kernel<D, R><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, a.dk, a.dv, a.Tq, a.Tk, a.d, a.q_off, a.k_off,
      a.causal, a.kv_len, a.scale);
  return cudaGetLastError();
}

// fp32 on the CUDA cores, bf16 on the tensor cores, at d's padded width.
cudaError_t dispatch(int dtype, const Args& a, cudaStream_t stream) {
  FLASH_PADDED_DIMS(a.d, return dtype == 0 ? launch<DP>(a, stream)
                                           : launch_mma<DP>(a, stream))
}

}  // namespace

extern "C" int dvggf_flash_block_dkv(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* delta,
                                     float* dk, float* dv, int BH, int Tq,
                                     int Tk, int D, int q_off, int k_off,
                                     int causal, int kv_len, float scale,
                                     int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (BH < 1 || Tq < 1 || Tk < 1 || kv_len < 1 || kv_len > Tk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q,  k,  v,  dout,  lse,   delta,  dk,     dv,   BH,
               Tq, Tk, D,  q_off, k_off, causal, kv_len, scale};
  return static_cast<int>(
      dispatch(dtype, a, static_cast<cudaStream_t>(stream)));
}
