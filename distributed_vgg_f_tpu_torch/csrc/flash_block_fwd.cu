// Ring block forward for Hopper (sm_90a): fold one visiting K/V block into
// the online-softmax state (acc, m, l) that the caller carries between
// calls.
//
// Replaces the JAX package's Pallas TPU kernel
// ops/flash_attention.py:_ring_fwd_kernel (reached through
// flash_block_update), which parallel/ring_flash.py calls once per ring
// step. For each (b, h) = bh and local query row i, with keys j of the
// visiting block:
//   s_ij   = (q_i . k_j) * scale                      (fp32)
//   masked to -inf where j >= kv_len (block-local), or, when causal,
//   where k_off + j > q_off + i (global positions)
//   m_new  = max(m_i, max_j s_ij)
//   corr   = exp(m_i - m_new), p_ij = exp(s_ij - m_new)
//   l_i    = l_i * corr + sum_j p_ij
//   acc_i  = acc_i * corr + sum_j round(p_ij) v_j      (round: to v's dtype)
//   m_i    = m_new
// The caller finishes with out = acc / l and lse = m + log l.
//
// Bound: at the 4-rank ring's local shape (B*H = 24, Tq = Tk = 2048,
// D = 64) a fold does 4*D FLOP per live pair against the bytes of q, k, v
// and the fp32 state read and written once: ~570 bf16 FLOP a byte, above
// the card's ~295, so the least time is set by the tensor cores' bf16
// rate (~26 us for a fully live block), and by the CUDA cores' fp32 rate
// in fp32. bf16 runs its products on the tensor cores (mma.sync,
// block_fwd_mma_kernel), fp32 on the CUDA cores (block_fwd_kernel), at
// any head dim from 1 to 256 (padded as flash_common.cuh says); neither
// is near the bound (its TMA and wgmma redesign on csrc/hopper.cuh, as
// flash_fwd.cu's, is ROADMAP B7's third step).
//
// Design: the TPU kernel's sequential KV grid axis, with the state in its
// output blocks, becomes a loop inside the block. A block owns kTile query
// rows of one bh: it reads their state from device memory into registers,
// walks the visiting block's K/V tiles through shared memory up to the
// causal bound of its rows (block_key_end: tiles wholly in the rows' future
// are never read), and writes the state back. Each block owns its rows, so
// no atomics are needed, and the state is updated IN PLACE (acc, m and l
// are read and then written by the same thread). A block whose bound is
// <= 0 (every key in its rows' future) leaves its rows untouched. The
// offsets and kv_len are kernel arguments. A row that has seen no live
// key keeps m = -inf, and the rescale uses 0 in its place, so
// -inf - -inf never occurs: unlike the TPU kernel, this one does not rely
// on the ring's first step being the diagonal block.
//
// C interface (ctypes): dvggf_flash_block_fwd returns cudaGetLastError()
// after the launch, 0 on success.

#include "flash_common.cuh"

namespace {

using flash::kThreads;
using flash::kTile;

template <int D, int R>
__global__ void __launch_bounds__(kThreads)
    block_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* acc_io, float* m_io,
                     float* l_io, int Tq, int Tk, int d, int q_off,
                     int k_off, int causal, int kv_len, float scale) {
  constexpr int kR = R / 16;
  float* Qs = flash::dyn_smem<float>();  // R x (D+1)
  float* Ks = Qs + R * (D + 1);           // R x (D+1)
  float* Vs = Ks + R * (D + 1);           // R x (D+1)
  float* Ps = Vs + R * (D + 1);           // R x (R+1)
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

  float acc[kR][D / 16];
  float m[kR], l[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = q0 + ty * kR + i;
    const bool in = row < Tq;
    const long long at = static_cast<long long>(bh) * Tq + row;
    m[i] = in ? m_io[at] : -INFINITY;
    l[i] = in ? l_io[at] : 0.0f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      acc[i][j] =
          in && tx + 16 * j < d ? acc_io[at * d + tx + 16 * j] : 0.0f;
    }
  }
  for (int k0 = 0; k0 < k_end; k0 += R) {
    __syncthreads();  // the last tile's readers of Ks, Vs and Ps are done
    flash::load_tile<D, R>(Ks, k, kbase, ks, k0, Tk, d);
    flash::load_tile<D, R>(Vs, v, kbase, ks, k0, Tk, d);
    __syncthreads();
    float sc[kR][kR];
    flash::dot_tile<D, R>(sc, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int qi = q0 + ty * kR + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const int kj = k0 + tx + 16 * j;
        // rows past Tq count as live here: they are never written back
        const bool live =
            flash::block_live(qi, kj, q_off, k_off, causal, kv_len);
        sc[i][j] = live ? sc[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], flash::row_max(mx));
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;
      const float corr = expf(m[i] - m_use);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const float p = expf(sc[i][j] - m_use);
        rs += p;
        Ps[(ty * kR + i) * (R + 1) + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + flash::row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
    flash::accumulate_rows<D, R>(acc, Ps, Vs, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = q0 + ty * kR + i;
    if (row >= Tq) continue;
    const long long at = static_cast<long long>(bh) * Tq + row;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      if (tx + 16 * j < d) acc_io[at * d + tx + 16 * j] = acc[i][j];
    }
    if (tx == 0) {
      m_io[at] = m[i];
      l_io[at] = l[i];
    }
  }
}

// The bf16 version of the same function, on the tensor cores with
// mma.sync (as flash_dq.cu's kernel): a block of 4 warps owns kTile query
// rows, 16 a warp; Q's fragments stay in registers; each K/V tile is staged
// in shared memory as bf16 (K row-major, V transposed); S, m, l and acc
// stay in registers (acc in the C-fragment layout, read from and written
// back to the fp32 state), and P goes to the P.V product as a fragment
// rounded to bf16.
template <int D>
__global__ void __launch_bounds__(flash::kMmaThreads)
    block_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, float* acc_io,
                         float* m_io, float* l_io, int Tq, int Tk, int d,
                         int q_off, int k_off, int causal, int kv_len,
                         float scale, bool vec) {
  uint16_t* Qs = flash::dyn_smem<uint16_t>();  // kTile x (D+8)
  uint16_t* Ks = Qs + kTile * (D + 8);          // kTile x (D+8)
  uint16_t* Vt = Ks + kTile * (D + 8);          // D x (kTile+8)
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16;  // this warp's rows of the tile
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
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    flash::load_a<D + 8>(qa[kc], Qs, r0, 16 * kc, lane);
  }
  // rows g and g+8 of the warp's 16: state from device memory
  float acc[D / 8][4], m[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + 8 * i;
    const bool in = row < Tq;
    const long long at = static_cast<long long>(bh) * Tq + row;
    m[i] = in ? m_io[at] : -INFINITY;
    l[i] = in ? l_io[at] : 0.0f;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = 8 * n + 2 * tq + j;
        acc[n][2 * i + j] = in && c < d ? acc_io[at * d + c] : 0.0f;
      }
    }
  }
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the last tile's readers of Ks and Vt are done
    flash::load_tile_bf16<D, false>(Ks, k, kbase, ks, k0, Tk, d, vec);
    flash::load_tile_bf16<D, true>(Vt, v, kbase, ks, k0, Tk, d, vec);
    __syncthreads();
    float sc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.0f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t bf[2];
        flash::load_b<D + 8>(bf, Ks, 8 * nt, 16 * kc, lane);
        flash::mma_16816(sc[nt], qa[kc], bf);
      }
    }
    // a tile whose keys are live for every row of the block needs no mask
    const bool mask = k0 + kTile > kv_len ||
                      (causal && k_off + k0 + kTile - 1 > q_off + q0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q0 + r0 + g + (e >= 2 ? 8 : 0);
        const int kj = k0 + 8 * nt + 2 * tq + (e & 1);
        // rows past Tq count as live here: they are never written back
        const bool live = !mask || flash::block_live(qi, kj, q_off, k_off,
                                                     causal, kv_len);
        sc[nt][e] = live ? sc[nt][e] * scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
      }
    }
    // exponentials through the fast ex2 path: ~2 ulp of fp32, far inside
    // the bf16 rounding of p that follows
    float corr[2], m_use[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], flash::quad_max(mx[i]));
      m_use[i] = m_new == -INFINITY ? 0.0f : m_new;
      corr[i] = __expf(m[i] - m_use[i]);
      m[i] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[nt][e] = __expf(sc[nt][e] - m_use[e >> 1]);
        rs[e >> 1] += sc[nt][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + flash::quad_sum(rs[i]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      flash::c_to_a(pa, sc, kk);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t bf[2];
        flash::load_b<kTile + 8>(bf, Vt, 8 * n, 16 * kk, lane);
        flash::mma_16816(acc[n], pa, bf);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + 8 * i;
    if (row >= Tq) continue;
    const long long at = static_cast<long long>(bh) * Tq + row;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = 8 * n + 2 * tq + j;
        if (c < d) acc_io[at * d + c] = acc[n][2 * i + j];
      }
    }
    if (tq == 0) {
      m_io[at] = m[i];
      l_io[at] = l[i];
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  float* acc;
  float* m;
  float* l;
  int BH, Tq, Tk, d, q_off, k_off, causal, kv_len;
  float scale;
};

template <int D>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = flash::smem_bytes_bf16<D>(2, 1);
  static const cudaError_t opt_in =
      flash::allow_smem(block_fwd_mma_kernel<D>, smem);
  if (opt_in != cudaSuccess) return opt_in;
  dim3 grid;
  const cudaError_t err = flash::grid_of(a.Tq, kTile, a.BH, &grid);
  if (err != cudaSuccess) return err;
  block_fwd_mma_kernel<D><<<grid, flash::kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.acc, a.m, a.l, a.Tq, a.Tk,
      a.d, a.q_off, a.k_off, a.causal, a.kv_len, a.scale,
      // row strides Tq*d and Tk*d are multiples of 8 values when d is
      flash::rows_aligned16(a.d, flash::rows_strides(a.Tq, a.d), a.q, a.k,
                            a.v));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int R = flash::rows_fp32<D>();
  constexpr size_t smem = flash::smem_bytes<D, R>(3, 1, 0);
  static const cudaError_t opt_in =
      flash::allow_smem(block_fwd_kernel<D, R>, smem);
  if (opt_in != cudaSuccess) return opt_in;
  dim3 grid;
  const cudaError_t err = flash::grid_of(a.Tq, R, a.BH, &grid);
  if (err != cudaSuccess) return err;
  block_fwd_kernel<D, R><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.acc, a.m, a.l, a.Tq, a.Tk, a.d,
      a.q_off, a.k_off, a.causal, a.kv_len, a.scale);
  return cudaGetLastError();
}

// fp32 on the CUDA cores, bf16 on the tensor cores, at d's padded width.
cudaError_t dispatch(int dtype, const Args& a, cudaStream_t stream) {
  FLASH_PADDED_DIMS(a.d, return dtype == 0 ? launch<DP>(a, stream)
                                           : launch_mma<DP>(a, stream))
}

}  // namespace

extern "C" int dvggf_flash_block_fwd(const void* q, const void* k,
                                     const void* v, float* acc, float* m,
                                     float* l, int BH, int Tq, int Tk, int D,
                                     int q_off, int k_off, int causal,
                                     int kv_len, float scale, int dtype,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (BH < 1 || Tq < 1 || Tk < 1 || kv_len < 1 || kv_len > Tk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q,  k,     v,     acc,   m,      l,      BH,    Tq,
               Tk, D,     q_off, k_off, causal, kv_len, scale};
  return static_cast<int>(
      dispatch(dtype, a, static_cast<cudaStream_t>(stream)));
}
