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
// block_fwd_mma_kernel), fp32 on the CUDA cores (block_fwd_kernel), as
// flash_fwd.cu does; neither is near the bound (TMA and wgmma are later
// work).
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

template <int D>
__global__ void __launch_bounds__(kThreads)
    block_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* acc_io, float* m_io,
                     float* l_io, int Tq, int Tk, int q_off, int k_off,
                     int causal, int kv_len, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                  // kTile x (D+1)
  float* Ks = Qs + kTile * (D + 1);  // kTile x (D+1)
  float* Vs = Ks + kTile * (D + 1);  // kTile x (D+1)
  float* Ps = Vs + kTile * (D + 1);  // kTile x (kTile+1)
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

  float acc[4][D / 16];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const bool in = row < Tq;
    const long long at = static_cast<long long>(bh) * Tq + row;
    m[i] = in ? m_io[at] : -INFINITY;
    l[i] = in ? l_io[at] : 0.0f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      acc[i][j] = in ? acc_io[at * D + tx + 16 * j] : 0.0f;
    }
  }
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the last tile's readers of Ks, Vs and Ps are done
    flash::load_tile<D>(Ks, k, kbase, ks, k0, Tk);
    flash::load_tile<D>(Vs, v, kbase, ks, k0, Tk);
    __syncthreads();
    float sc[4][4];
    flash::dot_tile<D>(sc, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
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
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_use);
        rs += p;
        Ps[(ty * 4 + i) * (kTile + 1) + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + flash::row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
    flash::accumulate_rows<D>(acc, Ps, Vs, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Tq) continue;
    const long long at = static_cast<long long>(bh) * Tq + row;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc_io[at * D + tx + 16 * j] = acc[i][j];
    if (tx == 0) {
      m_io[at] = m[i];
      l_io[at] = l[i];
    }
  }
}

// The bf16 version of the same function, on the tensor cores, as
// flash_fwd.cu's flash_fwd_mma_kernel: a block of 4 warps owns kTile query
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
                         float* m_io, float* l_io, int Tq, int Tk, int q_off,
                         int k_off, int causal, int kv_len, float scale,
                         bool vec) {
  __shared__ __align__(16) uint16_t Qs[kTile * (D + 8)];
  __shared__ __align__(16) uint16_t Ks[kTile * (D + 8)];
  __shared__ __align__(16) uint16_t Vt[D * (kTile + 8)];
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16;  // this warp's rows of the tile
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
        acc[n][2 * i + j] = in ? acc_io[at * D + 8 * n + 2 * tq + j] : 0.0f;
      }
    }
  }
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the last tile's readers of Ks and Vt are done
    flash::load_tile_bf16<D, false>(Ks, k, kbase, ks, k0, Tk, vec);
    flash::load_tile_bf16<D, true>(Vt, v, kbase, ks, k0, Tk, vec);
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
        acc_io[at * D + 8 * n + 2 * tq + j] = acc[n][2 * i + j];
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
  int BH, Tq, Tk, q_off, k_off, causal, kv_len;
  float scale;
};

template <int D>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.Tq + kTile - 1) / kTile, a.BH);
  block_fwd_mma_kernel<D><<<grid, flash::kMmaThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.acc, a.m, a.l, a.Tq, a.Tk,
      a.q_off, a.k_off, a.causal, a.kv_len, a.scale,
      // every row stride (T*D) is a multiple of 8 values at D = 32 or 64
      flash::rows_aligned16(flash::rows_strides(a.Tq, D), a.q, a.k, a.v));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = flash::smem_bytes<D>(3, 1, 0);
  static const cudaError_t opt_in =
      flash::allow_smem(block_fwd_kernel<D>, smem);
  if (opt_in != cudaSuccess) return opt_in;
  const dim3 grid((a.Tq + kTile - 1) / kTile, a.BH);
  block_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.acc, a.m, a.l, a.Tq, a.Tk, a.q_off,
      a.k_off, a.causal, a.kv_len, a.scale);
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
  const Args a{q, k, v, acc, m, l, BH, Tq, Tk, q_off, k_off, causal, kv_len,
               scale};
  return static_cast<int>(
      dispatch(dtype, D, a, static_cast<cudaStream_t>(stream)));
}
