// Flash attention forward for Hopper (sm_90a): O and the row logsumexp.
//
// Replaces the JAX package's Pallas TPU kernel
// ops/flash_attention.py:_fwd_kernel (with _fwd_update and _fwd_finish).
// For each (b, h) and query row i:
//   s_ij = (q_i . k_j) * scale                  (fp32)
//   masked to -inf where j >= kv_len, or j > i when causal
//   m_i = max_j s_ij, l_i = sum_j exp(s_ij - m_i)
//   o_i = sum_j round(exp(s_ij - m_i)) v_j / l_i  (stored in q's dtype)
//   lse_i = m_i + log(l_i)                      (fp32, (B, H, T))
// where round() is the cast of p to v's dtype before P.V.
//
// Bound: at ViT's T = 197, D = 64 the card's ratio of operations to bytes
// (~295 bf16 tensor-core FLOP a byte) is far above this function's
// (4*T*D FLOP for 8*D bytes a row: ~100 at T = 197), so the least time is
// set by device-memory bytes. Two versions, at head dim 32 or 64: bf16
// runs its products on the tensor cores (mma.sync, flash_fwd_mma_kernel),
// fp32 on the CUDA cores (flash_fwd_kernel). Neither is near the bytes
// yet: each block stages every K/V tile through shared
// memory with plain loads and reads K/V once per query tile; TMA, wgmma
// and a persistent grid are later work.
//
// Design: the TPU kernel's sequential KV grid axis, with (acc, m, l) in
// scratch, becomes a loop inside the block. A block owns kTile query rows
// of one (b, h), keeps them in shared memory, and walks the K/V tiles
// through shared memory, carrying m, l and its share of acc in registers
// (online softmax). Keys at or past kv_len (and T) are masked in the
// kernel instead of padding T to a block multiple; a row whose tile holds
// no live key yet keeps m = -inf, and the rescale uses 0 in its place, so
// -inf - -inf never occurs. A row with no live key at all (not reachable
// through flash_self_attention, whose kv_len >= 1 keeps key 0 live for
// every row) gets o = 0 and lse = -inf.
//
// C interface (ctypes): dvggf_flash_fwd returns cudaGetLastError() after
// the launch, 0 on success.

#include "flash_common.cuh"

namespace {

using flash::kThreads;
using flash::kTile;

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int H, int T_len,
                     flash::Strides s, int causal, int kv_len, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                  // kTile x (D+1)
  float* Ks = Qs + kTile * (D + 1);  // kTile x (D+1)
  float* Vs = Ks + kTile * (D + 1);  // kTile x (D+1)
  float* Ps = Vs + kTile * (D + 1);  // kTile x (kTile+1)
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int q0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const long long base = b * s.b + h * s.h;
  flash::load_tile<D>(Qs, q, base, s, q0, T_len);

  float acc[4][D / 16];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.0f;
  }
  // the keys any row of this tile may see
  const int k_end = causal ? min(kv_len, q0 + kTile) : kv_len;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the last tile's readers of Ks, Vs and Ps are done
    flash::load_tile<D>(Ks, k, base, s, k0, T_len);
    flash::load_tile<D>(Vs, v, base, s, k0, T_len);
    __syncthreads();
    float sc[4][4];
    flash::dot_tile<D>(sc, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool live = kp < kv_len && (!causal || kp <= qp);
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
        Ps[(ty * 4 + i) * (kTile + 1) + tx + 16 * j] = (p);
      }
      l[i] = l[i] * corr + flash::row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
    flash::accumulate_rows<D>(acc, Ps, Vs, ty, tx);
  }

  const flash::Strides os = flash::dense_strides(T_len, H, D);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= T_len) continue;
    const long long at = b * os.b + row * os.t + h * os.h;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      o[at + tx + 16 * j] =
          (l[i] > 0.0f ? acc[i][j] / l[i] : 0.0f);
    }
    if (tx == 0) {
      lse[static_cast<long long>(bh) * T_len + row] =
          l[i] > 0.0f ? m[i] + logf(l[i]) : -INFINITY;
    }
  }
}

// The bf16 version of the same function, on the tensor cores: a
// block of 4 warps owns kTile query rows, 16 a warp. Q's fragments stay in
// registers; each K/V tile is staged in shared memory as bf16 (K row-major
// for S = Q K^T, V transposed for O += P V); S, m, l and O stay in
// registers, and P goes to the P.V product as a fragment rounded to bf16.
template <int D>
__global__ void __launch_bounds__(flash::kMmaThreads)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, int H, int T_len,
                         flash::Strides s, int causal, int kv_len,
                         float scale, bool vec) {
  __shared__ __align__(16) uint16_t Qs[kTile * (D + 8)];
  __shared__ __align__(16) uint16_t Ks[kTile * (D + 8)];
  __shared__ __align__(16) uint16_t Vt[D * (kTile + 8)];
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16;  // this warp's rows of the tile
  const int g = lane / 4;
  const int tq = lane % 4;
  const int q0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const long long base = b * s.b + h * s.h;
  flash::load_tile_bf16<D, false>(Qs, q, base, s, q0, T_len, vec);
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    flash::load_a<D + 8>(qa[ks], Qs, r0, 16 * ks, lane);
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  }
  float m[2] = {-INFINITY, -INFINITY};  // rows g and g+8 of the warp's 16
  float l[2] = {0.0f, 0.0f};
  const int k_end = causal ? min(kv_len, q0 + kTile) : kv_len;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the last tile's readers of Ks and Vt are done
    flash::load_tile_bf16<D, false>(Ks, k, base, s, k0, T_len, vec);
    flash::load_tile_bf16<D, true>(Vt, v, base, s, k0, T_len, vec);
    __syncthreads();
    float sc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t bf[2];
        flash::load_b<D + 8>(bf, Ks, 8 * nt, 16 * ks, lane);
        flash::mma_16816(sc[nt], qa[ks], bf);
      }
    }
    // a tile whose keys are live for every row of the block needs no mask
    const bool mask =
        k0 + kTile > kv_len || (causal && k0 + kTile - 1 > q0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = q0 + r0 + g + (e >= 2 ? 8 : 0);
        const int kp = k0 + 8 * nt + 2 * tq + (e & 1);
        const bool live = !mask || (kp < kv_len && (!causal || kp <= qp));
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

  const flash::Strides os = flash::dense_strides(T_len, H, D);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + 8 * i;
    if (row >= T_len) continue;
    const long long at = b * os.b + row * os.t + h * os.h;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        o[at + 8 * n + 2 * tq + j] = __float2bfloat16(
            l[i] > 0.0f ? acc[n][2 * i + j] / l[i] : 0.0f);
      }
    }
    if (tq == 0) {
      lse[static_cast<long long>(bh) * T_len + row] =
          l[i] > 0.0f ? m[i] + logf(l[i]) : -INFINITY;
    }
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int T_len, int H, flash::Strides s,
                       int causal, int kv_len, float scale,
                       cudaStream_t stream) {
  const dim3 grid((T_len + kTile - 1) / kTile, B * H);
  flash_fwd_mma_kernel<D><<<grid, flash::kMmaThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, H, T_len, s, causal, kv_len, scale,
      flash::rows_aligned16(s, q, k, v));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int T_len, int H, flash::Strides s,
                   int causal, int kv_len, float scale, cudaStream_t stream) {
  constexpr size_t smem = flash::smem_bytes<D>(3, 1, 0);
  static const cudaError_t opt_in =
      flash::allow_smem(flash_fwd_kernel<D>, smem);
  if (opt_in != cudaSuccess) return opt_in;
  const dim3 grid((T_len + kTile - 1) / kTile, B * H);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, T_len, s,
      causal, kv_len, scale);
  return cudaGetLastError();
}

// fp32 on the CUDA cores, bf16 on the tensor cores; D = 32 or 64.
cudaError_t dispatch(int dtype, int D, const void* q, const void* k,
                     const void* v, void* o, float* lse, int B, int T_len,
                     int H, flash::Strides s, int causal, int kv_len,
                     float scale, cudaStream_t stream) {
  if (dtype == 0 && D == 32) {
    return launch<32>(q, k, v, o, lse, B, T_len, H, s, causal, kv_len, scale,
                      stream);
  }
  if (dtype == 0 && D == 64) {
    return launch<64>(q, k, v, o, lse, B, T_len, H, s, causal, kv_len, scale,
                      stream);
  }
  if (dtype == 1 && D == 32) {
    return launch_mma<32>(q, k, v, o, lse, B, T_len, H, s, causal, kv_len,
                          scale, stream);
  }
  if (dtype == 1 && D == 64) {
    return launch_mma<64>(q, k, v, o, lse, B, T_len, H, s, causal, kv_len,
                          scale, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int dvggf_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, float* lse, int B, int T_len, int H,
                               int D, long long sb, long long st,
                               long long sh, int causal, int kv_len,
                               float scale, int dtype, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B < 1 || T_len < 1 || H < 1 || kv_len < 1 || kv_len > T_len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(dispatch(dtype, D, q, k, v, o, lse, B, T_len, H,
                                   flash::Strides{sb, st, sh}, causal,
                                   kv_len, scale,
                                   static_cast<cudaStream_t>(stream)));
}
