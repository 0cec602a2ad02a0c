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
//
// Design of the bf16 kernel (block_dq_wgmma_kernel): flash_dq.cu's
// flash_dq_wgmma_kernel (its header has the design and the budgets;
// these follow it for D = 64, 128 and 256), written out again with what a
// ring block step adds. Persistent, one block of 384 threads an SM
// walking work tiles of kM = 128 query rows; a producer warp loads Q and
// dO once a work tile (two buffers) and the K/V tiles through a ring of
// kStages stages by TMA, over the (B*H, T, D) tensors seen as (B, T, H,
// D) with H = 1; two consumer warpgroups run S = Q K^T, dP = dO V^T and
// dQ += dS K as wgmma, K read MN-major through the descriptor; the first
// tile of a walk is peeled and the warpgroup index is warp-uniform, so
// ptxas keeps the wgmma asynchronous. What the block step adds:
// - keys of their own length Tk (the K/V tensor maps' rows; kv_len <= Tk);
// - the causal diagonal shifted by shift = q_off - k_off (any integer: a
//   past block's is >= Tk, the diagonal's 0, a partly future block's
//   negative): key j is live for row i when j <= i + shift. The walk's
//   key end (block_key_end), each warpgroup's live-tile count, the "no
//   mask on this tile" test and the per-pair mask all take it;
// - an epilogue that adds scale * dq into the carried fp32 accumulator IN
//   PLACE, float2 accesses when d is even and dq on 8 bytes. Each element
//   has one owner thread: no atomics, the same bits from run to run. A
//   work tile whose rows see no key loads nothing and a row that sees
//   none is not written, so a block wholly in the rows' future leaves dq
//   bit-for-bit as it came.
// Masked pairs get p = 0 explicitly, so lse = -inf (a row with no live
// key) gives no NaN. Rows past Tq are computed from TMA's zeros and never
// written. The flash backward keeps its own kernel (flash_dq.cu): one
// body templated for both problems cost the flash dQ and dK/dV 3-6% at
// causal T = 8192 on an H100 80GB HBM3 (700 W).
//
// The fp32 version (block_dq_kernel) stays on the CUDA cores: a TF32
// product would not meet the fp32 check of 1e-5 of the largest value. It
// is flash_dq.cu's fp32 loop with the offsets and kv_len as arguments: a
// block owns R query rows of one bh and streams the visiting block's K/V
// tiles through shared memory up to its rows' causal bound
// (block_key_end), at any head dim from 1 to 256 (padded as
// flash_common.cuh says).
//
// C interface (ctypes): dvggf_flash_block_dq returns cudaGetLastError()
// after the launch, 0 on success; -1 when the driver has no tensor map
// encoder or refuses the layout, -2 when the bf16 kernel did not compile
// to 168 registers a thread. In bf16 the rows of q, k, v and dO are
// ld = d rounded up to 8 elements apart (d itself, or the wrapper's padded
// copy: ops/flash_cuda.py `_block_tma_inputs`); dq is contiguous at d.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using flash::kThreads;

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

// ------------------------------------------------------------- bf16
template <int DP>
struct Dq {
  static constexpr int kM = 128;                  // query rows of a tile
  static constexpr int kN = DP <= 128 ? 64 : 32;  // keys of a K/V stage
  static constexpr int kStages = DP == 64 ? 4 : DP == 128 ? 3 : 2;
  // Q/dO buffers: the next work tile's load overlaps this one's walk
  static constexpr int kBufs = DP == 256 ? 1 : 2;
  static constexpr int kChunks = DP / 64;  // 128-byte swizzle atoms a row
  static constexpr uint32_t kRowsBytes = kM * DP * 2;  // Q or dO
  static constexpr uint32_t kKVBytes = kN * DP * 2;    // one K or V stage
  static constexpr int kThreads = 384;
  // 1024 bytes of slack to align the tiles for the swizzle, then Q, dO,
  // the K stages, the V stages and the barriers
  static constexpr size_t kSmem =
      1024 + 2 * kBufs * kRowsBytes + 2 * kStages * kKVBytes + 256;
};

template <int kStages, int kBufs>
struct DqBarriers {
  uint64_t q_full[kBufs], q_empty[kBufs];  // Q and dO of a work tile
  uint64_t full[kStages], empty[kStages];  // K and V of a stage
};

template <int DP>
__global__ void __launch_bounds__(384, 1)
    block_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dq, int Tq, int d, int BH,
                          int shift, int causal, int kv_len, int pairs,
                          float scale) {
  using C = Dq<DP>;
  constexpr int kM = C::kM;
  constexpr int kN = C::kN;
  constexpr int kStages = C::kStages;
  unsigned char* raw = flash::dyn_smem<unsigned char>();
  unsigned char* sQ =
      raw + ((1024 - (hopper::smem_addr(raw) & 1023)) & 1023);
  // buffer b: Q at sQ + 2 * b * kRowsBytes, dO kRowsBytes after it
  unsigned char* sK = sQ + 2 * C::kBufs * C::kRowsBytes;  // kStages K tiles
  unsigned char* sV = sK + kStages * C::kKVBytes;  // kStages V tiles
  auto* bar =
      reinterpret_cast<DqBarriers<kStages, C::kBufs>*>(sV + kStages *
                                                            C::kKVBytes);
  // a tile of R rows is C::kChunks chunks of R x 64 values (128 bytes a
  // row), chunk c at c * R * 128 bytes

  // warp-uniform as far as the compiler can tell
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int nq = (Tq + kM - 1) / kM;
  const long long n_tiles = static_cast<long long>(nq) * BH;

  if (threadIdx.x == 0) {
    // full: the producer's one arrival with its bytes; empty: one arrival
    // from each of the 8 consumer warps
#pragma unroll
    for (int b = 0; b < C::kBufs; ++b) {
      hopper::mbar_init(&bar->q_full[b], 1);
      hopper::mbar_init(&bar->q_empty[b], 8);
    }
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&bar->full[s], 1);
      hopper::mbar_init(&bar->empty[s], 8);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x != 0) return;
    hopper::prefetch_tensor_map(&tq);
    hopper::prefetch_tensor_map(&tk);
    hopper::prefetch_tensor_map(&tv);
    hopper::prefetch_tensor_map(&tdo);
    int c = 0;   // K/V tiles loaded so far
    int it = 0;  // work tiles loaded so far
    for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const flash::Work w =
          flash::block_query_walk(t, BH, nq, kM, kN, Tq, shift, causal,
                                  kv_len);
      if (w.n == 0) continue;  // no live key: nothing to load
      const int qb = it % C::kBufs;
      unsigned char* q_buf = sQ + 2 * qb * C::kRowsBytes;
      hopper::mbar_wait(&bar->q_empty[qb], ((it / C::kBufs) & 1) ^ 1);
      ++it;
      hopper::mbar_expect_tx(&bar->q_full[qb], 2 * C::kRowsBytes);
#pragma unroll
      for (int ch = 0; ch < C::kChunks; ++ch) {
        hopper::tma_load_4d(q_buf + ch * kM * 128, &tq, &bar->q_full[qb],
                            64 * ch, 0, w.r0, w.bh);
        hopper::tma_load_4d(q_buf + C::kRowsBytes + ch * kM * 128, &tdo,
                            &bar->q_full[qb], 64 * ch, 0, w.r0, w.bh);
      }
      for (int j = 0; j < w.n; ++j, ++c) {
        const int s = c % kStages;
        unsigned char* k_at = sK + s * C::kKVBytes;
        unsigned char* v_at = sV + s * C::kKVBytes;
        hopper::mbar_wait(&bar->empty[s], ((c / kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(&bar->full[s], 2 * C::kKVBytes);
#pragma unroll
        for (int ch = 0; ch < C::kChunks; ++ch) {
          hopper::tma_load_4d(k_at + ch * kN * 128, &tk, &bar->full[s],
                              64 * ch, 0, j * kN, w.bh);
          hopper::tma_load_4d(v_at + ch * kN * 128, &tv, &bar->full[s],
                              64 * ch, 0, j * kN, w.bh);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  hopper::setmaxnreg_inc<232>();
  const int cw = wg - 1;  // this warpgroup's 64 rows of the tile
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int tq4 = lane % 4;
  const float scale_log2 = scale * hopper::kLog2e;
  const uint32_t k_at = hopper::smem_addr(sK);
  const uint32_t v_at = hopper::smem_addr(sV);
  int c = 0;
  int it = 0;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const flash::Work w =
        flash::block_query_walk(t, BH, nq, kM, kN, Tq, shift, causal,
                                kv_len);
    if (w.n == 0) continue;  // no live key: these rows stay as they are
    const int wg_row0 = w.r0 + 64 * cw;
    const int qb = it % C::kBufs;
    const uint32_t q_phase = (it / C::kBufs) & 1;
    ++it;
    const uint32_t q_at =
        hopper::smem_addr(sQ) + 2 * qb * C::kRowsBytes + cw * 64 * 128;
    const uint32_t do_at = q_at + C::kRowsBytes;
    // K/V tiles this warpgroup's rows may see: none when they all lie past
    // Tq, none after the one holding key wg_row0 + 63 + shift when causal
    const int last = wg_row0 + 63 + shift;
    const int n_live = wg_row0 >= Tq ? 0
                       : causal ? (last < 0 ? 0 : min(w.n, last / kN + 1))
                                : w.n;
    // this thread's rows of the accumulators: row0 and row0 + 8; its
    // columns 8*(e/4) + 2*(lane%4) + (e%2) of each 8-column group
    const int row0 = wg_row0 + 16 * warp + lane / 4;
    float lse_log2[2], row_delta[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      const long long at = static_cast<long long>(w.bh) * Tq + row;
      lse_log2[i] = row < Tq ? lse[at] * hopper::kLog2e : 0.0f;
      row_delta[i] = row < Tq ? delta[at] : 0.0f;
    }
    float acc[DP / 2];
#pragma unroll
    for (int e = 0; e < DP / 2; ++e) acc[e] = 0.0f;
    uint32_t ds[kN / 16][4];  // dS of the previous tile (its dQ pending)
    // S = Q K^T and dP = dO V^T of the tile in stage s (a fence before, a
    // commit after)
    const auto issue_s_dp = [&](float (&sc)[kN / 2], float (&dp)[kN / 2],
                                int s) {
      hopper::wgmma_tile_ss<DP, kN, kM>(sc, q_at, k_at + s * C::kKVBytes);
      hopper::wgmma_tile_ss<DP, kN, kM>(dp, do_at, v_at + s * C::kKVBytes);
    };
    // dS = p (dP - delta), p = exp(s * scale - lse), into dp, for the tile
    // of keys from k0
    const auto softmax_bwd = [&](const float (&sc)[kN / 2],
                                 float (&dp)[kN / 2], int k0) {
      const bool mask =
          k0 + kN > kv_len || (causal && k0 + kN - 1 > wg_row0 + shift);
#pragma unroll
      for (int e = 0; e < kN / 2; ++e) {
        const int i = (e >> 1) & 1;
        float p = hopper::ex2(fmaf(sc[e], scale_log2, -lse_log2[i]));
        if (mask) {
          const int key = k0 + 8 * (e >> 2) + 2 * tq4 + (e & 1);
          if (key >= kv_len || (causal && key > row0 + 8 * i + shift)) {
            p = 0.0f;
          }
        }
        dp[e] = p * (dp[e] - row_delta[i]);
      }
    };
    hopper::mbar_wait(&bar->q_full[qb], q_phase);
    if (n_live == 0 && lane == 0) hopper::mbar_arrive(&bar->q_empty[qb]);
    if (n_live > 0) {
      {  // the first tile: its S and dP alone
        const int s = c % kStages;
        hopper::mbar_wait(&bar->full[s], (c / kStages) & 1);
        float sc[kN / 2], dp[kN / 2];
        hopper::wgmma_fence();
        issue_s_dp(sc, dp, s);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);
        hopper::fence_regs(dp);
        if (n_live == 1 && lane == 0) hopper::mbar_arrive(&bar->q_empty[qb]);
        __syncwarp();
        softmax_bwd(sc, dp, 0);
        hopper::to_a_frags<kN>(ds, dp);  // dS rounded to k's dtype
      }
      for (int j = 1; j < n_live; ++j) {
        const int ck = c + j;
        const int s = ck % kStages;
        const int sp = (ck - 1) % kStages;  // the previous tile's
        hopper::mbar_wait(&bar->full[s], (ck / kStages) & 1);
        float sc[kN / 2], dp[kN / 2];
        hopper::wgmma_fence();
        issue_s_dp(sc, dp, s);
        hopper::wgmma_commit();
        hopper::wgmma_tile_rs<DP, kN>(acc, ds, k_at + sp * C::kKVBytes);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // S_j and dP_j done; dQ may still run
        hopper::fence_regs(sc);
        hopper::fence_regs(dp);
        if (j == n_live - 1 && lane == 0) {
          hopper::mbar_arrive(&bar->q_empty[qb]);
        }
        __syncwarp();
        softmax_bwd(sc, dp, j * kN);
        hopper::wgmma_wait<0>();  // dS_{j-1} K_{j-1} done
        hopper::fence_regs(acc);
        hopper::fence_regs(ds);
        if (lane == 0) hopper::mbar_arrive(&bar->empty[sp]);
        __syncwarp();
        hopper::to_a_frags<kN>(ds, dp);  // dS rounded to k's dtype
      }
      // the last live tile's dQ
      const int sp = (c + n_live - 1) % kStages;
      hopper::wgmma_fence();
      hopper::wgmma_tile_rs<DP, kN>(acc, ds, k_at + sp * C::kKVBytes);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::fence_regs(ds);
      if (lane == 0) hopper::mbar_arrive(&bar->empty[sp]);
      __syncwarp();
    }
    for (int j = n_live; j < w.n; ++j) {  // wholly masked: passed on unread
      const int ck = c + j;
      hopper::mbar_wait(&bar->full[ck % kStages], (ck / kStages) & 1);
      if (lane == 0) hopper::mbar_arrive(&bar->empty[ck % kStages]);
      __syncwarp();
    }
    c += w.n;

    if (n_live == 0) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      // past Tq, or seeing no key: left as it came
      if (row >= Tq || (causal && row + shift < 0)) continue;
      float* out = dq + (static_cast<long long>(w.bh) * Tq + row) * d;
#pragma unroll
      for (int jb = 0; jb < DP / 8; ++jb) {
        const int col = 8 * jb + 2 * tq4;
        if (col >= d) continue;
        flash::add_pair(out + col, acc[4 * jb + 2 * i] * scale,
                        acc[4 * jb + 2 * i + 1] * scale, pairs, col + 1 < d);
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

template <int DP>
int launch_wgmma(const Args& a, flash::Strides sq, flash::Strides sk,
                 int device, cudaStream_t stream) {
  using C = Dq<DP>;
  static const int ready =
      hopper::launch_ready(block_dq_wgmma_kernel<DP>, C::kSmem);
  if (ready != 0) return ready;
  CUtensorMap mq, mk, mv, mdo;
  if (!hopper::encode_bthd(&mq, a.q, a.BH, a.Tq, 1, a.d, sq.b, sq.t, sq.h,
                           C::kM) ||
      !hopper::encode_bthd(&mk, a.k, a.BH, a.Tk, 1, a.d, sk.b, sk.t, sk.h,
                           C::kN) ||
      !hopper::encode_bthd(&mv, a.v, a.BH, a.Tk, 1, a.d, sk.b, sk.t, sk.h,
                           C::kN) ||
      !hopper::encode_bthd(&mdo, a.dout, a.BH, a.Tq, 1, a.d, sq.b, sq.t,
                           sq.h, C::kM)) {
    return hopper::kErrTensorMap;
  }
  const long long n_tiles =
      static_cast<long long>((a.Tq + C::kM - 1) / C::kM) * a.BH;
  int grid = 0;
  const cudaError_t err = hopper::persistent_grid(n_tiles, device, &grid);
  if (err != cudaSuccess) return err;
  const int pairs =
      a.d % 2 == 0 && reinterpret_cast<uintptr_t>(a.dq) % 8 == 0;
  block_dq_wgmma_kernel<DP><<<grid, C::kThreads, C::kSmem, stream>>>(
      mq, mk, mv, mdo, a.lse, a.delta, a.dq, a.Tq, a.d, a.BH,
      a.q_off - a.k_off, a.causal, a.kv_len, pairs, a.scale);
  return cudaGetLastError();
}

// bf16 through TMA and wgmma at 64, 128 or 256 columns (a 128-byte
// swizzle atom is 64 of them), on rows ld apart: the (B*H, T, D) tensors
// seen as (B*H, T, 1, D) with element strides (T*ld, ld, ld).
int launch_bf16(const Args& a, int device, cudaStream_t stream) {
  const long long ld = (a.d + 7) / 8 * 8;
  const flash::Strides sq{a.Tq * ld, ld, ld};
  const flash::Strides sk{a.Tk * ld, ld, ld};
  if (!flash::tma_rows(sq, a.q, a.dout) || !flash::tma_rows(sk, a.k, a.v)) {
    return cudaErrorInvalidValue;  // TMA's 16-byte rules
  }
  switch (flash::padded_dim(a.d)) {
    case 16:
    case 32:
    case 64:
      return launch_wgmma<64>(a, sq, sk, device, stream);
    case 128:
      return launch_wgmma<128>(a, sq, sk, device, stream);
    case 256:
      return launch_wgmma<256>(a, sq, sk, device, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// fp32 on the CUDA cores at d's padded width, bf16 on the tensor cores.
int dispatch(int dtype, const Args& a, int device, cudaStream_t stream) {
  if (dtype == 1) return launch_bf16(a, device, stream);
  if (dtype != 0) return cudaErrorInvalidValue;
  FLASH_PADDED_DIMS(a.d, return launch<DP>(a, stream))
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
  return dispatch(dtype, a, device, static_cast<cudaStream_t>(stream));
}
