// Flash attention backward, dQ, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels
// ops/flash_attention.py:_dq_kernel (with _dq_update) and, through its
// causal loop bound, _dq_kernel_jagged. From the forward's residuals (q,
// k, v, lse) and dO with delta_i = sum_d dO_id * O_id (fp32, computed by
// the caller), for each (b, h) and query row i:
//   s_ij  = (q_i . k_j) * scale, p_ij = exp(s_ij - lse_i)   (0 if masked)
//   dp_ij = dO_i . v_j
//   ds_ij = p_ij * (dp_ij - delta_i)
//   dq_i  = scale * sum_j round(ds_ij) k_j              (stored in q's dtype)
// with the forward's masks (j >= kv_len; j > i when causal) and round()
// the cast of dS to k's dtype before the product. Any head dim from 1 to
// 256 (flash_common.cuh).
//
// Bound, in bf16. ViT-S/16's layer (1024, 197, 6, 64) reads q, k, v and dO
// and writes dq, 10*D bytes a row, for 6*T*D FLOP a row: ~118 FLOP a byte
// at T = 197, far below the card's ~295 bf16 tensor-core FLOP a byte, so
// device-memory bytes set the least time (0.234 ms); with two 128-row
// tiles of queries a (b, h) and four 64-key K/V tiles a walk, what a
// kernel pays above that is each tile's fixed cost: a block's start, its
// loads' latency, the epilogue. Causal (4, 8192, 6, 64) does three
// products over 805 M live pairs (309 GFLOP) for 126 MB: the tensor
// cores' rate sets the least time (0.313 ms).
//
// Design of the bf16 kernel (flash_dq_wgmma_kernel), the forward's shape
// (flash_fwd.cu):
// - Persistent: one block of 384 threads an SM walks work tiles of
//   kM = 128 query rows of one (b, h) (flash::query_walk: causal tiles
//   longest first, else a (b, h)'s tiles side by side so its K/V is read
//   again from L2), so one tile's epilogue overlaps the next one's loads.
// - Warp specialisation: warpgroup 0 is the producer (setmaxnreg down to
//   40); one thread issues TMA loads through tensor maps over the strided
//   (B, T, H, D) views of q, k and v and over dO (its own map). Q and dO of
//   a work tile are loaded once, into one of two buffers (one at D = 256),
//   so the next work tile's load overlaps this one's walk; K and V of each
//   tile of kN keys go through a ring of kStages stages, each with a full
//   and an empty mbarrier, so loads run ahead of the products. TMA writes
//   zeros for rows past T and columns past D: T = 197 and narrow heads need
//   no padding copy.
// - Two consumer warpgroups (setmaxnreg up to 232) own 64 query rows each,
//   with lse and delta of their rows in registers. For K/V tile j a
//   consumer issues S_j = Q K_j^T and dP_j = dO V_j^T as wgmma with both
//   operands in shared memory (K-major), then the previous tile's
//   dQ += dS_{j-1} K_{j-1} as wgmma with dS in registers (bf16) and K read
//   through the descriptor's transpose (MN-major): no transposed copy of
//   K, which is read from device memory once a work tile. It waits for S_j
//   and dP_j alone and computes p and dS_j while that product runs on the
//   tensor cores. Under causal masking a warpgroup skips the K/V tiles
//   wholly after its rows (it passes their stages on unread).
// - ptxas keeps wgmma asynchronous only where no branch it cannot prove
//   uniform surrounds one (else it serialises them: warnings C7518-C7520).
//   So the warpgroup index is made warp-uniform with a shuffle, and the
//   first K/V tile of a walk, which has no earlier product to overlap, is
//   peeled out of the loop instead of branching inside it.
// - No atomics: the one block that owns a row writes its dq once, times
//   scale, so the result is the same bits from run to run.
// - Numerics as the JAX kernel's: fp32 scores, p recomputed from lse
//   (exp through ex2 with log2(e) folded into the scale: a few fp32 ulps),
//   dS in fp32 rounded to bf16 before the product, an fp32 accumulator.
//   Masks (keys at or past kv_len, which covers keys past T, and j > i when
//   causal) give p = 0; only a tile that holds the diagonal or kv_len pays
//   them. Rows past T are computed from zeros and never written.
// - Budgets: a consumer thread holds dq (DP/2 fp32), S and dP (kN/2 each)
//   and the dS fragments (kN/4): 32 + 64 + 16 = 112 registers at D <= 64,
//   144 at 128, and at 256 with kN = 32 keys 128 + 32 + 8 = 168, inside
//   232 (at 256, with the products in flight, ptxas spills a few).
//   Shared memory: Q and dO (2 * 128 * DP * 2 bytes a buffer) and the
//   stages (2 * kN * DP * 2 bytes each): 2 * 32 + 4 * 16 = 128 KB at 64,
//   2 * 64 + 3 * 32 = 224 KB at 128, 128 + 2 * 32 = 192 KB at 256, of 227.
// - Guards: every mbarrier wait is bounded (hopper.cuh: a stalled wait
//   traps); the launcher refuses to start the kernel unless it compiled to
//   the 168 registers a thread that setmaxnreg's budget assumes.
//
// The fp32 version (flash_dq_kernel) stays on the CUDA cores: a TF32
// product would not meet the fp32 check of 1e-5 of the largest value. A
// block owns R query rows of one (b, h) (R = 64, or 32 at D = 256): their
// q, dO, lse and delta stay in shared memory and registers while the K/V
// tiles stream through shared memory.
//
// C interface (ctypes): dvggf_flash_dq returns cudaGetLastError() after
// the launch, 0 on success; -1 when the driver has no tensor map encoder
// or refuses the layout, -2 when the bf16 kernel did not compile to 168
// registers a thread. dO has its own (B, T, H) strides (in bf16: the
// wrapper may have copied it); the fp32 kernel takes it dense.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using flash::kThreads;

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
    flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int H, int T_len,
                          int d, int BH, int causal, int kv_len,
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
  const int nq = (T_len + kM - 1) / kM;
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
    int c = 0;  // K/V tiles loaded so far
    int it = 0;
    for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
      const flash::Work w =
          flash::query_walk(t, BH, H, nq, kM, kN, causal, kv_len);
      const int qb = it % C::kBufs;
      unsigned char* q_buf = sQ + 2 * qb * C::kRowsBytes;
      hopper::mbar_wait(&bar->q_empty[qb], ((it / C::kBufs) & 1) ^ 1);
      hopper::mbar_expect_tx(&bar->q_full[qb], 2 * C::kRowsBytes);
#pragma unroll
      for (int ch = 0; ch < C::kChunks; ++ch) {
        hopper::tma_load_4d(q_buf + ch * kM * 128, &tq, &bar->q_full[qb],
                            64 * ch, w.h, w.r0, w.b);
        hopper::tma_load_4d(q_buf + C::kRowsBytes + ch * kM * 128, &tdo,
                            &bar->q_full[qb], 64 * ch, w.h, w.r0, w.b);
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
                              64 * ch, w.h, j * kN, w.b);
          hopper::tma_load_4d(v_at + ch * kN * 128, &tv, &bar->full[s],
                              64 * ch, w.h, j * kN, w.b);
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
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
    const flash::Work w =
        flash::query_walk(t, BH, H, nq, kM, kN, causal, kv_len);
    const int wg_row0 = w.r0 + 64 * cw;
    const int qb = it % C::kBufs;
    const uint32_t q_at =
        hopper::smem_addr(sQ) + 2 * qb * C::kRowsBytes + cw * 64 * 128;
    const uint32_t do_at = q_at + C::kRowsBytes;
    // K/V tiles this warpgroup's rows may see: none when they all lie past
    // T, none after the one holding key wg_row0 + 63 when causal
    const int n_live = wg_row0 >= T_len ? 0
                       : causal ? min(w.n, (wg_row0 + 63) / kN + 1)
                                : w.n;
    // this thread's rows of the accumulators: row0 and row0 + 8; its
    // columns 8*(e/4) + 2*(lane%4) + (e%2) of each 8-column group
    const int row0 = wg_row0 + 16 * warp + lane / 4;
    float lse_log2[2], row_delta[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      const long long at = static_cast<long long>(w.bh) * T_len + row;
      lse_log2[i] = row < T_len ? lse[at] * hopper::kLog2e : 0.0f;
      row_delta[i] = row < T_len ? delta[at] : 0.0f;
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
          k0 + kN > kv_len || (causal && k0 + kN - 1 > wg_row0);
#pragma unroll
      for (int e = 0; e < kN / 2; ++e) {
        const int i = (e >> 1) & 1;
        float p = hopper::ex2(fmaf(sc[e], scale_log2, -lse_log2[i]));
        if (mask) {
          const int key = k0 + 8 * (e >> 2) + 2 * tq4 + (e & 1);
          if (key >= kv_len || (causal && key > row0 + 8 * i)) p = 0.0f;
        }
        dp[e] = p * (dp[e] - row_delta[i]);
      }
    };
    hopper::mbar_wait(&bar->q_full[qb], (it / C::kBufs) & 1);
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
      if (row >= T_len) continue;
      __nv_bfloat16* out =
          dq + ((static_cast<long long>(w.b) * T_len + row) * H + w.h) * d;
#pragma unroll
      for (int jb = 0; jb < DP / 8; ++jb) {
        const int col = 8 * jb + 2 * tq4;
        if (col >= d) continue;
        const float v0 = acc[4 * jb + 2 * i] * scale;
        const float v1 = acc[4 * jb + 2 * i + 1] * scale;
        if (d % 2 == 0) {
          *reinterpret_cast<uint32_t*>(out + col) = flash::pack_bf16(v0, v1);
        } else {
          out[col] = __float2bfloat16(v0);
          if (col + 1 < d) out[col + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

template <int DP>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, int B, int T_len, int H, int d, flash::Strides s,
                 flash::Strides so, int causal, int kv_len, float scale,
                 int device, cudaStream_t stream) {
  using C = Dq<DP>;
  static const int ready =
      hopper::launch_ready(flash_dq_wgmma_kernel<DP>, C::kSmem);
  if (ready != 0) return ready;
  CUtensorMap mq, mk, mv, mdo;
  if (!hopper::encode_bthd(&mq, q, B, T_len, H, d, s.b, s.t, s.h, C::kM) ||
      !hopper::encode_bthd(&mk, k, B, T_len, H, d, s.b, s.t, s.h, C::kN) ||
      !hopper::encode_bthd(&mv, v, B, T_len, H, d, s.b, s.t, s.h, C::kN) ||
      !hopper::encode_bthd(&mdo, dout, B, T_len, H, d, so.b, so.t, so.h,
                           C::kM)) {
    return hopper::kErrTensorMap;
  }
  const long long n_tiles =
      static_cast<long long>((T_len + C::kM - 1) / C::kM) * B * H;
  int grid = 0;
  const cudaError_t err = hopper::persistent_grid(n_tiles, device, &grid);
  if (err != cudaSuccess) return err;
  flash_dq_wgmma_kernel<DP><<<grid, C::kThreads, C::kSmem, stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<__nv_bfloat16*>(dq), H, T_len,
      d, B * H, causal, kv_len, scale);
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

// fp32 on the CUDA cores at d's padded width; bf16 through TMA and wgmma
// at 64, 128 or 256 columns (a 128-byte swizzle atom is 64 of them).
int dispatch(int dtype, int d, const void* q, const void* k, const void* v,
             const void* dout, const float* lse, const float* delta,
             void* dq, int B, int T_len, int H, flash::Strides s,
             flash::Strides so, int causal, int kv_len, float scale,
             int device, cudaStream_t stream) {
  if (dtype == 0) {
    FLASH_PADDED_DIMS(d, return launch<DP>(q, k, v, dout, lse, delta, dq, B,
                                           T_len, H, d, s, causal, kv_len,
                                           scale, stream))
  }
  if (dtype != 1 || !flash::tma_rows(s, q, k, v) ||
      !flash::tma_rows(so, dout)) {
    return cudaErrorInvalidValue;  // TMA's 16-byte rules
  }
  switch (flash::padded_dim(d)) {
    case 16:
    case 32:
    case 64:
      return launch_wgmma<64>(q, k, v, dout, lse, delta, dq, B, T_len, H, d,
                              s, so, causal, kv_len, scale, device, stream);
    case 128:
      return launch_wgmma<128>(q, k, v, dout, lse, delta, dq, B, T_len, H,
                               d, s, so, causal, kv_len, scale, device,
                               stream);
    case 256:
      return launch_wgmma<256>(q, k, v, dout, lse, delta, dq, B, T_len, H,
                               d, s, so, causal, kv_len, scale, device,
                               stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int dvggf_flash_dq(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, void* dq, long long dsb,
                              long long dst, long long dsh, int B, int T_len,
                              int H, int D, long long sb, long long st,
                              long long sh, int causal, int kv_len,
                              float scale, int dtype, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B < 1 || T_len < 1 || H < 1 || kv_len < 1 || kv_len > T_len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch(dtype, D, q, k, v, dout, lse, delta, dq, B, T_len, H,
                  flash::Strides{sb, st, sh}, flash::Strides{dsb, dst, dsh},
                  causal, kv_len, scale, device,
                  static_cast<cudaStream_t>(stream));
}
