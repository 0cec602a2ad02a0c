// Flash attention backward, dK and dV, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels
// ops/flash_attention.py:_dkv_kernel (with _dkv_update) and, through its
// causal loop bound, _dkv_kernel_jagged. From the forward's residuals (q,
// k, v, lse), dO and delta_i = sum_d dO_id * O_id (fp32, computed by the
// caller), for each (b, h) and key row j:
//   s_ij  = (q_i . k_j) * scale, p_ij = exp(s_ij - lse_i)   (0 if masked)
//   dv_j  = sum_i round(p_ij) dO_i                       (in v's dtype)
//   ds_ij = p_ij * (dO_i . v_j - delta_i)
//   dk_j  = scale * sum_i round(ds_ij) q_i               (in k's dtype)
// with the forward's masks (j >= kv_len; j > i when causal) and round()
// the casts of p to dO's dtype and of dS to q's dtype before the products.
// A masked key gets p = 0 for every query, so dk and dv are exactly 0. Any
// head dim from 1 to 256 (flash_common.cuh).
//
// Bound, in bf16. ViT-S/16's layer (1024, 197, 6, 64) reads q, k, v and dO
// and writes dk and dv, 12*D bytes a row, for 8*T*D FLOP a row: ~131 FLOP
// a byte at T = 197, below the card's ~295, so device-memory bytes set
// the least time (0.280 ms), and each tile's fixed cost is what a kernel
// pays above it. Causal (4, 8192, 6, 64) does four products over 805 M
// live pairs (412 GFLOP) for 151 MB: the tensor cores' rate sets the least
// time (0.417 ms).
//
// Design of the bf16 kernel (flash_dkv_wgmma_kernel), the transposed walk
// of the dQ kernel (flash_dq.cu), as the TPU kernel runs the transposed
// grid:
// - Persistent: one block of 384 threads an SM walks work tiles of kM key
//   rows of one (b, h) (key_walk: causal tiles first-keys first, which
//   walk the most queries; else a (b, h)'s tiles side by side, so its Q and
//   dO are read again from L2).
// - Warp specialisation: warpgroup 0 is the producer (setmaxnreg down to
//   40). K and V of a work tile are loaded once by TMA; the Q and dO tiles
//   of kN queries stream through a ring of kStages stages, each with a
//   full and an empty mbarrier. Beside each stage the producer warp's 32
//   lanes store the tile's lse (times log2(e); +inf past T, so p = 0
//   there) and delta, and arrive on the stage's full barrier with the TMA
//   bytes. TMA writes zeros for rows past T and columns past D.
// - Two consumer warpgroups (setmaxnreg up to 232) accumulate dK and dV
//   in registers. For Q tile j a consumer issues S_j^T = K Q_j^T and
//   dP_j^T = V dO_j^T as wgmma with both operands in shared memory
//   (K-major), then the previous tile's dV += P^T dO and dK += dS^T Q as
//   wgmma with P^T and dS^T in registers (bf16) and dO and Q read through
//   the descriptor's transpose (MN-major): no transposed copy of Q or dO.
//   It waits for S_j^T and dP_j^T alone and computes P^T and dS^T while
//   those products run on the tensor cores. As in dQ, the warpgroup index
//   is made warp-uniform and the first live tile is peeled out of the
//   loop, so that ptxas keeps the wgmma asynchronous.
// - Budgets. Up to D = 128 each consumer warpgroup owns 64 keys (kM = 128)
//   and all D columns of their dK and dV: a thread holds dK and dV (D/2
//   fp32 each), S^T and dP^T (kN/2 each) and the P^T and dS^T fragments
//   (kN/4 each): 64 + 64 + 32 = 160 registers at D <= 64 (kN = 64), and
//   128 + 32 + 16 = 176 at 128 (kN = 32), inside 232. At D = 256 dK and dV
//   of 64 keys would take 256 registers a thread, so a work tile is 64
//   keys, both warpgroups compute its S^T and dP^T, and each accumulates
//   128 of the 256 columns of dK and dV (128 + 32 + 16 = 176 registers):
//   the two score products are done twice (6 products instead of 4) so
//   that no fp32 score crosses shared memory. (With the products in flight
//   ptxas spills a few bytes at 128 and 256.) Shared memory: K and V
//   (2 * kM * D * 2 bytes) and the stages (2 * kN * D * 2 bytes each, with
//   lse and delta): 32 + 4 * 16 = 96 KB at 64, 64 + 4 * 16 = 128 KB at
//   128, 64 + 3 * 32 = 160 KB at 256, of 227 KB.
// - Causal and kv_len. A work tile walks the Q tiles from its first key on
//   (those wholly before it see none of its keys); a warpgroup passes on,
//   unread, the tiles wholly before its own keys. A work tile whose keys
//   all lie at or past kv_len loads nothing and writes zeros; a
//   warpgroup's keys that do are passed over the same way. Only the tiles
//   that hold the diagonal or kv_len pay the mask.
// - No atomics: the one block that owns a key writes its dk (times scale)
//   and dv once, so the result is the same bits from run to run.
// - Numerics as the JAX kernel's: fp32 scores, p recomputed from lse
//   (through ex2, a few fp32 ulps), p rounded to bf16 before dV, dS in
//   fp32 rounded to bf16 before dK, fp32 accumulators.
// - Guards: every mbarrier wait is bounded (hopper.cuh: a stalled wait
//   traps); the launcher refuses to start the kernel unless it compiled to
//   the 168 registers a thread that setmaxnreg's budget assumes.
//
// The fp32 version (flash_dkv_kernel) stays on the CUDA cores: a TF32
// product would not meet the fp32 check of 1e-5 of the largest value. A
// block owns R key rows of one (b, h) (R = 64, or 32 at D = 256): their k
// and v stay in shared memory, dk and dv accumulate in registers, and the
// Q tiles (q, dO, lse, delta) stream through shared memory.
//
// C interface (ctypes): dvggf_flash_dkv returns cudaGetLastError() after
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

// ------------------------------------------------------------- bf16
template <int DP>
struct Dkv {
  // at 256 the two consumer warpgroups share a work tile's keys and split
  // the columns of dK and dV
  static constexpr bool kSplit = DP == 256;
  static constexpr int kM = kSplit ? 64 : 128;       // keys of a work tile
  static constexpr int kW = kSplit ? DP / 2 : DP;    // a warpgroup's columns
  static constexpr int kN = DP == 64 ? 64 : 32;      // queries of a stage
  static constexpr int kStages = DP == 256 ? 3 : 4;
  static constexpr int kChunks = DP / 64;  // 128-byte swizzle atoms a row
  static constexpr uint32_t kKVBytes = kM * DP * 2;    // K or V
  static constexpr uint32_t kRowsBytes = kN * DP * 2;  // a Q or dO stage
  static constexpr int kThreads = 384;
  // 1024 bytes of slack to align the tiles for the swizzle, then K, V,
  // the Q stages, the dO stages, lse and delta of each stage and the
  // barriers
  static constexpr size_t kSmem = 1024 + 2 * kKVBytes +
                                  2 * kStages * kRowsBytes +
                                  2 * kStages * kN * sizeof(float) + 128;
};

template <int kStages>
struct DkvBarriers {
  uint64_t kv_full, kv_empty;  // K and V of the work tile
  uint64_t full[kStages], empty[kStages];  // Q, dO, lse and delta of a stage
};

// The producer warp's arrivals on a stage's full barrier: lane 0's with the
// TMA bytes, then one from each lane after its lse and delta stores.
constexpr int kStageArrivals = 1 + 32;

// The walk of dK/dV: kM key rows walk the Q tiles of kN queries from their
// first key on when causal (the tiles before see none of them), all of
// them otherwise; none when every key lies at or past kv_len. Causal tiles
// go first-keys first (the longest walks); otherwise a (b, h)'s tiles sit
// side by side.
__device__ __forceinline__ flash::Work key_walk(long long t, int BH, int H,
                                                int nk, int kM, int kN,
                                                int T_len, int causal,
                                                int kv_len) {
  int kb, bh;
  if (causal) {
    kb = static_cast<int>(t / BH);
    bh = static_cast<int>(t % BH);
  } else {
    bh = static_cast<int>(t / nk);
    kb = static_cast<int>(t % nk);
  }
  const int k0 = kb * kM;
  const int q_start = causal ? k0 : 0;
  const int n = k0 >= kv_len ? 0 : (T_len - q_start + kN - 1) / kN;
  return flash::Work{bh / H, bh % H, bh, k0, n};
}

template <int DP>
__global__ void __launch_bounds__(384, 1)
    flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int H, int T_len,
                           int d, int BH, int causal, int kv_len,
                           float scale) {
  using C = Dkv<DP>;
  constexpr int kM = C::kM;
  constexpr int kN = C::kN;
  constexpr int kW = C::kW;
  constexpr int kStages = C::kStages;
  unsigned char* raw = flash::dyn_smem<unsigned char>();
  unsigned char* sK =
      raw + ((1024 - (hopper::smem_addr(raw) & 1023)) & 1023);
  unsigned char* sV = sK + C::kKVBytes;
  unsigned char* sQ = sV + C::kKVBytes;               // kStages Q tiles
  unsigned char* sdO = sQ + kStages * C::kRowsBytes;  // kStages dO tiles
  float* s_lse = reinterpret_cast<float*>(sdO + kStages * C::kRowsBytes);
  float* s_delta = s_lse + kStages * kN;  // kN a stage, each
  auto* bar = reinterpret_cast<DkvBarriers<kStages>*>(s_delta + kStages * kN);
  // a tile of R rows is C::kChunks chunks of R x 64 values (128 bytes a
  // row), chunk c at c * R * 128 bytes

  // warp-uniform as far as the compiler can tell
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int nk = (T_len + kM - 1) / kM;
  const long long n_tiles = static_cast<long long>(nk) * BH;

  if (threadIdx.x == 0) {
    // kv_full: the producer's one arrival with its bytes; full: see
    // kStageArrivals; empty: one arrival from each of the 8 consumer warps
    hopper::mbar_init(&bar->kv_full, 1);
    hopper::mbar_init(&bar->kv_empty, 8);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&bar->full[s], kStageArrivals);
      hopper::mbar_init(&bar->empty[s], 8);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      hopper::prefetch_tensor_map(&tq);
      hopper::prefetch_tensor_map(&tk);
      hopper::prefetch_tensor_map(&tv);
      hopper::prefetch_tensor_map(&tdo);
    }
    int c = 0;     // Q tiles loaded so far
    int n_kv = 0;  // K/V tiles loaded so far
    for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const flash::Work w =
          key_walk(t, BH, H, nk, kM, kN, T_len, causal, kv_len);
      if (w.n == 0) continue;
      if (lane == 0) {
        hopper::mbar_wait(&bar->kv_empty, (n_kv & 1) ^ 1);
        hopper::mbar_expect_tx(&bar->kv_full, 2 * C::kKVBytes);
#pragma unroll
        for (int ch = 0; ch < C::kChunks; ++ch) {
          hopper::tma_load_4d(sK + ch * kM * 128, &tk, &bar->kv_full,
                              64 * ch, w.h, w.r0, w.b);
          hopper::tma_load_4d(sV + ch * kM * 128, &tv, &bar->kv_full,
                              64 * ch, w.h, w.r0, w.b);
        }
      }
      ++n_kv;
      const int q_start = causal ? w.r0 : 0;
      const long long rows = static_cast<long long>(w.bh) * T_len;
      for (int j = 0; j < w.n; ++j, ++c) {
        const int s = c % kStages;
        const int q0 = q_start + j * kN;
        hopper::mbar_wait(&bar->empty[s], ((c / kStages) & 1) ^ 1);
        if (lane == 0) {
          hopper::mbar_expect_tx(&bar->full[s], 2 * C::kRowsBytes);
#pragma unroll
          for (int ch = 0; ch < C::kChunks; ++ch) {
            hopper::tma_load_4d(sQ + s * C::kRowsBytes + ch * kN * 128, &tq,
                                &bar->full[s], 64 * ch, w.h, q0, w.b);
            hopper::tma_load_4d(sdO + s * C::kRowsBytes + ch * kN * 128,
                                &tdo, &bar->full[s], 64 * ch, w.h, q0, w.b);
          }
        }
        for (int r = lane; r < kN; r += 32) {
          const int row = q0 + r;
          s_lse[s * kN + r] =
              row < T_len ? lse[rows + row] * hopper::kLog2e : INFINITY;
          s_delta[s * kN + r] = row < T_len ? delta[rows + row] : 0.0f;
        }
        hopper::mbar_arrive(&bar->full[s]);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  hopper::setmaxnreg_inc<232>();
  const int cw = wg - 1;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int tq4 = lane % 4;
  const float scale_log2 = scale * hopper::kLog2e;
  // this warpgroup's 64 keys of the tile (all of them when split) and its
  // first column of dK and dV
  const int key_off = C::kSplit ? 0 : 64 * cw;
  const int col0 = C::kSplit ? kW * cw : 0;
  const uint32_t k_at = hopper::smem_addr(sK) + key_off * 128;
  const uint32_t v_at = hopper::smem_addr(sV) + key_off * 128;
  const uint32_t q_at = hopper::smem_addr(sQ);
  const uint32_t do_at = hopper::smem_addr(sdO);
  // this warpgroup's columns of a Q or dO stage start at chunk col0 / 64
  const uint32_t col_at = (col0 / 64) * kN * 128;
  int c = 0;
  int n_kv = 0;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const flash::Work w =
        key_walk(t, BH, H, nk, kM, kN, T_len, causal, kv_len);
    const int key0 = w.r0 + key_off;
    // this thread's keys: krow and krow + 8; its queries 8*(e/4) +
    // 2*(lane%4) + (e%2) of each 8-query group of a tile
    const int krow = key0 + 16 * warp + lane / 4;
    float dk_acc[kW / 2], dv_acc[kW / 2];
#pragma unroll
    for (int e = 0; e < kW / 2; ++e) dk_acc[e] = dv_acc[e] = 0.0f;
    if (w.n > 0) {
      const int q_start = causal ? w.r0 : 0;
      // tiles before j_live are passed on unread: all when this
      // warpgroup's keys lie at or past kv_len; when causal, those whose
      // queries all precede key0 (key0 - q_start is 0 or 64)
      const int j_live = key0 >= kv_len ? w.n
                         : causal ? min(w.n, (key0 - q_start) / kN)
                                  : 0;
      // P^T and dS^T of the previous tile (its dK and dV pending)
      uint32_t pf[kN / 16][4], dsf[kN / 16][4];
      hopper::mbar_wait(&bar->kv_full, n_kv & 1);
      if (j_live == w.n && lane == 0) hopper::mbar_arrive(&bar->kv_empty);
      for (int j = 0; j < j_live; ++j) {  // passed on unread
        const int ck = c + j;
        hopper::mbar_wait(&bar->full[ck % kStages], (ck / kStages) & 1);
        if (lane == 0) hopper::mbar_arrive(&bar->empty[ck % kStages]);
        __syncwarp();
      }
      // S^T = K Q^T and dP^T = V dO^T of the tile in stage s (a fence
      // before, a commit after)
      const auto issue_s_dp = [&](float (&st)[kN / 2], float (&dpt)[kN / 2],
                                  int s) {
        hopper::wgmma_tile_ss<DP, kN, kM>(st, k_at, q_at + s * C::kRowsBytes);
        hopper::wgmma_tile_ss<DP, kN, kM>(dpt, v_at,
                                          do_at + s * C::kRowsBytes);
      };
      // dV += P^T dO and dK += dS^T Q of the tile in stage s
      const auto issue_dk_dv = [&](int s) {
        const uint32_t at = s * C::kRowsBytes + col_at;
        hopper::wgmma_tile_rs<kW, kN>(dv_acc, pf, do_at + at);
        hopper::wgmma_tile_rs<kW, kN>(dk_acc, dsf, q_at + at);
      };
      // P^T into st, dS^T = P^T (dP^T - delta) into dpt, for the tile of
      // queries from q0 in stage s
      const auto softmax_bwd = [&](float (&st)[kN / 2], float (&dpt)[kN / 2],
                                   int q0, int s) {
        const bool mask =
            key0 + 64 > kv_len || (causal && key0 + 63 > q0);
        const float* tile_lse = s_lse + s * kN;
        const float* tile_delta = s_delta + s * kN;
#pragma unroll
        for (int e = 0; e < kN / 2; e += 2) {
          const int col = 8 * (e >> 2) + 2 * tq4;  // queries col, col + 1
          const int key = krow + 8 * ((e >> 1) & 1);
          const float2 l2 = *reinterpret_cast<const float2*>(tile_lse + col);
          const float2 dl = *reinterpret_cast<const float2*>(tile_delta + col);
          float p0 = hopper::ex2(fmaf(st[e], scale_log2, -l2.x));
          float p1 = hopper::ex2(fmaf(st[e + 1], scale_log2, -l2.y));
          if (mask) {
            const bool dead = key >= kv_len;
            if (dead || (causal && key > q0 + col)) p0 = 0.0f;
            if (dead || (causal && key > q0 + col + 1)) p1 = 0.0f;
          }
          st[e] = p0;
          st[e + 1] = p1;
          dpt[e] = p0 * (dpt[e] - dl.x);
          dpt[e + 1] = p1 * (dpt[e + 1] - dl.y);
        }
      };
      if (j_live < w.n) {
        {  // the first live tile: its S^T and dP^T alone
          const int ck = c + j_live;
          const int s = ck % kStages;
          hopper::mbar_wait(&bar->full[s], (ck / kStages) & 1);
          float st[kN / 2], dpt[kN / 2];
          hopper::wgmma_fence();
          issue_s_dp(st, dpt, s);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(st);
          hopper::fence_regs(dpt);
          if (j_live == w.n - 1 && lane == 0) {
            hopper::mbar_arrive(&bar->kv_empty);
          }
          __syncwarp();
          softmax_bwd(st, dpt, q_start + j_live * kN, s);
          hopper::to_a_frags<kN>(pf, st);    // p rounded to dO's dtype
          hopper::to_a_frags<kN>(dsf, dpt);  // dS rounded to q's dtype
        }
        for (int j = j_live + 1; j < w.n; ++j) {
          const int ck = c + j;
          const int s = ck % kStages;
          const int sp = (ck - 1) % kStages;  // the previous tile's
          hopper::mbar_wait(&bar->full[s], (ck / kStages) & 1);
          float st[kN / 2], dpt[kN / 2];
          hopper::wgmma_fence();
          issue_s_dp(st, dpt, s);
          hopper::wgmma_commit();
          issue_dk_dv(sp);
          hopper::wgmma_commit();
          hopper::wgmma_wait<1>();  // S^T and dP^T done; dK, dV may run
          hopper::fence_regs(st);
          hopper::fence_regs(dpt);
          if (j == w.n - 1 && lane == 0) hopper::mbar_arrive(&bar->kv_empty);
          __syncwarp();
          softmax_bwd(st, dpt, q_start + j * kN, s);
          hopper::wgmma_wait<0>();  // the previous tile's dK, dV done
          hopper::fence_regs(dv_acc);
          hopper::fence_regs(dk_acc);
          hopper::fence_regs(pf);
          hopper::fence_regs(dsf);
          if (lane == 0) hopper::mbar_arrive(&bar->empty[sp]);
          __syncwarp();
          hopper::to_a_frags<kN>(pf, st);    // p rounded to dO's dtype
          hopper::to_a_frags<kN>(dsf, dpt);  // dS rounded to q's dtype
        }
        // the last tile's dK and dV
        const int sp = (c + w.n - 1) % kStages;
        hopper::wgmma_fence();
        issue_dk_dv(sp);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dv_acc);
        hopper::fence_regs(dk_acc);
        hopper::fence_regs(pf);
        hopper::fence_regs(dsf);
        if (lane == 0) hopper::mbar_arrive(&bar->empty[sp]);
        __syncwarp();
      }
      c += w.n;
      ++n_kv;
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = krow + 8 * i;
      if (row >= T_len) continue;
      const long long at =
          ((static_cast<long long>(w.b) * T_len + row) * H + w.h) * d;
#pragma unroll
      for (int jb = 0; jb < kW / 8; ++jb) {
        const int col = col0 + 8 * jb + 2 * tq4;
        if (col >= d) continue;
        const float k0 = dk_acc[4 * jb + 2 * i] * scale;
        const float k1 = dk_acc[4 * jb + 2 * i + 1] * scale;
        const float v0 = dv_acc[4 * jb + 2 * i];
        const float v1 = dv_acc[4 * jb + 2 * i + 1];
        if (d % 2 == 0) {
          *reinterpret_cast<uint32_t*>(dk + at + col) =
              flash::pack_bf16(k0, k1);
          *reinterpret_cast<uint32_t*>(dv + at + col) =
              flash::pack_bf16(v0, v1);
        } else {
          dk[at + col] = __float2bfloat16(k0);
          dv[at + col] = __float2bfloat16(v0);
          if (col + 1 < d) {
            dk[at + col + 1] = __float2bfloat16(k1);
            dv[at + col + 1] = __float2bfloat16(v1);
          }
        }
      }
    }
  }
}

template <int DP>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dk, void* dv, int B, int T_len, int H, int d,
                 flash::Strides s, flash::Strides so, int causal,
                 int kv_len, float scale, int device, cudaStream_t stream) {
  using C = Dkv<DP>;
  static const int ready =
      hopper::launch_ready(flash_dkv_wgmma_kernel<DP>, C::kSmem);
  if (ready != 0) return ready;
  CUtensorMap mq, mk, mv, mdo;
  if (!hopper::encode_bthd(&mq, q, B, T_len, H, d, s.b, s.t, s.h, C::kN) ||
      !hopper::encode_bthd(&mk, k, B, T_len, H, d, s.b, s.t, s.h, C::kM) ||
      !hopper::encode_bthd(&mv, v, B, T_len, H, d, s.b, s.t, s.h, C::kM) ||
      !hopper::encode_bthd(&mdo, dout, B, T_len, H, d, so.b, so.t, so.h,
                           C::kN)) {
    return hopper::kErrTensorMap;
  }
  const long long n_tiles =
      static_cast<long long>((T_len + C::kM - 1) / C::kM) * B * H;
  int grid = 0;
  const cudaError_t err = hopper::persistent_grid(n_tiles, device, &grid);
  if (err != cudaSuccess) return err;
  flash_dkv_wgmma_kernel<DP><<<grid, C::kThreads, C::kSmem, stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, T_len, d, B * H, causal, kv_len,
      scale);
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

// fp32 on the CUDA cores at d's padded width; bf16 through TMA and wgmma
// at 64, 128 or 256 columns (a 128-byte swizzle atom is 64 of them).
int dispatch(int dtype, int d, const void* q, const void* k, const void* v,
             const void* dout, const float* lse, const float* delta,
             void* dk, void* dv, int B, int T_len, int H, flash::Strides s,
             flash::Strides so, int causal, int kv_len, float scale,
             int device, cudaStream_t stream) {
  if (dtype == 0) {
    FLASH_PADDED_DIMS(d, return launch<DP>(q, k, v, dout, lse, delta, dk, dv,
                                           B, T_len, H, d, s, causal, kv_len,
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
      return launch_wgmma<64>(q, k, v, dout, lse, delta, dk, dv, B, T_len, H,
                              d, s, so, causal, kv_len, scale, device,
                              stream);
    case 128:
      return launch_wgmma<128>(q, k, v, dout, lse, delta, dk, dv, B, T_len,
                               H, d, s, so, causal, kv_len, scale, device,
                               stream);
    case 256:
      return launch_wgmma<256>(q, k, v, dout, lse, delta, dk, dv, B, T_len,
                               H, d, s, so, causal, kv_len, scale, device,
                               stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int dvggf_flash_dkv(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, void* dk, void* dv,
                               long long dsb, long long dst, long long dsh,
                               int B, int T_len, int H, int D, long long sb,
                               long long st, long long sh, int causal,
                               int kv_len, float scale, int dtype,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B < 1 || T_len < 1 || H < 1 || kv_len < 1 || kv_len > T_len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch(dtype, D, q, k, v, dout, lse, delta, dk, dv, B, T_len, H,
                  flash::Strides{sb, st, sh}, flash::Strides{dsb, dst, dsh},
                  causal, kv_len, scale, device,
                  static_cast<cudaStream_t>(stream));
}
