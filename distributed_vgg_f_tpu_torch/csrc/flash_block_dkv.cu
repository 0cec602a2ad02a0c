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
// set the least time (~52 us in bf16 for a fully live block).
//
// Design of the bf16 kernel (block_dkv_wgmma_kernel): flash_dkv.cu's
// flash_dkv_wgmma_kernel (its header has the design and the budgets,
// which this follows for D = 64, 128 and 256: at 256 the two consumer
// warpgroups share 64 keys and split the columns), written out again
// with what a ring block step adds. Persistent, one block of 384 threads
// an SM walking work tiles of kM keys; a producer warp loads K and V once
// a work tile and the Q and dO tiles through a ring of kStages stages by
// TMA, its 32 lanes storing each stage's lse (times log2(e); +inf past
// Tq, so p = 0 there) and delta beside it; two consumer warpgroups run
// S^T = K Q^T, dP^T = V dO^T, dV += P^T dO and dK += dS^T Q as wgmma, Q
// and dO read MN-major through the descriptor (no transposed copy); the
// first live tile is peeled and the warpgroup index is warp-uniform. What
// the block step adds:
// - the queries' own length Tq (the walk over Q tiles, lse and delta),
//   while the work tiles and the rows are the visiting block's Tk keys;
// - the causal diagonal shifted by shift = q_off - k_off (key j is live
//   for query i when j <= i + shift): a work tile's first Q tile
//   (block_query_start; tiles wholly before it are never read), each
//   warpgroup's first live tile, the "no mask on this tile" test and the
//   per-pair mask take it;
// - an epilogue that adds scale * dk and dv into the carried fp32
//   accumulators IN PLACE, float2 accesses when d is even and both on 8
//   bytes. Each element has one owner thread: no atomics, the same bits
//   from run to run. Keys at or past kv_len, and keys in the future of
//   every local query, are never written, and a work tile of such keys
//   loads nothing: they stay bit-for-bit as they came.
// The flash backward keeps its own kernel (flash_dkv.cu), for the reason
// flash_block_dq.cu gives.
//
// The fp32 version (block_dkv_kernel) stays on the CUDA cores: a TF32
// product would not meet the fp32 check of 1e-5 of the largest value. It
// is flash_dkv.cu's fp32 loop with the offsets and kv_len as arguments: a
// block owns R keys of the visiting block for one bh and streams the local
// Q tiles (q, dO, lse, delta) through shared memory from
// block_query_start on, at any head dim from 1 to 256.
//
// C interface (ctypes): dvggf_flash_block_dkv returns cudaGetLastError()
// after the launch, 0 on success; -1 when the driver has no tensor map
// encoder or refuses the layout, -2 when the bf16 kernel did not compile
// to 168 registers a thread. In bf16 the rows of q, k, v and dO are
// ld = d rounded up to 8 elements apart, as in flash_block_dq.cu; dk and
// dv are contiguous at d.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using flash::kThreads;

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

// The walk of the block dK/dV: kM key rows from k0 of one bh walk the Q
// tiles of kN queries from the first that may see k0 (block_query_start;
// all when not causal), none when every key lies at or past kv_len or in
// every local query's future. Causal tiles go first-keys first (the
// longest walks); otherwise a bh's tiles sit side by side, so its Q and
// dO are read again from L2.
__device__ __forceinline__ flash::Work key_walk(long long t, int BH, int nk,
                                                int kM, int kN, int Tq,
                                                int shift, int causal,
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
  const int q_start = flash::block_query_start(k0, kN, shift, 0, causal);
  const int n =
      k0 >= kv_len || q_start >= Tq ? 0 : (Tq - q_start + kN - 1) / kN;
  return flash::Work{bh, 0, bh, k0, n};
}

template <int DP>
__global__ void __launch_bounds__(384, 1)
    block_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv,
                           int Tq, int Tk, int d, int BH, int shift,
                           int causal, int kv_len, int pairs, float scale) {
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
  const int nk = (Tk + kM - 1) / kM;
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
          key_walk(t, BH, nk, kM, kN, Tq, shift, causal, kv_len);
      if (w.n == 0) continue;
      if (lane == 0) {
        hopper::mbar_wait(&bar->kv_empty, (n_kv & 1) ^ 1);
        hopper::mbar_expect_tx(&bar->kv_full, 2 * C::kKVBytes);
#pragma unroll
        for (int ch = 0; ch < C::kChunks; ++ch) {
          hopper::tma_load_4d(sK + ch * kM * 128, &tk, &bar->kv_full,
                              64 * ch, 0, w.r0, w.bh);
          hopper::tma_load_4d(sV + ch * kM * 128, &tv, &bar->kv_full,
                              64 * ch, 0, w.r0, w.bh);
        }
      }
      ++n_kv;
      const int q_start =
          flash::block_query_start(w.r0, kN, shift, 0, causal);
      const long long rows = static_cast<long long>(w.bh) * Tq;
      for (int j = 0; j < w.n; ++j, ++c) {
        const int s = c % kStages;
        const int q0 = q_start + j * kN;
        hopper::mbar_wait(&bar->empty[s], ((c / kStages) & 1) ^ 1);
        if (lane == 0) {
          hopper::mbar_expect_tx(&bar->full[s], 2 * C::kRowsBytes);
#pragma unroll
          for (int ch = 0; ch < C::kChunks; ++ch) {
            hopper::tma_load_4d(sQ + s * C::kRowsBytes + ch * kN * 128, &tq,
                                &bar->full[s], 64 * ch, 0, q0, w.bh);
            hopper::tma_load_4d(sdO + s * C::kRowsBytes + ch * kN * 128,
                                &tdo, &bar->full[s], 64 * ch, 0, q0, w.bh);
          }
        }
        for (int r = lane; r < kN; r += 32) {
          const int row = q0 + r;
          s_lse[s * kN + r] =
              row < Tq ? lse[rows + row] * hopper::kLog2e : INFINITY;
          s_delta[s * kN + r] = row < Tq ? delta[rows + row] : 0.0f;
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
        key_walk(t, BH, nk, kM, kN, Tq, shift, causal, kv_len);
    const int key0 = w.r0 + key_off;
    // this thread's keys: krow and krow + 8; its queries 8*(e/4) +
    // 2*(lane%4) + (e%2) of each 8-query group of a tile
    const int krow = key0 + 16 * warp + lane / 4;
    float dk_acc[kW / 2], dv_acc[kW / 2];
#pragma unroll
    for (int e = 0; e < kW / 2; ++e) dk_acc[e] = dv_acc[e] = 0.0f;
    if (w.n > 0) {
      const int q_start =
          flash::block_query_start(w.r0, kN, shift, 0, causal);
      // tiles before j_live are passed on unread: all when this
      // warpgroup's keys lie at or past kv_len; when causal, those whose
      // queries all precede key0 - shift
      const int j_live =
          key0 >= kv_len ? w.n
          : causal       ? min(w.n, max(0, key0 - shift - q_start) / kN)
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
            key0 + 64 > kv_len || (causal && key0 + 63 > q0 + shift);
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
            if (dead || (causal && key > q0 + col + shift)) p0 = 0.0f;
            if (dead || (causal && key > q0 + col + 1 + shift)) p1 = 0.0f;
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
      // padding, or in every local query's future: left as it came
      if (row >= kv_len || (causal && row - shift >= Tq)) continue;
      const long long at = (static_cast<long long>(w.bh) * Tk + row) * d;
#pragma unroll
      for (int jb = 0; jb < kW / 8; ++jb) {
        const int col = col0 + 8 * jb + 2 * tq4;
        if (col >= d) continue;
        flash::add_pair(dk + at + col, dk_acc[4 * jb + 2 * i] * scale,
                        dk_acc[4 * jb + 2 * i + 1] * scale, pairs,
                        col + 1 < d);
        flash::add_pair(dv + at + col, dv_acc[4 * jb + 2 * i],
                        dv_acc[4 * jb + 2 * i + 1], pairs, col + 1 < d);
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

template <int DP>
int launch_wgmma(const Args& a, flash::Strides sq, flash::Strides sk,
                 int device, cudaStream_t stream) {
  using C = Dkv<DP>;
  static const int ready =
      hopper::launch_ready(block_dkv_wgmma_kernel<DP>, C::kSmem);
  if (ready != 0) return ready;
  CUtensorMap mq, mk, mv, mdo;
  if (!hopper::encode_bthd(&mq, a.q, a.BH, a.Tq, 1, a.d, sq.b, sq.t, sq.h,
                           C::kN) ||
      !hopper::encode_bthd(&mk, a.k, a.BH, a.Tk, 1, a.d, sk.b, sk.t, sk.h,
                           C::kM) ||
      !hopper::encode_bthd(&mv, a.v, a.BH, a.Tk, 1, a.d, sk.b, sk.t, sk.h,
                           C::kM) ||
      !hopper::encode_bthd(&mdo, a.dout, a.BH, a.Tq, 1, a.d, sq.b, sq.t,
                           sq.h, C::kN)) {
    return hopper::kErrTensorMap;
  }
  const long long n_tiles =
      static_cast<long long>((a.Tk + C::kM - 1) / C::kM) * a.BH;
  int grid = 0;
  const cudaError_t err = hopper::persistent_grid(n_tiles, device, &grid);
  if (err != cudaSuccess) return err;
  const auto at8 = [](const float* p) {
    return reinterpret_cast<uintptr_t>(p) % 8 == 0;
  };
  const int pairs = a.d % 2 == 0 && at8(a.dk) && at8(a.dv);
  block_dkv_wgmma_kernel<DP><<<grid, C::kThreads, C::kSmem, stream>>>(
      mq, mk, mv, mdo, a.lse, a.delta, a.dk, a.dv, a.Tq, a.Tk, a.d, a.BH,
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
  return dispatch(dtype, a, device, static_cast<cudaStream_t>(stream));
}
