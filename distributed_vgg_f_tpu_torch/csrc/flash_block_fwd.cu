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
// in fp32.
//
// Design of the bf16 kernel (block_fwd_wgmma_kernel): flash_fwd.cu's
// flash_fwd_wgmma_kernel (its header has the design), written out again
// with what a ring block step adds and the block dQ's walk
// (flash_block_dq.cu). Persistent, one block of 384 threads an SM walking
// work tiles of kM = 128 query rows (flash::block_query_walk); a producer
// warp loads the Q tile once a work tile and K and V through a ring of
// kStages = 2 stages by TMA, over the (B*H, T, D) tensors seen as (B, T,
// H, D) with H = 1; two consumer warpgroups of 64 rows each issue S_j =
// Q K_j^T as wgmma from shared memory, then the previous tile's O +=
// P_{j-1} V_{j-1} with P in registers (bf16) and V read MN-major through
// the descriptor (no transposed copy), and run the softmax of S_j while
// P.V runs. The first live tile of a walk is peeled and the warpgroup
// index is warp-uniform, so ptxas keeps the wgmma asynchronous. What the
// block step adds:
// - the carried state: each consumer thread reads acc for rows row0 and
//   row0 + 8 (its wgmma C-fragment columns) straight into the registers
//   P.V accumulates into, and m and l of the same rows, before it waits
//   for the first product, so the loads' latency hides under it. acc's
//   rows are d apart: the fp32 state is never copied or padded. l is held
//   as four quad shares (the carried sum in one of them) and summed at
//   write-back. acc, m and l go back IN PLACE, each element by the thread
//   that read it: no atomics, the same bits from run to run;
// - m on the scaled scores (the caller's contract): m_new = max(m,
//   scale * rowmax(raw scores)), equal to the max of the scaled scores
//   since rounding a product by a positive scale is monotone; log2(e) is
//   folded into the exponent's multiply-add after the compare. A row
//   whose carried m wins keeps its bits; a row that has seen no live key
//   keeps m = -inf and rescales with 0 in its place, so -inf - -inf never
//   occurs and the diagonal block need not come first;
// - keys of their own length Tk (kv_len <= Tk), and the causal diagonal
//   shifted by shift = q_off - k_off (any integer): key j is live for row
//   i when j <= i + shift. The walk's key end, each warpgroup's live-tile
//   count (clamped at 0 before its division) and the "no mask on this
//   tile" test take it, so only tiles that hold the shifted diagonal or
//   kv_len pay the mask;
// - what is not written: a work tile whose rows see no key loads nothing
//   and stores nothing, rows past Tq are never stored, and a row that
//   sees no key is not stored either (adding P.V's +0.0 would turn a
//   -0.0 of acc into +0.0), so a block wholly in the rows' future leaves
//   the state bit-for-bit as it came.
// The flash forward's ping-pong of the two warpgroups on short walks is
// not carried over: here the two may walk different numbers of tiles.
// The flash forward keeps its own kernel (flash_fwd.cu), for the reason
// flash_block_dq.cu gives.
//
// The fp32 version (block_fwd_kernel) stays on the CUDA cores: a TF32
// product would not meet the fp32 check of 1e-5 of the largest value. A
// block owns R query rows of one bh: it reads their state from device
// memory into registers, walks the visiting block's K/V tiles through
// shared memory up to the causal bound of its rows (block_key_end), and
// writes the state back in place, at any head dim from 1 to 256 (padded
// as flash_common.cuh says). A block whose bound is <= 0 leaves its rows
// untouched.
//
// C interface (ctypes): dvggf_flash_block_fwd returns cudaGetLastError()
// after the launch, 0 on success; -1 when no tensor map encoder is found
// or the layout is refused, -2 when the bf16 kernel did not compile to
// 168 registers a thread. In bf16 the rows of q, k and v are ld = d
// rounded up to 8 elements apart, as in flash_block_dq.cu; acc is
// contiguous at d.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using flash::kThreads;

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

// ------------------------------------------------------------- bf16
template <int DP>
struct Fold {
  static constexpr int kM = 128;                  // query rows of a tile
  static constexpr int kN = DP <= 128 ? 128 : 64;  // keys of a K/V stage
  static constexpr int kStages = 2;
  static constexpr int kChunks = DP / 64;  // 128-byte swizzle atoms a row
  static constexpr uint32_t kQBytes = kM * DP * 2;
  static constexpr uint32_t kKVBytes = kN * DP * 2;  // one K or V stage
  static constexpr int kThreads = 384;
  // 1024 bytes of slack to align the tiles for the swizzle, then Q, the
  // K stages, the V stages and the barriers
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + 128;
};

struct Barriers {
  uint64_t q_full, q_empty;
  uint64_t k_full[2], k_empty[2], v_full[2], v_empty[2];
};

using hopper::ex2;

template <int DP>
__global__ void __launch_bounds__(384, 1)
    block_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           float* __restrict__ acc_io,
                           float* __restrict__ m_io,
                           float* __restrict__ l_io, int Tq, int d, int BH,
                           int shift, int causal, int kv_len, int pairs,
                           float scale) {
  using C = Fold<DP>;
  constexpr int kM = C::kM;
  constexpr int kN = C::kN;
  constexpr int kStages = C::kStages;
  unsigned char* raw = flash::dyn_smem<unsigned char>();
  unsigned char* sQ =
      raw + ((1024 - (hopper::smem_addr(raw) & 1023)) & 1023);
  unsigned char* sK = sQ + C::kQBytes;            // kStages K tiles
  unsigned char* sV = sK + kStages * C::kKVBytes;  // kStages V tiles
  Barriers* bar = reinterpret_cast<Barriers*>(sV + kStages * C::kKVBytes);
  // a tile of R rows is C::kChunks chunks of R x 64 values (128 bytes a
  // row), chunk c at c * R * 128 bytes

  // warp-uniform as far as the compiler can tell
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int nq = (Tq + kM - 1) / kM;
  const long long n_tiles = static_cast<long long>(nq) * BH;

  if (threadIdx.x == 0) {
    // full: the producer's one arrival with its bytes; empty: one arrival
    // from each of the 8 consumer warps
    hopper::mbar_init(&bar->q_full, 1);
    hopper::mbar_init(&bar->q_empty, 8);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&bar->k_full[s], 1);
      hopper::mbar_init(&bar->k_empty[s], 8);
      hopper::mbar_init(&bar->v_full[s], 1);
      hopper::mbar_init(&bar->v_empty[s], 8);
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
    int c = 0;   // K/V tiles loaded so far
    int it = 0;  // work tiles loaded so far
    for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const flash::Work w = flash::block_query_walk(t, BH, nq, kM, kN, Tq,
                                                    shift, causal, kv_len);
      if (w.n == 0) continue;  // no live key: nothing to load
      hopper::mbar_wait(&bar->q_empty, (it & 1) ^ 1);
      ++it;
      hopper::mbar_expect_tx(&bar->q_full, C::kQBytes);
#pragma unroll
      for (int ch = 0; ch < C::kChunks; ++ch) {
        hopper::tma_load_4d(sQ + ch * kM * 128, &tq, &bar->q_full, 64 * ch,
                            0, w.r0, w.bh);
      }
      for (int j = 0; j < w.n; ++j, ++c) {
        const int s = c % kStages;
        const uint32_t free_parity = ((c / kStages) & 1) ^ 1;
        unsigned char* k_at = sK + s * C::kKVBytes;
        unsigned char* v_at = sV + s * C::kKVBytes;
        hopper::mbar_wait(&bar->k_empty[s], free_parity);
        hopper::mbar_expect_tx(&bar->k_full[s], C::kKVBytes);
#pragma unroll
        for (int ch = 0; ch < C::kChunks; ++ch) {
          hopper::tma_load_4d(k_at + ch * kN * 128, &tk, &bar->k_full[s],
                              64 * ch, 0, j * kN, w.bh);
        }
        hopper::mbar_wait(&bar->v_empty[s], free_parity);
        hopper::mbar_expect_tx(&bar->v_full[s], C::kKVBytes);
#pragma unroll
        for (int ch = 0; ch < C::kChunks; ++ch) {
          hopper::tma_load_4d(v_at + ch * kN * 128, &tv, &bar->v_full[s],
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
  const uint32_t q_at = hopper::smem_addr(sQ) + cw * 64 * 128;
  const uint32_t k_at = hopper::smem_addr(sK);
  const uint32_t v_at = hopper::smem_addr(sV);
  int c = 0;
  int it = 0;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const flash::Work w = flash::block_query_walk(t, BH, nq, kM, kN, Tq,
                                                  shift, causal, kv_len);
    if (w.n == 0) continue;  // no live key: these rows stay as they are
    const uint32_t q_phase = it & 1;
    ++it;
    const int wg_row0 = w.r0 + 64 * cw;
    // K/V tiles this warpgroup's rows may see: none when they all lie past
    // Tq, none after the one holding key wg_row0 + 63 + shift when causal
    const int last = wg_row0 + 63 + shift;
    const int n_live = wg_row0 >= Tq ? 0
                       : causal ? (last < 0 ? 0 : min(w.n, last / kN + 1))
                                : w.n;
    // this thread's rows of the accumulators: row0 and row0 + 8; its
    // columns 8*(e/4) + 2*(lane%4) + (e%2) of each 8-column group
    const int row0 = wg_row0 + 16 * warp + lane / 4;
    // the carried state of those rows, loaded before the first product's
    // wait; m on the scaled scores, l's whole sum in the quad's lane 0
    float acc[DP / 2], m[2], l[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      const bool in = n_live > 0 && row < Tq;
      const long long at = static_cast<long long>(w.bh) * Tq + row;
      m[i] = in ? m_io[at] : -INFINITY;
      l[i] = in && tq4 == 0 ? l_io[at] : 0.0f;
      const float* src = acc_io + (in ? at : 0) * d;
#pragma unroll
      for (int jb = 0; jb < DP / 8; ++jb) {
        const int col = 8 * jb + 2 * tq4;
        float2 a = make_float2(0.0f, 0.0f);
        if (in && col < d) {
          if (pairs) {
            a = *reinterpret_cast<const float2*>(src + col);
          } else {
            a.x = src[col];
            if (col + 1 < d) a.y = src[col + 1];
          }
        }
        acc[4 * jb + 2 * i] = a.x;
        acc[4 * jb + 2 * i + 1] = a.y;
      }
    }
    // the online softmax of the scores of the tile of keys from k0, in
    // place (sc becomes p); updates m and l, returns the rescale of acc
    const auto softmax = [&](float (&sc)[kN / 2], int k0,
                             float (&corr)[2]) {
      if (k0 + kN > kv_len || (causal && k0 + kN - 1 > wg_row0 + shift)) {
#pragma unroll
        for (int e = 0; e < kN / 2; ++e) {
          const int row = row0 + 8 * ((e >> 1) & 1);
          const int key = k0 + 8 * (e >> 2) + 2 * tq4 + (e & 1);
          if (key >= kv_len || (causal && key > row + shift)) {
            sc[e] = -INFINITY;
          }
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int e = 0; e < kN / 2; ++e) {
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
      }
      float m_log2[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], flash::quad_max(mx[i]) * scale);
        const float m_use = m_new == -INFINITY ? 0.0f : m_new;
        corr[i] = ex2((m[i] - m_use) * hopper::kLog2e);
        m_log2[i] = m_use * hopper::kLog2e;
        m[i] = m_new;
      }
#pragma unroll
      for (int e = 0; e < kN / 2; ++e) {
        const int i = (e >> 1) & 1;
        sc[e] = ex2(fmaf(sc[e], scale_log2, -m_log2[i]));
        rs[i] += sc[e];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
    };
    const auto rescale = [&](const float (&corr)[2]) {
#pragma unroll
      for (int e = 0; e < DP / 2; ++e) acc[e] *= corr[(e >> 1) & 1];
    };
    hopper::mbar_wait(&bar->q_full, q_phase);
    if (n_live == 0 && lane == 0) hopper::mbar_arrive(&bar->q_empty);
    if (n_live > 0) {
      uint32_t p[kN / 16][4];  // P of the previous tile (its P.V pending)
      {  // the first tile: its S alone
        const int s = c % kStages;
        hopper::mbar_wait(&bar->k_full[s], (c / kStages) & 1);
        float sc[kN / 2];
        hopper::wgmma_fence();
        hopper::wgmma_tile_ss<DP, kN, kM>(sc, q_at, k_at + s * C::kKVBytes);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);
        if (lane == 0) {
          hopper::mbar_arrive(&bar->k_empty[s]);
          if (n_live == 1) hopper::mbar_arrive(&bar->q_empty);
        }
        __syncwarp();
        float corr[2];
        softmax(sc, 0, corr);
        rescale(corr);
        hopper::to_a_frags<kN>(p, sc);  // p rounded to v's dtype
      }
      for (int j = 1; j < n_live; ++j) {
        const int ck = c + j;
        const int s = ck % kStages;
        const int sv = (ck - 1) % kStages;  // the previous tile's V
        hopper::mbar_wait(&bar->k_full[s], (ck / kStages) & 1);
        // both waits before the fence: a wait between the two products
        // makes ptxas fence again before P.V (note C7519)
        hopper::mbar_wait(&bar->v_full[sv], ((ck - 1) / kStages) & 1);
        float sc[kN / 2];
        hopper::wgmma_fence();
        hopper::wgmma_tile_ss<DP, kN, kM>(sc, q_at, k_at + s * C::kKVBytes);
        hopper::wgmma_commit();
        hopper::wgmma_tile_rs<DP, kN>(acc, p, v_at + sv * C::kKVBytes);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // S_j done; P.V may still run
        hopper::fence_regs(sc);
        if (lane == 0) {
          hopper::mbar_arrive(&bar->k_empty[s]);
          if (j == n_live - 1) hopper::mbar_arrive(&bar->q_empty);
        }
        __syncwarp();
        float corr[2];
        softmax(sc, j * kN, corr);
        hopper::wgmma_wait<0>();  // P_{j-1} V_{j-1} done
        hopper::fence_regs(acc);
        hopper::fence_regs(p);
        if (lane == 0) hopper::mbar_arrive(&bar->v_empty[sv]);
        __syncwarp();
        rescale(corr);
        hopper::to_a_frags<kN>(p, sc);
      }
      // the last live tile's P.V
      const int cv = c + n_live - 1;
      const int sv = cv % kStages;
      hopper::mbar_wait(&bar->v_full[sv], (cv / kStages) & 1);
      hopper::wgmma_fence();
      hopper::wgmma_tile_rs<DP, kN>(acc, p, v_at + sv * C::kKVBytes);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if (lane == 0) hopper::mbar_arrive(&bar->v_empty[sv]);
      __syncwarp();
    }
    for (int j = n_live; j < w.n; ++j) {  // wholly masked: passed on unread
      const int ck = c + j;
      const int s = ck % kStages;
      const uint32_t phase = (ck / kStages) & 1;
      hopper::mbar_wait(&bar->k_full[s], phase);
      hopper::mbar_wait(&bar->v_full[s], phase);
      if (lane == 0) {
        hopper::mbar_arrive(&bar->k_empty[s]);
        hopper::mbar_arrive(&bar->v_empty[s]);
      }
      __syncwarp();
    }
    c += w.n;

    if (n_live == 0) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float l_row = flash::quad_sum(l[i]);
      const int row = row0 + 8 * i;
      // past Tq, or seeing no key: left as it came
      if (row >= Tq || (causal && row + shift < 0)) continue;
      const long long at = static_cast<long long>(w.bh) * Tq + row;
      float* dst = acc_io + at * d;
#pragma unroll
      for (int jb = 0; jb < DP / 8; ++jb) {
        const int col = 8 * jb + 2 * tq4;
        if (col >= d) continue;
        const float a0 = acc[4 * jb + 2 * i], a1 = acc[4 * jb + 2 * i + 1];
        if (pairs) {
          *reinterpret_cast<float2*>(dst + col) = make_float2(a0, a1);
        } else {
          dst[col] = a0;
          if (col + 1 < d) dst[col + 1] = a1;
        }
      }
      if (tq4 == 0) {
        m_io[at] = m[i];
        l_io[at] = l_row;
      }
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


template <int DP>
int launch_wgmma(const Args& a, flash::Strides sq, flash::Strides sk,
                 int device, cudaStream_t stream) {
  using C = Fold<DP>;
  static const int ready =
      hopper::launch_ready(block_fwd_wgmma_kernel<DP>, C::kSmem);
  if (ready != 0) return ready;
  CUtensorMap mq, mk, mv;
  if (!hopper::encode_bthd(&mq, a.q, a.BH, a.Tq, 1, a.d, sq.b, sq.t, sq.h,
                           C::kM) ||
      !hopper::encode_bthd(&mk, a.k, a.BH, a.Tk, 1, a.d, sk.b, sk.t, sk.h,
                           C::kN) ||
      !hopper::encode_bthd(&mv, a.v, a.BH, a.Tk, 1, a.d, sk.b, sk.t, sk.h,
                           C::kN)) {
    return hopper::kErrTensorMap;
  }
  const long long n_tiles =
      static_cast<long long>((a.Tq + C::kM - 1) / C::kM) * a.BH;
  int grid = 0;
  const cudaError_t err = hopper::persistent_grid(n_tiles, device, &grid);
  if (err != cudaSuccess) return err;
  const int pairs =
      a.d % 2 == 0 && reinterpret_cast<uintptr_t>(a.acc) % 8 == 0;
  block_fwd_wgmma_kernel<DP><<<grid, C::kThreads, C::kSmem, stream>>>(
      mq, mk, mv, a.acc, a.m, a.l, a.Tq, a.d, a.BH, a.q_off - a.k_off,
      a.causal, a.kv_len, pairs, a.scale);
  return cudaGetLastError();
}

// bf16 through TMA and wgmma at 64, 128 or 256 columns (a 128-byte
// swizzle atom is 64 of them), on rows ld apart: the (B*H, T, D) tensors
// seen as (B*H, T, 1, D) with element strides (T*ld, ld, ld).
int launch_bf16(const Args& a, int device, cudaStream_t stream) {
  const long long ld = (a.d + 7) / 8 * 8;
  const flash::Strides sq{a.Tq * ld, ld, ld};
  const flash::Strides sk{a.Tk * ld, ld, ld};
  if (!flash::tma_rows(sq, a.q) || !flash::tma_rows(sk, a.k, a.v)) {
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
  return dispatch(dtype, a, device, static_cast<cudaStream_t>(stream));
}
