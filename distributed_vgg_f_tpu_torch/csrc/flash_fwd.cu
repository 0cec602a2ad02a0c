// Flash attention forward for Hopper (sm_90a): O and the row logsumexp.
//
// Replaces the JAX package's Pallas TPU kernels
// ops/flash_attention.py:_fwd_kernel (with _fwd_update and _fwd_finish)
// and, through its causal loop bound, _fwd_kernel_jagged. For each (b, h)
// and query row i:
//   s_ij = (q_i . k_j) * scale                  (fp32)
//   masked to -inf where j >= kv_len, or j > i when causal
//   m_i = max_j s_ij, l_i = sum_j exp(s_ij - m_i)
//   o_i = sum_j round(exp(s_ij - m_i)) v_j / l_i  (stored in q's dtype)
//   lse_i = m_i + log(l_i)                      (fp32, (B, H, T))
// where round() is the cast of p to v's dtype before P.V. Any head dim
// from 1 to 256 (flash_common.cuh).
//
// Bound, in bf16. ViT-S/16's layer (1024, 197, 6, 64) does 4*T*D FLOP for
// the 8*D bytes of a row (~100 FLOP a byte at T = 197), far below the
// card's ~295 bf16 tensor-core FLOP a byte: device-memory bytes set the
// least time, and with only two 128-row tiles of queries and of keys per
// (b, h), the fixed cost of each tile (a block's start, its loads'
// latency) is what a kernel that serialises copies and products pays.
// Causal (4, 8192, 6, 64) does some 4,000 FLOP a byte over its live pairs:
// the tensor cores' rate sets the least time.
//
// Design of the bf16 kernel (flash_fwd_wgmma_kernel):
// - Persistent: one block of 384 threads per SM walks work tiles of
//   kM = 128 query rows of one (b, h) (grid-stride over the tiles, so B*H
//   has no grid limit). Causal tiles are walked longest first; otherwise
//   a (b, h)'s tiles sit side by side, so its K/V is read again from L2.
// - Warp specialisation: warpgroup 0 is the producer (setmaxnreg down to
//   40 registers); one of its threads issues TMA loads
//   (cp.async.bulk.tensor) through tensor maps over the strided
//   (B, T, H, D) views the model passes, so q, k and v are read in place.
//   The Q tile is loaded once per work tile; K and V go through a ring of
//   kStages = 2 stages, each with its own full and empty mbarriers, so
//   the loads of the next tiles overlap the products of this one. TMA
//   writes zeros for rows past T and columns past D: T = 197 and narrow
//   heads need no padding copy.
// - Two consumer warpgroups (setmaxnreg up to 232) own 64 query rows each.
//   For K/V tile j a consumer issues S_j = Q K_j^T as wgmma with both
//   operands in shared memory (K-major, the 128-byte swizzle the tensor
//   map wrote), then the previous tile's O += P_{j-1} V_{j-1} as wgmma
//   with P in registers (bf16) and V read through the descriptor's
//   transpose, waits for S_j alone, and runs the online softmax of S_j
//   while P.V runs on the tensor cores; it then waits for P.V, rescales
//   O and rounds the new P to bf16. S, P, O, m and l stay in registers.
//   On a short walk (D <= 64 and at most kPingPongMaxTiles K/V tiles, as
//   at T = 197) the two warpgroups take turns to issue their products
//   (ping-pong on two named barriers), so one's softmax, on the exp unit
//   and the CUDA cores, runs while the other's products run on the tensor
//   cores; a longer walk keeps the tensor cores busy with the overlap
//   inside each warpgroup, and wider heads leave the turns nothing to
//   gain.
// - Numerics as the JAX kernel's: fp32 scores scaled in fp32, the
//   softmax statistics in fp32 (exp through ex2 with the scale's log2(e)
//   folded in, a few fp32 ulps), p rounded to bf16 before P.V, an fp32
//   accumulator times 1/l at the end, lse = m * scale + log l.
// - Masks: keys at or past kv_len (which covers keys past T) and, when
//   causal, j > i. Only a tile that holds the diagonal or kv_len pays them.
//   A row that has seen no live key keeps m = -inf and rescales with 0,
//   so -inf - -inf never occurs; a row with none at all gets o = 0 and
//   lse = -inf.
// - Guards: every mbarrier wait is bounded (hopper.cuh: a stalled wait
//   traps); the launcher refuses to start the kernel unless it compiled
//   to the 168 registers a thread that setmaxnreg's budget assumes.
//
// The fp32 version (flash_fwd_kernel) stays on the CUDA cores: a TF32
// product would not meet the fp32 check of 1e-5 of the largest value. A
// block owns R query rows of one (b, h) (R = 64, or 32 at D = 256),
// keeps them in shared memory, and walks the K/V tiles through shared
// memory, carrying m, l and its share of acc in registers.
//
// C interface (ctypes): dvggf_flash_fwd returns cudaGetLastError() after
// the launch, 0 on success; -1 when the driver has no tensor map encoder
// or refuses the layout, -2 when the bf16 kernel did not compile to 168
// registers a thread.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using flash::kThreads;

template <int D, int R>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int H, int T_len, int d,
                     flash::Strides s, int causal, int kv_len, float scale) {
  constexpr int kR = R / 16;
  float* Qs = flash::dyn_smem<float>();  // R x (D+1)
  float* Ks = Qs + R * (D + 1);           // R x (D+1)
  float* Vs = Ks + R * (D + 1);           // R x (D+1)
  float* Ps = Vs + R * (D + 1);           // R x (R+1)
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const flash::Tile tile = flash::tile_of(R, T_len);
  const int q0 = tile.r0;
  const int bh = tile.bh;
  const int b = bh / H;
  const int h = bh % H;
  const long long base = b * s.b + h * s.h;
  flash::load_tile<D, R>(Qs, q, base, s, q0, T_len, d);

  float acc[kR][D / 16];
  float m[kR], l[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.0f;
  }
  // the keys any row of this tile may see
  const int k_end = causal ? min(kv_len, q0 + R) : kv_len;
  for (int k0 = 0; k0 < k_end; k0 += R) {
    __syncthreads();  // the last tile's readers of Ks, Vs and Ps are done
    flash::load_tile<D, R>(Ks, k, base, s, k0, T_len, d);
    flash::load_tile<D, R>(Vs, v, base, s, k0, T_len, d);
    __syncthreads();
    float sc[kR][kR];
    flash::dot_tile<D, R>(sc, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int qp = q0 + ty * kR + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
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

  const flash::Strides os = flash::dense_strides(T_len, H, d);
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = q0 + ty * kR + i;
    if (row >= T_len) continue;
    const long long at = b * os.b + row * os.t + h * os.h;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      if (tx + 16 * j < d) {
        o[at + tx + 16 * j] = l[i] > 0.0f ? acc[i][j] / l[i] : 0.0f;
      }
    }
    if (tx == 0) {
      lse[static_cast<long long>(bh) * T_len + row] =
          l[i] > 0.0f ? m[i] + logf(l[i]) : -INFINITY;
    }
  }
}


// ------------------------------------------------------------- bf16
// the named barriers of the two consumer warpgroups' turns to issue
constexpr int kTurnBarrier = 1;  // warpgroup w's is kTurnBarrier + w
constexpr int kTurnThreads = 256;
// work tiles of at most this many K/V tiles take turns at D <= 64
constexpr int kPingPongMaxTiles = 4;

template <int DP>
struct Fwd {
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

using flash::Work;
using hopper::ex2;

template <int DP>
__global__ void __launch_bounds__(384, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int H, int T_len, int d,
                           int BH, int causal, int kv_len, float scale) {
  using C = Fwd<DP>;
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

  const int wg = threadIdx.x / 128;
  const int nq = (T_len + kM - 1) / kM;
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
    int c = 0;  // K/V tiles loaded so far
    int it = 0;
    for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
      const Work w = flash::query_walk(t, BH, H, nq, kM, kN, causal, kv_len);
      hopper::mbar_wait(&bar->q_empty, (it & 1) ^ 1);
      hopper::mbar_expect_tx(&bar->q_full, C::kQBytes);
#pragma unroll
      for (int ch = 0; ch < C::kChunks; ++ch) {
        hopper::tma_load_4d(sQ + ch * kM * 128, &tq, &bar->q_full, 64 * ch,
                            w.h, w.r0, w.b);
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
                              64 * ch, w.h, j * kN, w.b);
        }
        hopper::mbar_wait(&bar->v_empty[s], free_parity);
        hopper::mbar_expect_tx(&bar->v_full[s], C::kKVBytes);
#pragma unroll
        for (int ch = 0; ch < C::kChunks; ++ch) {
          hopper::tma_load_4d(v_at + ch * kN * 128, &tv, &bar->v_full[s],
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
  const uint32_t q_at = hopper::smem_addr(sQ) + cw * 64 * 128;
  const uint32_t k_at = hopper::smem_addr(sK);
  const uint32_t v_at = hopper::smem_addr(sV);
  // ping-pong: warpgroup 0 takes the first turn to issue
  if (cw == 1) hopper::named_arrive(kTurnBarrier, kTurnThreads);
  int c = 0;
  int it = 0;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
    const Work w = flash::query_walk(t, BH, H, nq, kM, kN, causal, kv_len);
    const int wg_row0 = w.r0 + 64 * cw;
    // both warpgroups walk the same tiles, so they agree on taking turns
    // (and a tile leaves the turn where it found it)
    const bool ping_pong = DP == 64 && w.n <= kPingPongMaxTiles;
    // this thread's rows of the accumulators: row0 and row0 + 8; its
    // columns 8*(e/4) + 2*(lane%4) + (e%2) of each 8-column group
    const int row0 = wg_row0 + 16 * warp + lane / 4;
    float acc[DP / 2];
#pragma unroll
    for (int e = 0; e < DP / 2; ++e) acc[e] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY};  // on the unscaled scores
    float l[2] = {0.0f, 0.0f};            // this thread's share of the row
    uint32_t p[kN / 16][4];
    hopper::mbar_wait(&bar->q_full, it & 1);
    for (int j = 0; j < w.n; ++j) {
      const int ck = c + j;
      const int sk = ck % kStages;
      hopper::mbar_wait(&bar->k_full[sk], (ck / kStages) & 1);
      float sc[kN / 2];
      if (ping_pong) hopper::named_sync(kTurnBarrier + cw, kTurnThreads);
      hopper::wgmma_fence();
      hopper::wgmma_tile_ss<DP, kN, kM>(sc, q_at, k_at + sk * C::kKVBytes);
      hopper::wgmma_commit();
      const int cv = ck - 1;  // the V tile of the previous step
      const int sv = (cv + kStages) % kStages;
      if (j > 0) {
        hopper::mbar_wait(&bar->v_full[sv], (cv / kStages) & 1);
        hopper::wgmma_tile_rs<DP, kN>(acc, p, v_at + sv * C::kKVBytes);
        hopper::wgmma_commit();
        if (ping_pong) {
          hopper::named_arrive(kTurnBarrier + 1 - cw, kTurnThreads);
        }
        hopper::wgmma_wait<1>();  // S_j done; P.V may still run
      } else {
        if (ping_pong) {
          hopper::named_arrive(kTurnBarrier + 1 - cw, kTurnThreads);
        }
        hopper::wgmma_wait<0>();
      }
      hopper::fence_regs(sc);
      if (lane == 0) {
        hopper::mbar_arrive(&bar->k_empty[sk]);
        if (j == w.n - 1) hopper::mbar_arrive(&bar->q_empty);
      }
      __syncwarp();

      const int k0 = j * kN;
      if (k0 + kN > kv_len || (causal && k0 + kN - 1 > wg_row0)) {
#pragma unroll
        for (int e = 0; e < kN / 2; ++e) {
          const int row = row0 + 8 * ((e >> 1) & 1);
          const int key = k0 + 8 * (e >> 2) + 2 * tq4 + (e & 1);
          if (key >= kv_len || (causal && key > row)) sc[e] = -INFINITY;
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int e = 0; e < kN / 2; ++e) {
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
      }
      float corr[2], m_log2[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = flash::quad_max(mx[i]);
        const float m_use = mx[i] == -INFINITY ? 0.0f : mx[i];
        corr[i] = ex2((m[i] - m_use) * scale_log2);
        m_log2[i] = m_use * scale_log2;
        m[i] = mx[i];
      }
#pragma unroll
      for (int e = 0; e < kN / 2; ++e) {
        const int i = (e >> 1) & 1;
        sc[e] = ex2(fmaf(sc[e], scale_log2, -m_log2[i]));
        rs[i] += sc[e];
      }
      if (j > 0) {
        hopper::wgmma_wait<0>();  // P_{j-1} V_{j-1} done
        hopper::fence_regs(acc);
        hopper::fence_regs(p);
        if (lane == 0) hopper::mbar_arrive(&bar->v_empty[sv]);
        __syncwarp();
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
#pragma unroll
      for (int e = 0; e < DP / 2; ++e) acc[e] *= corr[(e >> 1) & 1];
      hopper::to_a_frags<kN>(p, sc);
    }
    {  // the last tile's P.V
      const int cv = c + w.n - 1;
      const int sv = cv % kStages;
      hopper::mbar_wait(&bar->v_full[sv], (cv / kStages) & 1);
      if (ping_pong) hopper::named_sync(kTurnBarrier + cw, kTurnThreads);
      hopper::wgmma_fence();
      hopper::wgmma_tile_rs<DP, kN>(acc, p, v_at + sv * C::kKVBytes);
      hopper::wgmma_commit();
      if (ping_pong) {
        hopper::named_arrive(kTurnBarrier + 1 - cw, kTurnThreads);
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if (lane == 0) hopper::mbar_arrive(&bar->v_empty[sv]);
      __syncwarp();
    }
    c += w.n;

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float l_row = flash::quad_sum(l[i]);
      const float inv_l = l_row > 0.0f ? 1.0f / l_row : 0.0f;
      const int row = row0 + 8 * i;
      if (row >= T_len) continue;
      __nv_bfloat16* out =
          o + ((static_cast<long long>(w.b) * T_len + row) * H + w.h) * d;
#pragma unroll
      for (int jb = 0; jb < DP / 8; ++jb) {
        const int col = 8 * jb + 2 * tq4;
        if (col >= d) continue;
        const float v0 = acc[4 * jb + 2 * i] * inv_l;
        const float v1 = acc[4 * jb + 2 * i + 1] * inv_l;
        if (d % 2 == 0) {
          *reinterpret_cast<uint32_t*>(out + col) = flash::pack_bf16(v0, v1);
        } else {
          out[col] = __float2bfloat16(v0);
          if (col + 1 < d) out[col + 1] = __float2bfloat16(v1);
        }
      }
      if (tq4 == 0) {
        lse[static_cast<long long>(w.bh) * T_len + row] =
            l_row > 0.0f ? m[i] * scale + logf(l_row) : -INFINITY;
      }
    }
  }
}

template <int DP>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int T_len, int H, int d, flash::Strides s,
                 int causal, int kv_len, float scale, int device,
                 cudaStream_t stream) {
  using C = Fwd<DP>;
  static const int ready =
      hopper::launch_ready(flash_fwd_wgmma_kernel<DP>, C::kSmem);
  if (ready != 0) return ready;
  CUtensorMap mq, mk, mv;
  if (!hopper::encode_bthd(&mq, q, B, T_len, H, d, s.b, s.t, s.h, C::kM) ||
      !hopper::encode_bthd(&mk, k, B, T_len, H, d, s.b, s.t, s.h, C::kN) ||
      !hopper::encode_bthd(&mv, v, B, T_len, H, d, s.b, s.t, s.h, C::kN)) {
    return hopper::kErrTensorMap;
  }
  const long long n_tiles =
      static_cast<long long>((T_len + C::kM - 1) / C::kM) * B * H;
  int grid = 0;
  const cudaError_t err = hopper::persistent_grid(n_tiles, device, &grid);
  if (err != cudaSuccess) return err;
  flash_fwd_wgmma_kernel<DP><<<grid, C::kThreads, C::kSmem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, H, T_len, d, B * H,
      causal, kv_len, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int T_len, int H, int d,
                   flash::Strides s, int causal, int kv_len, float scale,
                   cudaStream_t stream) {
  constexpr int R = flash::rows_fp32<D>();
  constexpr size_t smem = flash::smem_bytes<D, R>(3, 1, 0);
  static const cudaError_t opt_in =
      flash::allow_smem(flash_fwd_kernel<D, R>, smem);
  if (opt_in != cudaSuccess) return opt_in;
  dim3 grid;
  const cudaError_t err = flash::grid_of(T_len, R, B * H, &grid);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<D, R><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, T_len, d,
      s, causal, kv_len, scale);
  return cudaGetLastError();
}

// fp32 on the CUDA cores at d's padded width; bf16 through TMA and wgmma
// at 64, 128 or 256 columns (a 128-byte swizzle atom is 64 of them).
int dispatch(int dtype, int d, const void* q, const void* k, const void* v,
             void* o, float* lse, int B, int T_len, int H, flash::Strides s,
             int causal, int kv_len, float scale, int device,
             cudaStream_t stream) {
  if (dtype == 0) {
    FLASH_PADDED_DIMS(d, return launch<DP>(q, k, v, o, lse, B, T_len, H, d, s,
                                           causal, kv_len, scale, stream))
  }
  if (dtype != 1 || !flash::tma_rows(s, q, k, v)) {
    return cudaErrorInvalidValue;  // TMA's 16-byte rules
  }
  switch (flash::padded_dim(d)) {
    case 16:
    case 32:
    case 64:
      return launch_wgmma<64>(q, k, v, o, lse, B, T_len, H, d, s, causal,
                              kv_len, scale, device, stream);
    case 128:
      return launch_wgmma<128>(q, k, v, o, lse, B, T_len, H, d, s, causal,
                               kv_len, scale, device, stream);
    case 256:
      return launch_wgmma<256>(q, k, v, o, lse, B, T_len, H, d, s, causal,
                               kv_len, scale, device, stream);
    default:
      return cudaErrorInvalidValue;
  }
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
  return dispatch(dtype, D, q, k, v, o, lse, B, T_len, H,
                  flash::Strides{sb, st, sh}, causal, kv_len, scale, device,
                  static_cast<cudaStream_t>(stream));
}
