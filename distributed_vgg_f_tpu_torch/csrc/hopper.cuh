// Hopper (sm_90a) building blocks for the port's kernels, as inline PTX:
// mbarriers with bounded waits, TMA tile loads through a CUtensorMap,
// wgmma shared-memory descriptors, the warpgroup products and their loops
// over a tile, and the host side that encodes a tensor map through the
// driver's entry point and checks that a warp-specialised kernel may
// start.
//
// Guards: every mbarrier wait here is bounded. A wait that has not seen
// its phase complete after kWaitLimitNs of the GPU's global timer calls
// __trap(), which ends the kernel with an error that the next
// synchronisation raises (a RuntimeError in PyTorch), instead of hanging
// the card.
//
// The tensor map is encoded on the host by cuTensorMapEncodeTiled, which
// is reached through cudaGetDriverEntryPoint, so the build links no
// -lcuda; <cuda.h> is read for its types and enums only.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

// ----------------------------------------------------------- mbarriers
// How long a wait may go unanswered before the kernel traps (4 s).
constexpr unsigned long long kWaitLimitNs = 4000000000ull;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One arrival that also expects `bytes` of TMA transactions this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Waits until the phase of parity `parity` of `bar` has completed; traps
// past kWaitLimitNs.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  if (mbar_try_wait(addr, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(addr, parity)) {
    if (global_ns() - t0 > kWaitLimitNs) __trap();
  }
}

// ----------------------------------------------------------------- TMA
__device__ __forceinline__ void prefetch_tensor_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// The box of a 4-d tensor map at coordinates (c0, c1, c2, c3), innermost
// first, into shared memory at dst; completion is counted on `bar`.
// Elements outside the tensor are written as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// 2^x on the exp unit (ex2.approx, ~2 ulp of fp32; -inf gives +0): the
// flash kernels' exp(x) is ex2(x * log2(e)) with log2(e) folded into the
// scale.
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------ named barriers
// Barriers 1..15 of the block (0 is __syncthreads'): bar.sync waits until
// `count` threads have arrived, its own warp's included; bar.arrive
// arrives without waiting.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ----------------------------------------------------------------- wgmma
// A shared-memory matrix descriptor for the 128-byte swizzle (the layout
// a tensor map with CU_TENSOR_MAP_SWIZZLE_128B writes: rows of 128 bytes,
// 8-row atoms of 1024 bytes): start address, leading byte offset (LBO),
// stride byte offset (SBO = 1024, the next 8 rows), layout type 1. For a
// K-major operand the LBO is unused; for an MN-major one it is the step to
// the next 64 columns (the next 128-byte swizzle atom).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr,
                                               uint32_t lbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers that an asynchronous wgmma reads or writes: the compiler
// may not move their other uses across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

// Hand registers between the warpgroups of a warp-specialised block (all
// four warps of a warpgroup execute it): a producer gives up what it does
// not need, the consumers take it. A 384-thread block launched at 168
// registers a thread holds 64512, enough for 40 + 2 * 232 a thread of 128
// threads each; setmaxnreg.inc waits until the registers are free.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// D (64 x 32, fp32) (+)= A (64 x 16) B (16 x 32), A and B bf16 in shared
// memory, both K-major with the 128-byte swizzle; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 64, fp32) (+)= A (64 x 16) B (16 x 64), A and B bf16 in shared
// memory, both K-major with the 128-byte swizzle; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 128, fp32) (+)= A (64 x 16) B (16 x 128), A and B bf16 in shared
// memory, both K-major with the 128-byte swizzle; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 64, fp32) += A (64 x 16) B (16 x 64): A bf16 in registers (the
// mma.m16n8k16 A fragment of each warp's 16 rows), B bf16 in shared memory,
// MN-major with the 128-byte swizzle (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16) B (16 x 128): A bf16 in registers (the
// mma.m16n8k16 A fragment of each warp's 16 rows), B bf16 in shared memory,
// MN-major with the 128-byte swizzle (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// ---------------------------------------------------------- tile products
// A tile of R rows and DP columns as TMA writes it with boxes of 64
// columns and the 128-byte swizzle: DP / 64 chunks of R rows of 128 bytes,
// chunk c at c * R * 128 bytes. These loops issue the flash kernels'
// products over such tiles (a wgmma_fence before them, a commit after).

// D (64 x N) = A B^T: A is 64 rows of a tile of kRowsA rows (a_rows is the
// shared address of its first row in chunk 0), B all N rows of a tile at
// b_tile; the DP columns of both are the contraction (K-major).
template <int DP, int N, int kRowsA>
__device__ __forceinline__ void wgmma_tile_ss(float (&d)[N / 2],
                                              uint32_t a_rows,
                                              uint32_t b_tile) {
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    // 16 columns: chunk ks / 4, 32 bytes into its rows
    const uint64_t a =
        desc_sw128(a_rows + (ks / 4) * kRowsA * 128 + (ks % 4) * 32, 0);
    const uint64_t b =
        desc_sw128(b_tile + (ks / 4) * N * 128 + (ks % 4) * 32, 0);
    if constexpr (N == 32) {
      wgmma_ss_n32(d, a, b, ks > 0);
    } else if constexpr (N == 64) {
      wgmma_ss_n64(d, a, b, ks > 0);
    } else {
      static_assert(N == 128, "N is 32, 64 or 128");
      wgmma_ss_n128(d, a, b, ks > 0);
    }
  }
}

// D (64 x W) += A B: A (64 x R) in registers, one m16n8k16 A fragment per
// 16 of its columns; B the W columns of a tile of R rows that start at
// chunk_at (the shared address of their first chunk), read MN-major
// through the descriptor's transpose (LBO: the next chunk).
template <int W, int R>
__device__ __forceinline__ void wgmma_tile_rs(float (&d)[W / 2],
                                              const uint32_t (&a)[R / 16][4],
                                              uint32_t chunk_at) {
#pragma unroll
  for (int kk = 0; kk < R / 16; ++kk) {
    const uint32_t at = chunk_at + kk * 16 * 128;  // 16 rows further
    if constexpr (W == 64) {
      wgmma_rs_n64(d, a[kk], desc_sw128(at, R * 128));
    } else {
      static_assert(W % 128 == 0, "W is 64, 128 or 256");
#pragma unroll
      for (int half = 0; half < W / 128; ++half) {
        wgmma_rs_n128(d + 64 * half, a[kk],
                      desc_sw128(at + half * 2 * R * 128, R * 128));
      }
    }
  }
}

// The accumulator of an m64nN product (fp32, N / 2 a thread) rounded to
// bf16 as the A fragments of a product that contracts its N columns: the
// thread's values of columns 16 kk .. 16 kk + 15 are d[8 kk .. 8 kk + 7].
template <int N>
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[N / 16][4],
                                           const float (&d)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float lo = d[8 * kk + 2 * r], hi = d[8 * kk + 2 * r + 1];
      a[kk][r] = static_cast<uint32_t>(
                     __bfloat16_as_ushort(__float2bfloat16(lo))) |
                 (static_cast<uint32_t>(
                      __bfloat16_as_ushort(__float2bfloat16(hi)))
                  << 16);
    }
  }
}

// ------------------------------------------------------------------ host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver (no -lcuda), or nullptr.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-d bf16 tensor map over dims[0..3] (innermost first, dims[0]
// contiguous), strides in bytes of dims 1..3, box box[0..3], with the
// 128-byte swizzle and zero fill outside the tensor. False on failure.
inline bool encode_bf16_4d(CUtensorMap* map, const void* base,
                           const uint64_t (&dims)[4],
                           const uint64_t (&strides)[3],
                           const uint32_t (&box)[4]) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t gdim[4], gstride[3];
  cuuint32_t gbox[4], estride[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) {
    gdim[i] = dims[i];
    gbox[i] = box[i];
  }
  for (int i = 0; i < 3; ++i) gstride[i] = strides[i];
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(base), gdim, gstride, gbox, estride,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A tensor map over a bf16 (B, T, H, d) tensor with element strides
// (sb, st, sh) and a contiguous last axis, whose box is 64 columns of
// `rows` consecutive t of one (b, h): coordinates (column, h, t, b).
inline bool encode_bthd(CUtensorMap* map, const void* base, int B, int T,
                        int H, int d, long long sb, long long st,
                        long long sh, uint32_t rows) {
  const uint64_t dims[4] = {static_cast<uint64_t>(d),
                            static_cast<uint64_t>(H),
                            static_cast<uint64_t>(T),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {static_cast<uint64_t>(sh) * 2,
                               static_cast<uint64_t>(st) * 2,
                               static_cast<uint64_t>(sb) * 2};
  const uint32_t box[4] = {64, 1, rows, 1};
  return encode_bf16_4d(map, base, dims, strides, box);
}

// What the warp-specialised launchers return besides CUDA's own errors.
constexpr int kErrTensorMap = -1;  // no tensor map encoder, or refused
constexpr int kErrRegisters = -2;  // not compiled to kRegsAtLaunch
// A 384-thread block's registers a thread at launch: setmaxnreg's
// 40 + 2 * 232 of 128 threads need 168, and with fewer setmaxnreg.inc
// would wait for ever.
constexpr int kRegsAtLaunch = 168;

// 0 when a warp-specialised kernel may start with `smem` bytes of dynamic
// shared memory and compiled to kRegsAtLaunch registers a thread; else a
// CUDA error or kErrRegisters.
template <typename Kernel>
inline int launch_ready(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  return attr.numRegs == kRegsAtLaunch ? 0 : kErrRegisters;
}

// The grid of a persistent kernel: one block an SM, at most n_tiles.
inline cudaError_t persistent_grid(long long n_tiles, int device,
                                   int* grid) {
  int sms = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  *grid = static_cast<int>(n_tiles < sms ? n_tiles : sms);
  return cudaSuccess;
}

}  // namespace hopper
