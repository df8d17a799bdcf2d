// The GEMM mainloop for Hopper (sm_90a) that csrc/swiglu.cu and the GEMM
// role of csrc/fused_overlap.cu share: bf16 in, f32 accumulate, written by
// hand in PTX (wgmma.mma_async, cp.async.bulk.tensor, mbarrier).
//
// A CTA walks the steps its schedule gives it.  A step is one K tile (BK =
// 64) of one output tile of Tile::BM rows of x by Tile::BN weight columns:
// acc_i += x[m0:, k0:k0 + 64] @ w_i[k0:k0 + 64, n0:] for NMAT weight
// matrices at once (SwiGLU's gate and up share the x tile); after a tile's
// last step the caller's epilogue takes the f32 sums.
//
// What bounds a GEMM on the card: operations at large M (2 M N K flops on
// the tensor cores, which only wgmma reaches at full rate), the weights'
// bytes at decode-size M.  What the design does about it:
//   * Tiles: RowTile puts x's rows on wgmma's 64-row (M) side, each
//     consumer warpgroup running m64n128k16 (prefill sizes, the fused op).
//     SwapTile puts the weights' columns there and x's TN rows on the N
//     side (m64nTNk16, TN 8..64, "swap AB"): at decode sizes no product
//     row is padding and the accumulators stay small.
//   * Loads: TMA copies of x (M, K), K-major, and of the weights (K, N)
//     row-major, so MN-major for wgmma (its transpose bit: B's for a row
//     tile, A's for a swap tile), both with the 128-byte swizzle.  An x
//     stage is BM rows of 64 K (128 bytes each), a weight stage BN / 64
//     boxes of 64 K rows x 64 columns per matrix.  The ring of STAGES
//     stages sits in dynamic shared memory aligned to 1024 bytes, the
//     swizzle's period.  TMA fills the parts of a box past M, N or K with
//     zeros, so ragged edges need no masked loads; epilogues guard their
//     stores.
//   * Barriers: each stage has a full mbarrier (one arrival, the producer's
//     expect_tx; the copies' bytes complete it) and an empty mbarrier (one
//     arrival per consumer warp, once that warp's products of the stage
//     are done).
//   * Products: operands straight from the swizzled stage, the first
//     product of a tile with scale-d = 0 (no zeroing of the accumulators);
//     each warpgroup keeps one stage's products in flight while it starts
//     the next stage's.  Nothing but wgmma touches the accumulators inside
//     the K loop; the epilogue runs after it, so ptxas keeps the products
//     asynchronous.
//   * Producer: a warp of its own that starts every load of the CTA and
//     waits only on the empty barriers, or (where the CTA size is fixed,
//     as in the fused op) thread 0 between its own products, STAGES steps
//     ahead.  The step list runs across tiles, so the ring is already
//     loading the next tile while the current tile's epilogue runs.
//   * Tensor maps are built on the host with cuTensorMapEncodeTiled,
//     fetched through the runtime's cudaGetDriverEntryPoint, so no library
//     links libcuda; kernels take them as __grid_constant__ parameters.
// Inputs: K % 8 == 0, N % 8 == 0 and 16-byte aligned bases (TMA's global
// strides and addresses), K > 0.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gemm_sm90 {

constexpr int BK = 64;             // K per stage: one 128-byte swizzle row
constexpr int WG_THREADS = 128;
constexpr int ROW_BYTES = BK * 2;  // one swizzled row: 64 bf16
constexpr int BOX_BYTES = BK * 64 * 2;   // one 64 x 64 weight box

// One step of a CTA's schedule: the K tile at k0 of the tile at (m0, n0).
struct Step {
  int m0, n0, k0;
};

// ---------------------------------------------------------------------------
// PTX
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::"r"(
          bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

// Returns once the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// A box of `map` at (column c0, row c1) into shared memory, completing
// `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma's shared-memory matrix descriptor with the 128-byte swizzle:
// start address, leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// x, K-major: rows 128 bytes apart, groups of 8 rows 1024 bytes apart (the
// leading offset is unused by a swizzled K-major operand).
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return smem_desc(addr, 16, 8 * ROW_BYTES);
}

// The weights, MN-major: 64 columns per 128-byte row, the next 64 columns
// one box further (leading offset), groups of 8 K rows 1024 bytes apart
// (stride offset).
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
  return smem_desc(addr, BOX_BYTES, 8 * ROW_BYTES);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators
// across a wgmma fence or wait (they are written asynchronously).
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma m64nNk16 writes d (64 x N, f32): thread t of the warpgroup holds,
// for j < N / 8, d[4j + {0, 1}] at row 16 (t / 32) + (t % 32) / 4 and
// columns 8 j + 2 (t % 4) + {0, 1}, and d[4j + {2, 3}] eight rows below.
__device__ __forceinline__ int frag_row(int i) {
  const int t = threadIdx.x % WG_THREADS;
  return 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) & 1);
}

__device__ __forceinline__ int frag_col(int i) {
  return 8 * (i / 4) + 2 * (threadIdx.x % 4) + (i & 1);
}

// d (64 x 128) = A (64 x 16, K-major) @ B (16 x 128, MN-major) + (d if
// `accumulate`, else 0).
__device__ __forceinline__ void mma_n128(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N) = A (64 x 16, MN-major) @ B (16 x N, K-major) + (d if
// `accumulate`, else 0), N = 8, 16, 32 or 64.
template <int N>
__device__ __forceinline__ void mma_swap(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate);

template <>
__device__ __forceinline__ void mma_swap<8>(float (&d)[4], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_swap<16>(float (&d)[8], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_swap<32>(float (&d)[16], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, %16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_swap<64>(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// ---------------------------------------------------------------------------
// Attention forms (csrc/flash_attention.cu)
// ---------------------------------------------------------------------------
// A box of a 4-D `map` at coordinates (c0, c1, c2, c3), innermost first,
// into shared memory, completing `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// Orders this thread's generic-proxy writes to shared memory before later
// reads of it by wgmma or TMA (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x 64) = A (64 x 16, K-major) @ B (16 x 64, K-major) + (d if
// `accumulate`, else 0): scores, Q as A and a K stage (keys as rows) as B.
__device__ __forceinline__ void mma_kk_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N) = A (64 x 16, from registers) @ B (16 x N, MN-major) + (d if
// `accumulate`, else 0), N = 64 or 128: A is four bf16 pairs a thread holds
// in the accumulator layout of a 64 x 16 slice (frag_row / frag_col), so an
// f32 product converts in place into the A of the next one.
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db,
                                       int accumulate);

template <>
__device__ __forceinline__ void mma_rs<64>(float (&d)[32],
                                          const uint32_t (&a)[4], uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_rs<128>(float (&d)[64],
                                          const uint32_t (&a)[4], uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// ---------------------------------------------------------------------------
// Tiles
// ---------------------------------------------------------------------------
// x's rows on wgmma's M side: a tile of 128 rows by 128 columns, two
// consumer warpgroups stacked, warpgroup w owning rows 64 w.
struct RowTile {
  static constexpr int BM = 128;
  static constexpr int BN = 128;
  static constexpr int WGS = 2;
  static constexpr int ACC = 64;   // f32 sums a thread holds per matrix
  static constexpr bool SWAP = false;

  // byte offsets of warpgroup wg's part of an x and of a weight stage
  __device__ static uint32_t x_off(int wg) { return wg * 64 * ROW_BYTES; }
  __device__ static uint32_t w_off(int) { return 0; }
  // the products of 16 of K (kk-th of the stage) of one weight matrix, x
  // and w the warpgroup's parts of the stage
  __device__ static void mma(float (&d)[ACC], uint32_t x, uint32_t w, int kk,
                             int accumulate) {
    mma_n128(d, kmajor_desc(x + kk * 32),
             mnmajor_desc(w + kk * 16 * ROW_BYTES), accumulate);
  }
  // row of x and weight column, within the tile, of the thread's sum i
  __device__ static int row(int i) {
    return 64 * (threadIdx.x / WG_THREADS) + frag_row(i);
  }
  __device__ static int col(int i) { return frag_col(i); }
};

// Swap AB: the weights' columns on wgmma's M side, x's TN rows on its N
// side: a tile of TN rows by 128 columns, two consumer warpgroups side by
// side, warpgroup w owning columns 64 w.
template <int TN>
struct SwapTile {
  static constexpr int BM = TN;
  static constexpr int BN = 128;
  static constexpr int WGS = 2;
  static constexpr int ACC = TN / 2;
  static constexpr bool SWAP = true;

  __device__ static uint32_t x_off(int) { return 0; }
  __device__ static uint32_t w_off(int wg) { return wg * BOX_BYTES; }
  __device__ static void mma(float (&d)[ACC], uint32_t x, uint32_t w, int kk,
                             int accumulate) {
    mma_swap<TN>(d, mnmajor_desc(w + kk * 16 * ROW_BYTES),
                 kmajor_desc(x + kk * 32), accumulate);
  }
  __device__ static int row(int i) { return frag_col(i); }
  __device__ static int col(int i) {
    return 64 * (threadIdx.x / WG_THREADS) + frag_row(i);
  }
};

// The shared-memory ring of a tile, NMAT weight matrices and STAGES stages:
// stage s holds the x tile, then each matrix's BN / 64 boxes, then the
// barriers.
template <class Tile, int NMAT, int STAGES>
struct Ring {
  static constexpr int CONSUMERS = WG_THREADS * Tile::WGS;
  static constexpr int A_BYTES = Tile::BM * ROW_BYTES;
  static constexpr int BOXES = Tile::BN / 64;
  static constexpr int B_BYTES = BOXES * BOX_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + NMAT * B_BYTES;
  // the stages, their barriers and the slack that aligns them to 1024
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
  static_assert(A_BYTES % 1024 == 0, "x tiles of whole 8-row groups");

  uint32_t base;   // shared address of stage 0
  uint32_t bars;   // full[STAGES], then empty[STAGES]

  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 8 * (STAGES + s); }
  __device__ uint32_t a(int s) const { return base + s * STAGE_BYTES; }
  __device__ uint32_t b(int s, int mat) const {
    return a(s) + A_BYTES + mat * B_BYTES;
  }
};

// ---------------------------------------------------------------------------
// The mainloop
// ---------------------------------------------------------------------------
// Runs every step of `sched` and calls epilogue(step, acc),
// acc[NMAT][Tile::ACC] the f32 sums of the calling thread, after each
// tile's last step.  `sched` gives steps() and, for step i, at(i) and
// span(i): the steps left in its tile from i on (i being a tile's first
// step).  Warpgroups [0, Tile::WGS) consume; with PRODUCER the next warp
// starts the loads and returns, else thread 0 starts them between its own
// products.  b_maps[i] is weight matrix i's tensor map.
template <class Tile, int NMAT, int STAGES, bool PRODUCER, class Sched,
          class Epilogue>
__device__ __forceinline__ void run(unsigned char* smem,
                                    const CUtensorMap* a_map,
                                    const CUtensorMap* const (&b_maps)[NMAT],
                                    const Sched& sched, Epilogue&& epilogue) {
  using R = Ring<Tile, NMAT, STAGES>;
  R ring;
  ring.base = (smem_u32(smem) + 1023u) & ~1023u;
  ring.bars = ring.base + STAGES * R::STAGE_BYTES;
  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(ring.full(s), 1);
      mbar_init(ring.empty(s), R::CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n = sched.steps();
  auto load = [&](int p) {
    const Step st = sched.at(p);
    const int s = p % STAGES;
    const uint32_t bar = ring.full(s);
    if (p >= STAGES) mbar_wait(ring.empty(s), ((p / STAGES) + 1) & 1);
    mbar_expect_tx(bar, R::STAGE_BYTES);
    tma_load(ring.a(s), a_map, bar, st.k0, st.m0);
#pragma unroll
    for (int mat = 0; mat < NMAT; ++mat)
#pragma unroll
      for (int h = 0; h < R::BOXES; ++h)
        tma_load(ring.b(s, mat) + h * BOX_BYTES, b_maps[mat], bar,
                 st.n0 + 64 * h, st.k0);
  };
  if (PRODUCER && tid >= R::CONSUMERS) {
    if (tid == R::CONSUMERS)
      for (int p = 0; p < n; ++p) load(p);
    return;
  }
  int p = 0;   // thread 0 without a producer warp: the next step to load
  if (!PRODUCER && tid == 0)
    for (; p < n && p < STAGES; ++p) load(p);

  const int wg = tid / WG_THREADS;
  const uint32_t x_off = Tile::x_off(wg);
  const uint32_t w_off = Tile::w_off(wg);
  const bool lead = (tid % 32) == 0;
  float acc[NMAT][Tile::ACC];
  for (int c = 0; c < n;) {
    const int span = sched.span(c);
    for (int j = 0; j < span; ++j, ++c) {
      const int s = c % STAGES;
      mbar_wait(ring.full(s), (c / STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int mat = 0; mat < NMAT; ++mat)
          Tile::mma(acc[mat], ring.a(s) + x_off, ring.b(s, mat) + w_off, kk,
                    j > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();   // the previous step's products are done
      if (j > 0 && lead) mbar_arrive(ring.empty((c + STAGES - 1) % STAGES));
      if (!PRODUCER && tid == 0) {
        // steps [0, c) are released by this warp; the other warps release
        // them as their products finish
        for (; p < n && p < c + STAGES; ++p) load(p);
      }
      __syncwarp();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mat = 0; mat < NMAT; ++mat) fence_acc(acc[mat]);
    if (lead) mbar_arrive(ring.empty((c + STAGES - 1) % STAGES));
    if (!PRODUCER && tid == 0)
      for (; p < n && p < c + STAGES; ++p) load(p);
    __syncwarp();
    epilogue(sched.at(c - 1), acc);
  }
}

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, and the device's primary context made current on
// the calling thread first: the encoder is a driver call and refuses a map
// (CUDA_ERROR_INVALID_CONTEXT) on a thread with no current context, such
// as autograd's device thread before anything has launched from it.  The
// runtime's cudaSetDevice binds the context; once a thread.
static inline EncodeTiled encoder() {
  static thread_local bool bound = false;
  if (!bound) {
    int dev = 0;
    bound = cudaGetDevice(&dev) == cudaSuccess &&
            cudaSetDevice(dev) == cudaSuccess;
  }
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a row-major bf16 matrix (rows, cols) read in boxes of
// box_rows rows x 64 columns with the 128-byte swizzle; out-of-bounds
// elements read as zeros.  False if cuTensorMapEncodeTiled refuses it.
static inline bool encode(CUtensorMap* map, const void* base, int rows,
                          int cols, int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}


// The map of a bf16 tensor of rank 4, dims[0] innermost with unit stride
// and strides[i] the byte stride of dims[i + 1], read in boxes of box[0] =
// 64 x box[1] x box[2] x box[3] elements with the 128-byte swizzle (a box
// lands as box[1] * box[2] * box[3] rows of 128 bytes); out-of-bounds
// elements read as zeros.  False if cuTensorMapEncodeTiled refuses it.
static inline bool encode_4d(CUtensorMap* map, const void* base,
                             const cuuint64_t (&dims)[4],
                             const cuuint64_t (&strides)[3],
                             const cuuint32_t (&box)[4]) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace gemm_sm90
