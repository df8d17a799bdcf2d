// The backward of causal GQA flash attention, for Hopper (sm_90a), with a
// plain C interface loaded through ctypes.
//
// Replaces no TPU kernel: the JAX package differentiates its attention
// through XLA (src/repro/kernels/flash_attention.py `flash_attention` has no
// backward Pallas kernel).  It is the gradient of the port's forward kernel
// (csrc/flash_attention.cu), which training on the card runs, so that
// dQ, dK and dV come from the same scores the forward took.
//
// Given q (B, S, H, D), k and v (B, S, KV, D), the forward's output O and
// its row log-sum-exp L (B, H, S) f32 of the scaled scores, and dO (B, S,
// H, D): with s = scale q.k, P = exp(s - L) (causal: query i sees keys
// j <= i + q_offset), D_i = sum_d dO_i O_i,
//   dV = P^T dO,  dS = P (dO V^T - D),  dQ = scale dS K,  dK = scale dS^T Q,
// dK and dV summed over the group's query heads.
//
// What bounds it on the card: operations.  At training's shapes (Qwen3-8B,
// B 2, S 2048, 32 heads over 8, head_dim 128) the function needs five
// causal S x S x D products per head (S recomputed from L, dP, dV, dK, dQ),
// 171.9 GFLOP against ~50 MB of operands, far above the card's ridge; only
// wgmma reaches the tensor cores' full rate.
//
// What the design does about it (bf16; f32 below, kept for exact checks):
//   * Three launches on the stream.  A preprocess computes D = rowsum(dO O)
//     and L log2(e) for every packed query row (below) into (tile, 2, 64)
//     f32, the layout the main kernel loads beside a query tile.  The main
//     kernel computes each product once: five products, no recomputation.
//     A postprocess scales the f32 dQ sums and writes dQ in bf16.
//   * Items: one per (128-key tile, KV head, batch row), key tile 0 first
//     across all (batch, KV head).  A persistent grid, one CTA per SM,
//     takes them in order from an atomic work counter, so every item an
//     item waits on (below) is already held by a running CTA.  An item's K
//     and V tiles are loaded once by TMA and stay resident; its query
//     tiles stream through a two-stage mbarrier ring, from the last one
//     (the most keys) down to the first that sees the key tile.
//   * Query tiles are the forward's packed rows: 64 rows = 64 / group
//     positions x the group's query heads (row r = position r / group,
//     head r % group), loaded through the forward's 4-D map over (D, H, S,
//     B).  So the sum of dK and dV over the group's heads is part of each
//     product's reduction: no loop over heads and no atomics.  At groups
//     3, 7 and 9 row 63 is never loaded; it is zeroed once, so it and the
//     zero-filled rows past S (L = D = 0) contribute exact zeros.
//   * Warp roles: a producer warpgroup (24 registers after setmaxnreg)
//     whose warp 0 issues the TMA loads and whose warp 1 adds the dQ
//     partials, and two consumer warpgroups (240 registers), warpgroup w
//     owning keys 64 w .. 64 w + 63 of the tile.  Per query tile a
//     consumer runs, on wgmma,
//       S^T = K Q^T and dP^T = V dO^T in flight together (both operands
//         K-major, swizzled; 64 f32 registers a thread beside dK and dV's
//         128, no spills),
//       P^T = 2^(S^T scale log2(e) - L log2(e)), causal and ragged elements
//         selected to 0 only on tiles that cross the diagonal or S,
//       dS^T = P^T (dP^T - D),
//       dV += P^T dO and dK += dS^T Q (A from registers: the accumulators
//         convert in place into A fragments, as the forward's P V; B
//         MN-major through the transpose bit),
//     then stores dS^T in bf16 to shared memory (the 128-byte swizzle) and,
//     after a barrier of both warpgroups, dQ_partial = dS K on wgmma (A and
//     B MN-major; warpgroup w takes dQ's columns 64 w .. 64 w + 63, at
//     head_dim 64 warpgroup 0 all of them).  dK and dV stay in f32
//     registers for the whole item and are written once.
//   * dQ in a fixed order: each partial goes to shared memory (row-major
//     f32, 16-byte chunks swizzled by the row, double-buffered); the writer
//     warp adds it into f32 (tile, 64, D) sums in the same
//     layout by one bulk copy (key tile 0: a plain store, so nothing is
//     zeroed) or one bulk f32 reduce (the others).
//     Causal visibility is monotone in the key tile, so a counter per
//     (batch, KV head, query tile) orders the adds: key tile j waits until
//     it reads j, adds, waits for the add to land, then bumps it; the last
//     key tile a query tile sees sets it back to 0.  The sum is taken in
//     the same order every call: two calls are bitwise equal.  The work
//     counter is set back to 0 by the CTA that takes the last ticket.
//   * f32 (kept for exact checks): two kernels, dQ (which also stores D)
//     then dK/dV per key tile sweeping the group's heads, FMAs on the CUDA
//     cores, every sum taken by one thread in a fixed order.
// Takes what training gives: Sq == Skv, an int q_offset >= 0, d_v ==
// d_qk, head_dim 64 or 128, any group up to 64 (the wrapper holds it to
// the forward's pairs), float32 or bfloat16.  Head dim 256 returns -1.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"

namespace {

namespace g9 = gemm_sm90;

// ---------------------------------------------------------------------------
// bf16: TMA ring, wgmma, one key-major pass with dQ summed in a fixed order
// ---------------------------------------------------------------------------
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BKEY = 128;        // keys per item: two consumer warpgroups
constexpr int BQ = 64;           // packed query rows per step
constexpr int WG = 128;          // threads of a warpgroup
constexpr int ROW = 128;         // bytes of one swizzled row: 64 bf16
constexpr int THREADS = 3 * WG;  // producer warpgroup + two consumers
constexpr int CONSUMER_WARPS = 8;
// registers a thread after setmaxnreg: the producer warpgroup gives what
// the consumers take (128 x (168 - 24) = 256 x (240 - 168))
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

struct Bf16Params {
  const void* out;
  const void* dout;
  const float* lse;   // (B, H, S)
  float* ld;          // (tiles, 2, 64): L log2(e), then D, per packed row
  float* acc;         // (tiles, 64, D) f32 dQ sums, chunks swizzled
  int* counters;      // (tiles + 1): the tiles' order, then the work counter
  void* dq;
  void* dk;
  void* dv;
  int batch, s, n_heads, n_kv, group, pt, q_tiles, k_tiles, q_offset;
  float scale;
};

// The CTA's shared memory at head dim D, from a 1024-aligned base: the K
// and V tiles (D / 64 boxes of 128 keys x 128 bytes each), two stages of
// Q, dO (D / 64 boxes of 64 rows) and their L/D rows, two dS^T buffers
// (128 keys x 64 queries, bf16), two dQ partials (f32), the item slots,
// each column's position in the tile, then the barriers.
template <int D>
struct Bwd {
  static constexpr int BOXES = D / 64;
  static constexpr int KV_BOX = BKEY * ROW;
  static constexpr int KV_BYTES = BOXES * KV_BOX;
  static constexpr int Q_BOX = BQ * ROW;
  static constexpr int Q_BYTES = BOXES * Q_BOX;
  static constexpr int DS_BYTES = BKEY * ROW;
  static constexpr int DQ_WGS = D / 64;   // warpgroups computing dQ
  static constexpr int DQ_BYTES = DQ_WGS * 64 * 64 * 4;
  static constexpr int LD_BYTES = 2 * BQ * 4;
  static constexpr int OFF_K = 0;
  static constexpr int OFF_V = KV_BYTES;
  static constexpr int OFF_Q = 2 * KV_BYTES;
  static constexpr int OFF_DO = OFF_Q + 2 * Q_BYTES;
  static constexpr int OFF_DS = OFF_DO + 2 * Q_BYTES;
  static constexpr int OFF_DQ = OFF_DS + 2 * DS_BYTES;
  static constexpr int OFF_LD = OFF_DQ + 2 * DQ_BYTES;
  static constexpr int OFF_ITEM = OFF_LD + 2 * LD_BYTES;   // 2 ints
  static constexpr int OFF_COLS = OFF_ITEM + 16;           // 64 chars
  static constexpr int OFF_BARS = OFF_COLS + 64;
  // kv full / empty, then two of each: q full / empty, dq full / empty,
  // item full / empty
  static constexpr int BARS = 14;
  static constexpr int BYTES = 1024 + OFF_BARS + BARS * 8;
  static_assert(BYTES <= 232448, "shared memory of one CTA");
};

enum Bar { KV_FULL = 0, KV_EMPTY = 1, Q_FULL = 2, Q_EMPTY = 4, DQ_FULL = 6,
           DQ_EMPTY = 8, ITEM_FULL = 10, ITEM_EMPTY = 12 };

template <int N>
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// `bytes` contiguous bytes from global memory into shared memory,
// completing `bar`'s transaction bytes.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// `bytes` of shared memory stored to (or, REDUCE, added in f32 into)
// global memory, in this thread's bulk group.
template <bool REDUCE>
__device__ __forceinline__ void bulk_out(float* dst, uint32_t src,
                                         uint32_t bytes) {
  if (REDUCE)
    asm volatile(
        "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], "
        "[%1], %2;\n" ::"l"(dst),
        "r"(src), "r"(bytes)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
            dst),
        "r"(src), "r"(bytes)
        : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void fence_proxy_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// d (64 x 64) = A (64 x 16, MN-major) @ B (16 x 64, MN-major) + (d if
// `accumulate`, else 0): dQ's partial, dS^T (keys as rows) as A and a K
// tile's box as B.
__device__ __forceinline__ void mma_tt_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// One item of the grid: key tile j of (batch row b, KV head kvh), and the
// first query tile with a position that sees the tile's first key (every
// later one does too).
struct Item {
  int j, kvh, b, first;
};

__device__ __forceinline__ Item decode_item(const Bf16Params& p, int x) {
  Item it;
  const int per = p.n_kv * p.batch;
  it.j = x / per;
  const int r = x - it.j * per;
  it.b = r / p.n_kv;
  it.kvh = r - it.b * p.n_kv;
  const int need = it.j * BKEY - p.q_offset - (p.pt - 1);
  it.first = need <= 0 ? 0 : (need + p.pt - 1) / p.pt;
  return it;
}

// The last key tile that query tile i sees.
__device__ __forceinline__ int last_key_tile(const Bf16Params& p, int i) {
  const int last_pos = min(i * p.pt + p.pt, p.s) - 1;
  return min(p.k_tiles - 1, (last_pos + p.q_offset) / BKEY);
}

__device__ __forceinline__ int tile_of(const Bf16Params& p, const Item& it,
                                       int i) {
  return (it.b * p.n_kv + it.kvh) * p.q_tiles + i;
}

// D / 8 threads per packed query row (tile, r), 16 bytes of O and dO
// each: L log2(e) and D = rowsum(dO O) in f32 (a fixed shuffle tree), 0 for
// row 63 of a 63-row tile and rows past S.
template <int D>
__global__ void __launch_bounds__(256) flash_bwd_pre_kernel(const Bf16Params p) {
  constexpr int TPR = D / 8;   // threads a row
  const long long idx = blockIdx.x * 256LL + threadIdx.x;
  const long long row_id = idx / TPR;
  const int c = static_cast<int>(idx % TPR);
  const long long rows_all = (long long)p.batch * p.n_kv * p.q_tiles * BQ;
  const int tile = static_cast<int>(row_id / BQ);
  const int r = static_cast<int>(row_id % BQ);
  const int i = tile % p.q_tiles;
  const int kvh = tile / p.q_tiles % p.n_kv;
  const int b = tile / p.q_tiles / p.n_kv;
  const int pos = i * p.pt + r / p.group;
  const bool real = row_id < rows_all && r < p.group * p.pt && pos < p.s;
  const int h = kvh * p.group + r % p.group;
  float acc = 0.f;
  if (real) {
    const long long at =
        (((long long)b * p.s + pos) * p.n_heads + h) * D + 8 * c;
    const uint4 ov = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(p.out) + at);
    const uint4 dv = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(p.dout) + at);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc = fmaf(__low2float(d2[e]), __low2float(o2[e]), acc);
      acc = fmaf(__high2float(d2[e]), __high2float(o2[e]), acc);
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (c == 0 && row_id < rows_all) {
    p.ld[(long long)tile * 2 * BQ + r] =
        real ? p.lse[((long long)b * p.n_heads + h) * p.s + pos] * LOG2E : 0.f;
    p.ld[(long long)tile * 2 * BQ + BQ + r] = acc;
  }
}

// D / 4 threads per row of a tile's dQ sums (row-major 64 x D f32, each
// row's 16-byte chunks swizzled by its low three bits), one chunk each:
// dQ = scale x the sums, in bf16, for rows with a position.
template <int D>
__global__ void __launch_bounds__(256) flash_bwd_post_kernel(const Bf16Params p) {
  constexpr int TPR = D / 4;
  const long long idx = blockIdx.x * 256LL + threadIdx.x;
  const long long row_id = idx / TPR;
  if (row_id >= (long long)p.batch * p.n_kv * p.q_tiles * BQ) return;
  const int r = static_cast<int>(row_id % BQ);
  const int i = static_cast<int>(row_id / BQ % p.q_tiles);
  const int kvh = static_cast<int>(row_id / BQ / p.q_tiles % p.n_kv);
  const int b = static_cast<int>(row_id / BQ / p.q_tiles / p.n_kv);
  const int pos = i * p.pt + r / p.group;
  if (r >= p.group * p.pt || pos >= p.s) return;
  const float4 v = reinterpret_cast<const float4*>(p.acc)[idx];
  const int col = 4 * (static_cast<int>(idx % TPR) ^ (r & 7));
  const int h = kvh * p.group + r % p.group;
  __nv_bfloat162 out[2] = {__floats2bfloat162_rn(v.x * p.scale, v.y * p.scale),
                           __floats2bfloat162_rn(v.z * p.scale, v.w * p.scale)};
  *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p.dq) +
                            (((long long)b * p.s + pos) * p.n_heads + h) * D +
                            col) = *reinterpret_cast<const uint2*>(out);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap do_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const Bf16Params p) {
  using L = Bwd<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = g9::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  volatile int* item_slot = reinterpret_cast<volatile int*>(gbase + L::OFF_ITEM);
  signed char* col_pos = reinterpret_cast<signed char*>(gbase + L::OFF_COLS);
  const uint32_t bars = base + L::OFF_BARS;
  auto bar = [&](int id) { return bars + 8u * id; };
  const int tid = threadIdx.x;
  const int rows = p.group * p.pt;   // 64, or 63 at groups 3, 7 and 9
  const int tiles = p.batch * p.n_kv * p.q_tiles;
  const int n_items = p.k_tiles * p.n_kv * p.batch;

  if (tid == 0) {
    g9::mbar_init(bar(KV_FULL), 1);
    g9::mbar_init(bar(KV_EMPTY), CONSUMER_WARPS);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      g9::mbar_init(bar(Q_FULL + s), 1);
      g9::mbar_init(bar(Q_EMPTY + s), CONSUMER_WARPS);
      g9::mbar_init(bar(DQ_FULL + s), 4 * L::DQ_WGS);
      g9::mbar_init(bar(DQ_EMPTY + s), 1);
      g9::mbar_init(bar(ITEM_FULL + s), 1);
      g9::mbar_init(bar(ITEM_EMPTY + s), CONSUMER_WARPS + 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < BQ) col_pos[tid] = tid < rows ? tid / p.group : -1;
  if (rows < BQ) {
    // row 63 of every Q and dO box, which no load writes: zeros
    for (int idx = tid; idx < 4 * L::BOXES * 8; idx += THREADS)
      asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(
                       base + L::OFF_Q + (idx / 8) * L::Q_BOX +
                       (BQ - 1) * ROW + (idx % 8) * 16),
                   "r"(0)
                   : "memory");
    g9::fence_proxy_async();
  }
  __syncthreads();

  if (tid < WG) {
    regs_dec<PRODUCER_REGS>();
    if (tid == 0) {
      // the producer: items from the work counter, each one's K and V
      // tiles, then its query tiles from the last down
      int step = 0;
      for (int n = 0;; ++n) {
        const int slot = n & 1;
        if (n >= 2) g9::mbar_wait(bar(ITEM_EMPTY + slot), ((n >> 1) + 1) & 1);
        const int x = atomicAdd(p.counters + tiles, 1);
        if (x == n_items + static_cast<int>(gridDim.x) - 1)
          atomicExch(p.counters + tiles, 0);   // the last ticket
        item_slot[slot] = x;
        g9::mbar_arrive(bar(ITEM_FULL + slot));
        if (x >= n_items) break;
        const Item it = decode_item(p, x);
        if (n >= 1) g9::mbar_wait(bar(KV_EMPTY), (n + 1) & 1);
        g9::mbar_expect_tx(bar(KV_FULL), 2 * L::KV_BYTES);
#pragma unroll
        for (int h = 0; h < L::BOXES; ++h) {
          g9::tma_load_4d(base + L::OFF_K + h * L::KV_BOX, &k_map,
                          bar(KV_FULL), 64 * h, it.kvh, it.j * BKEY, it.b);
          g9::tma_load_4d(base + L::OFF_V + h * L::KV_BOX, &v_map,
                          bar(KV_FULL), 64 * h, it.kvh, it.j * BKEY, it.b);
        }
        for (int i = p.q_tiles - 1; i >= it.first; --i, ++step) {
          const int s = step & 1;
          if (step >= 2) g9::mbar_wait(bar(Q_EMPTY + s), ((step >> 1) + 1) & 1);
          g9::mbar_expect_tx(bar(Q_FULL + s),
                             2 * L::BOXES * rows * ROW + L::LD_BYTES);
#pragma unroll
          for (int h = 0; h < L::BOXES; ++h) {
            g9::tma_load_4d(base + L::OFF_Q + s * L::Q_BYTES + h * L::Q_BOX,
                            &q_map, bar(Q_FULL + s), 64 * h,
                            it.kvh * p.group, i * p.pt, it.b);
            g9::tma_load_4d(base + L::OFF_DO + s * L::Q_BYTES + h * L::Q_BOX,
                            &do_map, bar(Q_FULL + s), 64 * h,
                            it.kvh * p.group, i * p.pt, it.b);
          }
          bulk_load(base + L::OFF_LD + s * L::LD_BYTES,
                    p.ld + (long long)tile_of(p, it, i) * 2 * BQ, L::LD_BYTES,
                    bar(Q_FULL + s));
        }
      }
    } else if (tid == 32) {
      // the dQ writer: each step's partial into the f32 sums, in key-tile
      // order per query tile
      int step = 0;
      for (int n = 0;; ++n) {
        const int slot = n & 1;
        g9::mbar_wait(bar(ITEM_FULL + slot), (n >> 1) & 1);
        const int x = item_slot[slot];
        g9::mbar_arrive(bar(ITEM_EMPTY + slot));
        if (x >= n_items) break;
        const Item it = decode_item(p, x);
        for (int i = p.q_tiles - 1; i >= it.first; --i, ++step) {
          const int s = step & 1;
          const int tile = tile_of(p, it, i);
          int* ctr = p.counters + tile;
          float* dst = p.acc + (long long)tile * BQ * D;
          const uint32_t src = base + L::OFF_DQ + s * L::DQ_BYTES;
          g9::mbar_wait(bar(DQ_FULL + s), (step >> 1) & 1);
          if (it.j == 0) {
            bulk_out<false>(dst, src, L::DQ_BYTES);
          } else {
            while (ld_acquire(ctr) != it.j) __nanosleep(32);
            fence_proxy_global();
            bulk_out<true>(dst, src, L::DQ_BYTES);
          }
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
          g9::mbar_arrive(bar(DQ_EMPTY + s));
          asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
          fence_proxy_global();
          const int last = last_key_tile(p, i);
          if (it.j < last)
            asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(
                             ctr),
                         "r"(1)
                         : "memory");
          else if (it.j > 0)
            *ctr = 0;   // the query tile's last add: ready for the next call
        }
      }
    }
    return;
  }

  regs_inc<CONSUMER_REGS>();
  const int cw = tid / WG - 1;   // consumer warpgroup: keys 64 cw ..
  const int t = tid % WG;
  const int lane = tid % 32;
  const bool lead = lane == 0;
  const int r0 = 16 * (t / 32) + lane / 4;   // rows r0 and r0 + 8
  const int cq = 2 * (t % 4);                // columns cq + 8 j + {0, 1}
  const bool does_dq = cw < L::DQ_WGS;
  const float sl2 = p.scale * LOG2E;
  const uint32_t sk = base + L::OFF_K;
  const uint32_t sv = base + L::OFF_V;
  float dk[D / 2], dv[D / 2], dq[32];
  // a step's dQ partial, into the dQ buffer of its step
  auto store_dq = [&](int done) {
    const int s = done & 1;
    g9::fence_acc(dq);
    if (done >= 2) g9::mbar_wait(bar(DQ_EMPTY + s), ((done >> 1) + 1) & 1);
    // row-major 64 x D f32, each row's 16-byte chunks swizzled by the row's
    // low three bits (the postprocess reads rows whole)
    unsigned char* part =
        gbase + L::OFF_DQ + s * L::DQ_BYTES + r0 * D * 4 + (cq & 3) * 4;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int chunk = 16 * cw + 2 * j + (cq >> 2);
        *reinterpret_cast<float2*>(part + half * 8 * D * 4 +
                                   ((chunk ^ (r0 & 7)) << 4)) =
            make_float2(dq[4 * j + 2 * half], dq[4 * j + 2 * half + 1]);
      }
    g9::fence_proxy_async();
    __syncwarp();
    if (lead) g9::mbar_arrive(bar(DQ_FULL + s));
  };
  int step = 0;
  for (int n = 0;; ++n) {
    const int slot = n & 1;
    g9::mbar_wait(bar(ITEM_FULL + slot), (n >> 1) & 1);
    const int x = item_slot[slot];
    __syncwarp();
    if (lead) g9::mbar_arrive(bar(ITEM_EMPTY + slot));
    if (x >= n_items) break;
    const Item it = decode_item(p, x);
    const int key0 = it.j * BKEY;
    const int my_key = key0 + 64 * cw + r0;   // this thread's first key
    g9::mbar_wait(bar(KV_FULL), n & 1);
    for (int i = p.q_tiles - 1; i >= it.first; --i, ++step) {
      const int s = step & 1;
      const int first = i == p.q_tiles - 1;
      const uint32_t sq = base + L::OFF_Q + s * L::Q_BYTES;
      const uint32_t sdo = base + L::OFF_DO + s * L::Q_BYTES;
      const uint32_t sds = base + L::OFF_DS + s * L::DS_BYTES;
      const float* ld =
          reinterpret_cast<const float*>(gbase + L::OFF_LD + s * L::LD_BYTES);
      g9::mbar_wait(bar(Q_FULL + s), (step >> 1) & 1);
      // S^T = K Q^T and dP^T = V dO^T in flight together: this
      // warpgroup's 64 keys x 64 rows each, both f32 tiles beside dK and dV
      float st[32], dpt[32];
      g9::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        g9::mma_kk_n64(
            st,
            g9::kmajor_desc(sk + (kk / 4) * L::KV_BOX + cw * 64 * ROW +
                            (kk % 4) * 32),
            g9::kmajor_desc(sq + (kk / 4) * L::Q_BOX + (kk % 4) * 32), kk > 0);
      g9::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        g9::mma_kk_n64(
            dpt,
            g9::kmajor_desc(sv + (kk / 4) * L::KV_BOX + cw * 64 * ROW +
                            (kk % 4) * 32),
            g9::kmajor_desc(sdo + (kk / 4) * L::Q_BOX + (kk % 4) * 32),
            kk > 0);
      g9::wgmma_commit();
      g9::wgmma_wait<1>();
      g9::fence_acc(st);
      // P^T = 2^(s sl2 - L log2 e); keys past S or past a row's causal
      // limit are selected to 0 only where the tile reaches them
      const int pos0 = i * p.pt;
      const bool masked =
          key0 + BKEY - 1 > pos0 + p.q_offset || key0 + BKEY > p.s;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(ld + 8 * j + cq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int idx = 4 * j + e;
          const float pv = ex2(fmaf(st[idx], sl2, (e & 1) ? -l2.y : -l2.x));
          if (masked) {
            const int cp = col_pos[8 * j + cq + (e & 1)];
            const int pos = pos0 + cp;
            const int lim =
                cp >= 0 && pos < p.s ? min(p.s, pos + p.q_offset + 1) : 0;
            st[idx] = my_key + 8 * (e >> 1) < lim ? pv : 0.f;
          } else {
            st[idx] = pv;
          }
        }
      }
      // dS^T = P^T (dP^T - D) in f32, in place of dP^T; then P^T and dS^T
      // in bf16 as A fragments (rows 16 kk .. of the reduction axis are
      // the sums 8 kk .. 8 kk + 7), and dV += P^T dO, dK += dS^T Q (B
      // MN-major: the stage's rows are the reduction axis)
      g9::wgmma_wait<0>();
      g9::fence_acc(dpt);
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dd =
            *reinterpret_cast<const float2*>(ld + BQ + 8 * j + cq);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[4 * j + e] =
              st[4 * j + e] * (dpt[4 * j + e] - ((e & 1) ? dd.y : dd.x));
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          pa[kk][f] = pack_bf16(st[8 * kk + 2 * f], st[8 * kk + 2 * f + 1]);
          da[kk][f] = pack_bf16(dpt[8 * kk + 2 * f], dpt[8 * kk + 2 * f + 1]);
        }
      g9::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        g9::mma_rs<D>(dv, pa[kk], g9::mnmajor_desc(sdo + kk * 16 * ROW),
                      !(first && kk == 0));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        g9::mma_rs<D>(dk, da[kk], g9::mnmajor_desc(sq + kk * 16 * ROW),
                      !(first && kk == 0));
      g9::wgmma_commit();
      // dS^T to shared memory in bf16 with the 128-byte swizzle: row = key
      // (64 cw + r0 + 8 (f & 1), the low three bits of r0), 16-byte chunk =
      // query / 8
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int row = 64 * cw + r0 + 8 * (f & 1);
          const int chunk = 2 * kk + (f >> 1);
          asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(
                           sds + row * ROW + ((chunk ^ (r0 & 7)) << 4) +
                           cq * 2),
                       "r"(da[kk][f])
                       : "memory");
        }
      g9::fence_proxy_async();
      named_sync<2 * WG>(1);   // both warpgroups' rows of dS^T
      g9::wgmma_wait<0>();     // dV and dK: the stage and the A fragments
      g9::fence_acc(dk);
      g9::fence_acc(dv);
      __syncwarp();
      if (lead) g9::mbar_arrive(bar(Q_EMPTY + s));
      if (does_dq) {
        // dQ's columns 64 cw .. of dS K, over the tile's 128 keys
        g9::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKEY / 16; ++kk)
          mma_tt_n64(dq, g9::mnmajor_desc(sds + kk * 16 * ROW),
                     g9::mnmajor_desc(sk + cw * L::KV_BOX + kk * 16 * ROW),
                     kk > 0);
        g9::wgmma_commit();
        g9::wgmma_wait<0>();
        store_dq(step);
      }
    }
    // the item's K and V are free; dK (scaled) and dV to global memory
    __syncwarp();
    if (lead) g9::mbar_arrive(bar(KV_EMPTY));
    __nv_bfloat16* dk_out = static_cast<__nv_bfloat16*>(p.dk);
    __nv_bfloat16* dv_out = static_cast<__nv_bfloat16*>(p.dv);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = my_key + 8 * half;
      if (key >= p.s) continue;
      const long long at = (((long long)it.b * p.s + key) * p.n_kv + it.kvh) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int c = 8 * j + cq;
        *reinterpret_cast<__nv_bfloat162*>(dk_out + at + c) =
            __floats2bfloat162_rn(dk[4 * j + 2 * half] * p.scale,
                                  dk[4 * j + 2 * half + 1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(dv_out + at + c) =
            __floats2bfloat162_rn(dv[4 * j + 2 * half],
                                  dv[4 * j + 2 * half + 1]);
      }
    }
  }
}

// Sets the main kernel's shared-memory size and reads the SM count once
// per device, encodes the four tensor maps, then launches the preprocess,
// the persistent main kernel (one CTA per SM, at most one per item) and
// the postprocess.  Returns 0, a CUDA error, or -2 when a map is refused.
template <int D>
int launch_bf16(const void* q, const void* k, const void* v, Bf16Params p,
                cudaStream_t stream) {
  using L = Bwd<D>;
  auto kernel = flash_bwd_bf16_kernel<D>;
  static int sized = -1, sms = 0;   // the device whose attribute is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sized != dev) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = dev;
  }
  const cuuint64_t e = 2;   // bytes per element
  CUtensorMap q_map, do_map, k_map, v_map;
  const cuuint64_t q_dims[4] = {D, (cuuint64_t)p.n_heads, (cuuint64_t)p.s,
                                (cuuint64_t)p.batch};
  const cuuint64_t q_strides[3] = {D * e, p.n_heads * D * e,
                                   (cuuint64_t)p.s * p.n_heads * D * e};
  const cuuint32_t q_box[4] = {64, (cuuint32_t)p.group, (cuuint32_t)p.pt, 1};
  const cuuint64_t kv_dims[4] = {D, (cuuint64_t)p.n_kv, (cuuint64_t)p.s,
                                 (cuuint64_t)p.batch};
  const cuuint64_t kv_strides[3] = {D * e, p.n_kv * D * e,
                                    (cuuint64_t)p.s * p.n_kv * D * e};
  const cuuint32_t kv_box[4] = {64, 1, BKEY, 1};
  if (!g9::encode_4d(&q_map, q, q_dims, q_strides, q_box) ||
      !g9::encode_4d(&do_map, p.dout, q_dims, q_strides, q_box) ||
      !g9::encode_4d(&k_map, k, kv_dims, kv_strides, kv_box) ||
      !g9::encode_4d(&v_map, v, kv_dims, kv_strides, kv_box))
    return -2;
  const long long tiles = (long long)p.batch * p.n_kv * p.q_tiles;
  const long long items = (long long)p.k_tiles * p.n_kv * p.batch;
  if (tiles * BQ * (D / 4) / 256 + 1 > 0x7fffffffLL || items > 0x3fffffffLL)
    return -1;
  flash_bwd_pre_kernel<D>
      <<<static_cast<int>((tiles * BQ * (D / 8) + 255) / 256), 256, 0,
         stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<int>(items < sms ? items : sms), THREADS, L::BYTES,
           stream>>>(q_map, do_map, k_map, v_map, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_post_kernel<D>
      <<<static_cast<int>((tiles * BQ * (D / 4) + 255) / 256), 256, 0,
         stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32: dQ (and D), then dK/dV, FMAs on the CUDA cores
// ---------------------------------------------------------------------------
constexpr int F32_THREADS = 128;   // four warps
constexpr int F32_BQ = 64;         // dQ: query rows per CTA
constexpr int F32_BKEY = 64;       // keys per tile (both kernels)
constexpr int F32_BQ2 = 32;        // dK/dV: query rows per inner tile
constexpr int PAD = 4;             // 16 bytes of f32 per row

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* out;
  const float* dout;
  const float* lse;   // (B, H, S)
  float* delta;       // (B, H, S): written by dQ, read by dK/dV
  float* dq;
  float* dk;
  float* dv;
  int batch, s, n_heads, n_kv, q_offset;
  float scale;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// A warp's tile product c (16 x 8 NT) += A (16 x K) B^T, where A's row r is
// at a + r lda and B's row n (an output column) at b + n ldb, both with the
// reduction axis contiguous, each thread summing its own elements over k
// in order.  c[nt][i] is row gid + 8 (i / 2), column 8 nt + 2 tig + i % 2
// (gid = lane / 4, tig = lane % 4).
template <int NT>
__device__ __forceinline__ void tile_mma(float (&c)[NT][4], const float* a,
                                         int lda, const float* b, int ldb,
                                         int k) {
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* ar = a + (gid + 8 * (i >> 1)) * lda;
      const float* br = b + (nt * 8 + 2 * tig + (i & 1)) * ldb;
      float acc = c[nt][i];
      for (int kk = 0; kk < k; ++kk) acc = fmaf(ar[kk], br[kk], acc);
      c[nt][i] = acc;
    }
}

// Rows [row0, row0 + n) of head h of a (B, S, heads, D) tensor into dst
// (n rows of ld), rows past S as zeros; with dt, also transposed into dt
// (D rows of ldt, dt[d][r]).
template <int D>
__device__ __forceinline__ void load_rows(float* dst, int ld, float* dt,
                                          int ldt, const float* src, int b,
                                          int row0, int n, int s, int heads,
                                          int h) {
  constexpr int V = 4;
  for (int idx = threadIdx.x; idx < n * (D / V); idx += F32_THREADS) {
    const int r = idx / (D / V);
    const int c = (idx % (D / V)) * V;
    const int pos = row0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (pos < s)
      val = *reinterpret_cast<const float4*>(
          src + (((long long)b * s + pos) * heads + h) * D + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = val;
    if (dt != nullptr) {
      dt[c * ldt + r] = val.x;
      dt[(c + 1) * ldt + r] = val.y;
      dt[(c + 2) * ldt + r] = val.z;
      dt[(c + 3) * ldt + r] = val.w;
    }
  }
}

// Whether query position pos sees key `key`.
__device__ __forceinline__ bool visible(const Params& p, int pos, int key) {
  return pos < p.s && key < p.s && key <= pos + p.q_offset;
}

// dQ (and D): one CTA per (64-query tile, query head, batch row)
template <int D>
struct DqLayout {
  static constexpr int LD = D + PAD;          // Q, dO, K, V rows
  static constexpr int LDT = F32_BKEY + PAD;  // K^T and dS rows
  static constexpr int BYTES =
      (2 * F32_BQ * LD + 2 * F32_BKEY * LD + D * LDT + F32_BQ * LDT) * 4 +
      2 * F32_BQ * 4;
};

template <int D>
__global__ void __launch_bounds__(F32_THREADS)
flash_bwd_dq_kernel(const Params p) {
  using L = DqLayout<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);
  float* sdo = sq + F32_BQ * L::LD;
  float* sk = sdo + F32_BQ * L::LD;
  float* sv = sk + F32_BKEY * L::LD;
  float* skt = sv + F32_BKEY * L::LD;
  float* sds = skt + D * L::LDT;
  float* slse = sds + F32_BQ * L::LDT;
  float* sdelta = slse + F32_BQ;

  const int qt = gridDim.x - 1 - blockIdx.x;   // the most keys first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.n_heads / p.n_kv);
  const int q0 = qt * F32_BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane >> 2;
  const int tig = lane & 3;

  load_rows<D>(sq, L::LD, nullptr, 0, p.q, b, q0, F32_BQ, p.s, p.n_heads, h);
  load_rows<D>(sdo, L::LD, nullptr, 0, p.dout, b, q0, F32_BQ, p.s, p.n_heads,
               h);
  // D = rowsum(dO O) and L for the tile's rows (0 past S)
  for (int r = warp; r < F32_BQ; r += F32_THREADS / 32) {
    const int pos = q0 + r;
    float acc = 0.f;
    if (pos < p.s) {
      const long long base = (((long long)b * p.s + pos) * p.n_heads + h) * D;
      for (int d = lane; d < D; d += 32)
        acc = fmaf(p.dout[base + d], p.out[base + d], acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      const long long li = ((long long)b * p.n_heads + h) * p.s + pos;
      sdelta[r] = acc;
      slse[r] = pos < p.s ? p.lse[li] : 0.f;
      if (pos < p.s) p.delta[li] = acc;
    }
  }

  const int r_lo = warp * 16;   // this warp's rows of the tile
  float dq[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[nd][i] = 0.f;
  const int last_q = min(p.s - 1, q0 + F32_BQ - 1);
  const int kend = max(0, min(p.s, last_q + p.q_offset + 1));   // keys [0, kend)
  const int n_kt = (kend + F32_BKEY - 1) / F32_BKEY;
  float* ds_w = sds + r_lo * L::LDT;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * F32_BKEY;
    __syncthreads();   // the previous tile's K, V and dS reads are done
    load_rows<D>(sk, L::LD, skt, L::LDT, p.k, b, k0, F32_BKEY, p.s, p.n_kv,
                 kvh);
    load_rows<D>(sv, L::LD, nullptr, 0, p.v, b, k0, F32_BKEY, p.s, p.n_kv,
                 kvh);
    __syncthreads();
    float s[F32_BKEY / 8][4], dp[F32_BKEY / 8][4];
#pragma unroll
    for (int nt = 0; nt < F32_BKEY / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
    tile_mma(s, sq + r_lo * L::LD, L::LD, sk, L::LD, D);
    tile_mma(dp, sdo + r_lo * L::LD, L::LD, sv, L::LD, D);
#pragma unroll
    for (int nt = 0; nt < F32_BKEY / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = gid + 8 * (i >> 1);
        const int c = nt * 8 + 2 * tig + (i & 1);
        float ds = 0.f;
        if (visible(p, q0 + r_lo + r, k0 + c)) {
          const float pr = expf(fmaf(s[nt][i], p.scale, -slse[r_lo + r]));
          ds = pr * (dp[nt][i] - sdelta[r_lo + r]);
        }
        ds_w[r * L::LDT + c] = ds;
      }
    __syncwarp();
    tile_mma(dq, ds_w, L::LDT, skt, L::LDT, F32_BKEY);
  }
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pos = q0 + r_lo + gid + 8 * (i >> 1);
      const int d = nd * 8 + 2 * tig + (i & 1);
      if (pos < p.s)
        p.dq[(((long long)b * p.s + pos) * p.n_heads + h) * D + d] =
            dq[nd][i] * p.scale;
    }
}

// dK and dV: one CTA per (64-key tile, KV head, batch row)
template <int D>
struct DkvLayout {
  static constexpr int LD = D + PAD;          // K, V, Q, dO rows
  static constexpr int LDT = F32_BQ2 + PAD;   // Q^T, dO^T, P and dS rows
  static constexpr int BYTES =
      (2 * F32_BKEY * LD + 2 * F32_BQ2 * LD + 2 * D * LDT +
       2 * F32_BKEY * LDT) * 4 +
      2 * F32_BQ2 * 4;
};

template <int D>
__global__ void __launch_bounds__(F32_THREADS)
flash_bwd_dkv_kernel(const Params p) {
  using L = DkvLayout<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sk = reinterpret_cast<float*>(smem);
  float* sv = sk + F32_BKEY * L::LD;
  float* sq = sv + F32_BKEY * L::LD;
  float* sdo = sq + F32_BQ2 * L::LD;
  float* sqt = sdo + F32_BQ2 * L::LD;
  float* sdot = sqt + D * L::LDT;
  float* sp = sdot + D * L::LDT;
  float* sds = sp + F32_BKEY * L::LDT;
  float* slse = sds + F32_BKEY * L::LDT;
  float* sdelta = slse + F32_BQ2;

  const int kt = blockIdx.x;   // key tile 0 (the most queries) first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = p.n_heads / p.n_kv;
  const int k0 = kt * F32_BKEY;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int r_lo = warp * 16;   // this warp's keys of the tile

  load_rows<D>(sk, L::LD, nullptr, 0, p.k, b, k0, F32_BKEY, p.s, p.n_kv, kvh);
  load_rows<D>(sv, L::LD, nullptr, 0, p.v, b, k0, F32_BKEY, p.s, p.n_kv, kvh);
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[nd][i] = dv[nd][i] = 0.f;
  // the first query tile with a position that sees key k0
  const int first = max(0, k0 - p.q_offset) / F32_BQ2;
  const int n_qt = (p.s + F32_BQ2 - 1) / F32_BQ2;
  float* p_w = sp + r_lo * L::LDT;
  float* ds_w = sds + r_lo * L::LDT;
  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    for (int qt = first; qt < n_qt; ++qt) {
      const int q0 = qt * F32_BQ2;
      __syncthreads();   // the previous tile's reads are done
      load_rows<D>(sq, L::LD, sqt, L::LDT, p.q, b, q0, F32_BQ2, p.s,
                   p.n_heads, h);
      load_rows<D>(sdo, L::LD, sdot, L::LDT, p.dout, b, q0, F32_BQ2, p.s,
                   p.n_heads, h);
      if (threadIdx.x < F32_BQ2) {
        const int pos = q0 + threadIdx.x;
        const long long li = ((long long)b * p.n_heads + h) * p.s + pos;
        slse[threadIdx.x] = pos < p.s ? p.lse[li] : 0.f;
        sdelta[threadIdx.x] = pos < p.s ? p.delta[li] : 0.f;
      }
      __syncthreads();
      // S^T and dP^T: this warp's 16 keys x the tile's 32 queries
      float st[F32_BQ2 / 8][4], dpt[F32_BQ2 / 8][4];
#pragma unroll
      for (int nt = 0; nt < F32_BQ2 / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) st[nt][i] = dpt[nt][i] = 0.f;
      tile_mma(st, sk + r_lo * L::LD, L::LD, sq, L::LD, D);
      tile_mma(dpt, sv + r_lo * L::LD, L::LD, sdo, L::LD, D);
#pragma unroll
      for (int nt = 0; nt < F32_BQ2 / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = gid + 8 * (i >> 1);
          const int c = nt * 8 + 2 * tig + (i & 1);
          float pr = 0.f, ds = 0.f;
          if (visible(p, q0 + c, k0 + r_lo + r)) {
            pr = expf(fmaf(st[nt][i], p.scale, -slse[c]));
            ds = pr * (dpt[nt][i] - sdelta[c]);
          }
          p_w[r * L::LDT + c] = pr;
          ds_w[r * L::LDT + c] = ds;
        }
      __syncwarp();
      tile_mma(dv, p_w, L::LDT, sdot, L::LDT, F32_BQ2);
      tile_mma(dk, ds_w, L::LDT, sqt, L::LDT, F32_BQ2);
    }
  }
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + r_lo + gid + 8 * (i >> 1);
      const int d = nd * 8 + 2 * tig + (i & 1);
      if (key < p.s) {
        const long long at = (((long long)b * p.s + key) * p.n_kv + kvh) * D + d;
        p.dk[at] = dk[nd][i] * p.scale;
        p.dv[at] = dv[nd][i];
      }
    }
}

// Sets both kernels' shared-memory sizes once per device, then launches
// dQ (which stores D) and dK/dV on the stream, in that order.
template <int D>
int launch_f32(const Params& p, cudaStream_t stream) {
  auto kq = flash_bwd_dq_kernel<D>;
  auto kkv = flash_bwd_dkv_kernel<D>;
  constexpr int QB = DqLayout<D>::BYTES;
  constexpr int KVB = DkvLayout<D>::BYTES;
  static int sized = -1;   // the device whose attributes are set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sized != dev) {
    err = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               QB);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(
        kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, KVB);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = dev;
  }
  kq<<<dim3((p.s + F32_BQ - 1) / F32_BQ, p.n_heads, p.batch), F32_THREADS,
       QB, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kkv<<<dim3((p.s + F32_BKEY - 1) / F32_BKEY, p.n_kv, p.batch), F32_THREADS,
        KVB, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out, dout, dq, dk and dv).
// q, out, dout and dq are contiguous (B, S, H, D); k, v, dk and dv
// contiguous (B, S, KV, D); lse the forward's (B, H, S) f32 log-sum-exp
// rows.  Query i sees keys [0, i + q_offset].  With pt = 64 / group and
// tiles = B KV ceil(S / pt): f32 takes scratch as (B, H, S) f32 and
// ignores acc and counters; bf16 takes scratch as tiles x 128 f32, acc as
// tiles x 64 x head_dim f32, and counters as tiles + 1 int32 zeros, which
// the launch leaves zero.  Returns -1 for a shape this build does not take
// (head_dim other than 64 or 128, H not a multiple of KV, a group over 64,
// q_offset < 0, B or H over 65535), -2 for a tensor map
// cuTensorMapEncodeTiled refuses, else the launches' CUDA error code.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* scratch, void* acc,
    void* counters, void* dq, void* dk, void* dv, int dtype, int batch, int s,
    int n_heads, int n_kv, int head_dim, int q_offset, float scale,
    void* stream) {
  if (batch == 0 || s == 0) return 0;
  if (n_kv <= 0 || n_heads % n_kv || n_heads / n_kv > BQ || q_offset < 0 ||
      batch > 65535 || n_heads > 65535 || (head_dim != 64 && head_dim != 128))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (acc == nullptr || counters == nullptr) return -1;
    Bf16Params p;
    p.out = out;
    p.dout = dout;
    p.lse = static_cast<const float*>(lse);
    p.ld = static_cast<float*>(scratch);
    p.acc = static_cast<float*>(acc);
    p.counters = static_cast<int*>(counters);
    p.dq = dq;
    p.dk = dk;
    p.dv = dv;
    p.batch = batch;
    p.s = s;
    p.n_heads = n_heads;
    p.n_kv = n_kv;
    p.group = n_heads / n_kv;
    p.pt = BQ / p.group;
    p.q_tiles = (s + p.pt - 1) / p.pt;
    p.k_tiles = (s + BKEY - 1) / BKEY;
    p.q_offset = q_offset;
    p.scale = scale;
    return head_dim == 64 ? launch_bf16<64>(q, k, v, p, st)
                          : launch_bf16<128>(q, k, v, p, st);
  }
  if (dtype != 0) return -1;
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.out = static_cast<const float*>(out);
  p.dout = static_cast<const float*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(scratch);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.batch = batch;
  p.s = s;
  p.n_heads = n_heads;
  p.n_kv = n_kv;
  p.q_offset = q_offset;
  p.scale = scale;
  return head_dim == 64 ? launch_f32<64>(p, st) : launch_f32<128>(p, st);
}
