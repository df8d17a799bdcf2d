// Causal GQA flash attention with a per-row query offset, for Hopper
// (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// `flash_attention` (`_kernel`): q (B, Sq, H, D) attends k, v (B, Skv, KV, D)
// causally, query row i of batch row b seeing keys [0, q_offset[b] + i] (and
// never past Skv), query head h reading KV head h // group, with an f32
// online softmax.  Same constants as the TPU kernel: scores are scaled by
// `scale` (the wrapper passes d ** -0.5), masked scores are NEG_INF = -1e30,
// and the softmax denominator is clamped to 1e-30.  Unlike the TPU kernel,
// whose offset is a static int, q_offset is a device (B,) int32 array read
// by each block (or, when null, one int for every row), so the legacy step's
// chunks at any prefix depth run this kernel (the JAX engine sends those to
// its XLA ref).
//
// What bounds it on the card: at the legacy step's shapes (a 256-token chunk
// over a 768-row prefix, or a 513-token prompt recomputed from 0) it does
// 2-3 GFLOP over 7-11 MB, about 250 flops per byte: near the H100's ridge
// (~295 flops/byte in bf16), so the bound is a few microseconds either way.
// What bounds this kernel is neither: each 64-row query tile streams all of
// its KV head's rows through shared memory (the head's 16 query tiles read
// the same rows, 44 MB of loads for 3 MB of K/V at the chunk shape), and
// the ring alone, with no products, takes about two thirds of the kernel's
// time whatever its depth or the bytes a CTA streams (tools/flash_probe.py,
// PERF.md).
//
// What the design does about it (bf16):
//   * Items: a work item is (64-row query tile, KV head, batch row, key
//     chunk).  The tile's 64 rows are 64 / group positions (rounded down)
//     times the group's query heads (row r = position r / group, head r %
//     group), so each K/V tile is loaded once for all the query heads that
//     share it.  At groups 3, 7 and 9 that is 63 rows: the Q box leaves row
//     63 as it was, its scores and sums stay in their own row of every
//     product, and it is never stored.
//     The wrapper's plan (kernels/flash_attention.py) splits a tile's keys
//     into chunks of at least 16 stages only where the tiles leave SMs
//     idle, and only into as many chunks as the idle SMs take, from the
//     shapes and the SM count alone (never the device offset); the grid
//     holds every (tile, chunk): items whose chunk starts past the tile's
//     causal end exit at once; items run chunk-major, the last query
//     tiles (the most keys) first.  A split tile's chunks write f32
//     partials; the CTA that takes the tile's last ticket (the split-KV
//     counters decode attention shares) merges them in chunk order and sets
//     the ticket back to 0, so results do not depend on which CTA ran what.
//   * Loads: a producer warp issues TMA copies into an mbarrier ring: the Q
//     tile through a 4-D tensor map over (D, H, Sq, B) in boxes of (64,
//     group, 64 / group, 1), so its rows land in the order above, and K and
//     V stages of 64 keys through maps over the strided (D, KV, Skv, B)
//     view (the slot's view of the serving cache), all with the 128-byte
//     swizzle.  K and V have their own full and empty barriers, so the next
//     K stage loads while this V stage is still read.  A tile's first chunk
//     starts its Q tile and first stage before the offset is read.  TMA
//     zero-fills past Sq and Skv, so ragged shapes need no masked loads.
//   * Products: S = Q K^T is wgmma m64n64k16 with both operands K-major in
//     shared memory; O += P V takes P from registers (the score
//     accumulators convert in place into wgmma's A fragments) and V
//     MN-major through the transpose bit, P split into bf16 hi + lo parts
//     so that P V sees P at near-f32 precision (two products per k-step).
//     The online softmax runs in log2 units, one FFMA and one ex2 a score.
//   * Two consumer warpgroups per CTA at head_dim <= 128, on the same 64
//     query rows, take alternate key tiles (two stages each): each walks
//     half the tile's keys, and one warpgroup's softmax runs while the
//     other's products do (two warps per scheduler).  The second
//     warpgroup's state joins the first's through shared memory in a
//     fixed order.  One CTA per SM; at head_dim 256 one warpgroup (the
//     accumulators take 254 registers).
//   * Causal limits: a chunk stops at key q_offset[b] + the tile's last
//     position + 1; the boxes of its last stage may still hold rows past
//     that limit inside the view (another request's rows or uninitialised
//     cache), so those V rows are zeroed in shared memory before that P V
//     and their scores masked with a select: a stale row can never reach
//     the output, even as NaN * 0.
//   * f32 (kept for exact checks): one block of 8 warps per (query
//     position, KV head, batch row), each warp owning a strided share of the
//     keys with its own online softmax state for the group's heads, merged
//     once at the end in a fixed order, as in csrc/packed_attention.cu.
// Left for a later change: d_v != d_qk (absorbed MLA, ROADMAP A5).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"

namespace {

namespace g9 = gemm_sm90;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* q_offset;   // (B,) or null: q_offset_scalar for every row
  void* out;
  int sq, skv, n_heads, n_kv, q_offset_scalar;
  long long k_sb, k_ss, v_sb, v_ss;   // element strides over batch and row
  float scale;
  // bf16: the items (see flash_bf16_kernel) and the split tiles' scratch
  int batch, q_tiles, chunk, n_chunks;
  float* part;        // (tiles, n_chunks, Cfg<D>::PART) f32 partials
  int32_t* tickets;   // (tiles,), 0 between launches
};

__device__ __forceinline__ int row_offset(const Params& p, int b) {
  return p.q_offset ? p.q_offset[b] : p.q_offset_scalar;
}

// ---------------------------------------------------------------------------
// bf16: TMA ring, wgmma, a producer warp; key ranges split into chunks
// ---------------------------------------------------------------------------
constexpr int BM = 64;          // query rows (position x head) per tile
constexpr int BN = 64;          // keys per K/V stage
constexpr int WG = 128;         // threads of a warpgroup
constexpr int ROW = 128;        // bytes of one swizzled row: 64 bf16

// The layout of a head dim's CTA: WGS consumer warpgroups on one 64-row
// query tile (two at head_dim <= 128, one at 256), warpgroup w taking key
// tiles w, w + WGS, ..., and a producer warp; two K/V stages a warpgroup,
// tile j in stage j % STAGES (so each stage belongs to one warpgroup).  Its shared memory: the Q tile, the K stages,
// the V stages (each D / 64 boxes of 128-byte rows, a box being 64 columns
// of every row), the exchange of the second warpgroup's softmax state,
// then the barriers; the slack aligns it to 1024 (the swizzle's period).
template <int D>
struct Cfg {
  static constexpr int WGS = D <= 128 ? 2 : 1;
  static constexpr int CONSUMERS = WG * WGS;
  static constexpr int THREADS = CONSUMERS + 32;
  static constexpr int STAGES = 2 * WGS;
  static constexpr int BOXES = D / 64;
  static constexpr int Q_BYTES = BOXES * BM * ROW;
  static constexpr int KV_BYTES = BOXES * BN * ROW;   // one K or V stage
  // f32 floats of one thread-minor softmax state of a warpgroup: the output
  // sums, then m and l of each thread's two rows (the exchange between the
  // warpgroups, and a split chunk's partial in device memory)
  static constexpr int PART = (D / 2 + 4) * WG;
  static constexpr int XCHG = WGS > 1 ? PART * 4 : 0;
  static constexpr int BARS = 1 + 4 * STAGES;   // q, full K, full V, empty K, empty V
  static constexpr int BYTES =
      1024 + Q_BYTES + 2 * STAGES * KV_BYTES + XCHG + BARS * 8;
};

// Named barrier `id` over the first n threads (0 is __syncthreads').
template <int N>
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(N) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (a, b) -> bf16 pairs hi + lo with hi + lo = (a, b) to ~2^-17 relative:
// P then enters P V at near-f32 precision, as the TPU kernel's f32 dot
// takes it (one bf16 rounding of P alone errs by up to 2^-9 of |V|, which
// shows on rows that see few keys).
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - __low2float(h),
                                                 b - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// What a consumer thread keeps for one item: its two rows' limits and
// softmax states (m in log2 units of the scaled scores), the output sums,
// the scores and P's bf16 parts.
template <int D>
struct Consumer {
  static constexpr int NO = D / 2;                 // output sums
  static constexpr int NH = D <= 128 ? D : 128;    // columns of one PV product
  int lim[2];
  float m[2], l[2];
  float o[NO];
  float s[32];                                     // a 64 x 64 score tile
  uint32_t ph[BN / 16][4], pl[BN / 16][4];

  // S = Q K^T of the stage at `k` (shared addresses)
  __device__ __forceinline__ void scores(uint32_t q, uint32_t k) {
    g9::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      g9::mma_kk_n64(s,
                     g9::kmajor_desc(q + (kk / 4) * BM * ROW + (kk % 4) * 32),
                     g9::kmajor_desc(k + (kk / 4) * BN * ROW + (kk % 4) * 32),
                     kk > 0);
    g9::wgmma_commit();
  }

  // O += P V of the stage at `v`, P as hi + lo (two products per k-step)
  __device__ __forceinline__ void pv(uint32_t v) {
    g9::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int h = 0; h < D / NH; ++h) {
        float(&acc)[NH / 2] = *reinterpret_cast<float(*)[NH / 2]>(o + h * NH / 2);
        const uint64_t desc =
            g9::mnmajor_desc(v + h * (NH / 64) * BN * ROW + kk * 16 * ROW);
        g9::mma_rs<NH>(acc, ph[kk], desc, 1);
        g9::mma_rs<NH>(acc, pl[kk], desc, 1);
      }
    g9::wgmma_commit();
  }

  // The online softmax of the tile whose first key is key0: s -> P in f32
  // in place, p = 2^(s sl2 - m) (one FFMA and one ex2 a score); alpha
  // rescales the rows' earlier sums.  Keys at or past a row's limit are
  // NEG_INF (a select: a stale row's NaN never passes), checked only where
  // the tile crosses the first row's limit.  A row with no key yet
  // exponentiates against 0, so its masked keys weigh 2^(NEG_INF sl2) = 0.
  __device__ __forceinline__ void softmax(int key0, bool masked, float sl2,
                                          float (&alpha)[2]) {
    const int lane = threadIdx.x % 32;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      if (masked && key0 + (i / 4) * 8 + (lane & 3) * 2 + (i & 1) >= lim[h])
        s[i] = NEG_INF;
      mx[h] = fmaxf(mx[h], s[i]);
    }
    float use[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float mn = mx[h] == NEG_INF ? m[h] : fmaxf(m[h], mx[h] * sl2);
      use[h] = mn == NEG_INF ? 0.f : mn;
      alpha[h] = ex2(m[h] - use[h]);
      m[h] = mn;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float pe = ex2(fmaf(s[i], sl2, -use[(i >> 1) & 1]));
      s[i] = pe;
      rs[(i >> 1) & 1] += pe;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
  }

  __device__ __forceinline__ void rescale(const float (&alpha)[2]) {
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
  }

  // P (f32, the accumulator layout) -> the A fragments of P V: keys
  // 16 kk .. 16 kk + 15 are the score sums 8 kk .. 8 kk + 7
  __device__ __forceinline__ void to_p() {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f)
        split_bf16(s[8 * kk + 2 * f], s[8 * kk + 2 * f + 1], ph[kk][f],
                   pl[kk][f]);
  }

  // Writes this thread's state to x, thread-minor (t = its thread of the
  // warpgroup).
  __device__ __forceinline__ void save(float* x, int t) const {
#pragma unroll
    for (int i = 0; i < NO; ++i) x[i * WG + t] = o[i];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      x[(NO + h) * WG + t] = m[h];
      x[(NO + 2 + h) * WG + t] = l[h];
    }
  }

  // The weight of a state of maximum mc against the common maximum mg
  __device__ __forceinline__ static float weight(float mc, float mg) {
    return ex2(mc - (mg == NEG_INF ? 0.f : mg));
  }

  // Merges the state at x (as save writes it; CG: another CTA's, read
  // past L1) into this thread's: against the rows' common maximum, its
  // own sums first, then x's.
  template <bool CG>
  __device__ __forceinline__ void merge(const float* x, int t) {
    float w0[2], w1[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mx = CG ? __ldcg(x + (NO + h) * WG + t) : x[(NO + h) * WG + t];
      const float lx = CG ? __ldcg(x + (NO + 2 + h) * WG + t)
                          : x[(NO + 2 + h) * WG + t];
      const float mg = fmaxf(m[h], mx);
      w0[h] = weight(m[h], mg);
      w1[h] = weight(mx, mg);
      l[h] = l[h] * w0[h] + lx * w1[h];
      m[h] = mg;
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      const float ox = CG ? __ldcg(x + i * WG + t) : x[i * WG + t];
      o[i] = o[i] * w0[(i >> 1) & 1] + ox * w1[(i >> 1) & 1];
    }
  }

  // rows r0 and r0 + 8 of the tile as position pos0 + r / G, head
  // kvh G + r % G, divided by the rows' sums
  template <int G>
  __device__ __forceinline__ void store(const Params& p, int b, int kvh,
                                        int pos0, int r0) const {
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + h * 8;
      if ((BM / G) * G < BM && r >= (BM / G) * G) continue;   // padding row
      const int pos = pos0 + r / G;
      if (pos >= p.sq) continue;
      const float inv = 1.f / fmaxf(l[h], 1e-30f);
      __nv_bfloat16* dst =
          out + (((long long)b * p.sq + pos) * p.n_heads + kvh * G + r % G) * D;
#pragma unroll
      for (int j = 0; j < NO / 4; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + j * 8 + (lane & 3) * 2) =
            __floats2bfloat162_rn(o[4 * j + 2 * h] * inv,
                                  o[4 * j + 2 * h + 1] * inv);
    }
  }
};

// Zeroes rows [z0, z1) of every box of the V stage at `v` (whole 128-byte
// rows, so the swizzle does not matter) and orders the writes before the
// warpgroup's next wgmma; t is the thread of the warpgroup, bar its
// named barrier.
template <int D>
__device__ __forceinline__ void zero_rows(uint32_t v, int z0, int z1, int t,
                                          int bar) {
  constexpr int PER_ROW = (D / 64) * (ROW / 16);   // 16-byte pieces
  for (int idx = t; idx < (z1 - z0) * PER_ROW; idx += WG) {
    const int row = z0 + idx / PER_ROW;
    const int piece = idx % PER_ROW;
    const uint32_t addr =
        v + (piece / (ROW / 16)) * BN * ROW + row * ROW + (piece % (ROW / 16)) * 16;
    asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(addr),
                 "r"(0)
                 : "memory");
  }
  g9::fence_proxy_async();
  named_sync<WG>(bar);
}

// One CTA per item (64-row query tile, KV head, batch row, key chunk).
// Items run chunk-major, and within a chunk from the last query tile (the
// most keys) down; an item whose chunk starts at or past the tile's causal
// end exits at once.  A tile of one chunk with keys writes its output; the
// chunks of a split tile write partials, and the CTA that takes the tile's
// last ticket merges them in chunk order and sets the ticket back to 0.
template <int G, int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                  const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map, const Params p) {
  using L = Cfg<D>;
  constexpr int STAGES = L::STAGES;
  constexpr int PT = BM / G;   // positions per tile
  constexpr int Q_TX = L::BOXES * PT * G * ROW;   // the Q box's bytes
  extern __shared__ unsigned char smem_raw[];
  __shared__ int last;
  const uint32_t raw = g9::smem_u32(smem_raw);
  const uint32_t sq_s = (raw + 1023u) & ~1023u;
  const uint32_t sk = sq_s + L::Q_BYTES;
  const uint32_t sv = sk + STAGES * L::KV_BYTES;
  const uint32_t sx = sv + STAGES * L::KV_BYTES;   // the exchange
  const uint32_t q_bar = sx + L::XCHG;
  const uint32_t full_k = q_bar + 8;
  const uint32_t full_v = full_k + 8 * STAGES;
  const uint32_t empty_k = full_v + 8 * STAGES;
  const uint32_t empty_v = empty_k + 8 * STAGES;

  const int tiles = p.q_tiles * p.n_kv * p.batch;
  const int c = blockIdx.x / tiles;
  const int rest = blockIdx.x - c * tiles;
  const int qt = p.q_tiles - 1 - rest / (p.n_kv * p.batch);
  const int kvh = rest / p.batch % p.n_kv;
  const int b = rest % p.batch;
  const int tile = (b * p.n_kv + kvh) * p.q_tiles + qt;
  const int pos0 = qt * PT;
  const int k0 = c * p.chunk;
  const int tid = threadIdx.x;
  // a tile's first chunk loads its Q tile and first K/V stage before the
  // offset is read (whenever the tile has keys, they start at key 0)
  const bool early = c == 0 && p.skv > 0;

  if (tid == L::CONSUMERS) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&q_map)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&k_map)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&v_map)) : "memory");
    g9::mbar_init(q_bar, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      g9::mbar_init(full_k + 8 * s, 1);
      g9::mbar_init(full_v + 8 * s, 1);
      g9::mbar_init(empty_k + 8 * s, WG / 32);
      g9::mbar_init(empty_v + 8 * s, WG / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the producer: the Q tile, then each stage's K and V boxes, waiting
  // only on the empty barriers
  auto load_q = [&]() {
    g9::mbar_expect_tx(q_bar, Q_TX);
#pragma unroll
    for (int h = 0; h < D / 64; ++h)
      g9::tma_load_4d(sq_s + h * BM * ROW, &q_map, q_bar, 64 * h, kvh * G,
                      pos0, b);
  };
  auto load_kv = [&](int j) {
    const int s = j % STAGES;
    const uint32_t parity = ((j / STAGES) + 1) & 1;
    const int key = k0 + j * BN;
    if (j >= STAGES) g9::mbar_wait(empty_k + 8 * s, parity);
    g9::mbar_expect_tx(full_k + 8 * s, L::KV_BYTES);
#pragma unroll
    for (int h = 0; h < D / 64; ++h)
      g9::tma_load_4d(sk + s * L::KV_BYTES + h * BN * ROW, &k_map,
                      full_k + 8 * s, 64 * h, kvh, key, b);
    if (j >= STAGES) g9::mbar_wait(empty_v + 8 * s, parity);
    g9::mbar_expect_tx(full_v + 8 * s, L::KV_BYTES);
#pragma unroll
    for (int h = 0; h < D / 64; ++h)
      g9::tma_load_4d(sv + s * L::KV_BYTES + h * BN * ROW, &v_map,
                      full_v + 8 * s, 64 * h, kvh, key, b);
  };
  if (tid == L::CONSUMERS && early) {
    load_q();
    load_kv(0);
  }

  const int off = row_offset(p, b);
  const int last_pos = min(pos0 + PT, p.sq) - 1;
  // keys this tile needs: [0, kend); rows past it are never read
  const int kend = max(0, min(p.skv, off + last_pos + 1));
  if (k0 >= kend && c > 0) return;
  const int k1 = min(kend, k0 + p.chunk);
  const int n_kt = (k1 - k0 + BN - 1) / BN;   // 0 only when kend == 0
  const int n_live = (kend + p.chunk - 1) / p.chunk;

  if (tid >= L::CONSUMERS) {
    if (tid == L::CONSUMERS && n_kt > 0) {
      if (!early) load_q();
      for (int j = early ? 1 : 0; j < n_kt; ++j) load_kv(j);
    }
    return;
  }

  const int wg = tid / WG;
  const int t = tid % WG;
  const int lane = tid % 32;
  const bool lead = lane == 0;
  const int r0 = (t / 32) * 16 + lane / 4;   // rows r0 and r0 + 8
  Consumer<D> cs;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    cs.lim[h] = min(kend, off + pos0 + (r0 + h * 8) / G + 1);
    cs.m[h] = NEG_INF;
    cs.l[h] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < Consumer<D>::NO; ++i) cs.o[i] = 0.f;
  const int min_lim = min(p.skv, off + pos0 + 1);   // the first row's limit
  const float sl2 = p.scale * LOG2E;

  if (n_kt == 0 && early && wg == 0) {
    // no key at all: wait for the early loads before the CTA exits
    g9::mbar_wait(q_bar, 0);
    g9::mbar_wait(full_k, 0);
    g9::mbar_wait(full_v, 0);
  }
  if (n_kt > wg) {
    g9::mbar_wait(q_bar, 0);
    // this warpgroup's key tiles are j = wg, wg + WGS, ..., its last jl;
    // tile n_kt - 1 (the last of the warpgroup that has it) gets its V rows
    // at or past kend (stale cache rows inside the view) zeroed before its
    // P V: TMA loads whole boxes
    const int jl = wg + (n_kt - 1 - wg) / L::WGS * L::WGS;
    // S = Q K^T of tile j, then its softmax: P in registers
    auto scores = [&](int j) {
      const int s = j % STAGES;
      g9::mbar_wait(full_k + 8 * s, (j / STAGES) & 1);
      cs.scores(sq_s, sk + s * L::KV_BYTES);
      g9::wgmma_wait<0>();
      g9::fence_acc(cs.s);
      if (lead) g9::mbar_arrive(empty_k + 8 * s);
      const int key0 = k0 + j * BN;
      float alpha[2];
      cs.softmax(key0, key0 + BN > min_lim, sl2, alpha);
      cs.rescale(alpha);
      cs.to_p();
    };
    // O += P V of tile j
    auto pv = [&](int j) {
      const int s = j % STAGES;
      g9::mbar_wait(full_v + 8 * s, (j / STAGES) & 1);
      cs.pv(sv + s * L::KV_BYTES);
      g9::wgmma_wait<0>();
      g9::fence_acc(cs.o);
      if (lead) g9::mbar_arrive(empty_v + 8 * s);
    };
    for (int j = wg; j < jl; j += L::WGS) {
      scores(j);
      pv(j);
    }
    scores(jl);
    const int z0 = k1 - (k0 + jl * BN);
    const int z1 = min(BN, p.skv - (k0 + jl * BN));
    if (jl == n_kt - 1 && z0 < z1) {
      const int s = jl % STAGES;
      g9::mbar_wait(full_v + 8 * s, (jl / STAGES) & 1);
      zero_rows<D>(sv + s * L::KV_BYTES, z0, z1, t, 2 + wg);
    }
    pv(jl);
  }

  // each row's sum over the four lanes that hold it
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    cs.l[h] += __shfl_xor_sync(0xffffffffu, cs.l[h], 1);
    cs.l[h] += __shfl_xor_sync(0xffffffffu, cs.l[h], 2);
  }
  if (L::WGS > 1) {
    // the second warpgroup's state joins the first's through shared memory
    float* x = reinterpret_cast<float*>(smem_raw + (sx - raw));
    if (wg == 1) cs.save(x, t);
    named_sync<L::CONSUMERS>(1);
    if (wg == 1) return;
    cs.template merge<false>(x, t);
  }
  if (n_live <= 1) {
    cs.template store<G>(p, b, kvh, pos0, r0);
    return;
  }

  // a split tile: this chunk's partial, then the merge by the last chunk
  float* part = p.part + (long long)tile * p.n_chunks * L::PART;
  cs.save(part + (long long)c * L::PART, t);
  __threadfence();
  named_sync<WG>(2);
  if (t == 0) last = atomicAdd(p.tickets + tile, 1) == n_live - 1;
  named_sync<WG>(2);
  if (!last) return;
  __threadfence();
  cs.m[0] = cs.m[1] = NEG_INF;
  cs.l[0] = cs.l[1] = 0.f;
#pragma unroll
  for (int i = 0; i < Consumer<D>::NO; ++i) cs.o[i] = 0.f;
  for (int cc = 0; cc < n_live; ++cc)
    cs.template merge<true>(part + (long long)cc * L::PART, t);
  cs.template store<G>(p, b, kvh, pos0, r0);
  if (t == 0) p.tickets[tile] = 0;   // ready for the next launch
}

// ---------------------------------------------------------------------------
// f32: one block per query position, warps split the keys
// ---------------------------------------------------------------------------
constexpr int NUM_WARPS = 8;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int N>
struct alignas(4 * N) Vec {
  float v[N];
};

template <int N>
__device__ __forceinline__ void load_vec(const float* __restrict__ p,
                                         float (&out)[N]) {
  const Vec<N> x = *reinterpret_cast<const Vec<N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = x.v[i];
}

// G: query heads per KV head; DPL: head_dim / 32 (elements per lane).
template <int G, int DPL>
__global__ void __launch_bounds__(NUM_WARPS * 32)
flash_f32_kernel(const Params p) {
  constexpr int D = DPL * 32;
  constexpr int ROWS = DPL <= 4 ? 8 : 4;   // K/V rows in flight per warp
  const int kvh = blockIdx.x;
  const int pos = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int len = max(0, min(p.skv, row_offset(p, b) + pos + 1));
  const long long qrow = ((long long)b * p.sq + pos) * p.n_heads + kvh * G;
  const float* __restrict__ q = static_cast<const float*>(p.q);
  float* __restrict__ out = static_cast<float*>(p.out);

  float qf[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_vec<DPL>(q + (qrow + g) * D + lane * DPL, qf[g]);
#pragma unroll
    for (int i = 0; i < DPL; ++i) qf[g][i] *= p.scale;
  }
  float m[G], l[G], acc[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
  }
  const float* __restrict__ kb =
      static_cast<const float*>(p.k) + b * p.k_sb + kvh * D + lane * DPL;
  const float* __restrict__ vb =
      static_cast<const float*>(p.v) + b * p.v_sb + kvh * D + lane * DPL;

  for (int base = warp * ROWS; base < len; base += NUM_WARPS * ROWS) {
    float kf[ROWS][DPL], vf[ROWS][DPL];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      if (base + u < len) {
        load_vec<DPL>(kb + (base + u) * p.k_ss, kf[u]);
        load_vec<DPL>(vb + (base + u) * p.v_ss, vf[u]);
      } else {
#pragma unroll
        for (int i = 0; i < DPL; ++i) kf[u][i] = vf[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s[ROWS];
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) part = fmaf(qf[g][i], kf[u][i], part);
        s[u] = (base + u < len) ? warp_sum(part) : NEG_INF;
        mx = fmaxf(mx, s[u]);
      }
      const float alpha = expf(m[g] - mx);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        s[u] = (base + u < len) ? expf(s[u] - mx) : 0.f;
        psum += s[u];
      }
      l[g] = l[g] * alpha + psum;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        float a = acc[g][i] * alpha;
#pragma unroll
        for (int u = 0; u < ROWS; ++u) a = fmaf(s[u], vf[u][i], a);
        acc[g][i] = a;
      }
      m[g] = mx;
    }
  }

  // merge the warps' partial softmax states, in a fixed order
  __shared__ float sm_m[NUM_WARPS][G];
  __shared__ float sm_l[NUM_WARPS][G];
  __shared__ float sm_acc[G][D];
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
  }
  for (int idx = threadIdx.x; idx < G * D; idx += NUM_WARPS * 32)
    sm_acc[idx / D][idx % D] = 0.f;
  __syncthreads();
  float mine[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float mg = NEG_INF;
    for (int w = 0; w < NUM_WARPS; ++w) mg = fmaxf(mg, sm_m[w][g]);
    mine[g] = expf(m[g] - mg);
  }
  for (int w = 0; w < NUM_WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < DPL; ++i) sm_acc[g][lane * DPL + i] += acc[g][i] * mine[g];
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < G * D; idx += NUM_WARPS * 32) {
    const int g = idx / D;
    const int d = idx % D;
    float mg = NEG_INF;
    for (int w = 0; w < NUM_WARPS; ++w) mg = fmaxf(mg, sm_m[w][g]);
    float lg = 0.f;
    for (int w = 0; w < NUM_WARPS; ++w) lg += sm_l[w][g] * expf(sm_m[w][g] - mg);
    out[(qrow + g) * D + d] = sm_acc[g][d] / fmaxf(lg, 1e-30f);
  }
}

// Sets the bf16 kernel's shared-memory size once per device and encodes its
// three tensor maps.  Returns 0, a CUDA error, or -2 when a map is refused.
template <int G, int D>
int launch_bf16(int batch, Params p, cudaStream_t stream) {
  using L = Cfg<D>;
  p.q_tiles = (p.sq + BM / G - 1) / (BM / G);
  auto kernel = flash_bf16_kernel<G, D>;
  static int sized = -1;   // the device whose attribute is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sized != dev) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = dev;
  }
  const cuuint64_t e = 2;   // bytes per element
  const cuuint64_t skv = p.skv > 0 ? p.skv : 1;
  CUtensorMap q_map, k_map, v_map;
  const cuuint64_t q_dims[4] = {D, (cuuint64_t)p.n_heads, (cuuint64_t)p.sq,
                                (cuuint64_t)batch};
  const cuuint64_t q_strides[3] = {D * e, p.n_heads * D * e,
                                   (cuuint64_t)p.sq * p.n_heads * D * e};
  const cuuint32_t q_box[4] = {64, G, BM / G, 1};
  const cuuint64_t kv_dims[4] = {D, (cuuint64_t)p.n_kv, skv,
                                 (cuuint64_t)batch};
  const cuuint64_t k_strides[3] = {D * e, (cuuint64_t)p.k_ss * e,
                                   (cuuint64_t)p.k_sb * e};
  const cuuint64_t v_strides[3] = {D * e, (cuuint64_t)p.v_ss * e,
                                   (cuuint64_t)p.v_sb * e};
  const cuuint32_t kv_box[4] = {64, 1, BN, 1};
  if (!g9::encode_4d(&q_map, p.q, q_dims, q_strides, q_box) ||
      !g9::encode_4d(&k_map, p.k, kv_dims, k_strides, kv_box) ||
      !g9::encode_4d(&v_map, p.v, kv_dims, v_strides, kv_box))
    return -2;
  const long long items =
      (long long)p.q_tiles * p.n_kv * batch * p.n_chunks;
  if (items > 0x7fffffffLL) return -1;
  kernel<<<static_cast<int>(items), L::THREADS, L::BYTES, stream>>>(
      q_map, k_map, v_map, p);
  return 0;
}

int launch(int dtype, int group, int head_dim, int batch, const Params& p,
           cudaStream_t stream) {
#define REPRO_FA_CASE(G, DPL)                                                  \
  if (group == G && head_dim == DPL * 32) {                                    \
    if (dtype == 1) return launch_bf16<G, DPL * 32>(batch, p, stream);         \
    flash_f32_kernel<G, DPL><<<dim3(p.n_kv, p.sq, batch), NUM_WARPS * 32, 0,   \
                               stream>>>(p);                                   \
    return 0;                                                                  \
  }
#define REPRO_FA_CASES(G) REPRO_FA_CASE(G, 2) REPRO_FA_CASE(G, 4) REPRO_FA_CASE(G, 8)
  REPRO_FA_CASES(1)
  REPRO_FA_CASES(2)
  REPRO_FA_CASES(4)
  REPRO_FA_CASES(8)
  // groups 3, 7 and 9 at head dim 128 only (csrc/decode_attention.cu)
  REPRO_FA_CASE(3, 4)
  REPRO_FA_CASE(7, 4)
  REPRO_FA_CASE(9, 4)
#undef REPRO_FA_CASES
#undef REPRO_FA_CASE
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out).  q (B, Sq, H, D) and
// out (B, Sq, H, D) are contiguous; k and v are (B, Skv, KV, D) with unit
// stride over (KV, D) and the given element strides over B and rows.
// q_offset is a (B,) int32 device array, or null for q_offset_scalar on
// every row.  bf16 only: the plan's key chunk (a multiple of 64) and
// n_chunks = ceil(Skv / chunk) (1 for Skv = 0); when n_chunks > 1, part
// holds ceil(Sq / (64 / group)) * KV * B * n_chunks * (head_dim / 2 + 4) *
// 128 floats and tickets ceil(Sq / (64 / group)) * KV * B int32 zeros, left
// zero by the launch.  Returns -1 for a shape or plan this build does not
// take, -2 for a tensor map cuTensorMapEncodeTiled refuses (strides or
// bases not 16-byte multiples), else the launch's CUDA error code.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, const void* q_offset,
    void* out, void* part, void* tickets, int dtype, int batch, int sq,
    int skv, int n_heads, int n_kv, int head_dim, int q_offset_scalar,
    int chunk, int n_chunks, long long k_stride_b, long long k_stride_s,
    long long v_stride_b, long long v_stride_s, float scale, void* stream) {
  if (batch == 0 || sq == 0) return 0;
  if ((dtype != 0 && dtype != 1) || n_kv <= 0 || n_heads % n_kv) return -1;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.q_offset = static_cast<const int32_t*>(q_offset);
  p.out = out;
  p.sq = sq;
  p.skv = skv;
  p.n_heads = n_heads;
  p.n_kv = n_kv;
  p.q_offset_scalar = q_offset_scalar;
  p.k_sb = k_stride_b;
  p.k_ss = k_stride_s;
  p.v_sb = v_stride_b;
  p.v_ss = v_stride_s;
  p.scale = scale;
  const int group = n_heads / n_kv;
  p.batch = batch;
  p.q_tiles = 0;   // set by the bf16 launch from its tile
  p.chunk = chunk;
  p.n_chunks = n_chunks;
  p.part = static_cast<float*>(part);
  p.tickets = static_cast<int32_t*>(tickets);
  if (dtype == 1 &&
      (chunk <= 0 || chunk % BN ||
       n_chunks != (skv > 0 ? (skv + chunk - 1) / chunk : 1) ||
       (n_chunks > 1 && (part == nullptr || tickets == nullptr))))
    return -1;
  const int rc = launch(dtype, group, head_dim, batch, p,
                        static_cast<cudaStream_t>(stream));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
