// Latent attention of absorbed MLA (DeepSeek-V2) over the token-packed
// stream, for Hopper (sm_90a), with a plain C interface loaded through
// ctypes.
//
// Replaces the TPU kernel src/repro/kernels/packed_attention.py
// `packed_attention` in the form absorbed MLA runs it (`_kernel`, KV = 1,
// d_v != d_qk): token t attends rows [0, min(lengths[t], sweep)) of slot
// token_slot[t].  Key row r is [c_kv[slot, r] | k_rope[slot, r]] (rank +
// rope = 576 columns), read in place from the two cache leaves through
// their own strides; the value row is c_kv[slot, r], the key's first 512
// columns, so one shared-memory stage serves both products and no
// concatenated key exists in device memory.  All H query heads share the
// one latent KV head (group = H).  Same constants as the TPU kernel: scores
// in f32 scaled by `scale` (the wrapper passes MLA's (nope + rope) ** -0.5,
// not d_qk ** -0.5), masked scores NEG_INF = -1e30, the softmax denominator
// clamped to 1e-30.  A token whose slot is out of range or whose length is
// not positive gives zeros.
//
// What bounds it on the card: at a decode token, bytes (each attended row
// is 1152 bytes in bf16); at a prefill chunk, operations (2 * H * (576 +
// 512) flops per attended (token, row)), since every token of a chunk
// attends its slot's rows again.
//
// Design (bf16):
//   * A CTA is one (token, block of 64 heads, chunk of key rows): the heads
//     are wgmma's 64-row M side, so group 128 and one KV head fill the
//     tensor cores' rows.  The wrapper's plan splits the sweep into chunks
//     only where the (token, head block) items leave SMs idle (a decode
//     batch), from the shapes alone; CTAs run chunk-major.  A split item's
//     chunks write f32 partials, and the CTA that takes the item's last
//     ticket (the split-KV counters the other attention kernels share)
//     merges them in chunk order and sets the ticket back to 0, in the
//     same launch: the result does not depend on which CTA ran what.
//   * Loads: a producer warp issues TMA copies into an mbarrier ring, all
//     with the 128-byte swizzle: the q tile (64 heads x 576 columns, nine
//     64-column boxes) and the first key stage are put in flight together,
//     then 64-key stages of two, each filled from two tensor maps over the
//     strided (slot, row) views, c_kv in 8 boxes and k_rope in 1, under one
//     expect_tx.  TMA zero-fills past the sweep; rows between a token's
//     length and the end of its last stage are another request's rows or
//     uninitialised cache, so their scores are masked with a select and
//     their V rows zeroed in shared memory before P V: a stale row never
//     reaches the output, even as NaN * 0.
//   * Products on wgmma.  Two consumer warpgroups split the 512 value
//     columns, 256 each (128 f32 sums a thread; 512 columns in one
//     warpgroup would need 256).  Each scores its half of the stage's keys
//     (m64n32k16, q and K both K-major in shared memory), the two exchange
//     row maxima through shared memory, and each passes its half of P, as
//     wgmma A fragments in bf16 hi + lo (P at near-f32 precision, as flash
//     keeps it), to the other: warpgroup 0's half in the stage's k_rope box
//     (read by the scores only, which are done by then), warpgroup 1's in
//     a buffer of its own.  So S is computed once a stage and both
//     warpgroups run O += P V on the same P, from registers, V read
//     MN-major from the stage's first 512 columns through the transpose
//     bit.  The online softmax runs in log2 units, one FFMA and one ex2 a
//     score.  setmaxnreg gives the consumers 232 registers and leaves the
//     producer warpgroup 40.
//   * Shared memory: q 73,728 B + two 64-key stages 147,456 B + one P half
//     8,192 B + the row exchange 512 B + barriers, within the 232,448 B a
//     block may use (a third stage, or P's other half beside it, does not
//     fit: hence the k_rope box).  One CTA per SM.
//   * What bounds it now (tools/mla_probe.py, PERF.md): with no row loaded
//     past the first two stages the kernel takes as long as it does in
//     full, so the ring is hidden and the consumers' chain (S, the
//     softmax and its two exchanges, P V, each waited for) is the time.
//     Tried and slower at every shape (PERF.md): 32-key stages four deep,
//     a cluster of the token's two head blocks sharing one TMA multicast
//     a stage, stages owned by alternate warpgroups or all by warpgroup 0
//     with the next S behind each P V (ptxas serialised the wgmmas,
//     C7515), and the next S behind P V in this design (a
//     compiler-inserted wait, spills).
//   * f32 (for the card's exact checks): 16 heads a CTA, 32-row stages in
//     shared memory, CUDA-core FMAs, a warp scoring two heads with lane =
//     key; split chunks merged by a second kernel.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "attn_decode.cuh"
#include "gemm_sm90.cuh"

namespace {
namespace mla {

namespace g9 = gemm_sm90;
using attn_decode::split_bf16;
using attn_decode::warp_sum;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int RANK = 512;           // kv_lora_rank: c_kv, and the value
constexpr int ROPE = 64;            // qk_rope_dim: k_rope
constexpr int D = RANK + ROPE;      // the latent key
constexpr int THREADS = 256;
constexpr int NK = 32;              // key rows per stage (f32)

// bf16 path
constexpr int BM = 64;              // query heads per CTA: wgmma's M
constexpr int BN = 64;              // key rows per stage
constexpr int HALF = BN / 2;        // keys a warpgroup scores
constexpr int WG = 128;             // threads of a warpgroup
constexpr int CONSUMERS = 2 * WG;
constexpr int BF_THREADS = CONSUMERS + WG;   // + the producer warpgroup
constexpr int ROW = 128;            // bytes of one swizzled row: 64 bf16
constexpr int BOXES = D / 64;       // 64-column boxes of a key row
constexpr int V_BOXES = RANK / 64;  // the value's: c_kv
constexpr int BOX = BN * ROW;       // one box of a stage
constexpr int Q_BYTES = BOXES * BM * ROW;
constexpr int STAGE_BYTES = BOXES * BOX;
constexpr int STAGES = 2;
constexpr int COLS = RANK / 2;      // value columns of a warpgroup
constexpr int NO = BM * COLS / WG;  // its f32 sums a thread: 128
// one warpgroup's half of P: (HALF / 16) A fragments, hi and lo, of 16 B
// a thread, thread-minor
constexpr int XP_BYTES = (HALF / 16) * 2 * WG * 16;
constexpr int XM_BYTES = 2 * BM * 4;   // each warpgroup's row maxima or sums
constexpr int BARS = 1 + 2 * STAGES;   // q, full, empty
constexpr int SMEM_BF16 =
    1024 + Q_BYTES + STAGES * STAGE_BYTES + XP_BYTES + XM_BYTES + BARS * 8;
// f32 floats of one warpgroup's state, thread-minor: the sums, then m and
// l of each thread's two rows; a split chunk's partial holds both
constexpr int WG_PART = (NO + 4) * WG;
constexpr int PART = 2 * WG_PART;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
static_assert(XP_BYTES == BOX, "warpgroup 0's P half fills the k_rope box");
static_assert(SMEM_BF16 <= 232448, "shared memory a block may use");
static_assert(PRODUCER_REGS * WG + CONSUMER_REGS * CONSUMERS <= 65536,
              "registers of the SM");

// f32 path
constexpr int F_HEADS = 16;
constexpr int F_LDK = D + 1;        // odd pitch: lane-per-key reads hit 32 banks
constexpr int SMEM_F32 = (F_HEADS * D + NK * F_LDK + F_HEADS * NK +
                          3 * F_HEADS) * 4;

struct Args {
  const void* q;
  const void* ckv;
  const void* krope;
  const int32_t* slot;
  const int32_t* len;
  void* out;
  float* part_ml;       // (T, H, splits, 2): m (log2 units), l
  float* part_acc;      // (T, H, splits, RANK): O unnormalized
  int t, h, n, sweep, chunk, splits;
  long long ck_s0, ck_s1, kr_s0, kr_s1;
  float sl2;            // scale * log2(e)
};

// The CTA's token, head block and key range [k0, k1); false when it has no
// key (out-of-range slot, non-positive length, or a chunk past the length).
struct Work {
  int t, hb, split, slot, k0, k1;
};

__device__ __forceinline__ bool find_work(const Args& a, int heads, Work& w) {
  const int hblocks = a.h / heads;
  int b = blockIdx.x;
  w.split = b % a.splits;
  b /= a.splits;
  w.hb = b % hblocks;
  w.t = b / hblocks;
  w.slot = a.slot[w.t];
  const int lim = min(a.len[w.t], a.sweep);
  w.k0 = w.split * a.chunk;
  w.k1 = min(lim, w.k0 + a.chunk);
  return w.slot >= 0 && w.slot < a.n && w.k1 > w.k0;
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// ---------------------------------------------------------------------------
// bf16: TMA ring, wgmma, a producer warp; split chunks merged in the launch
// ---------------------------------------------------------------------------
struct Params {
  const int32_t* slot;
  const int32_t* len;
  __nv_bfloat16* out;
  float* part;          // (T * H / 64, splits, PART) f32 partials
  int32_t* tickets;     // (T * H / 64,), 0 between launches
  int t, h, n, sweep, chunk, splits;
  float sl2;            // scale * log2(e)
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

__device__ __forceinline__ void st_shared_v4(uint32_t addr,
                                             const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}

__device__ __forceinline__ void ld_shared_v4(uint32_t addr,
                                             uint32_t (&v)[4]) {
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
               : "r"(addr)
               : "memory");
}

// A box of a 3-D `map` at (column c0, row c1, slot c2) into shared memory,
// completing `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// d (64 x 32) = A (64 x 16, K-major) @ B (16 x 32, K-major) + (d if
// `accumulate`, else 0): a warpgroup's scores, q as A and its half of a key
// stage (keys as rows) as B.
__device__ __forceinline__ void mma_kk_n32(float (&d)[16], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// What a consumer thread keeps: the softmax state of its two rows (m in
// log2 units of the scaled scores, l its warpgroup's keys' sum until the
// end), and its warpgroup's output sums, o[64 h + 4 j + e] at row r0 + 8 *
// (e / 2) and column 128 h + 8 j + 2 (t % 4) + e % 2 of the warpgroup's
// 256 (two m64n128 accumulators).
struct State {
  float m[2], l[2];
  float o[NO];

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = NEG_INF;
      l[h] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
  }

  // Writes the state to x, thread-minor (t = the thread of the warpgroup).
  __device__ __forceinline__ void save(float* x, int t) const {
#pragma unroll
    for (int i = 0; i < NO; ++i) x[i * WG + t] = o[i];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      x[(NO + h) * WG + t] = m[h];
      x[(NO + 2 + h) * WG + t] = l[h];
    }
  }

  // Merges another CTA's state at x (as save writes it, read past L1):
  // against the rows' common maximum, its own sums first, then x's.
  __device__ __forceinline__ void merge(const float* x, int t) {
    float w0[2], w1[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mx = __ldcg(x + (NO + h) * WG + t);
      const float lx = __ldcg(x + (NO + 2 + h) * WG + t);
      const float mg = fmaxf(m[h], mx);
      const float base = mg == NEG_INF ? 0.f : mg;
      w0[h] = ex2(m[h] - base);
      w1[h] = ex2(mx - base);
      l[h] = l[h] * w0[h] + lx * w1[h];
      m[h] = mg;
    }
#pragma unroll
    for (int i = 0; i < NO; ++i)
      o[i] = o[i] * w0[(i >> 1) & 1] +
             __ldcg(x + i * WG + t) * w1[(i >> 1) & 1];
  }

  // rows r0 and r0 + 8 of the block, divided by the rows' sums, into the
  // warpgroup's 256 columns at `dst` (row r0's first column of this thread)
  __device__ __forceinline__ void store(__nv_bfloat16* dst) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float inv = 1.f / fmaxf(l[h], 1e-30f);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + h * 8 * RANK + hh * 128 +
                                             j * 8) =
              __floats2bfloat162_rn(o[64 * hh + 4 * j + 2 * h] * inv,
                                    o[64 * hh + 4 * j + 2 * h + 1] * inv);
    }
  }
};

// The consumers' part of a busy CTA: the stages' products and softmax, then
// the output or this chunk's partial and, for the item's last chunk, the
// merge.
__device__ __forceinline__ void consume(const Params& p, uint32_t sq,
                                        uint32_t sk, uint32_t sxp,
                                        float* xm, uint32_t q_bar,
                                        uint32_t full, uint32_t empty,
                                        int* last, int item, int split,
                                        int k0, int k1, int n_st, int n_live,
                                        __nv_bfloat16* out_row) {
  const int tid = threadIdx.x;
  const int wg = tid / WG;
  const int t = tid % WG;
  const int lane = tid % 32;
  const int r0 = (t / 32) * 16 + lane / 4;   // rows r0 and r0 + 8
  State cs;
  cs.reset();
  g9::mbar_wait(q_bar, 0);
  for (int j = 0; j < n_st; ++j) {
    const int s = j % STAGES;
    const uint32_t st = sk + s * STAGE_BYTES;
    g9::mbar_wait(full + 8 * s, (j / STAGES) & 1);

    // S: the 64 heads against this warpgroup's 32 keys of the stage
    float sc[HALF / 2];
    g9::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_kk_n32(sc, g9::kmajor_desc(sq + (kk / 4) * BM * ROW + (kk % 4) * 32),
                 g9::kmajor_desc(st + (kk / 4) * BOX + wg * HALF * ROW +
                                 (kk % 4) * 32),
                 kk > 0);
    g9::wgmma_commit();
    g9::wgmma_wait<0>();
    g9::fence_acc(sc);

    // the rows' maxima over both halves; keys at or past k1 are NEG_INF (a
    // select, so a stale row's NaN never passes)
    const int key0 = k0 + j * BN + wg * HALF;
    const bool masked = key0 + HALF > k1;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < HALF / 2; ++i) {
      if (masked && key0 + (i / 4) * 8 + (lane & 3) * 2 + (i & 1) >= k1)
        sc[i] = NEG_INF;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    }
    if ((lane & 3) == 0) {
      xm[wg * BM + r0] = mx[0];
      xm[wg * BM + r0 + 8] = mx[1];
    }
    // past it, both warpgroups' scores of the stage are done
    named_sync<CONSUMERS>(1);

    // the online softmax: p = 2^(s sl2 - m); alpha rescales the earlier
    // sums.  A row with no key yet exponentiates against 0.
    float alpha[2], use[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], xm[(1 - wg) * BM + r0 + 8 * h]);
      const float mn =
          mx[h] == NEG_INF ? cs.m[h] : fmaxf(cs.m[h], mx[h] * p.sl2);
      use[h] = mn == NEG_INF ? 0.f : mn;
      alpha[h] = ex2(cs.m[h] - use[h]);
      cs.m[h] = mn;
    }
#pragma unroll
    for (int i = 0; i < HALF / 2; ++i) {
      const float pe = ex2(fmaf(sc[i], p.sl2, -use[(i >> 1) & 1]));
      sc[i] = pe;
      rs[(i >> 1) & 1] += pe;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) cs.l[h] = cs.l[h] * alpha[h] + rs[h];
#pragma unroll
    for (int i = 0; i < NO; ++i) cs.o[i] *= alpha[(i >> 1) & 1];

    // this warpgroup's half of P as A fragments (keys 16 kk .. 16 kk + 15 of
    // its half are the score sums 8 kk .. 8 kk + 7), for the other
    uint32_t ph[HALF / 16][4], pl[HALF / 16][4];
#pragma unroll
    for (int kk = 0; kk < HALF / 16; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f)
        split_bf16(sc[8 * kk + 2 * f], sc[8 * kk + 2 * f + 1], ph[kk][f],
                   pl[kk][f]);
    const uint32_t rope_box = st + V_BOXES * BOX;
    const uint32_t mine = wg == 0 ? rope_box : sxp;
    const uint32_t theirs = wg == 0 ? sxp : rope_box;
#pragma unroll
    for (int kk = 0; kk < HALF / 16; ++kk) {
      st_shared_v4(mine + ((2 * kk) * WG + t) * 16, ph[kk]);
      st_shared_v4(mine + ((2 * kk + 1) * WG + t) * 16, pl[kk]);
    }
    if (j == n_st - 1) {
      // the last stage's V rows at or past k1 inside the sweep (TMA zeroed
      // the rest), in this warpgroup's boxes: whole 128-byte rows, so the
      // swizzle does not matter
      const int z0 = k1 - (k0 + j * BN);
      const int z1 = min(BN, p.sweep - (k0 + j * BN));
      constexpr int PER_ROW = (V_BOXES / 2) * (ROW / 16);
      for (int idx = t; idx < (z1 - z0) * PER_ROW; idx += WG) {
        const int row = z0 + idx / PER_ROW;
        const int piece = idx % PER_ROW;
        const uint32_t addr = st +
                              (wg * V_BOXES / 2 + piece / (ROW / 16)) * BOX +
                              row * ROW + (piece % (ROW / 16)) * 16;
        asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(addr),
                     "r"(0)
                     : "memory");
      }
      g9::fence_proxy_async();
    }
    named_sync<CONSUMERS>(1);
    uint32_t oh[HALF / 16][4], ol[HALF / 16][4];
#pragma unroll
    for (int kk = 0; kk < HALF / 16; ++kk) {
      ld_shared_v4(theirs + ((2 * kk) * WG + t) * 16, oh[kk]);
      ld_shared_v4(theirs + ((2 * kk + 1) * WG + t) * 16, ol[kk]);
    }

    // O += P V over this warpgroup's 256 columns: its own keys, then the
    // other warpgroup's; P as hi + lo, two products a k-step
    g9::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const int half = kk < HALF / 16 ? wg : 1 - wg;
      const uint32_t v = st + (half * HALF + (kk % (HALF / 16)) * 16) * ROW;
      constexpr int H16 = HALF / 16;
      const int own = kk < H16 ? kk : 0, other = kk < H16 ? 0 : kk - H16;
      const uint32_t(&ah)[4] = kk < H16 ? ph[own] : oh[other];
      const uint32_t(&al)[4] = kk < H16 ? pl[own] : ol[other];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float(&acc)[64] = *reinterpret_cast<float(*)[64]>(cs.o + 64 * h);
        // MN-major: 64 columns a 128-byte row, the next 64 one box on
        const uint64_t desc = g9::smem_desc(
            v + (wg * V_BOXES / 2 + 2 * h) * BOX, BOX, 8 * ROW);
        g9::mma_rs<128>(acc, ah, desc, 1);
        g9::mma_rs<128>(acc, al, desc, 1);
      }
    }
    g9::wgmma_commit();
    g9::wgmma_wait<0>();
    g9::fence_acc(cs.o);
    // this thread's generic reads and writes of the stage come before the
    // TMA copies that refill it
    g9::fence_proxy_async();
    if (lane == 0) g9::mbar_arrive(empty + 8 * s);
  }

  // each row's sum over the four lanes that hold it, then over both
  // warpgroups' keys (the row maxima's last readers are past the last
  // stage's second barrier)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    cs.l[h] += __shfl_xor_sync(0xffffffffu, cs.l[h], 1);
    cs.l[h] += __shfl_xor_sync(0xffffffffu, cs.l[h], 2);
  }
  if ((lane & 3) == 0) {
    xm[wg * BM + r0] = cs.l[0];
    xm[wg * BM + r0 + 8] = cs.l[1];
  }
  named_sync<CONSUMERS>(1);
#pragma unroll
  for (int h = 0; h < 2; ++h) cs.l[h] += xm[(1 - wg) * BM + r0 + 8 * h];

  __nv_bfloat16* dst = out_row + r0 * RANK + wg * COLS + 2 * (lane & 3);
  if (n_live <= 1) {
    cs.store(dst);
    return;
  }
  // a split item: this chunk's partial, then the merge by its last chunk
  float* part = p.part + (long long)item * p.splits * PART + wg * WG_PART;
  cs.save(part + (long long)split * PART, t);
  __threadfence();
  named_sync<CONSUMERS>(1);
  if (tid == 0) *last = atomicAdd(p.tickets + item, 1) == n_live - 1;
  named_sync<CONSUMERS>(1);
  if (!*last) return;
  __threadfence();
  cs.reset();
  for (int cc = 0; cc < n_live; ++cc) cs.merge(part + (long long)cc * PART, t);
  cs.store(dst);
  if (tid == 0) p.tickets[item] = 0;   // ready for the next launch
}

// One CTA per (token, 64-head block, key chunk), chunk-major: blockIdx =
// (chunk * T + token) * (H / 64) + head block.  Threads [0, 256) are the
// consumer warpgroups, the next warpgroup the producer (its first thread
// issues every copy).
__global__ void __launch_bounds__(BF_THREADS, 1)
mla_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap ckv_map,
                const __grid_constant__ CUtensorMap kr_map, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int last;
  const uint32_t raw = g9::smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;
  const uint32_t sk = sq + Q_BYTES;                 // the stages
  const uint32_t sxp = sk + STAGES * STAGE_BYTES;   // warpgroup 1's P half
  const uint32_t sxm = sxp + XP_BYTES;              // the row exchange
  const uint32_t q_bar = sxm + XM_BYTES;
  const uint32_t full = q_bar + 8;
  const uint32_t empty = full + 8 * STAGES;
  const int tid = threadIdx.x;

  const int hblocks = p.h / BM;
  const int items = p.t * hblocks;
  const int split = blockIdx.x / items;
  const int item = blockIdx.x - split * items;
  const int tok = item / hblocks;
  const int hb = item - tok * hblocks;
  const int slot = p.slot[tok];
  const int lim = slot >= 0 && slot < p.n ? min(p.len[tok], p.sweep) : 0;
  const int k0 = split * p.chunk;
  const int k1 = min(lim, k0 + p.chunk);
  const int n_st = k1 > k0 ? (k1 - k0 + BN - 1) / BN : 0;
  const int n_live = lim > 0 ? (lim + p.chunk - 1) / p.chunk : 0;
  __nv_bfloat16* out_row = p.out + ((long long)tok * p.h + hb * BM) * RANK;

  if (tid == CONSUMERS) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&q_map)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&ckv_map)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&kr_map)) : "memory");
    g9::mbar_init(q_bar, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      g9::mbar_init(full + 8 * s, 1);
      g9::mbar_init(empty + 8 * s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // the producer: the q tile and the first stage together, then each
    // stage as its buffer comes free
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == CONSUMERS && n_st > 0) {
      g9::mbar_expect_tx(q_bar, Q_BYTES);
#pragma unroll
      for (int b = 0; b < BOXES; ++b)
        g9::tma_load(sq + b * BM * ROW, &q_map, q_bar, 64 * b,
                     tok * p.h + hb * BM);
      for (int j = 0; j < n_st; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) g9::mbar_wait(empty + 8 * s, ((j / STAGES) + 1) & 1);
        const uint32_t bar = full + 8 * s;
        const uint32_t dst = sk + s * STAGE_BYTES;
        const int key = k0 + j * BN;
        g9::mbar_expect_tx(bar, STAGE_BYTES);
#pragma unroll
        for (int b = 0; b < V_BOXES; ++b)
          tma_load_3d(dst + b * BOX, &ckv_map, bar, 64 * b, key, slot);
        tma_load_3d(dst + V_BOXES * BOX, &kr_map, bar, 0, key, slot);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    if (n_st > 0) {
      consume(p, sq, sk, sxp, reinterpret_cast<float*>(smem_raw + (sxm - raw)),
              q_bar, full, empty, &last, item, split, k0, k1, n_st, n_live,
              out_row);
    } else if (split == 0) {
      // no key at all: zeros
      for (int i = tid; i < BM * RANK / 8; i += CONSUMERS)
        *reinterpret_cast<uint4*>(out_row + i * 8) = make_uint4(0, 0, 0, 0);
    }
  }
}

// A 3-D map over a strided (slot, row) view of a bf16 leaf of `cols`
// columns (unit stride), read in boxes of 64 columns x BN rows with the
// 128-byte swizzle; rows past `rows` read as zeros.  False if
// cuTensorMapEncodeTiled refuses it.
bool encode_leaf(CUtensorMap* map, const void* base, int cols, int rows,
                 int slots, long long row_stride, long long slot_stride) {
  const g9::EncodeTiled fn = g9::encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)slots};
  // one slot: its stride is never used
  const long long ss = slots > 1 ? slot_stride : row_stride * rows;
  const cuuint64_t strides[2] = {(cuuint64_t)row_stride * 2,
                                 (cuuint64_t)ss * 2};
  const cuuint32_t box[3] = {64, BN, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Sets the bf16 kernel's shared-memory size once per device, encodes its
// three tensor maps and launches it.  Returns 0, a CUDA error, or -2 when
// a map is refused.
int launch_bf16(const void* q, const void* c_kv, const void* k_rope,
                const Params& p, long long ck_s0, long long ck_s1,
                long long kr_s0, long long kr_s1, cudaStream_t stream) {
  static int sized = -1;   // the device whose attribute is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sized != dev) {
    err = cudaFuncSetAttribute(mla_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BF16);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = dev;
  }
  CUtensorMap q_map, ckv_map, kr_map;
  if (!g9::encode(&q_map, q, p.t * p.h, D, BM)) return -2;
  // no row to read: the maps stay unused
  memset(&ckv_map, 0, sizeof ckv_map);
  memset(&kr_map, 0, sizeof kr_map);
  if (p.sweep > 0 && p.n > 0 &&
      (!encode_leaf(&ckv_map, c_kv, RANK, p.sweep, p.n, ck_s1, ck_s0) ||
       !encode_leaf(&kr_map, k_rope, ROPE, p.sweep, p.n, kr_s1, kr_s0)))
    return -2;
  const long long grid = (long long)p.t * (p.h / BM) * p.splits;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  mla_bf16_kernel<<<static_cast<unsigned>(grid), BF_THREADS, SMEM_BF16,
                    stream>>>(q_map, ckv_map, kr_map, p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS) mla_f32_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);           // F_HEADS x D
  float* sk = sq + F_HEADS * D;                         // NK x F_LDK
  float* sp = sk + NK * F_LDK;                          // F_HEADS x NK
  float* salpha = sp + F_HEADS * NK;                    // F_HEADS
  float* sm = salpha + F_HEADS;
  float* sl = sm + F_HEADS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  Work w;
  const bool busy = find_work(a, F_HEADS, w);
  const size_t row_t = (size_t)w.t * a.h + w.hb * F_HEADS;

  if (!busy) {
    if (a.splits == 1) {
      float* o = static_cast<float*>(a.out) + row_t * RANK;
      for (int i = tid; i < F_HEADS * RANK; i += THREADS) o[i] = 0.f;
    } else if (tid < F_HEADS) {
      float* ml = a.part_ml + ((row_t + tid) * a.splits + w.split) * 2;
      ml[0] = NEG_INF;
      ml[1] = 0.f;
    }
    return;
  }

  const float* q = static_cast<const float*>(a.q) + row_t * D;
  for (int i = tid; i < F_HEADS * D; i += THREADS) sq[i] = q[i];
  const float* ckv = static_cast<const float*>(a.ckv) +
                     (long long)w.slot * a.ck_s0;
  const float* krope = static_cast<const float*>(a.krope) +
                       (long long)w.slot * a.kr_s0;

  float acc[F_HEADS][2];
#pragma unroll
  for (int hh = 0; hh < F_HEADS; ++hh) acc[hh][0] = acc[hh][1] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int kb = w.k0; kb < w.k1; kb += NK) {
    for (int i = tid; i < NK * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const int row = kb + r;
      float x = 0.f;
      if (row < w.k1)
        x = d < RANK ? ckv[row * a.ck_s1 + d] : krope[row * a.kr_s1 + d - RANK];
      sk[r * F_LDK + d] = x;
    }
    __syncthreads();
    // warp: heads 2 warp, 2 warp + 1; lane: the key
    const bool valid = kb + lane < w.k1;
    const float* q0 = sq + (2 * warp) * D;
    const float* q1 = q0 + D;
    const float* kr = sk + lane * F_LDK;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float k = kr[d];
      s0 = fmaf(q0[d], k, s0);
      s1 = fmaf(q1[d], k, s1);
    }
    float s[2] = {valid ? s0 * a.sl2 : NEG_INF, valid ? s1 * a.sl2 : NEG_INF};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = s[hh];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[hh], mx);
      const float pe = valid ? exp2f(s[hh] - m_new) : 0.f;
      const float alpha = exp2f(m[hh] - m_new);
      l[hh] = l[hh] * alpha + warp_sum(pe);
      m[hh] = m_new;
      sp[(2 * warp + hh) * NK + lane] = pe;
      if (lane == 0) salpha[2 * warp + hh] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int hh = 0; hh < F_HEADS; ++hh) {
      const float al = salpha[hh];
      float a0 = acc[hh][0] * al, a1 = acc[hh][1] * al;
#pragma unroll 8
      for (int key = 0; key < NK; ++key) {
        const float pe = sp[hh * NK + key];
        a0 = fmaf(pe, sk[key * F_LDK + tid], a0);
        a1 = fmaf(pe, sk[key * F_LDK + tid + THREADS], a1);
      }
      acc[hh][0] = a0;
      acc[hh][1] = a1;
    }
    __syncthreads();
  }
  if (lane == 0) {
    sm[2 * warp] = m[0];
    sm[2 * warp + 1] = m[1];
    sl[2 * warp] = l[0];
    sl[2 * warp + 1] = l[1];
  }
  __syncthreads();
  if (a.splits == 1) {
    float* out = static_cast<float*>(a.out) + row_t * RANK;
#pragma unroll
    for (int hh = 0; hh < F_HEADS; ++hh) {
      const float inv = 1.f / fmaxf(sl[hh], 1e-30f);
      out[hh * RANK + tid] = acc[hh][0] * inv;
      out[hh * RANK + tid + THREADS] = acc[hh][1] * inv;
    }
  } else {
#pragma unroll
    for (int hh = 0; hh < F_HEADS; ++hh) {
      const size_t hrow = (row_t + hh) * a.splits + w.split;
      if (tid == 0) {
        a.part_ml[hrow * 2] = sm[hh];
        a.part_ml[hrow * 2 + 1] = sl[hh];
      }
      a.part_acc[hrow * RANK + tid] = acc[hh][0];
      a.part_acc[hrow * RANK + tid + THREADS] = acc[hh][1];
    }
  }
}

// ---------------------------------------------------------------------------
// the split chunks' merge: one CTA per (token, head), in chunk order
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(128) mla_merge_kernel(const Args a) {
  const size_t hrow = blockIdx.x;                 // token * H + head
  const float* ml = a.part_ml + hrow * a.splits * 2;
  float mmax = NEG_INF;
  for (int s = 0; s < a.splits; ++s)
    if (ml[2 * s + 1] > 0.f) mmax = fmaxf(mmax, ml[2 * s]);
  float acc[4] = {0.f, 0.f, 0.f, 0.f}, l = 0.f;
  const int col = threadIdx.x * 4;
  for (int s = 0; s < a.splits; ++s) {
    if (!(ml[2 * s + 1] > 0.f)) continue;
    const float f = exp2f(ml[2 * s] - mmax);
    l += f * ml[2 * s + 1];
    const float4 x = *reinterpret_cast<const float4*>(
        a.part_acc + (hrow * a.splits + s) * RANK + col);
    acc[0] += f * x.x;
    acc[1] += f * x.y;
    acc[2] += f * x.z;
    acc[3] += f * x.w;
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* out = static_cast<T*>(a.out) + hrow * RANK + col;
  store2(out, acc[0] * inv, acc[1] * inv);
  store2(out + 2, acc[2] * inv, acc[3] * inv);
}


}  // namespace mla
}  // namespace

// Returns a CUDA error code (0 on success), or -2 when cuTensorMapEncodeTiled
// refuses a map.  dtype: 0 float32, 1 bfloat16 (q, c_kv, k_rope and out
// share it).  c_kv (N, S, 512) and k_rope (N, S, 64) are read through their
// (slot, row) element strides, rows [0, sweep) of each slot.  The sweep is
// cut into `splits` chunks of `chunk` rows (a multiple of 64 in bf16, of
// 32 in f32).  With splits > 1: bf16 merges in the launch, part_acc
// holding T * H / 64 * splits * 33,792 f32 and tickets T * H / 64 int32
// zeros (left zero by the launch), part_ml unused; f32 writes part_ml (T *
// H * splits * 2) and part_acc (T * H * splits * 512) for a second kernel
// that merges them.
extern "C" int repro_mla_attention(
    const void* q, const void* c_kv, const void* k_rope,
    const int32_t* token_slot, const int32_t* lengths, void* out,
    float* part_ml, float* part_acc, int32_t* tickets, int dtype, int t,
    int h, int n, int sweep, int chunk, int splits, long long ck_s0,
    long long ck_s1, long long kr_s0, long long kr_s1, float scale,
    void* stream) {
  using namespace mla;
  if (t <= 0) return 0;
  if ((dtype != 0 && dtype != 1) || h <= 0 || splits < 1 || chunk <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (h % BM || chunk % BN || (splits > 1 && (!part_acc || !tickets)))
      return cudaErrorInvalidValue;
    const Params p{token_slot, lengths, static_cast<__nv_bfloat16*>(out),
                   part_acc, tickets, t, h, n, sweep, chunk, splits,
                   scale * LOG2E};
    return launch_bf16(q, c_kv, k_rope, p, ck_s0, ck_s1, kr_s0, kr_s1, st);
  }
  if (h % F_HEADS || chunk % NK || (splits > 1 && (!part_ml || !part_acc)))
    return cudaErrorInvalidValue;
  Args a{q, c_kv, k_rope, token_slot, lengths, out, part_ml, part_acc,
         t, h, n, sweep, chunk, splits, ck_s0, ck_s1, kr_s0, kr_s1,
         scale * LOG2E};
  const unsigned grid =
      (unsigned)t * (unsigned)(h / F_HEADS) * (unsigned)splits;
  cudaError_t err = cudaFuncSetAttribute(
      mla_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_F32);
  if (err != cudaSuccess) return err;
  mla_f32_kernel<<<grid, THREADS, SMEM_F32, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  mla_merge_kernel<float><<<(unsigned)t * (unsigned)h, RANK / 4, 0, st>>>(a);
  return cudaGetLastError();
}
