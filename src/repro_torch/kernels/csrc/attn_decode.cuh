// The decode-attention unit for Hopper (sm_90a) that csrc/decode_attention.cu
// and the attention role of csrc/fused_overlap.cu share.
//
// A unit is (row b, KV head, chunk of `chunk` consecutive cache rows): the G
// query heads of that KV head score their one query each against rows
// [chunk * C, min(len, (chunk + 1) * C)) of row b's cache, len =
// min(cache_len[b], S).  The contract is the TPU kernels' (src/repro/kernels/
// decode_attention.py `decode_attention`, src/repro/kernels/fused_overlap.py
// `_kernel`): scores are taken in f32 and scaled by `scale` (D ** -0.5), a
// masked score is NEG_INF = -1e30, the softmax denominator is clamped to
// 1e-30, rows past len are never read, and the caches are read in place
// through their (row, position) strides.  A row with no valid key gives
// zeros.
//
// What bounds it on the card: bytes.  Each attended K and V row is read
// once; the work is ~4 flops per byte, far below the ~295 flops per byte at
// which an H100 turns compute-bound.  So the unit keeps many bytes in flight
// and spends few instructions per byte:
//   * K and V tiles stream through a STAGES-deep cp.async ring in dynamic
//     shared memory (16-byte cp.async.cg, rows past the unit's end
//     zero-filled without a read), so the next tiles' copies are in flight
//     while the current one is scored.  A stage holds 16 KB of K and V
//     rows whatever the head dim, rows padded by 16 bytes so that ldmatrix
//     reads are free of bank conflicts.
//   * bf16 scores on the tensor cores: S = Q K^T on mma.sync m16n8k16 with
//     the query heads as the M side (G <= 8 heads in its first 8 rows, the
//     second 8 zero registers; G = 9 also fills rows 8-15, and then keeps
//     a second softmax state and a second 8-head O^T accumulator per
//     thread: HS below), q in bf16 as stored (its fragments in registers, or
//     in shared memory at D = 256) and the scale applied to the f32
//     scores.  The score fragment is already the B operand of the product
//     O^T += V^T P^T (M = head dim, from ldmatrix.trans of V), so P never
//     leaves registers; it enters as bf16 hi + lo halves, so P V keeps
//     f32-level precision (as csrc/flash_attention.cu).  The 8 warps split
//     a stage as KW key groups of 16 rows times D / 32 column groups of 32:
//     every warp scores its group's 16 keys over the whole head dim (the
//     cheap, repeated part) and accumulates 32 output columns.  Each key
//     group keeps its own online softmax in log2 units.
//   * f32 (for exact checks on the card) reads the same ring with CUDA-core
//     FMAs: each warp scores whole rows, one shuffle reduction per (row,
//     head), with its own online softmax.
//   * Split-KV with a deterministic merge: the key groups (or warps) merge
//     in a fixed order through shared memory; a row of one chunk writes its
//     output; otherwise each chunk writes its partial (m, l, acc) to
//     scratch, and the CTA that takes the (row, KV head) pair's last ticket
//     merges the partials in chunk order and sets the ticket back to 0.  No
//     result depends on which CTA ran which unit, or in which order.
//   * The launch is sized from S, never from a host read of cache_len: a
//     unit past its row's length returns before it reads anything.
//   * The paged form (PAGED = true, csrc/decode_attention.cu's
//     `repro_paged_decode_attention`) reads row b's logical row r from row
//     r % PS of page max(table[b, r / PS], 0) of (NP, PS, KV, D) pools (a -1
//     inside the length reads page 0, as the TPU kernel's `safe_table` and
//     its reference do).  Each stage's physical rows are looked up one stage
//     ahead, one table read per row by the first ROWS threads, and kept in
//     shared memory past the ring for the stage's 16-byte copies; table
//     entries past the row's length are never read.  Everything else is the
//     unit as it is.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace attn_decode {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int THREADS = 256;
constexpr int NUM_WARPS = THREADS / 32;
constexpr int STAGES = 3;
// head rows of the M side a group G takes (8 or 16), in head sets of 8;
// the merge's per-owner (m, l) rows are sized by it
template <int G>
__host__ __device__ constexpr int head_rows() { return G <= 8 ? 8 : 16; }
// a chunk is a whole number of stages for every dtype and head dim
constexpr int CHUNK_MULTIPLE = 64;

// Everything a unit reads; strides are in elements.  q and out are (B, H,
// D) contiguous; the caches (B, S, KV, D) with unit stride over (KV, D).
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* cache_len;
  void* out;
  float* part_ml;     // (B * KV, n_chunks, 2, G): m (log2 units) then l
  float* part_acc;    // (B * KV, n_chunks, G, D)
  int32_t* tickets;   // (B * KV,), 0 between launches
  int B, n_kv, S, chunk, n_chunks;
  long long k_sb, k_ss, v_sb, v_ss;
  float scale;
};

// The paged form's extra operands: the (B, max_pages) table of page ids and
// the rows per page; its caches are the pools, k_sb and v_sb are 0 and a
// page's flat row f = page * page_size + r % page_size is read at f * k_ss.
struct PagedArgs : Args {
  const int32_t* table;
  int max_pages, page_size;
};

// ---------------------------------------------------------------------------
// primitives (also used by the GEMM role of csrc/fused_overlap.cu)
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  // src-size 0 zero-fills the 16 destination bytes without reading src
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (a, b) -> bf16 pairs hi + lo with hi + lo = (a, b) to ~2^-17 relative
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - __low2float(h),
                                                 b - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// ---------------------------------------------------------------------------
// the ring's shape
// ---------------------------------------------------------------------------
template <typename T, int D>
struct Ring {
  static constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int DW = D / 32;                // bf16: column groups
  static constexpr int KW = NUM_WARPS / DW;        // bf16: key groups
  // rows per stage: 8 KB of K (and of V) per stage
  static constexpr int ROWS = BF16 ? 16 * KW : 2048 / D;
  static constexpr int LD = BF16 ? D + 8 : D;      // row pitch, elements
  static constexpr int OWNERS = BF16 ? KW : NUM_WARPS;   // softmax states
  // bf16 keeps q's MMA fragments in registers up to D = 128; at D = 256
  // they would spill under the fused kernel's 128-register cap, so q waits
  // in shared memory and each tile reads its fragments with ldmatrix
  static constexpr bool Q_SMEM = BF16 && D > 128;
  static constexpr int RING_BYTES = STAGES * 2 * ROWS * LD * (int)sizeof(T);
  static_assert(D == 64 || D == 128 || D == 256, "head dim");
  static_assert(CHUNK_MULTIPLE % ROWS == 0, "a chunk is whole stages");
  static_assert(ROWS * D * (int)sizeof(T) / 16 % THREADS == 0,
                "every thread copies the same number of 16-byte pieces");
};

// dynamic shared memory of one unit: the ring (the merge reuses it), plus q
// in f32, or in bf16 at D = 256 (head_rows padded rows, those >= G zero)
template <typename T, int G, int D>
__host__ __device__ constexpr int smem_bytes() {
  return Ring<T, D>::RING_BYTES +
         (!Ring<T, D>::BF16 ? G * D * 4
                            : Ring<T, D>::Q_SMEM ? head_rows<G>() * Ring<T, D>::LD * 2 : 0);
}

// the paged form adds each stage's physical rows, [STAGES][ROWS] int32
template <typename T, int G, int D>
__host__ __device__ constexpr int paged_smem_bytes() {
  return smem_bytes<T, G, D>() + STAGES * Ring<T, D>::ROWS * 4;
}

// ---------------------------------------------------------------------------
// the states' merge: in-CTA owners in order, then the chunks of a pair
// ---------------------------------------------------------------------------
// sm_ml[o][g] = (m, l) of owner o (log2 units); sm_acc[g][d] already holds
// sum_o acc_o * 2^(m_o - M).  Writes the output, or the chunk's partial and,
// for the pair's last chunk to finish, the merged output.
template <typename T, int G, int D, int OWNERS>
__device__ void finish(const Args& a, int b, int kvh, int pair, int chunk,
                       int n_chunks, float (*sm_ml)[head_rows<G>()][2],
                       const float* sm_acc) {
  __shared__ int last;
  T* __restrict__ out = static_cast<T*>(a.out) +
                        ((long long)b * a.n_kv * G + kvh * G) * D;
  float* ml = a.part_ml + (long long)pair * a.n_chunks * 2 * G;
  float* pacc = a.part_acc + (long long)pair * a.n_chunks * G * D;
  for (int idx = threadIdx.x; idx < G * D; idx += THREADS) {
    const int g = idx / D;
    float mg = NEG_INF;
#pragma unroll
    for (int o = 0; o < OWNERS; ++o) mg = fmaxf(mg, sm_ml[o][g][0]);
    float lg = 0.f;
#pragma unroll
    for (int o = 0; o < OWNERS; ++o) lg += sm_ml[o][g][1] * exp2f(sm_ml[o][g][0] - mg);
    if (n_chunks == 1) {
      out[idx] = from_f32<T>(sm_acc[idx] / fmaxf(lg, 1e-30f));
    } else {
      pacc[(long long)chunk * G * D + idx] = sm_acc[idx];
      if (idx % D == 0) {
        ml[(chunk * 2) * G + g] = mg;
        ml[(chunk * 2 + 1) * G + g] = lg;
      }
    }
  }
  if (n_chunks > 1) {
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(a.tickets + pair, 1) == n_chunks - 1;
    __syncthreads();
    if (last) {
      __threadfence();
      for (int idx = threadIdx.x; idx < G * D; idx += THREADS) {
        const int g = idx / D;
        float mg = NEG_INF;
        for (int c = 0; c < n_chunks; ++c) mg = fmaxf(mg, __ldcg(ml + (c * 2) * G + g));
        float lg = 0.f, acc = 0.f;
        for (int c = 0; c < n_chunks; ++c) {
          const float e = exp2f(__ldcg(ml + (c * 2) * G + g) - mg);
          lg += __ldcg(ml + (c * 2 + 1) * G + g) * e;
          acc += __ldcg(pacc + (long long)c * G * D + idx) * e;
        }
        out[idx] = from_f32<T>(acc / fmaxf(lg, 1e-30f));
      }
      if (threadIdx.x == 0) a.tickets[pair] = 0;   // ready for the next launch
    }
  }
}

// ---------------------------------------------------------------------------
// one unit
// ---------------------------------------------------------------------------
// T: q/cache/out type (float or __nv_bfloat16); G: query heads per KV head
// (<= 8, or 9 at D <= 128); D: head dim; PAGED: `a` is a PagedArgs and the
// caches are read through its table.  `u` = chunk * (B * KV) + (b * KV + kvh).  All THREADS
// threads of the CTA call it; it leaves the shared buffer free.
template <typename T, int G, int D, bool PAGED = false>
__device__ void unit(const Args& a, int u, unsigned char* smem) {
  using R = Ring<T, D>;
  constexpr int ROWS = R::ROWS;
  constexpr int LD = R::LD;
  constexpr int PIECES = ROWS * D * (int)sizeof(T) / 16 / THREADS;
  constexpr int PER_ROW = D * (int)sizeof(T) / 16;   // 16-byte pieces
  constexpr int MR = head_rows<G>();
  constexpr int HS = MR / 8;   // bf16: head sets of 8 rows on the M side
  static_assert(G >= 1 && G <= MR && MR <= 16, "group");
  static_assert(G <= 8 || !R::Q_SMEM, "q in shared memory holds 8 heads");
  const int pairs = a.B * a.n_kv;
  const int chunk = u / pairs;
  const int pair = u % pairs;
  const int b = pair / a.n_kv;
  const int kvh = pair % a.n_kv;
  const int len = min(max(a.cache_len[b], 0), a.S);
  const int n_chunks = max(1, (len + a.chunk - 1) / a.chunk);
  if (chunk >= n_chunks) return;   // past the row's length: nothing to read
  const int r0 = chunk * a.chunk;
  const int r1 = min(len, r0 + a.chunk);
  const int n_tiles = (r1 - r0 + ROWS - 1) / ROWS;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const float sl2 = a.scale * LOG2E;
  const T* __restrict__ q = static_cast<const T*>(a.q) +
                            ((long long)b * a.n_kv * G + kvh * G) * D;
  const T* __restrict__ kb = static_cast<const T*>(a.k) +
                             (long long)b * a.k_sb + kvh * D;
  const T* __restrict__ vb = static_cast<const T*>(a.v) +
                             (long long)b * a.v_sb + kvh * D;
  T* sk = reinterpret_cast<T*>(smem);          // [STAGES][ROWS][LD]
  T* sv = sk + STAGES * ROWS * LD;             // [STAGES][ROWS][LD]
  // paged: the flat row of each stage row, [STAGES][ROWS], and the lookup
  int* const prow = reinterpret_cast<int*>(smem + smem_bytes<T, G, D>());
  auto phys = [&](int row) -> int {
    const PagedArgs& pg = static_cast<const PagedArgs&>(a);
    if (row >= r1) return 0;
    const int page = max(pg.table[(long long)b * pg.max_pages + row / pg.page_size], 0);
    return page * pg.page_size + row % pg.page_size;
  };

  auto load = [&](int stage, int t) {
    const int row0 = r0 + t * ROWS;
#pragma unroll
    for (int i = 0; i < PIECES; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / PER_ROW;
      const int col = (c % PER_ROW) * (16 / (int)sizeof(T));
      int row = row0 + r;
      const bool ok = row < r1;
      if constexpr (PAGED) row = prow[stage * ROWS + r];
      cp_async16(sk + (stage * ROWS + r) * LD + col,
                 ok ? kb + row * a.k_ss + col : kb, ok);
      cp_async16(sv + (stage * ROWS + r) * LD + col,
                 ok ? vb + row * a.v_ss + col : vb, ok);
    }
  };
  if constexpr (PAGED) {
    if (tid < ROWS) {
#pragma unroll
      for (int s = 0; s < STAGES; ++s) prow[s * ROWS + tid] = phys(r0 + s * ROWS + tid);
    }
    __syncthreads();
  }
  // paged: stage t + STAGES's rows, read before stage t is scored and
  // stored after it into stage t's slot, whose copies went out STAGES - 1
  // iterations before
  auto next_rows = [&](int t) -> int {
    return PAGED && tid < ROWS ? phys(r0 + (t + STAGES) * ROWS + tid) : 0;
  };
  auto store_rows = [&](int t, int rows) {
    if (PAGED && tid < ROWS) prow[(t % STAGES) * ROWS + tid] = rows;
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load(s, s);
    cp_async_commit();
  }

  // after the loop the ring holds the merge: sm_ml [OWNERS][MR][2], then
  // sm_acc [G][D]
  float(*sm_ml)[MR][2] = reinterpret_cast<float(*)[MR][2]>(smem);
  float* sm_acc = reinterpret_cast<float*>(smem) + NUM_WARPS * MR * 2;

  if constexpr (R::BF16) {
    constexpr int KS = D / 16;             // k-steps of Q K^T
    const int kg = warp / R::DW;           // key group: rows kg*16.. of a stage
    const int dg = warp % R::DW;           // column group: d in [dg*32, +32)
    const int h = lane >> 2;               // this thread's head in the scores
    // A fragments of Q (rows = heads; rows 8-15 are zero registers unless
    // HS = 2, when they hold heads 8..): qa in registers, or at D = 256 q
    // in shared memory (published by the first tile's __syncthreads)
    constexpr bool Q_SMEM = R::Q_SMEM;
    __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem + R::RING_BYTES);
    uint32_t qa[Q_SMEM ? 1 : KS][2 * HS];
    if constexpr (Q_SMEM) {
      for (int i = tid; i < MR * D / 8; i += THREADS) {   // 16-byte pieces
        const int r = i / (D / 8);
        const int col = (i % (D / 8)) * 8;
        const uint4 piece = r < G ? *reinterpret_cast<const uint4*>(q + r * D + col)
                                  : make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(sq + r * LD + col) = piece;
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int col = ks * 16 + (lane & 3) * 2;
        qa[ks][0] = h < G ? *reinterpret_cast<const uint32_t*>(q + h * D + col) : 0u;
        qa[ks][1] = h < G ? *reinterpret_cast<const uint32_t*>(q + h * D + col + 8) : 0u;
        if constexpr (HS > 1) {
          const int h8 = h + 8;
          qa[ks][2] = h8 < G ? *reinterpret_cast<const uint32_t*>(q + h8 * D + col) : 0u;
          qa[ks][3] = h8 < G ? *reinterpret_cast<const uint32_t*>(q + h8 * D + col + 8) : 0u;
        }
      }
    }
    // head set hs: head h + 8 hs's state, this key group
    float m[HS], l[HS];
    // O^T: d = dg*32 + mt*16 + .., 2 heads of each head set
    float o[HS][2][4];
#pragma unroll
    for (int hs = 0; hs < HS; ++hs) {
      m[hs] = NEG_INF;
      l[hs] = 0.f;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[hs][mt][e] = 0.f;
    }

    for (int t = 0; t < n_tiles; ++t) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      const int nt = t + STAGES - 1;
      if (nt < n_tiles) load(nt % STAGES, nt);
      cp_async_commit();
      const int rows = next_rows(t);

      const int stage = t % STAGES;
      const __nv_bfloat16* kt = sk + (stage * ROWS + kg * 16) * LD;
      const __nv_bfloat16* vt = sv + (stage * ROWS + kg * 16) * LD;
      float s[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      uint32_t qf[4];   // Q_SMEM: the fragments of k-steps ks and ks + 1
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t bk[4];
        ldmatrix_x4(bk, kt + ((lane & 7) + ((lane >> 4) << 3)) * LD + ks * 16 +
                            ((lane >> 3) & 1) * 8);
        uint32_t af[4] = {0u, 0u, 0u, 0u};
        if constexpr (Q_SMEM) {
          if (ks % 2 == 0)
            ldmatrix_x4(qf, sq + (lane & 7) * LD + ks * 16 + (lane >> 3) * 8);
          af[0] = qf[(ks % 2) * 2];
          af[2] = qf[(ks % 2) * 2 + 1];
        } else {
          af[0] = qa[ks][0];
          af[2] = qa[ks][1];
          if constexpr (HS > 1) {
            af[1] = qa[ks][2];
            af[3] = qa[ks][3];
          }
        }
        mma_bf16(s[0], af, bk[0], bk[1]);
        mma_bf16(s[1], af, bk[2], bk[3]);
      }
      // online softmax of head h + 8 hs over this group's 16 keys (log2
      // units); s[n][2 hs + e], e < 2, is key n*8 + (lane&3)*2 + e of the
      // group
      const int key0 = r0 + t * ROWS + kg * 16 + (lane & 3) * 2;
      float alpha[HS];
      float p[HS][2][2];
#pragma unroll
      for (int hs = 0; hs < HS; ++hs) {
        float x[2][2];
        float mx = m[hs];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            x[n][e] = key0 + n * 8 + e < r1 ? s[n][2 * hs + e] * sl2 : NEG_INF;
            mx = fmaxf(mx, x[n][e]);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        alpha[hs] = exp2f(m[hs] - mx);
        m[hs] = mx;
        float ps = 0.f;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            p[hs][n][e] = key0 + n * 8 + e < r1 ? exp2f(x[n][e] - mx) : 0.f;
            ps += p[hs][n][e];
          }
        l[hs] = l[hs] * alpha[hs] + ps;
      }
      // this thread's O columns are heads 8 hs + (lane&3)*2 and +1
#pragma unroll
      for (int hs = 0; hs < HS; ++hs) {
        const float a0 = __shfl_sync(0xffffffffu, alpha[hs], (lane & 3) * 8);
        const float a1 = __shfl_sync(0xffffffffu, alpha[hs], (lane & 3) * 8 + 4);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          o[hs][mt][0] *= a0;
          o[hs][mt][1] *= a1;
          o[hs][mt][2] *= a0;
          o[hs][mt][3] *= a1;
        }
      }
      // O^T += V^T P^T: P^T's B fragment is (keys (lane&3)*2.., head lane/4)
      uint32_t bh0[HS], bl0[HS], bh1[HS], bl1[HS];
#pragma unroll
      for (int hs = 0; hs < HS; ++hs) {
        split_bf16(p[hs][0][0], p[hs][0][1], bh0[hs], bl0[hs]);
        split_bf16(p[hs][1][0], p[hs][1][1], bh1[hs], bl1[hs]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        uint32_t av[4];
        ldmatrix_x4_trans(av, vt + ((lane & 7) + ((lane >> 4) & 1) * 8) * LD +
                                  dg * 32 + mt * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int hs = 0; hs < HS; ++hs) {
          mma_bf16(o[hs][mt], av, bh0[hs], bh1[hs]);
          mma_bf16(o[hs][mt], av, bl0[hs], bl1[hs]);
        }
      }
      store_rows(t, rows);
    }
    cp_async_wait<0>();
    __syncthreads();   // the ring becomes the merge buffer

#pragma unroll
    for (int hs = 0; hs < HS; ++hs) {
      l[hs] += __shfl_xor_sync(0xffffffffu, l[hs], 1);
      l[hs] += __shfl_xor_sync(0xffffffffu, l[hs], 2);
    }
    if (dg == 0 && (lane & 3) == 0) {
#pragma unroll
      for (int hs = 0; hs < HS; ++hs) {
        sm_ml[kg][h + 8 * hs][0] = m[hs];
        sm_ml[kg][h + 8 * hs][1] = l[hs];
      }
    }
    for (int idx = tid; idx < G * D; idx += THREADS) sm_acc[idx] = 0.f;
    __syncthreads();
    // the heads of this thread's O columns, their merged max and own scale
    const int hc = (lane & 3) * 2;
    float sc[HS][2];
#pragma unroll
    for (int hs = 0; hs < HS; ++hs)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int hh = 8 * hs + hc + j;
        float mg = NEG_INF;
#pragma unroll
        for (int o2 = 0; o2 < R::KW; ++o2) mg = fmaxf(mg, sm_ml[o2][hh][0]);
        sc[hs][j] = exp2f(sm_ml[kg][hh][0] - mg);
      }
#pragma unroll
    for (int owner = 0; owner < R::KW; ++owner) {
      if (kg == owner) {
#pragma unroll
        for (int hs = 0; hs < HS; ++hs)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int hh = 8 * hs + hc + (e & 1);
              const int d = dg * 32 + mt * 16 + (lane >> 2) + (e >> 1) * 8;
              if (hh < G) sm_acc[hh * D + d] += o[hs][mt][e] * sc[hs][e & 1];
            }
      }
      __syncthreads();
    }
  } else {
    constexpr int DPL = D / 32;            // elements per lane
    float* sq = reinterpret_cast<float*>(smem + R::RING_BYTES);   // [G][D]
    for (int idx = tid; idx < G * D; idx += THREADS) sq[idx] = q[idx];
    float m[G], l[G], acc[G][DPL];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m[g] = NEG_INF;
      l[g] = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
    }
    for (int t = 0; t < n_tiles; ++t) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();   // also publishes sq before the first tile
      const int nt = t + STAGES - 1;
      if (nt < n_tiles) load(nt % STAGES, nt);
      cp_async_commit();
      const int rows = next_rows(t);

      const int stage = t % STAGES;
      for (int rr = warp; rr < ROWS; rr += NUM_WARPS) {
        if (r0 + t * ROWS + rr >= r1) break;
        const float* kr = sk + (stage * ROWS + rr) * LD + lane * DPL;
        const float* vr = sv + (stage * ROWS + rr) * LD + lane * DPL;
        float kf[DPL], vf[DPL];
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          kf[i] = kr[i];
          vf[i] = vr[i];
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float part = 0.f;
#pragma unroll
          for (int i = 0; i < DPL; ++i) part = fmaf(sq[g * D + lane * DPL + i], kf[i], part);
          const float x = warp_sum(part) * sl2;
          const float mx = fmaxf(m[g], x);
          const float alpha = exp2f(m[g] - mx);
          const float pe = exp2f(x - mx);
          l[g] = l[g] * alpha + pe;
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[g][i] = fmaf(pe, vf[i], acc[g][i] * alpha);
          m[g] = mx;
        }
      }
      store_rows(t, rows);
    }
    cp_async_wait<0>();
    __syncthreads();   // the ring becomes the merge buffer

    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        sm_ml[warp][g][0] = m[g];
        sm_ml[warp][g][1] = l[g];
      }
    }
    for (int idx = tid; idx < G * D; idx += THREADS) sm_acc[idx] = 0.f;
    __syncthreads();
    float sc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mg = NEG_INF;
#pragma unroll
      for (int w = 0; w < NUM_WARPS; ++w) mg = fmaxf(mg, sm_ml[w][g][0]);
      sc[g] = exp2f(m[g] - mg);
    }
#pragma unroll
    for (int owner = 0; owner < NUM_WARPS; ++owner) {
      if (warp == owner) {
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int i = 0; i < DPL; ++i) sm_acc[g * D + lane * DPL + i] += acc[g][i] * sc[g];
      }
      __syncthreads();
    }
  }
  finish<T, G, D, R::OWNERS>(a, b, kvh, pair, chunk, n_chunks, sm_ml, sm_acc);
  __syncthreads();   // the next unit reuses the shared buffer
}

}  // namespace attn_decode
