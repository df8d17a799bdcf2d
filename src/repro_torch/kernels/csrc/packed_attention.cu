// Segment-masked attention over the token-packed serving stream, for Hopper
// (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces the TPU kernel src/repro/kernels/packed_attention.py
// `packed_attention` (`_flash_step` and its four bodies): token t attends
// rows [0, min(lengths[t], kv_bucket)) of its own slot `token_slot[t]`, with
// an online softmax; query head h reads KV head h // group.  Same constants
// as the TPU kernel: scores are taken in f32 and scaled by `scale` (the
// wrapper passes d ** -0.5), masked scores are NEG_INF = -1e30, and the
// softmax denominator is clamped to 1e-30.  A token whose slot is out of
// range or whose length is not positive gives zeros.
//
// One source, two compile-time switches (-D flags; kernels/build.py
// builds each of the four variants into its own library, in parallel):
//   REPRO_PA_BLOCK_TABLE (`_kernel_block`): the caches are physical block
//     storage, and logical row r of the token's slot lives at flat row
//     bt[slot * nb_cols + r / bs] * bs + r % bs of the N·S row space
//     (DESIGN.md §12).  Table entries past the rows a tile reads are never
//     read.
//   REPRO_PA_QUANT (`_kernel_quant`): K and V rows are int8 with one f32
//     scale per (row, KV head), read in place from the (N, S, KV) scale
//     leaves (DESIGN.md §15).
// Both together are `_kernel_block_quant`.
//
// What bounds it on the card: bytes.  The distinct K and V rows the stream
// attends are the least it must read (2 * head_dim bytes per row and KV head
// in int8, twice that in bf16, plus 8 bytes of scales per int8 row).  A
// prefill chunk of n tokens attends n nested prefixes of one slot, so a
// kernel that reads each token's rows on its own reads the slot ~n times
// over, and scoring one (row, head) at a time on the CUDA cores is a
// dependent shuffle chain per row.
//
// The tile kernel (pa_tile below):
//   * A tile is a run of up to `tq` consecutive tokens of one slot: the
//     stream is cut into groups of tq tokens (tq * group <= 64), and each
//     group into runs of equal slot.  The engine orders a stream as decode
//     tokens (runs of one) then prefill chunks (long runs), so a chunk's
//     tiles are whole groups and each K/V row is read once per tile, not
//     once per token.  A tile's rows are its tokens x the group's heads (the
//     M side of the MMA, as csrc/flash_attention.cu); each row masks keys
//     by its own token's length, so any stream is right.
//     Work is an item (tile, chunk of key rows, KV head).  A tile of <= 16
//     rows (a decode token) splits its rows up to its largest length into
//     chunks (split-KV); a larger tile is one item per KV head.  The grid
//     is persistent (SMs x CTAs per SM): every CTA reads the stream's slots
//     and lengths 256 tokens at a time, finds the tiles, picks the window's
//     chunk (the smallest `chunk` << e whose items fill no more than the
//     grid, so a few decode tokens split finely and many do not), numbers
//     the items in stream order and runs those whose number is its own
//     modulo the grid.  No host read of the stream, no extra launch, and no
//     CTA waits on another's tiles.  An item streams its rows through a
//     two-stage cp.async ring.  With bf16 q, S = Q K^T and O += P V run on
//     mma.sync m16n8k16 with P as bf16 hi + lo (csrc/attn_decode.cuh's
//     primitives); f32 q (for the exact checks on the card) reads the same
//     ring with CUDA-core FMAs, one shuffle reduction per (key, row), as the
//     unit's f32 path does.  The 4 warps take 16 rows each, or, when a tile
//     has <= 16 (<= 32) rows, the stage's keys split 4 (2) ways, so a decode
//     token's chunk is scored by every warp; their softmax states merge in a
//     fixed order.  A
//     split tile writes per-chunk partials, and the CTA that takes the
//     tile's last ticket (keyed by its first token and KV head; the
//     split-KV tickets that decode attention and the fused op share) merges
//     them in chunk order and sets the ticket back to 0: results do not
//     depend on which CTA ran when.
//     int8 K/V go through the ring as codes.  With bf16 q they are widened
//     to bf16 (exact: |code| <= 127) in shared memory before ldmatrix; row
//     r's k_scale multiplies its f32 score column after Q K^T and its
//     v_scale P's column before the hi + lo split, so dequantization adds no
//     rounding beyond the f32 `x * scale` of the TPU kernel.  With f32 q a
//     code is dequantized as that `x * scale` as it leaves the ring.  Block
//     tables: each stage's physical rows are computed one stage ahead from
//     the slot's table row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#ifndef REPRO_PA_QUANT
#define REPRO_PA_QUANT 0
#endif
#ifndef REPRO_PA_BLOCK_TABLE
#define REPRO_PA_BLOCK_TABLE 0
#endif

namespace {

// the tile kernel's f32 path loads through these
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&out)[N]) {
  const Vec<T, N> x = *reinterpret_cast<const Vec<T, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f32(x.v[i]);
}

}  // namespace

#include "attn_decode.cuh"

// Internal linkage: each build is its own library, and a function-local
// static of a template with external linkage (launch_tiles's grid) is one
// object for every library a process loads.
namespace {
namespace pa_tile {

using attn_decode::cp_async16;
using attn_decode::cp_async_commit;
using attn_decode::cp_async_wait;
using attn_decode::ldmatrix_x4;
using attn_decode::ldmatrix_x4_trans;
using attn_decode::LOG2E;
using attn_decode::mma_bf16;
using attn_decode::smem_addr;
using attn_decode::split_bf16;
using attn_decode::warp_sum;

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;     // 4 warps
constexpr int WINDOW = 2 * THREADS;   // tokens a CTA reads at once (tq divides it)
constexpr int BM = 64;           // a tile's rows: tokens x the group's heads
constexpr int STAGES = 2;        // the cp.async ring's depth
constexpr int CHUNK_MULTIPLE = 64;   // a chunk is whole stages at every D
constexpr int CHUNK_STEPS = 8;       // a window's chunk: a.chunk << [0, 8)
constexpr bool QUANT = REPRO_PA_QUANT != 0;
constexpr bool BLOCK_TABLE = REPRO_PA_BLOCK_TABLE != 0;

struct Args {
  const void* q;      // (T, H, D) float or bf16
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int32_t* token_slot;
  const int32_t* lengths;
  const int32_t* block_tables;
  void* out;          // (T, H, D) as q
  float* part_ml;     // (T, KV, n_chunks, 2, G): m (log2 units) then l
  float* part_acc;    // (T, KV, n_chunks, G, D)
  int32_t* tickets;   // (T * KV,), 0 between launches
  int n_tokens, n_kv, n_slots, sweep, nb_cols, block_size;
  int tq, chunk, n_chunks;
  long long k_sn, k_ss, v_sn, v_ss, s_sn, s_ss;
  float scale;
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// four int8 codes -> two bf16 pairs, exactly: byte i becomes the f32
// 2^23 + 128 + code, minus 2^23 + 128
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& p01,
                                       uint32_t& p23) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) -
           8388736.f;
  const __nv_bfloat162 a = __floats2bfloat162_rn(f[0], f[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(f[2], f[3]);
  p01 = *reinterpret_cast<const uint32_t*>(&a);
  p23 = *reinterpret_cast<const uint32_t*>(&b);
}

// N (4 or 8) consecutive outputs from f32, in one or two 16-byte stores
template <int N>
__device__ __forceinline__ void store_out(float* p, const float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(p + i) = make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
}
template <int N>
__device__ __forceinline__ void store_out(__nv_bfloat16* p, const float (&x)[N]) {
  uint32_t w[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  if constexpr (N == 8)
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  else
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

// Shared-memory plan of one CTA (bytes): the ring (K then V per stage, as
// stored: bf16, f32 or int8 codes) and, for int8 under bf16 q, the widened
// bf16 stage; the warps' output merge reuses that region after the last
// stage; then the int8 scales per stage, then the q tile.
template <typename T, typename KV, int D>
struct Shape {
  static constexpr bool F32 = std::is_same<T, float>::value;   // CUDA cores
  static constexpr bool Q8 = std::is_same<KV, int8_t>::value;
  // key rows per stage: bf16 64 (32 at D 256), f32 8 KB of K per stage
  static constexpr int BN = F32 ? 2048 / D : D <= 128 ? 64 : 32;
  static constexpr int LD = D + 8;                     // q (and bf16) pitch, elements
  static constexpr int RLD = Q8 ? D + 16 : LD;         // ring pitch, elements
  static constexpr int KG_MAX = F32 ? 4 : BN / 16;     // ways a stage splits
  static constexpr int MLD = D + 8;                    // merge pitch, floats
  static constexpr int RING = STAGES * 2 * BN * RLD * (int)sizeof(KV);
  static constexpr int CVT = Q8 && !F32 ? 2 * BN * LD * 2 : 0;
  static constexpr int MERGE = 4 * 16 * MLD * 4;
  static constexpr int REGION = RING + CVT > MERGE ? RING + CVT : MERGE;
  static constexpr int SCALES = Q8 ? STAGES * 2 * BN * 4 : 0;
  static constexpr int SQ = BM * LD * (int)sizeof(T);
  static constexpr int BYTES = REGION + SCALES + SQ;
  static constexpr int PER_ROW = D * (int)sizeof(KV) / 16;   // 16 B pieces
  static_assert(D == 64 || D == 128 || D == 256, "head dim");
  static_assert(CHUNK_MULTIPLE % BN == 0, "a chunk is whole stages");
  static_assert(BN * PER_ROW % THREADS == 0, "even copy shares");
  static_assert(BN <= THREADS && BN <= 64, "one thread per stage row");
  static_assert(BN % 4 == 0 && (F32 || BN >= 16), "ring");
};

// What a CTA keeps between its tiles, in static shared memory.
struct Shared {
  int slot[WINDOW], len[WINDOW];   // the window's tokens: slot, clamped length
  // per token that starts a tile: its tokens, largest length, chunks, items
  // (chunks x KV heads; 0 for a token that starts none) and the items of the
  // window before it
  int n_tok[WINDOW], tile_len[WINDOW], nch[WINDOW], items[WINDOW];
  int base[WINDOW];
  int warp_items[THREADS / 32];
  int need[THREADS / 32][8];  // per warp: the window's tiles' items per chunk
  int hit;                    // the window's tile that holds a CTA's item
  int prow[STAGES][64];       // block tables: physical row of each stage row
  float ml[4][16][2];         // per warp: m (log2 units) and l of its rows
  float fac[4][BM];           // per key group and row: 2^(m - M)
  float row[BM][3];           // per row: M, 1 / max(L, 1e-30) and L
  int last;
};

// One (tile, chunk): rows [r0, r1) of the tile's slot for tokens
// [u0, u0 + n_tok), whose lengths are sh.len[ta..]; chunk c of nch.  KG:
// ways each stage's keys split over the warps (the warps then hold 16 rows
// x BN / KG keys).
template <typename T, typename KV, int G, int D, int KG>
__device__ __forceinline__ void tile(const Args& a, unsigned char* smem,
                                     Shared& sh, int kvh, int c, int nch,
                                     int ta, int u0, int n_tok, int slot,
                                     int r0, int r1) {
  using S = Shape<T, KV, D>;
  constexpr int BN = S::BN, LD = S::LD, RLD = S::RLD, MLD = S::MLD;
  constexpr int KEYS = BN / KG;    // a warp's keys per stage
  constexpr int NT = KEYS >= 8 ? KEYS / 8 : 1;   // bf16: its score n-tiles
  constexpr int OT = D / 8;        // bf16: output n-tiles
  constexpr int DPL = D / 32;      // f32: columns per lane
  constexpr int QV = 16 / (int)sizeof(T);   // q elements per 16-byte piece
  constexpr int PIECES = BN * S::PER_ROW / THREADS;
  static_assert(KG >= 1 && KG <= S::KG_MAX && 4 % KG == 0, "key groups");
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rows = n_tok * G;
  const int H = a.n_kv * G;
  const T* q = static_cast<const T*>(a.q);
  KV* ring = reinterpret_cast<KV*>(smem);              // [2][K, V][BN][RLD]
  __nv_bfloat16* cvt =
      reinterpret_cast<__nv_bfloat16*>(smem + S::RING);  // [K, V][BN][LD]
  float* macc = reinterpret_cast<float*>(smem);          // [4][16][MLD]
  float* scl = reinterpret_cast<float*>(smem + S::REGION);   // [2][K, V][BN]
  T* sq = reinterpret_cast<T*>(smem + S::REGION + S::SCALES);

  const int n_st = r1 > r0 ? (r1 - r0 + BN - 1) / BN : 0;

  // the tile's q rows (row r: token u0 + r / G, head kvh * G + r % G);
  // rows past the tile are zero
  for (int i = tid; i < BM * (D / QV); i += THREADS) {
    const int r = i / (D / QV);
    const int col = (i % (D / QV)) * QV;
    const bool ok = r < rows;
    cp_async16(sq + r * LD + col,
               ok ? q + ((long long)(u0 + r / G) * H + kvh * G + r % G) * D + col
                  : q,
               ok);
  }
  const long long base_k = BLOCK_TABLE ? 0 : (long long)slot * a.k_sn;
  const long long base_v = BLOCK_TABLE ? 0 : (long long)slot * a.v_sn;
  const long long base_s = BLOCK_TABLE ? 0 : (long long)slot * a.s_sn;
  const KV* kb = static_cast<const KV*>(a.k) + base_k + kvh * D;
  const KV* vb = static_cast<const KV*>(a.v) + base_v + kvh * D;
  const float* ksb = QUANT ? a.k_scale + base_s + kvh : nullptr;
  const float* vsb = QUANT ? a.v_scale + base_s + kvh : nullptr;
  const int32_t* bt =
      BLOCK_TABLE ? a.block_tables + (long long)slot * a.nb_cols : nullptr;
  // row r of the slot in the leaf's row space (the flat N·S rows when
  // block tables); rows at or past r1 are never looked up
  auto phys = [&](int r) -> int {
    if (!BLOCK_TABLE || r >= r1) return r;
    return bt[r / a.block_size] * a.block_size + r % a.block_size;
  };
  if (BLOCK_TABLE) {
    if (tid < BN)
      for (int st = 0; st < STAGES; ++st) sh.prow[st][tid] = phys(r0 + st * BN + tid);
    __syncthreads();
  }
  auto load = [&](int st) {
    const int buf = st % STAGES;
    const int row0 = r0 + st * BN;
    KV* sk = ring + buf * 2 * BN * RLD;
    KV* sv = sk + BN * RLD;
#pragma unroll
    for (int i = 0; i < PIECES; ++i) {
      const int p = tid + i * THREADS;
      const int r = p / S::PER_ROW;
      const int col = (p % S::PER_ROW) * (16 / (int)sizeof(KV));
      const bool ok = row0 + r < r1;
      const long long pr = BLOCK_TABLE ? sh.prow[buf][r] : row0 + r;
      cp_async16(sk + r * RLD + col, ok ? kb + pr * a.k_ss + col : kb, ok);
      cp_async16(sv + r * RLD + col, ok ? vb + pr * a.v_ss + col : vb, ok);
    }
    if (QUANT && tid < BN) {
      const bool ok = row0 + tid < r1;
      const long long pr = BLOCK_TABLE ? sh.prow[buf][tid] : row0 + tid;
      float* s = scl + buf * 2 * BN;
      cp_async4(s + tid, ok ? ksb + pr * a.s_ss : ksb, ok);
      cp_async4(s + BN + tid, ok ? vsb + pr * a.s_ss : vsb, ok);
    }
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {   // q lands with stage 0
    if (st < n_st) load(st);
    cp_async_commit();
  }

  const int rb = warp / KG;        // row block: rows rb * 16 .. + 15
  const int kq = warp % KG;        // key group: keys kq * KEYS .. of a stage
  const bool active = rb * 16 < rows;
  // the length that masks row r of the tile (0 past its rows)
  auto row_len = [&](int r) { return r < rows ? sh.len[ta + r / G] : 0; };
  // bf16: this thread's two rows' lengths
  int lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) lim[h] = row_len(rb * 16 + (lane >> 2) + h * 8);
  const float sl2 = a.scale * LOG2E;
  // bf16: the MMA fragments of O and this thread's two rows' (m, l)
  float o[OT][4];
#pragma unroll
  for (int t = 0; t < OT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
  // f32: the warp's 16 rows, DPL columns of O per lane
  float fm[16], fl[16], facc[16][DPL];
#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    fm[rr] = NEG_INF;
    fl[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) facc[rr][i] = 0.f;
  }

  for (int st = 0; st < n_st; ++st) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // stage st landed; stage st - 1 is free
    if (st + STAGES - 1 < n_st) load(st + STAGES - 1);
    cp_async_commit();
    const int buf = st % STAGES;
    int next_row = 0;  // block tables: stage st + STAGES's physical row
    if (BLOCK_TABLE && tid < BN) next_row = phys(r0 + (st + STAGES) * BN + tid);
    const float* ks = scl + buf * 2 * BN;   // int8: this stage's scales
    const float* vs = ks + BN;
    const int kbase = r0 + st * BN + kq * KEYS;

    if constexpr (S::F32) {
      // each key of the warp's group against its 16 rows, in order: one
      // shuffle reduction per (key, row), an online softmax per row
      const KV* kr = ring + buf * 2 * BN * RLD + kq * KEYS * RLD + lane * DPL;
      const KV* vr = kr + BN * RLD;
      for (int j = 0; active && j < KEYS && kbase + j < r1; ++j) {
        float kf[DPL], vf[DPL];
        load_vec<KV, DPL>(kr + j * RLD, kf);
        load_vec<KV, DPL>(vr + j * RLD, vf);
        if (QUANT) {
          const float kss = ks[kq * KEYS + j];
          const float vss = vs[kq * KEYS + j];
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            kf[i] *= kss;
            vf[i] *= vss;
          }
        }
#pragma unroll
        for (int rr = 0; rr < 16; ++rr) {
          if (kbase + j >= row_len(rb * 16 + rr)) continue;   // warp-uniform
          float qf[DPL];
          load_vec<float, DPL>(sq + (rb * 16 + rr) * LD + lane * DPL, qf);
          float part = 0.f;
#pragma unroll
          for (int i = 0; i < DPL; ++i) part = fmaf(qf[i], kf[i], part);
          const float x = warp_sum(part) * sl2;
          const float mx = fmaxf(fm[rr], x);
          const float alpha = exp2f(fm[rr] - mx);
          const float pe = exp2f(x - mx);
          fl[rr] = fl[rr] * alpha + pe;
#pragma unroll
          for (int i = 0; i < DPL; ++i) facc[rr][i] = fmaf(pe, vf[i], facc[rr][i] * alpha);
          fm[rr] = mx;
        }
      }
    } else {
      const __nv_bfloat16* kt;
      const __nv_bfloat16* vt;
      if constexpr (S::Q8) {
        // widen the stage's codes to bf16 (exact) for ldmatrix
        const int8_t* src = reinterpret_cast<const int8_t*>(ring) + buf * 2 * BN * RLD;
        constexpr int W = 2 * BN * (D / 16);   // 16-code pieces of K and V
#pragma unroll
        for (int i = 0; i < W / THREADS; ++i) {
          const int p = tid + i * THREADS;
          const int r = p / (D / 16);          // row of [K; V]
          const int col = (p % (D / 16)) * 16;
          const uint4 w = *reinterpret_cast<const uint4*>(src + r * RLD + col);
          uint4 lo, hi;
          widen4(w.x, lo.x, lo.y);
          widen4(w.y, lo.z, lo.w);
          widen4(w.z, hi.x, hi.y);
          widen4(w.w, hi.z, hi.w);
          *reinterpret_cast<uint4*>(cvt + r * LD + col) = lo;
          *reinterpret_cast<uint4*>(cvt + r * LD + col + 8) = hi;
        }
        __syncthreads();
        kt = cvt;
        vt = cvt + BN * LD;
      } else {
        kt = reinterpret_cast<const __nv_bfloat16*>(ring) + buf * 2 * BN * RLD;
        vt = kt + BN * RLD;
      }

      if (active) {
        // S = Q K^T: the warp's 16 rows x its KEYS keys
        float s[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D; kk += 16) {
          uint32_t af[4];
          ldmatrix_x4(af, sq + (rb * 16 + (lane & 15)) * LD + kk + (lane >> 4) * 8);
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t bk[4];
            ldmatrix_x4(bk, kt + (kq * KEYS + np * 16 + (lane & 7) +
                                  ((lane >> 4) << 3)) * LD +
                                kk + ((lane >> 3) & 1) * 8);
            mma_bf16(s[2 * np], af, bk[0], bk[1]);
            mma_bf16(s[2 * np + 1], af, bk[2], bk[3]);
          }
        }
        // online softmax in log2 units; a key at or past a row's length is
        // masked (and contributes p = 0 even to a row with no key yet)
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kl = n * 8 + (lane & 3) * 2 + (e & 1);
            float x = s[n][e];
            if (QUANT) x *= ks[kq * KEYS + kl];
            x = kbase + kl < lim[e >> 1] ? x * sl2 : NEG_INF;
            s[n][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        float alpha[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          alpha[h] = exp2f(m[h] - mx[h]);
          m[h] = mx[h];
        }
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kl = n * 8 + (lane & 3) * 2 + (e & 1);
            const float pe =
                kbase + kl < lim[e >> 1] ? exp2f(s[n][e] - mx[e >> 1]) : 0.f;
            rs[e >> 1] += pe;
            s[n][e] = QUANT ? pe * vs[kq * KEYS + kl] : pe;
          }
#pragma unroll
        for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
#pragma unroll
        for (int t = 0; t < OT; ++t) {
          o[t][0] *= alpha[0];
          o[t][1] *= alpha[0];
          o[t][2] *= alpha[1];
          o[t][3] *= alpha[1];
        }
        // O += P V, P from the score registers as bf16 hi + lo
#pragma unroll
        for (int kk = 0; kk < KEYS / 16; ++kk) {
          uint32_t ah[4], al[4];
          split_bf16(s[2 * kk][0], s[2 * kk][1], ah[0], al[0]);
          split_bf16(s[2 * kk][2], s[2 * kk][3], ah[1], al[1]);
          split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[2], al[2]);
          split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[3], al[3]);
          const int vrow = kq * KEYS + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
          for (int dp = 0; dp < OT / 2; ++dp) {
            uint32_t bv[4];
            ldmatrix_x4_trans(bv, vt + vrow * LD + dp * 16 + (lane >> 4) * 8);
            mma_bf16(o[2 * dp], ah, bv[0], bv[1]);
            mma_bf16(o[2 * dp], al, bv[0], bv[1]);
            mma_bf16(o[2 * dp + 1], ah, bv[2], bv[3]);
            mma_bf16(o[2 * dp + 1], al, bv[2], bv[3]);
          }
        }
      }
    }
    if (BLOCK_TABLE && tid < BN) sh.prow[buf][tid] = next_row;
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring becomes the merge buffer

  // the warps' states: (m, l) per row, O unnormalized, merged in key-group
  // order
  if (active) {
    float* mw = macc + warp * 16 * MLD;
    if constexpr (S::F32) {
      if (lane == 0) {
#pragma unroll
        for (int rr = 0; rr < 16; ++rr) {
          sh.ml[warp][rr][0] = fm[rr];
          sh.ml[warp][rr][1] = fl[rr];
        }
      }
#pragma unroll
      for (int rr = 0; rr < 16; ++rr)
#pragma unroll
        for (int i = 0; i < DPL; i += 2)
          *reinterpret_cast<float2*>(mw + rr * MLD + lane * DPL + i) =
              make_float2(facc[rr][i], facc[rr][i + 1]);
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      }
      if ((lane & 3) == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sh.ml[warp][(lane >> 2) + h * 8][0] = m[h];
          sh.ml[warp][(lane >> 2) + h * 8][1] = l[h];
        }
      }
#pragma unroll
      for (int t = 0; t < OT; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(mw + ((lane >> 2) + h * 8) * MLD + t * 8 +
                                     (lane & 3) * 2) =
              make_float2(o[t][2 * h], o[t][2 * h + 1]);
    }
  }
  __syncthreads();
  if (tid < rows) {
    const int w0 = (tid / 16) * KG;
    const int rr = tid % 16;
    float mg = NEG_INF;
#pragma unroll
    for (int k = 0; k < KG; ++k) mg = fmaxf(mg, sh.ml[w0 + k][rr][0]);
    float lg = 0.f;
#pragma unroll
    for (int k = 0; k < KG; ++k) {
      const float f = exp2f(sh.ml[w0 + k][rr][0] - mg);
      sh.fac[k][tid] = f;
      lg += sh.ml[w0 + k][rr][1] * f;
    }
    sh.row[tid][0] = mg;
    sh.row[tid][1] = 1.f / fmaxf(lg, 1e-30f);
    sh.row[tid][2] = lg;
  }
  __syncthreads();
  const bool direct = nch == 1;
  T* out = static_cast<T*>(a.out);
  // 8 consecutive columns of one row per thread and step: two float4 reads
  // per key group, one or two 16-byte stores of the output (or two float4
  // partial stores)
  constexpr int CV = D / 8;
  for (int idx = tid; idx < rows * CV; idx += THREADS) {
    const int r = idx / CV;
    const int d0 = (idx % CV) * 8;
    const float* mr = macc + ((r / 16) * KG * 16 + r % 16) * MLD + d0;
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
#pragma unroll
    for (int k = 0; k < KG; ++k) {
      const float f = sh.fac[k][r];
      const float4 x0 = *reinterpret_cast<const float4*>(mr + k * 16 * MLD);
      const float4 x1 = *reinterpret_cast<const float4*>(mr + k * 16 * MLD + 4);
      acc[0] += x0.x * f;
      acc[1] += x0.y * f;
      acc[2] += x0.z * f;
      acc[3] += x0.w * f;
      acc[4] += x1.x * f;
      acc[5] += x1.y * f;
      acc[6] += x1.z * f;
      acc[7] += x1.w * f;
    }
    const int u = u0 + r / G;
    const int g = r % G;
    if (direct) {
      const float inv = sh.row[r][1];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] *= inv;
      store_out<8>(out + ((long long)u * H + kvh * G + g) * D + d0, acc);
    } else {
      float* pa = a.part_acc +
                  (((long long)u * a.n_kv + kvh) * a.n_chunks + c) * G * D + g * D + d0;
      store_out<8>(pa, acc);
    }
  }
  if (!direct) {
    if (tid < rows) {
      const int u = u0 + tid / G;
      const int g = tid % G;
      float* ml = a.part_ml + (((long long)u * a.n_kv + kvh) * a.n_chunks + c) * 2 * G;
      ml[g] = sh.row[tid][0];
      ml[G + g] = sh.row[tid][2];
    }
    __threadfence();
    __syncthreads();
    int32_t* ticket = a.tickets + (long long)u0 * a.n_kv + kvh;
    if (tid == 0) sh.last = atomicAdd(ticket, 1) == nch - 1;
    __syncthreads();
    if (sh.last) {
      __threadfence();
      // the chunks in order: 4 consecutive columns of one row per step
      for (int idx = tid; idx < rows * (D / 4); idx += THREADS) {
        const int r = idx / (D / 4);
        const int d0 = (idx % (D / 4)) * 4;
        const int u = u0 + r / G;
        const int g = r % G;
        const long long pair = (long long)u * a.n_kv + kvh;
        const float* ml = a.part_ml + pair * a.n_chunks * 2 * G + g;
        const float* pa = a.part_acc + pair * a.n_chunks * G * D + g * D + d0;
        float mg = NEG_INF;
        for (int cc = 0; cc < nch; ++cc) mg = fmaxf(mg, __ldcg(ml + cc * 2 * G));
        float lg = 0.f;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int cc = 0; cc < nch; ++cc) {
          const float e = exp2f(__ldcg(ml + cc * 2 * G) - mg);
          lg += __ldcg(ml + cc * 2 * G + G) * e;
          const float4 x =
              __ldcg(reinterpret_cast<const float4*>(pa + (long long)cc * G * D));
          acc[0] += x.x * e;
          acc[1] += x.y * e;
          acc[2] += x.z * e;
          acc[3] += x.w * e;
        }
        const float inv = 1.f / fmaxf(lg, 1e-30f);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] *= inv;
        store_out<4>(out + ((long long)u * H + kvh * G + g) * D + d0, acc);
      }
      if (tid == 0) *ticket = 0;   // ready for the next launch
    }
  }
  __syncthreads();   // the next tile reuses shared memory
}

// T: q/out element (float or bf16); KV: cache element (T, or int8 codes);
// G: query heads per KV head; D: head dim.  A persistent grid: every CTA
// walks the stream in windows of WINDOW tokens, finds the window's tiles
// (runs of one slot inside each group of tq tokens) and numbers their items
// (chunk, KV head) in stream order, and runs the items whose number is its
// own modulo the grid.
template <typename T, typename KV, int G, int D>
__global__ void __launch_bounds__(THREADS)
packed_attention_tile_kernel(const Args a) {
  using S = Shape<T, KV, D>;
  constexpr int KG1 = S::KG_MAX < 4 ? S::KG_MAX : 4;   // tiles of <= 16 rows
  constexpr int KG2 = S::KG_MAX < 2 ? S::KG_MAX : 2;   // <= 32 rows
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Shared sh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int carry = 0;   // items of the windows before this one
  const int tq_mask = a.tq - 1;              // tq and chunk: powers of two
  const int chunk_log2 = __ffs(a.chunk) - 1;
  for (int w0 = 0; w0 < a.n_tokens; w0 += WINDOW) {
    const int nw = min(WINDOW, a.n_tokens - w0);
    for (int x = tid; x < nw; x += THREADS) {
      const int sl = a.token_slot[w0 + x];
      const int ln = a.lengths[w0 + x];
      sh.slot[x] = sl;
      sh.len[x] = sl >= 0 && sl < a.n_slots ? min(max(ln, 0), a.sweep) : 0;
    }
    __syncthreads();
    // a tile starts at a multiple of tq or where the slot changes, and ends
    // at the next.  Thread tid looks at tokens 2 tid and 2 tid + 1.
    bool small[2];
    int n_tok[2], tl[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int x = 2 * tid + k;
      n_tok[k] = 0;
      if (x < nw && ((x & tq_mask) == 0 || sh.slot[x] != sh.slot[x - 1])) {
        int b = x + 1;
        int L = sh.len[x];
        while (b < nw && (b & tq_mask) != 0 && sh.slot[b] == sh.slot[x])
          L = max(L, sh.len[b++]);
        n_tok[k] = b - x;
        tl[k] = L;
        sh.n_tok[x] = b - x;
        sh.tile_len[x] = L;
      }
      small[k] = n_tok[k] > 0 && n_tok[k] * G <= 16;
    }
    // A tile of <= 16 rows (a decode token) splits its rows up to its
    // largest length into chunks, a larger one has work enough for a CTA
    // and reads them in one item.  The window's chunk is the smallest
    // a.chunk << e whose items fill no more than the grid (the largest
    // when none does), so few decode tokens split finely and many do not.
    // Every tile has chunk 0, which writes zeros for a tile with nothing to
    // read.
    int need[CHUNK_STEPS];
#pragma unroll
    for (int e = 0; e < CHUNK_STEPS; ++e) {
      need[e] = 0;
#pragma unroll
      for (int k = 0; k < 2; ++k)
        if (n_tok[k] > 0)
          need[e] += small[k] ? max(1, (tl[k] + (a.chunk << e) - 1) >> (chunk_log2 + e)) : 1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        need[e] += __shfl_xor_sync(0xffffffffu, need[e], off);
      if (lane == 0) sh.need[warp][e] = need[e];
    }
    __syncthreads();
    int shift = chunk_log2 + CHUNK_STEPS - 1;
#pragma unroll
    for (int e = CHUNK_STEPS - 1; e >= 0; --e) {
      int tiles = 0;
#pragma unroll
      for (int w = 0; w < THREADS / 32; ++w) tiles += sh.need[w][e];
      if ((long long)tiles * a.n_kv <= gridDim.x) shift = chunk_log2 + e;
    }
    const int chunk = 1 << shift;
    int items[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int x = 2 * tid + k;
      items[k] = 0;
      if (n_tok[k] > 0) {
        const int nch = small[k] ? max(1, (tl[k] + chunk - 1) >> shift) : 1;
        items[k] = nch * a.n_kv;
        sh.nch[x] = nch;
      }
      sh.items[x] = items[k];
    }
    int incl = items[0] + items[1];   // inclusive scan over the window
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) sh.warp_items[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
      before += w < warp ? sh.warp_items[w] : 0;
      total += sh.warp_items[w];
    }
    sh.base[2 * tid] = before + incl - items[0] - items[1];
    sh.base[2 * tid + 1] = before + incl - items[1];
    __syncthreads();
    // this CTA's items of the window: numbers j (from the window's first)
    // with carry + j equal to blockIdx.x modulo the grid; the tile that
    // holds j is the start whose range of numbers covers it
    int j = static_cast<int>(blockIdx.x) - carry % static_cast<int>(gridDim.x);
    if (j < 0) j += gridDim.x;
    for (; j < total; j += gridDim.x) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int x = 2 * tid + k;
        if (sh.items[x] > 0 && sh.base[x] <= j && j < sh.base[x] + sh.items[x])
          sh.hit = x;
      }
      __syncthreads();
      const int ta = sh.hit;
      const int i = j - sh.base[ta];
      const int c = i / a.n_kv;
      const int kvh = i % a.n_kv;
      const int n_tok = sh.n_tok[ta];
      const int rows = n_tok * G;
      const int slot = sh.slot[ta];
      const int L = sh.tile_len[ta];
      const int nch = sh.nch[ta];
      const int r0 = nch > 1 ? c * chunk : 0;
      const int r1 = nch > 1 ? min(L, r0 + chunk) : L;
      if (rows <= 16)
        tile<T, KV, G, D, KG1>(a, smem, sh, kvh, c, nch, ta, w0 + ta, n_tok, slot, r0, r1);
      else if (rows <= 32)
        tile<T, KV, G, D, KG2>(a, smem, sh, kvh, c, nch, ta, w0 + ta, n_tok, slot, r0, r1);
      else
        tile<T, KV, G, D, 1>(a, smem, sh, kvh, c, nch, ta, w0 + ta, n_tok, slot, r0, r1);
    }
    carry += total;
    __syncthreads();   // the next window rewrites the arrays
  }
}

// The grid is as many CTAs as the card holds at once (SMs x CTAs per SM),
// found with the shared-memory attribute at an instantiation's first
// launch on each device and kept: a launch then makes no other runtime
// call than cudaGetDevice.
template <typename T, typename KV, int G, int D>
int launch_tiles(const Args& a, cudaStream_t stream) {
  constexpr int SMEM = Shape<T, KV, D>::BYTES;
  constexpr int MAX_DEVICES = 64;
  static int grid[MAX_DEVICES] = {};   // per device; 0 until found
  auto kernel = packed_attention_tile_kernel<T, KV, G, D>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= MAX_DEVICES) return -1;
  if (grid[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          THREADS, SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    grid[dev] = sms * max(per_sm, 1);
  }
  kernel<<<grid[dev], THREADS, SMEM, stream>>>(a);
  return 0;
}

template <typename T>
int dispatch(int group, int head_dim, const Args& a, cudaStream_t s) {
  using KV = typename std::conditional<QUANT, int8_t, T>::type;
#define REPRO_PT_CASE(G, D) \
  if (group == G && head_dim == D) return launch_tiles<T, KV, G, D>(a, s);
#define REPRO_PT_CASES(G) REPRO_PT_CASE(G, 64) REPRO_PT_CASE(G, 128) REPRO_PT_CASE(G, 256)
  REPRO_PT_CASES(1)
  REPRO_PT_CASES(2)
  REPRO_PT_CASES(4)
  REPRO_PT_CASES(8)
  // groups 3, 7 and 9 at head dim 128 only (csrc/decode_attention.cu)
  REPRO_PT_CASE(3, 128)
  REPRO_PT_CASE(7, 128)
  REPRO_PT_CASE(9, 128)
#undef REPRO_PT_CASES
#undef REPRO_PT_CASE
  return -1;
}

}  // namespace pa_tile
}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q and out).  kv_int8 must equal this
// build's REPRO_PA_QUANT and block_tables must be non-null exactly when it
// is built with REPRO_PA_BLOCK_TABLE.  q (T, H, D) and out (T, H, D) are
// contiguous; token_slot and lengths (T,) int32; k/v are (N, S, KV, D) with
// unit stride over (KV, D) and the given element strides over N and S;
// scales are (N, S, KV) f32 with unit stride over KV; block_tables is (N,
// nb_cols) int32, contiguous.  Groups of `tq` tokens (a power of two, tq *
// group <= 64), chunks of at least `chunk` key rows (a power of two >= 64)
// with n_chunks * chunk >= sweep; when n_chunks > 1, part_ml holds T * KV *
// n_chunks * 2 * G floats, part_acc T * KV * n_chunks * G * D, and tickets
// T * KV int32 zeros, left zero by the launch.  Returns 0 at once for T =
// 0, -1 for a shape this build does not instantiate, -2 for a variant it
// was not built as, else cudaGetLastError() after the launch.
extern "C" int repro_packed_attention(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* token_slot, const void* lengths,
    const void* block_tables, void* out, void* part_ml, void* part_acc,
    void* tickets, int dtype, int kv_int8, int n_tokens, int n_heads,
    int n_kv, int head_dim, int n_slots, int sweep, int nb_cols,
    int block_size, int tq, int chunk, int n_chunks, long long k_stride_n,
    long long k_stride_s, long long v_stride_n, long long v_stride_s,
    long long s_stride_n, long long s_stride_s, float scale, void* stream) {
  if (n_tokens == 0) return 0;   // an empty stream's pointers may be null
  if ((kv_int8 != 0) != pa_tile::QUANT ||
      (block_tables != nullptr) != pa_tile::BLOCK_TABLE)
    return -2;
  if (n_kv <= 0 || n_heads % n_kv || token_slot == nullptr) return -1;
  const int group = n_heads / n_kv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = -1;
  if (tq < 1 || (tq & (tq - 1)) || tq * group > pa_tile::BM ||
      chunk < pa_tile::CHUNK_MULTIPLE || (chunk & (chunk - 1)) || n_chunks < 1 ||
      (long long)n_chunks * chunk < sweep ||
      (n_chunks > 1 && (!part_ml || !part_acc || !tickets)))
    return -1;
  pa_tile::Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.token_slot = static_cast<const int32_t*>(token_slot);
  a.lengths = static_cast<const int32_t*>(lengths);
  a.block_tables = static_cast<const int32_t*>(block_tables);
  a.out = out;
  a.part_ml = static_cast<float*>(part_ml);
  a.part_acc = static_cast<float*>(part_acc);
  a.tickets = static_cast<int32_t*>(tickets);
  a.n_tokens = n_tokens;
  a.n_kv = n_kv;
  a.n_slots = n_slots;
  a.sweep = sweep;
  a.nb_cols = nb_cols;
  a.block_size = block_size;
  a.tq = tq;
  a.chunk = chunk;
  a.n_chunks = n_chunks;
  a.k_sn = k_stride_n;
  a.k_ss = k_stride_s;
  a.v_sn = v_stride_n;
  a.v_ss = v_stride_s;
  a.s_sn = s_stride_n;
  a.s_ss = s_stride_s;
  a.scale = scale;
  if (dtype == 0)
    rc = pa_tile::dispatch<float>(group, head_dim, a, s);
  else if (dtype == 1)
    rc = pa_tile::dispatch<__nv_bfloat16>(group, head_dim, a, s);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
