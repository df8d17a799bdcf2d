// Segment-masked attention over the token-packed serving stream, for Hopper
// (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces the TPU kernel src/repro/kernels/packed_attention.py
// `packed_attention` (`_flash_step` and its four bodies): token t attends
// rows [0, min(lengths[t], kv_bucket)) of its own slot `token_slot[t]`, with
// an online softmax; query head h reads KV head h // group.  Same constants
// as the TPU kernel: q is scaled by `scale` (the wrapper passes
// d ** -0.5), masked scores are NEG_INF = -1e30, and the softmax denominator
// is clamped to 1e-30.
//
// One source, three compile-time switches (-D flags; kernels/build.py
// builds each of the five variants into its own library, in parallel):
//   REPRO_PA_BLOCK_TABLE (`_kernel_block`): the caches are physical block
//     storage, and logical row r of the token's slot lives at flat row
//     bt[slot * nb_cols + r / bs] * bs + r % bs of the N·S row space
//     (DESIGN.md §12).  The loop stops at the token's length, so table
//     entries past it are never read.
//   REPRO_PA_QUANT (`_kernel_quant`): K and V rows are int8 with one f32
//     scale per (row, KV head), read in place from the (N, S, KV) scale
//     leaves; each row dequantizes in registers as float(x) * scale, the
//     TPU kernel's `k * ks` (DESIGN.md §15), before the same f32 math.
// Both together are `_kernel_block_quant`.
//   REPRO_PA_DECODE: token b is the one query of row b and its length is
//     `cache_len[b]`, so no token_slot array is read.  It is built only
//     with REPRO_PA_BLOCK_TABLE (below).  Decode attention over slot caches
//     (the TPU kernel src/repro/kernels/decode_attention.py
//     `decode_attention`) lives in csrc/decode_attention.cu, on the
//     split-KV unit of csrc/attn_decode.cuh.
//   REPRO_PA_DECODE with REPRO_PA_BLOCK_TABLE (replaces the TPU kernel
//     src/repro/kernels/decode_attention.py `paged_decode_attention`): decode
//     through a page table.  Token b reads its logical row r from row r % PS
//     of page max(page_table[b, r / PS], 0) of the (NP, PS, KV, D) pools, in
//     place (block_size = PS, nb_cols = MAXP; the TPU wrapper's (KV, NP, PS,
//     D) transpose is not made).  A -1 entry inside the length reads page 0,
//     as the TPU kernel (which prefetches max(table, 0)) and its reference
//     do; pages past the length are never read.  The clamp exists only in
//     this build, so the other builds compile as before.
//
// What bounds it on the card: bytes.  A decode token reads its slot's K and V
// rows once (2 * len * head_dim bytes per KV head in int8, twice that in
// bf16, plus 8 bytes of scales per int8 row) and does ~4 flops per byte
// read, far below the ~295 flops/byte at which an H100 turns compute-bound.
//
// What the design does about it:
//   * The cache is read in its stored (N, S, KV, D) layout through strides;
//     no transposed copy of the cache or of the scales is made (the TPU
//     wrapper's (N, KV, S, D) and (N, KV, S) transposes would cost one pass
//     over the cache per layer per step, and the TPU decode wrapper also
//     pads the cache to a whole number of blocks on every call).
//   * One block per (token, KV head): the `group` query heads that share a KV
//     head are all scored against each K row while it is in registers, so a
//     row is read once per block, not once per query head.
//   * Each warp owns a strided share of the rows and keeps its own online
//     softmax state (m, l, acc) in f32 registers; each lane holds head_dim/32
//     contiguous elements, loaded with one vector load per row (4 bytes of
//     int8 at head_dim 128), and each warp keeps ROWS K and V rows in flight.
//     The warps' states are merged once at the end through shared memory, in
//     a fixed order (deterministic).
//   * Rows past the token's length are never loaded: the ragged tail is
//     masked by the loop bound itself.
// Left for a later change (ROADMAP B1): one q tile per prefill segment so a
// chunk does not re-read its slot once per token, and the split-KV unit of
// csrc/attn_decode.cuh for the decode tokens and the paged build.
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
#ifndef REPRO_PA_DECODE
#define REPRO_PA_DECODE 0
#endif

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NUM_WARPS = 8;
constexpr bool QUANT = REPRO_PA_QUANT != 0;
constexpr bool BLOCK_TABLE = REPRO_PA_BLOCK_TABLE != 0;
constexpr bool DECODE = REPRO_PA_DECODE != 0;
static_assert(!DECODE || !QUANT, "the decode builds read native caches");

// Everything a launch needs besides its compile-time shape; strides are in
// elements.  k_scale/v_scale share strides (s_sn, s_ss) and have unit stride
// over KV heads.
struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int32_t* token_slot;
  const int32_t* lengths;
  const int32_t* block_tables;
  void* out;
  int n_kv, n_slots, sweep, nb_cols, block_size;
  long long k_sn, k_ss, v_sn, v_ss, s_sn, s_ss;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// T: q/out type; KV: cache type (T, or int8_t when QUANT); G: query heads per
// KV head; DPL: head_dim / 32 (elements per lane).
template <typename T, typename KV, int G, int DPL>
__global__ void __launch_bounds__(NUM_WARPS * 32)
packed_attention_kernel(const Params p) {
  constexpr int D = DPL * 32;
  constexpr int ROWS = DPL <= 4 ? 8 : 4;   // K/V rows in flight per warp
  const int kvh = blockIdx.x;
  const int t = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_heads = p.n_kv * G;
  const T* __restrict__ q = static_cast<const T*>(p.q);
  T* __restrict__ out = static_cast<T*>(p.out);

  const int slot = DECODE ? t : p.token_slot[t];
  int len = min(p.lengths[t], p.sweep);
  if (slot < 0 || slot >= p.n_slots || len < 0) len = 0;

  float qf[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_vec<T, DPL>(q + ((long long)t * n_heads + kvh * G + g) * D + lane * DPL,
                     qf[g]);
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

  // Row r is at `base + row(r) * row_stride`: row(r) = r within the slot's
  // rows in contiguous mode, the physical flat row in block-table mode.
  const long long slot_k = BLOCK_TABLE ? 0 : (long long)slot * p.k_sn;
  const long long slot_v = BLOCK_TABLE ? 0 : (long long)slot * p.v_sn;
  const long long slot_s = BLOCK_TABLE ? 0 : (long long)slot * p.s_sn;
  const KV* __restrict__ kb =
      static_cast<const KV*>(p.k) + slot_k + kvh * D + lane * DPL;
  const KV* __restrict__ vb =
      static_cast<const KV*>(p.v) + slot_v + kvh * D + lane * DPL;
  const float* __restrict__ ksb = QUANT ? p.k_scale + slot_s + kvh : nullptr;
  const float* __restrict__ vsb = QUANT ? p.v_scale + slot_s + kvh : nullptr;
  const int32_t* __restrict__ bt =
      BLOCK_TABLE ? p.block_tables + (long long)slot * p.nb_cols : nullptr;

  for (int base = warp * ROWS; base < len; base += NUM_WARPS * ROWS) {
    float kf[ROWS][DPL], vf[ROWS][DPL];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      const int r = base + u;
      if (r < len) {
        long long row = r;
        if (BLOCK_TABLE) {
          int page = bt[r / p.block_size];
          if (DECODE) page = max(page, 0);   // paged decode: -1 reads page 0
          row = (long long)page * p.block_size + r % p.block_size;
        }
        load_vec<KV, DPL>(kb + row * p.k_ss, kf[u]);
        load_vec<KV, DPL>(vb + row * p.v_ss, vf[u]);
        if (QUANT) {
          const float ks = ksb[row * p.s_ss];
          const float vs = vsb[row * p.s_ss];
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            kf[u][i] *= ks;
            vf[u][i] *= vs;
          }
        }
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

  // merge the warps' partial softmax states
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
    out[((long long)t * n_heads + kvh * G + g) * D + d] =
        from_f32<T>(sm_acc[g][d] / fmaxf(lg, 1e-30f));
  }
}

template <typename T>
int launch(int group, int head_dim, int n_tokens, const Params& p,
           cudaStream_t stream) {
  using KV = typename std::conditional<QUANT, int8_t, T>::type;
  const dim3 grid(p.n_kv, n_tokens);
#define REPRO_PA_CASE(G, DPL)                                                 \
  if (group == G && head_dim == DPL * 32) {                                   \
    packed_attention_kernel<T, KV, G, DPL><<<grid, NUM_WARPS * 32, 0, stream>>>(p); \
    return 0;                                                                 \
  }
#define REPRO_PA_CASES(G) REPRO_PA_CASE(G, 2) REPRO_PA_CASE(G, 4) REPRO_PA_CASE(G, 8)
  REPRO_PA_CASES(1)
  REPRO_PA_CASES(2)
  REPRO_PA_CASES(4)
  REPRO_PA_CASES(8)
#undef REPRO_PA_CASES
#undef REPRO_PA_CASE
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q and out).  kv_int8 must equal this
// build's REPRO_PA_QUANT, block_tables must be non-null exactly when it is
// built with REPRO_PA_BLOCK_TABLE, and token_slot must be null exactly when
// it is built with REPRO_PA_DECODE (token t is then slot t; with block
// tables, the paged build, row t of the (T, nb_cols) page table is token
// t's, and entries may be -1).  q (T, H, D)
// and out (T, H, D) are contiguous; k/v are (N, S, KV, D) with unit stride
// over (KV, D) and the given element strides over N and S; scales are
// (N, S, KV) f32 with unit stride over KV; block_tables is (N, nb_cols)
// int32, contiguous.  Returns -1 for a shape this build does not
// instantiate, -2 for a variant it was not built as, else
// cudaGetLastError() after the launch.
extern "C" int repro_packed_attention(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* token_slot, const void* lengths,
    const void* block_tables, void* out, int dtype, int kv_int8, int n_tokens,
    int n_heads, int n_kv, int head_dim, int n_slots, int sweep, int nb_cols,
    int block_size, long long k_stride_n, long long k_stride_s,
    long long v_stride_n, long long v_stride_s, long long s_stride_n,
    long long s_stride_s, float scale, void* stream) {
  if ((kv_int8 != 0) != QUANT || (block_tables != nullptr) != BLOCK_TABLE ||
      (token_slot == nullptr) != DECODE)
    return -2;
  if (n_tokens == 0) return 0;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.token_slot = static_cast<const int32_t*>(token_slot);
  p.lengths = static_cast<const int32_t*>(lengths);
  p.block_tables = static_cast<const int32_t*>(block_tables);
  p.out = out;
  p.n_kv = n_kv;
  p.n_slots = n_slots;
  p.sweep = sweep;
  p.nb_cols = nb_cols;
  p.block_size = block_size;
  p.k_sn = k_stride_n;
  p.k_ss = k_stride_s;
  p.v_sn = v_stride_n;
  p.v_ss = v_stride_s;
  p.s_sn = s_stride_n;
  p.s_ss = s_stride_s;
  p.scale = scale;
  const int group = n_heads / n_kv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0)
    rc = launch<float>(group, head_dim, n_tokens, p, s);
  else if (dtype == 1)
    rc = launch<__nv_bfloat16>(group, head_dim, n_tokens, p, s);
  else
    rc = -1;
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
