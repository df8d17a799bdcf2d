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
// (~295 flops/byte in bf16), so both the tensor-core rate and the bytes
// matter; the bound is a few microseconds either way.
//
// What the design does about it:
//   * bf16: one block of 4 warps per (64-row query tile, KV head, batch row).
//     The tile's 64 rows are 64 / group positions times the group's query
//     heads (row r = position r / group, head r % group), so each K/V tile
//     is loaded once for all the query heads that share it.  Q stays in
//     shared memory; K/V tiles of BN rows stream through a 2-stage cp.async
//     ring; S = Q K^T and O += P V run on mma.sync m16n8k16 (bf16 in, f32
//     accumulate) from ldmatrix loads of padded (bank-conflict-free) rows,
//     with P kept in registers between the two products, split into bf16
//     hi + lo parts so that P V sees P at near-f32 precision (half again
//     the tensor work, against an error of up to 2^-9 |V| on rows with few
//     keys).  Each warp keeps an f32 online softmax for its 16 rows.
//   * Causal skipping: a block stops at key q_offset[b] + its last position
//     + 1, so a prefill chunk never reads the slot-cache rows beyond its own
//     end, and rows past that limit are zero-filled in shared memory (a
//     stale row can then never reach the output, even as NaN * 0).
//   * K/V are read in their stored (B, S, KV, D) layout through strides (the
//     slot's view of the serving cache); ragged Sq and Skv are masked in the
//     kernel.  Nothing is padded or transposed in device memory (the TPU
//     wrapper pads both and transposes to head-major).
//   * f32 (kept for exact checks): one block of 8 warps per (query
//     position, KV head, batch row), each warp owning a strided share of the
//     keys with its own online softmax state for the group's heads, merged
//     once at the end in a fixed order, as in csrc/packed_attention.cu.
// Left for a later change: wgmma/TMA, warp specialisation and a persistent
// schedule; d_v != d_qk (absorbed MLA, ROADMAP A5).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
};

__device__ __forceinline__ int row_offset(const Params& p, int b) {
  return p.q_offset ? p.q_offset[b] : p.q_offset_scalar;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor-core kernel
// ---------------------------------------------------------------------------
constexpr int BM = 64;          // query rows (position x head) per block
constexpr int MMA_THREADS = 128;

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

template <int D, int BN>
constexpr int smem_bytes() {
  return (BM + 4 * BN) * (D + 8) * 2;   // Q tile + 2 stages of K and V
}

// G: query heads per KV head; D: head dim; BN: keys per K/V tile.
template <int G, int D, int BN>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bf16_kernel(const Params p) {
  constexpr int PT = BM / G;   // positions per tile
  constexpr int LD = D + 8;    // padded row pitch (elements)
  constexpr int NT = BN / 8;   // score n-tiles of a warp
  constexpr int OT = D / 8;    // output n-tiles of a warp
  constexpr int CH = D / 8;    // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk = sq + BM * LD;        // [2][BN][LD]
  __nv_bfloat16* sv = sk + 2 * BN * LD;    // [2][BN][LD]

  const int pos0 = blockIdx.x * PT;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int off = row_offset(p, b);
  const int last_pos = min(pos0 + PT, p.sq) - 1;
  // keys this block needs: [0, kend); rows past it are never read
  const int kend = max(0, min(p.skv, off + last_pos + 1));
  const int n_kt = (kend + BN - 1) / BN;
  const int min_lim = min(p.skv, off + pos0 + 1);   // first row's limit

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
  const __nv_bfloat16* kb =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * D;
  const __nv_bfloat16* vb =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * D;

  for (int c = tid; c < BM * CH; c += MMA_THREADS) {
    const int r = c / CH;
    const int col = (c % CH) * 8;
    const int pos = pos0 + r / G;
    const bool ok = pos < p.sq;
    const __nv_bfloat16* src =
        ok ? q + (((long long)b * p.sq + pos) * p.n_heads + kvh * G + r % G) * D + col
           : q;
    cp_async16(sq + r * LD + col, src, ok);
  }
  auto load_kv = [&](int stage, int kt) {
    for (int c = tid; c < BN * CH; c += MMA_THREADS) {
      const int r = c / CH;
      const int col = (c % CH) * 8;
      const int key = kt * BN + r;
      const bool ok = key < kend;
      cp_async16(sk + (stage * BN + r) * LD + col,
                 ok ? kb + key * p.k_ss + col : kb, ok);
      cp_async16(sv + (stage * BN + r) * LD + col,
                 ok ? vb + key * p.v_ss + col : vb, ok);
    }
  };
  if (n_kt > 0) load_kv(0, 0);
  cp_async_commit();

  // this thread's two rows: r0 and r0 + 8 of the tile
  const int r0 = warp * 16 + (lane >> 2);
  int lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    lim[h] = min(p.skv, off + pos0 + (r0 + h * 8) / G + 1);
  const float sl2 = p.scale * LOG2E;

  float o[OT][4];
#pragma unroll
  for (int t = 0; t < OT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) load_kv((kt + 1) & 1, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* skt = sk + (kt & 1) * BN * LD;
    const __nv_bfloat16* svt = sv + (kt & 1) * BN * LD;

    // S = Q K^T for the warp's 16 rows x BN keys
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, sq + (warp * 16 + (lane & 15)) * LD + kk + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, skt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD
                            + kk + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], a, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // online softmax in log2 units; keys at or past a row's limit masked
    const bool masked = (kt + 1) * BN > min_lim;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float x = s[n][e] * sl2;
        if (masked && kt * BN + n * 8 + (lane & 3) * 2 + (e & 1) >= lim[h])
          x = NEG_INF;
        s[n][e] = x;
        mx[h] = fmaxf(mx[h], x);
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
        const float pe = exp2f(s[n][e] - mx[e >> 1]);
        s[n][e] = pe;
        rs[e >> 1] += pe;
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

    // O += P V, P taken from the score registers as hi + lo bf16 A
    // fragments (two products per V fragment)
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t ah[4], al[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ah[0], al[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ah[1], al[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[2], al[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[3], al[3]);
      const int vrow = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dp = 0; dp < OT / 2; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, svt + vrow * LD + dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], ah, bv[0], bv[1]);
        mma_bf16(o[2 * dp], al, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], ah, bv[2], bv[3]);
        mma_bf16(o[2 * dp + 1], al, bv[2], bv[3]);
      }
    }
    __syncthreads();   // the next iteration refills this stage
  }
  cp_async_wait<0>();

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lh = l[h];
    lh += __shfl_xor_sync(0xffffffffu, lh, 1);
    lh += __shfl_xor_sync(0xffffffffu, lh, 2);
    const float inv = 1.f / fmaxf(lh, 1e-30f);
    const int r = r0 + h * 8;
    const int pos = pos0 + r / G;
    if (pos >= p.sq) continue;
    __nv_bfloat16* dst =
        out + (((long long)b * p.sq + pos) * p.n_heads + kvh * G + r % G) * D;
#pragma unroll
    for (int t = 0; t < OT; ++t)
      *reinterpret_cast<__nv_bfloat162*>(dst + t * 8 + (lane & 3) * 2) =
          __floats2bfloat162_rn(o[t][2 * h] * inv, o[t][2 * h + 1] * inv);
  }
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

template <int G, int D>
int launch_bf16(int batch, const Params& p, cudaStream_t stream) {
  constexpr int BN = D <= 128 ? 64 : 32;
  constexpr int bytes = smem_bytes<D, BN>();
  auto kernel = flash_bf16_kernel<G, D, BN>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.sq + BM / G - 1) / (BM / G), p.n_kv, batch);
  kernel<<<grid, MMA_THREADS, bytes, stream>>>(p);
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
#undef REPRO_FA_CASES
#undef REPRO_FA_CASE
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out).  q (B, Sq, H, D) and
// out (B, Sq, H, D) are contiguous; k and v are (B, Skv, KV, D) with unit
// stride over (KV, D) and the given element strides over B and rows.
// q_offset is a (B,) int32 device array, or null for q_offset_scalar on
// every row.  Returns -1 for a shape this build does not instantiate, else
// the launch's CUDA error code.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, const void* q_offset,
    void* out, int dtype, int batch, int sq, int skv, int n_heads, int n_kv,
    int head_dim, int q_offset_scalar, long long k_stride_b,
    long long k_stride_s, long long v_stride_b, long long v_stride_s,
    float scale, void* stream) {
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
  const int rc = launch(dtype, n_heads / n_kv, head_dim, batch, p,
                        static_cast<cudaStream_t>(stream));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
