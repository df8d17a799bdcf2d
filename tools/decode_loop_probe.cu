// Where the time of the register-resident decode-attention row loop goes:
// a copy of the loop that csrc/packed_attention.cu (decode build) and
// csrc/fused_overlap.cu (`attn_unit`) ran before csrc/attn_decode.cuh
// replaced it, in three modes (template MODE):
//   0  loads only: each warp loads its K/V rows into registers as the loop
//      did, and sums them into one value per thread so the loads stay;
//   1  loads + scoring: adds the per-(row, head) dot products and their
//      5-step shuffle reductions, summed likewise;
//   2  the full loop: online softmax, P V, the warps' merge and, over
//      several chunks, the last-ticket merge of the partials.
// Two launch shapes: one CTA per (row, KV head) over the whole row (the
// decode build, __launch_bounds__(256)), and a persistent grid walking
// (row, KV head, chunk) units (the fused op's attention role,
// __launch_bounds__(256, 2)).  bf16 at group 4, head_dim 128 only.
// Built and driven by tools/decode_loop_probe.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;
constexpr int NUM_WARPS = THREADS / 32;
constexpr int G = 4;
constexpr int DPL = 4;
constexpr int D = DPL * 32;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int32_t* cache_len;
  __nv_bfloat16* out;
  float* sink;        // one float per thread of the grid (modes 0 and 1)
  float* part_ml;
  float* part_acc;
  int32_t* tickets;
  int B, n_kv, S, chunk, n_chunks, n_units;
  long long k_sb, k_ss, v_sb, v_ss;
  float scale;
};

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&o)[DPL]) {
  struct alignas(8) V4 { __nv_bfloat16 v[4]; };
  const V4 x = *reinterpret_cast<const V4*>(p);
#pragma unroll
  for (int i = 0; i < DPL; ++i) o[i] = __bfloat162float(x.v[i]);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int MODE>
__device__ void attn_unit(const Params& p, int unit) {
  constexpr int ROWS = 8;
  __shared__ float sm_m[NUM_WARPS][G];
  __shared__ float sm_l[NUM_WARPS][G];
  __shared__ float sm_acc[G][D];
  __shared__ int sm_last;
  const int pairs = p.B * p.n_kv;
  const int chunk = unit / pairs;
  const int pair = unit % pairs;
  const int b = pair / p.n_kv;
  const int kvh = pair % p.n_kv;
  const int len = min(max(p.cache_len[b], 0), p.S);
  const int n_chunks = max(1, (len + p.chunk - 1) / p.chunk);
  if (chunk >= n_chunks) return;
  const int r0 = chunk * p.chunk;
  const int r1 = min(len, r0 + p.chunk);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_heads = p.n_kv * G;

  float qf[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_vec(p.q + ((long long)b * n_heads + kvh * G + g) * D + lane * DPL, qf[g]);
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
  float sink = 0.f;
  const __nv_bfloat16* kb = p.k + (long long)b * p.k_sb + kvh * D + lane * DPL;
  const __nv_bfloat16* vb = p.v + (long long)b * p.v_sb + kvh * D + lane * DPL;
  for (int base = r0 + warp * ROWS; base < r1; base += NUM_WARPS * ROWS) {
    float kf[ROWS][DPL], vf[ROWS][DPL];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      const int r = base + u;
      if (r < r1) {
        load_vec(kb + (long long)r * p.k_ss, kf[u]);
        load_vec(vb + (long long)r * p.v_ss, vf[u]);
      } else {
#pragma unroll
        for (int i = 0; i < DPL; ++i) kf[u][i] = vf[u][i] = 0.f;
      }
    }
    if (MODE == 0) {
#pragma unroll
      for (int u = 0; u < ROWS; ++u)
#pragma unroll
        for (int i = 0; i < DPL; ++i) sink += kf[u][i] + vf[u][i];
      continue;
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
        s[u] = (base + u < r1) ? warp_sum(part) : NEG_INF;
        mx = fmaxf(mx, s[u]);
      }
      if (MODE == 1) {
#pragma unroll
        for (int u = 0; u < ROWS; ++u) sink += s[u];
        sink += vf[g % ROWS][0];
        continue;
      }
      const float alpha = expf(m[g] - mx);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        s[u] = (base + u < r1) ? expf(s[u] - mx) : 0.f;
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
  if (MODE < 2) {
    p.sink[(long long)blockIdx.x * blockDim.x + threadIdx.x] += sink;
    return;
  }

  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
  }
  for (int idx = threadIdx.x; idx < G * D; idx += THREADS) sm_acc[idx / D][idx % D] = 0.f;
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
  float* ml = p.part_ml + ((long long)pair * p.n_chunks) * 2 * G;
  float* pacc = p.part_acc + ((long long)pair * p.n_chunks) * G * D;
  for (int idx = threadIdx.x; idx < G * D; idx += THREADS) {
    const int g = idx / D;
    float mg = NEG_INF;
    for (int w = 0; w < NUM_WARPS; ++w) mg = fmaxf(mg, sm_m[w][g]);
    float lg = 0.f;
    for (int w = 0; w < NUM_WARPS; ++w) lg += sm_l[w][g] * expf(sm_m[w][g] - mg);
    if (n_chunks == 1) {
      p.out[((long long)b * n_heads + kvh * G) * D + idx] =
          __float2bfloat16(sm_acc[g][idx % D] / fmaxf(lg, 1e-30f));
    } else {
      pacc[(long long)chunk * G * D + idx] = sm_acc[g][idx % D];
      if (idx % D == 0) {
        ml[(chunk * 2) * G + g] = mg;
        ml[(chunk * 2 + 1) * G + g] = lg;
      }
    }
  }
  if (n_chunks > 1) {
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) sm_last = atomicAdd(p.tickets + pair, 1) == n_chunks - 1;
    __syncthreads();
    if (sm_last) {
      __threadfence();
      for (int idx = threadIdx.x; idx < G * D; idx += THREADS) {
        const int g = idx / D;
        float mg = NEG_INF;
        for (int c = 0; c < n_chunks; ++c) mg = fmaxf(mg, __ldcg(ml + (c * 2) * G + g));
        float lg = 0.f, a = 0.f;
        for (int c = 0; c < n_chunks; ++c) {
          const float e = expf(__ldcg(ml + (c * 2) * G + g) - mg);
          lg += __ldcg(ml + (c * 2 + 1) * G + g) * e;
          a += __ldcg(pacc + (long long)c * G * D + idx) * e;
        }
        p.out[((long long)b * n_heads + kvh * G) * D + idx] =
            __float2bfloat16(a / fmaxf(lg, 1e-30f));
      }
      if (threadIdx.x == 0) p.tickets[pair] = 0;
    }
  }
  __syncthreads();
}

template <int MODE>
__global__ void __launch_bounds__(THREADS) per_pair_kernel(const Params p) {
  attn_unit<MODE>(p, blockIdx.x);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 2) persistent_kernel(const Params p) {
  for (int u = blockIdx.x; u < p.n_units; u += gridDim.x) attn_unit<MODE>(p, u);
}

}  // namespace

// layout: 0 = one CTA per (row, KV head) over the whole row (chunk = S),
// 1 = a persistent grid of `ctas` CTAs over units of `chunk` rows.  q (B, H,
// D), caches (B, S, KV, D) contiguous, bf16; sink holds ctas * 256 floats
// (layout 1) or B * KV * 256 (layout 0).  Returns the launch's CUDA error,
// -1 for a mode or layout it does not know.
extern "C" int probe_decode_loop(const void* q, const void* k, const void* v,
                                 const void* cache_len, void* out, void* sink,
                                 void* part_ml, void* part_acc, void* tickets,
                                 int mode, int layout, int B, int n_kv, int S,
                                 int chunk, int ctas, float scale, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.cache_len = static_cast<const int32_t*>(cache_len);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.sink = static_cast<float*>(sink);
  p.part_ml = static_cast<float*>(part_ml);
  p.part_acc = static_cast<float*>(part_acc);
  p.tickets = static_cast<int32_t*>(tickets);
  p.B = B;
  p.n_kv = n_kv;
  p.S = S;
  p.chunk = layout == 0 ? S : chunk;
  p.n_chunks = (S + p.chunk - 1) / p.chunk;
  p.n_units = B * n_kv * p.n_chunks;
  p.k_sb = p.v_sb = (long long)S * n_kv * D;
  p.k_ss = p.v_ss = (long long)n_kv * D;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = layout == 0 ? B * n_kv : ctas;
#define PROBE_CASE(M)                                                    \
  if (mode == M) {                                                       \
    if (layout == 0)                                                     \
      per_pair_kernel<M><<<grid, THREADS, 0, s>>>(p);                    \
    else                                                                 \
      persistent_kernel<M><<<grid, THREADS, 0, s>>>(p);                  \
    return static_cast<int>(cudaGetLastError());                         \
  }
  PROBE_CASE(0)
  PROBE_CASE(1)
  PROBE_CASE(2)
#undef PROBE_CASE
  return -1;
}

// ---------------------------------------------------------------------------
// The streaming rate of the new unit's cp.async ring alone: the fused op's
// attention role without any arithmetic.  Each unit is (row, KV head,
// `chunk` rows); 3 stages of 32 rows of K and V (D 128, bf16), 16-byte
// cp.async.cg, as csrc/attn_decode.cuh loads them.  head_major = 0 reads
// the caches in their (B, S, KV, D) layout (a row's 256 bytes at a 2 KB
// stride), 1 a (B, KV, S, D) copy (a stage's rows contiguous).
// ---------------------------------------------------------------------------
namespace {

constexpr int RING_ROWS = 32;
constexpr int RING_STAGES = 3;
constexpr int RING_LD = D + 8;

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 16 : 0));
}

__global__ void __launch_bounds__(THREADS, 2) ring_kernel(const Params p,
                                                          int head_major) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sv = sk + RING_STAGES * RING_ROWS * RING_LD;
  float sink = 0.f;
  const int pairs = p.B * p.n_kv;
  for (int u = blockIdx.x; u < p.n_units; u += gridDim.x) {
    const int chunk = u / pairs, pair = u % pairs;
    const int b = pair / p.n_kv, kvh = pair % p.n_kv;
    const int len = min(max(p.cache_len[b], 0), p.S);
    if (chunk * p.chunk >= max(len, 1)) continue;
    const int r0 = chunk * p.chunk, r1 = min(len, r0 + p.chunk);
    const int n_tiles = (r1 - r0 + RING_ROWS - 1) / RING_ROWS;
    const long long row_stride = head_major ? D : (long long)p.n_kv * D;
    const long long base = head_major
        ? ((long long)b * p.n_kv + kvh) * p.S * D
        : (long long)b * p.S * p.n_kv * D + kvh * D;
    auto load = [&](int stage, int t) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = threadIdx.x + i * THREADS;
        const int r = c / 16, col = (c % 16) * 8;
        const int row = r0 + t * RING_ROWS + r;
        const bool ok = row < r1;
        const long long off = base + (long long)row * row_stride + col;
        cp16(sk + (stage * RING_ROWS + r) * RING_LD + col, ok ? p.k + off : p.k, ok);
        cp16(sv + (stage * RING_ROWS + r) * RING_LD + col, ok ? p.v + off : p.v, ok);
      }
    };
    for (int s = 0; s < RING_STAGES - 1; ++s) {
      if (s < n_tiles) load(s, s);
      asm volatile("cp.async.commit_group;\n" ::);
    }
    for (int t = 0; t < n_tiles; ++t) {
      asm volatile("cp.async.wait_group 1;\n" ::);
      __syncthreads();
      if (t + 2 < n_tiles) load((t + 2) % RING_STAGES, t + 2);
      asm volatile("cp.async.commit_group;\n" ::);
      sink += __bfloat162float(sk[((t % RING_STAGES) * RING_ROWS + threadIdx.x % RING_ROWS) * RING_LD]);
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
  }
  p.sink[(long long)blockIdx.x * blockDim.x + threadIdx.x] += sink;
}

}  // namespace

// the ring alone over a persistent grid of `ctas` CTAs: q, out, part_* and
// tickets unused; returns the launch's CUDA error
extern "C" int probe_ring(const void* k, const void* v, const void* cache_len,
                          void* sink, int B, int n_kv, int S, int chunk,
                          int ctas, int head_major, void* stream) {
  Params p = {};
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.cache_len = static_cast<const int32_t*>(cache_len);
  p.sink = static_cast<float*>(sink);
  p.B = B;
  p.n_kv = n_kv;
  p.S = S;
  p.chunk = chunk;
  p.n_chunks = (S + chunk - 1) / chunk;
  p.n_units = B * n_kv * p.n_chunks;
  constexpr int SMEM = 2 * RING_STAGES * RING_ROWS * RING_LD * 2;
  cudaError_t err = cudaFuncSetAttribute(
      ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  ring_kernel<<<ctas, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(p, head_major);
  return static_cast<int>(cudaGetLastError());
}
