// Segment-masked attention over the token-packed serving stream, for Hopper
// (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces the TPU kernel src/repro/kernels/packed_attention.py
// `packed_attention` (`_kernel` / `_flash_step`), contiguous mode: token t
// attends rows [0, min(lengths[t], kv_bucket)) of its own slot
// `token_slot[t]`, with an online softmax; query head h reads KV head
// h // group.  Same constants as the TPU kernel: q is scaled by `scale`
// (the wrapper passes d ** -0.5), masked scores are NEG_INF = -1e30, and the softmax
// denominator is clamped to 1e-30.
//
// What bounds it on the card: bytes.  A decode token reads its slot's K and V
// rows once (2 * len * head_dim * 2 bytes per KV head in bf16) and does ~4
// flops per byte read, far below the ~295 flops/byte at which an H100 turns
// compute-bound.
//
// What the design does about it:
//   * The cache is read in its stored (N, S, KV, D) layout through strides;
//     no transposed copy of the cache is made (the TPU wrapper's (N, KV, S, D)
//     transpose would cost one pass over the cache per layer per step).
//   * One block per (token, KV head): the `group` query heads that share a KV
//     head are all scored against each K row while it is in registers, so a
//     row is read once per block, not once per query head.
//   * Each warp owns a strided share of the rows and keeps its own online
//     softmax state (m, l, acc) in f32 registers; each lane holds head_dim/32
//     contiguous elements, loaded with one vector load per row, and each warp
//     keeps ROWS K and V rows in flight.  The warps' states are merged once at
//     the end through shared memory, in a fixed order (deterministic).
//   * Rows past the token's length are never loaded: the ragged tail is
//     masked by the loop bound itself.
// Left for a later change (ROADMAP B1): one q tile per prefill segment so a
// chunk does not re-read its slot once per token, and split-KV so a
// decode-only step fills all 132 SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NUM_WARPS = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// G: query heads per KV head; DPL: head_dim / 32 (elements per lane).
template <typename T, int G, int DPL>
__global__ void __launch_bounds__(NUM_WARPS * 32)
packed_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int32_t* __restrict__ token_slot,
                        const int32_t* __restrict__ lengths,
                        T* __restrict__ out, int n_kv, int n_slots, int sweep,
                        long long k_stride_n, long long k_stride_s,
                        long long v_stride_n, long long v_stride_s,
                        float scale) {
  constexpr int D = DPL * 32;
  constexpr int ROWS = DPL <= 4 ? 8 : 4;   // K/V rows in flight per warp
  const int kvh = blockIdx.x;
  const int t = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_heads = n_kv * G;

  const int slot = token_slot[t];
  int len = min(lengths[t], sweep);
  if (slot < 0 || slot >= n_slots || len < 0) len = 0;

  float qf[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_vec<T, DPL>(q + ((long long)t * n_heads + kvh * G + g) * D + lane * DPL,
                     qf[g]);
#pragma unroll
    for (int i = 0; i < DPL; ++i) qf[g][i] *= scale;
  }

  float m[G], l[G], acc[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
  }

  const T* kb = k + (long long)slot * k_stride_n + kvh * D + lane * DPL;
  const T* vb = v + (long long)slot * v_stride_n + kvh * D + lane * DPL;
  for (int base = warp * ROWS; base < len; base += NUM_WARPS * ROWS) {
    float kf[ROWS][DPL], vf[ROWS][DPL];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      const int r = base + u;
      if (r < len) {
        load_vec<T, DPL>(kb + r * k_stride_s, kf[u]);
        load_vec<T, DPL>(vb + r * v_stride_s, vf[u]);
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

template <typename T, int G, int DPL>
void launch(const void* q, const void* k, const void* v, const void* slot,
            const void* lengths, void* out, int n_tokens, int n_kv,
            int n_slots, int sweep, long long ksn, long long kss,
            long long vsn, long long vss, float scale, cudaStream_t stream) {
  dim3 grid(n_kv, n_tokens);
  packed_attention_kernel<T, G, DPL><<<grid, NUM_WARPS * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(slot),
      static_cast<const int32_t*>(lengths), static_cast<T*>(out), n_kv,
      n_slots, sweep, ksn, kss, vsn, vss, scale);
}

template <typename T, int G>
int launch_d(int head_dim, const void* q, const void* k, const void* v,
             const void* slot, const void* lengths, void* out, int n_tokens,
             int n_kv, int n_slots, int sweep, long long ksn, long long kss,
             long long vsn, long long vss, float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      launch<T, G, 2>(q, k, v, slot, lengths, out, n_tokens, n_kv, n_slots,
                      sweep, ksn, kss, vsn, vss, scale, stream);
      return 0;
    case 128:
      launch<T, G, 4>(q, k, v, slot, lengths, out, n_tokens, n_kv, n_slots,
                      sweep, ksn, kss, vsn, vss, scale, stream);
      return 0;
    case 256:
      launch<T, G, 8>(q, k, v, slot, lengths, out, n_tokens, n_kv, n_slots,
                      sweep, ksn, kss, vsn, vss, scale, stream);
      return 0;
  }
  return -1;
}

template <typename T>
int launch_g(int group, int head_dim, const void* q, const void* k,
             const void* v, const void* slot, const void* lengths, void* out,
             int n_tokens, int n_kv, int n_slots, int sweep, long long ksn,
             long long kss, long long vsn, long long vss, float scale,
             cudaStream_t stream) {
#define REPRO_PA_CASE(G)                                                      \
  case G:                                                                     \
    return launch_d<T, G>(head_dim, q, k, v, slot, lengths, out, n_tokens,    \
                          n_kv, n_slots, sweep, ksn, kss, vsn, vss, scale,    \
                          stream);
  switch (group) {
    REPRO_PA_CASE(1)
    REPRO_PA_CASE(2)
    REPRO_PA_CASE(4)
    REPRO_PA_CASE(8)
  }
#undef REPRO_PA_CASE
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q (T, H, D) and out (T, H, D) are
// contiguous; k/v are (N, S, KV, D) with unit stride over (KV, D) and the
// given element strides over N and S.  Returns -1 for a shape this build
// does not instantiate, else cudaGetLastError() after the launch.
extern "C" int repro_packed_attention(
    const void* q, const void* k, const void* v, const void* token_slot,
    const void* lengths, void* out, int dtype, int n_tokens, int n_heads,
    int n_kv, int head_dim, int n_slots, int sweep, long long k_stride_n,
    long long k_stride_s, long long v_stride_n, long long v_stride_s,
    float scale, void* stream) {
  if (n_tokens == 0) return 0;
  const int group = n_heads / n_kv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0)
    rc = launch_g<float>(group, head_dim, q, k, v, token_slot, lengths, out,
                         n_tokens, n_kv, n_slots, sweep, k_stride_n,
                         k_stride_s, v_stride_n, v_stride_s, scale, s);
  else if (dtype == 1)
    rc = launch_g<__nv_bfloat16>(group, head_dim, q, k, v, token_slot,
                                 lengths, out, n_tokens, n_kv, n_slots, sweep,
                                 k_stride_n, k_stride_s, v_stride_n,
                                 v_stride_s, scale, s);
  else
    rc = -1;
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
