// NanoFlow's fused GEMM + decode-attention overlap for Hopper (sm_90a), with
// a plain C interface loaded through ctypes.
//
// Replaces the TPU kernel src/repro/kernels/fused_overlap.py `fused_overlap`
// (`_kernel`): gemm_out = x (M, K) @ w (K, N), accumulated in f32 and stored
// in x's dtype, computed in the same launch as decode attention of q (B, H,
// D) over caches (B, S, KV, D), row b attending rows [0, cache_len[b]) with
// scores scaled by D ** -0.5 (NEG_INF = -1e30 and the 1e-30 clamp of the
// denominator, as the TPU kernel).  On the TPU one core interleaves a GEMM
// tile and an attention unit in each grid step; here the launch is split
// between the two kinds of work by CTA, the paper's SM partition.
//
// What bounds it on the card: the GEMM is bound by operations (2 M N K
// flops on the tensor cores) and the attention by bytes (each attended K
// and V row read once, ~4 flops per byte).  Run one after the other, the
// card pays the sum of the two; run side by side on disjoint CTAs, the
// least it can pay is the larger of the two resources' times for the whole
// op.  That is the overlap NanoFlow buys.
//
// What the design does about it:
//   * One persistent launch of P CTAs, P = SMs x the CTAs per SM that the
//     occupancy API allows, so every CTA is resident at once and both roles
//     really run at the same time.  CTAs [0, G) walk the GEMM's output tiles
//     with stride G; CTAs [G, P) walk the attention units with stride P - G.
//     G = clamp(round(gemm_fraction * P), 1, P - 1) when both have work, so
//     gemm_fraction = 1.0 still leaves one CTA to the attention.  Blocks are
//     handed out one per SM before the second, so at G = P / 2 each SM holds
//     one CTA of each role (intra-SM overlap).
//   * GEMM role, bf16: csrc/gemm_sm90.cuh's mainloop with one weight
//     matrix: 128 x 128 output tiles, two consumer warpgroups each running
//     wgmma m64n128k16 (64 f32 accumulators a thread, inside the 128
//     registers that two CTAs per SM allow), a 3-stage TMA ring of 32 KB
//     stages (97 KB with its barriers, so two CTAs still fit an SM) with
//     full and empty mbarriers, thread 0 keeping the loads STAGES steps
//     ahead across the CTA's tiles (the unit fixes the CTA at 256
//     threads, so there is no producer warp).  TMA zero-fills ragged M, N
//     and K edges; stores are guarded.  bf16 needs K > 0 and K, N
//     multiples of 8.  f32: 64 x 64 tiles of plain FMA, kept for exact
//     checks (masked loads).
//   * Attention role: csrc/attn_decode.cuh's unit, shared with decode
//     attention: a unit is (row, KV head, chunk of `chunk` rows, 512 by
//     default; the TPU kernel's block_s is 256), and units past cache_len
//     exit without a read.  K/V tiles stream through a cp.async ring that fits
//     in the GEMM ring's shared memory, bf16 scores and P V run on
//     mma.sync, and a row of several chunks is merged in chunk order by the
//     CTA that takes the pair's last ticket (an atomic counter per (row, KV
//     head), set back to 0 by that CTA), so the op stays one launch.
//   * Each output element's arithmetic does not depend on which CTA computes
//     it, nor on the order in which CTAs finish, so the outputs are bitwise
//     equal at every gemm_fraction.
//   * Shared memory is one dynamic buffer sized to the larger role (the bf16
//     GEMM ring, 97 KB, above the 48 KB default; the attention ring takes
//     at most 54 KB).
// Left for a later change: choosing G from the two roles' measured rates
// instead of a caller's fraction.
#include "attn_decode.cuh"
#include "gemm_sm90.cuh"

namespace {

using attn_decode::THREADS;

struct Params {
  CUtensorMap x_map, w_map;   // bf16: the GEMM role's operands for TMA
  const void* x;
  const void* w;
  void* gemm_out;
  int M, N, K;
  attn_decode::Args attn;   // the attention role's operands
  int n_gemm_ctas, n_tiles, n_units;
};

// ---------------------------------------------------------------------------
// GEMM role, bf16: wgmma tiles on csrc/gemm_sm90.cuh's mainloop
// ---------------------------------------------------------------------------
constexpr int STAGES = 3;
using GemmTile = gemm_sm90::RowTile;
using GemmRing = gemm_sm90::Ring<GemmTile, 1, STAGES>;
constexpr int BM = GemmTile::BM;
constexpr int BN = GemmTile::BN;
constexpr int BF16_SMEM = GemmRing::SMEM;
static_assert(GemmRing::CONSUMERS == THREADS, "one CTA size for both roles");

// The tiles cta, cta + stride, ... (row-major over the tile grid), each
// over all of K.
struct Strided {
  int cta, stride, n_tiles, n_tn, kt;
  __device__ int steps() const {
    return cta < n_tiles ? ((n_tiles - 1 - cta) / stride + 1) * kt : 0;
  }
  __device__ gemm_sm90::Step at(int i) const {
    const int t = cta + (i / kt) * stride;
    return gemm_sm90::Step{(t / n_tn) * BM, (t % n_tn) * BN,
                           (i % kt) * gemm_sm90::BK};
  }
  __device__ int span(int) const { return kt; }
};

__device__ void gemm_role(const Params& p, int cta, __nv_bfloat16* /*tag*/,
                          unsigned char* smem) {
  __nv_bfloat16* __restrict__ out = static_cast<__nv_bfloat16*>(p.gemm_out);
  const Strided sched{cta, p.n_gemm_ctas, p.n_tiles, (p.N + BN - 1) / BN,
                      (p.K + gemm_sm90::BK - 1) / gemm_sm90::BK};
  const CUtensorMap* const b_maps[1] = {&p.w_map};
  gemm_sm90::run<GemmTile, 1, STAGES, false>(
      smem, &p.x_map, b_maps, sched,
      [&](const gemm_sm90::Step& st, float (&acc)[1][GemmTile::ACC]) {
#pragma unroll
        for (int i = 0; i < GemmTile::ACC; i += 2) {
          const int row = st.m0 + GemmTile::row(i);
          const int col = st.n0 + GemmTile::col(i);
          if (row < p.M && col < p.N)
            *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long long>(row) * p.N + col) =
                __floats2bfloat162_rn(acc[0][i], acc[0][i + 1]);
        }
      });
}

// ---------------------------------------------------------------------------
// GEMM role, f32: shared-memory tiled FMA
// ---------------------------------------------------------------------------
constexpr int FM = 64;
constexpr int FN = 64;
constexpr int FK = 16;
constexpr int F32_SMEM = (FK * (FM + 4) + FK * FN) * 4;

__device__ void gemm_tile(const Params& p, int tile, float* /*tag*/,
                          unsigned char* smem) {
  typedef float ARow[FM + 4];   // x tile, transposed: sa[k][m]
  typedef float BRow[FN];
  ARow* sa = reinterpret_cast<ARow*>(smem);
  BRow* sb = reinterpret_cast<BRow*>(smem + FK * sizeof(ARow));
  const float* __restrict__ x = static_cast<const float*>(p.x);
  const float* __restrict__ w = static_cast<const float*>(p.w);
  float* __restrict__ out = static_cast<float*>(p.gemm_out);
  const int M = p.M, N = p.N, K = p.K;
  const int tid = threadIdx.x;
  const int tx = tid & 15;   // 4 output columns each
  const int ty = tid >> 4;   // 4 output rows each
  const int n_tn = (N + FN - 1) / FN;
  const int m0 = (tile / n_tn) * FM;
  const int n0 = (tile % n_tn) * FN;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FK) {
#pragma unroll
    for (int i = 0; i < (FM * FK) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int row = e / FK;
      const int col = e % FK;
      const int m = m0 + row;
      const int kk = k0 + col;
      sa[col][row] = (m < M && kk < K) ? x[(long long)m * K + kk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (FK * FN) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int row = e / FN;
      const int col = e % FN;
      const int kk = k0 + row;
      const int n = n0 + col;
      sb[row][col] = (kk < K && n < N) ? w[(long long)kk * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sa[kk][ty * 4 + i];
        b[i] = sb[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) out[(long long)m * N + n] = acc[i][j];
    }
  }
}

__device__ void gemm_role(const Params& p, int cta, float* tag,
                          unsigned char* smem) {
  for (int t = cta; t < p.n_tiles; t += p.n_gemm_ctas)
    gemm_tile(p, t, tag, smem);
}

template <typename T, int G, int D>
__global__ void __launch_bounds__(THREADS, 2)
fused_overlap_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cta = blockIdx.x;
  if (cta < p.n_gemm_ctas) {
    gemm_role(p, cta, static_cast<T*>(nullptr), smem);
  } else {
    const int stride = gridDim.x - p.n_gemm_ctas;
    for (int u = cta - p.n_gemm_ctas; u < p.n_units; u += stride)
      attn_decode::unit<T, G, D>(p.attn, u, smem);
  }
}

template <typename T, int G, int D>
int launch(Params p, float gemm_fraction, int* sched, cudaStream_t stream) {
  constexpr int GEMM_SMEM = sizeof(T) == 2 ? BF16_SMEM : F32_SMEM;
  constexpr int A_SMEM = attn_decode::smem_bytes<T, G, D>();
  constexpr int SMEM = GEMM_SMEM > A_SMEM ? GEMM_SMEM : A_SMEM;
  auto kernel = fused_overlap_kernel<T, G, D>;
  cudaError_t err = cudaSuccess;
  if (SMEM > 48 * 1024)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                           SMEM)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return -3;
  const int n_ctas = sms * per_sm;
  int g;
  if (p.n_tiles == 0)
    g = 0;
  else if (p.n_units == 0)
    g = n_ctas;
  else
    g = min(max(static_cast<int>(gemm_fraction * n_ctas + 0.5f), 1), n_ctas - 1);
  p.n_gemm_ctas = g;
  sched[0] = n_ctas;
  sched[1] = g;
  sched[2] = per_sm;
  sched[3] = p.n_units;
  if (n_ctas > 0 && (p.n_tiles > 0 || p.n_units > 0))
    kernel<<<n_ctas, THREADS, SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int group, int head_dim, const Params& p, float frac, int* sched,
             cudaStream_t s) {
#define REPRO_FO_CASE(G, D) \
  if (group == G && head_dim == D) return launch<T, G, D>(p, frac, sched, s);
#define REPRO_FO_CASES(G) REPRO_FO_CASE(G, 64) REPRO_FO_CASE(G, 128) REPRO_FO_CASE(G, 256)
  REPRO_FO_CASES(1)
  REPRO_FO_CASES(2)
  REPRO_FO_CASES(4)
  REPRO_FO_CASES(8)
  // groups 3, 7 and 9 at head dim 128 only (csrc/decode_attention.cu)
  REPRO_FO_CASE(3, 128)
  REPRO_FO_CASE(7, 128)
  REPRO_FO_CASE(9, 128)
#undef REPRO_FO_CASES
#undef REPRO_FO_CASE
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w, gemm_out, q, the caches and
// attn_out all of it).  x (M, K), w (K, N), gemm_out (M, N), q and attn_out
// (B, H, D) are contiguous; the caches are (B, S, KV, D) with unit stride
// over (KV, D), 16-byte aligned rows and the given element strides over B
// and S; cache_len is (B,) int32.  `chunk` (a positive multiple of 64) is
// the cache rows per attention unit.  part_ml holds B * KV * n_chunks * 2 *
// G floats, part_acc B * KV * n_chunks * G * D (n_chunks = ceil(S /
// chunk)), tickets B * KV int32 zeros, left zero by the launch.  sched
// receives (CTAs launched, of them GEMM CTAs, CTAs per SM, attention
// units).  Returns -1 for a shape or chunk this build does not take (bf16
// also needs K > 0, K % 8 == 0 and N % 8 == 0), -3 if the kernel cannot be
// resident, -2 if cuTensorMapEncodeTiled refuses a tensor map of the bf16
// GEMM, else the CUDA error of the launch.
extern "C" int repro_fused_overlap(
    const void* x, const void* w, void* gemm_out, const void* q, const void* k,
    const void* v, const void* cache_len, void* attn_out, void* part_ml,
    void* part_acc, void* tickets, int dtype, int M, int N, int K, int B,
    int n_heads, int n_kv, int head_dim, int S, int chunk,
    long long k_stride_b, long long k_stride_s, long long v_stride_b,
    long long v_stride_s, float scale, float gemm_fraction, void* sched,
    void* stream) {
  if (n_kv <= 0 || n_heads % n_kv || chunk <= 0 ||
      chunk % attn_decode::CHUNK_MULTIPLE)
    return -1;
  Params p;
  p.x = x;
  p.w = w;
  p.gemm_out = gemm_out;
  p.M = M;
  p.N = N;
  p.K = K;
  attn_decode::Args& a = p.attn;
  a.q = q;
  a.k = k;
  a.v = v;
  a.cache_len = static_cast<const int32_t*>(cache_len);
  a.out = attn_out;
  a.part_ml = static_cast<float*>(part_ml);
  a.part_acc = static_cast<float*>(part_acc);
  a.tickets = static_cast<int32_t*>(tickets);
  a.B = B;
  a.n_kv = n_kv;
  a.S = S;
  a.chunk = chunk;
  a.n_chunks = (S + chunk - 1) / chunk;
  a.k_sb = k_stride_b;
  a.k_ss = k_stride_s;
  a.v_sb = v_stride_b;
  a.v_ss = v_stride_s;
  a.scale = scale;
  const bool empty_gemm = M == 0 || N == 0;
  if (dtype == 1) {
    if (K % 8 || N % 8) return -1;
    p.n_tiles = empty_gemm ? 0 : ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
    if (p.n_tiles > 0 &&
        (K <= 0 || !gemm_sm90::encode(&p.x_map, x, M, K, BM) ||
         !gemm_sm90::encode(&p.w_map, w, K, N, gemm_sm90::BK)))
      return K <= 0 ? -1 : -2;
  } else if (dtype == 0) {
    p.n_tiles = empty_gemm ? 0 : ((M + FM - 1) / FM) * ((N + FN - 1) / FN);
  } else {
    return -1;
  }
  // S == 0 still runs one unit per pair, which writes zeros
  p.n_units = B * n_kv * (a.n_chunks > 0 ? a.n_chunks : 1);
  p.n_gemm_ctas = 0;
  int* out = static_cast<int*>(sched);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = n_heads / n_kv;
  if (dtype == 1) return dispatch<__nv_bfloat16>(group, head_dim, p, gemm_fraction, out, s);
  return dispatch<float>(group, head_dim, p, gemm_fraction, out, s);
}
