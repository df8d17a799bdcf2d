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
//   * GEMM role, bf16: 128 x 128 output tiles, 8 warps each owning 64 x 32,
//     mma.sync m16n8k16 (bf16 in, f32 accumulate) fed by ldmatrix from padded
//     shared memory and a 3-stage cp.async ring (the tile code of
//     csrc/swiglu.cu with one product); f32: 64 x 64 tiles of plain FMA,
//     kept for exact checks.  Ragged M, N and K edges are masked in the
//     kernel (zero-filled loads, guarded stores); nothing is padded.  bf16
//     moves 16-byte chunks, so it needs K and N to be multiples of 8.
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
//     GEMM ring, 55.5 KB, above the 48 KB default; the attention ring takes
//     at most 54 KB).
// Left for a later change: wgmma and TMA for the GEMM role, and choosing G
// from the two roles' measured rates instead of a caller's fraction.
#include "attn_decode.cuh"

namespace {

using attn_decode::cp_async16;
using attn_decode::cp_async_commit;
using attn_decode::cp_async_wait;
using attn_decode::ldmatrix_x4;
using attn_decode::ldmatrix_x4_trans;
using attn_decode::mma_bf16;
using attn_decode::THREADS;

struct Params {
  const void* x;
  const void* w;
  void* gemm_out;
  int M, N, K;
  attn_decode::Args attn;   // the attention role's operands
  int n_gemm_ctas, n_tiles, n_units;
};

// ---------------------------------------------------------------------------
// GEMM role, bf16: mma.sync tensor-core tiles
// ---------------------------------------------------------------------------
constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int STAGES = 3;
constexpr int A_LD = BK + 8;   // padded row pitch (elements) of the x tile
constexpr int B_LD = BN + 8;   // padded row pitch of the w tile
constexpr int BF16_SMEM = STAGES * (BM * A_LD + BK * B_LD) * 2;

__device__ void gemm_tile(const Params& p, int tile, __nv_bfloat16* /*tag*/,
                          unsigned char* smem) {
  typedef __nv_bfloat16 ATile[BM][A_LD];
  typedef __nv_bfloat16 BTile[BK][B_LD];
  ATile* sa = reinterpret_cast<ATile*>(smem);
  BTile* sb = reinterpret_cast<BTile*>(smem + STAGES * sizeof(ATile));
  const __nv_bfloat16* __restrict__ x = static_cast<const __nv_bfloat16*>(p.x);
  const __nv_bfloat16* __restrict__ w = static_cast<const __nv_bfloat16*>(p.w);
  __nv_bfloat16* __restrict__ out = static_cast<__nv_bfloat16*>(p.gemm_out);
  const int M = p.M, N = p.N, K = p.K;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 2;   // warp's 64-row half of the tile
  const int wn = warp & 3;    // warp's 32-column quarter
  const int n_tn = (N + BN - 1) / BN;
  const int m0 = (tile / n_tn) * BM;
  const int n0 = (tile % n_tn) * BN;

  auto load_tile = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {   // x tile: 128 rows x 4 chunks of 8
      const int c = tid + i * THREADS;
      const int row = c >> 2;
      const int col = (c & 3) * 8;
      const bool ok = (m0 + row < M) && (k0 + col < K);
      const __nv_bfloat16* src = ok ? x + (long long)(m0 + row) * K + k0 + col : x;
      cp_async16(&sa[stage][row][col], src, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {   // w tile: 32 rows x 16 chunks of 8
      const int c = tid + i * THREADS;
      const int row = c >> 4;
      const int col = (c & 15) * 8;
      const bool ok = (k0 + row < K) && (n0 + col < N);
      const __nv_bfloat16* src = ok ? w + (long long)(k0 + row) * N + n0 + col : w;
      cp_async16(&sb[stage][row][col], src, ok);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;

  const int ktiles = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_tile(s, s * BK);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nk = kt + STAGES - 1;
    if (nk < ktiles) load_tile(nk % STAGES, nk * BK);
    cp_async_commit();

    const int st = kt % STAGES;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(af[mt], &sa[st][wm * 64 + mt * 16 + (lane & 15)]
                               [kk + (lane >> 4) * 8]);
      const int brow = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int bcol = wn * 32 + np * 16 + (lane >> 4) * 8;
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, &sb[st][brow][bcol]);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma_bf16(acc[mt][np * 2], af[mt], bf[0], bf[1]);
          mma_bf16(acc[mt][np * 2 + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the next tile's prologue overwrites the ring

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn * 32 + nt * 8 + (lane & 3) * 2;
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 64 + mt * 16 + (lane >> 2) + h * 8;
        if (row >= M) continue;
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * N + col) =
            __floats2bfloat162_rn(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
  }
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

template <typename T, int G, int D>
__global__ void __launch_bounds__(THREADS, 2)
fused_overlap_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cta = blockIdx.x;
  if (cta < p.n_gemm_ctas) {
    for (int t = cta; t < p.n_tiles; t += p.n_gemm_ctas)
      gemm_tile(p, t, static_cast<T*>(nullptr), smem);
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
// also needs K % 8 == 0 and N % 8 == 0), -3 if the kernel cannot be
// resident, else the CUDA error of the launch.
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
