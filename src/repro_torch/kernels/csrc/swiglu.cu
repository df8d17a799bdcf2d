// Fused SwiGLU, out = silu(x @ w_gate) * (x @ w_up), for Hopper (sm_90a),
// with a plain C interface loaded through ctypes.
//
// Replaces the TPU kernel src/repro/kernels/swiglu.py `swiglu` (`_kernel`):
// two f32 accumulators over the K sweep and one epilogue that applies
// g * sigmoid(g) * u and stores in the input dtype, so the two (M, N)
// intermediates never reach device memory.
//
// What bounds it on the card: at decode batch sizes (M <= ~256 rows against
// d_ff = 12288) the weights dominate and it is bound by bytes (two K x N
// matrices read once, ~201 MB per call for Qwen3-8B); at prefill batch sizes
// it is bound by operations (4 M N K flops on the tensor cores).
//
// What the design does about it:
//   * bf16: csrc/gemm_sm90.cuh's mainloop with two weight matrices: TMA
//     copies of the x tile and of the gate and up tiles at the same
//     coordinates into one ring, wgmma into two accumulators per
//     warpgroup, one x tile shared by both products, a producer warp (12%
//     faster than thread 0 at T = 256, PERF.md §6), 4 stages, one CTA per
//     SM.  The wrapper picks the tile (kernels/swiglu.py `plan`): up to 64
//     rows the swap-AB tile, TN = 8, 16, 32 or 64 rows of x on wgmma's N
//     side by 128 weight columns (two warpgroups of 64 on its M side,
//     stages of 33-40 KB), so no product row is padding; above, 128 x 128
//     tiles of x rows (two warpgroups stacked, stages of 48 KB).
//   * Schedule (the wrapper chooses it too): the grid is `groups` x mt
//     CTAs, mt = the M tiles.  Group g takes a run of whole column strips
//     over all of K, one CTA per M tile, so a strip's M tiles read each
//     weight tile at the same time (it crosses device memory once; the
//     others find it in L2).  No split of K, so no merge of partial sums.
//   * f32: a plain shared-memory tiled FMA kernel (4 x 4 outputs of both
//     products per thread), kept for exact f32 checks.
//   * Ragged M, N and K: TMA fills out-of-bounds box elements with zeros
//     and the epilogue guards its stores; nothing is padded in device
//     memory.  bf16 needs K and N to be multiples of 8 (TMA's strides).
#include "gemm_sm90.cuh"

namespace {

using gemm_sm90::BK;
using gemm_sm90::Step;

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g / (1.f + expf(-g)) * u;
}

// ---------------------------------------------------------------------------
// bf16: wgmma tensor-core kernel
// ---------------------------------------------------------------------------
struct Params {
  CUtensorMap x_map, wg_map, wu_map;
  __nv_bfloat16* out;
  int M, N, K;
  int mt, ns, kt, groups;
};

// Group g's column strips [g ns / groups, (g + 1) ns / groups), each over
// all kt K tiles: a CTA's steps are strip-major.
template <int BM, int BN>
struct Strips {
  int mtile, first, count, kt;
  __device__ int steps() const { return count * kt; }
  __device__ Step at(int i) const {
    return Step{mtile * BM, (first + i / kt) * BN, (i % kt) * BK};
  }
  __device__ int span(int) const { return kt; }
};

constexpr int STAGES = 4;

template <class Tile>
__global__ void __launch_bounds__(Tile::WGS * gemm_sm90::WG_THREADS + 32, 1)
swiglu_bf16_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = blockIdx.x / p.mt;
  const int first = static_cast<int>(static_cast<long long>(g) * p.ns / p.groups);
  const int end = static_cast<int>(static_cast<long long>(g + 1) * p.ns / p.groups);
  const Strips<Tile::BM, Tile::BN> strips{static_cast<int>(blockIdx.x % p.mt),
                                          first, end - first, p.kt};
  const CUtensorMap* const b_maps[2] = {&p.wg_map, &p.wu_map};
  gemm_sm90::run<Tile, 2, STAGES, true>(
      smem, &p.x_map, b_maps, strips,
      [&](const Step& st, float (&acc)[2][Tile::ACC]) {
#pragma unroll
        for (int i = 0; i < Tile::ACC; i += 2) {
          const int row = st.m0 + Tile::row(i);
          const int col = st.n0 + Tile::col(i);
          const float a = silu_mul(acc[0][i], acc[1][i]);
          const float b = silu_mul(acc[0][i + 1], acc[1][i + 1]);
          if (!Tile::SWAP) {   // sums i and i + 1: one row, two columns
            if (row < p.M && col < p.N)
              *reinterpret_cast<__nv_bfloat162*>(
                  p.out + static_cast<long long>(row) * p.N + col) =
                  __floats2bfloat162_rn(a, b);
          } else if (col < p.N) {  // one column, two rows
            if (row < p.M)
              p.out[static_cast<long long>(row) * p.N + col] = __float2bfloat16_rn(a);
            if (row + 1 < p.M)
              p.out[static_cast<long long>(row + 1) * p.N + col] = __float2bfloat16_rn(b);
          }
        }
      });
}

template <class Tile>
int launch_bf16(Params& p, const void* x, const void* wg, const void* wu,
                cudaStream_t stream) {
  using R = gemm_sm90::Ring<Tile, 2, STAGES>;
  p.mt = (p.M + Tile::BM - 1) / Tile::BM;
  p.ns = (p.N + Tile::BN - 1) / Tile::BN;
  if (p.groups < 1 || p.groups > p.ns) return -1;
  if (!gemm_sm90::encode(&p.x_map, x, p.M, p.K, Tile::BM) ||
      !gemm_sm90::encode(&p.wg_map, wg, p.K, p.N, BK) ||
      !gemm_sm90::encode(&p.wu_map, wu, p.K, p.N, BK))
    return -2;
  auto kernel = swiglu_bf16_kernel<Tile>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<p.groups * p.mt, R::CONSUMERS + 32, R::SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int TN>
using Swap = gemm_sm90::SwapTile<TN>;

// The bf16 tiles the wrapper may pick (kernels/swiglu.py `TILES`), by their
// rows of x and weight columns.
int launch_tile(Params& p, int bm, int bn, const void* x, const void* wg,
                const void* wu, cudaStream_t s) {
  if (bn != 128) return -1;
  switch (bm) {
    case 8: return launch_bf16<Swap<8>>(p, x, wg, wu, s);
    case 16: return launch_bf16<Swap<16>>(p, x, wg, wu, s);
    case 32: return launch_bf16<Swap<32>>(p, x, wg, wu, s);
    case 64: return launch_bf16<Swap<64>>(p, x, wg, wu, s);
    case 128: return launch_bf16<gemm_sm90::RowTile>(p, x, wg, wu, s);
  }
  return -1;
}

// ---------------------------------------------------------------------------
// f32: shared-memory tiled FMA kernel
// ---------------------------------------------------------------------------
constexpr int FM = 64;
constexpr int FN = 64;
constexpr int FK = 16;
constexpr int F_THREADS = 256;

__global__ void __launch_bounds__(F_THREADS)
swiglu_f32_kernel(const float* __restrict__ x, const float* __restrict__ wg,
                  const float* __restrict__ wu, float* __restrict__ out,
                  int M, int N, int K) {
  __shared__ float sa[FK][FM + 4];   // x tile, transposed: sa[k][m]
  __shared__ float sg[FK][FN];
  __shared__ float su[FK][FN];
  const int tid = threadIdx.x;
  const int tx = tid & 15;   // 4 output columns each
  const int ty = tid >> 4;   // 4 output rows each
  const int m0 = blockIdx.y * FM;
  const int n0 = blockIdx.x * FN;

  float acc_g[4][4] = {};
  float acc_u[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FK) {
#pragma unroll
    for (int i = 0; i < (FM * FK) / F_THREADS; ++i) {
      const int e = tid + i * F_THREADS;
      const int row = e / FK;
      const int col = e % FK;
      const int m = m0 + row;
      const int kk = k0 + col;
      sa[col][row] = (m < M && kk < K) ? x[(long long)m * K + kk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (FK * FN) / F_THREADS; ++i) {
      const int e = tid + i * F_THREADS;
      const int row = e / FN;
      const int col = e % FN;
      const int kk = k0 + row;
      const int n = n0 + col;
      const bool ok = kk < K && n < N;
      sg[row][col] = ok ? wg[(long long)kk * N + n] : 0.f;
      su[row][col] = ok ? wu[(long long)kk * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[4], g[4], u[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sa[kk][ty * 4 + i];
        g[i] = sg[kk][tx * 4 + i];
        u[i] = su[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc_g[i][j] = fmaf(a[i], g[j], acc_g[i][j]);
          acc_u[i][j] = fmaf(a[i], u[j], acc_u[i][j]);
        }
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
      if (n < N) out[(long long)m * N + n] = silu_mul(acc_g[i][j], acc_u[i][j]);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x (M, K), w_gate and w_up (K, N) and
// out (M, N) are contiguous row-major.  bf16 only: the tile of `bm` rows of x
// by `bn` weight columns and `groups` groups of CTAs, at most the column
// strips (kernels/swiglu.py `plan`).  Returns -1 for an input this build
// does not take (bf16 needs K > 0, K % 8 == 0, N % 8 == 0 and a tile of
// `TILES`), -2 if cuTensorMapEncodeTiled refuses a tensor map, else
// cudaGetLastError() after the launch.
extern "C" int repro_swiglu(const void* x, const void* w_gate,
                            const void* w_up, void* out, int dtype, int M,
                            int N, int K, int bm, int bn, int groups,
                            void* stream) {
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (K <= 0 || K % 8 || N % 8) return -1;
    Params p;
    p.out = static_cast<__nv_bfloat16*>(out);
    p.M = M;
    p.N = N;
    p.K = K;
    p.kt = (K + BK - 1) / BK;
    p.groups = groups;
    return launch_tile(p, bm, bn, x, w_gate, w_up, s);
  }
  if (dtype == 0) {
    dim3 grid((N + FN - 1) / FN, (M + FM - 1) / FM);
    swiglu_f32_kernel<<<grid, F_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w_gate),
        static_cast<const float*>(w_up), static_cast<float*>(out), M, N, K);
    return static_cast<int>(cudaGetLastError());
  }
  return -1;
}
