// The backward of fused SwiGLU, h = silu(x @ w_gate) * (x @ w_up), for
// Hopper (sm_90a), with a plain C interface loaded through ctypes:
// given dh (M, N), dg = dh u silu'(g) and du = dh silu(g), with g = x @ w_gate
// and u = x @ w_up, both (M, N) in x's dtype.
//
// Replaces no TPU kernel: the JAX package differentiates through XLA, and
// its SwiGLU Pallas kernel (src/repro/kernels/swiglu.py `swiglu`) computes
// g and u inside itself, never storing them.  So does the port's forward
// (csrc/swiglu.cu), which saves nothing for the backward: this kernel
// recomputes g and u in its own body with the forward's mainloop and
// applies the derivative in its epilogue.  dX = dg w_gate^T + du w_up^T,
// dW_gate = x^T dg and dW_up = x^T du stay plain products (torch.matmul),
// as XLA's autodiff computes them outside any Pallas kernel.
//
// What bounds it on the card: operations at training's M (4 M N K flops for
// g and u on the tensor cores; the epilogue reads dh and writes dg and du,
// 3 M N elements, a fraction of that time at K = 4096).
//
// What the design does about it:
//   * bf16: csrc/gemm_sm90.cuh's mainloop, as the forward runs it (TMA
//     ring, wgmma into the gate and up accumulators, a producer warp, the
//     same tiles and CTA groups, kernels/swiglu.py `plan`: 128 x 128 tiles
//     at training's M = 4096, the swap-AB tiles below 65 rows).  The
//     epilogue reads the thread's dh elements in pairs, takes sigmoid,
//     silu and silu' in f32 and stores dg and du in pairs.  The epilogue
//     lives here, not in the shared header.
//   * f32: the forward's shared-memory tiled FMA kernel (4 x 4 outputs of
//     both products per thread) with this epilogue, kept for exact checks.
//   * Ragged M, N and K as in the forward: TMA zero-fills, the epilogue
//     guards its loads and stores.  bf16 needs K and N multiples of 8.
#include "gemm_sm90.cuh"

namespace {

using gemm_sm90::BK;
using gemm_sm90::Step;

// (dg, du) of one element in f32: s = sigmoid(g), silu = g s,
// silu' = s (1 + g (1 - s)).
__device__ __forceinline__ void swiglu_grad(float g, float u, float dh,
                                            float& dg, float& du) {
  const float s = 1.f / (1.f + expf(-g));
  dg = dh * u * (s * (1.f + g * (1.f - s)));
  du = dh * (g * s);
}

// ---------------------------------------------------------------------------
// bf16: wgmma tensor-core kernel
// ---------------------------------------------------------------------------
struct Params {
  CUtensorMap x_map, wg_map, wu_map;
  const __nv_bfloat16* dh;
  __nv_bfloat16* dg;
  __nv_bfloat16* du;
  int M, N, K;
  int mt, ns, kt, groups;
};

// Group g's column strips [g ns / groups, (g + 1) ns / groups), each over
// all kt K tiles (the forward's schedule).
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
swiglu_bwd_bf16_kernel(const __grid_constant__ Params p) {
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
          if (!Tile::SWAP) {   // sums i and i + 1: one row, two columns
            if (row < p.M && col < p.N) {
              const long long at = static_cast<long long>(row) * p.N + col;
              const float2 dh = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(p.dh + at));
              float dg0, du0, dg1, du1;
              swiglu_grad(acc[0][i], acc[1][i], dh.x, dg0, du0);
              swiglu_grad(acc[0][i + 1], acc[1][i + 1], dh.y, dg1, du1);
              *reinterpret_cast<__nv_bfloat162*>(p.dg + at) =
                  __floats2bfloat162_rn(dg0, dg1);
              *reinterpret_cast<__nv_bfloat162*>(p.du + at) =
                  __floats2bfloat162_rn(du0, du1);
            }
          } else if (col < p.N) {  // one column, two rows
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              if (row + j >= p.M) continue;
              const long long at = static_cast<long long>(row + j) * p.N + col;
              float dg, du;
              swiglu_grad(acc[0][i + j], acc[1][i + j],
                          __bfloat162float(p.dh[at]), dg, du);
              p.dg[at] = __float2bfloat16_rn(dg);
              p.du[at] = __float2bfloat16_rn(du);
            }
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
  auto kernel = swiglu_bwd_bf16_kernel<Tile>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<p.groups * p.mt, R::CONSUMERS + 32, R::SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int TN>
using Swap = gemm_sm90::SwapTile<TN>;

// The forward's bf16 tiles (kernels/swiglu.py `TILES`).
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
swiglu_bwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ wg,
                      const float* __restrict__ wu,
                      const float* __restrict__ dh, float* __restrict__ dg,
                      float* __restrict__ du, int M, int N, int K) {
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
      if (n >= N) continue;
      const long long at = (long long)m * N + n;
      swiglu_grad(acc_g[i][j], acc_u[i][j], dh[at], dg[at], du[at]);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x (M, K), w_gate and w_up (K, N), dh,
// dg and du (M, N) are contiguous row-major.  bf16 only: the forward's tile
// of `bm` rows by `bn` columns and `groups` groups of CTAs (kernels/swiglu.py
// `plan`).  Returns -1 for an input this build does not take (bf16 needs
// K > 0, K % 8 == 0, N % 8 == 0 and a tile of `TILES`), -2 if
// cuTensorMapEncodeTiled refuses a tensor map, else cudaGetLastError()
// after the launch.
extern "C" int repro_swiglu_bwd(const void* x, const void* w_gate,
                                const void* w_up, const void* dh, void* dg,
                                void* du, int dtype, int M, int N, int K,
                                int bm, int bn, int groups, void* stream) {
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (K <= 0 || K % 8 || N % 8) return -1;
    Params p;
    p.dh = static_cast<const __nv_bfloat16*>(dh);
    p.dg = static_cast<__nv_bfloat16*>(dg);
    p.du = static_cast<__nv_bfloat16*>(du);
    p.M = M;
    p.N = N;
    p.K = K;
    p.kt = (K + BK - 1) / BK;
    p.groups = groups;
    return launch_tile(p, bm, bn, x, w_gate, w_up, s);
  }
  if (dtype == 0) {
    dim3 grid((N + FN - 1) / FN, (M + FM - 1) / FM);
    swiglu_bwd_f32_kernel<<<grid, F_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w_gate),
        static_cast<const float*>(w_up), static_cast<const float*>(dh),
        static_cast<float*>(dg), static_cast<float*>(du), M, N, K);
    return static_cast<int>(cudaGetLastError());
  }
  return -1;
}
