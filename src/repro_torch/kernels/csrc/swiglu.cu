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
//   * bf16: a 64 x 64 output tile per block, 4 warps each owning 32 x 32 of
//     both products, mma.sync m16n8k16 (bf16 in, f32 accumulate) fed by
//     ldmatrix from padded (bank-conflict-free) shared memory, and a 3-stage
//     cp.async ring so the next K tiles load while the current one
//     multiplies.  x is read once per N tile, each weight tile once per M
//     tile: at decode sizes (one M tile) the weights stream through exactly
//     once.
//   * f32: a plain shared-memory tiled FMA kernel (4 x 4 outputs of both
//     products per thread), kept for exact f32 checks.
//   * Ragged M, N and K edges are masked in the kernel (zero-filled loads,
//     guarded stores); nothing is padded in device memory.  The bf16 path
//     moves 16-byte chunks, so it needs K and N to be multiples of 8.
// Left for a later change: wgmma, TMA and warp specialisation, and a
// split-K or persistent schedule for the decode shapes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g / (1.f + expf(-g)) * u;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor-core kernel
// ---------------------------------------------------------------------------
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int STAGES = 3;
constexpr int A_LD = BK + 8;   // padded row pitch (elements) of the x tile
constexpr int B_LD = BN + 8;   // padded row pitch of the weight tiles
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

__global__ void __launch_bounds__(MMA_THREADS)
swiglu_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ wg,
                   const __nv_bfloat16* __restrict__ wu,
                   __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) __nv_bfloat16 sa[STAGES][BM][A_LD];
  __shared__ __align__(16) __nv_bfloat16 sg[STAGES][BK][B_LD];
  __shared__ __align__(16) __nv_bfloat16 su[STAGES][BK][B_LD];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 1;   // warp's 32-row half of the tile
  const int wn = warp & 1;    // warp's 32-column half
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  auto load_tile = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {   // x tile: 64 rows x 4 chunks of 8
      const int c = tid + i * MMA_THREADS;
      const int row = c >> 2;
      const int col = (c & 3) * 8;
      const bool ok = (m0 + row < M) && (k0 + col < K);
      const __nv_bfloat16* src = ok ? x + (long long)(m0 + row) * K + k0 + col : x;
      cp_async16(&sa[stage][row][col], src, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {   // weight tiles: 32 rows x 8 chunks of 8
      const int c = tid + i * MMA_THREADS;
      const int row = c >> 3;
      const int col = (c & 7) * 8;
      const bool ok = (k0 + row < K) && (n0 + col < N);
      const long long off = ok ? (long long)(k0 + row) * N + n0 + col : 0;
      cp_async16(&sg[stage][row][col], wg + off, ok);
      cp_async16(&su[stage][row][col], wu + off, ok);
    }
  };

  float acc_g[2][4][4];
  float acc_u[2][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc_g[a][b][c] = acc_u[a][b][c] = 0.f;

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
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(af[mt], &sa[st][wm * 32 + mt * 16 + (lane & 15)]
                               [kk + (lane >> 4) * 8]);
      const int brow = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int bcol = wn * 32 + np * 16 + (lane >> 4) * 8;
        uint32_t bg[4], bu[4];
        ldmatrix_x4_trans(bg, &sg[st][brow][bcol]);
        ldmatrix_x4_trans(bu, &su[st][brow][bcol]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc_g[mt][np * 2], af[mt], bg[0], bg[1]);
          mma_bf16(acc_g[mt][np * 2 + 1], af[mt], bg[2], bg[3]);
          mma_bf16(acc_u[mt][np * 2], af[mt], bu[0], bu[1]);
          mma_bf16(acc_u[mt][np * 2 + 1], af[mt], bu[2], bu[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn * 32 + nt * 8 + (lane & 3) * 2;
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 32 + mt * 16 + (lane >> 2) + h * 8;
        if (row >= M) continue;
        const float o0 = silu_mul(acc_g[mt][nt][2 * h], acc_u[mt][nt][2 * h]);
        const float o1 =
            silu_mul(acc_g[mt][nt][2 * h + 1], acc_u[mt][nt][2 * h + 1]);
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * N + col) =
            __floats2bfloat162_rn(o0, o1);
      }
    }
  }
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
// out (M, N) are contiguous row-major.  Returns -1 for an input this build
// does not take (bf16 needs K % 8 == 0 and N % 8 == 0), else
// cudaGetLastError() after the launch.
extern "C" int repro_swiglu(const void* x, const void* w_gate,
                            const void* w_up, void* out, int dtype, int M,
                            int N, int K, void* stream) {
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (K % 8 || N % 8) return -1;
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    swiglu_bf16_kernel<<<grid, MMA_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w_gate),
        static_cast<const __nv_bfloat16*>(w_up),
        static_cast<__nv_bfloat16*>(out), M, N, K);
  } else if (dtype == 0) {
    dim3 grid((N + FN - 1) / FN, (M + FM - 1) / FM);
    swiglu_f32_kernel<<<grid, F_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w_gate),
        static_cast<const float*>(w_up), static_cast<float*>(out), M, N, K);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
