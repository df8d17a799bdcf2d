// Mamba-1 selective scan for Hopper (sm_90a), with a plain C interface
// loaded through ctypes:
//   h_t = exp(dt_t * a) * h_{t-1} + dt_t * x_t * b_t
//   y_t = h_t . c_t + d * x_t
// per channel, with an (N,) state per (batch row, channel).
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan.py `ssm_scan`
// (`_kernel`).  What it keeps: the (C, N) state stays on chip (in
// registers) for the whole sequence sweep, so device-memory traffic is the
// inputs and outputs only.  What it leaves: on the TPU the sequence is the
// minor, sequential grid axis and a (Cb, N) VMEM scratch carries the state
// from one grid step to the next; here blocks run in no order, so the
// sequence becomes a loop inside the block, and channels, which are
// independent, are the parallel axis.
//
// What bounds it on the card: the C * N exponentials of every token on the
// special-function units (16 per clock per SM on compute capability 9.0);
// its bytes (x, dt, y, a, h0, h_final) are ~37 MB for a 256-token chunk at
// Jamba's C = 16384, N = 16, which the HBM moves in less time.  So it is
// bound by operations.
//
// What the design does about it:
//   * Each lane holds SPL = 4 states of one channel in registers; N / 4
//     neighbouring lanes share a channel, so y is a log2(N / 4)-step
//     butterfly of shuffles per token (2 at N = 16) and the exponentials
//     spread over 4x more lanes than one thread per channel would give
//     (65536 lanes at C = 16384: ~16 warps on each of the 132 SMs).
//   * A tile of TS tokens of x and dt (coalesced along the channels) and
//     their b and c rows (shared by every channel of the batch row) is
//     staged in shared memory as f32; y goes back through shared memory
//     and is written coalesced after the tile.
//   * Everything is accumulated in f32; y is rounded once, to x's dtype.
//   * The ragged channel edge is masked in the kernel (dead lanes compute
//     on zeros and store nothing); any S, S = 1 included, runs without
//     padding; h0 == NULL starts from zeros.
// Left for a later change: double-buffered (cp.async / TMA) staging, a
// persistent schedule, and a chunked (parallel-in-time) formulation for
// long prompts with few channels.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int SPL = 4;    // states per lane
constexpr int TS = 32;    // tokens per staged tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// grid (ceil(C / CH), B), THREADS lanes: lane `tid` runs states
// [n0, n0 + SPL) of channel c0 + tid / L.  Row r = bb * S + t of x, dt, b
// and c starts at element r * s{x,dt,b,c}; y is contiguous (B, S, C); a,
// h0 and h_out are contiguous (C, N) / (B, C, N).
template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
    ssm_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const T* __restrict__ b,
                    const T* __restrict__ c, const float* __restrict__ d,
                    const float* __restrict__ h0, T* __restrict__ y,
                    float* __restrict__ h_out, int S, int C, long long sx,
                    long long sdt, long long sb, long long sc) {
  constexpr int L = N / SPL;         // lanes per channel
  constexpr int CH = THREADS / L;    // channels per block
  static_assert(N % SPL == 0 && 32 % L == 0, "N / 4 lanes must divide a warp");
  __shared__ float xs[TS][CH];
  __shared__ float dts[TS][CH];
  __shared__ float ys[TS][CH];
  __shared__ __align__(16) float bs[TS][N];
  __shared__ __align__(16) float cs[TS][N];

  const int tid = threadIdx.x;
  const int bb = blockIdx.y;
  const int c0 = blockIdx.x * CH;
  const int ch = tid / L;
  const int n0 = (tid % L) * SPL;
  const int cg = c0 + ch;
  const bool live = cg < C;

  float av[SPL], h[SPL];
  float dskip = 0.f;
#pragma unroll
  for (int j = 0; j < SPL; ++j) av[j] = h[j] = 0.f;
  if (live) {
    const float4 a4 =
        *reinterpret_cast<const float4*>(a + (long long)cg * N + n0);
    av[0] = a4.x, av[1] = a4.y, av[2] = a4.z, av[3] = a4.w;
    if (h0 != nullptr) {
      const float4 h4 = *reinterpret_cast<const float4*>(
          h0 + ((long long)bb * C + cg) * N + n0);
      h[0] = h4.x, h[1] = h4.y, h[2] = h4.z, h[3] = h4.w;
    }
    dskip = d[cg];
  }

  const long long row0 = (long long)bb * S;
  for (int t0 = 0; t0 < S; t0 += TS) {
    const int nt = min(TS, S - t0);
    for (int i = tid; i < TS * CH; i += THREADS) {
      const int t = i / CH, k = i % CH;
      float xv = 0.f, dv = 0.f;
      if (t < nt && c0 + k < C) {
        const long long r = row0 + t0 + t;
        xv = to_f32(x[r * sx + c0 + k]);
        dv = dt[r * sdt + c0 + k];
      }
      xs[t][k] = xv;
      dts[t][k] = dv;
    }
    for (int i = tid; i < TS * N; i += THREADS) {
      const int t = i / N, k = i % N;
      float bv = 0.f, cv = 0.f;
      if (t < nt) {
        const long long r = row0 + t0 + t;
        bv = to_f32(b[r * sb + k]);
        cv = to_f32(c[r * sc + k]);
      }
      bs[t][k] = bv;
      cs[t][k] = cv;
    }
    __syncthreads();

    for (int t = 0; t < nt; ++t) {
      const float xt = xs[t][ch];
      const float dtt = dts[t][ch];
      const float dtx = dtt * xt;
      const float4 b4 = *reinterpret_cast<const float4*>(&bs[t][n0]);
      const float4 c4 = *reinterpret_cast<const float4*>(&cs[t][n0]);
      const float bv[SPL] = {b4.x, b4.y, b4.z, b4.w};
      const float cv[SPL] = {c4.x, c4.y, c4.z, c4.w};
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        h[j] = expf(dtt * av[j]) * h[j] + dtx * bv[j];
        acc += h[j] * cv[j];
      }
#pragma unroll
      for (int off = 1; off < L; off <<= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (n0 == 0) ys[t][ch] = acc + dskip * xt;
    }
    __syncthreads();

    for (int i = tid; i < TS * CH; i += THREADS) {
      const int t = i / CH, k = i % CH;
      if (t < nt && c0 + k < C)
        y[(row0 + t0 + t) * C + c0 + k] = from_f32<T>(ys[t][k]);
    }
    // the next tile's staging writes xs/dts/bs/cs, which no lane reads
    // past the barrier above; ys is rewritten only after the next barrier
  }

  if (live) {
    *reinterpret_cast<float4*>(h_out + ((long long)bb * C + cg) * N + n0) =
        make_float4(h[0], h[1], h[2], h[3]);
  }
}

template <typename T, int N>
int launch(const void* x, const void* dt, const void* a, const void* b,
           const void* c, const void* d, const void* h0, void* y, void* h_out,
           int B, int S, int C, long long sx, long long sdt, long long sb,
           long long sc, cudaStream_t s) {
  constexpr int CH = THREADS / (N / SPL);
  dim3 grid((C + CH - 1) / CH, B);
  ssm_scan_kernel<T, N><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const float*>(d),
      static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(h_out), S, C, sx, sdt, sb, sc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_n(int N, const void* x, const void* dt, const void* a,
               const void* b, const void* c, const void* d, const void* h0,
               void* y, void* h_out, int B, int S, int C, long long sx,
               long long sdt, long long sb, long long sc, cudaStream_t s) {
  switch (N) {
    case 16:
      return launch<T, 16>(x, dt, a, b, c, d, h0, y, h_out, B, S, C, sx, sdt,
                           sb, sc, s);
    case 32:
      return launch<T, 32>(x, dt, a, b, c, d, h0, y, h_out, B, S, C, sx, sdt,
                           sb, sc, s);
    case 64:
      return launch<T, 64>(x, dt, a, b, c, d, h0, y, h_out, B, S, C, sx, sdt,
                           sb, sc, s);
    default:
      return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, b, c and y); dt, a, d, h0 and h_out
// are float32.  x, dt: (B, S, C) and b, c: (B, S, N) with row r = bb * S +
// t at element r * s{x,dt,b,c} and the last axis contiguous; a (C, N), d
// (C,), h0 and h_out (B, C, N) and y (B, S, C) contiguous; a, h0 and h_out
// 16-byte aligned; h0 may be NULL (zeros).  N in {16, 32, 64}.  Returns -1
// for an input this build does not take, else cudaGetLastError() after the
// launch.
extern "C" int repro_ssm_scan(const void* x, const void* dt, const void* a,
                              const void* b, const void* c, const void* d,
                              const void* h0, void* y, void* h_out, int dtype,
                              int B, int S, int C, int N, long long sx,
                              long long sdt, long long sb, long long sc,
                              void* stream) {
  if (B == 0 || C == 0) return 0;
  if (B > 65535 || S < 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_n<__nv_bfloat16>(N, x, dt, a, b, c, d, h0, y, h_out, B, S,
                                     C, sx, sdt, sb, sc, s);
  if (dtype == 0)
    return dispatch_n<float>(N, x, dt, a, b, c, d, h0, y, h_out, B, S, C, sx,
                             sdt, sb, sc, s);
  return -1;
}
